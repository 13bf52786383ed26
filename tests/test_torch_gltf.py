"""glTF scene import in the port against the JAX package's, on the
transmissive cube, floor and point light that tools/inverse_render.py's
`make_volume_gltf` writes (a `volpath` scene of principled BSDFs and a
homogeneous medium).

* `load_scene_file` of the .gltf, and of the same document in a .glb
  container: compiled tables, metadata and the `Runtime`'s tables equal to
  the JAX package's (as tests/test_torch_compile.py holds them).
* A render at 16x16, spi 2, through both `Runtime`s: the image mean within
  2 % (the rule of tests/test_torch_volpath_render_mean.py for `volpath`
  scenes; 1.1 % on the CPU here), and at least 95 % of the pixels within
  1e-5 relative (248 of 256 on the CPU).  A path of up to eight bounces
  through the glass cube takes another branch on a last-bit difference now
  and then (ROADMAP.md queue 3, "Branch flips"), and at 256 lanes the JAX
  package traces with its Moeller-Trumbore sweep, the port with its
  Baldwin-Weber walk, which differ at triangle edges.
"""

import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.api import Runtime
from ignis_tpu_torch.convert import tables_to_numpy
from ignis_tpu_torch.scene.compile import load_and_compile as t_compile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from inverse_render import make_volume_gltf  # noqa: E402

FILM = 16
MEAN_REL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: faster for this small film, and the test workers
    sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _glb(gltf_path, out):
    """The glTF document (buffers as data URIs) in a .glb container: the
    12-byte header and one JSON chunk, padded with spaces."""
    doc = Path(gltf_path).read_bytes()
    doc += b" " * (-len(doc) % 4)
    out.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(doc))
                    + struct.pack("<II", len(doc), 0x4E4F534A) + doc)
    return out


@pytest.fixture(scope="module")
def gltf_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gltf")
    g = make_volume_gltf(d / "standin.gltf")
    return {"gltf": Path(g), "glb": _glb(g, d / "standin.glb")}


@pytest.mark.parametrize("kind", ["gltf", "glb"])
def test_gltf_scene_compiles_as_in_jax(kind, gltf_files):
    a = j_compile(str(gltf_files["gltf"]), FILM, FILM)
    b = t_compile(str(gltf_files[kind]), FILM, FILM)
    assert a.tables.keys() == b.tables.keys()
    for k in a.tables:
        x, y = np.asarray(a.tables[k]), np.asarray(b.tables[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert vars(a.technique) == vars(b.technique)
    assert b.technique.type == "volpath"
    assert a.bsdf_types == b.bsdf_types and a.media == b.media
    assert [(l.type, l.name) for l in a.lights] == \
           [(l.type, l.name) for l in b.lights]
    for f in ("eye", "dir", "up", "scale"):
        np.testing.assert_array_equal(getattr(a.camera, f),
                                      getattr(b.camera, f))
    np.testing.assert_array_equal(a.bbox_min, b.bbox_min)
    np.testing.assert_array_equal(a.bbox_max, b.bbox_max)


def test_gltf_runtime_tables_and_render(gltf_files):
    path = str(gltf_files["gltf"])
    jrt = JRuntime(path, width=FILM, height=FILM)
    trt = Runtime(path, width=FILM, height=FILM, device="cpu")
    jt = {k: np.asarray(v) for k, v in jrt.tables.items()}
    tt = tables_to_numpy(trt.tables)
    # beside the Baldwin-Weber rows the port keeps its kernel's cluster tree
    assert set(tt) - {"bw_ctree"} == set(jt)
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    jrt.step(spi=2)
    trt.step(spi=2)
    ref, got = jrt.currentFrame(), trt.currentFrame()
    assert got.shape == ref.shape == (FILM, FILM, 3)
    assert np.isfinite(got).all() and ref.mean() > 0
    assert abs(got.mean() - ref.mean()) <= MEAN_REL * ref.mean()
    near = np.isclose(got, ref, rtol=1e-5, atol=1e-6).all(axis=-1)
    assert near.mean() >= 0.95
