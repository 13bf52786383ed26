"""The asset cache (`utils.cache`) and the OpenEXR shim (`native.
load_exr_shim`, `utils.exr.read_exr`'s other compressions).

The cache: its key functions are the JAX package's (an entry's key also
holds a hash of the port's sources, and an entry of other code is not
read); a hit returns the arrays that
were stored (equal to the bit); a second `Runtime` of one scene records no
`build_bvh` (nor any traversal-table build) and has tables equal to the bit;
the mesh and measured-BSDF loaders go through it; two processes writing one
entry at once both get the built arrays and leave one readable entry; the
off switch (`IGNIS_TPU_TORCH_NO_CACHE`) builds every time and writes
nothing.  Every test points the cache at its own `tmp_path`.

The shim: PIZ, RLE, PXR24 and B44 files, written by a small writer built
here with g++ against the system's OpenEXR 3.1, read equal to the bit to
the JAX package's `read_exr` (and within half precision of what was
written; B44, which is lossy, within 2 % of the image's largest value).
Those cases skip only where that library is absent.
"""

import multiprocessing as mp
import os
import pickle
import shutil
import subprocess
import time

import numpy as np
import pytest

from ignis_tpu.utils import cache as jcache
from ignis_tpu.utils.exr import read_exr as j_read_exr
from ignis_tpu_torch.api import Runtime
from ignis_tpu_torch.scene.compile import load_and_compile
from ignis_tpu_torch.scenes import (
    demo_scene, write_dj_bsdf, write_klems_xml, write_tensortree_xml,
)
from ignis_tpu_torch.utils import cache
from ignis_tpu_torch.utils.exr import read_exr

WORKER_TIMEOUT = 120          # seconds a cache-writing process may take


@pytest.fixture
def cache_at(tmp_path, monkeypatch):
    d = tmp_path / "cache"
    monkeypatch.setenv("IGNIS_TPU_TORCH_CACHE", str(d))
    monkeypatch.delenv("IGNIS_TPU_TORCH_NO_CACHE", raising=False)
    return d


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return dict(a=rng.normal(size=(17, 3)).astype(np.float32),
                b=rng.integers(0, 9, 5).astype(np.int32),
                s=np.asarray(7, np.int64))


def test_keys_equal_the_jax_packages(tmp_path):
    arrays = list(_arrays().values())
    assert cache.data_key(arrays, "bvh", "x") == jcache.data_key(
        arrays, "bvh", "x")
    p = tmp_path / "f.bin"
    p.write_bytes(os.urandom(3000))
    assert cache._key(p, "mesh") == jcache._key(p, "mesh")
    assert cache._VERSION == jcache._VERSION


def test_hit_returns_equal_arrays(cache_at):
    calls = []

    def build():
        calls.append(1)
        return _arrays()

    first = cache.cached_arrays_data([np.arange(4)], "bvh", build)
    second = cache.cached_arrays_data([np.arange(4)], "bvh", build)
    assert len(calls) == 1
    assert first.keys() == second.keys()
    for k in first:
        assert second[k].dtype == first[k].dtype
        np.testing.assert_array_equal(second[k], first[k])
    # another key builds again
    cache.cached_arrays_data([np.arange(5)], "bvh", build)
    assert len(calls) == 2
    names = sorted(p.name for p in cache_at.iterdir())
    assert len(names) == 2 and all(n.startswith("bvh-") for n in names)


def test_file_keyed_entries(cache_at, tmp_path):
    f = tmp_path / "in.txt"
    f.write_text("one")
    calls = []

    def build(p):
        calls.append(p)
        return dict(n=np.asarray(len(open(p).read())))

    assert int(cache.cached_arrays(f, "mesh", build)["n"]) == 3
    assert int(cache.cached_arrays(f, "mesh", build)["n"]) == 3
    f.write_text("three")                       # new content: a new key
    assert int(cache.cached_arrays(f, "mesh", build)["n"]) == 5
    assert len(calls) == 2
    info = cache.cached_pickle(f, "klems", lambda p: ({"t": 1}, {"i": 2}))
    assert cache.cached_pickle(f, "klems", lambda p: 1 / 0) == info


def test_entry_of_other_code_is_not_read(cache_at, monkeypatch):
    calls = []

    def build():
        calls.append(1)
        return _arrays(len(calls))

    # the tag hashes the package's sources, and is stable within a process
    assert len(cache.code_tag()) == 16
    assert cache.code_tag() == cache.code_tag.__wrapped__()
    first = cache.cached_arrays_data([np.arange(4)], "bvh", build)
    monkeypatch.setattr(cache, "code_tag", lambda: "edited-sources")
    second = cache.cached_arrays_data([np.arange(4)], "bvh", build)
    assert len(calls) == 2
    assert not np.array_equal(first["a"], second["a"])
    assert len(list(cache_at.iterdir())) == 2


def test_corrupt_entry_is_rebuilt(cache_at):
    cache.cached_arrays_data([np.arange(3)], "pbvh", _arrays)
    (entry,) = cache_at.iterdir()
    entry.write_bytes(b"not an npz")
    out = cache.cached_arrays_data([np.arange(3)], "pbvh", _arrays)
    np.testing.assert_array_equal(out["a"], _arrays()["a"])


def test_off_switch(cache_at, monkeypatch):
    monkeypatch.setenv("IGNIS_TPU_TORCH_NO_CACHE", "1")
    calls = []

    def build():
        calls.append(1)
        return _arrays()

    for _ in range(2):
        cache.cached_arrays_data([np.arange(4)], "bvh", build)
    assert len(calls) == 2
    assert not cache_at.exists()
    rt = Runtime(demo_scene(), width=4, height=4, device="cpu")
    assert "build_bvh" in rt.stats.sections
    assert not cache_at.exists()


def test_second_runtime_builds_nothing(cache_at):
    scene = demo_scene()
    a = Runtime(scene, width=8, height=8, use_bvh=True, device="cpu")
    b = Runtime(scene, width=8, height=8, use_bvh=True, device="cpu")
    assert {"build_bvh", "build_traversal_tables"} <= set(a.stats.sections)
    assert not {"build_bvh", "build_traversal_tables"} & set(
        b.stats.sections)
    assert a.tables.keys() == b.tables.keys()
    for k, v in a.tables.items():
        if hasattr(v, "numpy"):
            assert v.dtype == b.tables[k].dtype, k
            np.testing.assert_array_equal(b.tables[k].numpy(), v.numpy(), k)
        else:
            assert b.tables[k] == v, k
    kinds = {p.name.split("-")[0] for p in cache_at.iterdir()}
    assert kinds == {"bvh", "bwtab"}


def test_mesh_and_measured_loaders_use_the_cache(cache_at, tmp_path,
                                                 monkeypatch):
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    klems, tree, dj = (str(tmp_path / n) for n in
                       ("k.xml", "t.xml", "d.bsdf"))
    write_klems_xml(klems, 1)
    write_tensortree_xml(tree, 2)
    write_dj_bsdf(dj, 3, ntheta=3, res=8, lres=8)
    scene = demo_scene()
    scene["shapes"].append({"type": "obj", "name": "tri",
                            "filename": str(obj)})
    scene["entities"].append({"name": "tri", "shape": "tri", "bsdf": "k"})
    scene["bsdfs"] += [
        {"type": "klems", "name": "k", "filename": klems},
        {"type": "tensortree", "name": "t", "filename": tree},
        {"type": "djmeasured", "name": "d", "filename": dj}]
    for e, b in zip(scene["entities"][1:3], ("t", "d")):
        e["bsdf"] = b
    first = load_and_compile(scene, 8, 8)
    kinds = sorted(p.name.split("-")[0] for p in cache_at.iterdir())
    assert kinds == ["djbrdf", "klems", "mesh", "ttbsdf"]

    def refuse(*a, **k):
        raise AssertionError("loader ran on a cached asset")

    from ignis_tpu_torch.measured import djmeasured, klems as tk, tensortree
    from ignis_tpu_torch.scene import mesh
    monkeypatch.setattr(mesh, "load_obj", refuse)
    monkeypatch.setattr(tk, "klems_tables", refuse)
    monkeypatch.setattr(tensortree, "tensortree_tables", refuse)
    monkeypatch.setattr(djmeasured, "load_brdf", refuse)
    second = load_and_compile(scene, 8, 8)
    assert second.tables.keys() == first.tables.keys()
    for k, v in first.tables.items():
        np.testing.assert_array_equal(np.asarray(second.tables[k]),
                                      np.asarray(v), k)


def _write_entry(cache_dir, out_path):
    """One concurrent writer: the same entry as every other writer."""
    os.environ["IGNIS_TPU_TORCH_CACHE"] = cache_dir
    from ignis_tpu_torch.utils import cache as c

    def build():
        time.sleep(0.5)                  # both processes build at once
        return _arrays(3)

    out = c.cached_arrays_data([np.arange(6)], "bvh", build)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def test_two_processes_write_one_entry(cache_at, tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_write_entry,
                         args=(str(cache_at), str(tmp_path / f"out{i}")))
             for i in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(WORKER_TIMEOUT)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and all(p.exitcode == 0 for p in procs)
    want = _arrays(3)
    for i in range(2):
        with open(tmp_path / f"out{i}", "rb") as f:
            got = pickle.load(f)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    (entry,) = list(cache_at.iterdir())       # no temporary file left
    assert entry.name.startswith("bvh-") and entry.suffix == ".npz"
    got = cache.cached_arrays_data([np.arange(6)], "bvh", lambda: 1 / 0)
    np.testing.assert_array_equal(got["a"], want["a"])


# ------------------------------------------------------------ the EXR shim
_WRITER = r"""
#include <ImfArray.h>
#include <ImfRgbaFile.h>
#include <cstdio>
#include <cstdlib>
#include <vector>
using namespace Imf;
// writer out.exr w h compression in.raw (w*h*3 float32)
int main(int argc, char** argv) {
    int w = atoi(argv[2]), h = atoi(argv[3]), comp = atoi(argv[4]);
    std::vector<float> rgb(size_t(w) * h * 3);
    FILE* f = fopen(argv[5], "rb");
    if (!f || fread(rgb.data(), 4, rgb.size(), f) != rgb.size()) return 2;
    fclose(f);
    Array2D<Rgba> px(h, w);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            const float* p = &rgb[(size_t(y) * w + x) * 3];
            px[y][x] = Rgba(p[0], p[1], p[2], 1.0f);
        }
    RgbaOutputFile out(argv[1], w, h, WRITE_RGBA, 1, Imath::V2f(0, 0), 1,
                       INCREASING_Y, Compression(comp));
    out.setFrameBuffer(&px[0][0], 1, w);
    out.writePixels(h);
    return 0;
}
"""
_COMPRESSIONS = {"RLE": 1, "PIZ": 4, "PXR24": 5, "B44": 6}


@pytest.fixture(scope="module")
def exr_writer(tmp_path_factory):
    if (not os.path.isdir("/usr/include/OpenEXR") or shutil.which("g++")
            is None):
        pytest.skip("no OpenEXR 3.1 headers or no g++ on this machine")
    d = tmp_path_factory.mktemp("exr_writer")
    (d / "writer.cpp").write_text(_WRITER)
    r = subprocess.run(
        ["g++", "-O1", "-o", str(d / "writer"), str(d / "writer.cpp"),
         "-I/usr/include/OpenEXR", "-I/usr/include/Imath", "-lOpenEXR-3_1",
         "-lImath-3_1", "-lIlmThread-3_1", "-lIex-3_1"],
        capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        pytest.skip(f"the OpenEXR 3.1 library is absent: {r.stderr[-300:]}")
    return d / "writer"


@pytest.fixture(scope="module")
def jax_shim(exr_writer):
    """The JAX package's shim, loaded.  It builds `_exr_shim.so` in place
    and remembers a failed load, and other test files may be building it at
    the same moment: retry until the other writer is done."""
    from ignis_tpu.native import build
    for _ in range(60):
        build._CACHE.pop("exr", None)
        if build.load_exr_shim() is not None:
            return
        time.sleep(1)
    pytest.fail("the JAX package's OpenEXR shim does not load")


@pytest.mark.parametrize("comp", sorted(_COMPRESSIONS))
def test_shim_reads_what_jax_reads(exr_writer, jax_shim, tmp_path, comp):
    # a smooth ramp (B44 packs 4x4 blocks) with a little seeded noise
    rng = np.random.default_rng(_COMPRESSIONS[comp])
    yy, xx = np.mgrid[0:13, 0:21].astype(np.float32)
    img = (np.stack([xx / 20, yy / 12, (xx + yy) / 32], -1) * 4
           + rng.uniform(0, 0.01, (13, 21, 3))).astype(np.float32)
    raw = tmp_path / "in.raw"
    img.tofile(raw)
    p = tmp_path / f"{comp}.exr"
    subprocess.run([str(exr_writer), str(p), "21", "13",
                    str(_COMPRESSIONS[comp]), str(raw)], check=True,
                   timeout=60)
    got = read_exr(p)
    want = j_read_exr(p)
    assert got.shape == (13, 21, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # half precision; B44 is lossy (4x4 blocks of 6-bit differences)
    if comp == "B44":
        assert np.abs(got - img).max() < 0.02 * img.max()
    else:
        np.testing.assert_allclose(got, img, rtol=2e-3, atol=1e-3)


def test_shim_is_built_once(exr_writer):
    from ignis_tpu_torch import native
    lib = native.load_exr_shim()
    assert lib is not None and native.load_exr_shim() is lib
    assert list(native.build_dir().glob("libexr_shim_*.so"))
