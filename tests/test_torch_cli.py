"""The port's CLIs (`ignis_tpu_torch.cli`) against the JAX package's, run
in-process through `main([... "--device", "cpu"])` on the demo box (depth
3) at 16x16.

* igcli with default flags (the per-lane stack BVH, `use_bvh=True`): a run
  of 2 + 2 samples through `--checkpoint` with `--aov` and `--tonemap`
  against the JAX CLI's uninterrupted 4 samples: the checkpoint's sum, the
  EXR, the AOV and tonemapped EXRs; with `--no-bvh` (the Baldwin-Weber
  tables), `-P __camera_eye=...` and `--denoise`: the denoised EXR.  Two
  JAX compiles, one a table set.
* igtrace: the lines for a ray file.
* igview: the `--fly` EXRs of two poses, then `_aov_frame` in every mode
  and `_histogram_pane` on the runtimes the two viewers built.
* imgutil: exr2hdr / hdr2exr round trips and exr2png / exr2jpg.
* mts2ig: a Mitsuba XML written here converts to the same dict, which the
  port renders.
* each CLI once more in a subprocess in which `jax` and `ignis_tpu` cannot
  be imported.

Tolerances: frames, checkpoint sums, AOVs and igtrace colors rtol 1e-5 /
atol 1e-5; the denoised and tonemapped frames rtol 1e-4 / atol 1e-5; the
8-bit PNG within 1 level; the HDR files and mts2ig's dicts equal.
"""

import json
import os
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from ignis_tpu.cli import igcli as j_igcli
from ignis_tpu.cli import igtrace as j_igtrace
from ignis_tpu.cli import igview as j_igview
from ignis_tpu.cli import imgutil as j_imgutil
from ignis_tpu.cli import mts2ig as j_mts2ig
from ignis_tpu_torch.cli import igcli, igtrace, igview, imgutil, mts2ig
from ignis_tpu_torch.ops import bvh as tbvh
from ignis_tpu_torch.scenes import demo_scene
from ignis_tpu_torch.utils.exr import read_exr, write_exr

FILM = ["--width", "16", "--height", "16"]
CPU = ["--device", "cpu"]
EQ = dict(rtol=1e-5, atol=1e-5)
NEAR = dict(rtol=1e-4, atol=1e-5)
EYE = "__camera_eye=0.1,0.05,3.7"
REPO = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT = 180


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    s = demo_scene()
    s["technique"] = dict(s["technique"], max_depth=3)
    (d / "scene.json").write_text(json.dumps(s))
    return d


def _scene(work):
    return str(work / "scene.json")


@pytest.fixture(scope="module")
def jax_igcli(work):
    """The JAX CLI's two runs (one compile each): default flags with
    `--checkpoint`, `--aov` and `--tonemap` over 4 samples; `--no-bvh` with
    `-P` and `--denoise` over 2."""
    j = work / "jax"
    j.mkdir()
    base = [_scene(work), *FILM, "--quiet"]
    j_igcli.main(base + ["--spp", "4", "--checkpoint", str(j / "ck.npz"),
                         "--aov", "--tonemap", "aces", "-o",
                         str(j / "default.exr")])
    j_igcli.main(base + ["--spp", "2", "--no-bvh", "-P", EYE, "--denoise",
                         "-o", str(j / "nobvh.exr")])
    return j


def test_igcli_default_checkpoint_aov_tonemap(work, jax_igcli, capsys):
    """Default flags: the stack BVH walk.  2 + 2 samples through
    `--checkpoint` against the JAX CLI's 4 in one run."""
    ck = work / "ck.npz"
    base = [_scene(work), *FILM, *CPU, "--quiet", "--spp", "2",
            "--checkpoint", str(ck)]
    calls = tbvh.bvh_closest.calls
    assert igcli.main(base + ["-o", str(work / "first.exr")]) == 0
    assert tbvh.bvh_closest.calls > calls
    assert igcli.main(base + ["--aov", "--tonemap", "aces", "--stats", "-o",
                              str(work / "default.exr")]) == 0
    out = capsys.readouterr().out
    assert "Resumed at 2 spp" in out and "WaveIterations" in out
    with np.load(ck) as got, np.load(jax_igcli / "ck.npz") as want:
        assert int(got["samples"]) == int(want["samples"]) == 4
        assert int(got["iteration"]) == int(want["iteration"]) == 4
        np.testing.assert_allclose(got["accum"], want["accum"], **EQ)
    for name, tol in (("default", EQ), ("default_tonemapped", NEAR),
                      ("default_normals", EQ), ("default_albedo", EQ),
                      ("default_depth", EQ)):
        np.testing.assert_allclose(read_exr(work / f"{name}.exr"),
                                   read_exr(jax_igcli / f"{name}.exr"),
                                   **tol, err_msg=name)
    assert read_exr(jax_igcli / "default.exr").mean() > 0


def test_igcli_no_bvh_parameter_denoise(work, jax_igcli):
    p = work / "nobvh.exr"
    calls = tbvh.bvh_closest.calls
    assert igcli.main([_scene(work), *FILM, *CPU, "--quiet", "--spp", "2",
                       "--no-bvh", "-P", EYE, "--denoise", "-o",
                       str(p)]) == 0
    assert tbvh.bvh_closest.calls == calls
    got = read_exr(p)
    np.testing.assert_allclose(got, read_exr(jax_igcli / "nobvh.exr"),
                               **NEAR)
    # the parameter moved the camera
    assert not np.allclose(got, read_exr(jax_igcli / "default.exr"),
                           atol=1e-2)


def test_igtrace_lines(work, tmp_path):
    rays = tmp_path / "rays.txt"
    rays.write_text("0 0 3.5 0 0 -1\n0.2 -0.3 3.5 0 0.1 -1\n"
                    "0 0 3.5 0.3 0.3 -1 0 100\n0.5 0.5 0.5 0 -1 0 0.1 0.2\n"
                    "0 0 0 1 0\n")                      # short: skipped
    got, want = tmp_path / "t.txt", tmp_path / "j.txt"
    assert igtrace.main([_scene(work), *CPU, "-i", str(rays), "-o", str(got),
                         "--spp", "2"]) == 0
    assert j_igtrace.main([_scene(work), "-i", str(rays), "-o", str(want),
                           "--spp", "2"]) == 0
    g = np.loadtxt(got, ndmin=2)
    w = np.loadtxt(want, ndmin=2)
    assert g.shape == w.shape == (4, 3)
    np.testing.assert_allclose(g, w, **EQ)
    assert (w.sum(1) > 0).sum() >= 2


@contextmanager
def _capture(module, name="Runtime"):
    """Record the runtimes `module.<name>` builds."""
    made = []
    real = getattr(module, name)

    def make(*a, **k):
        rt = real(*a, **k)
        made.append(rt)
        return rt

    with mock.patch.object(module, name, make):
        yield made


@pytest.fixture(scope="module")
def viewers(work):
    """(port runtime, JAX runtime) of two --fly runs, with their EXRs."""
    import ignis_tpu.api as japi
    import ignis_tpu_torch.api as tapi
    fly = "0,0,3.85;0.3,0.1,3.5,-0.1,0,-1"
    args = [_scene(work), *FILM, "--spi", "1", "--frames-spp", "2", "--fly",
            fly]
    with _capture(tapi) as made:
        igview.main(args + [*CPU, "--out", str(work / "fly_t")])
    with _capture(japi) as jmade:
        j_igview.main(args + ["--out", str(work / "fly_j")])
    return made[0], jmade[0]


def test_igview_fly_exrs(work, viewers):
    for i in range(2):
        got = read_exr(work / "fly_t" / f"fly_{i:04d}.exr")
        want = read_exr(work / "fly_j" / f"fly_{i:04d}.exr")
        np.testing.assert_allclose(got, want, **EQ)
        assert want.mean() > 0


@pytest.mark.parametrize("mode", ["Normals", "Albedo", "Depth", "Denoised"])
def test_igview_aov_frames(viewers, mode):
    rt, jrt = viewers
    got, want = igview._aov_frame(rt, mode), j_igview._aov_frame(jrt, mode)
    assert got.shape == (16, 16, 3)
    np.testing.assert_allclose(got, want, **(NEAR if mode == "Denoised"
                                             else EQ))


def test_igview_histogram_pane(viewers):
    rt, jrt = viewers
    got = igview._histogram_pane(rt, 40)
    assert got == j_igview._histogram_pane(jrt, 40)
    assert len(got.splitlines()) == 7


def test_imgutil_round_trips(tmp_path):
    rng = np.random.default_rng(21)
    img = rng.uniform(0, 3, (9, 14, 3)).astype(np.float32)
    img[0, 0] = 0
    src = tmp_path / "in.exr"
    write_exr(src, img)
    for mod, tag, dev in ((imgutil, "t", CPU), (j_imgutil, "j", [])):
        mod.main(["exr2hdr", str(src), str(tmp_path / f"{tag}.hdr")])
        mod.main(["hdr2exr", str(tmp_path / f"{tag}.hdr"),
                  str(tmp_path / f"{tag}.exr")])
        mod.main(["exr2png", str(src), str(tmp_path / f"{tag}.png"),
                  "--exposure", "0.7", "--tonemap", "reinhard", *dev])
        mod.main(["exr2jpg", str(src), str(tmp_path / f"{tag}.jpg"), *dev])
    assert ((tmp_path / "t.hdr").read_bytes()
            == (tmp_path / "j.hdr").read_bytes())
    back = read_exr(tmp_path / "t.exr")
    np.testing.assert_array_equal(back, read_exr(tmp_path / "j.exr"))
    # RGBE: an 8-bit mantissa under the pixel's largest component
    assert (np.abs(back - img) <= img.max(-1, keepdims=True) / 128).all()
    from PIL import Image
    png = [np.asarray(Image.open(tmp_path / f"{t}.png"), np.int16)
           for t in "tj"]
    assert png[0].shape == (9, 14, 3)
    assert np.abs(png[0] - png[1]).max() <= 1
    assert Image.open(tmp_path / "t.jpg").size == (14, 9)


def test_clis_refuse_to_fall_back_to_the_cpu(work, tmp_path):
    """Without `--device` a CLI runs on the CUDA device, and raises where
    there is none: it never renders on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    write_exr(tmp_path / "i.exr", np.ones((2, 3, 3), np.float32))
    for main, argv in ((igcli.main, [_scene(work), "--width", "4", "--height",
                                     "4", "-o", str(tmp_path / "o.exr")]),
                       (imgutil.main, ["exr2png", str(tmp_path / "i.exr")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


_MTS_XML = """<scene version="2.0.0">
  <default name="spp" value="4"/>
  <integrator type="path"><integer name="max_depth" value="3"/></integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="to_world">
      <lookat origin="0, 1, 4" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="16"/><integer name="height" value="12"/>
    </film>
  </sensor>
  <bsdf type="diffuse" id="grey">
    <rgb name="reflectance" value="0.6, 0.6, 0.5"/>
  </bsdf>
  <bsdf type="twosided" id="red">
    <bsdf type="diffuse"><rgb name="reflectance" value="0.7, 0.1, 0.1"/></bsdf>
  </bsdf>
  <shape type="rectangle" id="floor">
    <transform name="to_world">
      <scale value="3"/><rotate x="1" angle="-90"/>
      <translate y="-1"/>
    </transform>
    <ref id="grey"/>
  </shape>
  <shape type="cube" id="box">
    <transform name="to_world"><scale value="0.4"/></transform>
    <ref id="red"/>
  </shape>
  <shape type="sphere" id="lamp">
    <point name="center" x="0" y="2" z="0"/>
    <float name="radius" value="0.3"/>
    <emitter type="area"><rgb name="radiance" value="8, 8, 8"/></emitter>
  </shape>
  <emitter type="point">
    <point name="position" x="1" y="1.5" z="1"/>
    <rgb name="intensity" value="2, 2, 2"/>
  </emitter>
  <emitter type="constant"><rgb name="radiance" value="0.05"/></emitter>
</scene>
"""


def test_mts2ig_converts_as_jax_and_renders(tmp_path):
    from ignis_tpu_torch.api import Runtime
    xml = tmp_path / "scene.xml"
    xml.write_text(_MTS_XML)
    got = mts2ig.convert(xml)
    assert got == j_mts2ig.convert(xml)
    assert mts2ig.main([str(xml), "-o", str(tmp_path / "t.json")]) == 0
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
        json.dumps(got))
    rt = Runtime(str(tmp_path / "t.json"), device="cpu")
    rt.step(spi=2)
    img = rt.currentFrame()
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 1e-3


# ------------------------------------------- the CLIs without jax installed
_BLOCKED = """
import sys
sys.modules["jax"] = None            # `import jax` raises ImportError
sys.modules["ignis_tpu"] = None
from ignis_tpu_torch.cli import {mod}
code = {mod}.main({args!r})
assert not any(k == "jax" or k.startswith(("jax.", "ignis_tpu."))
               for k, v in sys.modules.items() if v is not None)
sys.exit(code)
"""


def _blocked_args(name, work, tmp):
    scene = _scene(work)
    if name == "igcli":
        return [scene, "--width", "8", "--height", "8", "--spp", "1",
                *CPU, "--quiet", "-o", str(tmp / "o.exr")]
    if name == "igtrace":
        (tmp / "r.txt").write_text("0 0 3.5 0 0 -1\n")
        return [scene, *CPU, "-i", str(tmp / "r.txt")]
    if name == "igview":
        return [scene, "--width", "8", "--height", "8", "--frames-spp", "1",
                "--fly", "0,0,3.85", *CPU, "--out", str(tmp / "fly")]
    if name == "imgutil":
        write_exr(tmp / "i.exr", np.ones((2, 3, 3), np.float32))
        return ["exr2png", str(tmp / "i.exr"), *CPU]
    (tmp / "s.xml").write_text(_MTS_XML)
    return [str(tmp / "s.xml")]


@pytest.mark.parametrize("name", ["igcli", "igtrace", "igview", "imgutil",
                                  "mts2ig"])
def test_cli_runs_without_jax(work, tmp_path, name):
    code = _BLOCKED.format(mod=name, args=_blocked_args(name, work, tmp_path))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True,
                       timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode == 0, r.stderr[-2000:]
