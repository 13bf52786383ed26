"""The WDAS cloud configuration on the CPU: the port's NanoVDB writer and
loader against the JAX package's, the port's `volpath` against the
benchmark's plain reference (`benchmark/reference/volpath.py`) per pixel,
and the tiny `wdas_cloud.render` cell through the harness: a sound run is
correct; the three faults of the timed path and the bfloat16 control are
not.

The grids are the configuration's own cloud (`benchmark/configs/
wdas_cloud.py`) on few voxels, its majorant cut so that a CPU step takes
seconds: the estimator's branches (null collisions, scattering, the
ratio-tracked wall after the eighth scattering) all occur.
"""

import numpy as np
import pytest
import torch

from benchmark.harness import FAULTS, load_json, load_module, run_cell
from benchmark.reference.volpath import VolScene, radiance
from ignis_tpu.medium import nanovdb as jn
from ignis_tpu_torch.api import Runtime
from ignis_tpu_torch.medium import nanovdb as tn

SEED = 2 ** 31 + 99            # above 32 signed bits: seeds may be that large
CELL = "wdas_cloud.render"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: faster for these small waves, and no
    oversubscription under the tier-1 run's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dims, depth):
    cfg = load_json("configs", "wdas_cloud")
    return dict(cfg, cpu_dims=list(dims), cpu_majorant_depth=float(depth))


def test_writer_bytes_and_loader_match_the_jax_package(tmp_path):
    """A seeded 40 x 24 x 17 grid (z, y, x), sparse, some blocks empty and
    the far blocks cut by the grid's edge: the two writers give the same
    bytes, and both loaders give the grid back."""
    rng = np.random.default_rng(17)
    dense = rng.uniform(0, 1, (40, 24, 17)).astype(np.float32)
    dense[dense < 0.45] = 0.0
    dense[:8, :8] = 0.0
    pt, pj = tmp_path / "t.nvdb", tmp_path / "j.nvdb"
    tn.write_nvdb_grid(pt, dense)
    jn.write_nvdb_grid(pj, dense)
    assert pt.read_bytes() == pj.read_bytes()
    got = tn.load_nvdb_grid(pt)
    assert got.dtype == np.float32 and got.flags.writeable
    np.testing.assert_array_equal(got, dense)
    np.testing.assert_array_equal(got, jn.load_nvdb_grid(pj))


def test_the_cloud_is_the_configurations():
    """The configuration's density: values in [0, 1], the largest exactly 1, and
    the empty share inside the configuration's range."""
    cfg = load_json("configs", "wdas_cloud")
    builder = load_module("configs", "wdas_cloud")
    d = builder.cloud_density(cfg["grid"], (99, 68, 122), "cpu").numpy()
    lo, hi = cfg["grid"]["empty_share_range"]
    assert d.min() == 0.0 and d.max() == 1.0
    assert lo <= float((d == 0).mean()) <= hi
    assert tuple(cfg["dims"]) == (994, 676, 1225)


def test_volpath_equals_the_reference_per_pixel(monkeypatch):
    """A 32^3 cloud at 16 x 16, 4 samples a pixel in one step: each
    pixel's sum as the reference's, the same paths with the same numbers;
    some paths reach the wall past their eighth scattering."""
    from benchmark.reference import volpath
    late = []
    real = volpath.ratio_transmittance

    def counted(sc, p0, *a):
        late.append(p0.shape[0])
        return real(sc, p0, *a)
    monkeypatch.setattr(volpath, "ratio_transmittance", counted)
    builder = load_module("configs", "wdas_cloud")
    scene, raw = builder.build(_cfg((32, 32, 32), 16), [16, 16], 64,
                               device="cpu")
    rt = Runtime(scene, seed=SEED, device="cpu")
    rt.step(spi=4)
    rt.dumpStats()
    q = rt.stats.quantities
    assert q["MediumNullEvents"] > 0 and q["MediumScatters"] > 0
    fb = torch.from_numpy(rt.rawFramebuffer().reshape(-1, 3)).double()
    pix = torch.arange(256).repeat(4)
    sample = torch.arange(4).repeat_interleave(256)
    rad = radiance(VolScene.from_raw(raw, 16, 16, 64), pix % 16, pix // 16,
                   0, SEED, sample=sample)
    ref = torch.zeros((256, 3), dtype=torch.float64).index_add_(
        0, pix, rad.double())
    assert float(ref.min()) >= 0.0 and float(ref.max()) > 0.0
    assert sum(late) > 0
    np.testing.assert_allclose(fb.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


def _run(fault=None, control=False):
    cfg = _cfg((16, 16, 16), 8)
    return run_cell(CELL, SEED, 0.2, 0, device="cpu",
                    overrides={"film": [8, 8], "check_pixels": 64},
                    config_overrides=cfg, fault=fault, control=control)


def test_a_tiny_cloud_run_is_correct():
    r = _run()
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["sample_count_gap"]["value"] == 0
    assert r["work"]["MediumNullEvents"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_cloud_run_is_not_correct(fault):
    r = _run(fault=fault)
    assert r["correct"] is False, (fault, r["checks"])


def test_control_run_is_not_correct():
    r = _run(control=True)
    assert r["correct"] is False, r["checks"]


def test_the_new_benchmark_modules_load_no_forbidden_module():
    """The volume reference, the volume entry and the cloud's builder load
    neither JAX nor the JAX package; the reference not even the port."""
    import subprocess
    import sys
    from benchmark.harness import ROOT
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.volpath\n"
            "assert 'ignis_tpu_torch' not in sys.modules, 'reference'\n"
            "from benchmark.harness import (forbidden_modules, load_json,\n"
            "                               load_module)\n"
            "load_module('entries', 'volrender')\n"
            "b = load_module('configs', 'wdas_cloud')\n"
            "b.cloud_density(load_json('configs', 'wdas_cloud')['grid'],\n"
            "                (8, 8, 8), 'cpu')\n"
            "import ignis_tpu_torch.medium.nanovdb\n"
            "print(forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
