"""The plain reference against the program on the CPU at tiny films, its
traversal against brute force, and the tetra generator."""

import numpy as np
import pytest
import torch

from benchmark.harness import load_json, load_module
from benchmark.reference.geometry import SierpinskiGeometry, SoupGeometry
from benchmark.reference.pathtracer import RefScene, radiance
from benchmark.tests.conftest import SEED


def test_tetra_has_4_to_the_n_tetrahedra_of_4_triangles():
    mesh = load_module("configs", "spd_tetra").tetra_mesh
    for n in (0, 1, 3):
        v, f = mesh(n)
        assert f.shape == (4 ** n * 4, 3) and v.shape == (4 ** n * 4, 3)
    v, f = mesh(8)
    assert f.shape[0] == 262_144
    v2, f2 = mesh(8)
    assert v.tobytes() == v2.tobytes() and f.tobytes() == f2.tobytes()


def test_tetra_file_is_the_same_bytes_every_time(tmp_path):
    from benchmark.scenes import write_ply
    v, f = load_module("configs", "spd_tetra").tetra_mesh(4)
    a = write_ply(tmp_path / "a.ply", v, f).read_bytes()
    b = write_ply(tmp_path / "b.ply", *load_module(
        "configs", "spd_tetra").tetra_mesh(4)).read_bytes()
    assert a == b and len(a) > 4 ** 4 * 4 * 13


def test_the_pyramids_walk_finds_the_brute_force_hits():
    v, f = load_module("configs", "spd_tetra").tetra_mesh(3)
    v = torch.from_numpy(v)
    f = torch.from_numpy(f)
    v0, e1, e2 = v[f[:, 0]], v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]
    g = torch.Generator().manual_seed(5)
    org = torch.rand((2000, 3), generator=g) * 6 - 3
    aim = torch.rand((2000, 3), generator=g) * 2 - 1      # inside the cube
    d = torch.nn.functional.normalize(aim - org, dim=-1)
    tmin, tmax = torch.zeros(2000), torch.full((2000,), 1e30)
    walk = SierpinskiGeometry(v0, e1, e2, 3)
    brute = SoupGeometry(v0, e1, e2)
    tw, _, _, iw = walk.closest(org, d, tmin, tmax)
    tb, _, _, ib = brute.closest(org, d, tmin, tmax)
    assert (iw >= 0).sum() > 100
    assert torch.equal(iw, ib) and torch.equal(tw, tb)
    short = tb * 0.999
    assert torch.equal(walk.occluded(org, d, tmin, short),
                       brute.occluded(org, d, tmin, short))


@pytest.mark.parametrize("config,size", [("cbox", 16), ("spd_tetra", 16)])
def test_reference_equals_the_program_path_by_path(config, size):
    """Runtime.step on the CPU (the kernels' plain versions) and the
    reference sum the same paths: every pixel within rounding."""
    from ignis_tpu_torch.api import Runtime
    cfg = dict(load_json("configs", config), film=[size, size])
    if config == "spd_tetra":
        cfg["size_factor"] = 3
    scene, raw = load_module("configs", config).build(cfg, cfg["film"], 64)
    rt = Runtime(scene, seed=SEED, device="cpu")
    for _ in range(2):
        rt.step(spi=1)
    prog = torch.from_numpy(rt.rawFramebuffer().reshape(-1, 3).copy())
    sc = RefScene.from_raw(raw, size, size, 64).to("cpu")
    idx = torch.arange(size * size)
    ref = sum(radiance(sc, idx % size, idx // size, it, SEED)
              for it in range(2))
    assert float(prog.sum()) > 0
    assert torch.allclose(prog, ref, rtol=1e-4, atol=1e-6)


def test_reference_gradients_equal_the_programs_train_step():
    from ignis_tpu_torch.api import Runtime
    from ignis_tpu_torch.parallel.sharding import train_step
    size, depth = 8, 6
    cfg = load_json("configs", "cbox")
    scene, raw = load_module("configs", "cbox").build(cfg, [size, size],
                                                      depth)
    rt = Runtime(scene, seed=SEED, device="cpu")
    idx = torch.arange(size * size)
    x, y = idx % size, idx // size
    target = torch.full((size * size, 3), 0.3)
    loss, out = train_step(rt.scene, dict(rt.tables), x.int(), y.int(), 0, 0,
                           0, SEED, target, lr=1.0)
    sc = RefScene.from_raw(raw, size, size, depth)
    kd = sc.kd.clone().requires_grad_(True)
    ld = sc.light_data.clone().requires_grad_(True)
    sc = RefScene(**{**sc.__dict__, "kd": kd, "light_data": ld})
    ref = torch.mean((radiance(sc, x, y, 0, SEED, bounces=depth) - target)
                     ** 2)
    gk, gl = torch.autograd.grad(ref, [kd, ld])
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)
    g_prog = rt.tables["mat_colors"] - out["mat_colors"].detach()
    assert float(g_prog.norm()) == pytest.approx(float(gk.norm()), rel=1e-4)
    g_prog = rt.tables["light_data"] - out["light_data"].detach()
    assert float(g_prog.norm()) == pytest.approx(float(gl.norm()), rel=1e-4)
    assert float(gk.norm()) > 0 and float(gl.norm()) > 0


def test_bfloat16_in_the_programs_place_fails_the_render_check():
    """The control at a test's size: the reference in bfloat16 against
    the reference in float32, by the cell's own tolerance and limit."""
    from benchmark.entries.render import mismatch_share
    wl = load_json("workloads", "cbox.render")
    cfg = load_json("configs", "cbox")
    size = 16
    _, raw = load_module("configs", "cbox").build(cfg, [size, size], 64)
    base = RefScene.from_raw(raw, size, size, 64)
    idx = torch.arange(size * size)
    x, y = idx % size, idx // size
    ref = sum(radiance(base, x, y, it, SEED).double() for it in range(2))
    ctl = sum(radiance(base.to("cpu", torch.bfloat16), x, y, it, SEED,
                       dtype=torch.bfloat16).double() for it in range(2))
    share = mismatch_share(ctl, ref, 2, wl["rtol"], wl["atol"])
    assert share > wl["limits"]["mismatch_share"]
    assert np.isfinite(share)
