"""`parallel.sharding` on `torch.distributed`: two gloo processes on the CPU
(the analog of tests/test_multihost.py, which is `slow` and stays so),
meeting through a FileStore under `tmp_path` (no TCP port to race for).

The demo box at depth 2 and 32x32 (1024 lanes, 512 a rank):
* the sharded render equals, bit for bit, a one-process `trace_wave` of the
  same lanes, on every rank;
* `replicate` restores rank 0's tables on rank 1, which changed its copy;
* `host_local_work` assembles the global work list on every rank from each
  rank's slice of it (uneven shares), as tests/_mh_worker.py calls the JAX
  package's;
* `sharded_train_step` is within 1e-6 of the one-process `train_step`
  (loss and updated parameters);
* the differentiable sharded render's gradient, summed over the ranks, is
  within rtol 1e-5 of the one-process gradient;
* the JAX package's `sharded_render_fn` on a 2-device CPU mesh gives the
  same radiance within rtol 1e-5 / atol 1e-6 (tests/test_determinism.py's
  tolerance).
Every process has its own timeout (`WORKER_TIMEOUT`): a rank whose peer
never arrives fails within it instead of hanging the run.
"""

import multiprocessing as mp
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu.parallel.sharding import make_mesh as j_make_mesh
from ignis_tpu.parallel.sharding import replicate as j_replicate
from ignis_tpu.parallel.sharding import sharded_render_fn as j_sharded
from ignis_tpu.parallel.sharding import shard_wave as j_shard_wave
from ignis_tpu_torch.api import Runtime
from ignis_tpu_torch.parallel import sharding
from ignis_tpu_torch.render.integrator import trace_wave
from ignis_tpu_torch.scenes import demo_scene

FILM = 32
WORLD = 2
SEED = 3
LR = 0.5
WORKER_TIMEOUT = 120       # seconds: rendezvous, collectives and the join


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    s = demo_scene()
    s["technique"] = dict(s["technique"], max_depth=2)
    return s


def _lanes():
    idx = torch.arange(FILM * FILM, dtype=torch.int64)
    return idx % FILM, idx // FILM


def _target():
    rng = np.random.default_rng(8)
    return torch.from_numpy(rng.uniform(0, 0.5, (FILM * FILM, 3))
                            .astype(np.float32))


def _rank_main(rank, store, out):
    """One rank: join the group, replicate, render, train, differentiate."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    sharding.init_distributed(f"file://{store}", WORLD, rank, backend="gloo",
                              timeout=WORKER_TIMEOUT)
    mesh = sharding.make_mesh(WORLD)
    rt = Runtime(_scene(), width=FILM, height=FILM, seed=SEED, device="cpu")
    tables = dict(rt.tables)
    if rank:                          # replicate must restore rank 0's
        tables["mat_colors"] = torch.zeros_like(tables["mat_colors"])
    sharding.replicate(mesh, tables)
    x, y = _lanes()
    lo_x, = sharding.shard_wave(mesh, x)
    # each rank gives its slice of a numpy work list, as tests/_mh_worker.py
    # gives the JAX package's; 1023 lanes make the shares uneven
    n = FILM * FILM - 1
    lo, hi = rank * n // WORLD, (rank + 1) * n // WORLD
    s_all = np.arange(n, dtype=np.uint32) % 7
    work = sharding.host_local_work(mesh, x.numpy()[lo:hi],
                                    y.numpy()[lo:hi], s_all[lo:hi])
    radiance = sharding.sharded_render_fn(rt.scene, mesh)(
        tables, x, y, 0, 0, 0, SEED)
    loss, new = sharding.sharded_train_step(
        rt.scene, mesh, ("mat_colors",), lr=LR)(
        tables, x, y, 0, 0, 0, SEED, _target())
    tg = dict(tables)
    tg["mat_colors"] = tables["mat_colors"].clone().requires_grad_(True)
    out_d = sharding.sharded_render_fn(rt.scene, mesh, differentiable=True)(
        tg, x, y, 0, 0, 0, SEED)
    out_d.sum().backward()
    grad = tg["mat_colors"].grad.contiguous()
    dist.all_reduce(grad, group=mesh.get_group("rays"))
    np.savez(out, radiance=radiance.numpy(), loss=loss.numpy(),
             mat_colors=new["mat_colors"].detach().numpy(),
             grad=grad.numpy(), render_d=out_d.detach().numpy(),
             share=lo_x.numpy(), tables_mat=tables["mat_colors"].numpy(),
             work=torch.stack(work).numpy())
    dist.destroy_process_group()


def _spawn(target, args_list):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in args_list]
    for p in procs:
        p.start()
    deadline = time.monotonic() + WORKER_TIMEOUT + 30
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    return procs, hung


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    procs, hung = _spawn(_rank_main, [(r, str(d / "store"), str(d / f"r{r}"))
                                      for r in range(WORLD)])
    assert not hung, "a rank did not finish within its timeout"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [dict(np.load(d / f"r{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    rt = Runtime(_scene(), width=FILM, height=FILM, seed=SEED, device="cpu")
    x, y = _lanes()
    with torch.no_grad():
        radiance = trace_wave(rt.scene, rt.tables, x, y, 0, 0, 0, SEED)
    return rt, radiance.numpy()


def test_sharded_render_bit_equal_to_one_process(ranks, single):
    _, want = single
    for r in ranks:
        np.testing.assert_array_equal(r["radiance"], want)
        np.testing.assert_array_equal(r["render_d"], want)
    assert want.mean() > 0
    x, _ = _lanes()
    half = FILM * FILM // WORLD
    for i, r in enumerate(ranks):             # contiguous shares
        np.testing.assert_array_equal(r["share"],
                                      x[i * half:(i + 1) * half].numpy())


def test_host_local_work_assembles_the_global_list(ranks):
    x, y = _lanes()
    n = FILM * FILM - 1
    want = np.stack([x.numpy()[:n], y.numpy()[:n], np.arange(n) % 7])
    for r in ranks:
        assert r["work"].dtype == np.int64
        np.testing.assert_array_equal(r["work"], want)


def test_replicate_restores_rank0_tables(ranks, single):
    rt, _ = single
    for r in ranks:
        np.testing.assert_array_equal(r["tables_mat"],
                                      rt.tables["mat_colors"].numpy())


def test_sharded_train_step_matches_train_step(ranks, single):
    rt, _ = single
    x, y = _lanes()
    loss, new = sharding.train_step(rt.scene, dict(rt.tables), x, y, 0, 0, 0,
                                    SEED, _target(),
                                    param_keys=("mat_colors",), lr=LR)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r["mat_colors"],
                                   new["mat_colors"].detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
    # every rank made the same update: the parameters stay replicated
    np.testing.assert_array_equal(ranks[0]["mat_colors"],
                                  ranks[1]["mat_colors"])
    assert not np.array_equal(ranks[0]["mat_colors"],
                              rt.tables["mat_colors"].numpy())


def test_sharded_gradient_matches_one_process(ranks, single):
    rt, _ = single
    x, y = _lanes()
    tg = dict(rt.tables)
    tg["mat_colors"] = rt.tables["mat_colors"].clone().requires_grad_(True)
    trace_wave(rt.scene, tg, x, y, 0, 0, 0, SEED,
               differentiable=True).sum().backward()
    want = tg["mat_colors"].grad.numpy()
    assert np.abs(want).max() > 0
    for r in ranks:
        np.testing.assert_allclose(r["grad"], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_jax_sharded_render_fn_matches(ranks):
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU devices of tests/conftest.py")
    jrt = JRuntime(_scene(), width=FILM, height=FILM, seed=SEED)
    mesh = j_make_mesh(2)
    x, y = (a.numpy().astype(np.int32) for a in _lanes())
    xs, ys = j_shard_wave(mesh, jnp.asarray(x), jnp.asarray(y))
    want = np.asarray(j_sharded(jrt.scene, mesh)(
        j_replicate(mesh, jrt.tables), xs, ys, jnp.uint32(0), jnp.uint32(0),
        jnp.uint32(0), SEED))
    np.testing.assert_allclose(ranks[0]["radiance"], want, rtol=1e-5,
                               atol=1e-6)


def _lonely_rank(store, out):
    """Rank 0 of a world of 2 whose peer never comes: must fail, not hang."""
    t0 = time.monotonic()
    try:
        sharding.init_distributed(f"file://{store}", WORLD, 0,
                                  backend="gloo", timeout=3)
    except Exception as e:          # the rendezvous' own timeout error
        with open(out, "w") as f:
            f.write(f"{type(e).__name__} {time.monotonic() - t0:.1f}")


def test_rank_without_peer_times_out(tmp_path):
    procs, hung = _spawn(_lonely_rank, [(str(tmp_path / "store"),
                                         str(tmp_path / "err"))])
    assert not hung
    name, secs = (tmp_path / "err").read_text().split()
    assert float(secs) < 60, (name, secs)


def test_init_distributed_without_a_coordinator_is_a_no_op(monkeypatch):
    import torch.distributed as dist
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert not dist.is_initialized()
    sharding.init_distributed()
    assert not dist.is_initialized()
