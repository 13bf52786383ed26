"""The port's row gather for parameter tables (`core/dgather.py`): its
forward is `table[idx.long()]` bit for bit, its backward sums each lane's
gradient row into the table row it came from, on the CPU with the plain
version (`index_add_`) and on the card with `csrc/row_scatter.cu`.

Tolerance of a sum: a float32 sum of n terms in any order lies within
(n - 1) 2^-24 sum |terms| of the exact sum (`_sum_bound`); each result is
held to the float64 sum within that, and two float32 sums within twice it.
`_emulate` repeats the kernel's split of the work and its order of additions
in numpy float32: on the CPU it shows that the plan takes every lane once,
and on the card the kernel must equal it bit for bit.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from ignis_tpu_torch.core import dgather as dg
from ignis_tpu_torch.utils import stats

SRC = pathlib.Path(dg.__file__).resolve().parent.parent / "csrc" / \
    "row_scatter.cu"
REDUCE_GROUPS = 32   # kReduceGroups of the source (checked below)


def _indices(n, m, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "one row":
        return np.zeros(n, np.int64)
    if kind == "mostly row 0":
        idx = rng.integers(0, m, n)
        return np.where(rng.random(n) < 0.9, 0, idx)
    return rng.integers(-m, m, n)       # spread, a half of them negative


def _sum_bound(g, idx, m):
    """(M, K) float64 exact row sums and the bound of a float32 sum's error
    for each cell."""
    g64 = g.double()
    rows = torch.where(idx < 0, idx + m, idx).long()
    exact = torch.zeros((m, g.shape[1]), dtype=torch.float64).index_add_(
        0, rows, g64)
    absum = torch.zeros_like(exact).index_add_(0, rows, g64.abs())
    count = torch.bincount(rows, minlength=m).double()[:, None]
    return exact, (count - 1).clamp_min(0) * 2.0 ** -24 * absum


def _emulate(g, idx, m, plan):
    """The kernel's result in numpy float32, addition by addition: thread
    (p, c) of block b adds its lanes b * L + p + groups * i in order into a
    row's cell, the lane groups are summed in order, then the blocks' partials
    in groups of blocks q, q + 32, ..., and those groups in order.  Adding
    the 0 of a lane of another row changes no sum, so every row can take the
    whole lane range."""
    g = g.numpy().astype(np.float32)
    rows = idx.long().numpy()
    rows = np.where(rows < 0, rows + m, rows)
    n, k = g.shape
    lanes, groups = plan.lanes_per_block, plan.groups
    per = -(-lanes // groups)
    part = np.zeros((plan.blocks, m, k), np.float32)
    for r in range(m):
        full = np.zeros((plan.blocks * lanes, k), np.float32)
        full[:n] = np.where((rows == r)[:, None], g, np.float32(0))
        gr = np.zeros((plan.blocks, per * groups, k), np.float32)
        gr[:, :lanes] = full.reshape(plan.blocks, lanes, k)
        acc = np.cumsum(gr.reshape(plan.blocks, per, groups, k), axis=1,
                        dtype=np.float32)[:, -1]
        part[:, r] = np.cumsum(acc, axis=1, dtype=np.float32)[:, -1]
    if plan.blocks == 1:
        return torch.from_numpy(part[0])
    nb = -(-plan.blocks // REDUCE_GROUPS)
    pad = np.zeros((nb * REDUCE_GROUPS, m, k), np.float32)
    pad[:plan.blocks] = part
    sums = np.cumsum(pad.reshape(nb, REDUCE_GROUPS, m, k), axis=0,
                     dtype=np.float32)[-1]
    return torch.from_numpy(np.cumsum(sums, axis=0, dtype=np.float32)[-1])


# (table shape, lanes, where the lanes land): the cell's material colours
# and its one light, and a table of many rows
GRAD_CASES = [((4, 4, 3), 4096, "mostly row 0"),
              ((1, 32), 4096, "one row"),
              ((300, 12), 4096, "spread")]


@pytest.mark.parametrize("shape,n,kind", GRAD_CASES,
                         ids=["mat_colors", "light_data", "many_rows"])
def test_gradient_matches_autograd_of_plain_indexing(shape, n, kind):
    idx = torch.from_numpy(_indices(n, shape[0], kind, seed=n + shape[0]))
    table = torch.from_numpy(np.random.default_rng(1).random(shape,
                                                             np.float32))
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (n, *shape[1:]), np.float32))
    mine = table.clone().requires_grad_(True)
    out = dg.gather_rows(mine, idx)
    assert torch.equal(out, table[idx.long()])
    before = stats.row_scatters()
    out.backward(g)
    assert stats.row_scatters() == before + 1
    ref = table.clone().requires_grad_(True)
    ref[idx.long()].backward(g)
    exact, bound = _sum_bound(g.reshape(n, -1), idx, shape[0])
    got = mine.grad.reshape(shape[0], -1).double()
    assert ((got - exact).abs() <= bound).all()
    assert ((got - ref.grad.reshape(shape[0], -1).double()).abs()
            <= 2 * bound).all()


def test_two_dimensional_and_negative_indices():
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.random((5, 3), np.float32))
    idx = torch.from_numpy(rng.integers(-5, 5, (64, 32)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((64, 32, 3), np.float32))
    mine = table.clone().requires_grad_(True)
    out = dg.gather_rows(mine, idx)
    assert out.shape == (64, 32, 3)
    assert torch.equal(out, table[idx.long()])
    out.backward(g)
    ref = table.clone().requires_grad_(True)
    ref[idx.long()].backward(g)
    exact, bound = _sum_bound(g.reshape(-1, 3), idx.reshape(-1), 5)
    assert ((mine.grad.double() - exact).abs() <= bound).all()
    assert ((mine.grad - ref.grad).double().abs() <= 2 * bound).all()


def test_gradcheck_in_float64():
    table = torch.rand((3, 2, 2), dtype=torch.float64, requires_grad=True)
    idx = torch.tensor([0, 2, -1, 1, 0, 0, -3])
    assert torch.autograd.gradcheck(lambda t: dg.gather_rows(t, idx),
                                    (table,))


@pytest.mark.parametrize("case", ["no_grad", "int_table", "plain_table"])
def test_no_gradient_keeps_plain_indexing(case):
    idx = torch.tensor([3, 0, -1, 2, 2], dtype=torch.int32)
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    if case == "int_table":
        table = table.to(torch.int32)
    elif case == "no_grad":
        table.requires_grad_(True)
    before = stats.row_scatters()
    with torch.set_grad_enabled(case != "no_grad"):
        out = dg.gather_rows(table, idx)
    assert out.grad_fn is None
    assert out.dtype == table.dtype
    assert torch.equal(out, table.detach()[idx.long()])
    assert stats.row_scatters() == before


def test_train_step_scatters_four_times_a_bounce():
    """The demo at depth 2 (tests/test_torch_train_step.py's scene, 256
    lanes): each bounce gathers mat_colors once (the BSDF's colours) and
    light_data three times (the NEE sample, the emitter's pdf and its
    radiance at a hit), so a step's backward makes 8 scatters."""
    from ignis_tpu_torch.convert import params_from_numpy
    from ignis_tpu_torch.parallel.sharding import train_step
    from ignis_tpu_torch.scene.compile import load_and_compile
    from ignis_tpu_torch.scenes import demo_scene
    scene = demo_scene()
    scene["film"] = {"size": [16, 16]}
    scene["technique"] = dict(scene["technique"], max_depth=2)
    ts = load_and_compile(scene)
    lanes = torch.arange(256, dtype=torch.int32)
    tables = params_from_numpy(ts.tables, ("mat_colors", "light_data"),
                               "cpu")
    before = stats.row_scatters()
    loss, _ = train_step(ts, tables, lanes % 16, lanes // 16, 0, 0, 0, 0,
                         torch.zeros((256, 3)))
    assert float(loss) > 0
    assert stats.row_scatters() - before == 8


def test_constants_match_the_kernel_source():
    src = SRC.read_text()
    got = {name: int(eval(v)) for name, v in re.findall(
        r"constexpr int (k\w+) = ([\d *]+);", src)}
    assert got["kThreads"] == dg._THREADS
    assert got["kAccBytes"] == dg._ACC_BYTES
    assert got["kReduceGroups"] == REDUCE_GROUPS


# (lanes, table rows, columns): the cell's two tables, a table of row slabs,
# rows of the kernel's widest, one block
PLAN_CASES = [(262144, 4, 12), (262144, 1, 32), (16384, 300, 12),
              (2000, 100, 256), (100, 3, 5)]


@pytest.mark.parametrize("n,m,k", PLAN_CASES)
def test_plan_takes_every_lane_once(n, m, k):
    plan = dg._plan(n, m, k, 132)
    assert plan.groups * k <= dg._THREADS
    assert 4 * plan.rows * plan.groups * k <= dg._ACC_BYTES
    assert plan.slabs * plan.rows >= m > (plan.slabs - 1) * plan.rows
    assert plan.blocks * plan.lanes_per_block >= n
    assert (plan.blocks - 1) * plan.lanes_per_block < n
    assert plan.blocks * m * k <= dg._SCRATCH_FLOATS or plan.blocks == 1
    if n >= 1 << 16:
        # the card gets several blocks for every SM
        assert plan.blocks * plan.slabs >= 4 * 132
    if n * k > 1 << 22:
        return      # the emulation's cost; the card holds these to it
    rng = np.random.default_rng(n + m + k)
    g = torch.from_numpy(rng.standard_normal((n, k), np.float32))
    idx = torch.from_numpy(rng.integers(-m, m, n))
    exact, bound = _sum_bound(g, idx, m)
    got = _emulate(g, idx, m, plan)
    assert ((got.double() - exact).abs() <= bound).all()


def test_rows_wider_than_the_kernel_raise():
    g = torch.zeros((4, dg._THREADS + 1))
    with pytest.raises(ValueError, match="past the kernel"):
        dg._launch(g, torch.zeros(4, dtype=torch.int64), 2)


@pytest.mark.cuda
def test_kernel_matches_emulation_and_plain_on_the_card():
    """The cell's shapes (262,144 lanes into (4, 4, 3) and (1, 32)), a table
    of row slabs, one of the kernel's widest rows, int32 and int64
    indices: the kernel equals `_emulate` bit for bit, lies within the sum
    bound of the float64 sum, and two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")
    dev = torch.device("cuda", 0)
    cases = [(262144, (4, 4, 3), "mostly row 0", torch.int32),
             (262144, (1, 32), "one row", torch.int64),
             (16384, (300, 12), "spread", torch.int64),
             (2000, (100, 256), "spread", torch.int32),
             (100, (3, 5), "spread", torch.int64)]
    for n, shape, kind, dtype in cases:
        m, k = shape[0], int(np.prod(shape[1:]))
        rng = np.random.default_rng(n + m)
        g = torch.from_numpy(rng.standard_normal((n, k), np.float32))
        idx = torch.from_numpy(_indices(n, m, kind, n + m)).to(dtype)
        launches = dg.gather_rows_backward.launches
        got = dg.gather_rows_backward(g.to(dev), idx.to(dev), m)
        again = dg.gather_rows_backward(g.to(dev), idx.to(dev), m)
        torch.cuda.synchronize()
        assert dg.gather_rows_backward.launches == launches + 2
        assert torch.equal(got, again), (n, shape)
        got = got.cpu()
        plan = dg._plan(n, m, k, dg._sms(0))
        assert torch.equal(got, _emulate(g, idx, m, plan)), (n, shape)
        exact, bound = _sum_bound(g, idx, m)
        assert ((got.double() - exact).abs() <= bound).all(), (n, shape)
        plain = dg.gather_rows_backward_plain(g.to(dev), idx.to(dev), m)
        assert ((got - plain.cpu()).double().abs() <= 2 * bound).all()


@pytest.mark.cuda
def test_gather_rows_backward_on_the_card():
    """Through autograd on the card: every backward takes the kernel, the
    forward is the indexing's bits, and a gradient other than float32
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.random((4, 4, 3), np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(-4, 4, (512, 8))).to(dev)
    g = torch.from_numpy(rng.standard_normal((512, 8, 4, 3),
                                             np.float32)).to(dev)
    mine = table.clone().requires_grad_(True)
    out = dg.gather_rows(mine, idx)
    assert torch.equal(out, table[idx])
    launches, calls = dg.gather_rows_backward.launches, stats.row_scatters()
    out.backward(g)
    assert dg.gather_rows_backward.launches == launches + 1
    assert stats.row_scatters() == calls + 1
    exact, bound = _sum_bound(g.reshape(-1, 12).cpu(), idx.reshape(-1).cpu(),
                              4)
    got = mine.grad.reshape(4, 12).cpu().double()
    assert ((got - exact).abs() <= bound).all()
    with pytest.raises(ValueError):
        dg.gather_rows_backward(g.reshape(-1, 12).double(), idx.reshape(-1),
                                4)
