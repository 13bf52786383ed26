"""Row gather for parameter tables, with a backward that scales with lanes.

`gather_rows(table, idx)` is `table[idx.long()]`.  Where a gradient can flow
to the table (grad mode on and the table requires grad) the gather runs as
the autograd Function `_GatherRows`: its forward is that same indexing, bit
for bit, and its backward sums each lane's gradient row into the table row
it came from, `gather_rows_backward`.  Everywhere else (the render paths,
integer tables, float tables that are no parameter) it is the indexing
alone.

Why the backward is not autograd's own: the backward of `table[idx]` is
`index_put_(accumulate=True)`, which on CUDA sorts the indices and then, for
each run of equal indices, has one thread a column walk every duplicate in
turn.  A differentiable render gathers a handful of rows for every lane, so
such a call takes time in proportion to the largest row's lane count.
Measured on an H100 in the benchmark's `cbox.inverse` cell (262,144 lanes,
6 bounces, `mat_colors` and `light_data` as parameters), it took 1.37 s of a
1.49 s `train_step`, 97 % of the device's time.  The JAX package's
`gather_rows` has a custom VJP too (ignis_tpu/core/dgather.py, a one-hot
product), for its own backend's serialised scatters.

`gather_rows_backward` runs the hand-written kernel `csrc/row_scatter.cu`
for CUDA tensors (float32 only; anything else raises) and the plain version
`gather_rows_backward_plain` (`index_add_`) for CPU tensors.  Every
backward, on either device, counts one on `utils.stats.row_scatters()`;
`gather_rows_backward.launches` counts those that took the kernel.

How the kernel splits the work (`_plan`; the source's header has the whole
account): blocks of `_THREADS` threads each sum a contiguous chunk of lanes
into a private accumulator of at most `_ACC_BYTES` in shared memory, thread
(lane group, column) owning its cells and adding in lane order; a second
launch sums the blocks' partials in block order, so the result does not
change from call to call.  A table taller than one accumulator is cut into
slabs of rows.  A row is at most `_THREADS` wide (the parameter tables are
at most 32).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ignis_tpu_torch.utils import stats

# a first-pass block's threads and its accumulator's most bytes: kThreads and
# kAccBytes of csrc/row_scatter.cu
_THREADS = 256
_ACC_BYTES = 48 * 1024
_BLOCKS_PER_SM = 8    # blocks of a launch for each SM, when there are lanes
_MIN_LANES = 8        # lanes each thread takes at the least
_SCRATCH_FLOATS = 1 << 24   # the blocks' partial sums, at most


def gather_rows(table, idx):
    if torch.is_grad_enabled() and table.requires_grad:
        return _GatherRows.apply(table, idx)
    return table[idx.long()]


class _GatherRows(torch.autograd.Function):
    """`table[idx.long()]`, whose backward is `gather_rows_backward`.  Saves
    the index tensor and the table's shape only."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx.long()]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        shape = ctx.table_shape
        n, k = idx.numel(), math.prod(shape[1:])
        d = gather_rows_backward(grad.reshape(n, k), idx.reshape(n), shape[0])
        return d.reshape(shape), None


def gather_rows_backward_plain(g, idx, m):
    """(M, K) row sums of the (N, K) gradient `g` by the (N,) indices `idx`
    (negative ones + M); plain PyTorch."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + m, idx)
    out = torch.zeros((m, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, idx, g)


def gather_rows_backward(g, idx, m):
    """The backward of `gather_rows` into an (M, ...) table: (M, K) row sums
    of the (N, K) gradient `g` by the (N,) indices `idx`.  CUDA tensors go to
    the kernel, CPU tensors to the plain version."""
    stats.count_row_scatter()
    if g.is_cuda:
        out = _launch(g, idx, m)
        if out is None:           # nothing to sum: nothing launched
            return torch.zeros((m, g.shape[1]), dtype=g.dtype,
                               device=g.device)
        gather_rows_backward.launches += 1
        return out
    return gather_rows_backward_plain(g, idx, m)


gather_rows_backward.launches = 0


class _Plan(NamedTuple):
    blocks: int           # lane blocks (grid.x)
    lanes_per_block: int
    groups: int           # lane groups of a block
    rows: int             # rows of a slab
    slabs: int            # row slabs (grid.y)


def _plan(n, m, k, sms):
    """How a launch over n lanes into an (m, k) table splits its work, from
    the shapes and the card's SM count alone (k at most `_THREADS`)."""
    groups = _THREADS // k
    rows = max(1, min(m, _ACC_BYTES // (4 * groups * k)))
    slabs = -(-m // rows)
    rows = -(-m // slabs)         # slabs of even height
    blocks = min(-(-_BLOCKS_PER_SM * sms // slabs),
                 -(-n // (groups * _MIN_LANES)),
                 _SCRATCH_FLOATS // (m * k))
    lanes = -(-n // max(blocks, 1))
    return _Plan(-(-n // lanes), lanes, groups, rows, slabs)


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(g, idx, m):
    """Launch the kernel: the (M, K) float32 row sums, or None when there is
    nothing to sum (no lanes, no cells)."""
    from ignis_tpu_torch import native
    dev = g.device
    if g.dtype != torch.float32 or g.ndim != 2:
        raise ValueError(f"the gradient must be (N, K) float32 on {dev}, got "
                         f"{g.dtype} {tuple(g.shape)}")
    n, k = g.shape
    if idx.device != dev or idx.shape != (n,):
        raise ValueError(f"idx must be ({n},) on {dev}, got "
                         f"{tuple(idx.shape)} on {idx.device}")
    if n == 0 or m * k == 0:
        return None
    if k > _THREADS:
        raise ValueError(f"rows of {k} values: past the kernel's "
                         f"{_THREADS}")
    if n >= 1 << 31 or m >= 1 << 31:
        raise ValueError(f"{n} lanes into {m} rows: past the kernel's int32 "
                         f"counts")
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.long()
    g, idx = g.contiguous(), idx.contiguous()
    plan = _plan(n, m, k, _sms(dev.index))
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    part = None
    if plan.blocks > 1:
        part = torch.empty((plan.blocks, m, k), dtype=torch.float32,
                           device=dev)
    with native.launch_guard(dev):
        err = native.library().ignis_row_scatter(
            g.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), n,
            m, k, *plan, None if part is None else part.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_scatter kernel launch failed: CUDA error "
                           f"{err}")
    return out
