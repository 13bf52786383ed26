"""Rays sharded over processes, and the inverse-rendering train step.

Counterpart of ignis_tpu/parallel/sharding.py, on `torch.distributed`.  The
reference shards the rays over the `rays` axis of a JAX device mesh and lets
XLA insert the collectives; here each process (rank) of a process group
renders its contiguous share of the lanes, the tables are replicated from
rank 0, and the collectives are explicit:

* the forward render needs no reduction of sums: each rank writes its own
  lanes into a zero buffer of all N lanes and one `all_reduce(SUM)` gathers
  them (adding exact zeros keeps every bit, and it works on gloo with CUDA
  tensors, where `all_gather` may not);
* the train step all-reduces each rank's gradient of its share of the global
  mean loss; the parameters stay replicated.

`init_distributed` starts the group (NCCL for a CUDA device, gloo for the
CPU); `make_mesh` is a one-axis `DeviceMesh` named `rays` over all ranks.
`train_step` is the step on the tensors' own device, in one process.

    init_distributed("file:///tmp/store", 2, rank)        # each process
    mesh = make_mesh()
    tables = replicate(mesh, tables)
    radiance = sharded_render_fn(scene, mesh)(tables, x, y, 0, 0, 0, 0)
    loss, tables = sharded_train_step(scene, mesh, ("mat_colors",))(
        tables, x, y, 0, 0, 0, 0, target)
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ignis_tpu_torch.render.integrator import trace_wave
from ignis_tpu_torch.utils.stats import span


def _default_backend():
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     backend=None, timeout=None):
    """Join the process group: `coordinator` is an init method
    (`tcp://host:port`, or `file:///path` for a store on a shared file
    system), `num_processes` the world size, `process_id` this rank.  They
    default to torch's environment (MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
    RANK, `env://`).  `backend` defaults to NCCL where CUDA is available and
    gloo elsewhere; `timeout` (seconds) bounds the rendezvous and every
    collective.  A no-op when a group already exists, or when neither a
    coordinator nor the environment names one."""
    if dist.is_initialized():
        return
    if coordinator is None:
        if "MASTER_ADDR" not in os.environ:
            return
        coordinator = "env://"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend or _default_backend(),
                            init_method=coordinator, **kw)


def make_mesh(n_devices=None, axis="rays"):
    """A one-axis `DeviceMesh` named `axis` over every rank of the group
    (one device a rank), of CUDA devices under NCCL and of the CPU under
    gloo.  Without a group it starts a one-process one."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        dist.init_process_group(_default_backend(), store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"requested a {n_devices}-rank mesh but the process "
                         f"group has {world} ranks")
    return DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                      list(range(world)), mesh_dim_names=(axis,))


def _share(mesh, axis, n):
    """This rank's contiguous lane range [lo, hi) of n lanes, and the
    axis's process group."""
    rank = mesh.get_local_rank(axis)
    size = mesh.size()
    return rank * n // size, (rank + 1) * n // size, mesh.get_group(axis)


def shard_wave(mesh, *arrays, axis="rays"):
    """This rank's contiguous share of the lanes (dim 0) of each array."""
    lo, hi, _ = _share(mesh, axis, arrays[0].shape[0])
    return tuple(a[lo:hi] for a in arrays)


def _gather_rows(local, lo, n, group):
    """The (n, ...) rows of every rank: each rank's `local` rows at `lo` of
    a zero buffer, summed over the ranks (adding exact zeros keeps every
    bit)."""
    full = local.new_zeros((n,) + tuple(local.shape[1:]))
    full[lo:lo + local.shape[0]] = local
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    return full


def host_local_work(mesh, x, y, sample, axis="rays"):
    """The global pixel work list (x, y, sample) on every rank, from the
    slice of it that each rank holds (the multi-host analog of
    `shard_wave`): the ranks' slices concatenated in rank order, as int64
    tensors on the device of `x` (of the CUDA device under NCCL)."""
    group = mesh.get_group(axis)
    rank, size = mesh.get_local_rank(axis), mesh.size()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl"
           else x.device if isinstance(x, torch.Tensor) else None)
    x, y, sample = (torch.as_tensor(a).to(device=dev, dtype=torch.int64)
                    for a in (x, y, sample))
    counts = torch.zeros(size, dtype=torch.int64, device=x.device)
    counts[rank] = x.shape[0]
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    lo, n = int(counts[:rank].sum()), int(counts.sum())
    return tuple(_gather_rows(a, lo, n, group) for a in (x, y, sample))


def replicate(mesh, tree, axis="rays"):
    """The tables of rank 0 on every rank: each tensor is broadcast in place
    (as its bytes, so that every dtype travels), the other entries as
    objects.  Returns `tree`."""
    group = mesh.get_group(axis)
    src = dist.get_global_rank(group, 0)
    rest = [{k: v for k, v in tree.items()
             if not isinstance(v, torch.Tensor)}]
    dist.broadcast_object_list(rest, src=src, group=group)
    tree.update(rest[0])
    with torch.no_grad():
        for v in tree.values():
            if isinstance(v, torch.Tensor) and v.numel():
                if not v.is_contiguous():
                    raise ValueError("replicate needs contiguous tables")
                flat = v.reshape(-1)
                dist.broadcast(flat.view(torch.uint8), src=src, group=group)
    return tree


class _GatherLanes(torch.autograd.Function):
    """Forward: the (n, ...) rows of every rank, each rank's `local` rows at
    `lo` of a zero buffer, summed over the ranks.  Backward: the rows of
    this rank's lanes, so that a rank's parameter gradients are those
    through its own lanes (summed over the ranks by the caller)."""

    @staticmethod
    def forward(ctx, local, lo, n, group):
        ctx.lo, ctx.rows = lo, local.shape[0]
        return _gather_rows(local, lo, n, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.lo:ctx.lo + ctx.rows], None, None, None


def sharded_render_fn(scene, mesh, differentiable=False, axis="rays"):
    """A render over the ranks of `mesh`.

    Returns fn(tables, x, y, sample, iteration, frame, seed) -> the (N, 3)
    radiance of all N lanes (x, y given in full on every rank), in input
    order, on every rank.  Each rank traces its contiguous share with
    `trace_wave`.  With `differentiable=True` the result carries autograd:
    a backward pass gives each rank the parameter gradients through its own
    lanes, which an `all_reduce(SUM)` over the ranks makes the whole
    render's (as `sharded_train_step` does)."""

    def fn(tables, x, y, sample, iteration, frame, seed):
        n = x.shape[0]
        lo, hi, group = _share(mesh, axis, n)
        with torch.set_grad_enabled(differentiable):
            local = trace_wave(scene, tables, x[lo:hi], y[lo:hi], sample,
                               iteration, frame, seed,
                               differentiable=differentiable)
            return _GatherLanes.apply(local, lo, n, group)
    return fn


def sharded_train_step(scene, mesh, param_keys=("mat_colors", "light_data"),
                       lr=1e-2, axis="rays"):
    """One inverse-rendering SGD step, sharded over rays.

    Returns step(tables, x, y, sample, iteration, frame, seed, target) ->
    (loss, new tables), x / y / target given in full on every rank.  loss =
    mean over all lanes and channels of (render - target)^2; each rank takes
    the gradient of its share of that mean and the gradients (and the loss)
    are summed over the ranks, so every rank makes the same update and the
    parameters stay replicated.  The tables given are not changed.  Under
    a profiler the step's phases are spans, as `train_step`'s: the render
    and its share of the loss `train.forward`, the gradient
    `train.backward`, the `all_reduce`s of the loss and the gradients
    `train.allreduce`, and the update `train.update`."""

    def step(tables, x, y, sample, iteration, frame, seed, target):
        n = x.shape[0]
        lo, hi, group = _share(mesh, axis, n)
        params = {k: tables[k].detach().to(torch.float32).requires_grad_(True)
                  for k in param_keys}
        t = dict(tables)
        t.update(params)
        dev = x.device
        with span("train.forward", request=iteration, device=dev):
            color = trace_wave(scene, t, x[lo:hi], y[lo:hi], sample,
                               iteration, frame, seed, differentiable=True)
            part = torch.sum((color - target[lo:hi]) ** 2) / float(
                n * color.shape[1])
        with span("train.backward", request=iteration, device=dev):
            grads = torch.autograd.grad(part, [params[k] for k in param_keys],
                                        allow_unused=True)
        loss = part.detach().clone()
        # a table the render never read has a zero gradient
        grads = [torch.zeros_like(params[k]) if g is None else g.contiguous()
                 for k, g in zip(param_keys, grads)]
        with span("train.allreduce", request=iteration, device=dev):
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
            for g in grads:
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        out = dict(tables)
        with span("train.update", request=iteration, device=dev):
            for k, g in zip(param_keys, grads):
                out[k] = (params[k] - lr * g).detach().requires_grad_(True)
        return loss, out
    return step


def train_step(scene, tables, x, y, sample, iteration, frame, seed, target,
               param_keys=("mat_colors", "light_data"), lr=1e-2):
    """One SGD step on the tensors' own device.  Returns (loss, new tables).

    loss = mean over lanes and channels of (render - target)^2, with the
    render `trace_wave(..., differentiable=True)` over the lanes (x, y);
    each table of `param_keys` becomes p - lr * dloss/dp.  The tables given
    are not changed: the updated ones are new leaf tensors that require
    grad, ready for the next step; the others are the same objects.  Under
    a profiler the render and loss, the gradient and the update are the
    spans `train.forward`, `train.backward` and `train.update`, each with
    its device interval on a CUDA device."""
    params = {k: tables[k].detach().to(torch.float32).requires_grad_(True)
              for k in param_keys}
    t = dict(tables)
    t.update(params)
    dev = x.device
    with span("train.forward", request=iteration, device=dev):
        color = trace_wave(scene, t, x, y, sample, iteration, frame, seed,
                           differentiable=True)
        loss = torch.mean((color - target) ** 2)
    with span("train.backward", request=iteration, device=dev):
        grads = torch.autograd.grad(loss, [params[k] for k in param_keys],
                                    allow_unused=True)
    out = dict(tables)
    with span("train.update", request=iteration, device=dev):
        for k, g in zip(param_keys, grads):
            # a table the render never read has a zero gradient
            new = params[k] if g is None else params[k] - lr * g
            out[k] = new.detach().requires_grad_(True)
    return loss.detach(), out
