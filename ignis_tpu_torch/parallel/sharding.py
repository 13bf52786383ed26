"""The inverse-rendering train step.

Counterpart of ignis_tpu/parallel/sharding.py.

`train_step` is the body of the reference's `sharded_train_step` on one
device: the mean squared error of a differentiable render against a target,
its gradient with respect to the named parameter tables, and one SGD update.
The reference shards the rays over a device mesh and lets XLA reduce the
gradients; the port's mesh, over `torch.distributed`, is not ported yet
(ROADMAP.md queue 1, item 10), so this step runs on the device of its
tensors.

    tables = params_from_numpy(scene.tables, ("mat_colors", "light_data"),
                               "cuda")
    for _ in range(steps):
        loss, tables = train_step(scene, tables, x, y, 0, 0, 0, 0, target)
"""

from __future__ import annotations

import torch

from ignis_tpu_torch.render.integrator import trace_wave


def train_step(scene, tables, x, y, sample, iteration, frame, seed, target,
               param_keys=("mat_colors", "light_data"), lr=1e-2):
    """One SGD step.  Returns (loss, new tables).

    loss = mean over lanes and channels of (render - target)^2, with the
    render `trace_wave(..., differentiable=True)` over the lanes (x, y);
    each table of `param_keys` becomes p - lr * dloss/dp.  The tables given
    are not changed: the updated ones are new leaf tensors that require
    grad, ready for the next step; the others are the same objects."""
    params = {k: tables[k].detach().to(torch.float32).requires_grad_(True)
              for k in param_keys}
    t = dict(tables)
    t.update(params)
    color = trace_wave(scene, t, x, y, sample, iteration, frame, seed,
                       differentiable=True)
    loss = torch.mean((color - target) ** 2)
    grads = torch.autograd.grad(loss, [params[k] for k in param_keys],
                                allow_unused=True)
    out = dict(tables)
    for k, g in zip(param_keys, grads):
        # a table the render never read has a zero gradient
        new = params[k] if g is None else params[k] - lr * g
        out[k] = new.detach().requires_grad_(True)
    return loss.detach(), out
