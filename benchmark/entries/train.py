"""Inverse rendering: `parallel.sharding.train_step` back to back, one SGD
step on a fixed-depth differentiable render of every pixel, against a
target image.

Set-up builds the one training object, the tables with the parameters,
sets the parameters' start (the configuration's reflectances with the
workload's `init` applied), makes the target with the plain reference from
the configuration's own reflectances, and drives the object through its
first three steps with the window's own call; the window goes on from
there.  Each step renders at another iteration, so every step's lanes take
other paths.

The check follows those three steps with the reference: the same lanes,
iterations, seed and target, autograd through the reference's render, the
same SGD update.  Compared: the steps' losses; each leaf's first gradient
as the optimizer got it, read back from the program's state after one step
as (p0 - p1) / lr; each leaf's change after three steps.  The window's last
three steps are compared too: for each, the reference takes one step from
the program's own state before it (its tables copied before each step) at
that step's iteration; compared are its loss and its gradient, read back
as (p_k - p_{k+1}) / lr (`last_loss_gap`, `last_grad_gap`).  A loss or a
table that is not finite fails them.  A gradient or a change is compared
by its norm: the gap between the program's norm and the reference's over
the larger of the reference's norm of that leaf and that of the median
leaf; leaves whose reference gradient is below a thousandth of the median
leaf's are left out: a gradient gap is the worst leaf's.  Over steps, a
gap is the median of the three steps': one lane whose camera ray grazes
the light's edge may see the light on one side only, and moves that
step's loss by up to a few per cent on its own.

The control puts the reference in bfloat16 in the program's place: its
losses, gradients and changes go through the same comparison.
"""

from __future__ import annotations

import collections
import gc
import math
import statistics
import time

import torch

from benchmark.reference.pathtracer import RefScene, radiance
from benchmark.roofline import LaunchSampler

FIRST_STEPS = 3
LEAVES = ("mat_colors", "light_data")   # the program's tables
REF_LEAVES = ("kd", "light_data")       # the reference's


def norm_gap(prog, ref):
    """Worst leaf's |norm(prog) - norm(ref)| over max(norm(ref leaf),
    norm(median leaf)); leaves under a thousandth of the median out."""
    rn = [float(r.double().norm()) for r in ref]
    med = statistics.median(rn)
    gaps = [abs(float(p.double().norm()) - r) / max(r, med)
            for p, r in zip(prog, rn) if r >= 1e-3 * med]
    return max(gaps) if gaps else 0.0


def median_gap(gaps):
    """The median of the steps' gaps; not a number where any step's is
    not, so that a loss or a table gone to NaN or infinity fails."""
    gaps = list(gaps)
    if not all(math.isfinite(g) for g in gaps):
        return float("nan")
    return statistics.median(gaps)


def rel_gap(prog, ref):
    return abs(prog - ref) / abs(ref)


class Cell:
    def __init__(self, wl, cfg, builder, seed, device):
        self.wl, self.cfg, self.builder = wl, cfg, builder
        self.seed, self.device = seed, device
        self.film = wl["film"]
        self.max_depth = int(wl["max_depth"])
        self.lr = float(wl["lr"])
        self.restore = lambda: None
        self.reference_s = 0.0

    def setup(self):
        from ignis_tpu_torch.api import Runtime
        from ignis_tpu_torch.parallel import sharding
        self.sharding = sharding
        w, h = self.film
        scene, self.raw = self.builder.build(self.cfg, self.film,
                                             self.max_depth)
        rt = Runtime(scene, seed=self.seed, device=self.device)
        self.stats = rt.stats
        self.scene = rt.scene
        tables = dict(rt.tables)
        del rt
        pix = torch.arange(w * h, device=self.device)
        self.x, self.y = (pix % w).to(torch.int32), (pix // w).to(torch.int32)
        # the parameters' start: the workload's reflectances over the
        # configuration's
        mats = list(self.cfg["materials"])
        self.kd0 = torch.tensor([self.wl["init"].get(m, self.cfg["materials"][m])
                                 for m in mats], dtype=torch.float32)
        colors = tables["mat_colors"].clone()
        for m, name in enumerate(self.scene.material_names):
            colors[m, 0] = self.kd0[mats.index(name)].to(self.device)
        tables["mat_colors"] = colors
        t0 = time.perf_counter()
        self.target = self._target()
        self.reference_s = time.perf_counter() - t0
        self.p0 = {k: tables[k].detach().clone() for k in LEAVES}
        self.tables = tables
        self._first_steps()

    def _first_steps(self):
        """From p0, the first steps through the window's own call: their
        losses, and the parameters after the first and the last."""
        self.tables.update({k: v.clone() for k, v in self.p0.items()})
        self.it = 0
        # (iteration, the state before the step, its loss) of the last steps
        self.history = collections.deque(maxlen=FIRST_STEPS)
        self.losses, self.p1 = [], None
        for _ in range(FIRST_STEPS):
            self.losses.append(float(self.step()))
            if self.p1 is None:
                self.p1 = {k: self.tables[k].detach().clone() for k in LEAVES}
        self.p3 = {k: self.tables[k].detach().clone() for k in LEAVES}

    def _target(self):
        """The reference's render of the configuration's own scene, the
        mean of `target_spp` samples at a seed of its own."""
        w, h = self.film
        sc = RefScene.from_raw(self.raw, w, h, self.max_depth).to(self.device)
        n = int(self.wl.get("target_spp", 1))
        acc = torch.zeros((w * h, 3), device=self.device)
        with torch.no_grad():
            for s in range(n):
                acc += radiance(sc, self.x.long(), self.y.long(), s,
                                (self.seed + 0x9E3779B9) & 0xFFFFFFFF)
        return acc / n

    def step(self):
        # the state before the step, for the check of the window's last steps
        prev = {k: self.tables[k].detach().clone() for k in LEAVES}
        loss, self.tables = self.sharding.train_step(
            self.scene, self.tables, self.x, self.y, 0, self.it, 0, self.seed,
            self.target, param_keys=LEAVES, lr=self.lr)
        self.history.append((self.it, prev, loss))
        self.it += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return loss

    def break_path(self, fault):
        """Faults of the timed path, to read what the check makes of them:
        a step that returns its state unchanged, half the lanes left out
        (the loss the mean over the rest), every lane's radiance off by
        1 %.  Applied before the first steps, which the check reads."""
        sh = self.sharding
        real_step, real_trace = sh.train_step, sh.trace_wave

        if fault == "unchanged":
            def broken(scene, tables, *a, **kw):
                loss, _ = real_step(scene, tables, *a, **kw)
                return loss, tables
            sh.train_step = broken
        elif fault == "half_batch":
            def broken(scene, tables, x, y, s, i, f, seed, target, **kw):
                n = x.shape[0] // 2
                return real_step(scene, tables, x[:n], y[:n], s, i, f, seed,
                                 target[:n], **kw)
            sh.train_step = broken
        else:
            sh.trace_wave = lambda *a, **kw: real_trace(*a, **kw) * 1.01

        def restore():
            sh.train_step, sh.trace_wave = real_step, real_trace
        self.restore = restore
        self._first_steps()          # again, through the broken path

    # --------------------------------------------------- metric sources
    def work(self):
        return {"train_steps": self.it}

    def table_build_s(self):
        return sum(s.total for k, s in self.stats.sections.items()
                   if k == "loading" or k.startswith("build_"))

    def launch_sampler(self):
        return LaunchSampler("bw_closest", "bw_any", limit=0)

    # ------------------------------------------------------------ check
    def _reference_steps(self, dtype, start, first_it, steps):
        """From `start` (the reference's leaves), `steps` SGD steps from
        iteration `first_it`: their losses, the first step's gradients and
        the change over all of them."""
        w, h = self.film
        sc = RefScene.from_raw(self.raw, w, h, self.max_depth).to(
            self.device, dtype)
        params = {k: v.to(self.device, dtype) for k, v in start.items()}
        target = self.target.to(dtype)
        x, y = self.x.long(), self.y.long()
        losses, first = [], None
        for it in range(first_it, first_it + steps):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            sc_k = RefScene(**{**sc.__dict__, **leaves})
            color = radiance(sc_k, x, y, it, self.seed,
                             bounces=min(self.max_depth, 64), dtype=dtype)
            loss = torch.mean((color - target) ** 2)
            grads = torch.autograd.grad(loss, [leaves[k] for k in REF_LEAVES])
            losses.append(loss.item())
            if first is None:
                first = [g.detach().float() for g in grads]
            params = {k: (leaves[k] - self.lr * g).detach()
                      for k, g in zip(REF_LEAVES, grads)}
            del color, loss, grads, leaves
        change = [(params[k] - start[k].to(self.device, dtype)).float()
                  for k in REF_LEAVES]
        return losses, first, change

    def _as_reference(self, tables):
        """The reference's leaves from the program's tables: each
        material's reflectance (column 0 of its `mat_colors` row), and the
        light rows, which both lay out alike."""
        names = self.scene.material_names
        rows = [names.index(m) for m in self.cfg["materials"]]
        return {"kd": tables["mat_colors"][rows, 0].detach().float(),
                "light_data": tables["light_data"].detach().float()}

    def _followed(self, dtype):
        """The reference's readings: the first steps from p0, and each of
        the window's last steps from the program's state before it (loss,
        gradient)."""
        w, h = self.film
        sc = RefScene.from_raw(self.raw, w, h, self.max_depth)
        p0 = {"kd": self.kd0, "light_data": sc.light_data}
        first = self._reference_steps(dtype, p0, 0, FIRST_STEPS)
        last = []
        for it, prev, _ in self.history:
            losses, grads, _ = self._reference_steps(
                dtype, self._as_reference(prev), it, 1)
            last.append((losses[0], grads))
        return first, last

    def check(self, control=False):
        states = [prev for _, prev, _ in self.history][1:]
        states.append({k: self.tables[k].detach() for k in LEAVES})
        self.tables = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        (losses, first, change), last = self._followed(torch.float32)
        if control:
            # the control's readings in the program's place
            (p_losses, p_first, p_change), p_last = \
                self._followed(torch.bfloat16)
        else:
            p_losses = self.losses
            p_first = [(self.p0[k] - self.p1[k]) / self.lr for k in LEAVES]
            p_change = [self.p3[k] - self.p0[k] for k in LEAVES]
            p_last = [(float(loss), [(prev[k] - nxt[k]) / self.lr
                                     for k in LEAVES])
                      for (_, prev, loss), nxt in zip(self.history, states)]
        numbers = {
            "loss_gap": median_gap(map(rel_gap, p_losses, losses)),
            "grad_gap": norm_gap(p_first, first),
            "change_gap": norm_gap(p_change, change),
            "last_loss_gap": median_gap(
                rel_gap(p[0], r[0]) for p, r in zip(p_last, last)),
            "last_grad_gap": median_gap(
                norm_gap(p[1], r[1]) for p, r in zip(p_last, last))}
        limits = self.wl["limits"]
        return {k: {"value": v, "limit": float(limits[k])}
                for k, v in numbers.items()}
