"""Progressive rendering of a participating medium: `Runtime.step(spi)` back
to back under `volpath`, as igcli and igview call it, on a scene whose
configuration builder takes the run's device (the grid is made there).

The check is the render entry's (`entries/render.py`): a sample of the
film's pixels drawn from the seed, each the sum of every sample the run
rendered into it, against the plain `volpath` reference
(`reference/volpath.py`) tracing the same paths with the same random
numbers; a pixel mismatches when a channel differs by more than `rtol` of
the reference's value plus `atol` a sample.  Compared: the share of sampled
pixels that mismatch, and the gap between the samples a pixel the program
counts and those the run asked for (exact).  The control puts the
reference's sums in bfloat16 in the program's place.

Metric sources beyond the render entry's: the runtime's media counters
(`MediumNullEvents`, `MediumScatters`, `MediumAbsorbs`, `RatioFlights`,
`MediumLookups` of `dumpStats`), read by `work()`; a program that keeps
none of them reads nothing.  The traced window's part of them
is `CountedWindow.counts`, which the readers find as `run.sampler.counts`.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.entries import render
from benchmark.reference.volpath import VolScene, radiance
from benchmark.roofline import LaunchSampler

LANES = 1 << 18           # reference lanes a call
MEDIUM_KEYS = ("MediumNullEvents", "MediumScatters", "MediumAbsorbs",
               "RatioFlights", "MediumLookups")


class CountedWindow(LaunchSampler):
    """A `LaunchSampler` that samples nothing and keeps, in `counts`, what
    each of the entry's `work()` counters gained while it was open: the
    traced window's part."""

    def __init__(self, entry):
        super().__init__("bw_closest", "bw_any", limit=0)
        self.entry = entry
        self.counts = {}

    def __enter__(self):
        self._start = self.entry.work()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        end = self.entry.work()
        self.counts = {k: v - self._start.get(k, 0) for k, v in end.items()}


class Cell(render.Cell):
    def setup(self):
        from ignis_tpu_torch.api import Runtime
        if self.device.type == "cpu":
            # a CPU run (the tests' tiny cells): one intra-op thread, faster
            # for these small waves and steady beside other processes; the
            # count is given back by `restore`
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            self.restore = lambda: torch.set_num_threads(threads)
        scene, self.raw = self.builder.build(self.cfg, self.film,
                                             self.max_depth,
                                             device=self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()      # the grid's making, not a table
        self.rt = Runtime(scene, seed=self.seed, device=self.device)
        t0 = time.perf_counter()
        for _ in range(int(self.wl.get("warmup_steps", 1))):
            self.step()
        self.warm_step_s = (time.perf_counter() - t0) / max(self.steps_called,
                                                              1)

    def break_path(self, fault):
        """The render entry's faults; `restore` undoes them and gives the
        thread count back."""
        before = self.restore
        super().break_path(fault)
        broken = self.restore
        self.restore = lambda: (broken(), before())

    # --------------------------------------------------- metric sources
    def work(self):
        """The wavefront's iteration counters and the media's counters so
        far (those the program keeps)."""
        out = super().work()
        q = self.rt.stats.quantities
        out.update({k: q[k] for k in MEDIUM_KEYS if k in q})
        return out

    def launch_sampler(self):
        """The traced window's bracket: no traversal launch is sampled (no
        roofline reads this cell); the counters are read as it opens and
        closes, outside the window's clock (`CountedWindow.counts`)."""
        return CountedWindow(self)

    # ------------------------------------------------------------ check
    def _reference(self, sc, x, y, samples, dtype):
        """Sum over iterations 0..samples-1 of each pixel's paths."""
        p = x.shape[0]
        out = torch.zeros((p, 3), dtype=torch.float64, device=x.device)
        lane_pix = torch.arange(p, device=x.device).repeat(samples)
        lane_it = torch.arange(samples, device=x.device).repeat_interleave(p)
        for s in range(0, lane_pix.shape[0], LANES):
            pix, it = lane_pix[s:s + LANES], lane_it[s:s + LANES]
            rad = radiance(sc, x[pix], y[pix], it, self.seed, dtype=dtype)
            out.index_add_(0, pix, rad.double())
        return out

    def check(self, control=False):
        wl = self.wl
        w, h = self.film
        asked = self.steps_called * self.spi
        counted = self.rt.currentSampleCount()
        samples = min(asked, counted)
        gen = torch.Generator().manual_seed(self.seed)
        npix = w * h
        p = min(int(wl["check_pixels"]), npix)
        idx = torch.randperm(npix, generator=gen)[:p]
        fb = self.rt.rawFramebuffer().reshape(-1, 3)
        prog = torch.from_numpy(np.ascontiguousarray(fb[idx.numpy()]))
        prog = prog.double().to(self.device)
        del self.rt
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        idx = idx.to(self.device)
        x, y = idx % w, idx // w
        base = VolScene.from_raw(self.raw, w, h, self.max_depth)
        if control:
            # the control: the reference in bfloat16, in the program's place
            prog = self._reference(base.to(self.device, torch.bfloat16), x,
                                   y, samples, torch.bfloat16)
        ref = self._reference(base.to(self.device), x, y, samples,
                              torch.float32)
        rtol, atol = float(wl["rtol"]), float(wl["atol"])
        return {"sample_count_gap": {"value": abs(counted - asked),
                                     "limit": 0},
                "mismatch_share": {
            "value": render.mismatch_share(prog, ref, samples, rtol, atol),
            "limit": float(wl["limits"]["mismatch_share"])}}
