"""Progressive rendering: `Runtime.step(spi)` back to back, as igcli and
igview call it.

The check: a sample of the film's pixels, drawn from the seed, each
holding the sum of every sample the run rendered into it (warm-up and
window).  The reference traces the same paths (same pixel, iteration and
seed, so the same random numbers) and sums them; a pixel mismatches when a
channel differs by more than `rtol` of the reference's value plus `atol`
a sample.  Rounding moves a sum by about 1e-6 of it; a path that took
another turn moves it by about one sample's radiance.  Compared: the share
of sampled pixels that mismatch, and the gap between the samples a pixel
the program counts and those the run asked for (exact).  Where the two
differ, the pixels are compared over the samples both hold.  The control
puts the reference's sums in bfloat16 in the program's place.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.reference.pathtracer import RefScene, radiance
from benchmark.roofline import LaunchSampler

LANES = 1 << 18           # reference lanes a call


def mismatch_share(prog, ref, samples, rtol, atol):
    """Share of pixels (rows) with a channel outside the tolerance."""
    bad = ((prog - ref).abs() > rtol * ref.abs() + atol * samples).any(-1)
    return float(bad.float().mean())


class Cell:
    def __init__(self, wl, cfg, builder, seed, device):
        self.wl, self.cfg, self.builder = wl, cfg, builder
        self.seed, self.device = seed, device
        self.film = wl.get("film", cfg["film"])
        self.max_depth = int(wl.get("max_depth", cfg["max_depth"]))
        self.spi = int(wl.get("spi", 1))
        self.steps_called = 0
        self.restore = lambda: None

    @property
    def work_per_step(self):
        return self.film[0] * self.film[1] * self.spi

    def setup(self):
        from ignis_tpu_torch.api import Runtime
        scene, self.raw = self.builder.build(self.cfg, self.film,
                                             self.max_depth)
        self.rt = Runtime(scene, seed=self.seed, device=self.device)
        ops, *names = self._traversal()
        closest, any_ = (getattr(ops, n) for n in names)
        calls = closest.launches + any_.launches
        t0 = time.perf_counter()
        for _ in range(int(self.wl.get("warmup_steps", 1))):
            self.step()
        # launches of the traversal a step, and a step's seconds, to spread
        # the traced window's sampled launches over it
        self.warm_step_s = (time.perf_counter() - t0) / max(self.steps_called,
                                                              1)
        self.calls_per_step = (closest.launches + any_.launches
                               - calls) / max(self.steps_called, 1)

    def step(self):
        self.rt.step(spi=self.spi)
        self.steps_called += 1

    def break_path(self, fault):
        """Faults of the timed path, to read what the check makes of them:
        a step that changes nothing, half the film left out (the rest
        counted double, so the frame's mean holds), every sample's radiance
        off by 1 %."""
        import ignis_tpu_torch.api as api
        if fault == "unchanged":
            self.rt.step = lambda spi=1: None
            return
        real = api.render_wavefront

        def broken(*a, **kw):
            fb, stats = real(*a, **kw)
            if fault == "altered":
                return fb * 1.01, stats
            # half the film's pixels left out, the rest counted double
            half = fb.shape[0] // 2
            fb = torch.cat([2.0 * fb[:half], torch.zeros_like(fb[half:])])
            return fb, stats
        api.render_wavefront = broken
        self.restore = lambda: setattr(api, "render_wavefront", real)

    # --------------------------------------------------- metric sources
    def work(self):
        """The wavefront's iteration counters so far: full-width and tail
        iterations (the tail's count follows the longest paths)."""
        self.rt.dumpStats()
        q = self.rt.stats.quantities
        return {"wave_iters": q.get("WaveIterations", 0),
                "tail_iters": q.get("TailIterations", 0)}

    def table_build_s(self):
        secs = self.rt.stats.sections
        return sum(s.total for k, s in secs.items()
                   if k == "loading" or k.startswith("build_"))

    def _traversal(self):
        """The soup's traversal module and its closest / any-hit entries,
        as the render's dispatch picks them."""
        if "pb_rows" in self.rt.tables:
            from ignis_tpu_torch.ops import packet_bvh
            return packet_bvh, "packet_bvh_closest", "packet_bvh_any"
        from ignis_tpu_torch.ops import bw_intersect
        return bw_intersect, "bw_closest", "bw_any"

    def launch_sampler(self):
        _, closest, any_ = self._traversal()
        limit = int(self.wl.get("sampled_launches", 24))
        steps = (float(self.wl.get("trace_seconds", 1.0))
                 / max(self.warm_step_s, 1e-3))
        stride = self.calls_per_step * steps / max(limit, 1)
        return LaunchSampler(closest, any_, limit=limit, stride=stride)

    # ------------------------------------------------------------ check
    def _reference(self, sc, x, y, samples, dtype):
        """Sum over iterations 0..samples-1 of each pixel's paths."""
        p = x.shape[0]
        out = torch.zeros((p, 3), dtype=torch.float64, device=x.device)
        lane_pix = torch.arange(p, device=x.device).repeat(samples)
        lane_it = torch.arange(samples, device=x.device).repeat_interleave(p)
        for s in range(0, lane_pix.shape[0], LANES):
            pix, it = lane_pix[s:s + LANES], lane_it[s:s + LANES]
            with torch.no_grad():
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
        base = RefScene.from_raw(self.raw, w, h, self.max_depth)
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
            "value": mismatch_share(prog, ref, samples, rtol, atol),
            "limit": float(wl["limits"]["mismatch_share"])}}
