"""Roofline bounds of the traversal kernels: the least time an H100 could
take for the work that a launch's rays needed, whatever implements it.

A frozen copy of the arithmetic that `chip_smoke.py` keeps for the same
kernels (`_bound`, `bw_bound`, `pb_bound` and the counting they read): the
work is what each ray's final window needs, [tmin, t] of a closest-hit ray
and [tmin, tmax] of an unoccluded any-hit ray, plus one triangle test an
occluded ray.  Counted here from the tables the kernel reads, by plain
PyTorch, after the traced window.

Peaks: NVIDIA H100 SXM data sheet, dense rates: 3.35 TB/s of HBM3 and
67 TFLOP/s float32 outside the tensor cores; a fused multiply-add counts as
two operations, as the sheet counts it.  They hold at the 700 W power
limit; the run records the card's limit beside them.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# float32 operations a test, counted from the kernels' sources: a slab test
# of a box, a Baldwin-Weber triangle test, a Moeller-Trumbore test
OPS_BOX, OPS_BW_TRI, OPS_MT_TRI = 25, 48, 54
BW_TILE = 8               # triangles of a Baldwin-Weber cluster
PB_WIDTH = 8              # children of a packet-BVH row, records of a leaf
PB_TYPE_LANE = 126        # a packet-BVH row's leaf flag
PB_MISSING = -1e9 * 0.5   # child-id lanes at or below this are empty
PAIR_CHUNK = 1 << 22


def bound_s(nbytes, ops):
    """max(bytes / bandwidth, operations / float32 peak), in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)


def _inv(d):
    return 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)


def _slab(lo, hi, org, inv, tmin, tmax):
    """Rays (N, 3) against boxes (N, K, 3): does [tmin, tmax] cross?"""
    t0 = (lo - org[:, None]) * inv[:, None]
    t1 = (hi - org[:, None]) * inv[:, None]
    near = torch.maximum(torch.minimum(t0, t1).amax(-1), tmin[:, None])
    far = torch.minimum(torch.maximum(t0, t1).amin(-1), tmax[:, None])
    return near <= far


def bw_needed(tables, org, d, tmin, tmax):
    """(ray, cluster) crossings of each ray's window: the clusters a
    Baldwin-Weber walk must enter, whatever its order."""
    cl = tables["bw_clusters"].float()
    cl = cl[cl[:, 6] > 0]
    inv = _inv(d.float())
    n = 0
    for i in range(0, org.shape[0], max(1, PAIR_CHUNK // max(cl.shape[0], 1))):
        s = slice(i, i + max(1, PAIR_CHUNK // max(cl.shape[0], 1)))
        m = org[s].shape[0]
        n += int(_slab(cl[None, :, 0:3].expand(m, -1, -1),
                       cl[None, :, 3:6].expand(m, -1, -1), org[s].float(),
                       inv[s], tmin[s].float(), tmax[s].float()).sum())
    return n


def bw_bound_s(tables, launch):
    """Bound of one `bw_closest` / `bw_any` launch (`launch`: kind, rays,
    the final t or the occlusion)."""
    org, d, tmin, tmax = launch["rays"]
    n = org.shape[0]
    any_hit = launch["kind"] == "any"
    nbytes = ((tables["bw_tris"].numel() + tables["bw_clusters"].numel()) * 4
              + n * 32 + n * (1 if any_hit else 16))
    if any_hit:
        occ = launch["occluded"]
        free = ~occ
        entered = int(occ.sum()) + bw_needed(tables, org[free], d[free],
                                             tmin[free], tmax[free])
    else:
        entered = bw_needed(tables, org, d, tmin, launch["t"])
    return bound_s(nbytes, entered * (OPS_BOX + BW_TILE * OPS_BW_TRI))


def pb_needed(tables, org, d, tmin, tmax):
    """The packet-BVH walk over each ray's window, level by level: inner
    rows visited, triangle records tested (those with mask bits), and the
    distinct inner rows and records the walk reads."""
    rows = tables["pb_rows"]
    dev = rows.device
    org, d = org.float(), d.float()
    inv = _inv(d)
    tmin, tmax = tmin.float(), tmax.float()
    ray = torch.arange(org.shape[0], device=dev)
    row = torch.zeros_like(ray)
    touched = torch.zeros(rows.shape[0], dtype=torch.bool, device=dev)
    inner_visits = tri_tests = 0
    rec_nonzero = (rows[:, 9:16 * PB_WIDTH:16] != 0).sum(1)
    while ray.numel():
        touched[row] = True
        r = rows[row]
        leaf = r[:, PB_TYPE_LANE] > 0.5
        tri_tests += int(rec_nonzero[row[leaf]].sum())
        inner = ~leaf
        inner_visits += int(inner.sum())
        nxt_ray, nxt_row = [], []
        ir, irow = ray[inner], row[inner]
        for i in range(0, ir.numel(), PAIR_CHUNK // PB_WIDTH):
            rr, rw = ir[i:i + PAIR_CHUNK // PB_WIDTH], \
                irow[i:i + PAIR_CHUNK // PB_WIDTH]
            b = rows[rw][:, :6 * PB_WIDTH].reshape(-1, PB_WIDTH, 6)
            ev = rows[rw][:, 64:64 + PB_WIDTH]
            push = (_slab(b[..., 0:3], b[..., 3:6], org[rr], inv[rr],
                          tmin[rr], tmax[rr]) & (ev > PB_MISSING))
            pr, pc = push.nonzero(as_tuple=True)
            nxt_ray.append(rr[pr])
            nxt_row.append(ev[pr, pc].long())
        ray = torch.cat(nxt_ray) if nxt_ray else ray[:0]
        row = torch.cat(nxt_row) if nxt_row else row[:0]
    is_leaf = rows[:, PB_TYPE_LANE] > 0.5
    return dict(inner_visits=inner_visits, tri_tests=tri_tests,
                inner_rows_touched=int((touched & ~is_leaf).sum()),
                records_touched=int(rec_nonzero[touched & is_leaf].sum()))


def pb_bound_s(tables, launch):
    """Bound of one `packet_bvh_closest` / `_any` launch: 8 box tests an
    inner row visited, a test a triangle record of a leaf visited, one test
    an occluded ray; bytes: the distinct inner rows at 28 bytes a child,
    the distinct records at 44 bytes, rays in, results out."""
    org, d, tmin, tmax = launch["rays"]
    n = org.shape[0]
    any_hit = launch["kind"] == "any"
    occluded = 0
    if any_hit:
        occ = launch["occluded"]
        occluded = int(occ.sum())
        need = pb_needed(tables, org[~occ], d[~occ], tmin[~occ], tmax[~occ])
    else:
        need = pb_needed(tables, org, d, tmin, launch["t"])
    nbytes = (n * 32 + n * (1 if any_hit else 16)
              + need["inner_rows_touched"] * PB_WIDTH * 28
              + need["records_touched"] * 44)
    ops = (need["inner_visits"] * PB_WIDTH * OPS_BOX
           + (need["tri_tests"] + occluded) * OPS_MT_TRI)
    return bound_s(nbytes, ops)


class LaunchSampler:
    """While active, records the rays and results of every `stride`-th
    launch, up to `limit`, of a pair of traversal entries that the render's
    dispatch calls (names in `ignis_tpu_torch.render.integrator`), and a
    None for each other launch.  References, not copies: the wavefront
    makes new tensors each bounce, and a copy would add device work to the
    traced window."""

    def __init__(self, closest, any_, limit=24, stride=1):
        self.names = (closest, any_)
        self.limit = int(limit)
        self.stride = max(1, int(stride))
        self.launches = []
        self._saved = None

    def __enter__(self):
        from ignis_tpu_torch.render import integrator
        self._saved = {n: getattr(integrator, n) for n in self.names}
        for name, kind in zip(self.names, ("closest", "any")):
            setattr(integrator, name, self._wrap(self._saved[name], kind))
        return self

    def __exit__(self, *exc):
        from ignis_tpu_torch.render import integrator
        for n, f in self._saved.items():
            setattr(integrator, n, f)

    def _wrap(self, fn, kind):
        def call(tables, org, d, tmin, tmax, *a, **kw):
            out = fn(tables, org, d, tmin, tmax, *a, **kw)
            if not org.shape[0]:
                return out                    # nothing was launched
            k = len(self.launches)
            if k % self.stride == 0 and k // self.stride < self.limit:
                rec = dict(kind=kind, rays=tuple(
                    x.detach() for x in (org, d, tmin, tmax)))
                if kind == "any":
                    rec["occluded"] = out.detach()
                else:
                    rec["t"] = out[0].detach()
                self.launches.append(rec)
            else:
                self.launches.append(None)
            return out
        return call


def roofline_pct(trace, sampler, kernel, tables, bound_fn):
    """100 x the sampled launches' bounds over their device time: the
    k-th launch of the entries is the k-th device operation whose name
    holds `kernel` in the traced window.  None where nothing was sampled
    or the trace holds no such operation."""
    events = trace.named(kernel)
    pairs = [(rec, ev) for rec, ev in zip(sampler.launches, events)
             if rec is not None]
    if not pairs or len(events) != len(sampler.launches):
        return None
    bound = sum(bound_fn(tables, rec) for rec, _ in pairs)
    device = sum(ev[2] - ev[1] for _, ev in pairs)
    return 100.0 * bound / device if device > 0 else None
