"""Light hierarchy selector: point-BVH importance sampling of many lights.

Counterpart of ignis_tpu/light/hierarchy.py (after Moreau & Clarberg,
"Importance Sampling of Many Lights on the GPU", Ray Tracing Gems ch. 18).
The host build is a copy of the JAX package's numpy code and gives the same
tables: a median-split binary tree over the finite lights, each entry its
position, signed flux and direction, `lh_child` (leaf: local light index;
inner: -(left + 1)), `lh_right` and each light's backtrack code (bit i set:
right turn at depth i).

The descent is a fixed loop of `depth` steps with per-lane leaf masks.  A
lane that reaches a leaf stays there and its counter advances only on inner
steps, so its k-th draw always reads counter c0 + k: `hierarchy_sample`
makes all `depth` draws in one batched call and then descends.  The
selection probabilities carry no gradient (the tables are host-built, as
the JAX package's are).
"""

from __future__ import annotations

import numpy as np
import torch

from ignis_tpu_torch.core import rng
from ignis_tpu_torch.core.dgather import gather_rows
from ignis_tpu_torch.core.vec import maximum, safe_div


# ------------------------------------------------------------------- build
def build_light_hierarchy(pos, dirs, has_dir, flux):
    """Median-split point BVH over finite lights.

    pos (L,3), dirs (L,3), has_dir (L,), flux (L,) — positive estimates.
    Returns dict(lh_pos (E,3), lh_flux (E,) signed, lh_dir (E,3),
    lh_child (E,) int32 [leaf: local light index; inner: -(left+1), right
    child = left+1], lh_codes (L,) uint32, lh_depth python int).
    """
    pos = np.asarray(pos, np.float32).reshape(-1, 3)
    dirs = np.asarray(dirs, np.float32).reshape(-1, 3)
    has_dir = np.asarray(has_dir, bool).reshape(-1)
    flux = np.asarray(flux, np.float32).reshape(-1)
    n = pos.shape[0]
    assert n >= 1

    entries = []          # (pos, flux_signed, dir, child_code)
    codes = np.zeros(n, np.uint32)
    max_depth = [1]

    def emit():
        entries.append([np.zeros(3, np.float32), 0.0,
                        np.zeros(3, np.float32), 0])
        return len(entries) - 1

    def build(idx, code, depth):
        """Returns (entry_index, pos, flux_signed, dir)."""
        me = emit()
        max_depth[0] = max(max_depth[0], depth + 1)
        if len(idx) == 1:
            li = int(idx[0])
            f = float(flux[li])
            fs = f if has_dir[li] else -f
            d = dirs[li] if has_dir[li] else np.float32([0, 0, 1])
            entries[me] = [pos[li], fs, d, li]
            codes[li] = code
            return me, pos[li], fs, d
        p = pos[idx]
        axis = int(np.argmax(p.max(0) - p.min(0)))
        order = np.argsort(p[:, axis], kind="stable")
        half = len(idx) // 2
        left_idx = idx[order[:half]]
        right_idx = idx[order[half:]]
        # children must be contiguous (entry.id -> left, left+1 -> right):
        # reserve nothing here — build left, then right, then fix `me`.
        lidx, lp, lf, ld = build(left_idx, code, depth + 1)
        ridx, rp, rf, rd = build(right_idx,
                                 code | np.uint32(1 << depth), depth + 1)
        # NOTE: reference loads children at (id, id+1); our recursive build
        # does not place siblings adjacently, so lh_child stores the left
        # child index and lh_right stores the right one explicitly.
        center = (p.min(0) + p.max(0)) * 0.5
        # delta flux sign handling (LightHierarchy.cpp:63-77)
        if lf < 0 and rf < 0:
            d = np.float32([0, 0, 1])
            fs = lf + rf
        elif lf < 0:
            d = np.float32([0, 0, 1])
            fs = -(-lf + rf)
        elif rf < 0:
            d = np.float32([0, 0, 1])
            fs = -(lf - rf)
        else:
            s = ld + rd
            nl = np.linalg.norm(s)
            d = (s / nl if nl > 1e-12 else np.float32([0, 0, 1]))
            fs = lf + rf
        entries[me] = [center, fs, d, -(lidx + 1)]
        _right[me] = ridx
        return me, center, fs, d

    _right = {}
    build(np.arange(n), np.uint32(0), 0)
    e = len(entries)
    lh_pos = np.stack([x[0] for x in entries]).astype(np.float32)
    lh_flux = np.asarray([x[1] for x in entries], np.float32)
    lh_dir = np.stack([np.asarray(x[2], np.float32) for x in entries])
    lh_child = np.asarray([x[3] for x in entries], np.int32)
    lh_right = np.zeros(e, np.int32)
    for k, v in _right.items():
        lh_right[k] = v
    if max_depth[0] > 32:
        raise ValueError("light hierarchy deeper than 32 (code bits)")
    return dict(lh_pos=lh_pos, lh_flux=lh_flux, lh_dir=lh_dir,
                lh_child=lh_child, lh_right=lh_right,
                lh_codes=codes), int(max_depth[0])


# ---------------------------------------------------------------- traversal
def _entry_cost(tables, node, from_pos):
    """flux * |cos(dir, to-node)| / dist^2."""
    p = gather_rows(tables["lh_pos"], node)
    f = gather_rows(tables["lh_flux"], node)
    d = gather_rows(tables["lh_dir"], node)
    cdir = p - from_pos
    dist2 = torch.sum(cdir * cdir, dim=-1)
    inv_len = safe_div(1.0, torch.sqrt(maximum(dist2, 1e-20)))
    cosd = torch.where(f >= 0.0,
                       torch.abs(torch.sum(d * cdir, dim=-1) * inv_len),
                       torch.ones_like(dist2))
    return safe_div(torch.abs(f) * cosd, dist2)


def _left_prop(tables, left, right, from_pos):
    cl = _entry_cost(tables, left, from_pos)
    cr = _entry_cost(tables, right, from_pos)
    return 1.0 / (1.0 + safe_div(cr, cl))


def _step(tables, node, from_pos):
    """(is_inner, left, right, left-branch probability) at `node`."""
    ch = tables["lh_child"][node]
    is_inner = ch < 0
    left = torch.where(is_inner, -ch - 1, node)
    right = torch.where(is_inner, tables["lh_right"][node], node)
    return is_inner, left, right, _left_prop(tables, left, right, from_pos)


def _draws(seed, counter, depth):
    """The `depth` uniform draws of a descent, (N, depth): draw k at
    counter + k."""
    k = torch.arange(depth, dtype=torch.int64, device=counter.device)
    u, _ = rng.next_f32(seed[:, None] if torch.is_tensor(seed) else seed,
                        (counter[:, None] + k) & rng.M32)
    return u


def hierarchy_sample(tables, from_pos, seed, counter, active, depth):
    """Descend the hierarchy; returns (local light index, pdf, counter).

    An active lane's k-th inner step reads counter + k; an inactive lane
    never advances, so every step of it reads `counter` (draw 0)."""
    n = from_pos.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=from_pos.device)
    pdf = torch.ones(n, dtype=torch.float32, device=from_pos.device)
    if depth <= 0:
        return torch.clamp_min(tables["lh_child"][node], 0), pdf, counter
    us = _draws(seed, counter, depth)
    steps = torch.zeros(n, dtype=torch.int64, device=from_pos.device)
    for k in range(depth):
        is_inner, left, right, prop = _step(tables, node, from_pos)
        u = torch.where(active, us[:, k], us[:, 0])
        go_left = u < prop
        node = torch.where(is_inner, torch.where(go_left, left, right), node)
        pdf = pdf * torch.where(is_inner, torch.where(go_left, prop, 1.0 - prop),
                                torch.ones_like(prop))
        steps = steps + is_inner.to(torch.int64)
    counter = torch.where(active, (counter + steps) & rng.M32, counter)
    leaf = tables["lh_child"][node]
    return torch.clamp_min(leaf, 0), pdf, counter


def hierarchy_pdf(tables, local_idx, from_pos, depth):
    """pdf of selecting finite light `local_idx` from `from_pos`: a replay of
    the descent along the light's backtrack code."""
    n = from_pos.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=from_pos.device)
    pdf = torch.ones(n, dtype=torch.float32, device=from_pos.device)
    code = gather_rows(tables["lh_codes"], local_idx)
    for _ in range(depth):
        is_inner, left, right, prop = _step(tables, node, from_pos)
        go_left = (code & 1) == 0
        node = torch.where(is_inner, torch.where(go_left, left, right), node)
        pdf = pdf * torch.where(is_inner, torch.where(go_left, prop, 1.0 - prop),
                                torch.ones_like(prop))
        code = torch.where(is_inner, code >> 1, code)
    return pdf
