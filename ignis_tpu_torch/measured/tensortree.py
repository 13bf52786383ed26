"""Tensor-tree measured BSDF: loader and batched evaluation.

Counterpart of ignis_tpu/measured/tensortree.py.  The loader (Radiance
TensorTree3/4 XML with Shirley-Chiu parameterised adaptive quad / oct trees,
flattened to a node int array -- inner: child block start; leaf: -(value
offset)-1 -- and a value float array whose negative sign bit marks a
single-value leaf) and the table builder are the JAX package's, copied.
The lookup is torch: a per-lane tree climb with masked descent, as many
levels as the tree is deep.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import torch

from ignis_tpu_torch.core.vec import safe_sqrt, to_int32


def _strip_ns(tag):
    return tag.split("}")[-1]


def _find(el, name):
    for c in el.iter():
        if _strip_ns(c.tag) == name:
            return c
    return None


def _findall(el, name):
    return [c for c in el.iter() if _strip_ns(c.tag) == name]


class _Node:
    __slots__ = ("children", "values")

    def __init__(self):
        self.children = []
        self.values = []

    def total(self, depth):
        area = 1.0 / (depth * (len(self.values) + len(self.children)))
        t = sum(c.total(depth + 1) for c in self.children)
        t += sum(np.pi * v * area for v in self.values)
        return t


def _parse_scatter(text, max_vals):
    root = _Node()
    stack = [root]
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "{":
            child = _Node()
            stack[-1].children.append(child)
            stack.append(child)
            i += 1
        elif c == "}":
            stack.pop()
            i += 1
        elif c in ", \t\r\n":
            i += 1
        else:
            node = stack[-1]
            while i < n and len(node.values) < max_vals:
                while i < n and text[i] in ", \t\r\n":
                    i += 1
                if i >= n or text[i] == "}":
                    break
                j = i
                while j < n and text[j] not in ", \t\r\n}{":
                    j += 1
                node.values.append(abs(float(text[i:j])))
                i = j
    return root


def _flatten(root, ndim):
    max_vals = 1 << ndim
    nodes = []
    values = []
    root_is_leaf = not root.children

    def add(node, parent_slot):
        if not node.children:
            off = len(values)
            if parent_slot is not None:
                nodes[parent_slot] = -(off + 1)
            if len(node.values) == 1:
                values.append(-abs(node.values[0]))  # signbit = single value
            else:
                values.extend(node.values)
        else:
            off = len(nodes)
            if parent_slot is not None:
                nodes[parent_slot] = off
            nodes.extend([0] * len(node.children))
            for i, ch in enumerate(node.children):
                add(ch, off + i)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(100000)
    try:
        add(root, None)
    finally:
        sys.setrecursionlimit(old)
    if not nodes:
        nodes = [-1] * max_vals
    # use copysign to preserve -0.0 single-value leaves
    vals = np.asarray(values, np.float32) if values else np.asarray([-0.0], np.float32)
    return (np.asarray(nodes, np.int32), vals, root_is_leaf)


def load_tensortree_xml(path: str | Path):
    tree = ET.parse(path)
    root = tree.getroot()
    layer = _find(root, "Layer")
    datadef = _find(layer, "DataDefinition")
    struct = _find(datadef, "IncidentDataStructure").text.strip()
    ndim = 4 if struct == "TensorTree4" else 3
    max_vals = 1 << ndim

    comps = {}
    for wd in _findall(layer, "WavelengthData"):
        block = _find(wd, "WavelengthDataBlock")
        if block is None:
            continue
        scat = _find(block, "ScatteringData")
        if scat is None:
            continue
        proot = _parse_scatter(scat.text, max_vals)
        if len(proot.children) == 1:
            only = proot.children[0]
            proot.values, proot.children = only.values, only.children
        total = proot.total(1)
        nodes, values, root_is_leaf = _flatten(proot, ndim)
        comp = dict(nodes=nodes, values=values, root_is_leaf=root_is_leaf,
                    total=float(total), ndim=ndim)
        direction = (_find(block, "WavelengthDataDirection").text.strip()
                     if _find(block, "WavelengthDataDirection") is not None
                     else "Transmission Front")
        if direction == "Transmission Front":
            comps["back_transmission"] = comp
        elif direction in ("Scattering Back", "Reflection Back"):
            comps["front_reflection"] = comp
        elif direction == "Transmission Back":
            comps["front_transmission"] = comp
        else:
            comps["back_reflection"] = comp

    black = dict(nodes=np.full(max_vals, -1, np.int32),
                 values=np.asarray([-0.0], np.float32),
                 root_is_leaf=False, total=0.0, ndim=ndim)
    comps.setdefault("front_reflection", black)
    comps.setdefault("back_reflection", black)
    ft = comps.get("front_transmission")
    bt = comps.get("back_transmission")
    if bt is None or (ft is not None and bt["total"] <= 1e-7):
        bt = ft
    if ft is None or (bt is not None and ft["total"] <= 1e-7):
        ft = bt
    comps["front_transmission"] = ft or black
    comps["back_transmission"] = bt or black
    comps["ndim"] = ndim
    return comps


_COMP_ORDER = ("front_reflection", "front_transmission",
               "back_reflection", "back_transmission")


def tensortree_tables(comps, prefix):
    tables = {}
    info = {"totals": [comps[k]["total"] for k in _COMP_ORDER],
            "ndim": comps["ndim"],
            "root_is_leaf": [comps[k]["root_is_leaf"] for k in _COMP_ORDER]}
    for k in _COMP_ORDER:
        tables[f"{prefix}_{k}_nodes"] = comps[k]["nodes"]
        tables[f"{prefix}_{k}_vals"] = comps[k]["values"]
    return tables, info


def _concentric_disk_to_square(p):
    """The inverse of the concentric square-to-disk map."""
    x, y = p[..., 0], p[..., 1]
    quadrant = torch.abs(x) > torch.abs(y)
    r_sign = torch.where(quadrant, x, y)
    r = torch.copysign(safe_sqrt(x * x + y * y), r_sign)
    phi = torch.atan2(y * torch.sign(r_sign), x * torch.sign(r_sign))
    c = 4.0 * phi / math.pi
    t = torch.where(quadrant, c, 2.0 - c) * r
    a = torch.where(quadrant, r, t)
    b = torch.where(quadrant, t, r)
    return torch.stack([(a + 1.0) * 0.5, (b + 1.0) * 0.5], dim=-1)


def tree_levels(nodes, ndim):
    """Levels of a flattened tree (numpy node array): the most steps any
    lookup descends before it reaches a leaf."""
    nodes = np.asarray(nodes)
    width = 1 << ndim
    levels, blocks = 0, [0]
    while blocks:
        levels += 1
        nxt = []
        for b in blocks:
            for v in nodes[b:b + width]:
                if v >= 0:
                    nxt.append(int(v))
        blocks = nxt
    return levels


def tt_eval_component(tables, prefix, comp, info_idx, info, in_dir, out_dir):
    """The value of one component at (in_dir, out_dir): a batched climb
    down the flattened tree, then the leaf's value."""
    ndim = info["ndim"]
    nodes = tables[f"{prefix}_{comp}_nodes"]
    vals = tables[f"{prefix}_{comp}_vals"]
    root_is_leaf = info["root_is_leaf"][info_idx]

    out_pos = _concentric_disk_to_square(out_dir[..., :2])
    if ndim == 3:
        in_t = ((0.5 - 1.1920929e-07)
                - 0.5 * safe_sqrt(in_dir[..., 0] ** 2 + in_dir[..., 1] ** 2))
        pos = torch.stack([in_t, out_pos[..., 0], out_pos[..., 1],
                           torch.zeros_like(in_t)], dim=-1)
    else:
        in_pos = _concentric_disk_to_square(-in_dir[..., :2])
        pos = torch.stack([in_pos[..., 0], in_pos[..., 1],
                           out_pos[..., 0], out_pos[..., 1]], dim=-1)
    pos = torch.clamp(pos, 0.0, 1.0 - 1e-7)
    nv_max = vals.shape[0] - 1

    if root_is_leaf:
        v0 = vals[0]
        nidx = _leaf_index(pos, ndim)
        return torch.where(torch.signbit(v0), -v0,
                           vals[torch.clamp(nidx, 0, nv_max)])

    shifts = torch.arange(ndim, dtype=torch.int64, device=pos.device)
    # the tree's depth, found once on the host and kept with the
    # component's static info
    levels = info.setdefault("levels", {})
    if comp not in levels:
        levels[comp] = tree_levels(nodes.cpu().numpy(), ndim)
    n = pos.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=pos.device)
    done = torch.zeros(n, dtype=torch.bool, device=pos.device)
    leaf = torch.zeros(n, dtype=torch.int64, device=pos.device)
    p = pos
    for _ in range(levels[comp]):
        # the child of each lane's block: one bit per dimension
        p2 = 2.0 * p[..., :ndim]
        t = (p2 >= 1.0).to(torch.int64)
        nidx = torch.sum(t << shifts, dim=-1)
        rem = p2 - t.to(torch.float32)
        if ndim == 3:
            rem = torch.cat([rem, p[..., 3:4]], dim=-1)
        nv = nodes[torch.clamp(node + nidx, 0, nodes.shape[0] - 1)].long()
        is_leaf = nv < 0
        leaf = torch.where(is_leaf & ~done, -nv - 1, leaf)
        node = torch.where(is_leaf | done, node, nv)
        p = torch.where(done[..., None], p, rem)
        done = done | is_leaf

    lv = vals[torch.clamp(leaf, 0, nv_max)]
    nidx = _leaf_index(p, ndim)
    full = vals[torch.clamp(leaf + nidx, 0, nv_max)]
    return torch.where(torch.signbit(lv), -lv, full)


def _leaf_index(pos, ndim):
    """The value's index inside a leaf of 2 samples a dimension.  The shift
    order is the reverse of the climb's: dimension ndim - 1 lands in the
    lowest bit."""
    shifts = torch.arange(ndim - 1, -1, -1, dtype=torch.int64,
                          device=pos.device)
    comp = to_int32(2.0 * pos[..., :ndim]).long()
    return torch.sum(comp << shifts, dim=-1)
