"""Klems-basis measured BSDF: loader and batched lookups.

Counterpart of ignis_tpu/measured/klems.py.  The loader (Radiance / WINDOW
XML with per-component front/back x reflection/transmission Klems angle
bases and scattering matrices; bases sorted by theta, matrices permuted to
match, front/back named by the WINDOW convention) and the table builder are
the JAX package's, copied: numpy and the standard library only.  The
lookups (direction -> patch index, matrix gather) are torch.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import torch

from ignis_tpu_torch.core.vec import to_int32

def _strip_ns(tag):
    return tag.split("}")[-1]


def _find(el, name):
    for c in el.iter():
        if _strip_ns(c.tag) == name:
            return c
    return None


def _findall(el, name):
    return [c for c in el.iter() if _strip_ns(c.tag) == name]


class KlemsBasis:
    def __init__(self, blocks):
        # blocks: list of (theta_center, lower, upper, phi_count), sorted
        blocks = sorted(blocks, key=lambda b: b[2])
        self.center = np.asarray([b[0] for b in blocks], np.float32)
        self.lower = np.asarray([b[1] for b in blocks], np.float32)
        self.upper = np.asarray([b[2] for b in blocks], np.float32)
        self.phi_count = np.asarray([b[3] for b in blocks], np.int32)
        self.lin_off = np.concatenate([[0], np.cumsum(self.phi_count)[:-1]]).astype(np.int32)
        self.entry_count = int(self.phi_count.sum())
        # per-phi-patch projected solid angle (KlemsLoader.cpp PhiSolidAngle)
        c_lo = np.cos(self.lower)
        c_up = np.cos(self.upper)
        self.phi_solid = ((c_lo * c_lo - c_up * c_up) * np.pi
                          / np.maximum(self.phi_count, 1)).astype(np.float32)

    def permutation(self, original_order):
        """entry permutation for a basis given in `original_order` of blocks."""
        # original_order: indices into sorted blocks for each original block
        perm = []
        for ri in original_order:
            start = self.lin_off[ri]
            perm.extend(range(start, start + self.phi_count[ri]))
        return np.asarray(perm, np.int64)


def _parse_basis(angle_basis):
    blocks = []
    for b in _findall(angle_basis, "AngleBasisBlock"):
        theta = float(_find(b, "Theta").text)
        nphi_el = _find(b, "nPhis")
        nphi = int(nphi_el.text) if nphi_el is not None else 1
        bounds = _find(b, "ThetaBounds")
        lo = float(_find(bounds, "LowerTheta").text)
        hi = float(_find(bounds, "UpperTheta").text)
        blocks.append((np.deg2rad(theta), np.deg2rad(lo), np.deg2rad(hi), nphi))
    return blocks


def load_klems_xml(path: str | Path):
    """Returns dict with 4 components, each {matrix (R,C), total, basis}."""
    tree = ET.parse(path)
    root = tree.getroot()
    layer = _find(root, "Layer")
    datadef = _find(layer, "DataDefinition")
    struct = _find(datadef, "IncidentDataStructure").text.strip()
    row_based = struct == "Rows"

    bases = {}
    for ab in _findall(datadef, "AngleBasis"):
        name = _find(ab, "AngleBasisName").text.strip()
        blocks = _parse_basis(ab)
        order = np.argsort([b[2] for b in blocks], kind="stable")
        inv_order = np.argsort(order)  # original block -> sorted index
        basis = KlemsBasis(blocks)
        # entry permutation from original linear order to sorted linear order
        orig_lin = []
        for bi in range(len(blocks)):
            orig_lin.append(inv_order[bi])
        perm = []
        for bi in range(len(blocks)):
            si = inv_order[bi]
            start = basis.lin_off[si]
            perm.extend(range(start, start + blocks[bi][3]))
        bases[name] = (basis, np.asarray(perm, np.int64))

    comps = {}
    for wd in _findall(layer, "WavelengthData"):
        block = _find(wd, "WavelengthDataBlock")
        if block is None:
            continue
        cbasis_el = _find(block, "ColumnAngleBasis")
        rbasis_el = _find(block, "RowAngleBasis")
        cname = (cbasis_el.text.strip() if cbasis_el is not None
                 else next(iter(bases)))
        rname = (rbasis_el.text.strip() if rbasis_el is not None else cname)
        col_basis, col_perm = bases.get(cname, next(iter(bases.values())))
        row_basis, row_perm = bases.get(rname, next(iter(bases.values())))
        scat = _find(block, "ScatteringData").text
        vals = np.fromstring(scat.replace(",", " "), sep=" ", dtype=np.float32)
        vals = np.nan_to_num(np.abs(vals), posinf=0.0, neginf=0.0)
        r, c = row_basis.entry_count, col_basis.entry_count
        vals = vals[:r * c]
        if vals.size < r * c:
            vals = np.pad(vals, (0, r * c - vals.size))
        if row_based:
            mat_orig = vals.reshape(c, r).T
        else:
            mat_orig = vals.reshape(r, c)
        mat = np.zeros((r, c), np.float32)
        mat[np.ix_(row_perm, col_perm)] = mat_orig
        direction = (_find(block, "WavelengthDataDirection").text.strip()
                     if _find(block, "WavelengthDataDirection") is not None
                     else "Transmission Front")
        total = float((mat * row_basis.phi_solid.repeat(row_basis.phi_count)[:, None]
                       * col_basis.phi_solid.repeat(col_basis.phi_count)[None, :]).sum())
        comp = dict(matrix=mat, total=total, row=row_basis, col=col_basis)
        # WINDOW convention flips front/back (KlemsLoader.cpp:461-471)
        if direction == "Transmission Front":
            comps["back_transmission"] = comp
        elif direction in ("Scattering Back", "Reflection Back"):
            comps["front_reflection"] = comp
        elif direction == "Transmission Back":
            comps["front_transmission"] = comp
        else:
            comps["back_reflection"] = comp

    any_basis = next(iter(bases.values()))[0]
    zero = dict(matrix=np.zeros((any_basis.entry_count, any_basis.entry_count),
                                np.float32),
                total=0.0, row=any_basis, col=any_basis)
    comps.setdefault("front_reflection", zero)
    comps.setdefault("back_reflection", zero)
    ft = comps.get("front_transmission")
    bt = comps.get("back_transmission")
    if bt is None or (ft is not None and bt["total"] <= 1e-7):
        bt = ft
    if ft is None or (bt is not None and ft["total"] <= 1e-7):
        ft = bt
    comps["front_transmission"] = ft or zero
    comps["back_transmission"] = bt or zero
    return comps


# ---------------------------------------------------------------- device eval

_COMP_ORDER = ("front_reflection", "front_transmission",
               "back_reflection", "back_transmission")


def klems_tables(comps, prefix):
    """Flatten a Klems model into named device arrays + static info."""
    tables = {}
    info = {"totals": [comps[k]["total"] for k in _COMP_ORDER]}
    for k in _COMP_ORDER:
        c = comps[k]
        tables[f"{prefix}_{k}_mat"] = c["matrix"]
        for ax, basis in (("row", c["row"]), ("col", c["col"])):
            tables[f"{prefix}_{k}_{ax}_lower"] = basis.lower
            tables[f"{prefix}_{k}_{ax}_phin"] = basis.phi_count
            tables[f"{prefix}_{k}_{ax}_off"] = basis.lin_off
        info[f"{k}_shape"] = c["matrix"].shape
    return tables, info


def _basis_index(tables, prefix, comp, ax, theta, phi):
    """Patch index of (theta, phi) in a component's row or column basis."""
    lower = tables[f"{prefix}_{comp}_{ax}_lower"]
    phin = tables[f"{prefix}_{comp}_{ax}_phin"]
    off = tables[f"{prefix}_{comp}_{ax}_off"]
    # the number of bands whose lower bound lies below theta
    i = torch.sum((lower[None, :] < theta[:, None]).to(torch.int32),
                  dim=-1) - 1
    i = torch.clamp(i, 0, lower.shape[0] - 1).long()
    pc = phin[i]
    j = torch.clamp_min(to_int32(phi * pc.to(torch.float32)
                                 * float(np.float32(0.5 / np.pi)) + 0.5), 0)
    j = torch.where(j >= pc, torch.zeros_like(j), j)
    return off[i] + j


def _spherical(d):
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.atan2(d[..., 1], d[..., 0])
    phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
    return theta, phi


def klems_eval_component(tables, prefix, comp, in_dir, out_dir):
    """matrix[row index of out_dir, column index of in_dir]."""
    it, ip = _spherical(in_dir)
    ot, op = _spherical(out_dir)
    in_idx = _basis_index(tables, prefix, comp, "col", it, ip)
    out_idx = _basis_index(tables, prefix, comp, "row", ot, op)
    mat = tables[f"{prefix}_{comp}_mat"]
    return mat[out_idx.long(), in_idx.long()]
