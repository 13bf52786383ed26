"""The port's Baldwin-Weber sweep (plain PyTorch version, the one the CPU
wrapper runs) against the JAX package's Pallas kernel in interpret mode, as
tests/test_bw_intersect.py runs it.

Tolerances: prim ids must be equal except where two triangles give bit-equal
t (an exact tie: either id is right) or where the reference's per-block
cluster skip and the port's per-ray skip see a hit within rounding of a box
face; t to 1e-5 relative and u, v to 1e-4 absolute, because XLA on the CPU
contracts multiply-adds and eager torch does not.  On the float-rule rays of
tests/test_torch_packet_bvh.py (subnormal, infinite and NaN components) prim
ids must be EQUAL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.ops.bvh import build_bvh as j_build_bvh
from ignis_tpu.ops.bw_intersect import bw_any as j_bw_any
from ignis_tpu.ops.bw_intersect import bw_closest as j_bw_closest
from ignis_tpu.ops.bw_intersect import bw_tables as j_bw_tables
from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.ops import bw_intersect as tbw
from test_torch_bw_walk import aimed_rays, scene_tables, soup_tables, table_set
from test_torch_packet_bvh import (
    RULE_HITS, RULE_RAYS, RULE_TRI, face_rays, rule_rays, same_bits,
)


def _random_soup(t, seed=0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2, 2, (t, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    return v0, e1, e2


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    org = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org, d


def _both(tab, org, d, tmin, tmax, mask_bit=0xF):
    jt = {k: jnp.asarray(v) for k, v in tab.items()}
    ref = [np.asarray(a) for a in j_bw_closest(
        jt, jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), mask_bit=mask_bit, interpret=True)]
    tt = tables_from_numpy(tab, "cpu")
    got = [a.numpy() for a in tbw.bw_closest(
        tt, torch.from_numpy(org), torch.from_numpy(d),
        torch.from_numpy(tmin), torch.from_numpy(tmax), mask_bit=mask_bit)]
    return ref, got


def _assert_same_hits(ref, got):
    rt, ru, rv, ri = ref
    gt, gu, gv, gi = got
    differ = ri != gi
    tie = differ & (ri >= 0) & (gi >= 0) & (rt == gt)
    assert not (differ & ~tie).any(), (ri[differ], gi[differ])
    hit = (ri >= 0) & ~differ
    np.testing.assert_allclose(gt[hit], rt[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gu[hit], ru[hit], rtol=0, atol=1e-4)
    np.testing.assert_allclose(gv[hit], rv[hit], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(gt[ri < 0], rt[ri < 0])  # misses keep tmax
    return int(hit.sum())


@pytest.mark.parametrize("t,with_order", [(5, False), (100, True),
                                          (733, True), (4000, True)])
def test_bw_tables_equal(t, with_order):
    v0, e1, e2 = _random_soup(t, seed=t)
    bits = np.random.default_rng(t).integers(0, 16, t)
    order = j_build_bvh(v0, e1, e2).tri_order if with_order else None
    a = j_bw_tables(v0, e1, e2, bits, order=order)
    b = tbw.bw_tables(v0, e1, e2, bits, order=order)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


@pytest.mark.parametrize("t", [5, 100, 733])
def test_bw_closest_matches_pallas_interpret(t):
    v0, e1, e2 = _random_soup(t)
    order = j_build_bvh(v0, e1, e2).tri_order
    tab = j_bw_tables(v0, e1, e2, np.full(t, 0xF), order=order)
    n = 1024
    org, d = _rays(n)
    ref, got = _both(tab, org, d, np.zeros(n, np.float32),
                     np.full(n, 1e30, np.float32))
    assert _assert_same_hits(ref, got) > 0


def test_bw_any_matches_pallas_interpret():
    t = 200
    v0, e1, e2 = _random_soup(t, seed=3)
    tab = j_bw_tables(v0, e1, e2, np.full(t, 0xF))
    n = 1024
    org, d = _rays(n, seed=4)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, 2.5, np.float32)
    ref = np.asarray(j_bw_any(
        {k: jnp.asarray(v) for k, v in tab.items()}, jnp.asarray(org),
        jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax), interpret=True))
    got = tbw.bw_any(tables_from_numpy(tab, "cpu"), torch.from_numpy(org),
                     torch.from_numpy(d), torch.from_numpy(tmin),
                     torch.from_numpy(tmax)).numpy()
    assert got.dtype == np.bool_
    # a hit within an ulp of tmin/tmax may fall on either side of the window
    assert (got != ref).sum() <= 1 and got.any() and not got.all()


@pytest.mark.parametrize("mask_bit", [0x1, 0x4, 0x8])
def test_bw_maskbits(mask_bit):
    t = 64
    v0, e1, e2 = _random_soup(t, seed=5)
    bits = np.full(t, 0xF)
    bits[::2] = 0x1  # half the soup camera-only
    tab = j_bw_tables(v0, e1, e2, bits)
    n = 512
    org, d = _rays(n, seed=6)
    ref, got = _both(tab, org, d, np.zeros(n, np.float32),
                     np.full(n, 1e30, np.float32), mask_bit=mask_bit)
    _assert_same_hits(ref, got)
    hit = got[3] >= 0
    assert hit.any()
    if mask_bit != 0x1:
        assert np.all(got[3][hit] % 2 == 1)  # even tris are camera-only


def test_bw_degenerate_triangles_never_hit():
    t = 16
    v0, e1, e2 = _random_soup(t, seed=7)
    e2[3] = e1[3]  # degenerate
    e1[9] = 0.0
    tab = j_bw_tables(v0, e1, e2, np.full(t, 0xF))
    n = 512
    org, d = _rays(n, seed=8)
    ref, got = _both(tab, org, d, np.zeros(n, np.float32),
                     np.full(n, 1e30, np.float32))
    _assert_same_hits(ref, got)
    assert not np.isin(got[3], [3, 9]).any()


def test_bw_cluster_order_reports_original_ids():
    """Clustering under `order` must not change the reported prim ids."""
    t = 300
    v0, e1, e2 = _random_soup(t, seed=11)
    order = np.random.default_rng(12).permutation(t)
    tab = j_bw_tables(v0, e1, e2, np.full(t, 0xF), order=order)
    tab_id = j_bw_tables(v0, e1, e2, np.full(t, 0xF))
    n = 512
    org, d = _rays(n, seed=13)
    tmin, tmax = np.zeros(n, np.float32), np.full(n, 1e30, np.float32)
    ref, got = _both(tab, org, d, tmin, tmax)
    _assert_same_hits(ref, got)
    _, got_id = _both(tab_id, org, d, tmin, tmax)
    assert (got[3] == got_id[3]).mean() > 0.99


def test_bw_zero_direction_component_and_dead_lanes():
    """Axis-aligned rays (a zero direction component takes the 1e30 guard)
    and dead lanes (tmax <= tmin) behave as in the reference."""
    t = 120
    v0, e1, e2 = _random_soup(t, seed=21)
    tab = j_bw_tables(v0, e1, e2, np.full(t, 0xF),
                      order=j_build_bvh(v0, e1, e2).tri_order)
    n = 256
    org, _ = _rays(n, seed=22)
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), np.arange(n) % 3] = np.where(np.arange(n) % 2, 1.0, -1.0)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e30, np.float32)
    tmax[::5] = -1.0
    ref, got = _both(tab, org, d, tmin, tmax)
    _assert_same_hits(ref, got)
    assert (got[3][::5] == -1).all()


def _rule_case(case, n_faces=512):
    """BW tables and rays of a float-rule case; "faces": rays on the cluster
    boxes' faces of a random soup."""
    if case != "faces":
        return tbw.bw_tables(*RULE_TRI, np.full(1, 0xF)), rule_rays(case)
    v0, e1, e2 = _random_soup(300, seed=23)
    tab = tbw.bw_tables(v0, e1, e2, np.full(300, 0xF),
                        order=j_build_bvh(v0, e1, e2).tri_order)
    return tab, face_rays(tab["bw_clusters"][:, :6], n_faces, 24)


@pytest.mark.parametrize("case", sorted(RULE_RAYS) + ["faces"])
def test_bw_float_rules_match_pallas_interpret(case):
    """Subnormal, infinite and NaN components: the JAX package's results
    (the subnormal case failed before the port took its float rules)."""
    tab, rays = _rule_case(case)
    ref, got = _both(tab, *rays)
    if case in RULE_HITS:
        assert got[3].tolist() == RULE_HITS[case]
    np.testing.assert_array_equal(got[3], ref[3])
    _assert_same_hits(ref, got)
    occ_ref = np.asarray(j_bw_any(
        {k: jnp.asarray(v) for k, v in tab.items()},
        *(jnp.asarray(a) for a in rays), interpret=True))
    occ = tbw.bw_any(tables_from_numpy(tab, "cpu"),
                     *(torch.from_numpy(a) for a in rays)).numpy()
    np.testing.assert_array_equal(occ, occ_ref)


def test_bw_cuda_tensor_never_takes_the_plain_version():
    """The wrapper picks the plain version only because the tensor is on the
    CPU; this is the dispatch condition, checked without a card."""
    import inspect
    src = inspect.getsource(tbw.bw_closest) + inspect.getsource(tbw.bw_any)
    assert "is_cuda" in src and "try" not in src
    assert tbw.bw_closest.launches == 0 and tbw.bw_any.launches == 0


@pytest.mark.cuda
def test_bw_float_rules_kernel_matches_plain_on_the_card():
    """The float-rule rays, and rays with special components on the faces of
    a soup's cluster boxes and of the 3,842-triangle field's cluster and
    tree-node boxes: the kernel's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")
    second = scene_tables("second")
    cases = [_rule_case(None), _rule_case("faces", 8192),
             (second, face_rays(np.concatenate([
                 second["bw_clusters"][:, :6], second["bw_ctree"][1:, :6]]),
                 8192, 25))]
    for tab, rays in cases:
        tab = dict(tab, bw_ctree=tbw.build_bw_ctree(tab["bw_clusters"]))
        tab = tables_from_numpy(tab, "cuda")
        args = [torch.from_numpy(a).cuda() for a in rays]
        for mb in (0x1, 0x8):
            got = tbw.bw_closest(tab, *args, mask_bit=mb)
            ref = tbw.bw_closest_plain(tab, *args, mask_bit=mb)
            assert all(same_bits(a, b) for a, b in zip(got, ref))
            assert torch.equal(tbw.bw_any(tab, *args, mask_bit=mb),
                               tbw.bw_any_plain(tab, *args, mask_bit=mb))


@pytest.mark.cuda
def test_bw_kernel_matches_plain_on_the_card():
    """1 to 65553 rays over soups of 1 to 481 clusters (the demo's 13 and the
    3,842-triangle field's, with trees of 1 and 2 levels; 1 and 8 clusters,
    without one), exact ties in one cluster and in two, every mask: the
    kernel's outputs equal the dense plain version's, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no interpret "
                    "mode")
    t = 733
    v0, e1, e2 = _random_soup(t)
    cases = [(soup_tables(v0, e1, e2,
                          order=j_build_bvh(v0, e1, e2).tri_order),
              (*_rays(4096), np.zeros(4096, np.float32),
               np.full(4096, 1e30, np.float32)))]
    for name, n, seed in (("demo", 65553, 71), ("second", 65553, 72),
                          ("second", 129, 73), ("second", 1, 74),
                          ("one_cluster", 4096, 75),
                          ("eight_clusters", 4096, 76), ("tie", 1000, 77),
                          ("tie_apart", 1000, 78)):
        tab = table_set(name)
        cases.append((tab, aimed_rays(tab, n, seed)))
    with pytest.raises(ValueError, match="bw_ctree"):
        tab = tables_from_numpy(cases[0][0], "cuda")
        del tab["bw_ctree"]
        tbw.bw_closest(tab, *(torch.from_numpy(a).cuda()
                              for a in cases[0][1]))
    for tab, rays in cases:
        tab = tables_from_numpy(tab, "cuda")
        org, d, tmin, tmax = (torch.from_numpy(a).cuda() for a in rays)
        hits = 0
        for mb in (0x1, 0x2, 0x4, 0x8):
            got = tbw.bw_closest(tab, org, d, tmin, tmax, mask_bit=mb)
            ref = tbw.bw_closest_plain(tab, org, d, tmin, tmax, mask_bit=mb)
            assert all(same_bits(a, b) for a, b in zip(got, ref)), mb
            seg = torch.full_like(tmax, 4.0)
            assert torch.equal(tbw.bw_any(tab, org, d, tmin, seg, mask_bit=mb),
                               tbw.bw_any_plain(tab, org, d, tmin, seg,
                                                mask_bit=mb))
            hits += int((got[3] >= 0).sum())
        assert hits > 0 or org.shape[0] < 10
