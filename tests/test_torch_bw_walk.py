"""The Baldwin-Weber kernel's cluster tree (`bw_ctree`) and its walk, in
PyTorch (`bw_walk_plain`), against the dense sweep that stays the
specification (`bw_closest_plain` / `bw_any_plain`).

Tolerances: none.  The tree's rows are float32 min / max of the clusters'
and must be EQUAL to a direct computation and to the tree built from the JAX
package's `bw_clusters`; the walk must give the dense sweep's bits (t, u, v
and prim; occlusion for any-hit), since the CUDA kernel is held to the dense
sweep the same way on the card.
"""

import functools

import numpy as np
import pytest
import torch

from ignis_tpu.ops.bvh import build_bvh as j_build_bvh
from ignis_tpu.ops.bw_intersect import bw_tables as j_bw_tables
from ignis_tpu_torch.api import build_accel_tables
from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.ops import bw_intersect as tbw
from ignis_tpu_torch.scene.compile import load_and_compile
from ignis_tpu_torch.scenes import big_scene, demo_scene
from test_torch_packet_bvh import (
    RULE_RAYS, RULE_TRI, face_rays, rule_rays, same_bits,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small inputs run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = np.float32
SECOND = dict(n_spheres=3, subdiv=3)        # 3,842 triangles, 481 clusters


@functools.lru_cache(maxsize=None)
def scene_tables(name):
    """The port's own soup tables (numpy) of the demo scene or of the
    3,842-triangle field, `bw_ctree` included."""
    scene = demo_scene() if name == "demo" else big_scene(**SECOND)
    tab = build_accel_tables(load_and_compile(scene, 16, 16).tables)
    keep = ("bw_tris", "bw_clusters", "bw_ctree", "tri_v0", "tri_e1",
            "tri_e2")
    return {k: tab[k] for k in keep}


def soup_tables(v0, e1, e2, bits=None, order=None):
    """`bw_tables` of a soup with the kernel's `bw_ctree` and the soup
    itself beside them."""
    if bits is None:
        bits = np.full(v0.shape[0], 0xF)
    tab = tbw.bw_tables(v0, e1, e2, bits, order=order)
    tab["bw_ctree"] = tbw.build_bw_ctree(tab["bw_clusters"])
    tab.update(tri_v0=v0, tri_e1=e1, tri_e2=e2)
    return tab


def random_soup(t, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-2, 2, (t, 3)).astype(F32)
    e1 = rng.uniform(-1, 1, (t, 3)).astype(F32)
    e2 = rng.uniform(-1, 1, (t, 3)).astype(F32)
    return v0, e1, e2


def tie_tables(apart):
    """16 triangles; triangle 5 is an exact copy of triangle 2 (`apart`
    False: the same cluster) or triangle 12 is (`apart` True: the next
    cluster), so every hit on it is an exact tie, and the later one must win
    as the sequential `t <= best` sweep says."""
    v0, e1, e2 = random_soup(16, 41)
    dup = 12 if apart else 5
    v0[dup], e1[dup], e2[dup] = v0[2], e1[2], e2[2]
    return soup_tables(v0, e1, e2), dup


def table_set(name):
    if name in ("demo", "second"):
        return scene_tables(name)
    if name == "one_cluster":
        return soup_tables(*random_soup(5, 42))
    if name == "eight_clusters":
        v0, e1, e2 = random_soup(64, 43)
        return soup_tables(v0, e1, e2, order=j_build_bvh(v0, e1, e2).tri_order)
    if name.startswith("tie"):
        return tie_tables(name == "tie_apart")[0]
    raise KeyError(name)


def aimed_rays(tab, n, seed):
    """Half the rays from random points of the soup's box in random
    directions, half aimed at random triangles' centroids."""
    rng = np.random.default_rng(seed)
    v0, e1, e2 = (np.asarray(tab[k], F32) for k in ("tri_v0", "tri_e1",
                                                    "tri_e2"))
    pts = np.concatenate([v0, v0 + e1, v0 + e2])
    lo, hi = pts.min(0), pts.max(0)
    span = np.maximum(hi - lo, 1e-3)
    org = lo - 0.2 * span + rng.uniform(0, 1, (n, 3)) * 1.4 * span
    org = org.astype(F32)
    d = rng.normal(0, 1, (n, 3))
    pick = rng.integers(0, v0.shape[0], n // 2)
    aim = v0[pick] + (e1[pick] + e2[pick]) / 3.0
    d[: n // 2] = aim - org[: n // 2]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F32)
    return org, d, np.full(n, 1e-3, F32), np.full(n, 1e30, F32)


def walk_and_dense(tab, rays, mask_bit, any_hit):
    """(walk, dense, walk work, dense work) on CPU tensors."""
    tt = tables_from_numpy(tab, "cpu")
    args = [torch.from_numpy(np.asarray(a)) for a in rays]
    if any_hit:
        args[3] = torch.full_like(args[3], 4.0)
    wwork, dwork = {}, {}
    walk = tbw.bw_walk_plain(tt, *args, mask_bit=mask_bit, any_hit=any_hit,
                             work=wwork)
    if any_hit:
        dense = tbw.bw_any_plain(tt, *args, mask_bit=mask_bit, work=dwork)
        return walk[3] >= 0, dense, wwork, dwork
    dense = tbw.bw_closest_plain(tt, *args, mask_bit=mask_bit, work=dwork)
    return walk, dense, wwork, dwork


# -------------------------------------------------------------- the tree
def _brute_node(clust, level, j):
    """A node's box and validity from the clusters it covers, directly."""
    part = clust[(8 ** level) * j:(8 ** level) * (j + 1)]
    v = part[part[:, 6] > 0]
    if not len(v):
        return None
    return (np.minimum(v[:, 0:3], v[:, 3:6]).min(0),
            np.maximum(v[:, 0:3], v[:, 3:6]).max(0))


@pytest.mark.parametrize("ccnt", [1, 7, 8, 9, 64, 65, 481])
def test_bw_ctree_nodes_are_min_max_of_valid_children(ccnt):
    """Each node is the exact min / max of the valid clusters below it; a
    soup of <= 8 clusters gets no level, padding clusters (valid 0) take no
    part, a NaN coordinate is kept in every node above it."""
    rng = np.random.default_rng(ccnt)
    clust = np.zeros((ccnt, 8), F32)
    lo = rng.uniform(-5, 5, (ccnt, 3)).astype(F32)
    clust[:, 0:3], clust[:, 3:6] = lo, lo + rng.uniform(0, 1, (ccnt, 3))
    clust[:, 6] = 1.0
    clust[1::5, 6] = 0.0                          # padding / invalid
    clust[1::5, 0:6] = 0.0
    clust[2::7, 0:3] = clust[2::7, 3:6] + 0.5     # inverted boxes
    if ccnt > 20:
        clust[17, 1] = np.nan
        clust[ccnt - 1, 6] = 0.0                  # a padding tail
        clust[ccnt - 1, 0:6] = 0.0
    tree = tbw.build_bw_ctree(clust)
    assert tree.dtype == np.float32 and tree.shape == (tbw.ctree_rows(ccnt), 8)
    hdr = tree[0]
    levels = int(hdr[0])
    want = 0
    while -(-ccnt // 8 ** want) > 8:
        want += 1
    assert levels == want and (hdr[1 + levels:] == 0).all()
    assert {1: 0, 7: 0, 8: 0, 9: 1, 64: 1, 65: 2, 481: 2}[ccnt] == levels
    seen = 1
    for lev in range(1, levels + 1):
        base = int(hdr[lev])
        assert base == seen
        nodes = -(-ccnt // 8 ** lev)
        for j in range(nodes):
            row = tree[base + j]
            ref = _brute_node(clust, lev, j)
            if ref is None:
                assert row[6] == 0.0
                continue
            assert row[6] == 1.0 and row[7] == 0.0
            np.testing.assert_array_equal(row[0:3], ref[0])
            np.testing.assert_array_equal(row[3:6], ref[1])
        seen += nodes
    assert seen == tree.shape[0]
    for lev in range(1, levels + 1 if ccnt > 20 else 1):
        assert np.isnan(tree[int(hdr[lev]) + 17 // 8 ** lev, 1])  # kept


def test_bw_ctree_from_reference_tables_equals_the_ports():
    """The tree depends on `bw_clusters` alone: built from the JAX package's
    tables of the 3,842-triangle field it equals the port's own."""
    tab = scene_tables("second")
    geo = (tab["tri_v0"], tab["tri_e1"], tab["tri_e2"])
    scene = load_and_compile(big_scene(**SECOND), 16, 16)
    flags = np.asarray(scene.tables["ent_flags"])[
        np.asarray(scene.tables["tri_ent"])]
    ref = j_bw_tables(*geo, flags, order=j_build_bvh(*geo).tri_order)
    np.testing.assert_array_equal(ref["bw_clusters"], tab["bw_clusters"])
    np.testing.assert_array_equal(tbw.build_bw_ctree(ref["bw_clusters"]),
                                  tab["bw_ctree"])
    assert tab["bw_clusters"].shape[0] == 481
    assert tab["bw_ctree"].shape == (1 + 61 + 8, 8)
    np.testing.assert_array_equal(tab["bw_ctree"][0],
                                  [2, 1, 62, 0, 0, 0, 0, 0])


def test_bw_ctree_rows_and_the_wrapper_check():
    for n in (1, 8, 9, 64, 65, 481, 4096, 5000):
        assert tbw.ctree_rows(n) == tbw.build_bw_ctree(
            np.zeros((n, 8), F32)).shape[0]


# -------------------------------------------------------------- the walk
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("mask_bit", [0x1, 0x2, 0x4, 0x8])
@pytest.mark.parametrize("name", ["demo", "second", "one_cluster",
                                  "eight_clusters"])
def test_bw_walk_equals_the_dense_sweep(name, mask_bit, any_hit):
    """The kernel's walk, in PyTorch: bit-equal to the dense sweep, entering
    the same clusters (the same triangle tests) after fewer box decisions
    where the soup has a tree."""
    tab = table_set(name)
    rays = aimed_rays(tab, 3000 if name == "second" else 1500, 50 + mask_bit)
    walk, dense, wwork, dwork = walk_and_dense(tab, rays, mask_bit, any_hit)
    if any_hit:
        assert torch.equal(walk, dense)
        hits = int(walk.sum())
    else:
        assert all(same_bits(a, b) for a, b in zip(walk, dense))
        hits = int((walk[3] >= 0).sum())
    assert hits > 10
    assert wwork["tri_tests"] == dwork["tri_tests"]
    if int(tab["bw_ctree"][0, 0]) > 0:
        assert wwork["node_tests"] + wwork["cluster_tests"] \
            < dwork["box_tests"]
    else:
        assert wwork.get("node_tests", 0) == 0


@pytest.mark.parametrize("case", sorted(RULE_RAYS) + ["faces_demo",
                                                      "faces_second"])
def test_bw_walk_float_rules(case):
    """Subnormal, infinite and NaN components, and rays that start on the
    faces of the clusters' AND the tree nodes' boxes with such components:
    the walk gives the dense sweep's bits, closest and any, every mask."""
    if case in RULE_RAYS:
        tab, rays = soup_tables(*RULE_TRI), rule_rays(case)
    else:
        tab = scene_tables(case.split("_")[1])
        boxes = np.concatenate([tab["bw_clusters"][:, :6],
                                tab["bw_ctree"][1:, :6]])
        rays = face_rays(boxes, 2048, 61)
    tt = tables_from_numpy(tab, "cpu")
    args = [torch.from_numpy(a) for a in rays]
    for mb in (0x1, 0x2, 0x4, 0x8):
        walk = tbw.bw_walk_plain(tt, *args, mask_bit=mb)
        dense = tbw.bw_closest_plain(tt, *args, mask_bit=mb)
        assert all(same_bits(a, b) for a, b in zip(walk, dense)), mb
        occ = tbw.bw_walk_plain(tt, *args, mask_bit=mb, any_hit=True)[3] >= 0
        assert torch.equal(occ, tbw.bw_any_plain(tt, *args, mask_bit=mb))


@pytest.mark.parametrize("apart", [False, True])
def test_bw_exact_tie_goes_to_the_higher_index(apart):
    """Two identical triangles, in one cluster or in two: every hit on them
    is an exact tie, and the higher index wins in the dense sweep, the walk
    and (tests/test_torch_bw_intersect.py) the kernel."""
    tab, dup = tie_tables(apart)
    rng = np.random.default_rng(44)
    v0, e1, e2 = tab["tri_v0"], tab["tri_e1"], tab["tri_e2"]
    n = 256
    w = rng.dirichlet([1, 1, 1], n).astype(F32)
    aim = v0[2] + w[:, 1:2] * e1[2] + w[:, 2:3] * e2[2]
    org = (aim + rng.normal(0, 2, (n, 3))).astype(F32)
    d = (aim - org).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = (org, d, np.zeros(n, F32), np.full(n, 1e30, F32))
    walk, dense, _, _ = walk_and_dense(tab, rays, 0xF, False)
    assert all(same_bits(a, b) for a, b in zip(walk, dense))
    on_pair = np.isin(dense[3].numpy(), [2, dup])
    assert on_pair.sum() > n // 2
    assert (dense[3].numpy()[on_pair] == dup).all()
    assert (tab["bw_tris"][:, 13].astype(int)[:16] == np.arange(16)).all()
    assert ((dup // 8) != (2 // 8)) == apart
