"""The per-lane stack BVH walk (`ops.bvh.bvh_closest` / `bvh_any`) against
the JAX package's, and `Runtime(use_bvh=True)` against the JAX `Runtime`.

Tolerances: prim ids EQUAL except where both hit at exactly the same t (a
tie the two may break on different rows), t within rtol 1e-5 / atol 1e-6,
u and v within 1e-4 (the `test_torch_packet_bvh.py` rule); occlusion equal.
On the float-rule rays (subnormal, infinite and NaN components, origins on
box faces) ids are EQUAL.  Tables equal to the bit.  The 16x16 frame per
pixel within rtol 1e-5 / atol 1e-5 at depth 3.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.api import Runtime as JRuntime
from ignis_tpu.ops import bvh as jbvh
from ignis_tpu_torch.api import Runtime
from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.ops import bvh as tbvh
from ignis_tpu_torch.scenes import demo_scene
from test_torch_packet_bvh import (
    RULE_HITS, RULE_RAYS, RULE_TRI, _random_rays, _random_soup, _same_hits,
    face_rays, rule_rays,
)

FILM = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _intersect_kind_soup(n_tris, seed):
    """tests/test_intersect.py's kind of soup: small triangles in a cube."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    return v0, e1, e2


def _both_tables(v0, e1, e2):
    geo = {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2}
    jt = jbvh.bvh_tables(jbvh.build_bvh(v0, e1, e2), geo)
    tt = tbvh.bvh_tables(tbvh.build_bvh(v0, e1, e2), geo)
    return jt, tt


def _run(jt, tt, rays, tri_mask=None, any_hit=False, **kw):
    """(JAX result, port result) as numpy."""
    jfn, tfn = ((jbvh.bvh_any, tbvh.bvh_any) if any_hit
                else (jbvh.bvh_closest, tbvh.bvh_closest))
    jm = None if tri_mask is None else jnp.asarray(tri_mask)
    tm = None if tri_mask is None else torch.from_numpy(tri_mask)
    ref = jfn({k: jnp.asarray(v) for k, v in jt.items()},
              *(jnp.asarray(a) for a in rays), tri_mask=jm, **kw)
    got = tfn(tables_from_numpy(tt, "cpu"),
              *(torch.from_numpy(np.asarray(a)) for a in rays), tri_mask=tm,
              **kw)
    if any_hit:
        return np.asarray(ref), got.numpy()
    return [np.asarray(a) for a in ref], [a.numpy() for a in got]


def _rays(n, seed, tmax=1e30, spread=6.0):
    org, d = _random_rays(n, seed=seed, spread=spread)
    return (org, d, np.zeros(n, np.float32),
            np.full(n, tmax, np.float32))


@pytest.mark.parametrize("n_tris", [1, 37, 500])
def test_bvh_tables_equal(n_tris):
    jt, tt = _both_tables(*_random_soup(n_tris, seed=n_tris))
    assert jt.keys() == tt.keys()
    for k in jt:
        np.testing.assert_array_equal(np.asarray(tt[k]), np.asarray(jt[k]), k)


@pytest.mark.parametrize("soup,n_rays,masked", [
    ("random", 256, False), ("random", 1500, False), ("random", 1500, True),
    ("intersect", 256, False), ("intersect", 256, True)])
def test_closest_matches_jax(soup, n_rays, masked):
    geo = (_random_soup(500, seed=5) if soup == "random"
           else _intersect_kind_soup(300, 7))
    jt, tt = _both_tables(*geo)
    mask = (np.random.default_rng(3).random(geo[0].shape[0]) < 0.6
            if masked else None)
    spread = 6.0 if soup == "random" else 2.0
    ref, got = _run(jt, tt, _rays(n_rays, n_rays, spread=spread), mask)
    nhit = _same_hits(ref, got)
    assert nhit > 10
    if masked:
        assert mask[got[3][got[3] >= 0]].all()


@pytest.mark.parametrize("masked", [False, True])
def test_any_matches_jax(masked):
    geo = _random_soup(200, seed=9)
    jt, tt = _both_tables(*geo)
    mask = (np.random.default_rng(4).random(200) < 0.5 if masked else None)
    ref, got = _run(jt, tt, _rays(700, 10, tmax=3.0), mask, any_hit=True)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("any_hit", [False, True])
def test_full_stack_drops_entries_as_jax(any_hit):
    """A 2-entry stack overflows on most rays: the port drops the same
    entries the reference does (the hits it misses are the same)."""
    jt, tt = _both_tables(*_random_soup(500, seed=5))
    rays = _rays(1024, 11, tmax=3.0 if any_hit else 1e30)
    ref, got = _run(jt, tt, rays, any_hit=any_hit, stack_depth=2)
    full_ref, _ = _run(jt, tt, rays, any_hit=any_hit)
    if any_hit:
        np.testing.assert_array_equal(got, ref)
        assert (ref != full_ref).any()          # entries were dropped
    else:
        _same_hits(ref, got)
        assert (ref[3] != full_ref[3]).any()


@pytest.mark.parametrize("case", sorted(RULE_RAYS))
def test_float_rule_rays(case):
    jt, tt = _both_tables(*RULE_TRI)
    rays = rule_rays(case)
    ref, got = _run(jt, tt, rays)
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[3], RULE_HITS[case])
    occ_ref, occ = _run(jt, tt, rays, any_hit=True)
    np.testing.assert_array_equal(occ, occ_ref)


def test_face_rays_on_node_boxes():
    jt, tt = _both_tables(*_random_soup(500, seed=5))
    boxes = np.concatenate([tt["bvh_node_min"], tt["bvh_node_max"]], 1)
    rays = face_rays(boxes, 2048, 71)
    ref, got = _run(jt, tt, rays)
    np.testing.assert_array_equal(got[3], ref[3])
    hit = ref[3] >= 0
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-5,
                               atol=1e-6)
    occ_ref, occ = _run(jt, tt, rays, any_hit=True)
    np.testing.assert_array_equal(occ, occ_ref)


# ------------------------------------------------------- Runtime(use_bvh)
def _scene():
    s = demo_scene()
    s["technique"] = dict(s["technique"], max_depth=3)
    return s


@pytest.fixture(scope="module")
def jax_runtime():
    jrt = JRuntime(copy.deepcopy(_scene()), width=FILM, height=FILM, seed=2,
                   use_bvh=True)
    jrt.step(spi=2)
    return jrt


def test_runtime_use_bvh_tables_equal(jax_runtime):
    rt = Runtime(_scene(), width=FILM, height=FILM, seed=2, use_bvh=True,
                 device="cpu")
    for k in [k for k in jax_runtime.tables if k.startswith("bvh_")]:
        np.testing.assert_array_equal(rt.tables[k].numpy(),
                                      np.asarray(jax_runtime.tables[k]), k)
    # the threshold: no `bvh_*` tables for the small demo by default
    assert "bvh_node_min" not in Runtime(_scene(), width=4, height=4,
                                         device="cpu").tables


def test_runtime_use_bvh_frame_per_pixel(jax_runtime):
    rt = Runtime(_scene(), width=FILM, height=FILM, seed=2, use_bvh=True,
                 device="cpu")
    calls = tbvh.bvh_closest.calls, tbvh.bvh_any.calls
    rt.step(spi=2)
    assert tbvh.bvh_closest.calls > calls[0]
    assert tbvh.bvh_any.calls > calls[1]
    got, want = rt.currentFrame(), jax_runtime.currentFrame()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert want.mean() > 0
