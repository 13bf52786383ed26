"""The port's two-level traversal (`ops/tlas.py`) against the JAX package's
Pallas kernel in interpret mode on the float-rule rays of
tests/test_torch_packet_bvh.py (subnormal, infinite and NaN components; on
them pool rows and instances must be EQUAL).  Split from
tests/test_torch_tlas.py, whose helpers and tolerances it uses, so that
`--dist loadfile` runs the slow interpret-mode groups on different workers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu_torch.convert import tables_from_numpy
from test_torch_packet_bvh import RULE_HITS, RULE_RAYS
from test_torch_tlas import _both, _rule_case, _walk_ray_by_ray


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's eager ops on these small inputs run faster on one intra-op
    thread, and the test workers sharing the CPU then do not oversubscribe
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(RULE_RAYS) + ["faces"])
def test_tlas_float_rules_match_pallas_interpret(case):
    """Subnormal, infinite and NaN components: the JAX package's results
    (the subnormal case failed before the port took its float rules)."""
    tab, rays = _rule_case(case)
    jtab = {k: jnp.asarray(v) for k, v in tab.items()}
    ttab = tables_from_numpy(tab, "cpu")
    for any_hit in (False, True):
        ref, got = _both(jtab, ttab, rays, 0xF, any_hit)
        if case in RULE_HITS and not any_hit:
            assert got[3].tolist() == RULE_HITS[case]
        if case == "faces":
            # rays that start on box faces, where vertices lie, along
            # near-axis directions graze triangle edges: a hit within
            # rounding of an edge (XLA contracts multiply-adds and flushes
            # subnormals in the functionals) may go either way.  The first
            # gate of this file holds, and the plain version is the
            # ray-by-ray walk of the kernel, bit for bit.
            key = (lambda x: x[3] >= 0) if any_hit else (lambda x: x[3])
            assert (key(got) == key(ref)).mean() > 0.99
            with np.errstate(all="ignore"):
                walk = _walk_ray_by_ray(tab, rays, 0xF, any_hit)
            for a, b in zip(got, walk):
                np.testing.assert_array_equal(a, b.astype(a.dtype))
            continue
        np.testing.assert_array_equal(got[3] >= 0, ref[3] >= 0)
        if any_hit:
            continue
        np.testing.assert_array_equal(got[3], ref[3])
        np.testing.assert_array_equal(got[4], ref[4])
        hit = ref[3] >= 0
        np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[1][hit], ref[1][hit], atol=1e-4)
        np.testing.assert_allclose(got[2][hit], ref[2][hit], atol=1e-4)
        np.testing.assert_array_equal(got[0][~hit], ref[0][~hit])
