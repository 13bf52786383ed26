"""The brightest lanes of the materials scene's 512x512 render, through both
packages: the fireflies that `chip_smoke.py`'s `train` phase clamps at 10.

The pixels are those that `scripts/torch_fireflies.py` finds above 100 on an
H100 (sample, iteration, frame and seed 0, one lane a pixel), with the true
parameters (the phase's target) and with its perturbed start (colors x 0.7,
the microfacet roughness slots + 0.1).  The JAX package renders the same
radiance there: the fireflies belong to the scene, not to the port.

Tolerance: per channel rel 1e-3; the largest channel above 1e3 in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ignis_tpu.render.integrator import trace_wave as j_trace_wave
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.convert import tables_from_numpy
from ignis_tpu_torch.render.integrator import trace_wave
from ignis_tpu_torch.scene.compile import (
    BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC, BSDF_ROUGH_PLASTIC,
    load_and_compile as t_compile,
)
from ignis_tpu_torch.scenes import materials_scene

FILM = 512
FIREFLIES = {   # (x, y) of the brightest lanes, brightest first
    "target": [(302, 291), (277, 446), (317, 460), (300, 432), (261, 396),
               (261, 223)],
    "start": [(302, 291), (258, 288), (279, 236), (261, 223), (187, 373),
              (287, 263)],
}


def _tables(scene, which):
    tables = dict(scene.tables)
    if which == "start":
        rough = [i for i, t in enumerate(scene.bsdf_types) if t in (
            BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC, BSDF_ROUGH_PLASTIC)]
        tables["mat_colors"] = tables["mat_colors"] * np.float32(0.7)
        sc = tables["mat_scalars"].copy()
        sc[rough, 0] += np.float32(0.1)
        sc[rough, 4] += np.float32(0.1)
        tables["mat_scalars"] = sc
    return tables


@pytest.mark.parametrize("which", sorted(FIREFLIES))
def test_materials_fireflies_match_reference(which):
    js = j_compile(materials_scene(), FILM, FILM)
    ts = t_compile(materials_scene(), FILM, FILM)
    x, y = (np.array(c, np.int32) for c in zip(*FIREFLIES[which]))
    jt = _tables(js, which)
    ref = np.asarray(j_trace_wave(
        js, {k: jnp.asarray(v) for k, v in jt.items()}, jnp.asarray(x),
        jnp.asarray(y), jnp.uint32(0), jnp.uint32(0), jnp.uint32(0), 0))
    got = trace_wave(ts, tables_from_numpy(_tables(ts, which), "cpu"),
                     torch.from_numpy(x), torch.from_numpy(y), 0, 0, 0, 0,
                     differentiable=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3)
    assert got.max() > 1e3 and ref.max() > 1e3
