"""The cameras (`render/camera.py`) against the JAX package's:
`generate_rays` of the orthogonal camera, the fishlens camera in its three
aspect modes (films wider and taller than high), the perspective camera with
depth of field, and each type under a registry pose; `sample_pixel` of all
three camera types.  Both packages compile the same scene, and the camera
configs are held equal first.

Tolerance: rays within 1e-6 (absolute).  The fishlens rays go through sin /
cos / sqrt of the angle, whose last bit may differ between XLA's and
PyTorch's CPU functions; the other cameras agree to the bit here but are held
to the same bound.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import create_flat_scene
from ignis_tpu.render import camera as jc
from ignis_tpu.scene.compile import load_and_compile as j_compile
from ignis_tpu_torch.render import camera as tc
from ignis_tpu_torch.scene.compile import load_and_compile as t_compile

N = 4096
TOL = 1e-6
CAMERAS = {
    "orthogonal": dict(type="orthogonal", scale=1.5),
    "fishlens circular": dict(type="fishlens", mode="circular"),
    "fishlens full": dict(type="fishlens", mode="full"),
    "fishlens cropped": dict(type="fishlens", mode="cropped"),
    "perspective dof": dict(type="perspective", aperture_radius=0.05,
                            focal_length=1.5),
}
FILMS = [(16, 9), (9, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cams(kind, film):
    s = copy.deepcopy(create_flat_scene())
    s["camera"] = dict(s["camera"], **CAMERAS[kind])
    a, b = j_compile(copy.deepcopy(s), *film), t_compile(s, *film)
    ja, tb = a.camera, b.camera
    assert (ja.type, ja.fishlens_mode, ja.aperture_radius, ja.focal_length) \
        == (tb.type, tb.fishlens_mode, tb.aperture_radius, tb.focal_length)
    for f in ("eye", "dir", "up", "scale"):
        np.testing.assert_array_equal(getattr(ja, f), getattr(tb, f))
    return ja, tb


def _coords(seed):
    r = np.random.default_rng(seed)
    nx = r.uniform(-1, 1, N).astype(np.float32)
    ny = r.uniform(-1, 1, N).astype(np.float32)
    nx[:3], ny[:3] = (0, 1, -1), (0, -1, 1)       # the centre and corners
    lens = r.uniform(0, 1, (2, N)).astype(np.float32)
    return nx, ny, lens


def _close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("film", FILMS)
@pytest.mark.parametrize("kind", sorted(CAMERAS))
def test_generate_rays(kind, film):
    ja, tb = _cams(kind, film)
    nx, ny, lens = _coords(sorted(CAMERAS).index(kind))
    ref = jc.generate_rays(ja, jnp.asarray(nx), jnp.asarray(ny),
                           lens_uv=tuple(jnp.asarray(l) for l in lens))
    got = tc.generate_rays(tb, torch.from_numpy(nx), torch.from_numpy(ny),
                           lens_uv=tuple(torch.from_numpy(l) for l in lens))
    _close(got, ref)
    norms = torch.linalg.norm(got[1], dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)


@pytest.mark.parametrize("kind", sorted(CAMERAS))
def test_generate_rays_registry_pose(kind):
    """A pose from the registry (`dyn` = eye, dir, up) for every type."""
    ja, tb = _cams(kind, FILMS[0])
    nx, ny, lens = _coords(7)
    eye = np.float32([0.3, -0.2, -1.5])
    d = np.float32([0.1, 0.2, 1.0])
    d /= np.linalg.norm(d)
    up = np.float32([0, 1, 0])
    ref = jc.generate_rays(ja, jnp.asarray(nx), jnp.asarray(ny),
                           dyn=tuple(jnp.asarray(v) for v in (eye, d, up)),
                           lens_uv=tuple(jnp.asarray(l) for l in lens))
    got = tc.generate_rays(tb, torch.from_numpy(nx), torch.from_numpy(ny),
                           dyn=tuple(torch.from_numpy(v) for v in (eye, d, up)),
                           lens_uv=tuple(torch.from_numpy(l) for l in lens))
    _close(got, ref)
    if kind != "orthogonal":
        assert torch.allclose(got[0][5], torch.from_numpy(eye), atol=0.06)


@pytest.mark.parametrize("kind", ["perspective", "orthogonal", "fishlens"])
def test_sample_pixel(kind):
    """World points to the film: valid, nx, ny, dir, weight."""
    s = copy.deepcopy(create_flat_scene())
    s["camera"] = dict(s["camera"], type=kind)
    ja = j_compile(copy.deepcopy(s), 16, 9).camera
    tb = t_compile(s, 16, 9).camera
    r = np.random.default_rng(3)
    pos = np.concatenate([r.uniform(-1.5, 1.5, (N, 2)),
                          r.uniform(-2.0, 1.0, (N, 1))], 1).astype(np.float32)
    ref = jc.sample_pixel(ja, jnp.asarray(pos))
    got = tc.sample_pixel(tb, torch.from_numpy(pos))
    assert ref.keys() == got.keys()
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(ref["valid"]))
    ok = got["valid"].numpy()
    for k in ("nx", "ny", "dir", "weight"):
        a, b = got[k].numpy(), np.asarray(ref[k])
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-6, atol=TOL,
                                   err_msg=k)
    if kind == "fishlens":
        assert not ok.any()
    else:
        assert ok.mean() > 0.1
