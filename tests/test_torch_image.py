"""Parity of the port's image ops and detector response with the JAX package.

Same shifted-add filters in the same order on float32 images in [0, 255]:
agreement to 1e-3 gray levels (a few f32 ulps at 255) and on the response
maps to 1e-4 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ov2slam_tpu.ops import detect as jdet
from ov2slam_tpu.ops import image as jim
from ov2slam_tpu_torch.ops import detect as tdet
from ov2slam_tpu_torch.ops import image as tim

from torch_parity import n, t


def _img(seed=0, h=120, w=160):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


@pytest.mark.parametrize("shape", [(120, 160), (61, 93)])
def test_pyramid(shape):
    img = _img(1, *shape)
    pt = tim.build_pyramid(t(img), 3)
    pj = jim.build_pyramid(jnp.asarray(img), 3)
    assert [tuple(a.shape) for a in pt] == [a.shape for a in pj]
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(n(a), n(b), atol=1e-3)


@pytest.mark.parametrize("fn", ["scharr_gradients", "sobel_gradients"])
def test_gradients(fn):
    img = _img(2)
    for a, b in zip(getattr(tim, fn)(t(img)), getattr(jim, fn)(jnp.asarray(img))):
        np.testing.assert_allclose(n(a), n(b), atol=1e-3)


@pytest.mark.parametrize("sigma,radius", [(2.0, 4), (1.2, None)])
def test_gaussian_blur(sigma, radius):
    img = _img(3)
    np.testing.assert_allclose(n(tim.gaussian_blur(t(img), sigma, radius)),
                               n(jim.gaussian_blur(jnp.asarray(img), sigma, radius)),
                               atol=1e-3)


def test_min_eig_response_and_occupancy():
    img = _img(4)
    rt = n(tdet.min_eig_response(t(img)))
    rj = n(jdet.min_eig_response(jnp.asarray(img)))
    np.testing.assert_allclose(rt, rj, rtol=1e-4, atol=1e-4 * np.abs(rj).max())
    rng = np.random.default_rng(4)
    kps = np.stack([rng.uniform(-5, 165, 40), rng.uniform(-5, 125, 40)],
                   -1).astype(np.float32)
    valid = rng.uniform(size=40) > 0.3
    for r in (0, 3, 11):
        np.testing.assert_array_equal(
            n(tdet.occupancy_mask((120, 160), t(kps), t(valid), r)),
            n(jdet.occupancy_mask((120, 160), jnp.asarray(kps),
                                  jnp.asarray(valid), r)))
