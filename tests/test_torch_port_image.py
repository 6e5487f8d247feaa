"""The port's depth-map filters, ``apply_prefilter`` and
``quaternion.from_matrix`` against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages: noisy
depth maps with a zero background (a square object, Gaussian ranging
noise, dropout holes and flying pixels), in float32 and float64. The
filters select and count, so they must agree to the bit; ``norm_img``
divides once, also to the bit. ``from_matrix`` is held at fp64 rtol 1e-10
(the same arithmetic; a normalization sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu import fit as jfit
from sqtpu.ops import image as jimage
from sqtpu.ops import quaternion as jquat
from sqtpu_torch import fit as tfit
from sqtpu_torch.ops import image as timage
from sqtpu_torch.ops import quaternion as tquat

from test_torch_port_ops import _few_torch_threads  # noqa: F401

DTYPES = [np.float32, np.float64]


def noisy_depth(seed: int, batch: int = 3, size: int = 64,
                dtype=np.float64) -> np.ndarray:
    """(B, S, S) depth maps in [0, 1], background 0: a square object with
    ranging noise, dropout holes and flying pixels."""
    rng = np.random.default_rng(seed)
    img = np.zeros((batch, size, size))
    lo, hi = size // 4, 3 * size // 4
    img[:, lo:hi, lo:hi] = rng.uniform(0.3, 0.8, (batch, 1, 1))
    obj = img > 0
    img = np.where(obj, np.clip(img + 0.02 * rng.normal(size=img.shape),
                                1 / 510, 1.0), img)
    img = np.where(obj & (rng.uniform(size=img.shape) < 0.2), 0.0, img)
    salt = ~obj & (rng.uniform(size=img.shape) < 0.01)
    img = np.where(salt, rng.uniform(1 / 255, 1.0, img.shape), img)
    return np.round(img * 255.0).astype(dtype) / dtype(255.0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "fp64"])
@pytest.mark.parametrize("name", ["median3", "despeckle", "norm_img"])
def test_filters_match_jax_bit_for_bit(name, dtype):
    img = noisy_depth(1, dtype=dtype)
    want = np.asarray(getattr(jimage, name)(jnp.asarray(img)))
    got = getattr(timage, name)(torch.from_numpy(img))
    assert got.dtype == torch.from_numpy(img).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "fp64"])
@pytest.mark.parametrize("prefilter", ["median", "despeckle", "none", ""])
def test_apply_prefilter_matches_jax(prefilter, dtype):
    img = noisy_depth(2, batch=2, size=48, dtype=dtype)[..., :40]
    want = np.asarray(jfit.apply_prefilter(jnp.asarray(img), prefilter))
    got = tfit.apply_prefilter(torch.from_numpy(img), prefilter).numpy()
    np.testing.assert_array_equal(got, want)


def test_apply_prefilter_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown prefilter"):
        tfit.apply_prefilter(torch.zeros(2, 8, 8), "gaussian")


def test_filters_do_what_they_say():
    """The median fills an isolated hole and removes an isolated flying
    pixel; despeckle removes the flying pixel and keeps the surface."""
    img = torch.zeros(16, 16, dtype=torch.float64)
    img[4:12, 4:12] = 0.5
    img[8, 8] = 0.0            # a dropout hole
    img[1, 1] = 0.9            # a flying pixel
    med = timage.median3(img)
    assert float(med[8, 8]) == 0.5 and float(med[1, 1]) == 0.0
    des = timage.despeckle(img)
    assert float(des[1, 1]) == 0.0
    assert torch.equal(des[4:12, 4:12], img[4:12, 4:12])


@pytest.mark.parametrize("flip", [True, False])
def test_depth_to_points_matches_jax(flip):
    img = noisy_depth(3, batch=1, size=20)[0]
    want = jimage.depth_to_points(jnp.asarray(img), flip_vertical=flip)
    np.testing.assert_array_equal(
        timage.depth_to_points(torch.from_numpy(img), flip_vertical=flip),
        want)
    np.testing.assert_array_equal(timage.depth_to_points(img, flip), want)


def test_from_matrix_matches_jax():
    """Random rotations and the four pivots' edge cases (trace −1 among
    them), fp64 rtol 1e-10; from_matrix inverts to_matrix up to sign."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(64, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    m = np.asarray(jquat.to_matrix(jnp.asarray(q)))
    edges = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]),
                      np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])])
    m = np.concatenate([m, edges])
    want = np.asarray(jquat.from_matrix(jnp.asarray(m)))
    got = tquat.from_matrix(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-15)
    back = np.abs(np.sum(got[:64] * q, axis=-1))
    np.testing.assert_allclose(back, 1.0, rtol=1e-12)
