"""The port's sensor-noise model, ``data.augment.depth_noise``, on the CPU.

It draws from a ``torch.Generator``, so it cannot repeat ``jax.random``'s
draws. It is held in two ways:

* exactly, where the outcome does not depend on the draws: what
  ``tests/test_augment.py`` pins for the JAX function (no change at zero
  magnitudes, the background untouched by Gaussian noise, object pixels
  kept as object pixels, flying pixels at least 1/255, the 8-bit lattice,
  per-sample magnitudes), the same bits as JAX's when every magnitude is 0
  and ``quantize`` rounds, and the same bits from the same generator
  state;
* by rates: the dropout and salt fractions within 5 binomial standard
  deviations of their probability, the Gaussian noise's mean and standard
  deviation within 5 standard errors (each check fails by chance with
  probability below 6e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.data.augment import depth_noise as jax_depth_noise
from sqtpu_torch.data.augment import depth_noise

from test_torch_port_ops import _few_torch_threads  # noqa: F401

Z = 5.0  # standard deviations of the rate checks


def _gen(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _img(batch: int = 2, size: int = 32, depth: float = 0.5,
         dtype=torch.float32) -> torch.Tensor:
    """A central square object at ``depth`` on a zero background, as the
    JAX tests' image."""
    img = torch.zeros((batch, size, size), dtype=dtype)
    img[:, size // 4:3 * size // 4, size // 4:3 * size // 4] = depth
    return img


# ---- the JAX tests' pins -----------------------------------------------------

def test_noop_is_identity():
    img = _img()
    assert torch.equal(depth_noise(_gen(0), img), img)


def test_gaussian_object_only():
    img = _img()
    out = depth_noise(_gen(1), img, gaussian=0.02)
    obj = img > 0
    assert (out[~obj] == 0).all()
    assert (out[obj] > 0).all()
    d = out[obj] - 0.5
    assert 0.01 < float(d.std()) < 0.03 and abs(float(d.mean())) < 0.01


def test_dropout_and_salt_ranges():
    img = _img(size=64)
    obj = img > 0
    dropped = float((depth_noise(_gen(2), img, dropout=0.3)[obj] == 0)
                    .double().mean())
    assert 0.2 < dropped < 0.4
    out = depth_noise(_gen(3), img, salt=0.1)
    flying = out[~obj]
    assert 0.05 < float((flying > 0).double().mean()) < 0.15
    assert (flying[flying > 0] >= 1 / 255 - 1e-7).all()


def test_quantize_lattice():
    out = depth_noise(_gen(4), _img() * 0.777, gaussian=0.01, quantize=True)
    np.testing.assert_allclose(out.numpy() * 255,
                               np.round(out.numpy() * 255), atol=1e-4)


def test_per_sample_magnitudes():
    imgs = torch.full((4, 16, 16), 0.5)
    imgs[:, :2] = 0.0  # some background
    g = torch.tensor([0.0, 0.01, 0.02, 0.03]).reshape(4, 1, 1)
    d = torch.tensor([0.0, 0.1, 0.2, 0.3]).reshape(4, 1, 1)
    s = torch.tensor([0.0, 0.005, 0.01, 0.02]).reshape(4, 1, 1)
    out = depth_noise(_gen(0), imgs, gaussian=g, dropout=d, salt=s)
    assert out.shape == imgs.shape
    assert torch.equal(out[0], imgs[0])  # all-zero magnitudes: untouched
    assert float((out[3] != imgs[3]).double().mean()) > 0.05


# ---- exact agreement with JAX and with itself ----------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["fp32", "fp64"])
def test_zero_magnitudes_quantize_like_jax(dtype):
    """No draw decides anything: the round to the lattice (half to even)
    gives JAX's bits, on a map with values at exact half levels."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (2, 24, 24))
    img[0, :4] = (np.arange(24) + 0.5) / 255.0  # half levels
    img[img < 0.2] = 0.0
    x = torch.from_numpy(img).to(dtype)
    want = np.asarray(jax_depth_noise(jax.random.PRNGKey(0),
                                      jnp.asarray(x.numpy()),
                                      quantize=True))
    got = depth_noise(_gen(0), x, gaussian=0.0, dropout=0.0, salt=0.0,
                      quantize=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_same_generator_state_same_bits():
    img = _img(size=48)
    kw = dict(gaussian=0.02, dropout=0.2, salt=0.01, quantize=True)
    a = depth_noise(_gen(7), img, **kw)
    b = depth_noise(_gen(7), img, **kw)
    c = depth_noise(_gen(8), img, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---- rates within binomial bounds -------------------------------------------

def _within(frac: float, p: float, n: int) -> bool:
    return abs(frac - p) <= Z * np.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("p", [0.05, 0.2, 0.5])
def test_dropout_rate(p):
    img = _img(batch=8, size=64)
    obj = img > 0
    out = depth_noise(_gen(10), img, dropout=p)
    n = int(obj.sum())
    assert _within(float((out[obj] == 0).double().mean()), p, n)
    assert torch.equal(out[~obj], img[~obj])


@pytest.mark.parametrize("p", [0.005, 0.05])
def test_salt_rate_and_depths(p):
    img = _img(batch=8, size=64)
    bg = img == 0
    out = depth_noise(_gen(11), img, salt=p)
    hit = out[bg] > 0
    assert _within(float(hit.double().mean()), p, int(bg.sum()))
    depths = out[bg][hit]
    assert float(depths.min()) >= 1 / 255 - 1e-7 and float(depths.max()) < 1
    assert torch.equal(out[~bg], img[~bg])
    # the depths are U(1/255, 1): their mean within 5 standard errors
    m, sd = (1 + 1 / 255) / 2, (1 - 1 / 255) / np.sqrt(12)
    assert abs(float(depths.double().mean()) - m) <= Z * sd / np.sqrt(
        depths.numel())


@pytest.mark.parametrize("sigma", [0.01, 0.03])
def test_gaussian_moments(sigma):
    img = _img(batch=8, size=64, dtype=torch.float64)
    obj = img > 0
    d = (depth_noise(_gen(12), img, gaussian=sigma) - img)[obj]
    n = d.numel()
    assert abs(float(d.mean())) <= Z * sigma / np.sqrt(n)
    # the sample std's standard error is sigma / sqrt(2 n)
    assert abs(float(d.std()) - sigma) <= Z * sigma / np.sqrt(2 * n)


def test_gaussian_clips_into_the_object_range():
    """Near the ends of the range the noise is clipped into [1/510, 1]:
    an object pixel neither vanishes nor leaves the lattice's top."""
    img = _img(batch=4, size=32, depth=0.003)
    img[:, :4, :4] = 0.999
    out = depth_noise(_gen(13), img, gaussian=0.05)
    obj = img > 0
    assert float(out[obj].min()) == pytest.approx(1 / 510, rel=1e-6)
    assert float(out[obj].max()) == 1.0 and (out[obj] > 0).all()
