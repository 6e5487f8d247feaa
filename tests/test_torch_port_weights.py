"""ResNetSQ of the port in train mode, its initial weights, weights carried
back to the JAX package, and the validation number ``chip_smoke.py`` pins.

Held against flax on the CPU: train-mode outputs atol 1e-4 (fp32
convolution sums in another order) and the updated BatchNorm statistics
(mean and the biased variance) rtol 1e-5; the initial weights by each
layer's standard deviation within 10% (two random draws of the same
distribution).
"""

import os
import sys

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.models import ResNetSQ as FlaxResNetSQ
from sqtpu.models import params_vector as flax_params_vector
from sqtpu.ops import losses as jlosses
from sqtpu.ops import render as jrender
from sqtpu.utils.checkpoint import load_weights_npz as flax_load_weights
from sqtpu_torch.models import ResNetSQ, params_vector
from sqtpu_torch.models.resnet import BatchNorm
from sqtpu_torch.ops import losses as tlosses
from sqtpu_torch.ops import render as trender
from sqtpu_torch.utils.checkpoint import (
    flax_from_state_dict, load_weights_npz, save_weights_npz,
    state_dict_from_flax,
)

from test_torch_port_ops import _few_torch_threads  # noqa: F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSL = os.path.join(ROOT, "artifacts", "resnet_sq_ssl_fp16.npz")
TRUTHS = os.path.join(ROOT, "runs", "eval_c4c3", "accs.npz")


def _flax_template():
    model = FlaxResNetSQ()
    v = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 32, 32, 1), jnp.float32))
    return model, {"params": v["params"], "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def ssl_flax():
    model, template = _flax_template()
    return model, flax_load_weights(SSL, template)


def _ssl_port() -> ResNetSQ:
    return load_weights_npz(SSL, ResNetSQ())


def _images(seed: int, b: int, s: int) -> np.ndarray:
    """Depth maps of numpy-made params, rendered by the port's plain
    renderer: the same float32 inputs for both packages."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = np.concatenate([rng.uniform(25 / 255, 75 / 255, (b, 3)),
                        rng.uniform(0.1, 1.0, (b, 2)),
                        (128 + rng.uniform(-40, 40, (b, 3))) / 255, q], -1)
    return trender.render_depth_hard_batch(
        torch.tensor(p, dtype=torch.float32), s, n_bisect=12,
        quantize=True, n_sweep=48).numpy()


def _flat_stats(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(
                flax.core.unfreeze(tree))}


def test_train_mode_forward_and_batch_stats_match_flax(ssl_flax):
    model, variables = ssl_flax
    imgs = _images(80, 4, 64)
    out, mutated = model.apply(variables, jnp.asarray(imgs[..., None]),
                               train=True, mutable=["batch_stats"])
    want = np.asarray(flax_params_vector(out))
    port = _ssl_port().train()
    got = params_vector(port(torch.from_numpy(imgs)[..., None]))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4, rtol=0)
    stats = flax_from_state_dict(port.state_dict())
    new = _flat_stats({"batch_stats": mutated["batch_stats"]})
    assert len(new) == 2 * 20  # mean and var of every BatchNorm
    for key, value in new.items():
        np.testing.assert_allclose(stats[key], value, rtol=1e-5, atol=1e-8,
                                   err_msg=key)


def test_batchnorm_updates_with_the_biased_variance():
    """flax's BatchNorm against the port's on 8 values per channel, where
    the unbiased variance (torch's own update) is 8/7 of the biased one."""
    x = np.random.default_rng(81).normal(1.0, 2.0, (2, 2, 2, 3))  # NHWC
    x = x.astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, mutated = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(3, eps=1e-5, momentum=0.01).train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = port(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(y), atol=1e-5, rtol=0)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)
    plain = torch.nn.BatchNorm2d(3, eps=1e-5, momentum=0.01).train()
    plain(xt)
    assert not np.allclose(plain.running_var.numpy(),
                           np.asarray(stats["var"]), rtol=1e-4)
    # eval mode uses the running statistics
    port.eval()
    want = (xt - port.running_mean[None, :, None, None]) / torch.sqrt(
        port.running_var[None, :, None, None] + 1e-5)
    torch.testing.assert_close(port(xt), want, rtol=1e-5, atol=1e-6)


def test_initial_weights_follow_flax():
    model, _ = _flax_template()
    ref = flax.core.unfreeze(model.init(
        jax.random.PRNGKey(82), jnp.zeros((1, 32, 32, 1), jnp.float32)))
    ref = flax_from_state_dict(state_dict_from_flax(
        _flat_stats(ref), ResNetSQ().state_dict()))
    torch.manual_seed(82)
    got = flax_from_state_dict(ResNetSQ().state_dict())
    assert set(got) == set(ref)
    for key, want in ref.items():
        have = got[key]
        if key.endswith("/kernel"):
            fan_in = int(np.prod(have.shape[:-1]))
            assert have.std() == pytest.approx(want.std(), rel=0.1), key
            assert have.std() == pytest.approx(fan_in ** -0.5, rel=0.1), key
            bound = 2 * fan_in ** -0.5 / 0.87962566103423978
            assert np.abs(have).max() <= bound * (1 + 1e-6), key
        else:  # biases and BatchNorm: constants
            np.testing.assert_array_equal(have, want, err_msg=key)


def test_weights_round_trip_to_jax(tmp_path):
    """The port saves, the JAX package loads into a flax template, and
    flax's forward equals the port's."""
    torch.manual_seed(83)
    port = ResNetSQ()
    port.train()(torch.rand(2, 32, 32, 1))  # move the BatchNorm statistics
    port.eval()
    path = tmp_path / "port_weights.npz"
    save_weights_npz(str(path), port, dtype=np.float32)
    model, template = _flax_template()
    variables = flax_load_weights(str(path), template)
    imgs = _images(84, 2, 64)
    want = np.asarray(flax_params_vector(model.apply(
        variables, jnp.asarray(imgs[..., None]), train=False)))
    with torch.no_grad():
        got = params_vector(port(torch.from_numpy(imgs))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the default fp16 file has the JAX artifact's keys, dtypes and shapes
    save_weights_npz(str(tmp_path / "half.npz"), port)
    with np.load(tmp_path / "half.npz") as mine, np.load(SSL) as theirs:
        assert set(mine.files) == set(theirs.files)
        for k in theirs.files:
            assert mine[k].shape == theirs[k].shape, k
            assert mine[k].dtype == theirs[k].dtype, k
    back = load_weights_npz(str(path), ResNetSQ())
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back.state_dict()[k], v), k


def test_pinned_validation_number():
    """The constant chip_smoke.py holds the card to: the JAX package's
    implicit loss of the ssl artifact's predictions on the first 16
    recorded truths (JAX hard render at (48, 12), 256², eval mode, 64³).

    On the JAX package's images, the port's model and plain loss give it
    within 1e-5 (measured 6e-7: convolution sums in another order). The
    port's whole CPU pipeline, its own hard render included, is held to
    1e-3 like the card: the two renderers differ by one gray level on 8 of
    the 16·256² pixels (the renderer's bound is 0.1%), and that moves this
    loss by 2.5e-4."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    with np.load(TRUTHS) as d:
        truths = d["true_params"][:chip_smoke.PINNED_N].astype(np.float32)
    model, template = _flax_template()
    variables = flax_load_weights(SSL, template)
    imgs = jrender.render_depth_hard_batch(jnp.asarray(truths), 256,
                                          n_bisect=12, quantize=True,
                                          n_sweep=48)
    pred = flax_params_vector(model.apply(variables, imgs[..., None],
                                          train=False))
    jax_loss = float(jlosses.implicit_loss(imgs, pred, 64, 1.5, 260.0))
    assert jax_loss == pytest.approx(chip_smoke.PINNED_VAL_LOSS, rel=1e-6)

    port = _ssl_port().eval()

    def port_loss(images: torch.Tensor) -> float:
        with torch.no_grad():
            tpred = params_vector(port(images[..., None]))
            return float(tlosses.implicit_loss(images, tpred, 64, 1.5,
                                               260.0))

    assert port_loss(torch.tensor(np.asarray(imgs))) == pytest.approx(
        jax_loss, rel=1e-5)
    timgs = trender.render_depth_hard_batch(torch.from_numpy(truths), 256,
                                            n_bisect=12, quantize=True,
                                            n_sweep=48)
    assert port_loss(timgs) == pytest.approx(
        jax_loss, rel=chip_smoke.PINNED_RTOL)
