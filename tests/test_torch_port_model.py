"""Parity of the port's ResNetSQ, its weight conversion and the slice as a
whole with the JAX package, on the CPU.

Weights: the shipped ``artifacts/resnet_sq_c4_fp16.npz``, loaded by each
package's own loader. Both sides compute in float32. Tolerances: atol 1e-4
on the ResNetSQ outputs (two fp32 convolution stacks that sum in another
order); atol 1e-3 on the slice's params, whose inputs are depth maps
that may differ in a few grazing pixels (the renderer's bound).
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.models import ResNetSQ as FlaxResNetSQ
from sqtpu.models import params_vector as flax_params_vector
from sqtpu.ops import render as jrender
from sqtpu.utils.checkpoint import load_weights_npz as flax_load_weights
from sqtpu_torch.models import ResNetSQ, build_model, params_vector
from sqtpu_torch.ops import render as trender
from sqtpu_torch.utils.checkpoint import (
    load_weights_npz, state_dict_from_flax,
)

from test_torch_port_ops import _few_torch_threads  # noqa: F401


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "artifacts", "resnet_sq_c4_fp16.npz")
TRUTHS = os.path.join(ROOT, "runs", "eval_c4c3", "accs.npz")


@pytest.fixture(scope="module")
def flax_model():
    model = FlaxResNetSQ()
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 1), jnp.float32))
    variables = flax_load_weights(WEIGHTS, {
        "params": template["params"],
        "batch_stats": template["batch_stats"]})
    apply = jax.jit(lambda x: flax_params_vector(
        model.apply(variables, x, train=False)))
    return apply


@pytest.fixture(scope="module")
def torch_model():
    model = ResNetSQ()
    load_weights_npz(WEIGHTS, model)
    return model.eval()


@pytest.fixture(scope="module")
def truths():
    with np.load(TRUTHS) as d:
        return d["true_params"][:4].astype(np.float32)


def test_forward_matches_flax(flax_model, torch_model, truths):
    imgs = trender.render_depth_hard_batch(
        torch.from_numpy(truths[:2]), 256, n_bisect=16, quantize=True,
        n_sweep=64)
    want = np.asarray(flax_model(jnp.asarray(imgs.numpy()[..., None])))
    with torch.no_grad():
        got = params_vector(torch_model(imgs[..., None])).numpy()
        got3 = params_vector(torch_model(imgs)).numpy()  # (B, H, W) input
    assert got.shape == (2, 12) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got3, got)
    np.testing.assert_allclose(np.linalg.norm(got[:, 8:], axis=-1), 1.0,
                               atol=1e-5)


def test_slice_matches_jax_pipeline(flax_model, torch_model, truths):
    """Recorded truths -> hard render -> ResNetSQ, through each package."""
    jimgs = jrender.render_depth_hard_batch(
        jnp.asarray(truths), 256, n_bisect=16, quantize=True, n_sweep=64)
    want = np.asarray(flax_model(jimgs[..., None]))
    timgs = trender.render_depth_hard_batch(
        torch.from_numpy(truths), 256, n_bisect=16, quantize=True,
        n_sweep=64)
    with torch.no_grad():
        got = params_vector(torch_model(timgs[..., None])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_rotation_head_is_finite_at_zero():
    model = ResNetSQ()
    with torch.no_grad():
        for p in model.head_rotation.parameters():
            p.zero_()
    x = torch.rand(2, 32, 32, 1, requires_grad=True)
    q = model.eval()(x)[3]
    q.sum().backward()
    assert torch.isfinite(q).all() and torch.isfinite(x.grad).all()
    assert torch.equal(q, torch.zeros_like(q))


def test_model_layout_matches_flax():
    """Every flax variable has exactly one place in the torch model."""
    model = FlaxResNetSQ()
    v = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 32, 32, 1), jnp.float32))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path):
            np.zeros(x.shape, x.dtype)
            for path, x in jax.tree_util.tree_leaves_with_path(
                flax.core.unfreeze(v))}
    sd = state_dict_from_flax(flat, ResNetSQ().state_dict())
    assert set(sd) == set(ResNetSQ().state_dict())


def test_conversion_transposes_and_casts():
    with np.load(WEIGHTS) as d:
        flat = {k: d[k] for k in d.files}
    sd = state_dict_from_flax(flat, ResNetSQ().state_dict())
    k = flat["params/encoder/layer2_0/conv1/kernel"]       # HWIO fp16
    np.testing.assert_array_equal(
        sd["encoder.layer2_0.conv1.weight"].numpy(),
        k.astype(np.float32).transpose(3, 2, 0, 1))
    w = flat["params/fc1/kernel"]                          # (in, out)
    np.testing.assert_array_equal(sd["fc1.weight"].numpy(),
                                  w.astype(np.float32).T)
    np.testing.assert_array_equal(
        sd["encoder.bn1.running_var"].numpy(),
        flat["batch_stats/encoder/bn1/var"])
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())


@pytest.mark.parametrize("fault", ["missing", "leftover", "shape"])
def test_conversion_raises_on_mismatch(fault):
    with np.load(WEIGHTS) as d:
        flat = {k: d[k] for k in d.files}
    if fault == "missing":
        del flat["batch_stats/encoder/layer3_1/bn2/mean"]
        err = KeyError
    elif fault == "leftover":
        flat["params/head_extra/Dense_0/kernel"] = np.zeros((256, 2))
        err = KeyError
    else:
        flat["params/fc2/bias"] = np.zeros((255,), np.float16)
        err = ValueError
    with pytest.raises(err):
        state_dict_from_flax(flat, ResNetSQ().state_dict())


def test_build_model_names_later_slices():
    """Every name of the JAX package's registry builds since Slice F (the
    flattening models for the given image size); any other name is the
    JAX registry's KeyError (``classical`` among them: an evaluation
    mode, not a model)."""
    from sqtpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from sqtpu_torch.models import IterativeSQ, KerasIsoNet

    assert isinstance(build_model("resnet_sq"), ResNetSQ)
    assert isinstance(build_model("refine_sq", n_refine=1, n_sweep=8),
                      IterativeSQ)
    for name in JAX_REGISTRY:
        assert build_model(name, 64) is not None, name
    assert build_model("keras_iso", 64).out.in_features == 2 * 2 * 256
    assert isinstance(build_model("keras_iso"), KerasIsoNet)
    for name in ("no_such_model", "classical"):
        with pytest.raises(KeyError):
            build_model(name)