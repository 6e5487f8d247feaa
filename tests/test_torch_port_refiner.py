"""The port's render-and-compare corrector ``refine_sq`` against the JAX
package's on the CPU, its weights, its trainer options and the
``leastsquares`` loss in a train step.

* ``apply_delta`` equals the JAX package's to the bit in float64 in a,
  e and t, and in the quaternion within 3e-16 relative: XLA computes the
  norm of ``normalize`` as a chain of fused multiply-adds (it matched
  fma(x3, x3, fma(x2, x2, fma(x1, x1, x0·x0))) on 3000 of 3000 rows),
  which torch's CPU operations do not offer; 1 ulp apart.
* ``IterativeSQ`` at full width on ``artifacts/refine_sq_c4r1_fp16.npz``,
  4 images at 256², float32, eval mode: within the atol 1e-4 the c4
  forward holds (tests/test_torch_port_model.py); each package renders
  its in-loop depth maps with its own plain renderer.
* One step of the c4r1 recipe (``runs/queue_r13.sh:84-93``: explicit_sym,
  sharpness 20, gauge 2, elongation 1.5, shape 4, ``freeze_base``) from
  the c4r1 artifact at B=4, 64², render size 16, against the JAX
  package's step: the loss relative 1e-5, the gradients before Adam
  within 2e-3 of each tensor's largest, the base's BatchNorm statistics
  (moved once) rtol 1e-5 / atol 1e-8, as
  tests/test_torch_port_train_supervised.py holds them; the corrector's
  (moved twice) within 1e-5 of each tensor's largest value, since its
  input holds each package's own render of the estimate, and the two
  plain renderers differ by up to 7.9e-6 on 9.7% of the pixels
  (unquantized, 64², the bisection's float32 rounding; 64 recorded
  predictions); the base's parameters equal to the bit after the step.
* ``warm_start_base`` and the weight round trip to the bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.models import build_model as flax_build_model
from sqtpu.models import params_vector as flax_params_vector
from sqtpu.models import refiner as jrefiner
from sqtpu.training import loop as jloop
from sqtpu.training.state import create_train_state as jax_create_state
from sqtpu.utils import config as jconfig
from sqtpu.utils.checkpoint import load_weights_npz as flax_load_weights
from sqtpu_torch import train as train_entry
from sqtpu_torch.models import (
    IterativeSQ, ResNetSQ, apply_delta, build_model, params_vector,
    refiner as trefiner, warm_start_base,
)
from sqtpu_torch.ops import render as trender
from sqtpu_torch.training import loop as tloop
from sqtpu_torch.training.state import create_train_state
from sqtpu_torch.utils.checkpoint import (
    flax_from_state_dict, load_weights_npz, state_dict_from_flax,
)
from sqtpu_torch.utils.config import TrainConfig

from test_torch_port_ops import _few_torch_threads  # noqa: F401
from test_torch_port_weights import ROOT, TRUTHS, _flat_stats

C4 = os.path.join(ROOT, "artifacts", "resnet_sq_c4_fp16.npz")
C4R1 = os.path.join(ROOT, "artifacts", "refine_sq_c4r1_fp16.npz")
SMALL = dict(batch_size=4, image_size=64, render_size=16, acc_render_size=16)
# the c4r1 recipe's loss flags (runs/queue_r13.sh:84-93)
C4R1_LOSS = dict(model="refine_sq", loss="explicit_sym", explicit_sharp=20.0,
                 gauge_weight=2.0, elong_weight=1.5, shape_weight=4.0,
                 freeze_base=True, learning_rate=1e-4, nan_policy="skip")


def _truths(n: int) -> np.ndarray:
    with np.load(TRUTHS) as d:
        return d["true_params"][:n].astype(np.float32)


def test_apply_delta_matches_jax_to_the_bit():
    rng = np.random.default_rng(3)
    p = np.concatenate([rng.uniform(0.0, 1.05, (16, 8)),
                        rng.normal(size=(16, 4))], -1)
    p[:, 8:] /= np.linalg.norm(p[:, 8:], axis=-1, keepdims=True)
    delta = rng.normal(scale=0.5, size=(16, 11))
    delta[0] = 0.0
    want = np.asarray(jrefiner.apply_delta(jnp.asarray(p),
                                           jnp.asarray(delta)))
    got = apply_delta(torch.from_numpy(p), torch.from_numpy(delta)).numpy()
    np.testing.assert_array_equal(got[:, :8], want[:, :8])
    np.testing.assert_allclose(got[:, 8:], want[:, 8:], rtol=3e-16, atol=0)
    np.testing.assert_array_equal(got[0], np.concatenate([
        np.clip(p[0, :3], 0.05, 1.0), np.clip(p[0, 3:5], 0.1, 1.0),
        np.clip(p[0, 5:8], 0.0, 1.0), got[0, 8:]]))
    # the derivative at the clip's bounds is jnp.clip's (1/2)
    pt = torch.tensor(p[:1], requires_grad=True)
    pt.data[0, 3] = 1.0
    apply_delta(pt, torch.zeros(1, 11, dtype=torch.float64))[0, 3].backward()
    assert pt.grad[0, 3].item() == 0.5


@pytest.fixture(scope="module")
def c4r1_images():
    return trender.render_depth_hard_batch(
        torch.from_numpy(_truths(4)), 256, n_bisect=16, quantize=True,
        n_sweep=64)


def test_forward_matches_flax_on_the_c4r1_artifact(c4r1_images):
    model = flax_build_model("refine_sq")
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 1), jnp.float32))
    variables = flax_load_weights(C4R1, {
        "params": template["params"],
        "batch_stats": template["batch_stats"]})
    imgs = c4r1_images.numpy()[..., None]
    want = np.asarray(jax.jit(lambda x: flax_params_vector(
        model.apply(variables, x, train=False)))(jnp.asarray(imgs)))
    port = load_weights_npz(C4R1, build_model("refine_sq")).eval()
    with torch.no_grad():
        got = params_vector(port(torch.from_numpy(imgs))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the corrector moved the base's prediction
    with torch.no_grad():
        base = params_vector(port.base(torch.from_numpy(imgs))).numpy()
    assert np.abs(got - base).max() > 1e-3


def test_renders_are_detached(monkeypatch, c4r1_images):
    """The in-loop renders take the detached estimate, return no graph,
    and the gradient reaches the base through apply_delta alone."""
    from sqtpu_torch.ops import kernels

    seen = []
    real = kernels.render_hard_auto

    def spy(p, *args, **kw):
        seen.append(p.requires_grad)
        out = real(p, *args, **kw)
        seen.append(out.requires_grad)
        return out

    monkeypatch.setattr(kernels, "render_hard_auto", spy)
    model = load_weights_npz(C4R1, build_model("refine_sq")).eval()
    x = c4r1_images[:2, ::4, ::4].contiguous()
    out = params_vector(model(x))
    assert seen == [False, False, False, False]
    out.sum().backward()
    assert model.base.fc1.weight.grad.abs().max() > 0
    assert model.refine.encoder.conv1.weight.grad.abs().max() > 0


def test_identity_at_init_after_warm_start(c4r1_images):
    """warm_start_base loads the base to the bit; the fresh corrector
    then returns the base's prediction."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = warm_start_base(build_model("refine_sq"), C4).eval()
    base = load_weights_npz(C4, ResNetSQ()).eval()
    for (k, v), (kb, vb) in zip(model.base.state_dict().items(),
                                base.state_dict().items()):
        assert k == kb and torch.equal(v, vb), k
    assert torch.count_nonzero(model.refine.delta.weight) == 0
    x = c4r1_images[:2]
    with torch.no_grad():
        got = params_vector(model(x))
        want = params_vector(base(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6)


def test_weights_round_trip_to_the_bit():
    with np.load(C4R1) as d:
        flat = {k: d[k] for k in d.files}
    model = build_model("refine_sq")
    sd = state_dict_from_flax(flat, model.state_dict())
    assert sd["refine.encoder.conv1.weight"].shape == (64, 2, 7, 7)
    assert sd["refine.fc1.weight"].shape == (256, 512 + 12)
    model.load_state_dict(sd)
    back = flax_from_state_dict(model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32), k)


@pytest.fixture(scope="module")
def batch():
    labels = _truths(4)
    imgs = trender.render_depth_hard_batch(
        torch.from_numpy(labels), 64, n_bisect=12, quantize=True,
        n_sweep=48).numpy()[..., None]
    return imgs, labels


def _jax_step(imgs, labels, cfg_kw):
    cfg = jconfig.TrainConfig(**SMALL, **cfg_kw, use_pallas=False,
                              donate=False)
    model = flax_build_model(cfg.model)
    state = jax_create_state(model, jax.random.PRNGKey(0), cfg)
    v = flax_load_weights(C4R1 if cfg.model == "refine_sq" else C4, {
        "params": state.params, "batch_stats": state.batch_stats})
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    ji, jl = jnp.asarray(imgs), jnp.asarray(labels)
    new_state, loss = jloop.make_train_step(model, cfg)(state, ji, jl)

    def loss_fn(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": state.batch_stats}, ji,
                             train=True, mutable=["batch_stats"])
        return jloop._compute_loss(cfg, flax_params_vector(out), ji, jl)

    grads = jax.jit(jax.grad(loss_fn))(state.params)
    return {"loss": float(loss), "grads": _flat_stats({"params": grads}),
            "stats": _flat_stats({"batch_stats": new_state.batch_stats})}


def _port_step(imgs, labels, cfg_kw, remat=False):
    cfg = TrainConfig(**SMALL, **cfg_kw, remat=remat, device="cpu")
    net = build_model(cfg.model)
    load_weights_npz(C4R1 if cfg.model == "refine_sq" else C4, net)
    state = create_train_state(net, cfg)
    loss = tloop.make_train_step(state, cfg)(torch.from_numpy(imgs),
                                             torch.from_numpy(labels))
    return loss, state.model


def test_c4r1_step_with_frozen_base_matches_jax(batch):
    imgs, labels = batch
    want = _jax_step(imgs, labels, C4R1_LOSS)
    start = load_weights_npz(C4R1, build_model("refine_sq")).state_dict()
    start = {k: v.clone() for k, v in start.items()}
    loss, model = _port_step(imgs, labels, C4R1_LOSS)
    assert loss.item() == pytest.approx(want["loss"], rel=1e-5)
    grads = flax_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})
    assert set(grads) == set(want["grads"])
    for key, g in want["grads"].items():
        if key.startswith("params/base/"):
            assert not grads[key].any(), key  # frozen: zeroed gradients
            continue
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(grads[key], g, rtol=0, atol=2e-3 * scale,
                                   err_msg=key)
    stats = flax_from_state_dict(model.state_dict())
    assert {k.split("/")[1] for k in want["stats"]} == {"base", "refine"}
    for key, value in want["stats"].items():
        atol = (1e-5 * float(np.abs(value).max())
                if key.startswith("batch_stats/refine/") else 1e-8)
        np.testing.assert_allclose(stats[key], value, rtol=1e-5, atol=atol,
                                   err_msg=key)
    after = model.state_dict()
    for name, p in model.base.named_parameters():
        assert torch.equal(after["base." + name], start["base." + name])
    moved = [k for k in after if k.endswith("running_mean")
             and not torch.equal(after[k], start[k])]
    assert len(moved) == 2 * 20  # every BatchNorm of both encoders
    assert not torch.equal(after["refine.delta.weight"],
                           start["refine.delta.weight"])


def test_remat_changes_nothing_in_the_corrector(batch):
    """With remat both encoders are recomputed in the backward; the loss,
    the gradients and the statistics (the corrector's moved twice, not
    four times) are those of the step without it."""
    imgs, labels = batch
    runs = {}
    for remat in (False, True):
        loss, model = _port_step(imgs, labels, C4R1_LOSS, remat)
        runs[remat] = (loss, {n: p.grad.clone() for n, p in
                              model.named_parameters()},
                       {n: b.clone() for n, b in model.named_buffers()})
    (l0, g0, b0), (l1, g1, b1) = runs[False], runs[True]
    assert l1.item() == pytest.approx(l0.item(), rel=1e-6)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=1e-12)
    for name in b0:
        torch.testing.assert_close(b1[name], b0[name], rtol=1e-6, atol=0)


def test_leastsquares_step_matches_jax(batch):
    imgs, labels = batch
    kw = dict(loss="leastsquares", learning_rate=1e-4)
    want = _jax_step(imgs, labels, kw)
    loss, model = _port_step(imgs, labels, kw)
    assert loss.item() == pytest.approx(want["loss"], rel=1e-5)
    grads = flax_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})
    for key, g in want["grads"].items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(grads[key], g, rtol=0, atol=2e-3 * scale,
                                   err_msg=key)


def test_refine_sq_trainer_cli_on_cpu(tmp_path):
    """``python -m sqtpu_torch.train --model refine_sq --init-base ...
    --freeze-base true`` at a toy size: the base stays the c4 weights to
    the bit, its BatchNorm statistics move, and the checkpoint evaluates
    as a refine_sq model."""
    from sqtpu_torch.evaluate import load_eval_state
    from sqtpu_torch.utils.config import EvalConfig

    ckpt = tmp_path / "c4r1"
    state, hist = train_entry.main([
        "--device", "cpu", "--model", "refine_sq", "--loss", "explicit_sym",
        "--render-size", "16", "--explicit-sharp", "20.0",
        "--gauge-weight", "2.0", "--elong-weight", "1.5", "--shape-weight",
        "4.0", "--freeze-base", "true", "--init-base", C4, "--data",
        "online", "--image-size", "64", "--batch-size", "4", "--remat",
        "true", "--learning-rate", "1e-4", "--max-epochs", "2",
        "--steps-per-epoch", "2", "--val-steps", "1", "--acc-render-size",
        "16", "--compare-images", "0", "--nan-policy", "skip",
        "--ckpt-dir", str(ckpt)])
    assert len(hist["loss"]) == 2 and np.isfinite(hist["val_loss"]).all()
    base = load_weights_npz(C4, ResNetSQ()).state_dict()
    got = state.model.base.state_dict()
    for name, _ in state.model.base.named_parameters():
        assert torch.equal(got[name].cpu(), base[name]), name
    assert not torch.equal(got["encoder.bn1.running_mean"].cpu(),
                           base["encoder.bn1.running_mean"])
    model = load_eval_state(EvalConfig(ckpt_dir=str(ckpt), device="cpu"),
                            torch.device("cpu"))
    assert isinstance(model, IterativeSQ)


def test_refiner_block_shapes():
    block = trefiner.RefineBlock()
    assert block.encoder.conv1.weight.shape == (64, 2, 7, 7)
    assert block.fc1.in_features == 512 + 12
    assert torch.count_nonzero(block.delta.weight) == 0
