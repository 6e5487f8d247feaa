"""The supervised ``explicit_sym`` recipe of the port on the CPU: one train
step against the JAX package's, with and without ``remat``; ``remat``
against no ``remat``; the trainer's CLI end to end with a resume; and the
validation number ``chip_smoke.py`` pins for the card.

The step starts from the c4 artifact (``resnet_sq_c4_fp16.npz``, which the
c4c recipe trained) with the recipe's loss weights (runs/queue_r12.sh:44-53:
sharpness 20, gauge weight 2, elongation weight 1.5) at a small size (B=4,
64² images, render size 16), on the first recorded truths of
``runs/eval_c4c3`` rendered by the port's plain renderer. Tolerances are
those of tests/test_torch_port_train.py::test_train_step_matches_jax: loss
relative 1e-5; each parameter tensor's gradient before Adam within 2e-3 of
that tensor's largest gradient (fp32 convolutions summed in another
order); BatchNorm statistics rtol 1e-5. With ``remat`` the port recomputes
the encoder in the backward: loss, gradients and statistics are the same
as without it (rtol 1e-6; the statistics move once per step).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.models import build_model as flax_build_model
from sqtpu.models import params_vector as flax_params_vector
from sqtpu.ops import render as jrender
from sqtpu.training import loop as jloop
from sqtpu.training.state import create_train_state as jax_create_state
from sqtpu.utils import config as jconfig
from sqtpu.utils.checkpoint import load_weights_npz as flax_load_weights
from sqtpu_torch import train as train_entry
from sqtpu_torch.models import ResNetSQ, params_vector
from sqtpu_torch.ops import render as trender
from sqtpu_torch.training import loop as tloop
from sqtpu_torch.training.state import create_train_state
from sqtpu_torch.utils.checkpoint import flax_from_state_dict, load_weights_npz
from sqtpu_torch.utils.config import TrainConfig

from test_torch_port_ops import _few_torch_threads  # noqa: F401
from test_torch_port_weights import ROOT, TRUTHS, _flat_stats, _flax_template

C4 = os.path.join(ROOT, "artifacts", "resnet_sq_c4_fp16.npz")
SMALL = dict(batch_size=4, image_size=64, render_size=16, acc_render_size=16)
# the c4c recipe's loss and optimizer flags (runs/queue_r12.sh:44-53)
C4C = dict(loss="explicit_sym", explicit_sharp=20.0, gauge_weight=2.0,
           elong_weight=1.5, learning_rate=5e-6, nan_policy="skip")


@pytest.fixture(scope="module")
def batch():
    with np.load(TRUTHS) as d:
        labels = d["true_params"][:4].astype(np.float32)
    imgs = trender.render_depth_hard_batch(
        torch.from_numpy(labels), 64, n_bisect=12, quantize=True,
        n_sweep=48).numpy()[..., None]
    return imgs, labels


def _jax_step(imgs, labels, remat: bool) -> dict:
    cfg = jconfig.TrainConfig(**SMALL, **C4C, remat=remat, use_pallas=False,
                              donate=False)
    model = flax_build_model("resnet_sq")
    state = jax_create_state(model, jax.random.PRNGKey(0), cfg)
    v = flax_load_weights(C4, {"params": state.params,
                               "batch_stats": state.batch_stats})
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


def _port_step(imgs, labels, remat: bool):
    cfg = TrainConfig(**SMALL, **C4C, remat=remat, device="cpu")
    state = create_train_state(load_weights_npz(C4, ResNetSQ()), cfg)
    loss = tloop.make_train_step(state, cfg)(torch.from_numpy(imgs),
                                             torch.from_numpy(labels))
    return loss, state.model


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off",
                                                      "remat_on"])
def test_explicit_sym_step_matches_jax(batch, remat):
    imgs, labels = batch
    want = _jax_step(imgs, labels, remat)
    loss, model = _port_step(imgs, labels, remat)
    assert loss.item() == pytest.approx(want["loss"], rel=1e-5)
    grads = flax_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})
    assert set(grads) == set(want["grads"])
    for key, g in want["grads"].items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(grads[key], g, rtol=0, atol=2e-3 * scale,
                                   err_msg=key)
    stats = flax_from_state_dict(model.state_dict())
    for key, value in want["stats"].items():
        np.testing.assert_allclose(stats[key], value, rtol=1e-5, atol=1e-8,
                                   err_msg=key)


def test_remat_changes_nothing(batch):
    imgs, labels = batch
    start = load_weights_npz(C4, ResNetSQ()).state_dict()
    runs = {}
    for remat in (False, True):
        loss, model = _port_step(imgs, labels, remat)
        runs[remat] = (loss, {n: p.grad for n, p in model.named_parameters()},
                       dict(model.named_buffers()))
    (l0, g0, b0), (l1, g1, b1) = runs[False], runs[True]
    assert l1.item() == pytest.approx(l0.item(), rel=1e-6)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=0)
    moved = 0
    for name in b0:
        torch.testing.assert_close(b1[name], b0[name], rtol=1e-6, atol=0)
        moved += not torch.equal(b0[name], start[name])
    assert moved == 2 * 20  # the mean and variance of every BatchNorm


def test_explicit_sym_trainer_cli_on_cpu(tmp_path, capsys):
    """``python -m sqtpu_torch.train`` with the c4c recipe's flags at a toy
    size, warm-started from the c4 artifact: checkpoints, a resume, and
    validation's loss, IoU and angle."""
    ckpt = tmp_path / "c4c"
    flags = ["--device", "cpu", "--loss", "explicit_sym", "--render-size",
             "16", "--explicit-sharp", "20.0", "--gauge-weight", "2.0",
             "--elong-weight", "1.5", "--data", "online", "--image-size",
             "64", "--batch-size", "4", "--remat", "true",
             "--learning-rate", "5e-6", "--nan-policy", "skip",
             "--acc-render-size", "16", "--compare-images", "0",
             "--steps-per-epoch", "2", "--val-steps", "1",
             "--init-weights", C4, "--ckpt-dir", str(ckpt)]
    state, hist = train_entry.main(flags + ["--max-epochs", "2"])
    assert "warm-started all weights" in capsys.readouterr().out
    assert {k: len(v) for k, v in hist.items()} == {
        "loss": 2, "val_loss": 2, "val_acc": 2, "val_angle_sym": 2}
    assert all(np.isfinite(v) for k in hist for v in hist[k])
    assert all(0.0 <= v <= 1.0 for v in hist["val_acc"])
    assert all(0.0 <= v <= np.pi for v in hist["val_angle_sym"])
    assert min(hist["val_loss"]) > 0.0
    for name in ("best.pt", "last.pt", "train_metrics.jsonl"):
        assert (ckpt / name).exists(), name
    state, hist2 = train_entry.main(flags + [
        "--max-epochs", "3", "--continue-training", "--resume-from", "last"])
    assert hist2["loss"][:2] == hist["loss"] and len(hist2["loss"]) == 3
    meta = json.loads((ckpt / "last.meta.json").read_text())
    assert meta["epoch"] == 2 and meta["config"]["remat"] is True
    assert meta["config"]["loss"] == "explicit_sym"


def test_pinned_explicit_validation_number():
    """The constant chip_smoke.py holds the card to: the JAX package's
    ``explicit_sym`` validation loss (c4c weights, explicit loss at 128³,
    sharpness 20, full sweep) of the c4 artifact's eval-mode predictions on
    the first 16 recorded truths (JAX hard render at (48, 12), 256²),
    computed on the CPU.

    On the JAX package's images the port's model and plain loss give it
    within 1e-5. The port's whole CPU pipeline, its own hard render
    included, is held to the card's bound: the two renderers differ by one
    gray level on 8 of the 16·256² pixels, which moves this loss by
    2.8e-4."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    n = chip_smoke.PINNED_N
    with np.load(TRUTHS) as d:
        truths = d["true_params"][:n].astype(np.float32)
    model, template = _flax_template()
    variables = flax_load_weights(C4, template)
    jimgs = jrender.render_depth_hard_batch(jnp.asarray(truths), 256,
                                           n_bisect=12, quantize=True,
                                           n_sweep=48)[..., None]
    jpred = flax_params_vector(model.apply(variables, jimgs, train=False))
    kw = dict(chip_smoke.C4C_LOSS, batch_size=n)
    jax_loss = float(jloop._compute_loss(
        jconfig.TrainConfig(use_pallas=False, **kw), jpred, jimgs,
        jnp.asarray(truths)))
    assert jax_loss == pytest.approx(chip_smoke.PINNED_EXPLICIT_VAL_LOSS,
                                     rel=1e-6)

    port = load_weights_npz(C4, ResNetSQ()).eval()
    cfg = TrainConfig(device="cpu", **kw)

    def port_loss(images: torch.Tensor) -> float:
        with torch.no_grad():
            pred = params_vector(port(images))
            return float(tloop._compute_loss(cfg, pred, images,
                                             torch.from_numpy(truths)))

    assert port_loss(torch.tensor(np.asarray(jimgs))) == pytest.approx(
        jax_loss, rel=1e-5)
    timgs = trender.render_depth_hard_batch(torch.from_numpy(truths), 256,
                                            n_bisect=12, quantize=True,
                                            n_sweep=48)[..., None]
    assert port_loss(timgs) == pytest.approx(
        jax_loss, rel=chip_smoke.PINNED_EXPLICIT_RTOL)
    assert (cfg.render_size, cfg.explicit_sharp) == (128, 20.0)
