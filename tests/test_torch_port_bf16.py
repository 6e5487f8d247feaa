"""bfloat16 training (flax's ``dtype``), the 6D rotation head's train
steps and ``profile_dir``, on the CPU against the JAX package.

flax's ``ResNetSQ(dtype=bfloat16)`` keeps float32 parameters, computes
every convolution and dense layer of the encoder and of fc1/fc2 in
bfloat16, reduces and normalizes BatchNorm in float32 and casts back, and
promotes the heads' input to float32. The structure is checked with
forward hooks. The numbers: XLA's and torch's bf16 convolutions round
differently, so the port's bf16 forward is held to the JAX package's
bf16 forward at atol 1.5e-2 on the ssl artifact at 64² (measured 5.7e-3
eval, 4.7e-3 train), and its bf16-vs-fp32 gap to within a factor 4 of
the JAX package's own (measured 6.5e-3 against 6.1e-3 eval, 4.7e-3
against 2.7e-3 train), never 0. One bf16 train step against the JAX
package's from the same weights and batch: loss relative 1e-2 (measured
2.1e-3).

The 6D head's train steps (stage A ``supervised_sym``, stage B
``implicit_sym``) are held like ``test_torch_port_keras_train.py``'s:
the port's float32 step against the JAX package's float64 step.
"""

import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.models import ResNetSQ as FlaxResNetSQ
from sqtpu.models import params_vector as flax_params_vector
from sqtpu.ops import losses as jlosses
from sqtpu.ops import render as jrender
from sqtpu.training import loop as jloop
from sqtpu.utils import config as jconfig
from sqtpu.utils.checkpoint import load_weights_npz as flax_load_weights
from sqtpu_torch.models import ResNetSQ, params_vector
from sqtpu_torch.models.resnet import BatchNorm, Conv2d, Linear
from sqtpu_torch.ops import losses as tlosses
from sqtpu_torch.training import loop as tloop
from sqtpu_torch.training.loop import train
from sqtpu_torch.training.state import create_train_state
from sqtpu_torch.utils.checkpoint import load_weights_npz
from sqtpu_torch.utils.config import MODEL_DTYPES, TrainConfig

from test_torch_port_keras_train import step_vs_jax
from test_torch_port_ops import _few_torch_threads  # noqa: F401
from test_torch_port_weights import SSL, _images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUTHS = os.path.join(ROOT, "runs", "eval_c4c3", "accs.npz")
BF16_ATOL, GAP_RATIO = 1.5e-2, 4.0
STEP_LOSS_RTOL = 1e-2


def _flax(dtype):
    model = FlaxResNetSQ(dtype=dtype)
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 1), jnp.float32))
    return model, flax_load_weights(SSL, {
        "params": template["params"],
        "batch_stats": template["batch_stats"]})


def _port(dtype):
    return load_weights_npz(SSL, ResNetSQ(dtype=dtype))


@pytest.fixture(scope="module")
def forwards():
    """Eval- and train-mode predictions of both packages, fp32 and bf16."""
    imgs = _images(80, 4, 64)[..., None]
    out = {}
    for jdt, tdt, key in ((None, None, "fp32"),
                          (jnp.bfloat16, torch.bfloat16, "bf16")):
        model, v = _flax(jdt)
        port = _port(tdt)
        for train_mode in (False, True):
            if train_mode:
                o, _ = model.apply(v, jnp.asarray(imgs), train=True,
                                   mutable=["batch_stats"])
            else:
                o = model.apply(v, jnp.asarray(imgs), train=False)
            assert all(x.dtype == jnp.float32 for x in o)
            with torch.no_grad():
                t = params_vector(port.train(train_mode)(
                    torch.from_numpy(imgs)))
            assert t.dtype == torch.float32
            out["jax", key, train_mode] = np.asarray(flax_params_vector(o),
                                                     np.float64)
            out["port", key, train_mode] = t.double().numpy()
    return out


@pytest.mark.parametrize("train_mode", [False, True])
def test_bf16_forward_matches_jax_bf16(forwards, train_mode):
    got = forwards["port", "bf16", train_mode]
    np.testing.assert_allclose(got, forwards["jax", "bf16", train_mode],
                               rtol=0, atol=BF16_ATOL)
    np.testing.assert_allclose(forwards["port", "fp32", train_mode],
                               forwards["jax", "fp32", train_mode],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("train_mode", [False, True])
def test_bf16_gap_is_the_jax_packages(forwards, train_mode):
    """bf16 against fp32 in each package: the same order, never 0 (a 0
    gap would be a float32 path in disguise)."""
    port = np.abs(forwards["port", "bf16", train_mode]
                  - forwards["port", "fp32", train_mode]).max()
    jax_gap = np.abs(forwards["jax", "bf16", train_mode]
                     - forwards["jax", "fp32", train_mode]).max()
    assert port > 0 and jax_gap > 0
    assert 1 / GAP_RATIO <= port / jax_gap <= GAP_RATIO


def test_bf16_structure():
    """Forward hooks on a bf16 train step: the encoder's and fc1/fc2's
    convolutions and dense layers compute in bf16 (every input but the
    image's, every output), BatchNorm returns bf16 and keeps float32
    statistics, the heads take and give float32, and the parameters and
    their gradients stay float32."""
    model = _port(torch.bfloat16).train()
    seen = {}

    def hook(name):
        def record(module, inputs, output):
            seen[name] = (inputs[0].dtype, output.dtype)
        return record

    for name, m in model.named_modules():
        if isinstance(m, (Conv2d, Linear, BatchNorm, torch.nn.Linear)):
            m.register_forward_hook(hook(name))
    out = params_vector(model(torch.from_numpy(_images(81, 2, 64))))
    out.sum().backward()
    assert out.dtype == torch.float32
    convs = [n for n, m in model.named_modules() if isinstance(m, Conv2d)]
    assert len(convs) == 20
    for name in convs + ["fc1", "fc2"]:
        want_in = torch.float32 if name == "encoder.conv1" else torch.bfloat16
        assert seen[name] == (want_in, torch.bfloat16), name
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            assert seen[name] == (torch.bfloat16, torch.bfloat16), name
            assert m.running_mean.dtype == m.running_var.dtype \
                == torch.float32
        if name.startswith("head_") and name.endswith("Dense_0"):
            assert seen[name] == (torch.float32, torch.float32), name
    for n, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, n


def test_bf16_train_step_matches_jax():
    """One ssl step in bf16 from the ssl weights, B=4, 64² images, render
    size 16, ``use_pallas=False``: the loss within 1e-2 relative of the
    JAX package's bf16 step (measured 2.1e-3; bf16 rounds differently in
    the two packages' convolutions), both off their fp32 losses."""
    imgs = _images(90, 4, 64)[..., None]
    labels = np.zeros((4, 12), np.float32)
    losses = {}
    for dtype in ("float32", "bfloat16"):
        kw = dict(batch_size=4, image_size=64, render_size=16,
                  use_pallas=False, dtype=dtype)
        jcfg = jconfig.TrainConfig(**kw, donate=False)
        model, v = _flax(jnp.bfloat16 if dtype == "bfloat16" else None)
        state = jloop.create_train_state(model, jax.random.PRNGKey(0), jcfg)
        state = state.replace(params=v["params"],
                              batch_stats=v["batch_stats"])
        _, jloss = jloop.make_train_step(model, jcfg)(
            state, jnp.asarray(imgs), jnp.asarray(labels))
        cfg = TrainConfig(**kw, device="cpu")
        tstate = create_train_state(_port(MODEL_DTYPES[dtype]), cfg)
        tloss = tloop.make_train_step(tstate, cfg)(torch.from_numpy(imgs),
                                                   torch.from_numpy(labels))
        losses[dtype] = float(jloss), float(tloss)
    (j32, t32), (j16, t16) = losses["float32"], losses["bfloat16"]
    assert t32 == pytest.approx(j32, rel=1e-5)
    assert t16 == pytest.approx(j16, rel=STEP_LOSS_RTOL)
    assert t16 != t32 and j16 != j32


def test_pinned_bf16_validation_number():
    """The constant chip_smoke.py holds the card's bf16 validation loss
    to is the JAX package's bf16 number on the CPU (`python
    tests/torch_port_pins.py bf16`), and the port's bf16 pipeline on the
    CPU lies within the card's bound of it (measured 1.24e-2)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    with np.load(TRUTHS) as d:
        truths = d["true_params"][:chip_smoke.PINNED_N].astype(np.float32)
    imgs = jrender.render_depth_hard_batch(jnp.asarray(truths), 256,
                                          n_bisect=12, quantize=True,
                                          n_sweep=48)
    model, v = _flax(jnp.bfloat16)
    pred = flax_params_vector(model.apply(v, imgs[..., None], train=False))
    jax_loss = float(jlosses.implicit_loss(imgs, pred, 64, 1.5, 260.0))
    assert jax_loss == pytest.approx(chip_smoke.PINNED_BF16_VAL_LOSS,
                                     rel=1e-6)
    port = _port(torch.bfloat16).eval()
    timgs = torch.tensor(np.asarray(imgs))
    with torch.no_grad():
        got = float(tlosses.implicit_loss(
            timgs, params_vector(port(timgs[..., None])), 64, 1.5, 260.0))
    assert got == pytest.approx(jax_loss, rel=chip_smoke.PINNED_BF16_RTOL)
    assert abs(got / chip_smoke.PINNED_VAL_LOSS - 1) >= \
        chip_smoke.BF16_MIN_GAP


R6D_STAGES = [("supervised_sym", dict(learning_rate=3e-4)),
              ("implicit_sym", dict(render_size=16))]


@pytest.mark.parametrize("loss,kw", R6D_STAGES,
                         ids=[s[0] for s in R6D_STAGES])
def test_resnet_sq6d_train_step_matches_jax(loss, kw):
    from sqtpu_torch.data import synthetic as tsyn

    imgs, labels = tsyn.make_batch(torch.Generator().manual_seed(14), 4, 64)
    step_vs_jax("resnet_sq6d", imgs.numpy(), labels.numpy(), 15, loss=loss,
                **kw)


def test_profile_dir_writes_a_trace(tmp_path):
    """``profile_dir``: one Chrome/TensorBoard trace of the run, with the
    train step's operators in it."""
    prof = tmp_path / "prof"
    cfg = TrainConfig(batch_size=2, image_size=32, render_size=8,
                      acc_render_size=8, max_epochs=1, steps_per_epoch=1,
                      val_steps=1, compare_images=0, loss="supervised",
                      ckpt_dir=str(tmp_path / "run"), profile_dir=str(prof),
                      device="cpu")
    train(cfg)
    traces = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("conv" in n for n in names)
    assert any("Optimizer.step" in n or "adam" in n.lower() for n in names)


def test_profile_dir_writes_a_trace_when_the_run_raises(tmp_path,
                                                        monkeypatch):
    """A run that raises inside the epochs still writes its trace: the
    failing run is often the one to look at."""
    prof = tmp_path / "prof"
    cfg = TrainConfig(batch_size=2, image_size=32, render_size=8,
                      acc_render_size=8, max_epochs=2, steps_per_epoch=1,
                      val_steps=1, compare_images=0, loss="supervised",
                      ckpt_dir=str(tmp_path / "run"), profile_dir=str(prof),
                      device="cpu")
    make_step = tloop.make_train_step

    def failing_second_step(state, cfg, layout=None):
        step, calls = make_step(state, cfg, layout), []

        def run(imgs, labels):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("step failed")
            return step(imgs, labels)
        return run

    monkeypatch.setattr(tloop, "make_train_step", failing_second_step)
    with pytest.raises(RuntimeError, match="step failed"):
        train(cfg)
    assert len(glob.glob(str(prof / "*.pt.trace.json"))) == 1


def test_step_timer_on_the_cpu():
    """``StepTimer`` records one wall-clock time per step, its median the
    middle one."""
    from sqtpu_torch.utils.profiling import StepTimer

    t = StepTimer("cpu")
    dts = []
    for _ in range(3):
        t.start()
        dts.append(t.stop())
    assert t.times == dts and all(dt >= 0 for dt in dts)
    assert t.median == sorted(dts)[1]
    assert StepTimer().median == 0.0
