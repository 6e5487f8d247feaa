"""The port's trainer on the CPU: one train step against the JAX package's,
the optimizer, ``nan_policy=skip``, the plateau scheduler, the training
config and its CLI, the resident dataset, and ``train(cfg)`` end to end
with a resume.

One train step from the same weights (``resnet_sq_ssl_fp16.npz``) on the
same batch (B=4, 64² images, render size 16) against
``sqtpu.training.loop.make_train_step`` with ``use_pallas=False``: loss
relative 1e-5; the gradients before Adam, per parameter tensor, within
2e-3 of that tensor's largest gradient (fp32 convolutions and their
backward sum in another order in torch and XLA; the measured gap is
1.1e-4 of the scale); the BatchNorm statistics rtol 1e-5. The optimizer
applied to the same gradients agrees with optax to 1e-6.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sqtpu.models import build_model as flax_build_model
from sqtpu.models import params_vector as flax_params_vector
from sqtpu.ops import losses as jlosses
from sqtpu.training import lr as jlr
from sqtpu.training.loop import make_train_step as jax_make_train_step
from sqtpu.training.state import create_train_state as jax_create_state
from sqtpu.training.state import make_optimizer as jax_make_optimizer
from sqtpu.utils import config as jconfig
from sqtpu.utils.checkpoint import load_weights_npz as flax_load_weights
from sqtpu_torch.evaluate import load_eval_state
from sqtpu_torch.models import ResNetSQ, params_vector
from sqtpu_torch.ops.kernels import launch_counts, reset_launches
from sqtpu_torch.training import lr as tlr
from sqtpu_torch.training.loop import (
    SyntheticResident, make_eval_step, make_train_step, train,
)
from sqtpu_torch.training.state import (
    TrainState, clip_by_global_norm, create_train_state, get_lr,
    make_optimizer, set_lr,
)
from sqtpu_torch.utils import config as tconfig
from sqtpu_torch.utils.checkpoint import (
    flax_from_state_dict, load_config, load_weights_npz,
)
from sqtpu_torch.utils.config import EvalConfig, TrainConfig
from sqtpu_torch.utils.logging import MetricLogger, NanGuard

from test_torch_port_ops import _few_torch_threads  # noqa: F401
from test_torch_port_weights import SSL, _flat_stats, _images

SMALL = dict(batch_size=4, image_size=64, render_size=16,
             acc_render_size=16, device="cpu")


# ---- one train step against the JAX package's --------------------------------

@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's train step from the ssl weights, its gradients
    before Adam, and the batch."""
    cfg = jconfig.TrainConfig(batch_size=4, image_size=64, render_size=16,
                              use_pallas=False, donate=False)
    model = flax_build_model("resnet_sq")
    state = jax_create_state(model, jax.random.PRNGKey(0), cfg)
    v = flax_load_weights(SSL, {"params": state.params,
                                "batch_stats": state.batch_stats})
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    imgs = _images(90, 4, 64)[..., None]
    labels = np.zeros((4, 12), np.float32)
    new_state, loss = jax_make_train_step(model, cfg)(
        state, jnp.asarray(imgs), jnp.asarray(labels))

    def loss_fn(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": state.batch_stats},
                             jnp.asarray(imgs), train=True,
                             mutable=["batch_stats"])
        return jlosses.implicit_loss(jnp.asarray(imgs[..., 0]),
                                     flax_params_vector(out), 16)

    grads = jax.jit(jax.grad(loss_fn))(state.params)
    return {"loss": float(loss), "grads": _flat_stats({"params": grads}),
            "stats": _flat_stats({"batch_stats": new_state.batch_stats}),
            "imgs": imgs, "labels": labels}


def _port_state(cfg: TrainConfig) -> TrainState:
    return create_train_state(load_weights_npz(SSL, ResNetSQ()), cfg)


def test_train_step_matches_jax(jax_step):
    cfg = TrainConfig(**SMALL)
    state = _port_state(cfg)
    loss = make_train_step(state, cfg)(torch.from_numpy(jax_step["imgs"]),
                                       torch.from_numpy(jax_step["labels"]))
    assert loss.item() == pytest.approx(jax_step["loss"], rel=1e-5)
    grads = flax_from_state_dict(
        {n: p.grad for n, p in state.model.named_parameters()})
    assert set(grads) == set(jax_step["grads"])
    for key, want in jax_step["grads"].items():
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(grads[key], want, rtol=0,
                                   atol=2e-3 * scale, err_msg=key)
    stats = flax_from_state_dict(state.model.state_dict())
    for key, want in jax_step["stats"].items():
        np.testing.assert_allclose(stats[key], want, rtol=1e-5, atol=1e-8,
                                   err_msg=key)


@pytest.mark.parametrize("weight_decay,clip", [(0.0, 0.0), (1e-2, 0.0),
                                               (0.0, 0.5), (0.0, 1e3),
                                               (1e-2, 0.5)])
def test_optimizer_matches_optax(weight_decay, clip):
    """Three updates from the same gradients: torch Adam/AdamW and the
    global-norm clip against optax (make_optimizer of the JAX package)."""
    rng = np.random.default_rng(91)
    params = [rng.normal(size=s).astype(np.float32)
              for s in ((3, 4), (5,), (2, 2, 2))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params]
             for _ in range(3)]
    tx = jax_make_optimizer(1e-3, weight_decay, clip)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    state = TrainState(model=None, optimizer=make_optimizer(
        tp, 1e-3, weight_decay), grad_clip=clip)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        if clip:
            clip_by_global_norm([p.grad for p in tp], clip)
        state.optimizer.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)


def test_clip_follows_optax_rule():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == 5.0
    torch.testing.assert_close(g[0], torch.tensor([0.6, 0.8]))
    small = [torch.tensor([0.3, 0.4])]
    clip_by_global_norm(small, 1.0)
    assert torch.equal(small[0], torch.tensor([0.3, 0.4]))


def test_get_and_set_lr():
    state = _port_state(TrainConfig(**SMALL))
    assert get_lr(state) == pytest.approx(1e-4)
    set_lr(state, 3e-5)
    assert get_lr(state) == pytest.approx(3e-5)
    assert all(g["lr"] == 3e-5 for g in state.optimizer.param_groups)


def test_nan_skip_discards_the_whole_update():
    cfg = TrainConfig(nan_policy="skip", **SMALL)
    state = _port_state(cfg)
    step = make_train_step(state, cfg)
    imgs = torch.from_numpy(_images(92, 4, 64))[..., None]
    labels = torch.zeros(4, 12)
    assert torch.isfinite(step(imgs, labels))  # moments exist now
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = {(i, k): v.clone()
               for i, s in enumerate(state.optimizer.state.values())
               for k, v in s.items()}
    bad = imgs.clone()
    bad[0, 5, 5, 0] = float("nan")
    assert not torch.isfinite(step(bad, labels))
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for (i, k), v in moments.items():
        now = list(state.optimizer.state.values())[i][k]
        assert torch.equal(now, v), (i, k)
    # a finite step afterwards moves the weights again
    step(imgs, labels)
    assert not torch.equal(state.model.fc1.weight, before["fc1.weight"])


def test_eval_step_reports_loss_iou_and_angle():
    cfg = TrainConfig(**SMALL)
    state = _port_state(cfg)
    labels = torch.from_numpy(np.load(os.path.join(
        os.path.dirname(SSL), "..", "runs", "eval_c4c3",
        "accs.npz"))["true_params"][:4].astype(np.float32))
    from sqtpu_torch.ops.render import render_depth_hard_batch
    imgs = render_depth_hard_batch(labels, 256, n_bisect=12, quantize=True,
                                   n_sweep=48)[..., None]
    loss, acc, ang, pred = make_eval_step(state, cfg)(imgs, labels)
    assert pred.shape == (4, 12) and not state.model.training
    assert 0 < float(loss) < 0.05 and 0.5 < float(acc) <= 1.0
    assert 0 <= float(ang) < 3.2


# ---- scheduler, config, logging ---------------------------------------------

def test_plateau_scheduler_matches_jax():
    seq = [1.0, 0.9, 0.95, 0.95, 0.95, 0.8, 0.81, 0.8, 0.8, 0.8, 0.7,
           float("nan"), 0.7, 0.7, 0.7]
    a = jlr.ReduceLROnPlateau(1e-3, patience=2, factor=0.5)
    b = tlr.ReduceLROnPlateau(1e-3, patience=2, factor=0.5)
    assert [a.step(v) for v in seq] == [b.step(v) for v in seq]
    c = tlr.ReduceLROnPlateau(1.0)
    c.load_state_dict(b.state_dict())
    assert (c.lr, c.best, c.bad_epochs) == (b.lr, b.best, b.bad_epochs)
    assert [tlr.step_schedule_2019(e) for e in (0, 249, 250, 499, 500)] == \
        [jlr.step_schedule_2019(e) for e in (0, 249, 250, 499, 500)]


def test_train_config_has_the_jax_fields_and_flags():
    jfields = {f.name: f.default for f in dataclasses.fields(
        jconfig.TrainConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert set(tfields) == set(jfields) | {"device"}
    assert {k: tfields[k] for k in jfields} == jfields
    argv = ["--batch-size", "512", "--nan-policy", "skip", "--data",
            "online", "--sigmoid-sharpness", "260.0", "--shuffle", "false",
            "--continue-training", "--learning-rate", "3e-4"]
    j = jconfig.parse_cli(jconfig.TrainConfig, argv)
    t = tconfig.parse_cli(TrainConfig, argv + ["--device", "cpu"])
    assert {k: getattr(t, k) for k in jfields} == dataclasses.asdict(j)
    assert t.device == "cpu"


def test_options_outside_the_slice_raise(tmp_path):
    """``classical`` is an evaluation mode, not a model to train: the JAX
    package's KeyError (``sqtpu.models.build_model``'s registry lookup).
    Every other option of the JAX package's TrainConfig runs since Slice
    F (:func:`test_options_of_slice_f_run`)."""
    cfg = TrainConfig(ckpt_dir=str(tmp_path), model="classical", **SMALL)
    with pytest.raises(KeyError, match="classical"):
        train(cfg)


@pytest.fixture(scope="module")
def encoder_npz(tmp_path_factory):
    """c4's encoder in torchvision's layout."""
    from sqtpu_torch.models import export_torchvision_resnet18

    path = str(tmp_path_factory.mktemp("enc") / "encoder.npz")
    np.savez(path, **export_torchvision_resnet18(load_weights_npz(
        os.path.join(os.path.dirname(SSL), "resnet_sq_c4_fp16.npz"),
        ResNetSQ())))
    return path


@pytest.mark.parametrize("option", [
    {"loss": "keras_chamfer"}, {"pretrained": "encoder"},
    {"model": "resnet_sq6d"}, {"dtype": "bfloat16"},
    {"profile_dir": "prof"}, {"iso": True}])
def test_options_of_slice_f_run(option, encoder_npz, tmp_path):
    """Options the slice gate refused until Slice F: one epoch of one step
    on the CPU each."""
    if "pretrained" in option:
        option = {"pretrained": encoder_npz}
    if "profile_dir" in option:
        option = {"profile_dir": str(tmp_path / "prof")}
    cfg = TrainConfig(max_epochs=1, steps_per_epoch=1, val_steps=1,
                      compare_images=0, ckpt_dir=str(tmp_path),
                      **{**SMALL, "loss": "supervised", **option})
    state, hist = train(cfg)
    assert np.isfinite(hist["loss"][0]) and np.isfinite(hist["val_loss"][0])
    if "profile_dir" in option:
        assert any(f.endswith(".pt.trace.json")
                   for f in os.listdir(option["profile_dir"]))
    if "dtype" in option:
        assert state.model.encoder.conv1.compute_dtype == torch.bfloat16


@pytest.fixture(scope="module")
def bmp_dir(tmp_path_factory):
    """Six 64² depth maps and their label CSV, rendered on the CPU."""
    from sqtpu_torch.generate import generate
    from sqtpu_torch.utils.config import GenerateConfig

    d = str(tmp_path_factory.mktemp("bmps") / "rot")
    generate(GenerateConfig(n=6, out=d, batch_size=6, image_size=64,
                            device="cpu"))
    return d


@pytest.mark.parametrize("option", [
    {"augment_gaussian": 0.01}, {"augment_dropout": 0.1},
    {"augment_salt": 0.01}, {"augment_randomize": True}, {"data": "dir"}])
def test_options_of_slice_c_run(option, bmp_dir, tmp_path):
    """Options the slice gate refused until Slice C (the sensor-noise
    augmentation and directory data): one step on the CPU each."""
    if "data" in option:
        option = {"data": bmp_dir, "labels_csv": os.path.join(
            bmp_dir, "data_labels.csv"), "train_split": 0.75}
    cfg = TrainConfig(max_epochs=1, steps_per_epoch=1, val_steps=1,
                      compare_images=0, ckpt_dir=str(tmp_path),
                      **{**SMALL, "loss": "supervised", **option})
    _, hist = train(cfg)
    assert np.isfinite(hist["loss"][0]) and np.isfinite(hist["val_loss"][0])


@pytest.mark.parametrize("option", [
    {"loss": "explicit"}, {"loss": "supervised_sym"}, {"remat": True}])
def test_options_of_the_supervised_slice_run(option, tmp_path):
    """Options the slice gate refused until the supervised slice: one
    step on the CPU each."""
    cfg = TrainConfig(max_epochs=1, steps_per_epoch=1, val_steps=1,
                      compare_images=0, ckpt_dir=str(tmp_path),
                      **{**SMALL, **option})
    _, hist = train(cfg)
    assert np.isfinite(hist["loss"][0]) and np.isfinite(hist["val_loss"][0])


def test_nan_guard_and_metric_logger(tmp_path, capsys):
    guard = NanGuard("skip")
    assert guard.check(0.5) and not guard.check(float("nan"))
    assert guard.count == 1 and "NON-FINITE" in capsys.readouterr().out
    with pytest.raises(ValueError):
        NanGuard("ignore")
    log = MetricLogger(str(tmp_path), "run")
    rec = log.log(epoch=1, loss=torch.tensor(0.25), lr=np.float32(1e-4))
    assert rec["loss"] == 0.25 and isinstance(rec["lr"], float)
    line = json.loads((tmp_path / "run_metrics.jsonl").read_text())
    assert line["epoch"] == 1


# ---- data and the whole loop --------------------------------------------------

def test_synthetic_resident(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = TrainConfig(ckpt_dir="ck", data_cache=True, **SMALL)
    data = SyntheticResident(cfg, 100, seed=3, device=torch.device("cpu"),
                             chunk=16)
    assert data.size == 112 and (data.n_train, data.n_val) == (100, 12)
    assert data.images.dtype == torch.uint8 and data.images.shape == (
        112, 64, 64)
    gen = torch.Generator()
    gen.manual_seed(0)
    imgs, labels = data.train_batch(gen)
    assert imgs.shape == (4, 64, 64, 1) and labels.shape == (4, 12)
    assert float(imgs.max()) <= 1.0 and float(imgs.max()) > 0.3
    cached = SyntheticResident(cfg, 100, seed=3, device=torch.device("cpu"),
                               chunk=16)
    assert torch.equal(cached.images, data.images)
    assert len(os.listdir(tmp_path / "data_cache")) == 1
    with pytest.raises(ValueError, match="no validation"):
        SyntheticResident(dataclasses.replace(cfg, train_split=1.0,
                                              data_cache=False), 16, 3,
                          torch.device("cpu"), chunk=16)


def test_train_on_cpu_and_resume(tmp_path):
    ckpt = tmp_path / "run"
    cfg = TrainConfig(max_epochs=2, steps_per_epoch=2, val_steps=1,
                      log_interval=1, ckpt_dir=str(ckpt), save_last_interval=5,
                      **SMALL)
    reset_launches()
    state, hist = train(cfg)
    assert not any(launch_counts().values())  # the CPU: plain loss
    assert {k: len(v) for k, v in hist.items()} == {
        "loss": 2, "val_loss": 2, "val_acc": 2, "val_angle_sym": 2}
    assert all(np.isfinite(hist["loss"]))
    for name in ("best.pt", "best.meta.json", "last.pt", "last.meta.json",
                 "train_metrics.jsonl"):
        assert (ckpt / name).exists(), name
    assert sorted(os.listdir(ckpt / "compare")) == sorted(
        f"{i}_{k}.bmp" for i in range(4) for k in ("pred", "true"))
    meta = json.loads((ckpt / "last.meta.json").read_text())
    assert meta["epoch"] == 1 and meta["config"]["batch_size"] == 4
    assert load_config(str(ckpt / "last"), TrainConfig) == cfg

    resumed = dataclasses.replace(cfg, max_epochs=3, continue_training=True,
                                  resume_from="last")
    state2, hist2 = train(resumed)
    assert {k: len(v) for k, v in hist2.items()} == {
        "loss": 3, "val_loss": 3, "val_acc": 3, "val_angle_sym": 3}
    assert hist2["loss"][:2] == hist["loss"]
    epochs = [json.loads(line)["epoch"] for line in
              (ckpt / "train_metrics.jsonl").read_text().splitlines()]
    assert epochs == [0, 1, 2]
    assert json.loads((ckpt / "last.meta.json").read_text())["epoch"] == 2
    # evaluation loads the run's best checkpoint
    model = load_eval_state(EvalConfig(ckpt_dir=str(ckpt), device="cpu"),
                            torch.device("cpu"))
    assert not model.training


def test_train_online_data(tmp_path):
    cfg = TrainConfig(data="online", max_epochs=1, steps_per_epoch=1,
                      val_steps=1, compare_images=0, ckpt_dir=str(tmp_path),
                      use_pallas=False, **SMALL)
    state, hist = train(cfg)
    assert np.isfinite(hist["loss"][0]) and np.isfinite(hist["val_loss"][0])
    assert not (tmp_path / "compare").exists()


def test_cpu_layout_gap_is_pinned():
    """On the CPU a (B, H, W, 1) batch's memory layout picks the
    convolution kernels: a contiguous batch (as from numpy) runs
    channels-last, the renderer's transposed tensor runs NCHW. Each
    layout's first-stage gradient (``encoder.conv1``) of one c4c-recipe
    step (c4 weights, B=4, 64², remat) against an fp64 run, relative to
    the fp64 gradient's largest entry, sits in its band: measured
    1.83e-5 channels-last and 4.24e-6 NCHW with torch 2.13 on two
    threads. A change in torch's CPU convolutions moves them out."""
    import copy

    from sqtpu_torch.ops import render as trender
    from sqtpu_torch.training.loop import _compute_loss

    with np.load(os.path.join(os.path.dirname(SSL), "..", "runs",
                              "eval_c4c3", "accs.npz")) as d:
        labels = torch.from_numpy(d["true_params"][:4].astype(np.float32))
    rendered = trender.render_depth_hard_batch(labels, 64, n_bisect=12,
                                               quantize=True, n_sweep=48)
    nchw = rendered[..., None]
    nhwc = torch.from_numpy(np.ascontiguousarray(rendered.numpy()))[..., None]
    assert nhwc.permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)
    assert not nchw.permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)  # (H, W) transposed in memory
    cfg = TrainConfig(loss="explicit_sym", explicit_sharp=20.0,
                      gauge_weight=2.0, elong_weight=1.5, remat=True,
                      **SMALL)
    base = load_weights_npz(os.path.join(os.path.dirname(SSL),
                                         "resnet_sq_c4_fp16.npz"), ResNetSQ())

    def first_stage_grad(x, dtype):
        model = copy.deepcopy(base).to(dtype).train()
        pred = params_vector(model(x.to(dtype), remat=True))
        _compute_loss(cfg, pred, x.to(dtype), labels.to(dtype)).backward()
        return model.encoder.conv1.weight.grad.double()

    ref = first_stage_grad(nhwc, torch.float64)
    gaps = {}
    for name, x in (("channels_last", nhwc), ("nchw", nchw)):
        g = first_stage_grad(x, torch.float32)
        gaps[name] = float((g - ref).abs().max() / ref.abs().max())
    assert 5e-6 <= gaps["channels_last"] <= 1e-4, gaps
    assert 1e-6 <= gaps["nchw"] <= 1.5e-5, gaps
    assert gaps["channels_last"] > 2 * gaps["nchw"], gaps
