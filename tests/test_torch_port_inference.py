"""The port's inference surfaces and noisy pipelines against the JAX
package, on the CPU: ``predict_files`` (with and without the median
filter), ``eval_single``, the sensor-noise protocol of ``eval_random``,
the noisy and filtered pipeline on the same injected images, and the
trainer on a BMP directory and with noise augmentation.

Weights: the shipped c4 artifact (inference) and the ssl artifact (the
train step), loaded by each package's own loader. Tolerances are those of
``tests/test_torch_port_model.py`` and ``tests/test_torch_port_train.py``:
params atol 1e-3 through each package's pipeline (two fp32 convolution
stacks that sum in another order), atol 1e-4 on the same image, a train
step's loss relative 1e-5. The noise itself is the port's (a
``torch.Generator``), injected into both packages.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu import evaluate as jevaluate
from sqtpu import fit as jfit
from sqtpu import predict as jpredict
from sqtpu.data import datasets as jdatasets
from sqtpu.data import labels as jlabels
from sqtpu.models import build_model as flax_build_model
from sqtpu.training.loop import make_train_step as jax_make_train_step
from sqtpu.training.state import create_train_state as jax_create_state
from sqtpu.utils import config as jconfig
from sqtpu.utils.checkpoint import load_weights_npz as flax_load_weights
from sqtpu_torch import evaluate as tevaluate
from sqtpu_torch import predict as tpredict
from sqtpu_torch.data import bmp as tbmp
from sqtpu_torch.data.augment import depth_noise
from sqtpu_torch.fit import apply_prefilter
from sqtpu_torch.generate import generate
from sqtpu_torch.ops.render import render_depth_hard_batch
from sqtpu_torch.training.loop import train
from sqtpu_torch.utils.config import (
    EvalConfig, GenerateConfig, PredictConfig, TrainConfig,
)

from test_torch_port_ops import _few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "artifacts", "resnet_sq_c4_fp16.npz")
SSL = os.path.join(ROOT, "artifacts", "resnet_sq_ssl_fp16.npz")
TRUTHS = os.path.join(ROOT, "runs", "eval_c4c3", "accs.npz")
NOISE = dict(gaussian=0.02, dropout=0.2, salt=0.005)


def _truth_images(n: int = 4) -> np.ndarray:
    """(n, 256, 256) float32 depth maps of the first recorded truths."""
    with np.load(TRUTHS) as d:
        p = torch.from_numpy(d["true_params"][:n].astype(np.float32))
    return render_depth_hard_batch(p, 256, n_bisect=16, quantize=True,
                                   n_sweep=64).numpy()


@pytest.fixture(scope="module")
def noisy_bmps(tmp_path_factory):
    """Four BMPs of recorded truths with the noise protocol injected."""
    d = tmp_path_factory.mktemp("noisy")
    gen = torch.Generator()
    gen.manual_seed(3)
    imgs = depth_noise(gen, torch.from_numpy(_truth_images()), quantize=True,
                       **NOISE).numpy()
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(d / ("%06d.bmp" % i)))
        tbmp.write_bmp(paths[-1], np.rint(img * 255).astype(np.uint8))
    return paths


@pytest.mark.parametrize("input_filter", ["none", "median"])
def test_predict_files_matches_jax(noisy_bmps, input_filter, tmp_path):
    """Batches of 3 (the tail padded), noisy inputs, each package's
    predict_files; then the CSV of each package's write_csv."""
    kw = dict(inputs=os.path.dirname(noisy_bmps[0]), ckpt_dir=WEIGHTS,
              batch_size=3, input_filter=input_filter)
    want = jpredict.predict_files(jpredict.PredictConfig(**kw), noisy_bmps)
    got = tpredict.predict_files(PredictConfig(device="cpu", **kw),
                                 noisy_bmps)
    assert got.shape == (4, 12) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert tpredict.list_inputs(kw["inputs"]) == noisy_bmps
    for denorm in (True, False):
        tpredict.write_csv(str(tmp_path / "t.csv"), noisy_bmps, want, denorm)
        jpredict.write_csv(str(tmp_path / "j.csv"), noisy_bmps, want, denorm)
        assert (tmp_path / "t.csv").read_text() == \
            (tmp_path / "j.csv").read_text()


def test_predict_main_writes_the_csv(noisy_bmps, tmp_path):
    out = str(tmp_path / "p.csv")
    tpredict.main(["--inputs", os.path.dirname(noisy_bmps[0]), "--ckpt-dir",
                   WEIGHTS, "--batch-size", "4", "--out", out,
                   "--device", "cpu", "--platform", "cpu"])
    labels = jlabels.parse_csv_torch(out)
    assert labels.shape == (4, 12) and np.isfinite(labels).all()


def test_eval_single_matches_jax(noisy_bmps, capsys):
    for input_filter in ("none", "median"):
        kw = dict(ckpt_dir=WEIGHTS, input_filter=input_filter)
        want = jevaluate.eval_single(jconfig.EvalConfig(**kw), noisy_bmps[1])
        got = tevaluate.eval_single(EvalConfig(device="cpu", **kw),
                                    noisy_bmps[1])
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    tevaluate.main(["--ckpt-dir", WEIGHTS, "--device", "cpu", "single",
                    noisy_bmps[1]])
    assert "Predicted parameters:" in capsys.readouterr().out


def test_noisy_filtered_pipeline_matches_jax():
    """The same noisy images through each package's filter and model."""
    gen = torch.Generator()
    gen.manual_seed(4)
    noisy = depth_noise(gen, torch.from_numpy(_truth_images(3)),
                        quantize=True, **NOISE)
    jcfg = jconfig.EvalConfig(ckpt_dir=WEIGHTS)
    model, state = jevaluate.load_eval_state(jcfg)
    tmodel = tevaluate.load_eval_state(EvalConfig(ckpt_dir=WEIGHTS),
                                       torch.device("cpu"))
    for name in ("none", "median", "despeckle"):
        jx = jfit.apply_prefilter(jnp.asarray(noisy.numpy()), name)
        tx = apply_prefilter(noisy, name)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        want = np.asarray(jevaluate.predict(model, state, jx[..., None]))
        got = tevaluate.predict(tmodel, tx[..., None]).numpy()
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_eval_random_noise_sees_the_clean_truths(tmp_path):
    """The noise has its own generator: a noisy run scores the clean run's
    shapes, and its model input differs from the clean one's."""
    kw = dict(ckpt_dir=WEIGHTS, n=4, batch_size=2, acc_render_size=16,
              device="cpu", seed=5)
    tevaluate.eval_random(EvalConfig(out_dir=str(tmp_path / "c"), **kw))
    tevaluate.eval_random(EvalConfig(
        out_dir=str(tmp_path / "n"), noise_gaussian=NOISE["gaussian"],
        noise_dropout=NOISE["dropout"], noise_salt=NOISE["salt"],
        input_filter="median", save_pairs=3, **kw))
    with np.load(tmp_path / "c" / "accs.npz") as c, \
            np.load(tmp_path / "n" / "accs.npz") as n:
        np.testing.assert_array_equal(n["true_params"], c["true_params"])
        assert not np.array_equal(n["pred_params"], c["pred_params"])
    pairs = sorted(f for f in os.listdir(tmp_path / "n")
                   if f.endswith(".bmp"))
    assert pairs == sorted(f"{i}_{k}.bmp" for i in range(3)
                           for k in ("pred", "true"))
    true1 = tbmp.read_bmp(str(tmp_path / "n" / "1_true.bmp"))
    assert true1.shape == (256, 256) and true1.max() > 50


# ---- the trainer on a BMP directory, and with augmentation --------------------

@pytest.fixture(scope="module")
def bmp_dir(tmp_path_factory):
    """Five 64² depth maps with their label CSV (the plain renderer)."""
    d = str(tmp_path_factory.mktemp("dirdata") / "rot")
    generate(GenerateConfig(n=5, out=d, batch_size=5, image_size=64, seed=9,
                            device="cpu"))
    return d


def test_directory_train_step_matches_jax(bmp_dir, tmp_path):
    """The trainer's first step on the directory's first shuffled batch
    against the JAX package's train step on the JAX dataset's batch, both
    from the ssl weights: the loss relative 1e-5."""
    csv = os.path.join(bmp_dir, "data_labels.csv")
    jcfg = jconfig.TrainConfig(batch_size=4, image_size=64, render_size=16,
                               use_pallas=False, donate=False, data=bmp_dir,
                               labels_csv=csv, train_split=0.8)
    ds = jdatasets.DepthDataset(bmp_dir, jlabels.parse_csv_torch(csv), 0.8,
                                str(tmp_path / "j.npy"))
    imgs, labels = next(ds.batches(ds.train_indices, 4, shuffle=True,
                                   seed=jcfg.seed))
    model = flax_build_model("resnet_sq")
    state = jax_create_state(model, jax.random.PRNGKey(0), jcfg)
    v = flax_load_weights(SSL, {"params": state.params,
                                "batch_stats": state.batch_stats})
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    _, want = jax_make_train_step(model, jcfg)(state, jnp.asarray(imgs),
                                               jnp.asarray(labels))
    _, hist = train(TrainConfig(
        data=bmp_dir, labels_csv=csv, train_split=0.8, batch_size=4,
        image_size=64, render_size=16, acc_render_size=16, max_epochs=1,
        init_weights=SSL, compare_images=0, device="cpu",
        ckpt_dir=str(tmp_path / "run")))
    assert hist["loss"][0] == pytest.approx(float(want), rel=1e-5)
    assert np.isfinite(hist["val_loss"][0])  # the one-image tail batch


AUGMENTED = dict(loss="supervised", data="online", batch_size=4,
                 image_size=64, render_size=16, acc_render_size=16,
                 steps_per_epoch=2, val_steps=1, compare_images=0,
                 device="cpu", augment_gaussian=0.03, augment_dropout=0.3,
                 augment_salt=0.01, augment_randomize=True)


def test_resume_repeats_the_augmented_run(tmp_path):
    """Two epochs straight against one epoch and a resume: every train
    and validation loss the same, bit for bit."""
    _, straight = train(TrainConfig(max_epochs=2, ckpt_dir=str(
        tmp_path / "a"), **AUGMENTED))
    cfg = TrainConfig(max_epochs=1, ckpt_dir=str(tmp_path / "b"),
                      save_last_interval=1, **AUGMENTED)
    train(cfg)
    _, resumed = train(dataclasses.replace(cfg, max_epochs=2,
                                           continue_training=True,
                                           resume_from="last"))
    assert resumed["loss"] == straight["loss"]
    assert resumed["val_loss"] == straight["val_loss"]


def test_augmented_batches_are_on_the_lattice():
    """augment_batch on a rendered batch: values in [0, 1] on the 8-bit
    lattice, object pixels at least 1/510; a rank's rows of the global
    batch equal the one-rank batch's rows."""
    from sqtpu_torch.training.loop import augment_batch

    cfg = TrainConfig(**AUGMENTED)
    imgs = torch.from_numpy(_truth_images(4))[..., None]
    gen = torch.Generator()
    gen.manual_seed(0)
    out = augment_batch(cfg, gen, imgs)
    x = out[..., 0]
    assert out.shape == imgs.shape and not torch.equal(out, imgs)
    assert float(x.min()) >= 0 and float(x.max()) <= 1
    assert float(x[x > 0].min()) >= 1 / 510
    assert float((x * 255 - (x * 255).round()).abs().max()) < 1e-4
    gen.manual_seed(0)
    rows = slice(2, 4)
    assert torch.equal(augment_batch(cfg, gen, imgs[rows], rows), out[rows])
