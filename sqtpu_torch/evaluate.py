"""Closed-loop evaluation on the card: random params -> hard ray-cast
render -> ResNetSQ -> IoU tuple and parameter errors, batched.

Counterpart of ``sqtpu/evaluate.py`` (``load_eval_state``, ``predict``,
``eval_single``, ``eval_random``, ``main``). Outputs are the same: an
appended ``results.txt`` log, ``accs.npz`` with the same keys, the same
printed summary and, with ``save_pairs``, the same true/pred BMP pairs.
The random stream is torch's, not ``jax.random``'s, so the sampled shapes
differ from the JAX package's run with the same seed.

The sensor-noise protocol (``--noise-*``) corrupts the model's input
only, the truths still score it; its draws come from a second generator,
so a noisy run sees the same shapes as a clean run with the same seed.
``--input-filter`` cleans the (corrupted) input before the model.
``--refine lm|gd|lm+gd`` polishes the predictions against the input
(:func:`sqtpu_torch.fit.refine_params`); ``--model classical`` runs no
network: the moments init and ``refine_steps`` LM iterations on
``refine_size``² points of each image (:func:`classical_recover_fn`).
The narrower models are scored by the JAX package's protocols: a model
of 8 parameters (``keras_iso``) sees the isometric view (``--iso true``,
required) and the known view quaternion is padded in; a model of 4 (the
rotation-only ``generic_sq``) has the true size, shape and position
padded in, so its rot-IoU and angles are the real metrics.

Usage::

    python -m sqtpu_torch.evaluate --ckpt-dir artifacts/resnet_sq_c4_fp16.npz \
        --n 1000 --batch-size 125 --out-dir eval_out [--device cpu]
    python -m sqtpu_torch.evaluate --ckpt-dir WEIGHTS.npz single image.bmp
    python -m sqtpu_torch.evaluate --model classical --n 1000 \
        --batch-size 125 [--refine-robust-c 4.685 --refine-filter median]
    python -m sqtpu_torch.evaluate --ckpt-dir WEIGHTS.npz --refine lm
    python -m sqtpu_torch.evaluate --model keras_iso --iso true \
        --ckpt-dir RUN_DIR --n 250 --batch-size 125
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from sqtpu_torch.data.augment import depth_noise
from sqtpu_torch.data.bmp import read_bmp
from sqtpu_torch.data.labels import denormalize_torch
from sqtpu_torch.data.synthetic import sample_params, save_pairs
from sqtpu_torch.fit import apply_prefilter, recover, refine_params
from sqtpu_torch.models import OUTPUT_DIMS, build_model, params_vector
from sqtpu_torch.ops import metrics
from sqtpu_torch.ops.kernels import render_hard_auto
from sqtpu_torch.utils.checkpoint import (
    checkpoint_exists, load_config, load_model_state, load_weights_npz,
)
from sqtpu_torch.utils.config import (
    EvalConfig, TrainConfig, check_slice, parse_cli, resolve_device,
)
from sqtpu_torch.utils.profiling import span

# eval-quality sweep of the ground-truth renderer (sqtpu/evaluate.py:157)
EVAL_SWEEP, EVAL_BISECT = 64, 16
# the noise generator's seed under the run's seed (the truths' generator
# is seeded with the seed itself)
NOISE_STREAM = 1


def load_eval_state(cfg, device: torch.device) -> torch.nn.Module:
    """A model in eval mode on ``device``: ``cfg.model`` with the weights
    of the ``.npz`` at ``cfg.ckpt_dir``, or the model of a port training
    run's ``<ckpt_dir>/best`` checkpoint (built from the config it
    embeds); random weights (seeded) with a warning when there is
    neither."""
    best = os.path.join(cfg.ckpt_dir, "best")
    name = cfg.model
    if checkpoint_exists(best):
        name = load_config(best, TrainConfig).model
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # the random init, if it is kept, is seeded
        model = build_model(name, cfg.image_size)
    if cfg.ckpt_dir.endswith(".npz"):
        load_weights_npz(cfg.ckpt_dir, model)
    elif checkpoint_exists(best):
        load_model_state(best, model)
    elif os.path.exists(best):
        raise NotImplementedError(
            f"{cfg.ckpt_dir} is an Orbax checkpoint of the JAX package; "
            "the port reads .npz weights (sqtpu.utils.checkpoint"
            ".save_weights_npz) and its own checkpoints")
    else:
        print(f"[warn] no weights at {cfg.ckpt_dir}; using random init",
              file=sys.stderr)
    return model.to(device).eval()


@torch.inference_mode()
def predict(model: torch.nn.Module, imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) or (B, H, W) images -> (B, k) params (eval mode; k
    the model's width, 12 for the full family); the span
    ``eval.predict`` (:mod:`sqtpu_torch.utils.profiling`)."""
    with span("eval.predict"):
        return params_vector(model(imgs))


def classical_recover_fn(cfg: EvalConfig):
    """(B, H, W) depth maps -> (B, 12) params by the no-network classical
    recovery (moments init + LM, :func:`sqtpu_torch.fit.recover`), with
    every ``refine_*`` knob of ``cfg``: the one place of that wiring."""
    def recover_fn(imgs: torch.Tensor) -> torch.Tensor:
        return recover(imgs, n_points=cfg.refine_size,
                       iters=cfg.refine_steps,
                       robust_c=cfg.refine_robust_c,
                       prefilter=cfg.refine_filter,
                       residual=cfg.refine_residual)[0]
    return recover_fn


def refine_fn(cfg):
    """(B, H, W) images, (B, 12) predictions -> the predictions refined
    with ``cfg.refine`` and its ``refine_*`` knobs; the identity when
    ``cfg.refine`` is ``"none"``."""
    def refine(imgs: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        if cfg.refine == "none":
            return p
        return refine_params(imgs, p, method=cfg.refine,
                             steps=cfg.refine_steps, n=cfg.refine_size,
                             lr=cfg.refine_lr,
                             robust_c=cfg.refine_robust_c,
                             prefilter=cfg.refine_filter,
                             residual=cfg.refine_residual)
    return refine


def eval_single(cfg: EvalConfig, image_path: str) -> np.ndarray:
    """One BMP -> its (12,) normalized params, the reference units
    printed. ``input_filter`` cleans the image first; ``--model
    classical`` recovers them with no network."""
    check_slice(cfg)
    device = resolve_device(cfg.device)
    img = torch.from_numpy(read_bmp(image_path).astype(np.float32) / 255.0)
    img = apply_prefilter(img.to(device), cfg.input_filter)
    if cfg.model == "classical":
        pred = classical_recover_fn(cfg)(img[None])[0].cpu().numpy()
    else:
        model = load_eval_state(cfg, device)
        pred = predict(model, img[None, ..., None])[0].cpu().numpy()
    d = denormalize_torch(pred)
    print("Predicted parameters:")
    print("Size a:", d[0:3])
    print("Shape e:", d[3:5])
    print("Position t:", d[5:8])
    print("Rotation q:", d[8:12])
    return pred


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def eval_random(cfg: EvalConfig) -> dict:
    """The closed loop over ``cfg.n`` random shapes in batches of
    ``cfg.batch_size``: per batch, sample the reference eval distribution,
    render ground-truth depth (K3 on the card), corrupt it with the
    ``noise_*`` options and clean it with ``input_filter`` (the model's
    input only), predict (or recover with no network, ``--model
    classical``), refine (``refine``), and score with the IoU tuple at
    ``acc_render_size``³ and per-parameter MAE. The first ``save_pairs``
    samples' input and prediction are written as BMP pairs. The
    predict-only latency times the model alone (for ``classical``, the
    solve), not the refinement."""
    check_slice(cfg)
    device = resolve_device(cfg.device)
    classical = cfg.model == "classical"
    width = OUTPUT_DIMS.get(cfg.model, 12)
    if width == 8 and not cfg.iso:
        # scored on random views with the true quaternion padded in, a
        # model that never sees rotation would report rot-IoU 1, angle 0
        raise ValueError(
            f"model {cfg.model!r} regresses 8 isometric-view parameters; "
            "pass --iso true (the py/test_isometry.py protocol)")
    if cfg.refine != "none" and width != 12:
        # the width-8 and width-4 protocols pad true values in: refined,
        # they would score a fit started from the truth, not the model
        raise ValueError(
            f"--refine {cfg.refine!r} requires a 12-parameter model; "
            f"{cfg.model!r} predicts {width}")
    if classical:
        model, recover_fn = None, classical_recover_fn(cfg)
    else:
        model = load_eval_state(cfg, device)
    refine = refine_fn(cfg)

    def infer(x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) images -> (B, 12): the model, or the solve."""
        return recover_fn(x[..., 0]) if classical else predict(model, x)

    os.makedirs(cfg.out_dir, exist_ok=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    noisy = cfg.noise_gaussian or cfg.noise_dropout or cfg.noise_salt
    noise_gen = torch.Generator(device=device)
    noise_gen.manual_seed(cfg.seed * 1_000_003 + NOISE_STREAM)

    def pad(p_true: torch.Tensor, p_pred: torch.Tensor) -> torch.Tensor:
        """A narrower prediction with the true values it lacks."""
        if width == 8:     # the fixed, known view quaternion
            return torch.cat([p_pred, p_true[:, 8:12]], dim=-1)
        if width == 4:     # the true size, shape and position
            return torch.cat([p_true[:, :8], p_pred], dim=-1)
        return p_pred

    def batch_eval():
        p_true = sample_params(cfg.batch_size, gen, device=device,
                               iso=cfg.iso)
        imgs = render_hard_auto(p_true, cfg.image_size, n_sweep=EVAL_SWEEP,
                                n_bisect=EVAL_BISECT, quantize=True)
        if noisy:
            imgs = depth_noise(noise_gen, imgs, gaussian=cfg.noise_gaussian,
                               dropout=cfg.noise_dropout,
                               salt=cfg.noise_salt, quantize=True)
        imgs = apply_prefilter(imgs, cfg.input_filter)[..., None]
        p_pred = refine(imgs[..., 0], pad(p_true, infer(imgs)))
        triple = metrics.iou_full(p_true, p_pred, cfg.acc_render_size)
        mae = torch.abs(p_pred - p_true)
        # MAE against the gauge-aligned truth, its quaternion flipped to
        # the prediction's hemisphere (q and -q are one rotation)
        aligned, _ = metrics.gauge_align(p_true, p_pred)
        qdot = torch.sum(aligned[..., 8:12] * p_pred[..., 8:12], dim=-1,
                         keepdim=True)
        qa = torch.where(qdot < 0, -aligned[..., 8:12], aligned[..., 8:12])
        aligned = torch.cat([aligned[..., :8], qa], dim=-1)
        mae_gauge = torch.abs(p_pred - aligned)
        return p_true, p_pred, triple, mae, mae_gauge, imgs

    all_triples, all_mae, all_mae_g, all_true, all_pred = [], [], [], [], []
    n_batches = (cfg.n + cfg.batch_size - 1) // cfg.batch_size
    latencies = []
    pairs_saved = 0
    with open(os.path.join(cfg.out_dir, cfg.results_file), "a") as f:
        for b in range(n_batches):
            t0 = time.perf_counter()
            out = batch_eval()
            p_true, p_pred, triple, mae, mae_g = (
                x.cpu().numpy() for x in out[:5])
            imgs = out[5]
            if b > 0:  # the first batch pays the kernel build and warm-up
                latencies.append((time.perf_counter() - t0) / cfg.batch_size)
            all_triples.append(triple)
            all_mae.append(mae)
            all_mae_g.append(mae_g)
            all_true.append(p_true)
            all_pred.append(p_pred)
            for i in range(triple.shape[0]):
                idx = b * cfg.batch_size + i
                if idx >= cfg.n:
                    break
                print(f"---------- Example {idx} ----------", file=f)
                print("True params:", denormalize_torch(p_true[i]), file=f)
                print("Pred params:", denormalize_torch(p_pred[i]), file=f)
                print("- Accuracy:", triple[i] * 100, file=f)
            # this batch's share of the pairs, so save_pairs > batch_size
            # goes on saving in the next batches
            k = min(cfg.save_pairs - pairs_saved, cfg.batch_size)
            if k > 0:
                save_pairs(cfg.out_dir, pairs_saved, imgs[:k, ..., 0],
                           out[1][:k], cfg.image_size)
                pairs_saved += k

    # predict-only latency on the last batch's images, batch 1 and batched
    predict_latency = {}
    for name, x in (("batch1", imgs[:1]), (f"batch{cfg.batch_size}", imgs)):
        infer(x)  # warm
        _sync(device)
        t0 = time.perf_counter()
        reps = 10
        for _ in range(reps):
            infer(x)
        _sync(device)
        predict_latency[name] = (time.perf_counter() - t0) / (reps
                                                              * x.shape[0])

    triples = np.concatenate(all_triples)[: cfg.n]
    maes = np.concatenate(all_mae)[: cfg.n]
    maes_g = np.concatenate(all_mae_g)[: cfg.n]
    trues = np.concatenate(all_true)[: cfg.n]
    preds = np.concatenate(all_pred)[: cfg.n]
    rot_iou, full_iou = triples[:, 0], triples[:, 1]
    ang, ang_sym = triples[:, 2], triples[:, 3]
    ang_gauge, rot_iou_gauge = triples[:, 4], triples[:, 5]
    gauge_swapped = triples[:, 6]

    # rotation about an axis is unobservable when the other two sizes are
    # (near-)equal: bin by the smallest pairwise size gap
    a_true = trues[:, 0:3]
    asym = np.min(np.abs(a_true[:, [0, 0, 1]] - a_true[:, [1, 2, 2]]),
                  axis=1)
    elong = a_true.max(axis=1) / a_true.min(axis=1)
    order = np.argsort(asym)
    strat = []
    for idx in np.array_split(order, min(4, order.size)):
        strat.append({
            "asym_lo": float(asym[idx].min()),
            "asym_hi": float(asym[idx].max()),
            "angle_sym": float(ang_sym[idx].mean()),
            "angle_gauge": float(ang_gauge[idx].mean()),
            "rot_iou": float(rot_iou[idx].mean()),
            "rot_iou_gauge": float(rot_iou_gauge[idx].mean()),
            "full_iou": float(full_iou[idx].mean()),
            "n": int(idx.size)})
    print("--Rot::")
    print("Mean: ", rot_iou.mean())
    print("Std: ", rot_iou.std())
    print("--Full::")
    print("Mean: ", full_iou.mean())
    print("Std: ", full_iou.std())
    print("--Angle err (rad)::")
    print("Mean: ", ang.mean())
    print("--Angle err mod D2 symmetry (rad)::")
    print("Mean: ", ang_sym.mean())
    print("--Angle err mod FULL D4 gauge (rad)::")
    print("Mean: ", ang_gauge.mean())
    print("--Rot-IoU vs gauge-aligned decomposition::")
    print("Mean: ", rot_iou_gauge.mean())
    print(f"--Gauge-swapped predictions (a1<->a2 + z quarter-turn): "
          f"{100.0 * gauge_swapped.mean():.1f}%")
    print("--Param MAE (12)::")
    print(maes.mean(axis=0))
    print("--Param MAE vs gauge-aligned truth (12; quat columns "
          "meaningful)::")
    print(maes_g.mean(axis=0))
    print("--Rotation metrics by shape asymmetry (quartiles of "
          "min pairwise |a_i - a_j|, normalized units)::")
    print(f"{'quartile':>9} {'asym range':>17} {'angle_sym':>10} "
          f"{'ang_gauge':>10} {'rot_iou':>8} {'rotIoU_g':>9} "
          f"{'full_iou':>9} {'n':>5}")
    for qi, s in enumerate(strat):
        print(f"{qi:>9} [{s['asym_lo']:.4f}, {s['asym_hi']:.4f}] "
              f"{s['angle_sym']:>10.3f} {s['angle_gauge']:>10.3f} "
              f"{s['rot_iou']:>8.3f} {s['rot_iou_gauge']:>9.3f} "
              f"{s['full_iou']:>9.3f} {s['n']:>5}")
    if latencies:
        print(f"--Per-image latency (render+predict+score): "
              f"{1e3 * float(np.mean(latencies)):.3f} ms")
    for name, lat in predict_latency.items():
        print(f"--Per-image latency (predict only, {name}): "
              f"{1e3 * lat:.3f} ms")
    np.savez(os.path.join(cfg.out_dir, "accs.npz"),
             rot_iou=rot_iou, full_iou=full_iou, angle=ang,
             angle_sym=ang_sym, angle_gauge=ang_gauge,
             rot_iou_gauge=rot_iou_gauge, gauge_swapped=gauge_swapped,
             mae=maes, mae_gauge=maes_g,
             true_params=trues, pred_params=preds,
             asym=asym, elongation=elong,
             predict_latency_batched_s=predict_latency[
                 f"batch{cfg.batch_size}"],
             predict_latency_batched_size=cfg.batch_size,
             predict_latency_batch1_s=predict_latency["batch1"],
             predict_latency_note=np.str_(
                 f"host clock around {device.type} work ending in a "
                 "synchronize; batch1 is one call per image"))
    return {"rot_iou_mean": float(rot_iou.mean()),
            "full_iou_mean": float(full_iou.mean()),
            "angle_mean": float(ang.mean()),
            "angle_sym_mean": float(ang_sym.mean()),
            "angle_gauge_mean": float(ang_gauge.mean()),
            "rot_iou_gauge_mean": float(rot_iou_gauge.mean()),
            "gauge_swapped_frac": float(gauge_swapped.mean()),
            "by_asymmetry_quartile": strat,
            "predict_latency_ms": {k: 1e3 * v
                                   for k, v in predict_latency.items()},
            "param_mae": maes.mean(axis=0).tolist(),
            "param_mae_gauge": maes_g.mean(axis=0).tolist()}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    single_path = None
    if "single" in argv:
        i = argv.index("single")
        single_path = argv[i + 1]
        del argv[i: i + 2]
    cfg = parse_cli(EvalConfig, argv)
    if single_path:
        eval_single(cfg, single_path)
    else:
        eval_random(cfg)


if __name__ == "__main__":
    main()
