"""Roofline decomposition of the explicit_sym train step at 128³.

Counterpart of ``tools/roofline_explicit.py``. It times, on the device,
the three parts of the recipe behind the shipped weights
(``explicit_sym`` at 128³, sharpness 20, gauge weight 2.0):

1. K4 alone (``explicit.cuda_fused``: the explicit loss's value and
   gradient in one sweep, each sample's z-window), with a second random
   parameter set as the predictions, and the loss's value and gradient
   through its wrapper (``explicit_loss_auto`` and autograd);
2. the encoder's train step alone (ResNetSQ, ``loss="supervised"``: the
   loss costs nothing), in float32 and bfloat16;
3. the full ``explicit_sym`` train step (``make_train_step``), in float32
   and bfloat16.

K4's bound is the card's own yardstick, counted as ``chip_smoke.py``
counts it (:func:`sqtpu_torch.ops.kernels.bounds.explicit_bounds`): the
points after the exact-zero cull at OPS_K4_CULLED float32 operations over
PEAK_FP32_OPS, or the bytes over PEAK_BYTES, whichever is larger;
``fraction_of_bound`` is bound_ms / kernel_ms. Prints one JSON object::

    python -m sqtpu_torch.tools.roofline_explicit [--device cpu]

``SQTPU_BENCH_BATCH`` (512) and ``SQTPU_BENCH_ITERS`` (10) set the batch
and the timed iterations (after two untimed ones). On the card the times
are CUDA events around the iterations; on the CPU the host clock.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

BATCH = int(os.environ.get("SQTPU_BENCH_BATCH", "512"))
ITERS = int(os.environ.get("SQTPU_BENCH_ITERS", "10"))
N = 128
SHARP = 20.0
IMAGE = 256


def time_ms(fn, device: torch.device) -> float:
    """Mean milliseconds of ``fn()`` over ITERS calls after two untimed
    ones: CUDA events on the card, the host clock after each call's
    completion on the CPU."""
    for _ in range(2):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / ITERS
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    return (time.perf_counter() - t0) / ITERS * 1e3


def _train_step_ms(cfg, imgs, labels, device) -> float:
    from sqtpu_torch.models import build_model
    from sqtpu_torch.training.loop import make_train_step
    from sqtpu_torch.training.state import create_train_state
    from sqtpu_torch.utils.config import MODEL_DTYPES

    torch.manual_seed(3)
    model = build_model("resnet_sq", IMAGE,
                        dtype=MODEL_DTYPES[cfg.dtype]).to(device)
    step = make_train_step(create_train_state(model, cfg), cfg)
    return time_ms(lambda: step(imgs, labels), device)


def measure(device: torch.device) -> dict:
    """The tool's JSON record on ``device``."""
    from sqtpu_torch.data.synthetic import make_batch, sample_params
    from sqtpu_torch.ops.kernels import bounds, explicit_loss_auto
    from sqtpu_torch.ops.kernels import explicit as KE
    from sqtpu_torch.utils.config import TrainConfig
    from sqtpu_torch.utils.profiling import card_line

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    imgs, labels = make_batch(gen, BATCH, IMAGE, "hard")
    # predictions: a second random parameter set (early training's window
    # unions, wider than a converged model's)
    gen.manual_seed(2)
    preds = sample_params(BATCH, gen)

    # ---- 1. K4 alone, and the loss's value and gradient through it
    par_t, par_p = KE.pack_params(labels, preds, N, True,
                                  KE.default_margin(SHARP))
    row = bounds.explicit_bounds(par_t, par_p, N, SHARP)["K4"]
    fused = KE.cuda_fused if device.type == "cuda" else KE.emulate_fused
    kernel_ms = time_ms(lambda: fused(par_t, par_p, N, SHARP), device)

    def value_and_grad():
        p = preds.clone().requires_grad_(True)
        explicit_loss_auto(labels, p, N, sharp=SHARP).backward()

    vg_ms = time_ms(value_and_grad, device)
    mean_planes = row["in_window_points"] / ((N + 1) ** 2 * BATCH)

    # ---- 2. the encoder's step alone; 3. the full explicit_sym step
    def cfg(loss, dtype):
        return TrainConfig(batch_size=BATCH, render_size=N, loss=loss,
                           gauge_weight=2.0, explicit_sharp=SHARP,
                           dtype=dtype, device=device.type)

    enc32 = _train_step_ms(cfg("supervised", "float32"), imgs, labels, device)
    enc16 = _train_step_ms(cfg("supervised", "bfloat16"), imgs, labels,
                           device)
    full32 = _train_step_ms(cfg("explicit_sym", "float32"), imgs, labels,
                            device)
    full16 = _train_step_ms(cfg("explicit_sym", "bfloat16"), imgs, labels,
                            device)
    rec = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "card": card_line() if device.type == "cuda" else None,
        "batch": BATCH, "iters": ITERS, "render_size": N, "sharp": SHARP,
        "mean_window_planes": mean_planes,
        "points_after_cull": row["points_after_cull"],
        "kernel_ms": kernel_ms,
        "kernel_imgs_per_sec": BATCH / kernel_ms * 1e3,
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "fraction_of_bound": (row["bound_ms"] / kernel_ms
                              if device.type == "cuda" else None),
        "loss_value_and_grad_ms": vg_ms,
        "encoder_fp32_ms": enc32, "encoder_bf16_ms": enc16,
        "full_step_ms": full32,
        "full_imgs_per_sec_per_chip": BATCH / full32 * 1e3,
        "full_step_bf16_ms": full16,
        "full_bf16_imgs_per_sec_per_chip": BATCH / full16 * 1e3,
        "sum_kernel_plus_encoder_ms": kernel_ms + enc32,
    }
    if device.type != "cuda":
        # no kernel runs on the CPU: K4's emulation stands in for it, and
        # the bound is the card's
        rec["kernel"] = "emulation"
    return rec


def main(argv=None) -> dict:
    from sqtpu_torch.utils.config import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    rec = measure(resolve_device(args.device))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
