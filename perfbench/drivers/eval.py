"""The ``eval`` traffic: the closed loop of ``python -m
sqtpu_torch.evaluate``, one batch after another.

Each batch calls the program's public functions in the order of
``evaluate.eval_random``'s batch (its loop is a closure): sample the
evaluation distribution (``data.synthetic.sample_params`` from a
generator on the card seeded by ``--seed``), render the truths
(``ops.kernels.render_hard_auto``, K3 at the traffic's sweep, quantized),
the input filter, predict in eval mode (``evaluate.predict``), score the
IoU tuple at ``acc_render_size``³ (``ops.metrics.iou_full``) and the
parameter errors (``metrics.gauge_align``), and read the five results
back to the host, as the CLI does. Set-up loads the configuration's
weights and runs ``warm_batches`` batches. ``eval_imgs_per_s`` is every
image of the window over its seconds.

The comparison takes ``sample`` batches of the window, drawn from the
seed among its first ``sample_from`` (the last batch when the window
holds none of them), and recomputes each with the plain
reference: the shapes (replayed from the seed), their depth maps (pixels
off by more than a gray level), each by itself; the predictions of the
reference's model on the program's own images (the largest gap: a pixel
one gray level off moves a prediction of some samples by 1e-2), the IoU tuple scored by the
reference on the program's truths and predictions (the largest gap:
scoring alone), and on its own (the mean IoUs' largest gap).

The traced run adds CUDA events around every ``predict`` and
``iou_full`` call of the window, and after the window ``trace_batches``
more batches under ``torch.profiler``.
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from perfbench.harness import Checks, progress
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref
from perfbench.trace import Profiler, Spans, kernel_seconds
from perfbench.weights import make as make_weights

IOU_COLUMNS = (0, 1, 5)        # rot-IoU, full IoU, gauge rot-IoU


class PortLoop:
    """The program's closed loop: its sampler, K3, model and scoring."""

    def __init__(self, config: dict, weights: dict, seed: int, device):
        from sqtpu_torch import evaluate
        from sqtpu_torch.data.synthetic import sample_params
        from sqtpu_torch.fit import apply_prefilter
        from sqtpu_torch.models import build_model
        from sqtpu_torch.ops import metrics
        from sqtpu_torch.ops.kernels import render_hard_auto
        from sqtpu_torch.utils.config import resolve_device

        if device.type == "cuda":
            resolve_device("cuda")      # TF32 off, as every entry point
        net = build_model(config["model"], config["image_size"])
        missing, unexpected = net.load_state_dict(weights, strict=False)
        if unexpected or any(not k.endswith("num_batches_tracked")
                             for k in missing):
            raise KeyError(f"weights do not fit the model: missing "
                           f"{missing}, unexpected {unexpected}")
        self.net = net.to(device).eval()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        c = config
        self.sample = lambda: sample_params(c["batch_size"], gen,
                                            device=device)
        self.render = lambda p: render_hard_auto(
            p, c["image_size"], n_sweep=c["n_sweep"],
            n_bisect=c["n_bisect"], quantize=True)
        self.prefilter = lambda x: apply_prefilter(x, c["input_filter"])
        self.predict = lambda x: evaluate.predict(self.net, x)
        self.score = lambda t, p: metrics.iou_full(t, p,
                                                   c["acc_render_size"])
        self.align = metrics.gauge_align


class ReferenceLoop:
    """The plain reference in the program's place (the control: TF32 in
    the model)."""

    def __init__(self, config: dict, weights: dict, seed: int, device,
                 tf32_on: bool = False):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        c = config
        self.sample = lambda: ref.sample_params(c["batch_size"], gen)
        self.render = lambda p: ref.render_hard(p, c["image_size"],
                                                c["n_sweep"], c["n_bisect"])
        self.prefilter = lambda x: x
        self.predict = lambda x: ref.predict(weights, x, ref_model.identity,
                                             tf32_on)
        self.score = lambda t, p: ref.score(t, p, c["acc_render_size"])
        from perfbench.reference import metrics

        self.align = metrics.gauge_align


def control(config: dict):
    """The reference one precision below the configuration's float32:
    TF32 in the model's convolutions and products."""
    return lambda *a: ReferenceLoop(*a, tf32_on=True)


def _batch(loop, spans=None):
    """One batch of the closed loop, in ``batch_eval``'s order; returns the
    device images and the host results (truths, predictions, IoU tuple,
    MAE, gauge MAE)."""
    def call(name, fn, *args):
        return spans.around(name, fn, *args) if spans else fn(*args)

    p_true = loop.sample()
    imgs = loop.prefilter(loop.render(p_true))[..., None]
    p_pred = call("predict", loop.predict, imgs)
    triple = call("iou_full", loop.score, p_true, p_pred)
    mae = torch.abs(p_pred - p_true)
    aligned, _ = loop.align(p_true, p_pred)
    qdot = torch.sum(aligned[..., 8:12] * p_pred[..., 8:12], dim=-1,
                     keepdim=True)
    qa = torch.where(qdot < 0, -aligned[..., 8:12], aligned[..., 8:12])
    mae_gauge = torch.abs(p_pred - torch.cat([aligned[..., :8], qa], -1))
    host = [x.cpu().numpy() for x in (p_true, p_pred, triple, mae,
                                      mae_gauge)]
    return imgs, host


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        loop_cls=PortLoop) -> dict:
    config = dict(cell.config)
    config.update(cell.traffic.get("config", {}))
    p = cell.params
    weights = make_weights(config["weights"], seed, device, cell.root,
                           config.get("weights_sha256", ""))
    loop = loop_cls(config, weights, seed, device)
    progress(t0, "weights loaded, loop built")
    with torch.inference_mode():
        warm = int(cell.traffic["warm_batches"])
        for _ in range(warm):
            _batch(loop)
        rng = random.Random(seed)
        sample = set(rng.sample(range(int(cell.traffic["sample_from"])),
                                int(cell.traffic["sample"])))
        kept, results = {}, []
        spans = Spans(device) if trace else None
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        start = time.perf_counter()
        setup_s = start - t0
        while True:
            imgs, host = _batch(loop, spans)
            if len(results) in sample:
                kept[len(results)] = imgs
            results.append(host)
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
        progress(t0, f"window: {len(results)} batches in {window_s:.3f} s")
        record = {"cell": cell.name, "batches": len(results),
                  "window_s": window_s}
        if trace:
            prof = Profiler(device, int(p.get("trace_batches", 3)))
            prof.run(lambda: _batch(loop))
            record["spans_ms"] = spans.read()
            record["trace"] = prof.summary
            record["kernel_s"] = {"K3": kernel_seconds(prof.summary,
                                                       "hardrender_kernel")}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    b = int(config["batch_size"])
    images = len(results) * b
    failed = sum(int((~np.isfinite(h[1]).all(axis=-1)
                      | ~np.isfinite(h[2]).all(axis=-1)).sum())
                 for h in results)
    if not kept:          # a window too short for the sample: its last
        kept[len(results) - 1] = imgs
    kept = {i: x.cpu().numpy() for i, x in kept.items()}
    del loop, imgs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = Checks(p.get("limits", {}))
    _compare(config, weights, seed, device, warm, kept, results, checks)
    progress(t0, "reference compared")
    return {"attempted": images, "failed": failed,
            "e2e": {"setup_s": setup_s, "eval_imgs_per_s": images / window_s},
            "peak_bytes": peak, "record": record, "checks": checks}


@torch.no_grad()
def _compare(config, weights, seed, device, warm, kept, results,
             checks) -> None:
    r = ReferenceLoop(config, weights, seed, device)
    gaps = dict.fromkeys(("labels_gap", "pixels_off", "pred_gap",
                          "score_gap", "iou_gap"), 0.0)
    last = max(kept)
    for i in range(warm + last + 1):
        p_true = r.sample()
        k = i - warm
        if k not in kept:
            continue
        t_prog, p_prog, triple = (torch.from_numpy(a).to(device)
                                  for a in results[k][:3])
        gaps["labels_gap"] = max(gaps["labels_gap"], float(
            (p_true - t_prog).abs().max()))
        imgs = r.render(p_true)
        gaps["pixels_off"] = max(gaps["pixels_off"], ref.levels_off(
            imgs.cpu(), torch.from_numpy(kept[k][..., 0])))
        # the model follows the program from its own rendered images: the
        # render is judged above, by itself
        p_ref = r.predict(torch.from_numpy(kept[k]).to(device))
        gaps["pred_gap"] = max(gaps["pred_gap"], float(
            (p_ref - p_prog).abs().max()))
        gaps["score_gap"] = max(gaps["score_gap"], float(
            (r.score(t_prog, p_prog) - triple).abs().max()))
        mean_ref = r.score(p_true, p_ref)[:, IOU_COLUMNS].mean(dim=0)
        mean_prog = triple[:, IOU_COLUMNS].mean(dim=0)
        gaps["iou_gap"] = max(gaps["iou_gap"], float(
            (mean_ref - mean_prog).abs().max()))
    for name, value in gaps.items():
        checks.add(name, value)
