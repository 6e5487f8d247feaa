"""The ``eval_refine`` traffic: the closed loop of ``python -m
sqtpu_torch.evaluate --model refine_sq``, one batch after another, with
the render-and-compare corrector (``IterativeSQ``) as the model.

Each batch is the ``eval`` traffic's (:func:`perfbench.drivers.eval._batch`:
sample, K3 at the traffic's sweep, quantized, predict in eval mode through
``evaluate.predict``, ``iou_full``, the errors and five host reads); the
model is built by ``build_model`` from the configuration's name, and its
``n_refine``, ``delta_scale`` and in-loop sweep are checked against the
configuration's. One forward runs the base, then each pass renders the
current estimate (K3, unquantized, at the configuration's in-loop sweep)
and applies the shared block's delta. A forward pre-hook on the model's
``refine`` block, set here and never in the program, records each pass's
estimate and the render the program made of it.

The comparison takes the ``eval`` traffic's sample of batches and
recomputes each with the plain reference (:mod:`perfbench.reference
.refiner`), teacher-forced: the shapes (replayed from the seed) and their
depth maps, each by itself (``labels_gap``, ``pixels_off``); the base's
estimate on the program's own images (``base_gap``, the largest gap); each
in-loop render against the plain unquantized render of the program's own
estimate of that pass (``render_off``: the share of pixels whose depth
differs by more than the cell's ``render_tol``: a silhouette pixel that
flips is a full depth step, while the renderers' roundings stay below
1e-5); the final predictions against the reference fed the program's
images and its in-loop renders (``pred_gap``); the IoU tuple scored by
the reference on the program's truths and predictions (``score_gap``) and
the mean IoUs of the reference's own predictions (``iou_gap``).

The traced run adds CUDA events around every ``predict`` and
``iou_full`` call of the window, and after the window ``trace_batches``
more batches under ``torch.profiler``, whose K3 launches (the input's and
the in-loop ones) are bounded on their own parameters and settings.
"""

from __future__ import annotations

import gc
import math
import random
import time

import numpy as np
import torch

from perfbench.counts import bounds
from perfbench.drivers import eval as closed_loop
from perfbench.drivers.eval import IOU_COLUMNS, _batch
from perfbench.harness import Checks, progress
from perfbench.reference import refiner as ref_refiner
from perfbench.reference import train as ref
from perfbench.trace import Profiler, Spans, kernel_seconds
from perfbench.weights_refine import make as make_weights

# the model's attribute that holds each configuration key
BUILT = (("n_refine", "n_refine"), ("delta_scale", "delta_scale"),
         ("refine_sweep", "n_sweep"))


def _settings(config: dict) -> dict:
    return {"n_refine": int(config["n_refine"]),
            "delta_scale": float(config["delta_scale"]),
            "n_sweep": int(config["refine_sweep"]),
            "n_bisect": int(config["refine_bisect"])}


class PortLoop(closed_loop.PortLoop):
    """The program's closed loop with the corrector; ``passes`` holds the
    latest forward's (estimate, render) of each pass."""

    def __init__(self, config: dict, weights: dict, seed: int, device):
        super().__init__(config, weights, seed, device)
        for key, attr in BUILT:
            if getattr(self.net, attr) != config[key]:
                raise ValueError(f"the built model's {attr} is "
                                 f"{getattr(self.net, attr)!r}, the "
                                 f"configuration's {key} {config[key]!r}")
        self.passes = []
        self.net.refine.register_forward_pre_hook(self._hook)
        predict = self.predict

        def recorded(x):
            self.passes = []
            return predict(x)

        self.predict = recorded

    def _hook(self, module, args):
        img2, p = args[0], args[1]
        self.passes.append((p, img2[..., 1]))


class ReferenceLoop(closed_loop.ReferenceLoop):
    """The plain reference in the program's place (the control: TF32 in
    the model), its own in-loop renders recorded as the program's are."""

    def __init__(self, config: dict, weights: dict, seed: int, device,
                 tf32_on: bool = False):
        super().__init__(config, weights, seed, device, tf32_on)
        self.passes = []
        kw = _settings(config)

        def predict(x):
            p, self.passes = ref_refiner.forward(weights, x, tf32_on=tf32_on,
                                                 **kw)
            return p

        self.predict = predict


def control(config: dict):
    """The reference one precision below the configuration's float32:
    TF32 in the model's convolutions and products."""
    return lambda *a: ReferenceLoop(*a, tf32_on=True)


def _kept_passes(passes) -> list:
    return [(p.detach().clone(), r.detach().clone()) for p, r in passes]


def _k3_bound_ms(config: dict, traced, device) -> float:
    """K3's least time over the profiled batches: the input render of
    each batch's truths and every in-loop render of its estimates, each
    at its own settings."""
    s, kw = int(config["image_size"]), _settings(config)
    total = 0.0
    for p_true, estimates in traced:
        total += bounds.k3_bound_ms(torch.from_numpy(p_true).to(device), s,
                                    int(config["n_sweep"]),
                                    int(config["n_bisect"]))
        for p in estimates:
            total += bounds.k3_bound_ms(p.float(), s, kw["n_sweep"],
                                        kw["n_bisect"])
    return total


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
                kept[len(results)] = (imgs, _kept_passes(loop.passes))
            results.append(host)
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
        progress(t0, f"window: {len(results)} batches in {window_s:.3f} s")
        record = {"cell": cell.name, "batches": len(results),
                  "window_s": window_s}
        if not kept:      # a window too short for the sample: its last
            kept[len(results) - 1] = (imgs, _kept_passes(loop.passes))
        if trace:
            traced = []

            def traced_batch():
                _, out = _batch(loop)
                traced.append((out[0], [q for q, _ in loop.passes]))

            prof = Profiler(device, int(p.get("trace_batches", 3)))
            prof.run(traced_batch)
            del traced[0]                        # the warm-up batch's
            record["spans_ms"] = spans.read()
            record["trace"] = prof.summary
            record["kernel_s"] = {"K3": kernel_seconds(prof.summary,
                                                       "hardrender_kernel")}
            record["bound_ms"] = {"K3": _k3_bound_ms(config, traced,
                                                     device)}
            del traced
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    b = int(config["batch_size"])
    images = len(results) * b
    failed = sum(int((~np.isfinite(h[1]).all(axis=-1)
                      | ~np.isfinite(h[2]).all(axis=-1)).sum())
                 for h in results)
    kept = {i: (x.cpu(), [(q.cpu(), r.cpu()) for q, r in passes])
            for i, (x, passes) in kept.items()}
    del loop, imgs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = Checks(p.get("limits", {}))
    _compare(config, weights, seed, device, warm, kept, results,
             float(p["render_tol"]), checks)
    progress(t0, "reference compared")
    return {"attempted": images, "failed": failed,
            "e2e": {"setup_s": setup_s, "eval_imgs_per_s": images / window_s},
            "peak_bytes": peak, "record": record, "checks": checks}


def _render_off(passes, image_size: int, kw: dict, tol: float,
                device) -> float:
    """The largest share, over the passes, of in-loop pixels whose depth
    differs from the plain render of the program's own estimate by more
    than ``tol``."""
    worst = 0.0
    for est, rendered in passes:
        plain = ref_refiner.render_estimate(est.to(device), image_size,
                                            kw["n_sweep"], kw["n_bisect"])
        diff = (plain - rendered.to(device).float()).abs()
        worst = max(worst, float((~(diff <= tol)).double().mean()))
    return worst


@torch.no_grad()
def _compare(config, weights, seed, device, warm, kept, results, tol,
             checks) -> None:
    r = closed_loop.ReferenceLoop(config, weights, seed, device)
    kw = _settings(config)
    gaps = dict.fromkeys(("labels_gap", "pixels_off", "base_gap",
                          "render_off", "pred_gap", "score_gap", "iou_gap"),
                         0.0)
    last = max(kept)
    for i in range(warm + last + 1):
        p_true = r.sample()
        k = i - warm
        if k not in kept:
            continue
        imgs_prog, passes = kept[k]
        t_prog, p_prog, triple = (torch.from_numpy(a).to(device)
                                  for a in results[k][:3])
        gaps["labels_gap"] = max(gaps["labels_gap"], float(
            (p_true - t_prog).abs().max()))
        gaps["pixels_off"] = max(gaps["pixels_off"], ref.levels_off(
            r.render(p_true).cpu(), imgs_prog[..., 0]))
        # the model follows the program from its own images and in-loop
        # renders: each render is judged below, by itself
        x = imgs_prog.to(device)
        p_ref, ref_passes = ref_refiner.forward(
            weights, x, renders=[rr.to(device) for _, rr in passes], **kw)
        gaps["base_gap"] = max(gaps["base_gap"], float(
            (ref_passes[0][0] - passes[0][0].to(device)).abs().max())
            if passes else math.inf)
        gaps["render_off"] = max(gaps["render_off"], _render_off(
            passes, x.shape[1], kw, tol, device))
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
