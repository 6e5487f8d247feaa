"""The ``train`` traffic: the port's training step on batches rendered on
the card before every step, as the trainer's ``--data online`` feeds it.

Set-up builds one object, the program's train step with its model and
Adam state (``sqtpu_torch.training.loop.make_train_step`` over
``sqtpu_torch.training.state.create_train_state``), from the weights the
benchmark made, and drives it through the traffic's ``checked_steps``
first steps with the window's own call and feed
(``sqtpu_torch.data.synthetic.make_batch`` from a generator on the card
seeded by ``--seed``: every row differs). Those steps warm up every shape
the window uses. The window goes on with the same object: a fresh batch,
a step, as often as ``--seconds`` allows; the loss is read once, at the
end. ``train_imgs_per_s`` is every image trained in the window over the
window's seconds and the cell's chips.

The comparison follows the first steps with the plain reference, from the
same weights and the same seed: the sampled shapes, replayed from the
seed, and the rendered batches, rendered again by the plain ray-caster
(pixels off by more than a gray level), each by itself; then the steps,
which the reference takes on the program's own rendered batches (a pixel
one gray level off, as the two renderers' roundings put 2e-6 of them,
moves the step's gradient on some seeds as far as the lower-precision
control does): the first step's predictions,
each step's loss, the first loss's gradient with respect to the
predictions (the loss kernels' output, recorded by a hook: the share of
rows off by more than half their norm), the first gradient as Adam got it (its first moment
after one step, over 1 − β1), the parameters' change after the checked
steps and the BatchNorm statistics' change, the last three by the worst
leaf's gap of norms (:func:`perfbench.reference.train.worst_leaf`).
Leaves whose
first gradient in the reference is under CHANGE_FLOOR of the median
leaf's (a bias before a train-mode BatchNorm: zero up to rounding) are
left out of the change, which Adam drives by rounding alone there.

The traced run adds CUDA events around every ``make_batch`` call of the
window, and after the window ``trace_steps`` more steps of the same
object under ``torch.profiler`` (so that the profiler's cost stays out of
the window); the predictions of the profiled steps are recorded by a
forward hook so that the kernels' bounds count the work of their own
inputs.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

from perfbench.counts import bounds
from perfbench.harness import Checks, progress
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref
from perfbench.trace import Profiler, Spans, kernel_seconds
from perfbench.weights import make as make_weights

CHANGE_FLOOR = 1e-3
# the reference's dtype: float32, as the configurations state; float64
# (set by ``perfbench.readings --reference float64``) for a second witness
REFERENCE_DTYPE = torch.float32
KERNELS = {"K3": "hardrender_kernel", "K1": "implicit_fwd_kernel",
           "K2": "implicit_bwd_kernel", "K4": "explicit_fused_kernel",
           "nccl": "nccl"}


def data_seed(seed: int) -> int:
    return seed


def weights_seed(seed: int) -> int:
    return seed + 1_000_003


class PortTrainee:
    """The program: its model, train step and Adam state, fed by its own
    ``make_batch``."""

    def __init__(self, config: dict, weights: dict, seed: int,
                 device: torch.device):
        from sqtpu_torch.data.synthetic import make_batch
        from sqtpu_torch.models import build_model
        from sqtpu_torch.training.loop import make_train_step
        from sqtpu_torch.training.state import create_train_state
        from sqtpu_torch.utils.config import (
            MODEL_DTYPES, TrainConfig, resolve_device,
        )

        if device.type == "cuda":
            resolve_device("cuda")      # TF32 off, as every entry point
        names = {f.name for f in dataclasses.fields(TrainConfig)}
        self.cfg = TrainConfig(**{k: v for k, v in config.items()
                                  if k in names})
        net = build_model(config["model"], self.cfg.image_size,
                          dtype=MODEL_DTYPES[self.cfg.dtype])
        missing, unexpected = net.load_state_dict(weights, strict=False)
        if unexpected or any(not k.endswith("num_batches_tracked")
                             for k in missing):
            raise KeyError(f"weights do not fit the model: missing "
                           f"{missing}, unexpected {unexpected}")
        self.net = net.to(device)
        self.state = create_train_state(self.net, self.cfg)
        self.step = make_train_step(self.state, self.cfg)
        gen = torch.Generator(device=device)
        gen.manual_seed(data_seed(seed))
        b, s = self.cfg.batch_size, self.cfg.image_size
        self.draw = lambda: make_batch(gen, b, s, self.cfg.renderer)
        self.preds = None
        self.pred_grads = None
        self.net.register_forward_hook(self._hook)

    def _hook(self, module, inputs, out):
        """Record the step's predictions and, when asked, the loss's
        gradient with respect to them (the four heads' in order)."""
        if self.preds is not None:
            from sqtpu_torch.models import params_vector

            self.preds.append(params_vector(out).detach())
        if self.pred_grads is not None:
            parts = {}
            sink = self.pred_grads

            def keep(i):
                def hook(g):
                    parts[i] = g.detach()
                    if len(parts) == len(out):
                        sink.append(torch.cat([parts[j] for j in
                                               range(len(out))], dim=-1))
                return hook

            for i, t in enumerate(out):
                t.register_hook(keep(i))

    def params(self) -> dict:
        return dict(self.net.named_parameters())

    def stats(self) -> dict:
        return {k: v for k, v in self.net.named_buffers()
                if ref_model.is_stat(k)}

    def first_grads(self) -> dict:
        """The gradient Adam got at its first step: exp_avg / (1 − β1);
        zeros for a leaf Adam has not stepped."""
        b1 = self.state.optimizer.param_groups[0]["betas"][0]
        st = self.state.optimizer.state
        return {k: st[p]["exp_avg"] / (1.0 - b1) if "exp_avg" in st[p]
                else torch.zeros_like(p)
                for k, p in self.net.named_parameters()}


class ReferenceTrainee:
    """The plain reference in the program's place, in the precision the
    control asks for: fed by the reference's sampler and renderer."""

    def __init__(self, config: dict, weights: dict, seed: int,
                 device: torch.device, quant=ref_model.identity,
                 tf32_on: bool = False, dtype=torch.float32):
        self.trainer = ref.Trainer(weights, config, quant, tf32_on, dtype)
        self.config = config
        gen = torch.Generator(device=device)
        gen.manual_seed(data_seed(seed))
        self.gen = gen
        self.preds = None
        self.pred_grads = None

    def draw(self):
        c = self.config
        labels = ref.sample_params(c["batch_size"], self.gen)
        imgs = ref.render_hard(labels, c["image_size"], c["n_sweep"],
                               c["n_bisect"])
        return imgs[..., None], labels

    def step(self, imgs, labels):
        loss = self.trainer.step(imgs, labels)
        if self.preds is not None:
            self.preds.append(self.trainer.last_pred)
        if self.pred_grads is not None:
            self.pred_grads.append(self.trainer.last_pred_grad)
        return loss

    def params(self) -> dict:
        return {k: self.trainer.w[k] for k in self.trainer.m}

    def stats(self) -> dict:
        return {k: v for k, v in self.trainer.w.items()
                if ref_model.is_stat(k)}

    def first_grads(self) -> dict:
        return self.trainer.last_grad


def control(config: dict):
    """The reference one precision below the configuration's, as a
    trainee factory: fp8 (scaled e4m3) under bfloat16, TF32 under
    float32."""
    if config["dtype"] == "bfloat16":
        return lambda *a: ReferenceTrainee(*a, quant=ref_model.fp8_round)
    return lambda *a: ReferenceTrainee(*a, tf32_on=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        trainee=PortTrainee) -> dict:
    config = dict(cell.config)
    config.update(cell.traffic.get("config", {}))
    p = cell.params
    checked = int(cell.traffic["checked_steps"])
    w0 = make_weights(config["weights"], weights_seed(seed), device,
                      cell.root, config.get("weights_sha256", ""))
    progress(t0, "weights made")
    tr = trainee(config, w0, seed, device)
    progress(t0, "train step built")

    # set-up: the checked first steps through the window's call and feed
    seen = {"labels": [], "imgs": [], "loss": []}
    tr.preds, tr.pred_grads = [], []
    for i in range(checked):
        imgs, labels = tr.draw()
        seen["labels"].append(labels.cpu().numpy())
        seen["imgs"].append(imgs[..., 0].float().cpu())
        seen["loss"].append(float(tr.step(imgs, labels)))
        progress(t0, f"checked step {i + 1}")
        if i == 0:
            seen["pred"] = tr.preds[0].float().cpu().numpy()
            seen["pred_grad"] = tr.pred_grads[0].double()
            seen["grad"] = {k: v.detach().clone() for k, v in
                            tr.first_grads().items()}
            tr.preds = tr.pred_grads = None
    seen["change"] = {k: (v.detach() - w0[k]) for k, v in tr.params().items()}
    seen["stat_change"] = {k: (v.detach() - w0[k])
                           for k, v in tr.stats().items()}

    # the window
    spans = Spans(device) if trace else None
    draw = ((lambda: spans.around("make_batch", tr.draw)) if trace
            else tr.draw)
    _sync(device)
    start = time.perf_counter()
    setup_s = start - t0
    steps = 0
    while True:
        imgs, labels = draw()
        loss = tr.step(imgs, labels)
        steps += 1
        if time.perf_counter() - start >= seconds:
            break
    final_loss = float(loss)                 # the window's one host read
    window_s = time.perf_counter() - start
    progress(t0, f"window: {steps} steps in {window_s:.3f} s, last loss "
             f"{final_loss!r}")
    traced = {"labels": [], "preds": []}
    if trace:   # the profiled steps follow the window, on the same object

        def traced_step():
            imgs, labels = tr.draw()
            traced["labels"].append(labels)
            tr.preds = traced["preds"]
            tr.step(imgs, labels)
            tr.preds = None

        prof = Profiler(device, int(p.get("trace_steps", 4)))
        prof.run(traced_step)
        del traced["labels"][0], traced["preds"][0]   # the warm-up step's
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    b = int(config["batch_size"])
    images = steps * b
    record = {"cell": cell.name, "steps": steps, "images": images,
              "window_s": window_s, "chips": cell.chips,
              "flops_per_image": bounds.resnet_sq_train_flops(
                  int(config["image_size"])),
              "peak_flops": bounds.PEAKS[config["dtype"]]}
    if trace:
        _sync(device)
        record["spans_ms"] = spans.read()
        record["trace"] = prof.summary
        record["kernel_s"] = {k: kernel_seconds(prof.summary, needle)
                              for k, needle in KERNELS.items()}
        record["bound_ms"] = _bounds(config, traced)
    del tr, traced, loss, imgs, labels
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = Checks(p.get("limits", {}))
    _compare(config, w0, seed, device, seen, checked, checks)
    progress(t0, "reference compared")
    return {"attempted": images,
            "failed": 0 if math.isfinite(final_loss) else b,
            "e2e": {"setup_s": setup_s,
                    "train_imgs_per_s": images / window_s / cell.chips},
            "peak_bytes": peak, "record": record, "checks": checks}


def _bounds(config: dict, traced: dict) -> dict:
    """The least device milliseconds of each kernel of the traced steps,
    counted on the steps' own shapes and predictions."""
    n, s = int(config["render_size"]), int(config["image_size"])
    out = {"K3": 0.0, "K1K2": 0.0, "K4": 0.0}
    for labels, pred in zip(traced["labels"], traced["preds"]):
        out["K3"] += bounds.k3_bound_ms(labels, s, int(config["n_sweep"]),
                                        int(config["n_bisect"]))
        if config["loss"] == "implicit":
            out["K1K2"] += bounds.k1k2_bound_ms(
                pred.float(), n, config["tau"], config["sigmoid_sharpness"])
        elif config["loss"].startswith("explicit"):
            out["K4"] += bounds.k4_bound_ms(labels.float(), pred.float(), n,
                                            config["explicit_sharp"])
    return out


def _compare(config, w0, seed, device, seen, checked, checks) -> None:
    """The reference's first ``checked`` steps from the same weights and
    seed, against what the program's set-up recorded."""
    r = ReferenceTrainee(config, w0, seed, device, dtype=REFERENCE_DTYPE)
    labels_gap = pixels = loss_gap = 0.0
    for i in range(checked):
        imgs, labels = r.draw()
        labels_gap = max(labels_gap, float(np.abs(
            labels.cpu().numpy() - seen["labels"][i]).max()))
        pixels = max(pixels, ref.levels_off(imgs[..., 0].cpu(),
                                            seen["imgs"][i]))
        # the step follows the program from its own rendered batch: the
        # render is judged above, by itself
        loss = float(r.step(seen["imgs"][i].to(device)[..., None], labels))
        loss_gap = max(loss_gap, abs(seen["loss"][i] - loss)
                       / max(abs(loss), 1e-30))
        if i == 0:
            diff = r.trainer.last_pred.double().cpu().numpy() - seen["pred"]
            g_ref = r.trainer.last_pred_grad.double()
            rows = (torch.linalg.vector_norm(seen["pred_grad"] - g_ref, dim=-1)
                    / torch.linalg.vector_norm(g_ref, dim=-1).clamp(
                        min=1e-300))
            ref_grad = {k: v.clone() for k, v in r.first_grads().items()}
    gn = {k: float(torch.linalg.vector_norm(v.double()))
          for k, v in ref_grad.items()}
    med = sorted(gn.values())[len(gn) // 2]
    moved = [k for k in ref_grad if gn[k] >= CHANGE_FLOOR * med]
    ref_change = {k: r.trainer.w[k] - w0[k] for k in ref_grad}
    ref_stats = {k: r.trainer.w[k] - w0[k] for k in seen["stat_change"]}
    numbers = {
        "labels_gap": labels_gap, "pixels_off": pixels,
        "pred_gap": float(np.abs(diff).max()),
        "pred_rms": float(np.sqrt(np.mean(diff ** 2))),
        "loss_gap": loss_gap,
        "lossgrad_rows": float((~(rows <= 0.5)).double().mean()),
        "grad_gap": ref.worst_leaf(seen["grad"], ref_grad),
        "change_gap": ref.worst_leaf(seen["change"], ref_change, moved),
        "stats_gap": ref.worst_leaf(seen["stat_change"], ref_stats)}
    for name, value in numbers.items():
        checks.add(name, value)
