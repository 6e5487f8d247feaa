"""The port's spans (:mod:`sqtpu_torch.utils.profiling`) on the CPU: off,
they record nothing; under ``torch.profiler`` (after its warm-up step) and
inside ``record_spans()`` they land in the trace and in ``span_totals()``
with their parents, self times and the gaps between root calls; the train
step's four parts tile it; and collecting changes no bit of what the
train step and the closed loop compute."""

import contextlib
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from sqtpu_torch import evaluate
from sqtpu_torch.data.synthetic import make_batch, sample_params
from sqtpu_torch.models import build_model
from sqtpu_torch.ops import metrics
from sqtpu_torch.ops.kernels import render_hard_auto
from sqtpu_torch.training import loop as tloop
from sqtpu_torch.training.state import create_train_state
from sqtpu_torch.utils import profiling
from sqtpu_torch.utils.config import MODEL_DTYPES, TrainConfig
from sqtpu_torch.utils.profiling import record_spans, span, span_totals

from test_torch_port_ops import _few_torch_threads  # noqa: F401

PARTS = ("train.forward", "train.loss", "train.backward", "train.optimizer")
# the two benchmark recipes at a size the CPU runs in a second
RECIPES = {
    "ssl-bf16": dict(loss="implicit", render_size=16, dtype="bfloat16",
                     learning_rate=1e-4),
    "c4c-fp32": dict(loss="explicit_sym", render_size=16, explicit_sharp=20.0,
                     gauge_weight=2.0, elong_weight=1.5, remat=True,
                     learning_rate=5e-6),
}
SIZE, BATCH = 64, 2


def _trainee(recipe: str, **extra):
    """(step, model, batches) of a tiny train step of ``recipe``; the same
    weights and batches every call."""
    cfg = TrainConfig(batch_size=BATCH, image_size=SIZE, device="cpu",
                      **RECIPES[recipe], **extra)
    torch.manual_seed(0)
    net = build_model("resnet_sq", SIZE, dtype=MODEL_DTYPES[cfg.dtype])
    step = tloop.make_train_step(create_train_state(net, cfg), cfg)
    gen = torch.Generator().manual_seed(7)
    return step, net, lambda: make_batch(gen, BATCH, SIZE)


def _eval_batch(net, gen):
    """One batch of the closed loop, in ``evaluate``'s order: the five
    results read back to the host."""
    p_true = sample_params(BATCH, gen)
    imgs = render_hard_auto(p_true, SIZE, n_sweep=64, n_bisect=16,
                            quantize=True)[..., None]
    p_pred = evaluate.predict(net, imgs)
    triple = metrics.iou_full(p_true, p_pred, 16)
    mae = torch.abs(p_pred - p_true)
    aligned, _ = metrics.gauge_align(p_true, p_pred)
    return [x.detach().numpy() for x in (p_true, p_pred, triple, mae,
                                          aligned)]


def _eval_loop():
    torch.manual_seed(1)
    net = build_model("resnet_sq", SIZE).eval()
    return net, torch.Generator().manual_seed(11)


def test_off_a_span_records_nothing(monkeypatch):
    """With no profiler and no ``record_spans()``, a train step and an eval
    batch create no event and enter no ``record_function``; inside
    ``record_spans()`` the same stand-ins count every span."""
    calls = {"event": 0, "record_function": 0}
    real_event, real_rf = profiling._event, torch.profiler.record_function

    def event(cuda):
        calls["event"] += 1
        return real_event(cuda)

    def record_function(name):
        calls["record_function"] += 1
        return real_rf(name)

    monkeypatch.setattr(profiling, "_event", event)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    step, _, draw = _trainee("c4c-fp32")
    net, gen = _eval_loop()
    with record_spans():
        pass                        # an empty collection: the latest
    with torch.no_grad():
        _eval_batch(net, gen)
    step(*draw())
    assert calls == {"event": 0, "record_function": 0}
    assert span_totals() == {}

    with record_spans():
        step(*draw())
        with torch.no_grad():
            _eval_batch(net, gen)
    totals = span_totals()
    spans = sum(t["calls"] for t in totals.values())
    assert calls == {"event": 2 * spans, "record_function": spans}
    assert totals["train.step"]["calls"] == 1
    assert totals["eval.predict"]["calls"] == 1
    # 3 IoUs a batch of 5 fields, each field's grid built once
    assert totals["metrics.voxels"]["calls"] == 5


def test_under_the_profiler_spans_land_in_the_trace_of_recorded_steps(
        tmp_path):
    """A CPU ``torch.profiler`` session with one warm-up step and two
    recorded ones: each span is a ``user_annotation`` of the exported
    trace, twice, and ``span_totals()`` counts the same two steps."""
    step, _, draw = _trainee("c4c-fp32")
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=2, repeat=1))
    with prof:
        for _ in range(3):
            step(*draw())
            prof.step()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    want = ("train.step", *PARTS, "data.make_batch", "data.sample",
            "ops.render_hard")
    assert {n: names.count(n) for n in want} == dict.fromkeys(want, 2)
    totals = span_totals()
    assert {n: totals[n]["calls"] for n in want} == dict.fromkeys(want, 2)
    assert totals["data.sample"]["parents"] == {"data.make_batch": 2}
    assert totals["train.loss"]["parents"] == {"train.step": 2}


def test_parents_self_times_gaps_and_a_fresh_collection():
    """A known nesting on the host clock: the parents by name, a parent's
    self time its duration less its children's, the wait before the
    second root call; a second collection holds only its own spans."""
    with record_spans():
        for _ in range(2):
            with span("outer"):
                with span("inner"):
                    time.sleep(0.02)
                with span("inner"):
                    time.sleep(0.01)
                time.sleep(0.005)
            time.sleep(0.015)
    t = span_totals()
    assert t["outer"]["parents"] == {None: 2}
    assert t["inner"]["parents"] == {"outer": 4}
    assert t["inner"]["calls"] == 4 and t["inner"]["device_ms"] >= 60
    assert t["inner"]["self_ms"] == t["inner"]["device_ms"]
    assert t["outer"]["self_ms"] == pytest.approx(
        t["outer"]["device_ms"] - t["inner"]["device_ms"])
    assert 10 <= t["outer"]["self_ms"] < t["outer"]["device_ms"]
    assert t["outer"]["host_ms"] >= t["outer"]["device_ms"] * 0.99
    assert t["outer"]["gap_before_calls"] == 1
    assert t["outer"]["gap_before_ms"] >= 15
    assert t["inner"]["gap_before_calls"] == 0

    with record_spans():
        with span("alone"):
            pass
    assert set(span_totals()) == {"alone"}


def test_completed_root_calls_are_folded_as_the_run_goes():
    """Root calls whose end has completed leave no record behind: only
    totals grow with the calls."""
    with record_spans():
        for _ in range(50):
            with span("outer"):
                with span("inner"):
                    pass
        assert profiling._current.pending == []
    assert span_totals()["inner"]["calls"] == 50


def test_the_four_parts_tile_the_train_step(tmp_path):
    """In the profiler's trace the step's four parts follow each other in
    order and cover its host interval end to end, up to the profiler's own
    few microseconds between them; ``span_totals()`` agrees."""
    step, _, draw = _trainee("ssl-bf16")
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=2, repeat=1))
    with prof:
        for _ in range(3):
            step(*draw())
            prof.step()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ann = [e for e in json.load(f)["traceEvents"]
               if e.get("cat") == "user_annotation"]
    steps = sorted((e for e in ann if e["name"] == "train.step"),
                   key=lambda e: e["ts"])
    parts = sorted((e for e in ann if e["name"] in PARTS),
                   key=lambda e: e["ts"])
    assert len(steps) == 2 and len(parts) == 8
    for i, s in enumerate(steps):
        mine = parts[4 * i:4 * i + 4]
        assert tuple(e["name"] for e in mine) == PARTS
        edges = [s["ts"]] + [x for e in mine
                             for x in (e["ts"], e["ts"] + e["dur"])]
        edges.append(s["ts"] + s["dur"])
        gaps = [b - a for a, b in zip(edges[::2], edges[1::2])]
        assert all(g >= 0 for g in gaps)
        assert sum(gaps) <= 0.02 * s["dur"]
    t = span_totals()
    assert sum(t[p]["device_ms"] for p in PARTS) == pytest.approx(
        t["train.step"]["device_ms"], rel=0.02)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_collecting_changes_no_bit_of_the_train_step(recipe):
    """Two steps from the same weights and batches, with spans off and
    collected: the losses, every parameter and every BatchNorm statistic
    equal bit for bit."""
    out = []
    for collect in (False, True):
        step, net, draw = _trainee(recipe)
        with record_spans() if collect else contextlib.nullcontext():
            losses = [step(*draw()) for _ in range(2)]
        out.append((losses, {k: v.detach().clone()
                             for k, v in net.state_dict().items()}))
    (l_off, s_off), (l_on, s_on) = out
    assert span_totals()["train.step"]["calls"] == 2
    assert all(torch.equal(a, b) for a, b in zip(l_off, l_on))
    assert s_off.keys() == s_on.keys()
    assert all(torch.equal(s_off[k], s_on[k]) for k in s_off), [
        k for k in s_off if not torch.equal(s_off[k], s_on[k])]


def test_collecting_changes_no_bit_of_an_eval_batch():
    out = []
    for collect in (False, True):
        net, gen = _eval_loop()
        with record_spans() if collect else contextlib.nullcontext(), torch.no_grad():
            out.append(_eval_batch(net, gen))
    assert span_totals()["metrics.iou_full"]["calls"] == 1
    for a, b in zip(*out):
        assert a.tobytes() == b.tobytes()


def test_the_skip_path_closes_every_span(monkeypatch):
    """``nan_policy="skip"`` with a non-finite loss returns from inside
    ``train.step`` after ``train.loss``: every span is closed, and no
    backward or optimizer span ran."""
    def nan_loss(cfg, pred, imgs, labels, layout):
        return pred.float().sum() * float("nan")

    monkeypatch.setattr(tloop, "_compute_loss", nan_loss)
    step, _, draw = _trainee("c4c-fp32", nan_policy="skip")
    with record_spans():
        loss = step(*draw())
        assert profiling._stack() == []
    assert not torch.isfinite(loss)
    t = span_totals()
    assert {n: t[n]["calls"] for n in t if n.startswith("train.")} == {
        "train.step": 1, "train.forward": 1, "train.loss": 1}


def test_the_trainers_profile_dir_trace_carries_the_spans(tmp_path):
    """``profile_dir``: the trainer's trace holds the train step's spans
    and the online data's."""
    from sqtpu_torch.training.loop import train

    prof = tmp_path / "prof"
    cfg = TrainConfig(batch_size=2, image_size=32, render_size=8,
                      acc_render_size=8, max_epochs=1, steps_per_epoch=2,
                      val_steps=1, compare_images=0, loss="supervised",
                      data="online", ckpt_dir=str(tmp_path / "run"),
                      profile_dir=str(prof), device="cpu")
    train(cfg)
    (path,) = list(prof.glob("*.pt.trace.json"))
    with open(path) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count("train.step") == 2
    assert all(names.count(p) == 2 for p in PARTS)
    assert names.count("data.make_batch") >= 2
