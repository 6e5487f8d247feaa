"""The per-layer metrics that read the program's own spans
(``sqtpu_torch.utils.profiling.span_totals``): each reader on known
totals, and with no module to read; tiny CPU runs of the three cells,
which print every such metric of the cell with ``--trace 1`` and none,
collecting nothing, with ``--trace 0``."""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import types

import pytest
import torch

from perfbench import harness, program_spans
from perfbench.tests import tiny

CPU = torch.device("cpu")
TRAIN = ("fwd_ms.train", "loss_ms.train", "bwd_ms.train", "opt_ms.train",
         "make_batch_ms.train")
EVAL = ("net_ms.eval", "voxels_ms.eval", "iou_self_ms.eval",
        "outside_ms.eval")


def _span(calls, device_ms, self_ms=None, gap_ms=0.0, gaps=0):
    return {"calls": calls, "device_ms": device_ms,
            "self_ms": device_ms if self_ms is None else self_ms,
            "host_ms": device_ms, "gap_before_ms": gap_ms,
            "gap_before_calls": gaps, "parents": {None: calls}}


KNOWN = {
    "train.step": _span(4, 400.0, self_ms=2.0),
    "train.forward": _span(4, 120.0),
    "train.loss": _span(4, 40.0),
    "train.backward": _span(4, 200.0),
    "train.optimizer": _span(4, 38.0),
    "data.make_batch": _span(4, 20.0, self_ms=1.0),
    "eval.predict": _span(3, 66.0),
    "metrics.iou_full": _span(3, 480.0, self_ms=30.0),
    "metrics.voxels": _span(144, 450.0),
    "data.sample": _span(3, 3.0, gap_ms=9.0, gaps=2),
}
WANT = {"fwd_ms.train": 30.0, "loss_ms.train": 10.0, "bwd_ms.train": 50.0,
        "opt_ms.train": 9.5, "make_batch_ms.train": 5.0,
        "net_ms.eval": 22.0, "voxels_ms.eval": 150.0,
        "iou_self_ms.eval": 10.0, "outside_ms.eval": 4.5}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _reader(name):
    return harness.load_module(
        os.path.join(harness.PKG, "metrics", name + ".py"),
        "perfbench_metric_" + name.replace(".", "_"))


def test_the_nine_entries_read_program_spans():
    spec = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in TRAIN + EVAL:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["moves"] == ("train_imgs_per_s" if name.endswith(".train")
                              else "eval_imgs_per_s")


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_on_known_totals(monkeypatch, name):
    stub = types.SimpleNamespace(span_totals=lambda: KNOWN)
    monkeypatch.setitem(sys.modules, program_spans.MODULE, stub)
    assert _reader(name).read({}) == pytest.approx(WANT[name])
    # a collection without the spans the reader needs
    stub.span_totals = lambda: {"other": _span(1, 1.0)}
    assert _reader(name).read({}) is None
    # a program without spans: the module is there, span_totals is not
    monkeypatch.setitem(sys.modules, program_spans.MODULE,
                        types.SimpleNamespace())
    assert _reader(name).read({}) is None
    monkeypatch.delitem(sys.modules, program_spans.MODULE)
    assert _reader(name).read({}) is None


def _run(root, cell, trace_on):
    from perfbench import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", cell, "--seed", "2147483999",
                       "--seconds", "0.3", "--trace", str(trace_on)],
                      device=CPU, root=root)
    return rc, json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.parametrize("cell", ["ssl-bf16.train-online",
                                  "c4c-fp32.train-online",
                                  "c4c-fp32.eval-closed-loop"])
def test_a_tiny_run_prints_its_span_metrics_only_when_traced(tmp_path,
                                                             cell):
    from sqtpu_torch.utils.profiling import record_spans, span_totals

    root = tiny.make_root(tmp_path)
    new = TRAIN if ".train" in cell else EVAL
    rc, line = _run(root, cell, 1)
    assert rc == 0
    for name in new:
        value = line["metrics"][name]["value"]
        assert value >= 0 and value == value, (name, value)
    totals, params = span_totals(), harness.Cell(cell, root).params
    if ".train" in cell:
        assert totals["train.step"]["calls"] == params["trace_steps"]
    else:
        assert totals["eval.predict"]["calls"] == params["trace_batches"]

    with record_spans():
        pass                    # an empty collection, the latest
    rc, line = _run(root, cell, 0)
    assert rc == 0 and not set(line["metrics"]) & set(TRAIN + EVAL)
    assert span_totals() == {}
