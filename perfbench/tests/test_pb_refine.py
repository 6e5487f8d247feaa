"""The corrector's cell on the CPU: each fault that :mod:`perfbench.faults`
plants makes the run incorrect and the run left alone stays correct; the
readers of the new per-layer metrics on known records and spans; the
corrector's reference and loader import nothing of the program.

The faults: ``one_pass``, ``stale_render`` and ``readings``'s
``prediction`` in the corrector's closed loop. The configuration runs in
float32 at the tiny size (:mod:`perfbench.tests.tiny`)."""

from __future__ import annotations

import os
import subprocess
import sys
import types

import pytest
import torch

from perfbench import faults, harness, program_spans
from perfbench.tests import tiny

CPU = torch.device("cpu")
EVAL = "c4r2-fp32.eval-closed-loop"
MODES = ("program", "one_pass", "stale_render", "prediction")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    base = tiny.make_root(tmp_path_factory.mktemp("refine"),
                          dtype="float32")
    tiny._update(os.path.join(base, "perfbench", "traffic",
                              "eval-closed-loop-refine.json"),
                 config={"batch_size": 4, "image_size": 64,
                         "acc_render_size": 16})
    yield base
    torch.set_num_threads(old)


@pytest.mark.parametrize("mode", MODES)
def test_a_fault_makes_the_run_incorrect(root, mode):
    cell = harness.Cell(EVAL, root)
    reading = faults.read(cell, mode, 2147483713, 0.3, CPU)
    assert reading["correct"] is (mode == "program"), reading["numbers"]


def _reader(name):
    return harness.load_module(
        os.path.join(harness.PKG, "metrics", name + ".py"),
        "perfbench_metric_" + name.replace(".", "_"))


def _span(calls, device_ms):
    return {"calls": calls, "device_ms": device_ms, "self_ms": device_ms,
            "host_ms": device_ms, "gap_before_ms": 0.0,
            "gap_before_calls": 0, "parents": {None: calls}}


@pytest.mark.parametrize("name,want", [("refine_base_ms.eval", 22.0),
                                       ("refine_render_ms.eval", 3.0),
                                       ("refine_pass_ms.eval", 48.0)])
def test_the_corrector_readers_on_known_totals(monkeypatch, name, want):
    known = {"eval.predict": _span(3, 220.0), "refine.base": _span(3, 66.0),
             "refine.render": _span(6, 9.0), "refine.pass": _span(6, 144.0)}
    stub = types.SimpleNamespace(span_totals=lambda: known)
    monkeypatch.setitem(sys.modules, program_spans.MODULE, stub)
    assert _reader(name).read({}) == pytest.approx(want)
    # a program whose corrector has no spans reads nothing
    stub.span_totals = lambda: {"eval.predict": _span(3, 220.0)}
    assert _reader(name).read({}) is None


def test_the_k3_reader_on_known_records():
    k3 = _reader("k3_roofline.eval")
    assert k3.read({"kernel_s": {"K3": 2e-3},
                    "bound_ms": {"K3": 0.05}}) == pytest.approx(2.5)
    assert k3.read({"kernel_s": {"K3": 0.0}, "bound_ms": {"K3": 0.05}}) \
        is None
    assert k3.read({}) is None


def test_the_corrector_reference_imports_nothing_of_the_program():
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import perfbench.reference.refiner, perfbench.weights_refine\n"
         "bad = [m for m in sys.modules if m.split('.')[0] in\n"
         "       ('sqtpu_torch', 'sqtpu', 'jax', 'jaxlib', 'flax', 'optax')]\n"
         "print(bad)\n"],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=tiny.REPO))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
