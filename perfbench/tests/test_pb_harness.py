"""The harness on the CPU: cells, configurations, traffic and metrics found
by name from files of their own; the result line's keys; the trace's
reduction; the check for modules of JAX and of the JAX package; a
reference that imports nothing of the program."""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import harness, trace
from perfbench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _run(root, argv):
    """``perfbench.run`` on the CPU in this process: (rc, stdout lines)."""
    from perfbench import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(argv, device=CPU, root=root)
    return rc, out.getvalue().splitlines()


def test_every_entry_of_the_benchmark_has_its_files():
    spec = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    for w in spec["workloads"]:
        cell = harness.Cell(w["name"])
        assert cell.chips == w["chips"]
        assert cell.params["why"] == w["why"]
        assert os.path.exists(cell.driver_path)
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_a_new_cell_config_traffic_and_metric_are_found_by_name(tmp_path):
    """Everything a later change adds is a new file and a new entry:
    nothing that is there is edited."""
    root = tiny.make_root(tmp_path, dtype="float32")
    pkg = os.path.join(root, "perfbench")
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, files in os.walk(pkg) for p in files
              if p.endswith((".py", ".json"))}
    conf = json.load(open(os.path.join(pkg, "configs",
                                       "resnet_sq-ssl-bf16.json")))
    conf.update(name="resnet_sq-ssl-fp32", batch_size=6)
    json.dump(conf, open(os.path.join(pkg, "configs",
                                      "resnet_sq-ssl-fp32.json"), "w"))
    traffic = json.load(open(os.path.join(pkg, "traffic",
                                          "train-online.json")))
    traffic["checked_steps"] = 2
    json.dump(traffic, open(os.path.join(pkg, "traffic",
                                         "train-twice.json"), "w"))
    json.dump({"why": "a cell added by files alone", "limits": {}},
              open(os.path.join(pkg, "cells", "ssl-fp32.train-twice.json"),
                   "w"))
    with open(os.path.join(pkg, "metrics", "steps_seen.train.py"), "w") as f:
        f.write("def read(record):\n    return float(record['steps'])\n")
    spec_path = os.path.join(root, "BENCHMARK.json")
    spec = json.load(open(spec_path))
    spec["configs"].append({"name": "resnet_sq-ssl-fp32",
                            "source": "a test", "reduced": [], "why": "test",
                            "file":
                            "perfbench/configs/resnet_sq-ssl-fp32.json"})
    spec["workloads"].append({"name": "ssl-fp32.train-twice",
                              "config": "resnet_sq-ssl-fp32",
                              "traffic": "train-twice", "chips": 1,
                              "why": "a cell added by files alone"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_imgs_per_s":
            m["workloads"].append("ssl-fp32.train-twice")
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "training.loop", "moves":
                              "train_imgs_per_s",
                              "workloads": ["ssl-fp32.train-twice"]})
    json.dump(spec, open(spec_path, "w"))

    cell = harness.Cell("ssl-fp32.train-twice", root)
    assert cell.config["batch_size"] == 6
    assert cell.traffic["checked_steps"] == 2
    assert [m["name"] for m in cell.per_layer] == ["steps_seen.train"]
    rc, lines = _run(root, ["--workload", "ssl-fp32.train-twice", "--seed",
                            "2147483701", "--seconds", "0.3", "--trace", "1"])
    line = json.loads(lines[-1])
    assert rc == 0 and line["metrics"]["steps_seen.train"]["value"] >= 1
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, files in os.walk(pkg) for p in files
             if p in before}
    assert after == before


@pytest.mark.parametrize("trace_on", [0, 1])
def test_the_result_line_has_the_contracts_keys(tmp_path, trace_on):
    root = tiny.make_root(tmp_path)
    rc, lines = _run(root, ["--workload", "c4c-fp32.eval-closed-loop",
                            "--seed", "3000000007", "--seconds", "0.3",
                            "--trace", str(trace_on)])
    line = json.loads(lines[-1])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    if trace_on:
        want.append("breakdown")
    assert rc == 0 and list(line) == want + ["checks"]
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    cell = harness.Cell("c4c-fp32.eval-closed-loop", root)
    names = {m["name"] for m in (cell.per_layer if trace_on
                                 else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace_on:
        assert set(line["metrics"]) == names
    for name, check in line["checks"].items():
        assert check["limit"] == cell.params["limits"][name]


def test_the_trace_reduction_on_known_intervals():
    """Two kernels overlapping, a memcpy, and two idle gaps labelled by
    the innermost host operator running when each begins."""
    ev = [
        {"cat": "cpu_op", "name": "step", "ts": 0.0, "dur": 1000.0},
        {"cat": "cpu_op", "name": "make_batch", "ts": 50.0, "dur": 150.0},
        {"cat": "kernel", "name": "hardrender_kernel", "ts": 100.0,
         "dur": 100.0},
        {"cat": "kernel", "name": "implicit_fwd_kernel", "ts": 150.0,
         "dur": 100.0},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 400.0,
         "dur": 50.0},
        {"cat": "kernel", "name": "implicit_bwd_kernel", "ts": 700.0,
         "dur": 300.0},
    ]
    s = trace.summarize(ev)
    assert s["span_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx((150 + 50 + 300) * 1e-6)
    assert trace.kernel_seconds(s, "implicit_") == pytest.approx(400e-6)
    assert dict(s["gaps"]) == pytest.approx({"step": 400e-6})
    idle = harness.load_module(
        os.path.join(harness.PKG, "metrics", "device_idle.train.py"), "m")
    assert idle.read({"trace": s}) == pytest.approx(50.0)
    k3 = harness.load_module(
        os.path.join(harness.PKG, "metrics", "k3_roofline.train.py"), "k3")
    assert k3.read({"kernel_s": {"K3": 100e-6},
                    "bound_ms": {"K3": 0.025}}) == pytest.approx(25.0)
    assert k3.read({"kernel_s": {}, "bound_ms": {}}) is None
    k12 = harness.load_module(
        os.path.join(harness.PKG, "metrics", "k1k2_roofline.train.py"), "k")
    assert k12.read({"kernel_s": {"K1": 1e-4, "K2": 3e-4},
                     "bound_ms": {"K1K2": 0.02}}) == pytest.approx(5.0)
    assert trace.summarize([{"cat": "cpu_op", "name": "x", "ts": 0,
                             "dur": 5}])["busy_s"] == 0.0


def test_the_forbidden_modules_are_named_by_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax",
             "sqtpu", "sqtpu.ops.render", "sqtpu_torch", "sqtpu_torch.ops",
             "jaxtyping", "flaxen", "optaxx", "numpy"]
    assert harness.forbidden_loaded(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax",
         "sqtpu", "sqtpu.ops.render"])


def _fresh_python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=tiny.REPO))


def test_the_reference_and_the_yardsticks_import_nothing_of_the_program():
    res = _fresh_python(
        "import sys\n"
        "import perfbench.reference.train, perfbench.reference.model\n"
        "import perfbench.counts.bounds, perfbench.weights, perfbench.trace\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('sqtpu_torch', 'sqtpu', 'jax', 'jaxlib', 'flax', 'optax')]\n"
        "print(bad)\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_a_run_loads_no_module_of_jax_or_the_jax_package(tmp_path):
    root = tiny.make_root(tmp_path)
    res = _fresh_python(
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from perfbench import run, harness\n"
        f"rc = run.main(['--workload', 'ssl-bf16.train-online', '--seed',\n"
        f"               '5', '--seconds', '0.3'], torch.device('cpu'),\n"
        f"              {root!r})\n"
        "print('RC', rc, harness.forbidden_loaded())\n")
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "RC 0 []"


def test_no_card_means_no_result(tmp_path):
    """Without a card, or in a checkout that holds only the benchmark's
    files, a run exits non-zero and prints no result."""
    root = tiny.make_root(tmp_path)
    os.unlink(os.path.join(root, "artifacts"))
    res = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "c4c-fp32.eval-closed-loop", "--seed", "1", "--seconds", "1"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert not res.stdout.strip()
