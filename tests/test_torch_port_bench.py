"""The port's bench (``python -m sqtpu_torch.bench``) against the JAX
package's ``bench.py``, read as source (an AST pass; importing it would
start the TPU bench).

* every measurement's ``TrainConfig`` equals the one ``bench.py`` builds
  (the port's config field for field, and the JAX package's config on
  their common fields), and its model computes in the same dtype;
* the printed line has ``bench.py``'s keys, less ``vs_baseline``, plus
  ``detail.device`` (the card's name and power limit);
* ``python -m sqtpu_torch.bench --device cpu`` at batch 2 and one timed
  step (all nine measurements, each with its three untimed steps: about
  40 s on two threads) prints exactly one JSON line with finite rates
  above 0, and imports neither jax nor ``sqtpu``.
"""

import ast
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from sqtpu.utils.config import TrainConfig as JaxTrainConfig
from sqtpu_torch import bench
from sqtpu_torch.utils.config import TrainConfig

from test_torch_port_ops import _few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(ROOT, "bench.py")
# bench.py's TrainConfig calls, in source order, by the port's names
ORDER = ("headline", "explicit96", "explicit128", "explicit128_sharp20",
         "explicit128_sharp20_bf16", "sp_implicit128_pallas",
         "sp_implicit128_jnp")
BATCH = 7


def _tree():
    with open(JAX_BENCH) as f:
        return ast.parse(f.read())


def _value(node, names: dict):
    """A keyword's value: a constant, a name bench.py assigns a constant
    to (``BATCH`` stands for the batch under test), or ``jnp.<dtype>``."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        return names[node.id]
    if isinstance(node, ast.Attribute) and node.value.id == "jnp":
        return node.attr
    raise AssertionError(f"unexpected value {ast.dump(node)}")


def jax_bench_configs():
    """(TrainConfig kwargs, model dtype) of each ``TrainConfig(...)`` call
    of bench.py, in source order. The headline's model is the ``model =
    ResNetSQ(dtype=...)`` assignment; a ``time_step`` call's is its
    ``model_dtype`` (float32 when it has none)."""
    tree = _tree()
    names = {"BATCH": BATCH}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)):
            names[node.targets[0].id] = node.value.value
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    headline_dtype = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "model"
                and node.value.func.id == "ResNetSQ"):
            headline_dtype = _value(node.value.keywords[0].value, names)
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "id", "") == "TrainConfig"):
            continue
        kw = {k.arg: _value(k.value, names) for k in node.keywords}
        parent = parents[node]
        if (isinstance(parent, ast.Call)
                and getattr(parent.func, "id", "") == "time_step"):
            dtype = "float32"
            for k in parent.keywords:
                if k.arg == "model_dtype":
                    dtype = _value(k.value, names)
        else:
            dtype = headline_dtype
        out.append((node.lineno, kw, dtype))
    return [(kw, dtype) for _, kw, dtype in sorted(out, key=lambda t: t[0])]


def test_bench_py_has_the_seven_configs():
    got = jax_bench_configs()
    assert len(got) == len(ORDER) == len(bench.configs(BATCH))
    assert list(bench.configs(BATCH)) == list(ORDER)


@pytest.mark.parametrize("index,name", list(enumerate(ORDER)))
def test_config_and_model_dtype_match_bench_py(index, name):
    kw, model_dtype = jax_bench_configs()[index]
    got = bench.configs(BATCH)[name]
    assert got == TrainConfig(**kw)
    want_jax = JaxTrainConfig(**kw)
    common = ({f.name for f in dataclasses.fields(JaxTrainConfig)}
              & {f.name for f in dataclasses.fields(TrainConfig)})
    assert len(common) > 40
    for field in sorted(common):
        assert getattr(got, field) == getattr(want_jax, field), field
    model = bench.seeded_model(got, bench.STATE_SEED, torch.device("cpu"))
    want = None if model_dtype == "float32" else getattr(torch, model_dtype)
    dtypes = {m.compute_dtype for m in model.modules()
              if hasattr(m, "compute_dtype")}
    assert dtypes == {want}


def test_seeded_model_is_its_seed_s():
    cfg = bench.configs(BATCH)["explicit96"]
    cpu = torch.device("cpu")
    a, b, c = (bench.seeded_model(cfg, s, cpu).state_dict()
               for s in (3, 3, 0))
    assert all(torch.equal(a[k], b[k]) for k in a)
    weights = [k for k in a if k.endswith("weight") and a[k].ndim > 1]
    assert weights and not any(torch.equal(a[k], c[k]) for k in weights)


@pytest.fixture(scope="module")
def cpu_run():
    """``python -m sqtpu_torch.bench --device cpu`` at batch 2, one timed
    step, two threads; its stdout and the modules it imported."""
    code = ("import runpy, sys\n"
            "sys.argv = ['sqtpu_torch.bench', '--device', 'cpu']\n"
            "runpy.run_module('sqtpu_torch.bench', run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'sqtpu'))\n"
            "print('MODULES ' + ' '.join(bad), file=sys.stderr)\n")
    env = dict(os.environ, SQTPU_BENCH_BATCH="2", SQTPU_BENCH_ITERS="1",
               OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    modules = [ln for ln in res.stderr.splitlines()
               if ln.startswith("MODULES")]
    return res.stdout, modules


def test_printed_keys_are_bench_py_s(cpu_run):
    stdout, _ = cpu_run
    line = json.loads(stdout)
    sys.path.insert(0, ROOT)
    import chip_smoke

    top, detail = chip_smoke.jax_bench_keys()
    assert set(line) == top - {"vs_baseline"}
    assert set(line["detail"]) == detail | {"device"}
    assert line["detail"]["device"] == "cpu"
    assert line["detail"]["n_chips"] == 1
    assert line["detail"]["batch"] == 2


def test_cpu_run_prints_one_line_of_finite_rates(cpu_run):
    stdout, modules = cpu_run
    lines = stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    rates = [line["value"]] + [v for k, v in line["detail"].items()
                               if k.endswith("_per_chip")
                               or k in ("imgs_per_sec_total",
                                        "loss_point_evals_per_sec")]
    assert len(rates) == 11
    assert all(math.isfinite(r) and r > 0 for r in rates)
    assert math.isfinite(line["detail"]["final_loss"])
    assert modules == ["MODULES "]


def test_resident_batch_is_its_seed_s():
    cpu = torch.device("cpu")
    (a, la), (b, lb) = (bench.resident_batch(cpu, 2) for _ in range(2))
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert a.shape == (2, bench.IMAGE, bench.IMAGE, 1) and a.max() > 0


def test_bench_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
