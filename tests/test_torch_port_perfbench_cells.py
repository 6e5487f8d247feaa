"""The benchmark's cell of the corrector (``c4r2-fp32.eval-closed-loop``),
run end to end by name on the CPU at a tiny size (64² images, batches of
4, ``perfbench/tests/tiny.py``) in a fresh Python with a temporary
directory of its own (the profiler's trace is written there under a fixed
name), as the benchmark runs it, untraced and traced: the run exits 0
with a correct result line that holds the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics read from the CPU
(``--trace 1``), loads no module of JAX or of the JAX package, and leaves
every file of the benchmark as it was."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from perfbench.tests import tiny

REPO = tiny.REPO
CELL = "c4r2-fp32.eval-closed-loop"
METRICS = {0: ("setup_s", "eval_imgs_per_s"),
           1: ("refine_base_ms.eval", "refine_render_ms.eval",
               "refine_pass_ms.eval", "net_ms.eval")}


def tiny_root(tmp) -> str:
    """``tiny.make_root`` in float32, with the corrector's traffic cut as
    the closed loop's is."""
    root = tiny.make_root(tmp, dtype="float32")
    tiny._update(os.path.join(root, "perfbench", "traffic",
                              "eval-closed-loop-refine.json"),
                 config={"batch_size": 4, "image_size": 64,
                         "acc_render_size": 16})
    return root


def _digests(root: str) -> dict:
    out = {}
    for dp, _, files in os.walk(os.path.join(root, "perfbench")):
        for name in files:
            if not name.endswith(".pyc"):
                path = os.path.join(dp, name)
                with open(path, "rb") as f:
                    out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.mark.parametrize("trace", sorted(METRICS))
def test_a_new_cell_runs_by_name_on_the_cpu(tmp_path, trace):
    root = tiny_root(tmp_path)
    before = _digests(root)
    code = ("import sys, torch\n"
            "torch.set_num_threads(2)\n"
            "from perfbench import run, harness\n"
            f"rc = run.main(['--workload', {CELL!r}, '--seed',\n"
            "               '3000000019', '--seconds', '0.3', '--trace',\n"
            f"               '{trace}'], torch.device('cpu'), {root!r})\n"
            "print('RC', rc, harness.forbidden_loaded())\n")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                 TMPDIR=str(tmp_path)))
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "RC 0 []", res.stderr[-3000:]
    line = json.loads(lines[-2])
    assert line["correct"] is True, line["checks"]
    for name in METRICS[trace]:
        value = line["metrics"][name]["value"]
        assert value >= 0 and value == value, (name, value)
    assert _digests(root) == before
