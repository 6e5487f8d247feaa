"""The port's multi-rank gates and its trainer over two ranks on the CPU.

* ``sqtpu_torch.parallel.dryrun`` at two gloo ranks: one train step of
  each layout against one rank (loss within 1e-5 relative, gradient norm
  within 1e-3 relative, the JAX package's gates) and the 20-step
  convergence gate (loss and validation IoU within 1e-2, BatchNorm
  statistics within 0.05 of their scale).
* ``python -m torch.distributed.run --nproc_per_node 2 -m
  sqtpu_torch.train --n-grid 2 --device cpu`` at a toy size: rank 0 alone
  logs and writes one set of checkpoints, and the run resumes from them.
"""

import json
import os
import subprocess
import sys

import numpy as np

from sqtpu_torch.parallel import dryrun

from test_torch_port_ops import _few_torch_threads  # noqa: F401
from test_torch_port_weights import ROOT


def test_dryrun_on_two_cpu_ranks(capsys):
    out = dryrun.dryrun(2, "cpu")
    printed = capsys.readouterr().out
    for name in dryrun.LAYOUTS:
        assert f"dryrun ok [{name}]" in printed
        assert len(out[name]) == 2
    assert "convergence gate ok" in printed
    assert out["grid-sharded-kernel"][0]["layout"] == (1, 2)
    assert out["kernel-dp"][0]["layout"] == (2, 1)
    assert out["refine-dp"][0]["layout"] == (2, 1)  # the Slice D corrector


# ---- the trainer through the launcher ---------------------------------------

def _launch(ckpt, *extra):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "sqtpu_torch.train",
           "--device", "cpu", "--n-grid", "2", "--batch-size", "4",
           "--image-size", "64", "--render-size", "16",
           "--acc-render-size", "16", "--steps-per-epoch", "2",
           "--val-steps", "1", "--log-interval", "1", "--ckpt-dir",
           str(ckpt), *extra]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout


def test_trainer_on_two_ranks_through_the_launcher(tmp_path):
    ckpt = tmp_path / "grid"
    out = _launch(ckpt, "--max-epochs", "2")
    assert out.count("mesh={'data': 1, 'grid': 2} backend=gloo") == 1
    assert out.count("Epoch 1:") == 1  # rank 0 alone logs
    for name in ("best.pt", "best.meta.json", "last.pt", "last.meta.json"):
        assert (ckpt / name).exists(), name
    assert sorted(os.listdir(ckpt / "compare")) == sorted(
        f"{i}_{k}.bmp" for i in range(4) for k in ("pred", "true"))
    lines = (ckpt / "train_metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1]
    assert all(np.isfinite(json.loads(line)["loss"]) for line in lines)
    meta = json.loads((ckpt / "last.meta.json").read_text())
    assert meta["epoch"] == 1 and meta["config"]["n_grid"] == 2

    out = _launch(ckpt, "--max-epochs", "3", "--continue-training",
                  "--resume-from", "last")
    assert out.count("Continuing with training") == 1
    lines = (ckpt / "train_metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1, 2]
    assert json.loads((ckpt / "last.meta.json").read_text())["epoch"] == 2
