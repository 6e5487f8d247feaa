"""A copy of the benchmark at a size the CPU runs in seconds: the cells'
files as they are, with the configurations cut to batch 4, 64² images and
16³ loss lattices, and the closed loop to batches of 4 scored at 16³."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = {"batch_size": 4, "image_size": 64, "render_size": 16}


def _update(path: str, **kw) -> None:
    with open(path) as f:
        data = json.load(f)
    for key, value in kw.items():
        if isinstance(value, dict):
            data.setdefault(key, {}).update(value)
        else:
            data[key] = value
    with open(path, "w") as f:
        json.dump(data, f)


def make_root(tmp, dtype: str | None = None) -> str:
    """The tiny copy under ``tmp``; ``dtype`` replaces the configurations'
    compute dtype."""
    root = os.path.join(str(tmp), "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "artifacts"),
               os.path.join(root, "artifacts"))
    configs = os.path.join(root, "perfbench", "configs")
    for name in os.listdir(configs):
        extra = {"dtype": dtype} if dtype else {}
        _update(os.path.join(configs, name), **TINY, **extra)
    _update(os.path.join(root, "perfbench", "traffic",
                         "eval-closed-loop.json"),
            config={"batch_size": 4, "image_size": 64,
                    "acc_render_size": 16})
    return root
