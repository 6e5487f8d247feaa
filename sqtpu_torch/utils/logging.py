"""Training observability: stdout progress, ``<run>_metrics.jsonl`` and the
non-finite-loss guard.

Counterpart of ``sqtpu/utils/logging.py``, with torch in place of jax.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch


class MetricLogger:
    """Metrics to ``<out_dir>/<run_name>_metrics.jsonl`` and messages to
    stdout. ``quiet`` (every rank but rank 0 of a multi-rank run) writes
    no file and prints nothing through :meth:`say`."""

    def __init__(self, out_dir: str = "", run_name: str = "train",
                 quiet: bool = False):
        self.out_dir = out_dir
        self.quiet = quiet
        self.path = (os.path.join(out_dir, f"{run_name}_metrics.jsonl")
                     if out_dir and not quiet else None)
        if self.path:
            os.makedirs(out_dir, exist_ok=True)
        self._t0 = time.time()

    def log(self, **kv):
        rec = {"t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if isinstance(
            v, (torch.Tensor, np.floating, np.ndarray)) else v)
            for k, v in kv.items()})
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def say(self, msg: str):
        if not self.quiet:
            self.line(msg)

    @staticmethod
    def progress(msg: str):
        sys.stdout.write("\033[K" + msg + "\r")
        sys.stdout.flush()

    @staticmethod
    def line(msg: str):
        sys.stdout.write("\033[K" + msg + "\n")
        sys.stdout.flush()


class NanGuard:
    """Counts non-finite losses. With policy ``skip`` the train step itself
    discards the update (see ``make_train_step``); this guard reports."""

    def __init__(self, policy: str = "warn"):
        if policy not in ("warn", "skip"):
            raise ValueError(f"nan_policy must be warn or skip, got "
                             f"{policy!r}")
        self.policy = policy
        self.count = 0

    def check(self, loss) -> bool:
        """Returns True if the step result should be kept."""
        ok = math.isfinite(float(loss))
        if not ok:
            self.count += 1
            MetricLogger.line(
                f"--------------- NON-FINITE LOSS (#{self.count}) "
                f"---------------")
            if self.policy == "skip":
                return False
        return True


class Throughput:
    """imgs/s meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._n = 0
        self._t0 = time.time()

    def update(self, n: int):
        self._n += n

    @property
    def rate(self) -> float:
        dt = time.time() - self._t0
        return self._n / dt if dt > 0 else 0.0
