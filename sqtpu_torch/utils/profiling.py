"""Profiling helpers: a ``torch.profiler`` trace of a whole run, a step
timer fenced on the device, the card's memory statistics and its
``nvidia-smi`` name and power limit.

Counterpart of ``sqtpu/utils/profiling.py``. :func:`trace` records the
host's operators and, with a card, its kernels (CUPTI), and writes one
Chrome/TensorBoard trace (``<host>_<pid>.<time>.pt.trace.json``) into
``log_dir`` when the block ends; every event stays in host memory until
then, so trace short runs. The trainer's ``profile_dir`` wraps the whole
run in it, as the JAX package's does.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU activity, and CUDA's when torch sees a card)
    and write its trace into ``log_dir`` at the end."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Wall-clock step times, each ended by a fence: a synchronize of the
    card (when ``device`` is a CUDA device) before the clock is read."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.times: list[float] = []
        self._t0 = None

    def _fence(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._fence()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self._fence()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def median(self) -> float:
        return sorted(self.times)[len(self.times) // 2] if self.times else 0.0


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card, the label
    every measurement on it carries."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return res.stdout.strip().splitlines()[0]


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of every card torch sees, by name
    (``cuda:0``, ...); empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
