"""What the traced run reads off the card: ``torch.profiler``'s events
over a few steps of the window, and CUDA events around calls into the
program's public functions.

:class:`Profiler` records the host's operators and the card's kernels
(CUPTI) over a number of steps after one of warm-up, fenced at both
ends, exports them as a Chrome trace into the run's temporary
directory, reads the file back and deletes it. :func:`summarize` reduces
the events of such a trace (dicts with ``cat``, ``name``, ``ts`` and
``dur`` in µs) to what the per-layer metrics read: the card's busy time
(the union of its operations' intervals), the traced span, each kernel's
device time by name, and the LABELLED longest idle gaps, each labelled
with the innermost host operator running when it began and summed by
label.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
LABELLED = 200      # the longest idle gaps that are labelled and grouped


def summarize(events: list) -> dict:
    """Seconds of the traced span, of device work (the union of the
    device intervals), device time by operation name, the longest idle
    gaps between device work grouped by the innermost host operator
    running at their start; all in seconds."""
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
                 for e in events if e.get("cat") in DEVICE_CATS
                 and "ts" in e)
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
                  for e in events if e.get("cat") == "cpu_op" and "ts" in e)
    stamps = [t for s, e, _ in dev + host for t in (s, e)]
    if not dev or not stamps:
        return {"span_s": 0.0, "busy_s": 0.0, "by_name": {}, "gaps": []}
    span = (max(stamps) - min(stamps)) * 1e-6
    by_name = defaultdict(float)
    merged = []
    for s, e, name in dev:
        by_name[name] += (e - s) * 1e-6
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-6
    idle = sorted(((nxt - end, end) for (_, end), (nxt, _)
                   in zip(merged, merged[1:])), reverse=True)[:LABELLED]
    gaps = defaultdict(float)
    for length, end in idle:
        running = [h for h in host if h[0] <= end < h[1]]
        label = max(running)[2] if running else "host: no operator"
        gaps[label] += length * 1e-6
    return {"span_s": span, "busy_s": busy, "by_name": dict(by_name),
            "gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]}


def kernel_seconds(summary: dict, needle: str) -> float:
    """Device seconds of the operations whose name holds ``needle``."""
    return sum(s for name, s in summary["by_name"].items() if needle in name)


def breakdown(summary: dict) -> dict:
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in summary["gaps"]]}


class Profiler:
    """``torch.profiler`` over the host and the card: one warm-up step,
    whose events are dropped, then ``steps`` recorded steps, each ended
    by :meth:`step`; fenced at both ends."""

    def __init__(self, device, steps: int):
        self.device = device
        self.steps = steps
        self.prof = None
        self.summary = None

    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        self._sync()
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities, schedule=schedule(
            wait=0, warmup=1, active=self.steps, repeat=1))
        self.prof.__enter__()

    def step(self) -> None:
        if self.prof.step_num in (0, self.steps):  # the recorded steps' ends
            self._sync()
        self.prof.step()

    def run(self, fn) -> dict:
        """``fn()`` once to warm up and ``steps`` times recorded; returns
        the summary of the recorded steps."""
        self.start()
        for _ in range(self.steps + 1):
            fn()
            self.step()
        return self.stop()

    def stop(self) -> dict:
        self._sync()
        self.prof.__exit__(None, None, None)
        path = os.path.join(tempfile.gettempdir(), "perfbench_trace.json")
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            if os.path.exists(path):
                os.remove(path)
        self.prof = None
        self.summary = summarize(events)
        return self.summary


class _HostEvent:
    """A CUDA event's stand-in on the CPU: the host clock at record."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Spans:
    """CUDA events around each call of a named function (host clock
    stand-ins on the CPU): the device milliseconds between the two events
    of each call, by name, after :meth:`read`."""

    def __init__(self, device):
        self.device = device
        self.pairs = defaultdict(list)

    def _event(self):
        import torch

        if self.device.type == "cuda":
            return torch.cuda.Event(enable_timing=True)
        return _HostEvent()

    def around(self, name: str, fn, *args, **kwargs):
        start, end = self._event(), self._event()
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        self.pairs[name].append((start, end))
        return out

    def read(self) -> dict:
        """Milliseconds of each call, by name (after a synchronize)."""
        return {name: [s.elapsed_time(e) for s, e in pairs]
                for name, pairs in self.pairs.items()}
