"""Profiling of the port: named spans on the device's clock, a
``torch.profiler`` trace of a whole run, a step timer fenced on the device
and the card's ``nvidia-smi`` name and power limit.

Counterpart of ``sqtpu/utils/profiling.py``. :func:`trace` records the
host's operators and, with a card, its kernels (CUPTI), and writes one
Chrome/TensorBoard trace (``<host>_<pid>.<time>.pt.trace.json``) into
``log_dir`` when the block ends; every event stays in host memory until
then, so trace short runs. The trainer's ``profile_dir`` wraps the whole
run in it, as the JAX package's does.

**Spans.** ``with span(name):`` marks a phase of the program. The port
marks these, each where its own code runs:

* ``train.step``, the whole train step of
  :func:`sqtpu_torch.training.loop.make_train_step`, and its four parts,
  which tile it: ``train.forward`` (train mode, ``zero_grad``, the float32
  cast, the model), ``train.loss`` (the step's loss call: K1 or K4 and
  their glue), ``train.backward`` (``loss.backward()`` with K2 and the
  recompute of ``remat``, the gradients' average over ranks, the frozen
  base's zeroing) and ``train.optimizer`` (clip, Adam, the BatchNorm
  statistics' broadcast);
* ``data.make_batch`` and ``data.sample``
  (:mod:`sqtpu_torch.data.synthetic`), ``ops.render_hard`` (K3's wrapper);
* ``eval.predict`` (:func:`sqtpu_torch.evaluate.predict`),
  ``metrics.iou_full`` and ``metrics.voxels``, its occupancy counts: the
  plain grids on the CPU, the one K7 launch on the card
  (:mod:`sqtpu_torch.ops.metrics`).

Collection is off by default, and a span then costs one check and records
nothing. It is on while a ``torch.profiler`` session records (not in its
warm-up steps) and inside :func:`record_spans`. An open span then enters
``torch.profiler.record_function(name)``, so it lands in the profiler's
trace on the kernels' clock; records a CUDA event at its entry and exit on
the current stream (the host clock in their place where CUDA is not in
use), so that its device interval includes the card's idle time while the
host was inside it; and records the host clock, its parent (the innermost
open span of the thread) and the call of its root span. For each root
span it keeps ``gap_before``: the device time from the end of the
previous root span to its own start, which the card spent in the caller's
code between the program's calls. A collection starts afresh at the first
span a profiler session records and at the entry into
:func:`record_spans`; :func:`span_totals` reads the latest. Root calls
whose events have completed are folded into totals by name as the run
goes on, so a long profiled run holds a bounded number of records.
"""

from __future__ import annotations

import contextlib
import subprocess
import threading
import time

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_explicit = 0           # the depth of open record_spans() blocks
_seen_off = True        # a span found collection off since one found it on
_current = None         # the latest collection
_local = threading.local()


class _Off:
    """A span while collection is off: it does nothing. Its two methods
    are builtins, which run without a Python frame and are called without
    the instance: ``tuple()`` is the empty tuple, and ``"".format(*exc)``
    the empty string, false, so an exception passes through."""

    __slots__ = ()
    __enter__ = tuple
    __exit__ = "".format


_OFF = _Off()


def span(name: str):
    """A context manager that marks the block as the phase ``name``; it
    records only while collection is on (see the module's docstring)."""
    global _seen_off
    if _explicit or _profiler_enabled():
        return _Span(name)
    _seen_off = True
    return _OFF


@contextlib.contextmanager
def record_spans():
    """Collect spans inside the block, with or without a profiler, into a
    fresh collection (the outermost of nested blocks starts it)."""
    global _explicit, _current, _seen_off
    if not _explicit:
        _current = _Collection()
    _explicit += 1
    try:
        yield
    finally:
        _explicit -= 1
        _seen_off = True


def span_totals() -> dict:
    """Totals by span name over the latest collection, once its device work
    has completed: ``calls``, ``device_ms``, ``self_ms`` (the device ms
    its child spans do not cover), ``host_ms``, ``gap_before_ms`` summed
    over the root calls that had a root call before them in the
    collection and their count ``gap_before_calls``, and ``parents`` (the
    calls by parent name, None for a root). Empty before any collection;
    a span still open is left out."""
    col = _current
    if col is None:
        return {}
    col.fold(wait=True)
    return {name: dict(t, parents=dict(t["parents"]))
            for name, t in col.totals.items()}


class _HostEvent:
    """A CUDA event's stand-in where CUDA is not in use: the host clock
    at record."""

    __slots__ = ("t",)

    def record(self):
        self.t = time.perf_counter()

    def query(self) -> bool:
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _event(cuda: bool):
    """An event recorded now: a CUDA event on the current stream, or the
    host clock."""
    ev = torch.cuda.Event(enable_timing=True) if cuda else _HostEvent()
    ev.record()
    return ev


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _collection() -> "_Collection":
    """The collection an opening span records into; a fresh one at the
    first span of a profiler session."""
    global _current, _seen_off
    if _current is None or (_seen_off and not _explicit):
        _current = _Collection()
    _seen_off = False
    return _current


class _Collection:
    """The spans of one collection: root calls whose events may still be
    pending, and the totals by name of those folded."""

    def __init__(self):
        self.last_end = None    # the latest root call's end event
        self.pending = []       # closed root calls, oldest first
        self.totals = {}

    def close_root(self, root: "_Span") -> None:
        self.last_end = root.end
        self.pending.append(root)
        self.fold(wait=False)

    def fold(self, wait: bool) -> None:
        """Fold the closed root calls whose events have completed, oldest
        first; with ``wait``, every one, once its end has completed."""
        while self.pending:
            root = self.pending[0]
            if wait:
                root.end.synchronize()
            elif not (root.end.query()
                      and (root.gap is None or root.gap.query())):
                return
            self.pending.pop(0)
            self._add(root, None)

    def _add(self, s: "_Span", parent) -> float:
        ms = s.start.elapsed_time(s.end)
        inner = sum(self._add(c, s.name) for c in s.children)
        t = self.totals.get(s.name)
        if t is None:
            t = self.totals[s.name] = {
                "calls": 0, "device_ms": 0.0, "self_ms": 0.0, "host_ms": 0.0,
                "gap_before_ms": 0.0, "gap_before_calls": 0, "parents": {}}
        t["calls"] += 1
        t["device_ms"] += ms
        t["self_ms"] += ms - inner
        t["host_ms"] += (s.t1 - s.t0) * 1e3
        t["parents"][parent] = t["parents"].get(parent, 0) + 1
        if s.gap is not None:
            t["gap_before_ms"] += s.gap.elapsed_time(s.start)
            t["gap_before_calls"] += 1
        return ms


class _Span:
    """An open span while collection is on. ``root`` is the call of its
    root span, which holds the spans of one step or batch until they are
    folded together."""

    __slots__ = ("name", "col", "parent", "root", "children", "gap", "cuda",
                 "rf", "t0", "t1", "start", "end")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        col = self.col = _collection()
        stack = _stack()
        parent = stack[-1] if stack and stack[-1].col is col else None
        self.parent, self.children = parent, []
        self.root = self if parent is None else parent.root
        self.cuda = torch.cuda.is_initialized()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        self.start = _event(self.cuda)
        last = col.last_end if parent is None else None
        if last is not None and isinstance(last, _HostEvent) == self.cuda:
            last = None     # a host clock and a CUDA event do not subtract
        self.gap = last
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.end = _event(self.cuda)
        self.t1 = time.perf_counter()
        self.rf.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.root is self:
            self.col.close_root(self)
        else:
            self.parent.children.append(self)
        return False


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
