"""The benchmark's data-driven core: a cell, its configuration, its
traffic mix and its metric readers are found by the names in
``BENCHMARK.json``, each in a file of its own under ``perfbench/``.

* ``BENCHMARK.json``'s ``workloads`` entry names the cell's ``config``,
  ``traffic`` and ``chips``; its ``configs`` entry names the
  configuration's ``file`` (``perfbench/configs/<config>.json``).
* ``perfbench/traffic/<traffic>.json`` holds the mix: the driver that
  generates it (``perfbench/drivers/<driver>.py``) and its parameters.
* ``perfbench/cells/<cell>.json`` holds the cell's ``why``, the
  parameters of its traced run and the limits of its comparison with the
  reference (``limits``, by the name of each number compared).
* ``perfbench/metrics/<metric>.py`` reads one per-layer metric from the
  traced run's record (``read(record)``, None when there is nothing to
  read).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sqtpu")


def forbidden_loaded(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole: ``sqtpu_torch`` is not ``sqtpu``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def progress(t0: float, msg: str) -> None:
    """One line on standard error: the seconds since ``t0`` and ``msg``."""
    print(f"perfbench: {time.perf_counter() - t0:8.2f} s  {msg}",
          file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything its files hold."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        pkg = os.path.join(root, "perfbench")
        spec = load_json(os.path.join(root, "BENCHMARK.json"))
        entry = {w["name"]: w for w in spec["workloads"]}.get(name)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.chips = int(entry["chips"])
        conf = {c["name"]: c for c in spec["configs"]}[entry["config"]]
        self.config = load_json(os.path.join(root, conf["file"]))
        self.traffic = load_json(os.path.join(pkg, "traffic",
                                              entry["traffic"] + ".json"))
        self.params = load_json(os.path.join(pkg, "cells", name + ".json"))
        self.driver_path = os.path.join(pkg, "drivers",
                                        self.traffic["driver"] + ".py")

        def mine(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in spec["end_to_end"] if mine(m)]
        self.per_layer = [m for m in spec["per_layer"] if mine(m)]
        self.metrics_dir = os.path.join(pkg, "metrics")

    def driver(self):
        return load_module(self.driver_path,
                           "perfbench_driver_" + self.traffic["driver"])

    def reader(self, metric: str):
        return load_module(os.path.join(self.metrics_dir, metric + ".py"),
                           "perfbench_metric_" + metric.replace(".", "_"))


class Checks:
    """The numbers compared with the reference, each beside its limit;
    a number with no limit in the cell's file is read and not held."""

    def __init__(self, limits: dict):
        self.limits = dict(limits)
        self.values = {}

    def add(self, name: str, value) -> None:
        self.values[name] = float(value)

    def correct(self) -> bool:
        return all(self._ok(n) for n in self.limits)

    def _ok(self, name: str) -> bool:
        v = self.values.get(name, math.nan)
        return math.isfinite(v) and v <= self.limits[name]

    def held(self) -> dict:
        return {n: {"value": self.values.get(n), "limit": lim}
                for n, lim in self.limits.items()}

    def lines(self) -> list:
        """The numbers read and not held, then each number held beside its
        limit (the last lines a run writes to standard error)."""
        out = [f"read {n}: {v!r} (not held)" for n, v in self.values.items()
               if n not in self.limits]
        for n, lim in self.limits.items():
            out.append(f"check {n}: {self.values.get(n)!r} limit {lim!r} "
                       f"{'ok' if self._ok(n) else 'FAILED'}")
        return out


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: Checks, breakdown=None) -> str:
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks.held()
    return json.dumps(line)
