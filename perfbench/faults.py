"""Faults that :mod:`perfbench.readings` lacks, planted under the timed path
of the corrector's cell, and a reading tool over them and over
:mod:`perfbench.readings`'s modes::

    python3 -m perfbench.faults --workload <cell> --seeds 1,2,3 \\
        --modes program,control,one_pass,stale_render --seconds 2 \\
        [--out FILE]

Faults:

* ``one_pass``: the corrector's second pass left out (``IterativeSQ``
  runs one pass whatever its ``n_refine``);
* ``stale_render``: every pass of the corrector renders the base's
  estimate instead of the current one.

Every mode of :mod:`perfbench.readings` (``program``, ``control``,
``reference`` and its faults) is read by that module. The benchmark's
runs never plant a fault: only this tool and the benchmark's tests do.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import types

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

FAULTS = ("one_pass", "stale_render")


@contextlib.contextmanager
def _patched(owner, name: str, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` of this module planted under its timed
    path."""
    if fault == "one_pass":
        from sqtpu_torch.models import refiner

        forward = refiner.IterativeSQ.forward

        def one_pass(self, x, remat=False):
            n = self.n_refine
            self.n_refine = min(n, 1)
            try:
                return forward(self, x, remat)
            finally:
                self.n_refine = n

        with _patched(refiner.IterativeSQ, "forward", one_pass):
            yield
    elif fault == "stale_render":
        from sqtpu_torch.models import refiner

        forward, kernels = refiner.IterativeSQ.forward, refiner.kernels
        first = []

        def render(p, *args, **kwargs):
            if not first:
                first.append(p)
            return kernels.render_hard_auto(first[0], *args, **kwargs)

        def fresh(self, x, remat=False):
            first.clear()
            return forward(self, x, remat)

        stale = types.SimpleNamespace(render_hard_auto=render)
        with _patched(refiner, "kernels", stale), \
                _patched(refiner.IterativeSQ, "forward", fresh):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r}")


def read(cell, mode: str, seed: int, seconds: float, device) -> dict:
    """One run of ``cell``'s driver in ``mode``; returns its reading, as
    :func:`perfbench.readings.read` does."""
    from perfbench import readings

    if mode not in FAULTS:
        return readings.read(cell, mode, seed, seconds, device)
    with planted(mode):
        res = cell.driver().run(cell, seed, seconds, False, device,
                                time.perf_counter())
    return {"mode": mode, "seed": seed,
            "numbers": res["checks"].values,
            "correct": res["checks"].correct(), "e2e": res["e2e"],
            "attempted": res["attempted"], "failed": res["failed"],
            "peak_bytes": res["peak_bytes"]}


def main(argv=None, device=None, root=None) -> list:
    import torch

    from perfbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--modes", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload, root or harness.ROOT)
    device = device or torch.device("cuda", 0)
    out = []
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            reading = read(cell, mode, seed, args.seconds, device)
            out.append(reading)
            line = json.dumps(reading)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
