"""Read the numbers a cell compares with its reference over many seeds in
one process: the program's, the control's (the reference in the
program's place one precision below the configuration's), and those of
the program with a fault planted underneath its timed path. The limits
in ``perfbench/cells/<cell>.json`` are set from these readings::

    python3 -m perfbench.readings --workload <cell> --seeds 1,2,3 \\
        --modes program,control,half_batch --seconds 2 [--out FILE]

Modes: ``program``; ``control``; ``reference`` (the float32 reference
itself in the program's place); ``unchanged`` (the optimizer's update
left out: a step that returns its state unchanged); ``half_batch`` (the
loss over the first half of the batch only, its mean over the rest);
``answer`` (one IoU of each batch lowered by 0.01 where ``iou_full``
produces it); ``prediction`` (one predicted parameter of each batch
moved by 0.1, a tenth of the unit range, where ``evaluate.predict``
produces it). Each reading is one JSON line: the
mode, the seed, the numbers, the end-to-end metrics and ``correct``
under the cell's current limits. ``--reference float64`` judges every
mode by the reference computed in float64 (training cells), a second
witness where the float32 reference and the program disagree. The
benchmark's runs never plant a fault: only this tool and the benchmark's
tests do.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

FAULTS = ("unchanged", "half_batch", "answer", "prediction")


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted under its timed path."""
    if fault == "unchanged":
        from sqtpu_torch.training import state

        saved = state.TrainState.apply_gradients
        state.TrainState.apply_gradients = lambda self: None
        try:
            yield
        finally:
            state.TrainState.apply_gradients = saved
    elif fault == "half_batch":
        from sqtpu_torch.training import loop

        saved = loop._compute_loss

        def half(cfg, pred, imgs, labels, layout=None):
            h = pred.shape[0] // 2
            return saved(cfg, pred[:h], imgs[:h], labels[:h], layout)

        loop._compute_loss = half
        try:
            yield
        finally:
            loop._compute_loss = saved
    elif fault == "answer":
        from sqtpu_torch.ops import metrics

        saved = metrics.iou_full

        def altered(*args, **kwargs):
            out = saved(*args, **kwargs).clone()
            out[0, 1] = out[0, 1] - 0.01
            return out

        metrics.iou_full = altered
        try:
            yield
        finally:
            metrics.iou_full = saved
    elif fault == "prediction":
        from sqtpu_torch import evaluate

        saved = evaluate.predict

        def altered(model, imgs):
            out = saved(model, imgs).clone()
            out[0, 0] = out[0, 0] + 0.1
            return out

        evaluate.predict = altered
        try:
            yield
        finally:
            evaluate.predict = saved
    else:
        raise ValueError(f"unknown fault {fault!r}")


def read(cell, mode: str, seed: int, seconds: float, device,
         reference: str = "float32") -> dict:
    """One run of ``cell``'s driver in ``mode``, judged by the reference
    in ``reference``'s dtype; returns its reading."""
    import torch

    driver = cell.driver()
    t0 = time.perf_counter()
    kwargs = {}
    if mode in ("control", "reference"):
        config = dict(cell.config, **cell.traffic.get("config", {}))
        key = "trainee" if cell.traffic["driver"] == "train" else "loop_cls"
        kwargs[key] = (driver.control(config) if mode == "control" else
                       getattr(driver, "ReferenceTrainee", None)
                       or driver.ReferenceLoop)
    if reference == "float64":
        driver.REFERENCE_DTYPE = torch.float64
    with planted(mode) if mode in FAULTS else contextlib.nullcontext():
        res = driver.run(cell, seed, seconds, False, device, t0, **kwargs)
    return {"mode": mode, "reference": reference, "seed": seed,
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
    ap.add_argument("--reference", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload, root or harness.ROOT)
    device = device or torch.device("cuda", 0)
    out = []
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            reading = read(cell, mode, seed, args.seconds, device,
                           args.reference)
            out.append(reading)
            line = json.dumps(reading)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
