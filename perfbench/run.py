"""Run one cell of the benchmark of ``sqtpu_torch`` once and print its
result as the last line of standard output::

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (``setup_s``) runs from the start of this process to the first
timed step: imports, the kernels' builds (cached under the checkout's
``sqtpu_torch/build/``), the weights, and the cell's first steps, which
warm up its shapes and are compared with the reference. The window then
measures for ``--seconds`` seconds. ``--trace 0`` prints the cell's
end-to-end metrics; ``--trace 1`` its per-layer metrics, read by the
readers under ``perfbench/metrics/`` from CUDA events and a
``torch.profiler`` trace of a few steps of the window, with the card's
busy seconds, the traced window and a breakdown. After the window the
program's state is freed and the plain reference
(``perfbench/reference/``) recomputes what the window's first steps or a
sample of its answers produced; ``correct`` holds when every number
compared is within the cell's limit. The numbers compared and their
limits are the last lines on standard error and the ``checks`` key of
the result line.

The run exits non-zero with no result when torch sees no card or fewer
cards than the cell asks for, and when a module of JAX or of the JAX
package is loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# kernel and compiler caches at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, os.path.join(_ROOT, ".perfbench_cache",
                                             _sub))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def main(argv=None, device=None, root=None) -> int:
    """Run the cell; ``device`` (a torch device) skips the look for a
    card, and ``root`` reads the cell's files from another checkout, as
    the benchmark's own tests do on the CPU."""
    from perfbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.Cell(args.workload, root or harness.ROOT)
    import torch

    harness.progress(T0, f"torch {torch.__version__} imported")

    if device is None:
        if not torch.cuda.is_available():
            print("perfbench: torch sees no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"perfbench: {cell.name} needs {cell.chips} cards, torch "
                  f"sees {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    res = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace),
                            device, T0)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 3

    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": res["peak_bytes"]}
    breakdown = None
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(res["record"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        summary = res["record"].get("trace")
        if summary:
            from perfbench.trace import breakdown as make_breakdown

            dev["busy_s"] = summary["busy_s"]
            dev["window_s"] = summary["span_s"]
            breakdown = make_breakdown(summary)
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}

    checks = res["checks"]
    print(f"perfbench: {cell.name} seed {args.seed} on "
          f"{card_line() if on_card else 'cpu'}", file=sys.stderr)
    for line in checks.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(checks.correct(), res["attempted"],
                              res["failed"], metrics, dev, checks,
                              breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
