#!/usr/bin/env python3
"""A/B of the hard renderer (K3) and the explicit loss's fused kernel (K4)
against another checkout's sources, on one card, in one process::

    python3 kernel_ab.py [--other DIR]

The inputs are ``chip_smoke.py``'s: phase 3's for K3 (the first BATCH
recorded truths of ``runs/eval_c4c3`` at IMAGE², at the eval and the
training sweep) and phase 11's for K4 (``explicit_inputs``, windowed, at
EXPLICIT_N and EXPLICIT_SHARP). Times are ``chip_smoke.cuda_ms``. K3's
wrapper (packing and launch), its packing alone and its launch alone on
packed rows are timed; K4's launch alone. With ``--other DIR``, DIR's
``sqtpu_torch/csrc`` sources are built with this checkout's nvcc flags
into a temporary directory, their launches run in turns with this
checkout's (other, this, this, other), and the outputs are compared: K3's
images bit for bit, K4's sums and gradients relative. Prints one JSON line
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

import chip_smoke as S
from sqtpu_torch.ops.kernels import _build
from sqtpu_torch.ops.kernels import explicit as KE
from sqtpu_torch.ops.kernels import hardrender as H


def build_other(root: str, name: str, out_dir: str) -> ctypes.CDLL:
    """``root``'s ``sqtpu_torch/csrc/<name>.cu`` built with this
    checkout's flags into ``out_dir``, loaded."""
    out = os.path.join(out_dir, f"lib{name}_other.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out,
                    os.path.join(root, "sqtpu_torch", "csrc", name + ".cu")],
                   check=True, capture_output=True,
                   timeout=_build.NVCC_TIMEOUT_S)
    return ctypes.CDLL(out)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def k3_launch(lib, par, s: int, n_sweep: int, n_bisect: int):
    """One launch of a library's ``sqtpu_hardrender`` on packed rows."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sqtpu_hardrender.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.sqtpu_hardrender.restype = i32
    b = par.shape[0]
    out = torch.empty((b, s, s), dtype=torch.float32, device=par.device)
    err = lib.sqtpu_hardrender(par.data_ptr(), out.data_ptr(), b, s,
                               n_sweep, n_bisect, 1, _stream(par.device))
    if err:
        raise RuntimeError(f"sqtpu_hardrender returned {err}")
    return out


def k4_launch(lib, par_t, par_p, n: int, sharp: float):
    """One launch of a library's ``sqtpu_explicit_fused``: (B,) sums and
    (B, 24) gradient. Its partial buffers take the library's own width."""
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.sqtpu_explicit_fused.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                         i32, f64, ptr]
    lib.sqtpu_explicit_fused.restype = i32
    width = (lib.sqtpu_explicit_fused_blocks
             if hasattr(lib, "sqtpu_explicit_fused_blocks")
             else lib.sqtpu_explicit_blocks)
    width.argtypes, width.restype = [i32], i32
    b, dev = par_p.shape[0], par_p.device
    blocks = width(n)
    partial_sum = torch.empty((b, blocks), dtype=torch.float32, device=dev)
    partial_grad = torch.empty((b, blocks, KE.N_PAR), dtype=torch.float32,
                               device=dev)
    sums = torch.empty((b,), dtype=torch.float32, device=dev)
    dpar = torch.empty((b, KE.PAR_STRIDE), dtype=torch.float32, device=dev)
    err = lib.sqtpu_explicit_fused(
        par_t.data_ptr(), par_p.data_ptr(), partial_sum.data_ptr(),
        partial_grad.data_ptr(), sums.data_ptr(), dpar.data_ptr(), b, n,
        sharp, _stream(dev))
    if err:
        raise RuntimeError(f"sqtpu_explicit_fused returned {err}")
    return sums, dpar


def in_turns(fns: dict) -> dict:
    """Each function's times, in turns other, this, this, other (or this
    twice)."""
    order = (["other", "this", "this", "other"] if "other" in fns
             else ["this", "this"])
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(S.cuda_ms(fns[k]))
    return times


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default="", help="root of another checkout")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    libs = {"hardrender": {"this": H._lib()}, "explicit": {"this": KE._lib()}}
    with tempfile.TemporaryDirectory() as tmp:
        if args.other:
            for name, pair in libs.items():
                pair["other"] = build_other(args.other, name, tmp)
        out = {"card": S.card_line(), "k3": {}, "k4": {}}

        with np.load(S.TRUTHS) as d:
            p = torch.as_tensor(d["true_params"][:S.BATCH].astype(np.float32),
                                device=dev)
        k3 = libs["hardrender"]
        for n_sweep, n_bisect in ((S.EVAL_SWEEP, S.EVAL_BISECT),
                                  (S.TRAIN_SWEEP, S.TRAIN_BISECT)):
            par = H.pack_frames(p, n_sweep)
            row = {"launch_ms": in_turns({k: (lambda lib=lib: k3_launch(
                       lib, par, S.IMAGE, n_sweep, n_bisect))
                       for k, lib in k3.items()}),
                   "wrapper_ms": S.cuda_ms(lambda: H.render_depth_hard_cuda(
                       p, S.IMAGE, n_sweep, n_bisect)),
                   "pack_ms": S.cuda_ms(lambda: H.pack_frames(p, n_sweep))}
            if args.other:
                a, b = (k3_launch(k3[k], par, S.IMAGE, n_sweep, n_bisect)
                        for k in ("this", "other"))
                row["pixels_differ"] = int((a != b).sum())
            out["k3"][f"{n_sweep}/{n_bisect}"] = row

        truths, pred = S.explicit_inputs(dev)
        n, sharp = S.EXPLICIT_N, S.EXPLICIT_SHARP
        par_t, par_p = KE.pack_params(truths, pred, n, True,
                                      KE.default_margin(sharp))
        k4 = libs["explicit"]
        out["k4"]["launch_ms"] = in_turns({k: (lambda lib=lib: k4_launch(
            lib, par_t, par_p, n, sharp)) for k, lib in k4.items()})
        if args.other:
            (sa, ga), (sb, gb) = (k4_launch(k4[k], par_t, par_p, n, sharp)
                                  for k in ("this", "other"))
            out["k4"]["max_rel_sum"] = float(((sa - sb).abs()
                                              / sb.abs()).max())
            out["k4"]["max_abs_grad"] = float((ga - gb).abs().max())
            out["k4"]["max_grad"] = float(gb.abs().max())
        torch.cuda.synchronize()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
