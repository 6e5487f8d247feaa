#!/usr/bin/env python3
"""A/B of the port's kernels against another checkout's sources, on one
card, in one process::

    python3 kernel_ab.py [--other DIR]

The inputs are ``chip_smoke.py``'s: phase 3's for K3 (the first BATCH
recorded truths of ``runs/eval_c4c3`` at IMAGE², at the eval and the
training sweep); phase 7's for K1 and K2 (``implicit_inputs(dev, 7)``,
LOSS_B samples at LOSS_N, windowed, K3 images, the cotangent of the
mean); phase 15's for K6 (``implicit_inputs(dev, 15)``, the first slab
of SLAB_COLS[0] columns); phase 11's for K4 and K5 (``explicit_inputs``,
windowed, at EXPLICIT_N and EXPLICIT_SHARP). Times are
``chip_smoke.cuda_ms``. K3's wrapper (packing and launch), its packing
alone and its launch alone on packed rows are timed; every other kernel's
launch alone, K2 and K6's backward on this checkout's Tacc. With
``--other DIR``, DIR's ``sqtpu_torch/csrc`` sources are built with this
checkout's nvcc flags (``_build.build``, into ``sqtpu_torch/build/`` under
their own hash: sources equal to this checkout's give its library), their
launches run in
turns with this checkout's (other, this, this, other), and the outputs
are compared: K3's images bit for bit; K1's, K2's and K6's sums, Tacc and
gradients relative (their arithmetic may differ); K4's and K5's outputs
bit for bit (``identical``) and relative. Always, this checkout's
``implicit.cu`` is also built with ``-DSQTPU_IMPLICIT_CULL=0`` (every
pixel sweeps its whole window), and K1/K2 with the cull must give the
bits of K1/K2 without it on phase 7's and phase 15's inputs, windowed and
not, with a NaN cotangent and a NaN image pixel; and ``explicit.cu`` with
``-DSQTPU_EXPLICIT_CULL=0``, and K4 (sums and gradient) and K5 (sums)
with the cull must give the bits of their uncut build on phase 11's
inputs, windowed and not, with a NaN pred size, and at sharpness 5 and
60; else it raises. K5's sums are compared with K4's (``k5.vs_k4``),
and the share of their warps' lane-slots that evaluate a point is
counted (``k5.lanes``). Prints one JSON line with the card's name and
power limit and the registers ptxas gave each explicit kernel it built
apart (the other checkout's, the uncut build).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os

import numpy as np
import torch

import chip_smoke as S
from sqtpu_torch.ops.image import nearest_resize
from sqtpu_torch.ops.kernels import _build
from sqtpu_torch.ops.kernels import explicit as KE
from sqtpu_torch.ops.kernels import hardrender as H
from sqtpu_torch.ops.kernels import implicit as K


EXPLICIT_ENTRIES = ("explicit_fused_kernel", "explicit_fwd_kernel")
REGISTERS: dict = {}  # "<name>_<tag>" -> {explicit entry: registers}


def build_lib(root: str, name: str, tag: str, *defines: str) -> ctypes.CDLL:
    """``root``'s ``sqtpu_torch/csrc/<name>.cu`` built with this
    checkout's nvcc flags (and ``defines``), loaded and typed by
    ``_build.library``; an explicit build's registers are kept."""
    csrc = os.path.join(root, "sqtpu_torch", "csrc")
    log = _build.build(name, defines, csrc)
    if name == "explicit":
        REGISTERS[f"{name}_{tag}"] = {e: S.registers_of(log, e)
                                      for e in EXPLICIT_ENTRIES}
    return _build.library(name, _build.library_path(name, defines, csrc))


def k1_launch(lib, img_xy, par, n: int, n_cols: int):
    """K1 of ``lib``: (B,) sums and the (B, n·n_cols) Tacc."""
    return K._launch_fwd(img_xy, par, n, n_cols, S.TAU, S.SHARP, "K1", lib)


def k2_launch(lib, img_xy, par, tacc, g, n: int, n_cols: int):
    """K2 of ``lib``: the (B, 24) gradient and the image cotangent."""
    return K._launch_bwd(img_xy, par, tacc, g, n, n_cols, S.TAU, S.SHARP,
                         "K2", lib)


def mean_cotangent(par, n: int):
    return torch.full((par.shape[0],), 1.0 / (par.shape[0] * n * n),
                      device=par.device)


def implicit_rows(pair: dict, img_xy, par, n: int, n_cols: int) -> dict:
    """K1's and K2's launches in turns on one plane (or slab), and, with
    another library, how far its outputs are from this one's."""
    g = mean_cotangent(par, n)
    _, tacc = k1_launch(pair["this"], img_xy, par, n, n_cols)
    row = {"fwd_ms": in_turns({k: (lambda lib=lib: k1_launch(
               lib, img_xy, par, n, n_cols)) for k, lib in pair.items()}),
           "bwd_ms": in_turns({k: (lambda lib=lib: k2_launch(
               lib, img_xy, par, tacc, g, n, n_cols))
               for k, lib in pair.items()})}
    if "other" in pair:
        (sa, ta), (sb, tb) = (k1_launch(pair[k], img_xy, par, n, n_cols)
                              for k in ("this", "other"))
        (ga, ia), (gb, ib) = (k2_launch(pair[k], img_xy, par, tacc, g, n,
                                        n_cols) for k in ("this", "other"))
        rel = torch.where(sa == sb, 0.0, (sa - sb).abs() / sb.abs())
        row.update(max_rel_sum=float(rel.max()),
                   max_abs_tacc=float((ta - tb).abs().max()),
                   max_abs_grad=float((ga - gb).abs().max()),
                   max_grad=float(gb.abs().max()),
                   image_grad_differ=int((ia != ib).sum()))
    return row


def same_bits(a, b) -> bool:
    """Equal to the bit where finite or infinite, NaN at the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return (torch.equal(na, nb) and torch.equal(a.view(torch.int32)[~na],
                                                b.view(torch.int32)[~nb]))


def cut_against_uncut(cut, uncut, img_xy, par, n: int, n_cols: int,
                      g=None) -> dict:
    """K1 then K2 of ``cut`` (this checkout's kernels) and of ``uncut``
    (the same source built with the cull off) on the same inputs; raises
    unless sums, Tacc, the gradient and the image cotangent are the same
    bits. K2 of both runs on the cut side's Tacc. Returns the uncut
    kernels' times."""
    g = mean_cotangent(par, n) if g is None else g
    sa, ta = k1_launch(cut, img_xy, par, n, n_cols)
    sb, tb = k1_launch(uncut, img_xy, par, n, n_cols)
    ga, ia = k2_launch(cut, img_xy, par, ta, g, n, n_cols)
    gb, ib = k2_launch(uncut, img_xy, par, ta, g, n, n_cols)
    for what, a, b in (("sums", sa, sb), ("Tacc", ta, tb),
                       ("gradient", ga, gb), ("image cotangent", ia, ib)):
        if not same_bits(a, b):
            raise RuntimeError(f"the cut kernels' {what} differ from the "
                               "uncut sweep's")
    return {"uncut_fwd_ms": S.cuda_ms(lambda: k1_launch(
                uncut, img_xy, par, n, n_cols)),
            "uncut_bwd_ms": S.cuda_ms(lambda: k2_launch(
                uncut, img_xy, par, ta, g, n, n_cols)),
            "nan_outputs": int(torch.isnan(ga).sum() + torch.isnan(sa).sum())}


def uncut_rows(cut, uncut, dev) -> dict:
    """The cull against the uncut sweep, bit for bit: phase 7's inputs
    (K3 and noise images, windowed and the full window), with a NaN
    cotangent and a NaN image pixel, and phase 15's slab."""
    n = S.LOSS_N
    _, k3_imgs, pred, noise_imgs = S.implicit_inputs(dev, 7)
    rows = {}
    for img_name, imgs in (("k3", k3_imgs), ("noise", noise_imgs)):
        for z_window in (True, False):
            rows[f"{img_name}_{'window' if z_window else 'full'}"] = \
                cut_against_uncut(cut, uncut, K.image_plane(imgs, n),
                                  K.pack_params(pred, n, z_window), n, n)
    par = K.pack_params(pred, n)
    g = mean_cotangent(par, n)
    g[3] = float("nan")
    img_xy = K.image_plane(k3_imgs, n)
    rows["nan_cotangent"] = cut_against_uncut(cut, uncut, img_xy, par, n, n,
                                              g)
    img_xy = img_xy.clone()
    img_xy[5, n * n // 2 + n // 2] = float("nan")
    rows["nan_pixel"] = cut_against_uncut(cut, uncut, img_xy, par, n, n)
    if not (rows["nan_cotangent"]["nan_outputs"]
            and rows["nan_pixel"]["nan_outputs"]):
        raise RuntimeError("a NaN input gave no NaN output")
    _, k3_imgs, pred, _ = S.implicit_inputs(dev, 15)
    cols = S.SLAB_COLS[0]
    rows["slab"] = cut_against_uncut(
        cut, uncut, K.slab_plane(nearest_resize(
            k3_imgs, (n, n))[:, :, :cols].contiguous()),
        K.pack_params(pred, n, x0=0), n, cols)
    return rows


def explicit_cut_against_uncut(cut, uncut, par_t, par_p, n: int,
                               sharp: float) -> dict:
    """K4 and K5 of ``cut`` (this checkout's kernels) and of ``uncut`` (the
    same source built with the cull off) on the same rows; raises unless
    K4's sums and gradient and K5's sums are the same bits. Returns the
    uncut kernels' times, the samples whose K4 and K5 sums are NaN, and
    whether K5's sums are K4's."""
    (sa, ga), (sb, gb) = (KE._launch_fused(par_t, par_p, n, sharp, lib)
                          for lib in (cut, uncut))
    fa, fb = (KE._launch_fwd(par_t, par_p, n, sharp, lib)
              for lib in (cut, uncut))
    for what, a, b in (("K4 sums", sa, sb), ("K4 gradient", ga, gb),
                       ("K5 sums", fa, fb)):
        if not same_bits(a, b):
            raise RuntimeError(f"the cut kernels' {what} differ from the "
                               "uncut sweep's")
    return {"uncut_fused_ms": S.cuda_ms(lambda: KE._launch_fused(
                par_t, par_p, n, sharp, uncut)),
            "uncut_fwd_ms": S.cuda_ms(lambda: KE._launch_fwd(
                par_t, par_p, n, sharp, uncut)),
            "nan_rows": torch.nonzero(torch.isnan(sa) & torch.isnan(fa)
                                      ).flatten().tolist(),
            "k5_is_k4": same_bits(fa, sa)}


def explicit_uncut_rows(cut, uncut, dev) -> dict:
    """K4/K5's cull against their uncut sweep, bit for bit: phase 11's
    inputs windowed and the full window, a pred row with a NaN size (the
    row must sweep its whole window and give NaN on both sides), and
    sharpness 5 and 60 (a wider and a narrower box)."""
    truths, pred = S.explicit_inputs(dev)
    n = S.EXPLICIT_N
    rows = {}
    for sharp in (S.EXPLICIT_SHARP, 5.0, 60.0):
        for z_window in ((True, False) if sharp == S.EXPLICIT_SHARP
                         else (True,)):
            par_t, par_p = KE.pack_params(truths, pred, n, z_window,
                                          KE.default_margin(sharp))
            rows[f"sharp{sharp:g}_{'window' if z_window else 'full'}"] = \
                explicit_cut_against_uncut(cut, uncut, par_t, par_p, n,
                                           sharp)
    sharp = S.EXPLICIT_SHARP
    par_t, par_p = KE.pack_params(truths, pred, n, True,
                                  KE.default_margin(sharp))
    par_p[3, 0] = float("nan")
    rows["nan_size"] = explicit_cut_against_uncut(cut, uncut, par_t, par_p,
                                                  n, sharp)
    if rows["nan_size"]["nan_rows"] != [3]:
        raise RuntimeError("a NaN pred size did not give NaN sums in its "
                           "row alone")
    return rows


def warp_lanes(par_t, par_p, n: int, sharp: float, cull: bool) -> dict:
    """The lattice points K4/K5 evaluate and the lane-slots their warps
    take (a warp of 8 (x) × 4 (y) columns runs as long as its longest
    column; columns past N idle), from the emulation's column planes."""
    col = KE._columns(par_t, par_p, n, sharp, cull)
    m = n + 1
    side = -(-m // 16) * 16
    span = (col.j1 - col.j0 + 1).clamp(min=0).reshape(-1, m, m)
    tiled = span.new_zeros((span.shape[0], side, side))
    tiled[:, :m, :m] = span
    longest = tiled.reshape(-1, side // 8, 8, side // 4, 4).amax(dim=(2, 4))
    points, slots = int(span.sum()), 32 * int(longest.sum())
    return {"points": points, "lane_slots": slots, "share": points / slots}


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
    libs = {name: {"this": _build.library(name)}
            for name in ("hardrender", "implicit", "explicit")}
    here = os.path.dirname(os.path.abspath(__file__))
    if args.other:
        for name, pair in libs.items():
            pair["other"] = build_lib(args.other, name, "other")
    uncut = build_lib(here, "implicit", "uncut", "-DSQTPU_IMPLICIT_CULL=0")
    uncut_explicit = build_lib(here, "explicit", "uncut",
                               "-DSQTPU_EXPLICIT_CULL=0")
    out = {"card": S.card_line(), "k3": {}, "k4": {}, "k5": {},
           "uncut": uncut_rows(libs["implicit"]["this"], uncut, dev),
           "explicit_uncut": explicit_uncut_rows(
               libs["explicit"]["this"], uncut_explicit, dev)}

    with np.load(S.TRUTHS) as d:
        p = torch.as_tensor(d["true_params"][:S.BATCH].astype(np.float32),
                            device=dev)
    k3 = libs["hardrender"]
    for n_sweep, n_bisect in ((S.EVAL_SWEEP, S.EVAL_BISECT),
                              (S.TRAIN_SWEEP, S.TRAIN_BISECT)):
        par = H.pack_frames(p, n_sweep)
        row = {"launch_ms": in_turns({k: (lambda lib=lib: H._launch(
                   par, S.IMAGE, n_sweep, n_bisect, True, lib))
                   for k, lib in k3.items()}),
               "wrapper_ms": S.cuda_ms(lambda: H.render_depth_hard_cuda(
                   p, S.IMAGE, n_sweep, n_bisect)),
               "pack_ms": S.cuda_ms(lambda: H.pack_frames(p, n_sweep))}
        if args.other:
            a, b = (H._launch(par, S.IMAGE, n_sweep, n_bisect, True,
                              k3[k]) for k in ("this", "other"))
            row["pixels_differ"] = int((a != b).sum())
        out["k3"][f"{n_sweep}/{n_bisect}"] = row

    n = S.LOSS_N
    _, k3_imgs, pred, _ = S.implicit_inputs(dev, 7)
    out["k1_k2"] = implicit_rows(libs["implicit"], K.image_plane(
        k3_imgs, n), K.pack_params(pred, n), n, n)
    _, k3_imgs, pred, _ = S.implicit_inputs(dev, 15)
    cols = S.SLAB_COLS[0]
    out["k6"] = implicit_rows(
        libs["implicit"], K.slab_plane(nearest_resize(
            k3_imgs, (n, n))[:, :, :cols].contiguous()),
        K.pack_params(pred, n, x0=0), n, cols)

    truths, pred = S.explicit_inputs(dev)
    n, sharp = S.EXPLICIT_N, S.EXPLICIT_SHARP
    par_t, par_p = KE.pack_params(truths, pred, n, True,
                                  KE.default_margin(sharp))
    k4 = libs["explicit"]
    out["k4"]["launch_ms"] = in_turns({k: (
        lambda lib=lib: KE._launch_fused(par_t, par_p, n, sharp, lib))
        for k, lib in k4.items()})
    out["k5"]["launch_ms"] = in_turns({k: (
        lambda lib=lib: KE._launch_fwd(par_t, par_p, n, sharp, lib))
        for k, lib in k4.items()})
    s4, _ = KE._launch_fused(par_t, par_p, n, sharp, k4["this"])
    s5 = KE._launch_fwd(par_t, par_p, n, sharp, k4["this"])
    out["k5"]["lanes"] = {
        "cut": warp_lanes(par_t, par_p, n, sharp, True),
        "uncut": warp_lanes(par_t, par_p, n, sharp, False)}
    out["k5"]["vs_k4"] = {
        "max_rel_sum": float(((s5 - s4).abs() / s4.abs()).max()),
        "identical": same_bits(s5, s4)}
    if args.other:
        (sa, ga), (sb, gb) = (KE._launch_fused(par_t, par_p, n, sharp,
                                               k4[k])
                              for k in ("this", "other"))
        out["k4"]["max_rel_sum"] = float(((sa - sb).abs()
                                          / sb.abs()).max())
        out["k4"]["max_abs_grad"] = float((ga - gb).abs().max())
        out["k4"]["max_grad"] = float(gb.abs().max())
        out["k4"]["identical"] = bool(torch.equal(sa, sb)
                                      and torch.equal(ga, gb))
        s5a, s5b = (KE._launch_fwd(par_t, par_p, n, sharp, k4[k])
                    for k in ("this", "other"))
        out["k5"]["max_rel_sum"] = float(((s5a - s5b).abs()
                                          / s5b.abs()).max())
        out["k5"]["identical"] = bool(torch.equal(s5a, s5b))
    torch.cuda.synchronize()
    out["registers"] = REGISTERS
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
