"""The card's yardstick: peak rates and the operations each kernel makes.

One source for the least time a kernel could take on the card
(``bound_ms``): ``chip_smoke.py`` and ``python -m
sqtpu_torch.tools.roofline_explicit`` both read it. A bound is the larger
of two times: the bytes the function must move (each input read once,
each output written once) over the memory rate, and the operations it
makes on these inputs over the float32 rate. Where the work depends on the
data, it counts what these inputs need: the points the emulations count
after the exact-zero cull, or the inside tests K3 makes.
"""

from __future__ import annotations

# Card peaks for the bound (NVIDIA H100 SXM data sheet, dense, 700 W):
PEAK_FP32_OPS = 67e12      # float32 outside the tensor cores, op/s
PEAK_BYTES = 3.35e12       # HBM3, bytes/s
# fp32 operations of one inside test of the hard renderer, each logf and
# expf counted as one: 3 FMA for u, v, w (6), 3 FMA for the squares plus
# FLT_MIN (6), 4 logf, 4 products by the exponents, 4 expf, 2 adds for
# A + B + FLT_MIN, 1 add for E + C, 1 compare = 28; plus 2 for the step
# (z = z_hi - j*step, or mid = 0.5*(lo + hi)). The bound counts the tests
# these inputs need: those the kernel makes, which skip the slabs its
# ray-box interval rules out (no test there can be inside). The tests of
# the full sweep from z_hi (the TPU kernel's algorithm) give a second
# figure, `bound_ms_full_sweep`, the yardstick kept from version to
# version.
OPS_PER_TEST = 30

# fp32 operations per in-window (x, y, z) point, each logf/expf counted as
# one, read off the first port's sqtpu_torch/csrc/implicit.cu, the
# TPU kernels' chain: the field chain 49 (21 for u, v, w; 9 squares and
# guards; 9 for the three powers; 10 for G, E, H, F); K1 adds 10 (sigmoid
# 6, S, exp(-τS) 2, Tacc), K2 adds 17 (sigmoid 6, S, T_j 2, V, W 2, gF 5)
# and the gradient chain's 108. The window's points at these counts give
# `bound_ms_window`, the yardstick kept from version to version.
OPS_K1 = 59
OPS_K2 = 174
# The redesigned K1/K2 make, per point they evaluate after the exact-zero
# cull, 44 and 115 operations read off sqtpu_torch/csrc/implicit.cu and
# sq_field.cuh: the field chain of 34 (u, v, w = u0 + c·z, 6; squares and
# guards 9; the three powers by reciprocals 9; G, E, H, F 10), the
# sigmoid 6, S, exp(-τS) 2 and the add into Tacc (K1: 44); K2 the same 34
# and 6, S, T_j 2, V, W 2, gF 5, and the separable gradient step 64.
# Every other point of the window has occupancy exactly 0.0f and moves no
# output, so the cull's points at these counts are the work these inputs
# need: K1's and K2's bound.
OPS_K1_CULLED = 44
OPS_K2_CULLED = 115

# fp32 operations per in-window lattice point of the first port's kernels,
# each logf/expf counted as one, read off their sources: two field
# chains (2 × 49) and two sigmoids (2 × 6), d, and d² into the sum (2):
# K5 113; K4 adds gF (5) and the gradient chain (108): 226. The window's
# points at these counts give `bound_ms_window`, the yardstick kept from
# version to version.
OPS_K5 = 113
OPS_K4 = 226
# The redesigned K4 makes, per point it evaluates after the
# exact-zero cull, 152 operations read off sqtpu_torch/csrc/explicit.cu and
# sq_field.cuh: two field chains of 34 (u, v, w = u0 + c·z, 6; squares and
# guards 9; the three powers by reciprocals 9; G, E, H, F 10), two sigmoids
# of 6, d and d² into the sum (3), gF (5) and the separable gradient step
# (64). Outside the cull's points d is exactly 0 and gF ±0, so these
# points at these ops are the work these inputs need: K4's bound; K5's is
# the same points at the value's part of the chain (152 - 5 - 64 = 83).
OPS_K4_CULLED = 152
OPS_K5_CULLED = OPS_K4_CULLED - 5 - 64

# fp32 operations per field evaluation of the voxel IoU kernel K7, each
# logf/expf counted as one, read off sqtpu_torch/csrc/voxel_iou.cu
# (``occupied``): per axis r2·Z, + P, − tr, / a and the square (15); five
# pows, each a log, a product by the exponent and an exp (15); (A + B),
# + tiny, (E + C), + tiny (4); the test F <= 1 (1). The column's P (9) is
# taken once a chunk of 32 voxels and the counting is a few integer
# operations a 32-voxel word: neither is counted. The evaluations the
# kernel makes are the field intervals its z cull leaves (counted by the
# emulation); every voxel outside them is unoccupied, so these are the work
# these inputs need: K7's bound. Every field at every voxel (the plain
# path's grids) gives `bound_ms_full_sweep`.
OPS_K7 = 35


def ops_ms(count: int, ops_per: int) -> float:
    """Milliseconds for ``count`` items of ``ops_per`` fp32 operations at
    PEAK_FP32_OPS."""
    return count * ops_per / PEAK_FP32_OPS * 1e3


def bytes_ms(n_bytes: int) -> float:
    """Milliseconds to move ``n_bytes`` at PEAK_BYTES."""
    return n_bytes / PEAK_BYTES * 1e3


def bound(ops: float, moved: float) -> tuple[float, str]:
    """(bound_ms, bound_by) from an operations time and a bytes time."""
    return max(ops, moved), "operations" if ops >= moved else "bytes"


def explicit_bounds(par_t, par_p, n: int, sharp: float) -> dict:
    """K4's and K5's bounds for the packed params ``par_t``, ``par_p`` of
    :func:`sqtpu_torch.ops.kernels.explicit.pack_params` (windowed or the
    full sweep, as packed): the points after the exact-zero cull at
    OPS_K4_CULLED and OPS_K5_CULLED, and the bytes (both packed sides in;
    K4 the sums and the (B, PAR_STRIDE) gradient out, K5 the sums). Each
    row also has the window's points at the first port's counts
    (``bound_ms_window``)."""
    from sqtpu_torch.ops.kernels import explicit as KE

    b = par_p.shape[0]
    points = KE.window_points(par_p, n)
    culled = KE.cull_points(par_t, par_p, n, sharp)
    par_bytes = 2 * b * KE.PAR_STRIDE * 4
    rows = {}
    for name, ops_per, window_ops, n_bytes in (
            ("K4", OPS_K4_CULLED, OPS_K4,
             par_bytes + b * 4 * (1 + KE.PAR_STRIDE)),
            ("K5", OPS_K5_CULLED, OPS_K5, par_bytes + b * 4)):
        moved = bytes_ms(n_bytes)
        bound_ms, bound_by = bound(ops_ms(culled, ops_per), moved)
        rows[name] = {"bound_ms": bound_ms, "bound_by": bound_by,
                      "ops_per_point": ops_per,
                      "points_after_cull": culled,
                      "in_window_points": points,
                      "bound_ms_window": max(ops_ms(points, window_ops),
                                             moved)}
    return rows


def voxel_iou_bounds(par, ax, n_pairs: int) -> dict:
    """K7's bound for (B, F, 24) rows packed by
    :func:`sqtpu_torch.ops.kernels.voxel_iou.pack_fields` on their
    lattice axes ``ax`` (F, N): the field evaluations after the z cull at OPS_K7, and the
    bytes (the rows in, the (B, n_pairs, 2) int64 counts out); beside it
    the full sweep's (every field at every voxel) and the share of it the
    kernel evaluates."""
    from sqtpu_torch.ops.kernels import voxel_iou as V

    b, f = par.shape[:2]
    evals = V.evaluations(par, ax)
    full = b * f * ax.shape[-1] ** 3
    moved = bytes_ms(par.numel() * par.element_size() + b * n_pairs * 16)
    bound_ms, bound_by = bound(ops_ms(evals, OPS_K7), moved)
    return {"bound_ms": bound_ms, "bound_by": bound_by,
            "ops_per_evaluation": OPS_K7, "evaluations": evals,
            "full_sweep_evaluations": full, "tested_share": evals / full,
            "bound_ms_full_sweep": max(ops_ms(full, OPS_K7), moved)}
