#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``sqtpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from source, holds each against
its plain PyTorch version, drives the port's closed-loop evaluation and
its server through the entry points a user calls, and checks the results
against the JAX package's recorded run of the same weights on the same
1000 shapes (``runs/eval_c4c3``). One flushed progress line per phase,
with the elapsed seconds; no failure is caught. The last lines are the
card (``nvidia-smi`` name and power limit), one JSON object with each
kernel's numbers, and ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when torch sees no CUDA device or
when the port is not beside it. A hang ends in a stack dump and a
non-zero exit after 600 s. It imports nothing of JAX or of ``sqtpu``.
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TRUTHS = os.path.join(ROOT, "runs", "eval_c4c3", "accs.npz")
WEIGHTS = os.path.join(ROOT, "artifacts", "resnet_sq_c4_fp16.npz")

# Means of the JAX package's closed loop on these weights and truths
# (runs/eval_c4c3/eval.log), and how far the port may be from them.
RECORDED_FULL_IOU = 0.9030094
RECORDED_ROT_IOU = 0.9211804
IOU_TOL = 0.005
# The renderer's bound (sqtpu/ops/geometry.py:400-402): fewer than 0.1% of
# pixels off by more than one gray level.
PIXEL_TOL = 1e-3
SERVE_TOL = 1e-3           # served params vs the closed loop's, per value
BATCH = 125
IMAGE = 256
EVAL_SWEEP, EVAL_BISECT = 64, 16
TRAIN_SWEEP, TRAIN_BISECT = 48, 12
TIMING_RUNS = 20

# Card peaks for the bound (NVIDIA H100 SXM data sheet, dense, 700 W):
PEAK_FP32_OPS = 67e12      # float32 outside the tensor cores, op/s
PEAK_BYTES = 3.35e12       # HBM3, bytes/s
# fp32 operations of one inside test of the hard renderer, each logf and
# expf counted as one: 3 FMA for u, v, w (6), 3 FMA for the squares plus
# FLT_MIN (6), 4 logf, 4 products by the exponents, 4 expf, 2 adds for
# A + B + FLT_MIN, 1 add for E + C, 1 compare = 28; plus 2 for the step
# (z = z_hi - j*step, or mid = 0.5*(lo + hi)).
OPS_PER_TEST = 30

T0 = time.perf_counter()


def progress(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median over ``runs`` single calls, each timed with CUDA events, after
    one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def gray_levels_off(a, b) -> float:
    """Fraction of pixels whose gray levels differ by more than one."""
    import torch

    la, lb = torch.round(a * 255.0), torch.round(b * 255.0)
    return float(((la - lb).abs() > 1).double().mean())


def inside_tests(p, s: int, n_sweep: int, n_bisect: int) -> int:
    """Inside tests the kernel makes on these params: a pixel that first
    hits at sweep step j makes j + 1 + n_bisect, a miss makes n_sweep.
    The same test as the kernel, on the kernel's packed frame scalars."""
    import torch

    from sqtpu_torch.ops.kernels.hardrender import pack_frames

    par = pack_frames(p, n_sweep)
    b = par.shape[0]
    col = torch.arange(s, device=p.device, dtype=torch.float32)
    X = (col / (s - 1))[None, None, :]                   # col = x
    Y = ((s - 1 - col) / (s - 1))[None, :, None]         # row = s-1-y

    def c(k):
        return par[:, k].reshape(b, 1, 1)

    u0 = (c(9) * X + c(10) * Y - c(6)) / c(0)
    v0 = (c(12) * X + c(13) * Y - c(7)) / c(1)
    w0 = (c(15) * X + c(16) * Y - c(8)) / c(2)
    tiny = torch.finfo(torch.float32).tiny
    first = torch.full((b, s, s), n_sweep, device=p.device,
                       dtype=torch.int64)
    for j in range(n_sweep):
        z = c(18) - j * c(19)
        u = u0 + c(11) / c(0) * z
        v = v0 + c(14) / c(1) * z
        w = w0 + c(17) / c(2) * z
        A = torch.exp(torch.log(u * u + tiny) * c(3))
        B = torch.exp(torch.log(v * v + tiny) * c(3))
        C = torch.exp(torch.log(w * w + tiny) * c(5))
        E = torch.exp(torch.log(A + B + tiny) * c(4))
        newly = (E + C <= 1.0) & (first == n_sweep)
        first = torch.where(newly, torch.full_like(first, j), first)
    hit = first < n_sweep
    tests = torch.where(hit, first + 1 + n_bisect,
                        torch.full_like(first, n_sweep))
    return int(tests.sum())


def phase_kernel(truths, dev) -> dict:
    """K3 against its plain version on the card, at both sweep settings;
    times and bound at the eval setting."""
    import torch

    from sqtpu_torch.ops.kernels.hardrender import render_depth_hard_cuda
    from sqtpu_torch.ops.render import render_depth_hard_batch

    p = torch.as_tensor(truths[:BATCH], device=dev)
    row = {}
    for n_sweep, n_bisect in ((EVAL_SWEEP, EVAL_BISECT),
                              (TRAIN_SWEEP, TRAIN_BISECT)):
        def kernel():
            return render_depth_hard_cuda(p, IMAGE, n_sweep, n_bisect, True)

        def plain():
            return render_depth_hard_batch(p, IMAGE, n_bisect=n_bisect,
                                           quantize=True, n_sweep=n_sweep)

        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"K3 gave {tuple(got.shape)}, finite="
                               f"{bool(torch.isfinite(got).all())}")
        off = gray_levels_off(got, ref)
        err = float((got - ref).abs().max())
        if not off < PIXEL_TOL:
            raise RuntimeError(
                f"K3 ({n_sweep}, {n_bisect}): {off:.2e} of pixels off by "
                f"more than one gray level (bound {PIXEL_TOL})")
        if float(got.max()) < 0.3:
            raise RuntimeError("K3 rendered nothing")
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain)
        tests = inside_tests(p, IMAGE, n_sweep, n_bisect)
        n_bytes = p.shape[0] * (24 * 4 + IMAGE * IMAGE * 4)
        ops = tests * OPS_PER_TEST
        bytes_ms = n_bytes / PEAK_BYTES * 1e3
        ops_ms = ops / PEAK_FP32_OPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        progress(f"K3 ({n_sweep}, {n_bisect}) B={p.shape[0]} S={IMAGE}: "
                 f"off>1 level {off:.2e}, max|err| {err:.4f}, kernel "
                 f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                 f"{bound_ms:.4f} ms ({tests} inside tests, "
                 f"{tests / (p.shape[0] * IMAGE * IMAGE):.2f} per pixel)")
        if (n_sweep, n_bisect) == (EVAL_SWEEP, EVAL_BISECT):
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms,
                   "bound_by": "operations" if ops_ms >= bytes_ms
                   else "bytes",
                   "frac_pixels_off": off}
        else:
            row["train_setting"] = {"n_sweep": n_sweep, "n_bisect": n_bisect,
                                    "frac_pixels_off": off,
                                    "max_abs_err": err, "ms": ms,
                                    "plain_ms": plain_ms,
                                    "bound_ms": bound_ms}
    return row


def phase_closed_loop(truths, recorded_pred, dev):
    """The recorded truths rendered by K3, predicted, scored at 128³."""
    import numpy as np
    import torch

    from sqtpu_torch.evaluate import load_eval_state, predict
    from sqtpu_torch.ops import metrics
    from sqtpu_torch.ops.kernels import hardrender, render_hard_auto
    from sqtpu_torch.utils.config import EvalConfig, resolve_device

    resolve_device(dev.type)
    model = load_eval_state(EvalConfig(ckpt_dir=WEIGHTS), dev)
    hardrender.reset_launches()
    preds, triples, first_imgs = [], [], None
    with torch.inference_mode():
        for lo in range(0, truths.shape[0], BATCH):
            p = torch.as_tensor(truths[lo:lo + BATCH], device=dev)
            imgs = render_hard_auto(p, IMAGE, n_sweep=EVAL_SWEEP,
                                    n_bisect=EVAL_BISECT, quantize=True)
            pred = predict(model, imgs[..., None])
            triples.append(metrics.iou_full(p, pred, 128).cpu().numpy())
            preds.append(pred.cpu().numpy())
            if first_imgs is None:
                first_imgs = imgs.cpu().numpy()
    launches = hardrender.launches
    preds, triples = np.concatenate(preds), np.concatenate(triples)
    if preds.shape != (truths.shape[0], 12) or not np.isfinite(preds).all():
        raise RuntimeError(f"predictions {preds.shape} not finite or "
                           "of the wrong shape")
    n_batches = -(-truths.shape[0] // BATCH)
    if launches != n_batches:
        raise RuntimeError(f"K3 launched {launches} times in the closed "
                           f"loop, expected {n_batches}")
    full_iou = float(triples[:, 1].mean())
    rot_iou = float(triples[:, 0].mean())
    dpred = np.abs(preds - recorded_pred)
    progress(f"closed loop on {truths.shape[0]} recorded truths: full IoU "
             f"{full_iou:.4f} (recorded {RECORDED_FULL_IOU:.4f}), rot-IoU "
             f"{rot_iou:.4f} (recorded {RECORDED_ROT_IOU:.4f}), K3 launches "
             f"{launches}; |pred - recorded pred| median "
             f"{float(np.median(dpred)):.2e} max {float(dpred.max()):.2e}")
    if abs(full_iou - RECORDED_FULL_IOU) > IOU_TOL \
            or abs(rot_iou - RECORDED_ROT_IOU) > IOU_TOL:
        raise RuntimeError(
            f"closed loop off the recorded run by more than {IOU_TOL}: "
            f"full {full_iou:.4f}, rot {rot_iou:.4f}")
    return preds, first_imgs, launches


def phase_eval_random(dev) -> int:
    """The user's entry point: ``eval_random`` on n=250."""
    import numpy as np

    from sqtpu_torch.evaluate import eval_random
    from sqtpu_torch.ops.kernels import hardrender
    from sqtpu_torch.utils.config import EvalConfig

    out_dir = tempfile.mkdtemp(prefix="sqtpu_torch_eval_")
    hardrender.reset_launches()
    res = eval_random(EvalConfig(ckpt_dir=WEIGHTS, n=250, batch_size=BATCH,
                                 out_dir=out_dir, device=dev.type))
    launches = hardrender.launches
    accs = os.path.join(out_dir, "accs.npz")
    if not os.path.exists(accs):
        raise RuntimeError("eval_random wrote no accs.npz")
    with np.load(accs) as d:
        if d["pred_params"].shape != (250, 12) \
                or not np.isfinite(d["pred_params"]).all():
            raise RuntimeError("eval_random's accs.npz is malformed")
    progress(f"eval_random n=250: full IoU {res['full_iou_mean']:.4f}, "
             f"rot-IoU {res['rot_iou_mean']:.4f}, K3 launches {launches}")
    if not res["full_iou_mean"] >= 0.85:
        raise RuntimeError(f"eval_random full IoU {res['full_iou_mean']}")
    if launches != 2:
        raise RuntimeError(f"eval_random launched K3 {launches} times, "
                           "expected 2")
    return launches


def phase_serve(imgs, preds, dev) -> None:
    """SQServer resident on the card answers K3-rendered images."""
    import numpy as np

    from sqtpu_torch.serve import ServeClient, SQServer
    from sqtpu_torch.utils.config import ServeConfig

    sock_dir = tempfile.mkdtemp(prefix="sqs")
    if len(sock_dir) > 90:  # a UNIX socket path has room for ~107 bytes
        sock_dir = tempfile.mkdtemp(prefix="sqs", dir="/tmp")
    sock = os.path.join(sock_dir, "s.sock")
    server = SQServer(ServeConfig(ckpt_dir=WEIGHTS, socket=sock,
                                  batch_size=64, device=dev.type))
    acceptor = threading.Thread(target=server.serve_forever,
                                kwargs={"join_timeout_s": 10.0},
                                name="sq-acceptor", daemon=True)
    acceptor.start()
    if not server.ready.wait(60):
        raise RuntimeError("server did not start listening")
    lat = []
    with ServeClient(sock, timeout_s=60) as client:
        if not client.ping():
            raise RuntimeError("ping failed")
        for i in range(8):
            img = np.rint(imgs[i] * 255.0).astype(np.uint8)
            t = time.perf_counter()
            resp = client.predict(img)
            lat.append((time.perf_counter() - t) * 1e3)
            d = np.abs(np.asarray(resp["params"]) - preds[i]).max()
            if not d <= SERVE_TOL:
                raise RuntimeError(f"request {i}: served params differ from "
                                   f"the closed loop's by {d:.2e}")
        stats = client.stats()
        if stats.get("requests") != 8:
            raise RuntimeError(f"server stats {stats}")
        client.shutdown()
    acceptor.join(timeout=10.0)
    alive = server.alive_threads() + ([acceptor] if acceptor.is_alive()
                                      else [])
    if alive:
        raise RuntimeError("server threads still alive after shutdown: "
                           + ", ".join(t.name for t in alive))
    progress(f"serve: 8 requests matched within {SERVE_TOL}; latency ms "
             f"per request {', '.join(f'{x:.2f}' for x in lat)}; "
             f"stats {json.dumps(stats)}; all threads joined")


def main() -> int:
    faulthandler.dump_traceback_later(600, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "sqtpu_torch")):
        print("chip_smoke: sqtpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from sqtpu_torch.ops.kernels import _build

    dev = torch.device("cuda")
    card = card_line()
    progress(f"phase 1 card: {card}; torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
             f"{torch.cuda.device_count()} device(s)")

    t = time.perf_counter()
    _build.build("hardrender")
    info = _build.build_log["hardrender"]
    progress(f"phase 2 built hardrender.cu in {time.perf_counter() - t:.1f}"
             f" s (nvcc {info['seconds']:.1f} s)")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print("    ptxas:", line.strip(), flush=True)

    with np.load(TRUTHS) as d:
        truths = d["true_params"].astype(np.float32)
        recorded_pred = d["pred_params"].astype(np.float32)

    row = phase_kernel(truths, dev)
    progress("phase 3 K3 matches its plain version at both settings")
    preds, imgs, loop_launches = phase_closed_loop(truths, recorded_pred,
                                                   dev)
    progress("phase 4 closed loop reproduces the recorded IoUs")
    launches = phase_eval_random(dev)
    progress("phase 5 eval_random done")
    phase_serve(imgs, preds, dev)
    progress("phase 6 serving done")

    kernels = [{"name": "hardrender", "route": "cuda",
                "source": "sqtpu_torch/csrc/hardrender.cu",
                "replaces": "sqtpu/ops/kernels/hardrender.py:50",
                "launches": launches,
                "launches_closed_loop": loop_launches,
                "library_ms": None, **row}]
    faulthandler.cancel_dump_traceback_later()
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
