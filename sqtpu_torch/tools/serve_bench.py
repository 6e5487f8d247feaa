"""Load test of the serving daemon: concurrent clients, p50/p90/p99 latency.

Counterpart of ``tools/serve_bench.py``: end-to-end request latency
(client send to response parsed) under K concurrent clients, and the
sustained rate, against a live ``python -m sqtpu_torch.serve``. The
N_IMAGES (32) request BMPs are rendered first, on ``--device`` (K3 on the card at 256²,
the full sweep, 30 bisections, quantized), before the server is spawned;
the server runs on the same device. After ``ping`` answers, one client
warms every path once, then the clients start together behind a barrier.
The report (also written to ``--out``) has p50, p90, p99, mean and max
latency, req/s and the server's stats; ``first_responses`` holds each
client's first answer and the name of its image (the images are
:func:`render_request_images`' and are deleted after the run)::

    python -m sqtpu_torch.tools.serve_bench \\
        --ckpt artifacts/resnet_sq_c4_fp16.npz [--device cpu] \\
        [--clients 8] [--requests 100] [--out runs/port_serve_bench.json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_IMAGES = 32  # request images, each client takes every clients-th one


def render_request_images(n: int, out_dir: str, device, seed: int = 0):
    """``n`` random superquadrics (the training distribution) rendered on
    ``device`` at 256², the full sweep, 30 bisections, quantized, and
    written as BMPs. Returns their paths."""
    import numpy as np
    import torch

    from sqtpu_torch.data.bmp import write_bmp
    from sqtpu_torch.data.synthetic import sample_params
    from sqtpu_torch.ops.kernels import render_hard_auto

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    imgs = render_hard_auto(sample_params(n, gen), 256, n_sweep=256,
                            n_bisect=30, quantize=True).cpu().numpy()
    paths = []
    for i in range(n):
        p = os.path.join(out_dir, f"req_{i:03d}.bmp")
        write_bmp(p, (imgs[i] * 255.0 + 0.5).astype(np.uint8))
        paths.append(p)
    return paths


def client_worker(sock_path: str, paths: list, n_requests: int,
                  latencies: list, errors: list, first: list,
                  barrier: threading.Barrier):
    """One client: ping, wait at the barrier, then ``n_requests``
    requests over ``paths`` in turn. Its latencies (ms) go to
    ``latencies``, failures to ``errors``, its first answer to ``first``."""
    from sqtpu_torch.serve import ServeClient

    with ServeClient(sock_path) as c:
        c.ping()
        barrier.wait()
        my_lat = []
        for i in range(n_requests):
            path = paths[i % len(paths)]
            t0 = time.perf_counter()
            try:
                r = c.predict(path)
            except (RuntimeError, OSError, ValueError) as exc:
                errors.append(str(exc))
                continue
            my_lat.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                first.append({"image": os.path.basename(path),
                              "params": r["params"]})
    latencies.extend(my_lat)


def wait_for_server(sock: str, server: subprocess.Popen, log: str,
                    timeout_s: float = 900.0) -> None:
    """Return once the daemon answers ``ping``; raise with the end of its
    ``log`` if it exits or ``timeout_s`` passes first."""
    from sqtpu_torch.serve import ServeClient

    deadline = time.time() + timeout_s
    while True:
        try:
            with ServeClient(sock) as c:
                if c.ping():
                    return
        except OSError:
            pass
        if time.time() > deadline or server.poll() is not None:
            with open(log) as f:
                out = f.read()
            raise RuntimeError(f"server did not come up:\n{out[-2000:]}")
        time.sleep(0.5)


def run(args) -> dict:
    """Render, spawn the server, warm up, load it and report."""
    from sqtpu_torch.serve import ServeClient
    from sqtpu_torch.utils.config import resolve_device

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="sqtpu_serve_bench_") as tmp:
        paths = render_request_images(N_IMAGES, tmp, device)
        print(f"rendered {len(paths)} request images ({device.type})",
              flush=True)
        sock = args.socket or os.path.join(tmp, "s.sock")
        if len(sock) > 100:  # a UNIX socket path has room for ~107 bytes
            raise ValueError(f"socket path too long ({len(sock)} bytes): "
                             "pass a shorter --socket")
        log = os.path.join(tmp, "server.log")
        with open(log, "w") as log_f:
            server = subprocess.Popen(
                [sys.executable, "-m", "sqtpu_torch.serve", "--ckpt-dir",
                 args.ckpt, "--socket", sock, "--batch-size",
                 str(args.batch_size), "--batch-window-ms",
                 str(args.batch_window_ms), "--device", args.device],
                cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT)
        try:
            wait_for_server(sock, server, log)
            # warm-up: one client touches every image path once
            with ServeClient(sock) as warm:
                t0 = time.perf_counter()
                for p in paths:
                    warm.predict(p)
            print(f"warmup done ({time.perf_counter() - t0:.1f}s)",
                  flush=True)

            latencies, errors, first = [], [], []
            barrier = threading.Barrier(args.clients)
            threads = [threading.Thread(
                target=client_worker,
                args=(sock, paths[i::args.clients] or paths, args.requests,
                      latencies, errors, first, barrier))
                for i in range(args.clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            with ServeClient(sock) as c:
                stats = c.stats()
                c.shutdown()
            server.wait(timeout=60)
        finally:
            if server.poll() is None:
                server.terminate()
                try:
                    server.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    server.kill()
                    server.wait()

    latencies.sort()
    n = len(latencies)

    def pct(q):
        return latencies[min(n - 1, int(q * n))] if n else None
    report = {
        "ckpt": args.ckpt, "device": device.type,
        "clients": args.clients, "requests_per_client": args.requests,
        "completed": n, "errors": len(errors), "wall_s": wall,
        "req_per_s": n / wall if wall else None,
        "latency_ms": {"p50": pct(0.50), "p90": pct(0.90),
                       "p99": pct(0.99),
                       "mean": statistics.fmean(latencies) if n else None,
                       "max": latencies[-1] if n else None},
        "server_stats": {k: stats.get(k) for k in
                         ("requests", "batches", "errors", "overloaded",
                          "batch_failures")},
        "first_responses": first,
    }
    if errors:
        print("sample errors:", errors[:5], file=sys.stderr)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", default="runs/port_serve_bench.json")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=100,
                    help="requests per client (after warmup)")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--batch-window-ms", type=float, default=2.0)
    ap.add_argument("--socket", default="",
                    help="UNIX socket path (default: one in a temporary "
                    "directory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda | cpu, for the renders and the server")
    args = ap.parse_args(argv)
    report = run(args)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
