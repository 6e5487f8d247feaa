"""Serving daemon: the model resident on the card, micro-batched inference.

Counterpart of ``sqtpu/serve.py:82-463``, with the same JSON-lines
protocol over a UNIX domain socket (default) or localhost TCP::

    {"id": 7, "path": "/abs/depth.bmp"}          # read a BMP from disk
    {"id": 8, "b64": "<base64 uint8 H*W>"}       # raw depth bytes inline
    {"cmd": "ping"}                              # liveness -> {"ok": true}
    {"cmd": "stats"}                             # counters
    {"cmd": "shutdown"}                          # drain and exit

Responses carry the normalized 12-vector and its reference-unit
de-normalization::

    {"id": 7, "params": [..12..], "denormalized": [..12..],
     "batch": 3, "latency_ms": 4.1}

Usage::

    python -m sqtpu_torch.serve --ckpt-dir artifacts/resnet_sq_c4_fp16.npz \
        --socket /tmp/sqtpu.sock --batch-size 64 [--device cpu]

Threads: one acceptor (the thread that calls :meth:`SQServer.serve_forever`),
one reader per connection feeding a bounded queue, and one batcher that
drains up to ``batch_size`` requests (waiting at most ``batch_window_ms``
after the first), pads them to ``batch_size`` and runs them as one call on
the device, the batch cleaned by ``input_filter`` there first and the
predictions refined with ``refine`` (``lm``, ``gd``, ``lm+gd``;
:func:`sqtpu_torch.fit.refine_params`) after. Only the batcher touches
the model.

Hardening contract (as in the JAX package):

- The request queue is bounded (``queue_factor * batch_size``); when it is
  full a predict request is answered ``{"error": "overloaded"}``.
- A batch-level failure answers every request of that batch with an error
  and the batcher keeps serving.
- Sends use a per-connection lock and an OS send timeout
  (``send_timeout_s``, SO_SNDTIMEO): a stalled client stalls only itself
  and is dropped on timeout.
- A UNIX socket is as trusted as its file permissions. Over TCP, ``path``
  requests are refused unless ``--path-root`` confines them to a subtree
  (realpath, so symlinks cannot escape). Clients get sanitized errors.
- Startup refuses to take over a live server's UNIX socket; only a stale
  one is unlinked.
- Shutdown stops the acceptor, lets the batcher drain the queue, shuts
  down every open connection so its reader returns, and joins every
  thread with a timeout. :meth:`SQServer.alive_threads` then names any thread
  that did not end.
"""

from __future__ import annotations

import base64
import json
import os
import queue
import socket
import struct
import threading
import time

import numpy as np
import torch

from sqtpu_torch.fit import apply_prefilter
from sqtpu_torch.utils.config import (
    ServeConfig, check_slice, parse_cli, resolve_device,
)

__all__ = ["ServeConfig", "SQServer", "ServeClient", "main"]


class _Conn:
    """A client connection plus its send lock."""

    __slots__ = ("sock", "lock")

    def __init__(self, sock):
        self.sock, self.lock = sock, threading.Lock()


class _Request:
    __slots__ = ("conn", "rid", "img", "t0")

    def __init__(self, conn, rid, img, t0):
        self.conn, self.rid, self.img, self.t0 = conn, rid, img, t0


class SQServer:
    """Resident-model inference server (see the module docstring)."""

    def __init__(self, cfg: ServeConfig):
        check_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=max(1, cfg.queue_factor) * cfg.batch_size)
        self._stop = threading.Event()
        self._lock = threading.Lock()   # guards stats, _conns, _threads
        self._conns: set = set()
        self._threads: list = []
        self.ready = threading.Event()  # set once the socket listens
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "overloaded": 0, "batch_failures": 0}
        self._build()

    # ---- model -----------------------------------------------------

    def _build(self):
        from sqtpu_torch.evaluate import load_eval_state, predict, refine_fn

        cfg = self.cfg
        model = load_eval_state(cfg, self.device)
        refine = refine_fn(cfg)

        def run(batch_np: np.ndarray) -> np.ndarray:
            x = apply_prefilter(torch.from_numpy(batch_np).to(self.device),
                                cfg.input_filter)
            return refine(x, predict(model, x[..., None])).cpu().numpy()

        self._run = run
        # pay the first call (cuDNN set-up) before accepting traffic
        self._run(np.zeros((cfg.batch_size, cfg.image_size,
                            cfg.image_size), np.float32))

    def _count(self, key: str, n: int = 1):
        with self._lock:
            self.stats[key] += n

    # ---- request decoding -------------------------------------------

    def _resolve_path(self, path: str) -> str:
        cfg = self.cfg
        if not cfg.socket and not cfg.path_root:
            raise ValueError(
                "'path' requests are disabled over TCP; send 'b64' "
                "or start the server with --path-root")
        real = os.path.realpath(path)
        if cfg.path_root:
            root = os.path.realpath(cfg.path_root)
            if not (real == root or real.startswith(root + os.sep)):
                raise ValueError("path is outside the configured root")
        return real

    def _decode_image(self, msg: dict) -> np.ndarray:
        s = self.cfg.image_size
        if "path" in msg:
            from sqtpu_torch.data.bmp import read_bmp
            path = self._resolve_path(str(msg["path"]))
            try:
                img = read_bmp(path).astype(np.float32) / 255.0
            except (OSError, ValueError) as e:
                print(f"sqtpu_torch.serve: read failed for {path!r}: {e}",
                      flush=True)
                raise ValueError("could not read image") from None
        elif "b64" in msg:
            raw = np.frombuffer(base64.b64decode(msg["b64"]), np.uint8)
            if raw.size != s * s:
                raise ValueError(
                    f"b64 payload has {raw.size} bytes, expected {s * s}")
            img = raw.reshape(s, s).astype(np.float32) / 255.0
        else:
            raise ValueError("request needs 'path' or 'b64'")
        if img.shape != (s, s):
            raise ValueError(f"image is {img.shape}, expected {(s, s)}")
        return img

    def _send(self, conn: _Conn, obj: dict):
        data = (json.dumps(obj) + "\n").encode()
        with conn.lock:
            try:
                conn.sock.sendall(data)
            except OSError:
                # the client left, or SO_SNDTIMEO fired: drop it
                try:
                    conn.sock.close()
                except OSError:
                    pass

    # ---- connection handling ----------------------------------------

    def _serve_conn(self, conn: _Conn):
        f = conn.sock.makefile("rb")
        try:
            for line in f:
                if self._stop.is_set():
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError as e:
                    self._count("errors")
                    self._send(conn, {"error": f"bad json: {e}"})
                    continue
                cmd = msg.get("cmd")
                if cmd == "ping":
                    self._send(conn, {"ok": True})
                elif cmd == "stats":
                    with self._lock:
                        stats = dict(self.stats)
                    self._send(conn, {"ok": True, **stats})
                elif cmd == "shutdown":
                    self._send(conn, {"ok": True, "shutting_down": True})
                    self._stop.set()
                    break
                else:
                    try:
                        img = self._decode_image(msg)
                    except Exception as e:  # a bad request; keep serving
                        self._count("errors")
                        self._send(conn, {"id": msg.get("id"),
                                          "error": str(e)})
                        continue
                    req = _Request(conn, msg.get("id"), img,
                                   time.perf_counter())
                    try:
                        self._queue.put_nowait(req)
                    except queue.Full:
                        self._count("overloaded")
                        self._send(conn, {"id": msg.get("id"),
                                          "error": "overloaded"})
        except OSError:
            pass  # the connection was shut down under the reader
        finally:
            f.close()
            with self._lock:
                self._conns.discard(conn)
            conn.sock.close()

    def _start_thread(self, target, *args, name: str):
        t = threading.Thread(target=target, args=args, name=name,
                             daemon=True)
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()
        return t

    def _accept_loop(self, sock):
        sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                raw, _ = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            raw.settimeout(None)
            if self.cfg.send_timeout_s > 0:
                sec = int(self.cfg.send_timeout_s)
                usec = int((self.cfg.send_timeout_s - sec) * 1e6)
                raw.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                               struct.pack("ll", sec, usec))
            conn = _Conn(raw)
            with self._lock:
                self._conns.add(conn)
            self._start_thread(self._serve_conn, conn, name="sq-reader")

    # ---- the batcher (the only thread that touches the model) --------

    def _batch_loop(self):
        cfg = self.cfg
        while not self._stop.is_set() or not self._queue.empty():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            reqs = [first]
            deadline = time.perf_counter() + cfg.batch_window_ms / 1e3
            while len(reqs) < cfg.batch_size:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    reqs.append(self._queue.get(timeout=left))
                except queue.Empty:
                    break
            try:
                batch = np.zeros(
                    (cfg.batch_size, cfg.image_size, cfg.image_size),
                    np.float32)
                for i, r in enumerate(reqs):
                    batch[i] = r.img
                params = self._run(batch)[: len(reqs)]
                self._count("batches")
                self._count("requests", len(reqs))
                now = time.perf_counter()
                for r, p in zip(reqs, params):
                    resp = {"id": r.rid,
                            "params": [float(v) for v in p],
                            "batch": len(reqs),
                            "latency_ms": round((now - r.t0) * 1e3, 2)}
                    if cfg.denormalize:
                        from sqtpu_torch.data.labels import denormalize_torch
                        resp["denormalized"] = [
                            float(v) for v in denormalize_torch(p)]
                    self._send(r.conn, resp)
            except Exception as e:  # the batcher must outlive a bad batch
                self._count("batch_failures")
                self._count("errors", len(reqs))
                print(f"sqtpu_torch.serve: batch failed: {e!r}", flush=True)
                for r in reqs:
                    self._send(r.conn, {"id": r.rid,
                                        "error": "inference failed"})

    # ---- lifecycle ----------------------------------------------------

    def _listen(self):
        cfg = self.cfg
        if cfg.socket:
            if os.path.exists(cfg.socket):
                probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                probe.settimeout(1.0)
                try:
                    probe.connect(cfg.socket)
                except OSError:
                    os.unlink(cfg.socket)  # a dead leftover
                else:
                    raise SystemExit(
                        f"sqtpu_torch.serve: a server is already listening "
                        f"on {cfg.socket}; shut it down or pick another "
                        f"--socket")
                finally:
                    probe.close()
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.bind(cfg.socket)
            where = cfg.socket
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((cfg.host, cfg.port))
            where = f"{cfg.host}:{cfg.port}"
        sock.listen(128)
        return sock, where

    def serve_forever(self, join_timeout_s: float = 5.0):
        """Serve until a ``shutdown`` request, then join every thread this
        server started: the batcher within ``join_timeout_s``, then the
        readers within another ``join_timeout_s``."""
        cfg = self.cfg
        sock, where = self._listen()
        batcher = self._start_thread(self._batch_loop, name="sq-batcher")
        print(f"sqtpu_torch.serve: model {cfg.model} ready on {where} "
              f"(device {self.device}, batch<= {cfg.batch_size}, window "
              f"{cfg.batch_window_ms} ms)", flush=True)
        self.ready.set()
        try:
            self._accept_loop(sock)
        finally:
            self._stop.set()
            sock.close()
            batcher.join(timeout=join_timeout_s)  # drains the queue first
            with self._lock:
                conns = list(self._conns)
            for conn in conns:  # wake readers blocked in readline
                try:
                    conn.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            deadline = time.monotonic() + join_timeout_s
            for t in self.threads():
                t.join(timeout=max(0.0, deadline - time.monotonic()))
            if cfg.socket and os.path.exists(cfg.socket):
                os.unlink(cfg.socket)

    def threads(self) -> list:
        with self._lock:
            return list(self._threads)

    def alive_threads(self) -> list:
        """Threads of this server that are still running."""
        return [t for t in self.threads() if t.is_alive()]


class ServeClient:
    """Minimal blocking client for :class:`SQServer`. ``address`` is a
    UNIX socket path or a ``(host, port)`` tuple; ``timeout_s`` bounds
    every send and receive."""

    def __init__(self, address, timeout_s: float | None = 60.0):
        family = socket.AF_UNIX if isinstance(address, str) \
            else socket.AF_INET
        self._sock = socket.socket(family, socket.SOCK_STREAM)
        self._sock.settimeout(timeout_s)
        self._sock.connect(address)
        self._file = self._sock.makefile("rb")
        self._next_id = 0

    def _rpc(self, msg: dict) -> dict:
        self._sock.sendall((json.dumps(msg) + "\n").encode())
        line = self._file.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    def ping(self) -> bool:
        return bool(self._rpc({"cmd": "ping"}).get("ok"))

    def stats(self) -> dict:
        return self._rpc({"cmd": "stats"})

    def shutdown(self):
        try:
            self._rpc({"cmd": "shutdown"})
        except ConnectionError:
            pass

    def predict(self, image) -> dict:
        """``image`` = BMP path (str) or (H, W) array in [0, 1] / uint8.
        Returns the full response (``params`` = normalized 12-vector)."""
        self._next_id += 1
        if isinstance(image, str):
            msg = {"id": self._next_id, "path": os.path.abspath(image)}
        else:
            arr = np.asarray(image)
            if arr.dtype != np.uint8:
                arr = np.clip(np.asarray(arr, np.float32) * 255.0,
                              0, 255).astype(np.uint8)
            msg = {"id": self._next_id,
                   "b64": base64.b64encode(arr.tobytes()).decode()}
        resp = self._rpc(msg)
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return resp

    def close(self):
        self._file.close()
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def main(argv=None):
    SQServer(parse_cli(ServeConfig, argv)).serve_forever()


if __name__ == "__main__":
    main()
