"""The multi-rank gates of the port, and the jobs that run on spawned ranks.

Counterpart of ``__graft_entry__.dryrun_multichip``, ``_dryrun_impl`` and
``multistep_convergence_gate`` (``__graft_entry__.py:33-321``)::

    python -m sqtpu_torch.parallel.dryrun [--ranks 2] [--device cpu]

:func:`dryrun` spawns the ranks itself (``gloo`` on the CPU, or ranks
sharing one card; ``nccl`` when each rank has a card of its own) and runs
one train step of each layout, on tiny shapes, against one rank on the
same batch, with the JAX package's gates (loss within 1e-5 relative,
gradient norm within 1e-3 relative):

* ``grid-sharded``: the implicit loss split by image columns over the grid
  axis, plain slab render;
* ``grid-sharded-kernel``: the same through K6 (on the card; its plain
  route on the CPU);
* ``kernel-dp``: the batch over the data axis, K1/K2 on each rank's rows;
* ``explicit-sym-dp``: the supervised recipe's objective, K4 on each
  rank's rows;
* ``refine-dp``: the same objective on the ``refine_sq`` corrector (one
  pass, the in-loop render at 8 slabs: K3 on each rank's rows; its two
  encoders' BatchNorm over the data group), the base from the c4
  artifact.

With an even number of ranks the grid layouts put two ranks on the grid
axis; the JAX package does that only from four devices, so at two ranks
it never sharded the grid. Then the convergence gate: 20 steps of
data-parallel ``explicit_sym`` training against one rank from the same
weights on the same batches: final loss within 1e-2 relative, validation
IoU within 1e-2, BatchNorm statistics within 0.05 of their scale.

The workers live in this module, which imports only torch and the port: a
spawned process imports its target's module, and the test suite's
``conftest.py`` imports JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import multiprocessing
import os
import queue as queue_mod
import socket
import sys
import time
import traceback

import numpy as np
import torch

from sqtpu_torch.data.synthetic import make_batch
from sqtpu_torch.models import build_model, warm_start_base
from sqtpu_torch.models.resnet import use_global_batch_stats
from sqtpu_torch.ops.kernels import launch_counts, reset_launches
from sqtpu_torch.parallel.mesh import (
    Layout, join, make_layout, shutdown,
)
from sqtpu_torch.parallel.sharded_losses import (
    implicit_loss_dp, implicit_loss_gridsharded, make_batch_dp,
)
from sqtpu_torch.training.loop import make_eval_step, make_train_step
from sqtpu_torch.training.state import create_train_state
from sqtpu_torch.utils.checkpoint import load_weights_npz
from sqtpu_torch.utils.config import TrainConfig, resolve_device

SPAWN_TIMEOUT_S = 900.0
VAL_IMAGE = 256
LOSS_RTOL, GRAD_NORM_RTOL = 1e-5, 1e-3          # __graft_entry__.py:196-210
CONVERGE_LOSS_RTOL, CONVERGE_IOU_ATOL, BN_DRIFT = 1e-2, 1e-2, 0.05  # :305-318


# ---------------------------------------------------------------------------
# Spawning ranks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, device: str, plan: list,
            threads: int, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    try:
        dev = join(resolve_device(device))
        try:
            out = [job(make_layout(n_grid, dev), spec)
                   for n_grid, job, spec in plan]
        finally:
            shutdown()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(n_ranks: int, plan: list, device: str = "cpu",
          timeout_s: float = SPAWN_TIMEOUT_S, threads: int = 2) -> list:
    """Run ``plan``, a list of ``(n_grid, job, spec)``, in order on
    ``n_ranks`` processes spawned here: each joins one process group and
    calls ``job(layout, spec)`` with the layout of ``n_grid`` grid ranks.
    Returns ``results[rank][i]``, job i's return value on each rank.
    Raises with a rank's traceback when one fails, and ``TimeoutError``
    after ``timeout_s``; every child is gone when it returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, n_ranks, port, device,
                                               plan, threads, results),
                         daemon=True)
             for r in range(n_ranks)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(out) < n_ranks:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank process {dead[0].name} exited "
                                       f"with {dead[0].exitcode}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks did not finish "
                                       f"within {timeout_s:.0f} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"rank process {p.name} exited with "
                                   f"{p.exitcode}")
    finally:
        for p in procs:
            if p.pid is None:
                continue  # never started
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    return [out[r] for r in range(n_ranks)]


# ---------------------------------------------------------------------------
# Jobs: module-level functions that a spawned rank runs
# ---------------------------------------------------------------------------

def deterministic(on: bool = True) -> None:
    """cuDNN's and torch's deterministic algorithms (warning where an
    operation has none): two runs then repeat to the bit."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(on, warn_only=True)


def build_resnet(weights: str | None, device: torch.device,
                 model: str = "resnet_sq"):
    """ResNetSQ from ``weights`` (a portable npz), or from seed 0; with
    ``model="refine_sq"`` the corrector of the JAX dryrun (one pass, 8
    slabs) from seed 0, its base from ``weights``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if model == "refine_sq":
            net = build_model(model, n_refine=1, n_sweep=8)
            if weights:
                warm_start_base(net, weights)
            return net.to(device)
        net = build_model(model)
    if weights:
        load_weights_npz(weights, net)
    return net.to(device)


def state_digest(model: torch.nn.Module) -> str:
    """sha256 of every parameter and buffer's bytes, in order."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _batch(layout: Layout, spec: dict, cfg: TrainConfig):
    """This rank's rows of the spec's batch: given (``batch``, the global
    batch's arrays or tensors), rendered from a seed (``seed``: the global batch,
    every rank keeps its rows) or drawn per rank (``dp_seed``:
    :func:`make_batch_dp`)."""
    dev = layout.device
    rows = layout.rows(cfg.batch_size)
    if "batch" in spec:
        imgs, labels = spec["batch"]
        return (torch.as_tensor(imgs[rows], device=dev),
                torch.as_tensor(labels[rows], device=dev))
    gen = torch.Generator(device=dev)
    if "dp_seed" in spec:
        gen.manual_seed(spec["dp_seed"])
        return make_batch_dp(gen, cfg.batch_size, layout, cfg.image_size)
    gen.manual_seed(spec["seed"])
    return make_batch(gen, cfg.batch_size, cfg.image_size, rows=rows)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_job(layout: Layout, spec: dict) -> dict:
    """One train step of ``spec["cfg"]`` (``make_train_step``) on this
    rank's rows, from ``spec["weights"]`` (or seed 0). Returns the loss,
    the norm of the averaged gradient, the BatchNorm statistics after the
    step, the digest of the model after the step, the launch counts of
    the batch's rendering and the step, the step's time and the peak
    memory; with ``spec["grads"]`` every parameter's gradient, with
    ``spec["dp_seed"]`` this rank's rows."""
    cfg, dev = spec["cfg"], layout.device
    model = build_resnet(spec.get("weights"), dev, cfg.model)
    use_global_batch_stats(model, layout.data_group)
    state = create_train_state(model, cfg)
    step = make_train_step(state, cfg, layout)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    imgs, labels = _batch(layout, spec, cfg)
    _sync(dev)
    t0 = time.perf_counter()
    loss = step(imgs, labels)
    _sync(dev)
    seconds = time.perf_counter() - t0
    grads = {n: p.grad for n, p in model.named_parameters()}
    out = {"loss": float(loss),
           "grad_norm": float(torch.sqrt(sum(torch.sum(g.double() ** 2)
                                             for g in grads.values()))),
           "stats": {n: b.detach().cpu().numpy()
                     for n, b in model.named_buffers()
                     if b.is_floating_point()},
           "digest": state_digest(model), "launches": launch_counts(),
           "seconds": seconds, "rank": layout.rank,
           "layout": (layout.n_data, layout.n_grid),
           "max_memory": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None)}
    if spec.get("grads"):
        out["grads"] = {n: g.cpu().numpy() for n, g in grads.items()}
    if "dp_seed" in spec:
        out["batch"] = (imgs.cpu().numpy(), labels.cpu().numpy())
    return out


def loss_job(layout: Layout, spec: dict) -> dict:
    """The implicit loss of the global batch ``spec["batch"]`` = (images
    (B, H, W), params (B, 12)) in the spec's dtype, grid-sharded
    (``spec["kind"] == "grid"``) or data-parallel, and its gradient with
    respect to this rank's rows of the params (divided by the data axis:
    each data rank's copy of the loss sends its rows the cotangent of all
    the copies). Returns the value, the rows and their gradient."""
    imgs, p = spec["batch"]
    rows = layout.rows(p.shape[0])
    img = torch.as_tensor(imgs[rows], device=layout.device)
    pp = torch.as_tensor(p[rows], device=layout.device).requires_grad_(True)
    if spec["kind"] == "grid":
        loss = implicit_loss_gridsharded(img, pp, layout, spec["n"],
                                         use_pallas=spec.get("use_pallas",
                                                             True))
    else:
        loss = implicit_loss_dp(img, pp, layout, spec["n"])
    loss.backward()
    grad = pp.grad / layout.n_data
    return {"loss": float(loss.detach()), "rows": (rows.start, rows.stop),
            "grad": grad.cpu().numpy()}


def converge_job(layout: Layout, spec: dict) -> dict:
    """A train step of ``spec["cfg"]`` from ``spec["weights"]`` on the
    global batch of each of ``spec["seeds"]`` but the last, then the
    validation IoU of the last one. Returns the last loss, the IoU and
    the BatchNorm statistics."""
    cfg, dev = spec["cfg"], layout.device
    if spec.get("deterministic"):
        deterministic()
    model = build_resnet(spec.get("weights"), dev)
    use_global_batch_stats(model, layout.data_group)
    state = create_train_state(model, cfg)
    step = make_train_step(state, cfg, layout)
    reset_launches()
    for seed in spec["seeds"][:-1]:
        loss = step(*_batch(layout, {"seed": seed}, cfg))
    # validated on the artifact's own 256² images
    val = _batch(layout, {"seed": spec["seeds"][-1]},
                 dataclasses.replace(cfg, image_size=VAL_IMAGE))
    _, acc, _, _ = make_eval_step(state, cfg, layout)(*val)
    return {"loss": float(loss), "iou": float(acc),
            "stats": {n: b.detach().cpu().numpy()
                      for n, b in model.named_buffers()
                      if b.is_floating_point()},
            "digest": state_digest(model), "launches": launch_counts()}


# ---------------------------------------------------------------------------
# The gates
# ---------------------------------------------------------------------------

# name -> (grid layout, use_pallas, loss, model)
LAYOUTS = {
    "grid-sharded": (True, False, "implicit", "resnet_sq"),
    "grid-sharded-kernel": (True, True, "implicit", "resnet_sq"),
    "kernel-dp": (False, True, "implicit", "resnet_sq"),
    "explicit-sym-dp": (False, True, "explicit_sym", "resnet_sq"),
    "refine-dp": (False, True, "explicit_sym", "refine_sq"),
}
_ART = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "artifacts")
WEIGHTS = {"implicit": os.path.join(_ART, "resnet_sq_ssl_fp16.npz"),
           "explicit_sym": os.path.join(_ART, "resnet_sq_c4_fp16.npz")}


def check_step_parity(name: str, ranks: list, one: dict,
                      stats_rtol: float | None = None) -> str:
    """Raise unless every rank's step equals the one-rank step ``one``
    within the JAX package's gates (and, with ``stats_rtol``, the
    BatchNorm statistics), and the ranks hold one model after it.
    Returns a summary line."""
    r0 = ranks[0]
    if len({r["digest"] for r in ranks}) != 1:
        raise AssertionError(f"[{name}] the ranks' parameters or buffers "
                             "differ after the step")
    d_loss = abs(r0["loss"] - one["loss"])
    if not d_loss <= LOSS_RTOL * max(1.0, abs(one["loss"])):
        raise AssertionError(f"loss parity broke [{name}]: {r0['loss']!r} "
                             f"vs one rank {one['loss']!r}")
    d_gn = abs(r0["grad_norm"] - one["grad_norm"])
    if not d_gn <= GRAD_NORM_RTOL * max(1.0, abs(one["grad_norm"])):
        raise AssertionError(f"grad-norm parity broke [{name}]: "
                             f"{r0['grad_norm']!r} vs {one['grad_norm']!r}")
    worst_stat = 0.0
    if stats_rtol is not None:
        for key, want in one["stats"].items():
            got = r0["stats"][key]
            err = np.abs(got - want)
            if not np.all(err <= stats_rtol * np.abs(want) + 1e-6):
                raise AssertionError(f"[{name}] BatchNorm {key} differs "
                                     f"from one rank by {err.max():.2e}")
            worst_stat = max(worst_stat, float(err.max()))
    return (f"[{name}] layout {r0['layout']}: loss {r0['loss']:.7f} "
            f"(one rank {one['loss']:.7f}, |d| {d_loss:.2e}), grad norm "
            f"{r0['grad_norm']:.6g} (rel {d_gn / one['grad_norm']:.2e}), "
            f"|BN stat d| {worst_stat:.2e}")


def _layout_spec(name: str, n_ranks: int, device: torch.device):
    grid, use_pallas, loss, model = LAYOUTS[name]
    n_grid = 2 if grid and n_ranks % 2 == 0 else 1
    n_data = n_ranks // n_grid
    cfg = TrainConfig(image_size=64, render_size=16, batch_size=2 * n_data,
                      use_pallas=use_pallas, n_grid=n_grid, loss=loss,
                      model=model, device=device.type)
    if use_pallas:
        # each rank renders its own rows (make_batch_dp), as the JAX dryrun
        return n_grid, {"cfg": cfg, "dp_seed": 1,
                        "weights": WEIGHTS.get(loss)}
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    imgs, labels = make_batch(gen, cfg.batch_size, 64)
    return n_grid, {"cfg": cfg, "weights": WEIGHTS.get(loss),
                    "batch": (imgs.cpu().numpy(), labels.cpu().numpy())}


def _gathered(ranks: list) -> tuple:
    """The global batch from the ranks' rows, in data order."""
    firsts = {}
    for r in ranks:
        firsts.setdefault(r["rank"] // r["layout"][1], r["batch"])
    parts = [firsts[d] for d in sorted(firsts)]
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(2))


def bn_drift(stats_n: dict, stats_1: dict) -> float:
    """The largest scale-aware gap of two models' BatchNorm statistics
    (``__graft_entry__.py:299-306``): means against their running std
    plus 1e-2, variances against themselves plus 1e-2."""
    drift = 0.0
    for k, want in stats_1.items():
        d = np.abs(stats_n[k] - want)
        if k.endswith("running_mean"):
            scale = np.sqrt(stats_1[k.replace("running_mean",
                                              "running_var")]) + 1e-2
        else:
            scale = np.abs(want) + 1e-2
        drift = max(drift, float(np.max(d / scale)))
    return drift


def convergence_plan(n_ranks: int, device: torch.device, steps: int = 20,
                     det: bool = False) -> dict:
    """The spec of :func:`converge_job` for the 20-step gate: explicit_sym
    through the kernels, Adam at 1e-4, batch 2 per rank, 64² images,
    render size 16, from the c4 artifact; batch i is rendered by every
    rank from seed 7000 + i."""
    cfg = TrainConfig(image_size=64, render_size=16, acc_render_size=16,
                      batch_size=2 * n_ranks, use_pallas=True,
                      loss="explicit_sym", learning_rate=1e-4,
                      device=device.type)
    return {"cfg": cfg, "seeds": [7_000 + i for i in range(steps + 1)],
            "deterministic": det, "weights": WEIGHTS["explicit_sym"]}


def check_convergence(ranks: list, one: dict) -> str:
    """The 20-step gate (``__graft_entry__.py:307-318``)."""
    r0 = ranks[0]
    if len({r["digest"] for r in ranks}) != 1:
        raise AssertionError("the ranks' models differ after the steps")
    drift = bn_drift(r0["stats"], one["stats"])
    if not abs(r0["loss"] - one["loss"]) <= CONVERGE_LOSS_RTOL * max(
            1.0, abs(one["loss"])):
        raise AssertionError(f"20-step loss diverged: {r0['loss']!r} vs "
                             f"one rank {one['loss']!r}")
    if not abs(r0["iou"] - one["iou"]) <= CONVERGE_IOU_ATOL:
        raise AssertionError(f"20-step val IoU diverged: {r0['iou']!r} vs "
                             f"{one['iou']!r}")
    if not drift <= BN_DRIFT:
        raise AssertionError(f"20-step BatchNorm statistics diverged: "
                             f"drift {drift:.2e}")
    return (f"convergence gate ok: {len(ranks)} data ranks vs one, loss "
            f"{r0['loss']:.6f}/{one['loss']:.6f}, val IoU {r0['iou']:.4f}/"
            f"{one['iou']:.4f}, BN stat drift {drift:.2e}")


def dryrun(n_ranks: int = 2, device: str = "cuda", steps: int = 20,
           layouts=tuple(LAYOUTS), timeout_s: float = SPAWN_TIMEOUT_S,
           say=print) -> dict:
    """One train step of each of ``layouts`` on ``n_ranks`` spawned ranks
    against one spawned rank on the same batch, then the ``steps``-step
    convergence gate; raises on the first gate that fails. Returns the
    ranks' results by layout name (and ``"convergence"``).

    The one rank is a spawned process too: a process that has run other
    work first (this one rendered the batches) may pick other CPU
    convolution kernels, and at these tiny shapes from random weights the
    gradient norm magnifies their last-bit differences to ~1e-3."""
    dev = resolve_device(device)
    det = dev.type == "cuda"
    specs = {name: _layout_spec(name, n_ranks, dev) for name in layouts}
    conv = convergence_plan(n_ranks, dev, steps, det)
    plan = [(n_grid, step_job, spec) for n_grid, spec in specs.values()]
    plan.append((1, converge_job, conv))
    results = spawn(n_ranks, plan, device, timeout_s)
    one_plan = []
    for i, (_, spec) in enumerate(specs.values()):
        if "dp_seed" in spec:
            spec = {"cfg": spec["cfg"], "weights": spec["weights"],
                    "batch": _gathered([r[i] for r in results])}
        one_plan.append((1, step_job, spec))
    one_plan.append((1, converge_job, conv))
    one = spawn(1, one_plan, device, timeout_s)[0]
    out = {}
    for i, name in enumerate(specs):
        ranks = [r[i] for r in results]
        say("dryrun ok " + check_step_parity(name, ranks, one[i]))
        out[name] = ranks
    ranks = [r[-1] for r in results]
    say(check_convergence(ranks, one[-1]))
    out["convergence"] = ranks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    dryrun(args.ranks, args.device, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
