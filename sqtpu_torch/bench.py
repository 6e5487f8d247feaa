"""Headline benchmark of the port: rotated-SQ training throughput.

Counterpart of the JAX package's ``bench.py``. It measures, in steady
state, what that bench measures, in the same order and with the same
``TrainConfig`` fields (:func:`configs`), and prints exactly one JSON line
with its keys::

    python -m sqtpu_torch.bench [--device cuda]
    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m sqtpu_torch.bench [--device cuda]

1. ``value``: the full ResNetSQ train step (bf16 encoder compute, float32
   parameters; the implicit loss at 64³ through K1/K2; Adam) on one
   resident batch of real depth maps, rendered once by K3;
2. ``online_imgs_per_sec_per_chip``: the same step, continuing from the
   same state, on a fresh batch rendered by K3 each step;
3. the ``explicit_sym`` recipe's steps (K4) at 96³ and 128³, sharpness 5
   and 20, float32 and a bf16 encoder, each from a fresh state;
4. the sequence-parallel pair at 128³, batch 64, ``remat``: the step
   through K1/K2 and through the plain loss (``use_pallas=False``);
5. ``datagen_imgs_per_sec_per_chip``: K3's batches alone.

Every measurement takes 1 + 2 untimed steps (the first carries cuDNN's
autotuning, as the JAX bench's first carries its compile), then
``SQTPU_BENCH_ITERS`` (10) timed ones at the global batch
``SQTPU_BENCH_BATCH`` (512) between two fences
(:class:`~sqtpu_torch.utils.profiling.StepTimer` synchronizes the card),
the last loss read with ``.item()``. As in the JAX bench, ``final_loss``
is the last online step's loss, and the sequence-parallel pair trains on
the first min(64, batch) rows; its rate counts those rows.

Under ``torch.distributed.run`` the N processes are the ranks of the
data axis (the JAX bench's mesh over its devices), joined as the trainer
joins them (:func:`sqtpu_torch.parallel.mesh.init_layout`: ``nccl`` when
each rank has a card of its own, ``gloo`` when ranks share a card or run
on the CPU). Each step is data-parallel: every rank trains on its rows of
the global batch, with the BatchNorm moments of the whole batch, the
global loss and the gradient averaged over the ranks, as
:func:`~sqtpu_torch.training.loop.make_train_step` does in the trainer.
Every rank renders the whole resident batch and keeps its rows; the online
and datagen batches are each rank's own shard, drawn from the online
stream folded with its rank (``make_batch_dp``'s stream). A measurement's
seconds are the slowest rank's. ``n_chips`` counts the distinct devices the
ranks hold (the JAX bench's ``len(jax.devices())``): ranks that share a
card count it once, CPU ranks count as one device. Every rate is global
rows × steps ÷ seconds ÷ ``n_chips``; ``imgs_per_sec_total`` is the
headline's before the division. Rank 0 alone prints the line; a rank that
fails makes the launcher exit non-zero.

What differs from the JAX bench: there is no ``vs_baseline`` (its 2500
imgs/s a chip is a target for a TPU v5e-8); ``detail.device`` holds the
card's ``nvidia-smi`` name and power limit instead. The kernels' ``nvcc``
builds are cached under ``sqtpu_torch/build/``, so nothing stands for the
JAX bench's compilation cache. Seeds come from explicit generators: 0 for
the headline model, 1 for the resident batch, 2 for the online stream, 3
for each later configuration's state. Progress goes to stderr, each line
prefixed with the rank: the world and its backend, whether ranks share a
card, each measurement's first output (the first step's loss), over
several ranks the models' digest after the headline, and each rank's
kernel launches. The CPU (``--device cpu``) is for tests only: the
kernels' plain versions run there.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import sys
import time

import torch

BATCH = int(os.environ.get("SQTPU_BENCH_BATCH", "512"))
ITERS = int(os.environ.get("SQTPU_BENCH_ITERS", "10"))
WARM_STEPS = 3
IMAGE = 256
SP_BATCH = 64
MODEL_SEED, RESIDENT_SEED, ONLINE_SEED, STATE_SEED = 0, 1, 2, 3


def configs(batch: int = BATCH) -> dict:
    """The JAX bench's ``TrainConfig`` of each measurement (the online
    step runs the headline's), by the name of its rate."""
    from sqtpu_torch.utils.config import TrainConfig

    def explicit(render_size, dtype="float32", **kw):
        return TrainConfig(batch_size=batch, render_size=render_size,
                           loss="explicit_sym", gauge_weight=2.0,
                           dtype=dtype, **kw)

    def sp(use_pallas):
        return TrainConfig(batch_size=SP_BATCH, render_size=128,
                           loss="implicit", use_pallas=use_pallas,
                           remat=True, dtype="float32")

    return {
        "headline": TrainConfig(batch_size=batch, render_size=64,
                                loss="implicit", dtype="bfloat16"),
        "explicit96": explicit(96),
        "explicit128": explicit(128),
        "explicit128_sharp20": explicit(128, explicit_sharp=20.0),
        "explicit128_sharp20_bf16": explicit(128, "bfloat16",
                                             explicit_sharp=20.0),
        "sp_implicit128_pallas": sp(True),
        "sp_implicit128_jnp": sp(False),
    }


def seeded_model(cfg, seed: int, device: torch.device):
    """ResNetSQ in ``cfg.dtype``'s compute dtype, with flax's initial
    weights drawn from a generator seeded ``seed``."""
    from sqtpu_torch.models import build_model
    from sqtpu_torch.models.resnet import init_like_flax
    from sqtpu_torch.utils.config import MODEL_DTYPES

    gen = torch.Generator()
    gen.manual_seed(seed)
    model = build_model("resnet_sq", IMAGE, dtype=MODEL_DTYPES[cfg.dtype])
    return init_like_flax(model, generator=gen).to(device)


def _log(rank: int, msg: str) -> None:
    # one write a line: the ranks share the launcher's stderr
    sys.stderr.write(f"bench[{rank}]: {msg}\n")
    sys.stderr.flush()


def _timed(fn, iters: int, device: torch.device) -> dict:
    """``fn(i)`` (a step, returning a tensor to read) WARM_STEPS times
    untimed, then ``iters`` times between two fences. Returns the seconds
    of the timed calls, the first call's output read on the host and the
    last's, and the peak memory allocated on the card (None on the
    CPU)."""
    from sqtpu_torch.utils.profiling import StepTimer

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    first = fn(0).reshape(-1)[0].item()
    for i in range(1, WARM_STEPS):
        out = fn(i)
    out.reshape(-1)[0].item()
    timer = StepTimer(device)
    timer.start()
    for i in range(iters):
        out = fn(WARM_STEPS + i)
    seconds = timer.stop()
    return {"seconds": seconds, "first": first,
            "last": out.reshape(-1)[0].item(),
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None)}


def resident_batch(device: torch.device, batch: int = BATCH) -> tuple:
    """The headline's resident batch, ``make_batch`` from a generator
    seeded RESIDENT_SEED: ``batch`` real depth maps rendered by K3 and
    their labels."""
    from sqtpu_torch.data.synthetic import make_batch

    gen = torch.Generator(device=device)
    gen.manual_seed(RESIDENT_SEED)
    return make_batch(gen, batch, IMAGE, "hard")


def check_layouts(batch: int, world: int) -> None:
    """Raise ``ValueError`` unless ``world`` ranks on the data axis fit
    every configuration (``utils.config.check_layout``): the batch and the
    sequence-parallel pair's batch of SP_BATCH each a multiple of the
    world."""
    from sqtpu_torch.utils.config import check_layout

    for cfg in configs(batch).values():
        check_layout(cfg, world)


def batch_stream(generator: torch.Generator, batch: int, layout):
    """A function that draws this rank's rows of the next global batch of
    ``batch`` (images, labels), rendered by K3: ``make_batch(generator,
    batch)`` on one rank; over the data axis, ``make_batch`` of this
    rank's share from ``fold_in(generator, data index)``, folded once, so
    that each rank draws a stream of its own (the first batch is
    ``make_batch_dp``'s)."""
    from sqtpu_torch.data.synthetic import make_batch
    from sqtpu_torch.parallel.sharded_losses import fold_in

    if layout.n_data == 1:
        return lambda: make_batch(generator, batch, IMAGE, "hard")
    local = fold_in(generator, layout.data_index)
    rows = layout.rows(batch)
    return lambda: make_batch(local, rows.stop - rows.start, IMAGE, "hard")


def measure(device: torch.device, batch: int = BATCH,
            iters: int = ITERS) -> tuple[dict, dict]:
    """The bench's measurements on ``device``, over the launcher's ranks
    when it runs under ``torch.distributed.run``: the dict :func:`main`
    prints, and each measurement's numbers by name (``_timed``'s with the
    slowest rank's seconds and the largest peak memory, its global rows
    and global imgs/s). Every rank returns both; the process group it
    joined is left on every path out."""
    from sqtpu_torch.parallel.mesh import init_layout, shutdown

    layout = init_layout(1, device)
    try:
        return _measure(layout, batch, iters)
    finally:
        if layout.world > 1:  # the group init_layout joined
            shutdown()


def _measure(layout, batch: int, iters: int) -> tuple[dict, dict]:
    from sqtpu_torch.models.resnet import use_global_batch_stats
    from sqtpu_torch.ops.kernels import launch_counts
    from sqtpu_torch.parallel.mesh import gather_objects
    from sqtpu_torch.training.loop import make_train_step
    from sqtpu_torch.training.state import create_train_state
    from sqtpu_torch.utils.profiling import card_line

    check_layouts(batch, layout.world)
    device, rank = layout.device, layout.rank
    # the distinct devices the ranks hold: one per card, one for the CPU
    n_chips = len(set(gather_objects(
        (socket.gethostname(), device.type, device.index), layout)))
    if layout.world == 1:
        sharing = "one rank"
    elif device.type == "cpu":
        sharing = "ranks on the CPU"
    elif n_chips < layout.world:
        sharing = "ranks share a card"
    else:
        sharing = "one card per rank"
    _log(rank, f"world {layout.world}, backend "
         f"{layout.backend or 'none'}, {n_chips} device(s): {sharing}; "
         f"device {device}")
    record = {}
    cfgs = configs(batch)

    def model(cfg, seed):
        net = seeded_model(cfg, seed, device)
        use_global_batch_stats(net, layout.data_group)
        return net

    def timed(name, fn, rows):
        """Time ``fn``; ``rows`` of the global batch a step. Returns the
        rate a chip."""
        t = time.perf_counter()
        res = _timed(fn, iters, device)
        ranks = gather_objects((res["seconds"], res["peak_bytes"]), layout)
        res["seconds"] = max(s for s, _ in ranks)
        if res["peak_bytes"] is not None:
            res["peak_bytes"] = max(p for _, p in ranks)
        res["rows"] = rows
        res["imgs_per_sec"] = rows * iters / res["seconds"]
        record[name] = res
        per_chip = res["imgs_per_sec"] / n_chips
        _log(rank, f"{name}: first {res['first']!r}; {per_chip:.1f} imgs/s "
             f"a chip ({1e3 * res['seconds'] / iters:.2f} ms a step, "
             f"{time.perf_counter() - t:.1f} s with warm-up; peak "
             f"{res['peak_bytes']} bytes)")
        return per_chip

    # the headline: bf16 encoder compute, the implicit loss through K1/K2,
    # on one resident batch of real depth maps rendered once; each rank
    # keeps its rows
    cfg = cfgs["headline"]
    state = create_train_state(model(cfg, MODEL_SEED), cfg)
    step = make_train_step(state, cfg, layout)
    imgs, labels = resident_batch(device, batch)
    mine = layout.rows(batch)
    x, y = imgs[mine], labels[mine]
    per_chip = timed("headline", lambda i: step(x, y), batch)
    total = record["headline"]["imgs_per_sec"]
    if layout.world > 1:
        from sqtpu_torch.parallel.dryrun import state_digest

        _log(rank, f"model after the headline: sha256 "
             f"{state_digest(state.model)}")

    # online: a fresh batch rendered on the card (K3) before each step,
    # each rank its own shard
    gen = torch.Generator(device=device)
    gen.manual_seed(ONLINE_SEED)
    draw = batch_stream(gen, batch, layout)
    online = timed("online", lambda i: step(*draw()), batch)
    final_loss = record["online"]["last"]
    del state, step  # free the headline's model and Adam state

    def time_step(name, rows=batch):
        c = cfgs[name]
        st = create_train_state(model(c, STATE_SEED), c)
        step_x = make_train_step(st, c, layout)
        n = min(rows, batch)
        share = layout.rows(n)
        x, y = imgs[share], labels[share]
        return timed(name, lambda i: step_x(x, y), n)

    rates = {name: time_step(name) for name in (
        "explicit96", "explicit128", "explicit128_sharp20",
        "explicit128_sharp20_bf16")}
    for name in ("sp_implicit128_pallas", "sp_implicit128_jnp"):
        rates[name] = time_step(name, SP_BATCH)

    # data generation alone (K3), from the online stream
    datagen = timed("datagen", lambda i: draw()[0], batch)
    _log(rank, f"launches {json.dumps(launch_counts())}")

    line = {
        "metric": "train_imgs_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": "256x256 depth imgs/sec/chip (full train step, implicit "
                "loss @64^3)",
        "detail": {
            "imgs_per_sec_total": round(total, 2),
            "n_chips": n_chips,
            "batch": batch,
            "loss_point_evals_per_sec": round(
                total * cfg.render_size ** 3, 1),
            "final_loss": final_loss,
            "online_imgs_per_sec_per_chip": round(online, 2),
            "online_note": "data generation on the card (K3, hard "
                           "ray-cast render) + train step",
            "explicit96_imgs_per_sec_per_chip": round(
                rates["explicit96"], 2),
            "explicit96_note": "flagship recipe step (explicit_sym @96^3, "
                               "K4 over each sample's z-window, fp32)",
            "explicit128_imgs_per_sec_per_chip": round(
                rates["explicit128"], 2),
            "explicit128_sharp20_imgs_per_sec_per_chip": round(
                rates["explicit128_sharp20"], 2),
            "explicit128_note": "stage-6/7 recipe step (explicit_sym "
                                "@128^3; sharp20 = the annealed stage, "
                                "tighter z-window; K4 fused value + grad)",
            "explicit128_sharp20_bf16_imgs_per_sec_per_chip": round(
                rates["explicit128_sharp20_bf16"], 2),
            "explicit128_bf16_note": "same step with a bf16 encoder (fp32 "
                                     "K4 unchanged)",
            "sp_implicit128_pallas_imgs_per_sec_per_chip": round(
                rates["sp_implicit128_pallas"], 2),
            "sp_implicit128_jnp_imgs_per_sec_per_chip": round(
                rates["sp_implicit128_jnp"], 2),
            "sp_note": "implicit @128^3 batch 64 with remat: K1/K2, and "
                       "the plain loss (use_pallas=False) on the card",
            "datagen_imgs_per_sec_per_chip": round(datagen, 2),
            "device": card_line() if device.type == "cuda" else "cpu",
        },
    }
    return line, record


def read_progress(text: str) -> dict:
    """The ranks' progress lines in ``text`` (a launched run's stderr),
    read back by rank: ``backend``, each measurement's ``first`` output
    and ``ms`` a step, the models' ``digest`` after the headline (several
    ranks) and the kernel ``launches``."""
    ranks = {}
    for line in text.splitlines():
        m = re.match(r"bench\[(\d+)\]: (.*)$", line)
        if not m:
            continue
        rank = ranks.setdefault(int(m[1]), {"first": {}, "ms": {}})
        msg = m[2]
        step = re.match(r"(\w+): first (\S+); .*\(([\d.]+) ms a step", msg)
        if step:
            rank["first"][step[1]] = float(step[2])
            rank["ms"][step[1]] = float(step[3])
        elif msg.startswith("world "):
            rank["backend"] = re.search(r"backend (\w+)", msg)[1]
        elif msg.startswith("model after the headline: sha256 "):
            rank["digest"] = msg.split()[-1]
        elif msg.startswith("launches "):
            rank["launches"] = json.loads(msg[len("launches "):])
    return ranks


def run(device: torch.device, batch: int = BATCH,
        iters: int = ITERS) -> dict:
    """The bench's measurements on ``device``: the dict :func:`main`
    prints."""
    return measure(device, batch, iters)[0]


def main(argv=None) -> dict:
    from sqtpu_torch.utils.config import resolve_device

    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="over several ranks, one per card (nccl) or sharing one "
               "(gloo):\n  python -m torch.distributed.run --standalone "
               "--nproc_per_node N -m sqtpu_torch.bench\nthe batch "
               "(SQTPU_BENCH_BATCH) is global and splits over the ranks; "
               "n_chips counts\nthe distinct devices the ranks hold (ranks "
               "on one card, or on the CPU, count one)\nand every rate is "
               "a chip's; rank 0 alone prints the line.")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    line = run(resolve_device(args.device))
    if int(os.environ.get("RANK", "0")) == 0:  # the launcher's rank
        print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
