"""How far the 20-step convergence gate's two runs drift apart by rounding
alone, from random weights, as the JAX package's gate starts
(``__graft_entry__.py:224-321``)::

    python -m sqtpu_torch.parallel.gate_noise [--bases 7000,8000,9000]

For each base seed s, the JAX gate's run (ResNetSQ from seed 0,
``explicit_sym`` through the kernels, Adam at 1e-4, batch 4, 64² images,
render size 16; step i on the global batch rendered from seed s + i,
20 steps; validation IoU on the 64² batch of seed s + 20) is made four
ways, each on ranks spawned on the CPU:

* ``dp``: two data ranks (the BatchNorm of the data group);
* ``one``: one rank (``F.batch_norm``);
* ``perm``: one rank on every batch with its halves swapped: the same
  global batch in another row order;
* ``group_bn``: one rank whose BatchNorm takes the data group's code path
  over a group of one rank (the same arithmetic as ``F.batch_norm`` in
  float64, other rounding in float32).

It prints one JSON line per base seed with the gate's three gaps (loss
relative, validation IoU, BatchNorm drift) of ``dp``, ``perm`` and
``group_bn`` against ``one``, and of ``dp`` against ``group_bn``.
:mod:`sqtpu_torch.parallel.dryrun`'s gate starts from the c4 artifact
instead: these gaps say why.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.distributed as dist

from sqtpu_torch.data.synthetic import make_batch
from sqtpu_torch.models.resnet import use_global_batch_stats
from sqtpu_torch.parallel.dryrun import bn_drift, build_resnet, spawn
from sqtpu_torch.training.loop import make_eval_step, make_train_step
from sqtpu_torch.training.state import create_train_state
from sqtpu_torch.utils.config import TrainConfig

STEPS = 20
CFG = TrainConfig(image_size=64, render_size=16, acc_render_size=16,
                  batch_size=4, use_pallas=True, loss="explicit_sym",
                  learning_rate=1e-4, device="cpu")


def _global_batch(seed: int, order):
    gen = torch.Generator()
    gen.manual_seed(seed)
    imgs, labels = make_batch(gen, CFG.batch_size, CFG.image_size)
    return imgs[order], labels[order]


def run_job(layout, spec: dict) -> dict:
    """The gate's run from base seed ``spec["base"]`` on this rank's rows,
    the global batch's rows in ``spec["order"]``, with ``spec["group_bn"]``
    the data group's BatchNorm over this one-rank world."""
    model = build_resnet(None, layout.device)
    group = layout.data_group
    if spec["group_bn"] and layout.world == 1:
        group = dist.group.WORLD
    use_global_batch_stats(model, group)
    state = create_train_state(model, CFG)
    step = make_train_step(state, CFG, layout)
    rows = layout.rows(CFG.batch_size)
    for i in range(STEPS):
        imgs, labels = _global_batch(spec["base"] + i, spec["order"])
        loss = step(imgs[rows], labels[rows])
    imgs, labels = _global_batch(spec["base"] + STEPS, spec["order"])
    _, iou, _, _ = make_eval_step(state, CFG, layout)(imgs[rows],
                                                      labels[rows])
    return {"loss": float(loss), "iou": float(iou),
            "stats": {n: b.detach().numpy()
                      for n, b in model.named_buffers()
                      if b.is_floating_point()}}


def gaps(a: dict, b: dict) -> dict:
    """The gate's three gaps of run ``a`` from run ``b``."""
    return {"loss_rel": abs(a["loss"] - b["loss"]) / max(1.0, abs(b["loss"])),
            "iou": abs(a["iou"] - b["iou"]),
            "bn_drift": bn_drift(a["stats"], b["stats"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bases", default="7000,8000,9000,10000,11000,12000")
    bases = [int(b) for b in ap.parse_args(argv).bases.split(",")]

    def plan(order, group_bn=False):
        return [(1, run_job, {"base": b, "order": order,
                              "group_bn": group_bn}) for b in bases]

    same, swapped = [0, 1, 2, 3], [2, 3, 0, 1]
    runs = {"dp": spawn(2, plan(same))[0],
            "one": spawn(1, plan(same))[0],
            "perm": spawn(1, plan(swapped))[0],
            "group_bn": spawn(1, plan(same, group_bn=True))[0]}
    for i, base in enumerate(bases):
        r = {k: v[i] for k, v in runs.items()}
        print(json.dumps({"base": base, "one_loss": r["one"]["loss"],
                          "one_iou": r["one"]["iou"],
                          "dp_vs_one": gaps(r["dp"], r["one"]),
                          "perm_vs_one": gaps(r["perm"], r["one"]),
                          "group_bn_vs_one": gaps(r["group_bn"], r["one"]),
                          "dp_vs_group_bn": gaps(r["dp"], r["group_bn"])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
