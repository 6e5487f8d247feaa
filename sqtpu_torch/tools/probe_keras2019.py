"""Loss-landscape probe of the 2019 rotation regime (``keras_chamfer``).

Counterpart of ``tools/probe_keras2019.py``: Adam descent directly on the
12 parameters of one superquadric, from its truth perturbed (sizes and
positions ±0.04, shapes ±0.15, a rotation of ``--rots`` radians about a
random axis), under the 2019 occupancy-field MSE (``keras_raw``, uncapped,
and ``keras_clip=<c>``, both fields capped at c; 64³) and under the 2020
explicit loss (``explicit2020``, 32³, the full lattice: K4 and K5 on the
card). The quaternion is renormalized after every step; non-finite
gradients are zeroed and recorded. The full IoU at 64³ scores the start
and the end. One JSON line per (rotation, loss, lr)::

    python -m sqtpu_torch.tools.probe_keras2019 [--device cpu]
        [--steps 2000] [--seeds 6] [--rots 0.35,1.57]
        [--losses keras_raw,keras_clip=100,keras_clip=2,explicit2020]
        [--lrs 3e-3,1e-3,3e-4] [--out runs/port_probe_keras2019.jsonl]

The seeds run as one batch. The truths and starts are drawn from one
generator on the CPU seeded 7 (the same on every device; not the JAX
package's draws); :func:`descend` takes any (truth, start) pair.
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch

from sqtpu_torch.data.synthetic import sample_params
from sqtpu_torch.fit import adam_update
from sqtpu_torch.ops import losses, metrics
from sqtpu_torch.ops import quaternion as quat


def perturb(gen: torch.Generator, p: torch.Tensor,
            rot_rad: float = 0.35) -> torch.Tensor:
    """Starts (B, 12) near the truths ``p`` (B, 12), drawn from ``gen`` on
    ``p``'s device: sizes ±0.04 (kept in [25, 75]/255), shapes ±0.15
    (kept in [0.1, 1]), positions ±0.04, and the rotation turned by
    ``rot_rad`` about a random axis."""
    b, dt = p.shape[0], p.dtype

    def u(n, lo, hi):
        return lo + (hi - lo) * torch.rand((b, n), generator=gen, dtype=dt,
                                           device=p.device)
    a = torch.clamp(p[:, 0:3] + u(3, -0.04, 0.04), 25 / 255, 75 / 255)
    e = torch.clamp(p[:, 3:5] + u(2, -0.15, 0.15), 0.1, 1.0)
    t = p[:, 5:8] + u(3, -0.04, 0.04)
    axis = torch.randn((b, 3), generator=gen, dtype=dt, device=p.device)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    dq = torch.cat([axis * math.sin(rot_rad / 2),
                    torch.full((b, 1), math.cos(rot_rad / 2), dtype=dt,
                               device=p.device)], dim=-1)
    return torch.cat([a, e, t, quat.multiply(dq, p[:, 8:12])], dim=-1)


def make_loss(name: str):
    """(objective, per_seed) of one of the probe's losses on truths and
    estimates (B, 12): ``per_seed`` gives the (B,) losses, ``objective``
    a scalar whose gradient in each row is that row's own loss's (the
    per-seed losses summed; ``keras_occupancy_mse`` averages over the
    batch, so it is taken B times)."""
    from sqtpu_torch.ops.kernels import explicit_loss_auto

    tk = losses.torch_to_keras_norm
    if name.startswith("keras_clip") or name == "keras_raw":
        clip = float(name.split("=")[1]) if name != "keras_raw" else 0.0

        def mse(tp, pp):
            return losses.keras_occupancy_mse(tk(tp), tk(pp), 64, clip=clip)

        def per_seed(tp, pp):
            return torch.stack([mse(tp[i:i + 1], pp[i:i + 1])
                                for i in range(pp.shape[0])])
        return (lambda tp, pp: pp.shape[0] * mse(tp, pp)), per_seed
    if name == "explicit2020":
        def per_seed(tp, pp):
            return explicit_loss_auto(tp, pp, 32, reduce=False,
                                      z_window=False)
        return (lambda tp, pp: per_seed(tp, pp).sum()), per_seed
    raise ValueError(name)


def descend(loss_name: str, truth: torch.Tensor, p0: torch.Tensor,
            lr: float, steps: int):
    """Adam from the starts ``p0`` (B, 12) on ``loss_name`` against the
    truths, the quaternion renormalized after each step and non-finite
    gradient components zeroed. Returns (the final params, the (B, steps)
    losses after each step, the (B, steps) flags of a non-finite
    gradient)."""
    objective, per_seed = make_loss(loss_name)
    p = p0.detach().clone()
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    ls, bad = [], []
    for k in range(1, steps + 1):
        with torch.enable_grad():
            p.requires_grad_(True)
            g, = torch.autograd.grad(objective(truth, p), p)
        p = p.detach()
        nonfinite = ~torch.isfinite(g)
        g = torch.where(nonfinite, torch.zeros_like(g), g)
        upd, m, v = adam_update(g, m, v, k, lr)
        p = p + upd
        q = p[:, 8:12]
        p = torch.cat([p[:, :8],
                       q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)],
                      dim=-1)
        with torch.no_grad():
            ls.append(per_seed(truth, p))
        bad.append(nonfinite.any(dim=-1))
    return p, torch.stack(ls, dim=1), torch.stack(bad, dim=1)


def draw(seeds: int, rot_rad: float):
    """The probe's truths (the raw label convention) and starts, float32
    (seeds, 12) each, from one CPU generator seeded 7."""
    gen = torch.Generator()
    gen.manual_seed(7)
    truth = sample_params(seeds, gen, canonical=False)
    return truth, perturb(gen, truth, rot_rad)


def run_config(loss_name: str, lr: float, steps: int, seeds: int,
               rot_rad: float = 0.35, device="cpu") -> dict:
    """One (rotation, loss, lr) record: the descent of every seed at once
    on ``device``, from :func:`draw`'s truths and starts."""
    truth, p0 = (x.to(device) for x in draw(seeds, rot_rad))
    pf, ls, bad = descend(loss_name, truth, p0, lr, steps)
    iou0 = metrics.iou(truth, p0, 64, reduce=False).cpu()
    iouf = metrics.iou(truth, pf, 64, reduce=False).cpu()
    ls, bad = ls.cpu(), bad.cpu()
    return {
        "loss": loss_name, "lr": lr, "steps": steps,
        "seeds": truth.shape[0], "rot_rad": rot_rad,
        "init_iou": [round(float(x), 4) for x in iou0],
        "final_iou": [round(float(x), 4) for x in iouf],
        "final_loss": [float(x) for x in ls[:, -1]],
        "any_nan_grad": [bool(x) for x in bad.any(dim=1)],
        "mean_init_iou": round(float(iou0.mean()), 4),
        "mean_final_iou": round(float(iouf.mean()), 4),
    }


def main(argv=None):
    from sqtpu_torch.utils.config import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--losses", default="keras_raw,keras_clip=100,"
                    "keras_clip=2,explicit2020")
    ap.add_argument("--lrs", default="3e-3,1e-3,3e-4")
    ap.add_argument("--rots", default="0.35",
                    help="rotation offset of the perturbed start, radians "
                    "(a CNN head at init is at ~pi/2 mean offset)")
    ap.add_argument("--out", default="runs/port_probe_keras2019.jsonl")
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    records = []
    with open(args.out, "w") as f:
        for rot in (float(x) for x in args.rots.split(",")):
            for loss_name in args.losses.split(","):
                for lr in (float(x) for x in args.lrs.split(",")):
                    r = run_config(loss_name, lr, args.steps, args.seeds,
                                   rot, device)
                    line = json.dumps(r)
                    print(line, flush=True)
                    f.write(line + "\n")
                    f.flush()
                    records.append(r)
    return records


if __name__ == "__main__":
    main()
