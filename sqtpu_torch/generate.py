"""Dataset generation: random superquadrics rendered to numbered depth
BMPs with the 21-column label CSV.

Counterpart of ``sqtpu/generate.py``. The files are the JAX package's:
``000000.bmp``, ``000001.bmp``, ... (the scanner's 24-bit layout) and
``data_labels.csv`` with the rows ``fn, a1..a3, e1, e2, t1..t3, m11..m33,
q1..q4`` (a and t in 0..255 world units, ``%f``). The parameters are
sampled from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
same distribution as the JAX package's, not the same draws); ``iso``
fixes the 2019 isometric view. ``backend``
picks the renderer: ``device`` the hard ray-caster on ``device`` (K3 on
the card, its plain version on the CPU; the full sweep, 20 bisections,
quantized), ``native`` the host C++ scanner (OpenMP).

Usage::

    python -m sqtpu_torch.generate --n 1000 --out data/rot \\
        [--device cpu] [--backend native] [--iso true]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from sqtpu_torch.data.bmp import write_bmp
from sqtpu_torch.data.labels import csv_row
from sqtpu_torch.data.synthetic import sample_params
from sqtpu_torch.ops import quaternion as quat
from sqtpu_torch.ops.kernels import render_hard_auto
from sqtpu_torch.utils.config import GenerateConfig, parse_cli, resolve_device

# the device renderer's sweep: every pixel row of the image, 20 bisections
# (sqtpu/generate.py:78-81)
GENERATE_BISECT = 20


def render_batch(p: torch.Tensor, cfg: GenerateConfig) -> np.ndarray:
    """(B, S, S) uint8 depth maps of (B, 12) params with ``cfg.backend``,
    on the device ``p`` lies on unless the backend is ``native``."""
    if cfg.backend == "native":
        from sqtpu_torch.data.native import render_batch_native
        return render_batch_native(p.cpu().numpy(), cfg.image_size)
    imgs = render_hard_auto(p.to(torch.float32), cfg.image_size,
                            n_sweep=cfg.image_size, n_bisect=GENERATE_BISECT,
                            quantize=True)
    # truncation to uint8 after ·255, as the JAX package's astype
    return (imgs * 255.0).to(torch.uint8).cpu().numpy()


def generate(cfg: GenerateConfig) -> None:
    if cfg.backend not in ("device", "native"):
        raise ValueError(f"backend must be device or native, got "
                         f"{cfg.backend!r}")
    device = resolve_device(cfg.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    os.makedirs(cfg.out, exist_ok=True)
    n_done = 0
    with open(os.path.join(cfg.out, cfg.csv_name), "w") as csv:
        while n_done < cfg.n:
            b = min(cfg.batch_size, cfg.n - n_done)
            p = sample_params(b, gen, iso=cfg.iso)
            imgs = render_batch(p, cfg)
            p_np = p.cpu().numpy()
            M = quat.to_matrix(p[:, 8:12]).cpu().numpy()
            for i in range(b):
                fn = "%06d.bmp" % (n_done + i)
                write_bmp(os.path.join(cfg.out, fn), imgs[i])
                csv.write(csv_row(fn, p_np[i], M[i]))
            n_done += b
            print(f"\r{n_done}/{cfg.n}", end="", flush=True)
    print(f"\nwrote {cfg.n} images + {cfg.csv_name} to {cfg.out}")


def main(argv=None):
    generate(parse_cli(GenerateConfig, argv))


if __name__ == "__main__":
    main(sys.argv[1:])
