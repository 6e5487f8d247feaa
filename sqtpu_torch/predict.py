"""Bulk inference: a directory of depth BMPs -> the reference's label CSV.

Counterpart of ``sqtpu/predict.py``. Every depth map is read, cleaned with
``input_filter`` and run through the model in batches of ``batch_size``
on the device (the tail batch padded with zero images, so every call has
one shape), and the predictions are written as the 21-column CSV of the
dataset generator (``fn, a1..a3, e1, e2, t1..t3, m11..m33, q1..q4``).
``--refine lm|gd|lm+gd`` polishes each batch's predictions against its
(cleaned) images (:func:`sqtpu_torch.fit.refine_params`).

Usage::

    python -m sqtpu_torch.predict --inputs data/rot --ckpt-dir \\
        artifacts/resnet_sq_c4_fp16.npz --out predictions.csv \\
        --batch-size 256 [--device cpu]

``--denormalize false`` writes normalized [0, 1] sizes and positions.
"""

from __future__ import annotations

import glob
import os
import sys
import time

import numpy as np
import torch

from sqtpu_torch.data.bmp import read_bmp
from sqtpu_torch.data.labels import csv_row
from sqtpu_torch.evaluate import load_eval_state, predict, refine_fn
from sqtpu_torch.fit import apply_prefilter
from sqtpu_torch.ops.quaternion import to_matrix
from sqtpu_torch.utils.config import (
    PredictConfig, check_slice, parse_cli, resolve_device,
)


def list_inputs(pattern: str) -> list[str]:
    """A directory -> its ``*.bmp`` sorted; anything else is a glob."""
    if os.path.isdir(pattern):
        return sorted(glob.glob(os.path.join(pattern, "*.bmp")))
    return sorted(glob.glob(pattern))


def predict_files(cfg: PredictConfig, files: list[str]) -> np.ndarray:
    """The model over ``files`` in device batches -> (N, 12) float32
    params, normalized (``a1..a3 e1 e2 t1..t3 qx qy qz qw``)."""
    check_slice(cfg)
    device = resolve_device(cfg.device)
    model = load_eval_state(cfg, device)
    refine = refine_fn(cfg)
    out = np.empty((len(files), 12), np.float32)
    bs = cfg.batch_size
    t0 = time.perf_counter()
    for lo in range(0, len(files), bs):
        chunk = files[lo:lo + bs]
        imgs = np.stack([read_bmp(f) for f in chunk]).astype(np.float32)
        imgs /= 255.0
        pad = bs - len(chunk)  # pad the tail: one shape for every call
        if pad:
            imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:],
                                                  np.float32)])
        x = apply_prefilter(torch.from_numpy(imgs).to(device),
                            cfg.input_filter)
        p = refine(x, predict(model, x[..., None]))
        out[lo:lo + len(chunk)] = p[:len(chunk)].cpu().numpy()
        done = min(lo + bs, len(files))
        rate = done / (time.perf_counter() - t0)
        print(f"\r{done}/{len(files)} images  ({rate:.0f} img/s)",
              end="", flush=True)
    print()
    return out


def write_csv(path: str, files: list[str], params: np.ndarray,
              denormalize: bool = True) -> None:
    """The 21-column reference CSV of normalized ``params``; ``csv_row``
    writes a·255 and t·255, ``denormalize=False`` keeps them normalized."""
    M = to_matrix(torch.from_numpy(np.asarray(params[:, 8:12]))).numpy()
    p = params if denormalize else params.copy()
    if not denormalize:  # undo csv_row's ×255
        p[:, 0:3] /= 255.0
        p[:, 5:8] /= 255.0
    with open(path, "w") as f:
        for fn, row, m in zip(files, p, M):
            f.write(csv_row(os.path.basename(fn), row, m))


def main(argv=None):
    cfg = parse_cli(PredictConfig, sys.argv[1:] if argv is None else argv)
    files = list_inputs(cfg.inputs)
    if not files:
        raise SystemExit(f"no input images match {cfg.inputs!r}")
    print(f"{len(files)} images -> {cfg.out} "
          f"(model={cfg.model}, refine={cfg.refine})")
    params = predict_files(cfg, files)
    write_csv(cfg.out, files, params, cfg.denormalize)
    print(f"wrote {cfg.out}")


if __name__ == "__main__":
    main()
