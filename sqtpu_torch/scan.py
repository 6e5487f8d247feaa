"""Drop-in replacement for the reference ``scanner`` binary.

Counterpart of ``sqtpu/scan.py``, with the same 18-argument contract::

    python -m sqtpu_torch.scan out.bmp a1 a2 a3 e1 e2 px py pz r11 ... r33

sizes and positions in 0..255 world units, the 3×3 rotation matrix
row-major. The output is a 256×256 24-bit grayscale BMP in the scanner's
layout, pixel = the surface's z (8-bit), background 0, rendered by the
hard ray-caster (every pixel row a slab, 30 bisections, quantized): on the
card (K3) from the CLI, on any device through
:func:`render_from_cli_args`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sqtpu_torch.data.bmp import write_bmp
from sqtpu_torch.ops import quaternion as quat
from sqtpu_torch.ops.kernels import render_hard_auto
from sqtpu_torch.utils.config import resolve_device

USAGE = ("usage: sqtpu_torch.scan out.bmp a1 a2 a3 e1 e2 px py pz "
         "r11 r12 r13 r21 r22 r23 r31 r32 r33")
SCAN_SIZE, SCAN_BISECT = 256, 30


def render_from_cli_args(args: list[str], device: str = "cuda"
                         ) -> tuple[str, np.ndarray]:
    """The 18 CLI arguments -> (output path, (256, 256) uint8 depth)."""
    if len(args) != 18:
        raise SystemExit(USAGE)
    out_path = args[0]
    vals = np.asarray([float(v) for v in args[1:]], dtype=np.float64)
    a, e, t = vals[0:3], vals[3:5], vals[5:8]
    q = quat.from_matrix(torch.from_numpy(vals[8:17].reshape(3, 3))).numpy()
    p = np.concatenate([a / 255.0, e, t / 255.0, q])
    # float32 params on every device: the card's kernel takes float32
    p = torch.from_numpy(p).to(resolve_device(device), torch.float32)
    depth = render_hard_auto(p[None], SCAN_SIZE, n_sweep=SCAN_SIZE,
                             n_bisect=SCAN_BISECT, quantize=True)[0]
    return out_path, (depth * 255.0).to(torch.uint8).cpu().numpy()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out_path, img = render_from_cli_args(argv)
    write_bmp(out_path, img)


if __name__ == "__main__":
    main()
