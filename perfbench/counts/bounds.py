"""The card's peaks, the kernels' least times and the model's operations.

A frozen copy of ``sqtpu_torch/ops/kernels/bounds.py``'s constants (each
``logf``/``expf`` one float32 operation; operations per inside test or
per point read off the CUDA sources of the port's kernels when this
benchmark was written) and of the bytes ``chip_smoke.py`` counts for each
kernel, so that a later change to the program cannot move its own
yardstick. A kernel's bound is the larger of its operations over the
float32 rate and its bytes over the memory rate, on the work that
:mod:`perfbench.counts.work` counts for the kernel's own inputs.

The model's operations (:func:`resnet_sq_train_flops`) are counted from
the shapes of its convolutions and dense layers: 2 per multiply-add,
the backward twice the forward (the input's and the weight's gradient),
less the stem's input gradient, which the images do not need. A
recompute in the backward (``remat``) is not counted: it is not work
the step needs.
"""

from __future__ import annotations

from perfbench.counts import work

# NVIDIA H100 SXM data sheet, dense rates, 700 W
PEAKS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

OPS_PER_TEST = 30          # K3: one inside test
OPS_K1_CULLED = 44         # K1: one point after the cull
OPS_K2_CULLED = 115        # K2: one point after the cull
OPS_K4_CULLED = 152        # K4: one point after the cull


def _ms(ops: float, n_bytes: float) -> float:
    return max(ops / PEAK_FP32_OPS, n_bytes / PEAK_BYTES) * 1e3


def k3_bound_ms(p, image_size: int, n_sweep: int, n_bisect: int) -> float:
    """K3's least time on (B, 12) shapes: its inside tests, its packed
    rows in and its (B, S, S) float32 images out."""
    b = p.shape[0]
    tests = work.k3_tests(p, image_size, n_sweep, n_bisect)
    return _ms(tests * OPS_PER_TEST,
               b * (work.PAR_STRIDE * 4 + image_size * image_size * 4))


def k1k2_bound_ms(pred, n: int, tau: float, sharp: float) -> float:
    """K1's plus K2's least time on (B, 12) predictions at n³."""
    b = pred.shape[0]
    points = work.k1k2_points(pred, n, tau, sharp)
    plane, par = b * n * n * 4, b * work.PAR_STRIDE * 4
    return (_ms(points * OPS_K1_CULLED, par + 2 * plane + b * 4)
            + _ms(points * OPS_K2_CULLED, 2 * par + b * 4 + 3 * plane))


def k4_bound_ms(true_p, pred, n: int, sharp: float) -> float:
    """K4's least time on (B, 12) labels and predictions at (N+1)³."""
    b = pred.shape[0]
    points = work.k4_points(true_p, pred, n, sharp)
    return _ms(points * OPS_K4_CULLED,
               2 * b * work.PAR_STRIDE * 4 + b * 4 * (1 + work.PAR_STRIDE))


def resnet_sq_layers(image_size: int, widths=(64, 128, 256, 512),
                     blocks=(2, 2, 2, 2), fcn: int = 256):
    """(name, multiply-adds a image) of every convolution and dense layer
    of ResNetSQ on image_size² depth images."""
    rows = []
    side = (image_size + 2 * 3 - 7) // 2 + 1          # the 7x7/2 stem
    rows.append(("stem", side * side * widths[0] * 1 * 49))
    side = (side + 2 - 3) // 2 + 1                     # the 3x3/2 max pool
    cin = widths[0]
    for stage, (n, width) in enumerate(zip(blocks, widths)):
        for block in range(n):
            stride = 2 if (stage > 0 and block == 0) else 1
            out = (side + 2 - 3) // stride + 1
            rows.append((f"layer{stage + 1}_{block}.conv1",
                         out * out * width * cin * 9))
            rows.append((f"layer{stage + 1}_{block}.conv2",
                         out * out * width * width * 9))
            if stride != 1 or cin != width:
                rows.append((f"layer{stage + 1}_{block}.downsample",
                             out * out * width * cin))
            side, cin = out, width
    rows.append(("fc1", cin * fcn))
    rows.append(("fc2", fcn * fcn))
    rows.append(("heads", fcn * 12))
    return rows


def resnet_sq_train_flops(image_size: int) -> float:
    """Operations of one image's train step: 2 × the multiply-adds of the
    forward, the input's gradient and the weight's gradient, the stem's
    input gradient left out."""
    layers = dict(resnet_sq_layers(image_size))
    return 2.0 * (3 * sum(layers.values()) - layers["stem"])
