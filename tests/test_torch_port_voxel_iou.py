"""The voxel IoU kernel K7 (``sqtpu_torch/csrc/voxel_iou.cu``): its
algorithm, proven on the CPU through the torch emulation of it
(:func:`sqtpu_torch.ops.kernels.voxel_iou.emulate_voxel_iou`). The CUDA
kernel is held against the plain path on the card by
tests/test_torch_port_gpu.py and chip_smoke.py (phase 39).

* The z cull is exact: on sampled truths, on noisy predictions and on
  ``iou_full``'s five fields, at N = 16, 32 and 64, no occupied voxel lies
  outside a field's interval, and the culled counts equal the plain
  ``iou_counts`` counts bit for bit (float32, and float64 at N = 16).
* The same on adversarial rows: exponents at 0.1 and 1.0, boxes crossing
  the lattice's faces, box faces exactly on lattice coordinates, a = 0,
  negative a, non-positive exponents, NaN and inf. Rows outside the range
  the proof covers are evaluated on every voxel: a full sweep's count of
  field evaluations.
* ``iou_full``'s pair table gives the plain ``iou_full``'s three IoU
  columns; CPU tensors keep the plain path and launch nothing.
* The source keeps the plain path's roundings (no fast-math, ``__fmul_rn``
  and ``__fadd_rn`` in the field chain) and counts with integers.
"""

import os

import numpy as np
import pytest
import torch

from sqtpu_torch.data.synthetic import sample_params
from sqtpu_torch.ops import geometry, metrics
from sqtpu_torch.ops.kernels import _build, bounds, launch_counts
from sqtpu_torch.ops.kernels import reset_launches
from sqtpu_torch.ops.kernels import voxel_iou as V

from test_torch_port_ops import _few_torch_threads  # noqa: F401


def _sampled(seed: int, b: int, dtype=torch.float32):
    """Truths from the evaluation distribution and predictions near them
    (sizes, exponents and positions moved by 0.03 noise, the quaternion
    by 0.05 and left unnormalized, as a network's raw output is)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    truth = sample_params(b, gen, dtype=dtype)
    noise = torch.randn(truth.shape, generator=gen, dtype=dtype)
    scale = torch.tensor([0.03] * 8 + [0.05] * 4, dtype=dtype)
    return truth, truth + scale * noise


def _fields(kind: str, seed: int, b: int, dtype=torch.float32):
    truth, pred = _sampled(seed, b, dtype)
    if kind == "truths":
        return [truth, truth.flip(0)], ((0, 1),)
    if kind == "noisy":
        return [truth, pred], ((0, 1),)
    fields, _ = metrics.full_fields(truth, pred)
    return list(fields), metrics.FULL_PAIRS


def _plain(fields, pairs, n):
    import chip_smoke

    return chip_smoke.k7_plain(fields, pairs, n)


def _dropped(par, ax) -> int:
    """Occupied voxels outside their field's interval: 0 if the cull is
    exact."""
    occ = V.field_occupancy(par, ax)
    k0, k1 = V.z_ranges(par, ax)
    kz = torch.arange(ax.shape[-1])
    inside = (kz >= k0[..., None]) & (kz <= k1[..., None])
    return int((occ & ~inside).sum())


@pytest.mark.parametrize("n", [16, 32, 64])
@pytest.mark.parametrize("kind", ["truths", "noisy", "iou_full"])
def test_culled_counts_equal_plain_counts(kind, n):
    b = 16 if n < 64 else 6
    fields, pairs = _fields(kind, 200 + n, b)
    par, ax = V.pack_fields(fields), V.axes(fields, n)
    got, evals = V.emulate_voxel_iou(par, ax, pairs)
    assert torch.equal(got, _plain(fields, pairs, n))
    assert _dropped(par, ax) == 0
    full, evals_full = V.emulate_voxel_iou(par, ax, pairs, cull=False)
    assert torch.equal(full, got)
    assert int(got[..., 1].min()) > 0            # something to count
    # the cull engages: a few percent of the full sweep is evaluated
    assert bool((evals < evals_full).all())
    assert V.tested_share(par, ax) < 0.15


def test_culled_counts_equal_plain_counts_in_float64():
    fields, pairs = _fields("iou_full", 7, 12, torch.float64)
    par = V.pack_fields(fields)
    assert par.dtype == torch.float64
    ax = V.axes(fields, 16)
    assert ax.dtype == torch.float64
    got, _ = V.emulate_voxel_iou(par, ax, pairs)
    assert torch.equal(got, _plain(fields, pairs, 16))
    assert _dropped(par, ax) == 0


@pytest.mark.parametrize("n", [16, 32])
def test_bfloat16_fields_take_bfloat16_arithmetic(n):
    """A bfloat16 prediction scored against float32 labels (a bf16 net's
    validation): the plain path builds the prediction's grid in bfloat16
    on a bfloat16 axis; the kernel's rows carry the flag, its arithmetic
    rounds each operation to bfloat16, and the cull stays off for it."""
    truth, pred = _sampled(8 + n, 12)
    fields = [truth, pred.bfloat16(), truth.bfloat16()]
    pairs = ((0, 1), (0, 2), (1, 2))
    par, ax = V.pack_fields(fields), V.axes(fields, n)
    assert par.dtype == ax.dtype == torch.float32
    assert par[:, :, 20].tolist() == [[0.0, 1.0, 1.0]] * 12
    assert torch.equal(ax[1].bfloat16(), geometry.make_axis(
        n, "iou", dtype=torch.bfloat16))
    got, _ = V.emulate_voxel_iou(par, ax, pairs)
    want = _plain(fields, pairs, n)
    assert torch.equal(got, want)
    # bfloat16 moves the occupancy: the truth in bf16 is not the truth
    assert not torch.equal(want[:, 1, 0], want[:, 1, 1])
    on, _ = V.cull_on(par)
    assert bool(on[:, 0].all()) and not bool(on[:, 1:].any())
    with pytest.raises(TypeError, match="float64 ones alone"):
        V.pack_fields([truth, pred.double()])
    with pytest.raises(TypeError, match="float64 ones alone"):
        V.pack_fields([truth, pred.half()])


def _adversarial(n: int):
    """32 truths and chip_smoke's rows that stress the cull from them: the
    first 24 inside the range its proof covers, the last 8 outside it."""
    import chip_smoke

    truth, _ = _sampled(300 + n, 32)
    return truth, chip_smoke.k7_adversarial(truth, geometry.make_axis(
        n, "iou"))


@pytest.mark.parametrize("n", [16, 32, 64])
def test_adversarial_rows(n):
    truth, p = _adversarial(n)
    fields, pairs = [truth, p], ((0, 1), (1, 1))
    par, ax = V.pack_fields(fields), V.axes(fields, n)
    on, _ = V.cull_on(par)
    assert bool(on[:24].all()) and not bool(on[24:, 1].any())
    got, _ = V.emulate_voxel_iou(par, ax, pairs)
    assert torch.equal(got, _plain(fields, pairs, n))
    assert _dropped(par, ax) == 0
    # the boundary rows are occupied exactly up to their faces
    assert int(got[16:20, 1, 1].min()) > 0
    k0, k1 = V.z_ranges(par, ax)
    evals = (k1 - k0 + 1).clamp(min=0).sum(dim=(-1, -2))      # (B, F)
    assert bool((evals[24:, 1] == n ** 3).all())
    assert bool((evals[:24, 1] < n ** 3).all())


def test_iou_full_pair_table_gives_plain_iou_full():
    truth, pred = _sampled(17, 10)
    fields, swapped = metrics.full_fields(truth, pred)
    par = V.pack_fields(fields)
    counts, _ = V.emulate_voxel_iou(par, V.axes(fields, 24),
                                    metrics.FULL_PAIRS)
    ious = counts[..., 0].to(truth.dtype) / counts[..., 1].to(truth.dtype)
    want = metrics.iou_full(truth, pred, 24)
    assert torch.equal(ious, want[:, [0, 1, 5]])
    assert torch.equal(swapped.to(truth.dtype), want[:, 6])
    # the truth's field is shared by the first two pairs
    assert metrics.FULL_PAIRS[0][0] == metrics.FULL_PAIRS[1][0] == 0


def test_cpu_tensors_take_the_plain_path():
    truth, pred = _sampled(18, 4)
    reset_launches()
    inter, union = metrics.iou_counts(truth, pred, 16)
    metrics.iou(truth, pred, 16)
    metrics.iou_full(truth, pred, 16)
    assert launch_counts()["K7"] == 0
    want = metrics.plain_iou_counts(truth, pred, 16)
    assert torch.equal(inter, want[0]) and torch.equal(union, want[1])
    with pytest.raises(ValueError, match="no kernel for device"):
        V.voxel_iou_cuda([truth, pred], ((0, 1),), 16)
    assert launch_counts()["K7"] == 0


@pytest.mark.parametrize("fields,pairs,n,error", [
    (0, ((0, 1),), 16, "fields outside"),
    (2, (), 16, "pairs outside"),
    (2, ((0, 2),), 16, "name fields outside"),
    (9, ((0, 1),), 16, "fields outside"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(fields, pairs, n,
                                                       error):
    truth, _ = _sampled(19, 2)
    with pytest.raises(ValueError, match=error):
        V.voxel_iou_cuda([truth] * fields, pairs, n)


def test_k7_source():
    src = open(os.path.join(_build.CSRC_DIR, "voxel_iou.cu")).read()
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "use_fast_math" not in src and "sq_field.cuh" not in src
    assert _build.source_files("voxel_iou") == [
        os.path.join(_build.CSRC_DIR, "voxel_iou.cu")]
    chain = src[src.index("bool occupied("):src.index("// A field's per")]
    for op in ("A::mul(", "A::add(", "A::sub(", "A::div(", "A::pow("):
        assert op in chain
    arith = src[src.index("struct Arith<float>"):
                src.index("struct Arith<double>")]
    for fn in ("__fmul_rn(", "__fadd_rn(", "__fsub_rn(", "__fdiv_rn(",
               "powf("):
        assert fn in arith
    for fast in ("__expf", "__logf", "__powf", "__fdividef", "expf(logf"):
        assert fast not in src
    assert "__popc(" in src and "atomicAdd(" in src
    assert "int sqtpu_voxel_iou(" in src


def test_k7_bound_counts_the_emulations_evaluations():
    fields, pairs = _fields("iou_full", 21, 4)
    par, ax = V.pack_fields(fields), V.axes(fields, 16)
    _, evals = V.emulate_voxel_iou(par, ax, pairs)
    row = bounds.voxel_iou_bounds(par, ax, len(pairs))
    assert row["evaluations"] == int(evals.sum()) > 0
    assert row["full_sweep_evaluations"] == 4 * 5 * 16 ** 3
    assert row["ops_per_evaluation"] == bounds.OPS_K7 == 35
    assert row["bound_ms"] == pytest.approx(max(
        bounds.ops_ms(int(evals.sum()), 35),
        bounds.bytes_ms(4 * 5 * 24 * 4 + 4 * 3 * 16)))
    assert row["bound_ms_full_sweep"] > row["bound_ms"]
    assert row["tested_share"] == pytest.approx(
        int(evals.sum()) / (4 * 5 * 16 ** 3))
    assert np.isclose(row["tested_share"], V.tested_share(par, ax))
