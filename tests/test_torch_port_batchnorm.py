"""The port's train-mode BatchNorm (``sqtpu_torch.models.resnet.BatchNorm``)
reads a channels-last input once a pass, in the dtype it arrives in (an
NCHW one of another dtype than the parameters' is cast to theirs first),
and moves its running statistics with the moments that normalization
took. Here it is
held against the two-pass formulation it replaced (:func:`two_pass`: the
input cast to float32, ``F.batch_norm``, ``torch.var_mean`` for the
running statistics, the output cast back), for bfloat16 and float32
input, NCHW and channels-last:

* the output within 1 ulp of its dtype, the running mean and variance
  within 1e-6 relative, the input's gradient within 1 ulp and the float32
  weight and bias gradients within 1e-5 relative;
* ``update_stats`` off leaves the running statistics alone; a ``remat``
  forward and backward of ResNetSQ moves them exactly once, to the bits
  of a forward without ``remat``;
* ``bn_path_counts`` counts 20 one-pass calls a ResNetSQ forward in train
  mode, 40 with ``remat``'s recompute, 20 eval calls in eval mode and 20
  data-group calls over a data group;
* the eval path and the data group's path give the two-pass code's bits.

The module imports only torch, numpy, pytest and the port, so the card's
tests (tests/test_torch_port_gpu.py) and ``chip_smoke.py`` import
:func:`two_pass` and its helpers from it and a spawned rank imports its
data-group job.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from sqtpu_torch.models import build_model, params_vector
from sqtpu_torch.models.resnet import (
    BatchNorm, ResNetSQ, _bn, _GlobalBatchNorm, bn_path_counts,
    reset_bn_path_counts, use_global_batch_stats,
)
from sqtpu_torch.parallel import dryrun

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
N_BATCH_NORMS = 20  # ResNet-18: the stem, two a block, three projections


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two torch threads in this worker (see test_torch_port_ops.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def two_pass(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """The train-mode formulation the one-pass path replaced: ``x`` cast
    to the parameters' dtype, normalized by ``F.batch_norm`` with no
    running statistics, a second pass by ``torch.var_mean`` for flax's
    biased moments, which move the running statistics at ``bn``'s
    momentum (when ``bn.update_stats``), and the output cast back to
    ``x``'s dtype."""
    xf = x.to(bn.weight.dtype)
    y = F.batch_norm(xf, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    if bn.update_stats:
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
            m = bn.momentum
            bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
    return y.to(x.dtype)


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Units in the last place between two tensors of one dtype (bfloat16
    or float32), element by element (+0 and -0 are 0 apart)."""
    bits, magnitude = {torch.bfloat16: (torch.int16, 0x7FFF),
                       torch.float32: (torch.int32, 0x7FFFFFFF)}[a.dtype]

    def ordered(t):
        i = t.detach().contiguous().view(bits).long()
        return torch.where(i < 0, -(i & magnitude), i)

    return (ordered(a) - ordered(b)).abs()


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest relative gap of ``a`` to ``b``, against ``b``'s largest."""
    return float((a - b).abs().max() / b.abs().max())


def bn_pair(c: int, seed: int, device="cpu"):
    """Two equal train-mode :class:`BatchNorm` of ``c`` channels on
    ``device`` with seeded parameters and running statistics."""
    g = torch.Generator().manual_seed(seed)
    values = {name: torch.randn(c, generator=g)
              for name in ("weight", "bias", "running_mean")}
    values["running_var"] = torch.rand(c, generator=g) + 0.5
    bns = [_bn(c).to(device).train() for _ in range(2)]
    with torch.no_grad():
        for bn in bns:
            for name, v in values.items():
                getattr(bn, name).copy_(v)
    return bns


def activation(shape, dtype, seed: int, channels_last: bool,
               device="cpu"):
    """A seeded activation on ``device`` with per-channel offsets and
    scales, in ``dtype`` and the given memory layout."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]

    def draw(fn, size):
        return fn(size, generator=g, device=device)

    scale = draw(torch.rand, (c,))[None, :, None, None] * 3 + 0.1
    offset = draw(torch.randn, (c,))[None, :, None, None] * 2
    x = (draw(torch.randn, shape) * scale + offset).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x


def far_apart(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest distance of the elements more than 1 ulp apart, against
    ``want``'s largest magnitude (0 when none is)."""
    off = ulps(got, want) > 1
    if not bool(off.any()):
        return 0.0
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs()[off].max() / want.abs().max())


def step_gaps(new: BatchNorm, old: BatchNorm, x: torch.Tensor,
              dy: torch.Tensor) -> dict:
    """One train-mode forward and backward of ``new`` and of
    :func:`two_pass` on ``old``, from ``x`` with the cotangent ``dy``.
    Checks the dtypes (the output and the input's gradient in ``x``'s,
    the weight's and bias's gradients and the running statistics in
    float32) and returns the gaps: the output's and the input gradient's
    largest ulps apart (``y_ulps``, ``gx_ulps``) and :func:`far_apart`
    (``y_far``, ``gx_far``), the weight's and bias's gradients' relative
    gaps (:func:`rel`), and the running statistics' largest relative gap
    element by element."""
    xs = [x.clone().requires_grad_() for _ in range(2)]
    y_new, y_old = new(xs[0]), two_pass(old, xs[1])
    assert y_new.dtype == y_old.dtype == x.dtype
    gx_new, gw_new, gb_new = torch.autograd.grad(
        y_new, (xs[0], new.weight, new.bias), dy)
    gx_old, gw_old, gb_old = torch.autograd.grad(
        y_old, (xs[1], old.weight, old.bias), dy)
    assert gx_new.dtype == x.dtype
    assert gw_new.dtype == gb_new.dtype == torch.float32
    gaps = {"y_ulps": int(ulps(y_new, y_old).max()),
            "y_far": far_apart(y_new, y_old),
            "gx_ulps": int(ulps(gx_new, gx_old).max()),
            "gx_far": far_apart(gx_new, gx_old),
            "grad_weight": rel(gw_new, gw_old),
            "grad_bias": rel(gb_new, gb_old)}
    for name in ("running_mean", "running_var"):
        a, b = getattr(new, name), getattr(old, name)
        assert a.dtype == torch.float32
        gaps[name] = float(((a - b) / b).abs().max())
    return gaps


@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_one_pass_matches_two_pass(dtype, channels_last):
    """Three train-mode steps of one BatchNorm, each a forward and a
    backward, on the new path and on :func:`two_pass`: the output and
    the input's gradient within 1 ulp, the weight's and bias's gradients
    within 1e-5 relative, the running statistics within 1e-6."""
    new, old = bn_pair(16, 0)
    for step in range(3):
        x = activation((6, 16, 12, 10), dtype, 10 + step, channels_last)
        dy = activation((6, 16, 12, 10), dtype, 20 + step, channels_last)
        gaps = step_gaps(new, old, x, dy)
        assert gaps["y_ulps"] <= 1 and gaps["gx_ulps"] <= 1, (step, gaps)
        assert gaps["grad_weight"] <= 1e-5, (step, gaps)
        assert gaps["grad_bias"] <= 1e-5, (step, gaps)
        assert gaps["running_mean"] <= 1e-6, (step, gaps)
        assert gaps["running_var"] <= 1e-6, (step, gaps)
    assert not torch.equal(new.running_var, bn_pair(16, 0)[0].running_var)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_update_stats_off_leaves_running_statistics(dtype):
    """The recompute's setting: the output as with ``update_stats`` on,
    the running statistics untouched."""
    bn, on = bn_pair(8, 1)
    bn.update_stats = False
    before = (bn.running_mean.clone(), bn.running_var.clone())
    x = activation((4, 8, 6, 6), dtype, 2, False)
    y = bn(x)
    assert torch.equal(bn.running_mean, before[0])
    assert torch.equal(bn.running_var, before[1])
    assert int(ulps(y, on(x)).max()) <= 1
    assert not torch.equal(on.running_mean, before[0])


def small_model(dtype) -> ResNetSQ:
    torch.manual_seed(3)
    return ResNetSQ(dtype=dtype if dtype == torch.bfloat16 else None).train()


def images(b: int = 2, size: int = 64) -> torch.Tensor:
    g = torch.Generator().manual_seed(4)
    return torch.rand((b, size, size, 1), generator=g)


def running_stats(model) -> dict:
    return {n: b.clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_remat_moves_running_statistics_once(dtype):
    """A ``remat`` forward and backward of ResNetSQ leaves every running
    statistic with the bits of a forward and backward without it (the
    recompute takes none), and each has moved; the one-pass path counts
    20 calls a forward and 20 more in the recompute."""
    x = images()
    models = {remat: small_model(dtype) for remat in (False, True)}
    start = running_stats(models[False])
    for remat, model in models.items():
        reset_bn_path_counts()
        params_vector(model(x, remat=remat)).sum().backward()
        assert bn_path_counts() == {
            "one_pass": N_BATCH_NORMS * (2 if remat else 1),
            "data_group": 0, "eval": 0}
    plain, recomputed = (running_stats(models[r]) for r in (False, True))
    for n, v in plain.items():
        assert torch.equal(recomputed[n], v), n
        assert not torch.equal(v, start[n]), n


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
def test_eval_path_gives_the_two_pass_bits(dtype):
    """Eval mode casts to float32, normalizes by the running statistics
    and casts back, as before; a ResNetSQ forward counts 20 eval calls."""
    bn, _ = bn_pair(8, 5)
    bn.eval()
    x = activation((4, 8, 6, 6), dtype, 6, False)
    want = F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                        bn.weight, bn.bias, False, 0.0, bn.eps).to(dtype)
    assert torch.equal(bn(x), want)
    model = small_model(dtype).eval()
    reset_bn_path_counts()
    with torch.no_grad():
        model(images())
    assert bn_path_counts() == {"one_pass": 0, "data_group": 0,
                                "eval": N_BATCH_NORMS}


def data_group_job(layout, spec):
    """Over this one-rank world's data group: one BatchNorm's forward and
    backward and the two-pass data-group code it keeps (the input cast to
    float32, :class:`_GlobalBatchNorm`, the running statistics moved by its
    moments, the output cast back). Returns, by dtype, the names of the
    outputs whose bits differ, and a ResNetSQ forward's path counts."""
    out = {}
    for dtype in DTYPES.values():
        new, old = bn_pair(8, 7)
        use_global_batch_stats(new, dist.group.WORLD)
        x = activation((4, 8, 6, 6), dtype, 8, False)
        dy = activation((4, 8, 6, 6), dtype, 9, False)
        xs = [x.clone().requires_grad_() for _ in range(2)]
        y_new = new(xs[0])
        y_old, mean, var = _GlobalBatchNorm.apply(
            xs[1].float(), old.weight, old.bias, old.eps, dist.group.WORLD)
        old._update_running(mean, var)
        y_old = y_old.to(dtype)
        pairs = {"y": (y_new, y_old)}
        grads = [torch.autograd.grad(y, (xx, bn.weight, bn.bias), dy)
                 for y, xx, bn in ((y_new, xs[0], new), (y_old, xs[1], old))]
        pairs.update(zip(("grad_x", "grad_weight", "grad_bias"), zip(*grads)))
        for name in ("running_mean", "running_var"):
            pairs[name] = (getattr(new, name), getattr(old, name))
        out[str(dtype)] = [name for name, (a, b) in pairs.items()
                           if a.dtype != b.dtype or not torch.equal(a, b)]
    model = build_model("resnet_sq").train()
    use_global_batch_stats(model, dist.group.WORLD)
    reset_bn_path_counts()
    model(images())
    out["counts"] = bn_path_counts()
    return out


def test_data_group_path_gives_the_two_pass_bits():
    out = dryrun.spawn(1, [(1, data_group_job, {})])[0][0]
    assert out.pop("counts") == {"one_pass": 0, "data_group": N_BATCH_NORMS,
                                 "eval": 0}
    assert out == {str(d): [] for d in DTYPES.values()}
