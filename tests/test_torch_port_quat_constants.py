"""The quaternion helpers' constants, made once on the device.

``quaternion.conjugate`` negates the vector part, and the gauge group's
right-multiplications take their rows from ``losses.gauge_table``, made
once for each device and dtype; before, each call copied its constant
from host memory (``q.new_tensor(...)``), and on the card such a copy
waits for the stream to drain. The old expressions live on here, in this
file alone, as the yardstick: every helper and every caller of them gives
the old bits in float32, float64 and bfloat16, on rows with ±0, ±inf and
NaN (a NaN compares as a NaN: its payload may change, and only that), and
so do the gradients by ``backward`` and by forward-mode AD. A table first
made under ``torch.inference_mode()`` still serves a training step's
backward, and no call after the first makes a tensor from host data.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from sqtpu_torch.ops import losses, metrics
from sqtpu_torch.ops import quaternion as quat
from test_torch_port_ops import _few_torch_threads, random_params  # noqa: F401

DTYPES = (torch.float32, torch.float64, torch.bfloat16)
INTS = {torch.float64: torch.int64, torch.float32: torch.int32,
        torch.bfloat16: torch.int16, torch.float16: torch.int16}
IOU_N = 12


# -- the old expressions: one constant copied from the host per call --------

def old_conjugate(q):
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def old_right_multiply(q, g):
    return quat.multiply(q, q.new_tensor(g).expand_as(q))


def old_flip_orbit(q):
    return torch.stack([old_right_multiply(q, f)
                        for f in losses.SQ_FLIP_QUATS])


def old_param_gauge_orbit(p):
    a, e, t, q = p[..., 0:3], p[..., 3:5], p[..., 5:8], p[..., 8:12]
    a_sw = losses._swap_sizes(a)

    def variant(g, a_v):
        return torch.cat([a_v, e, t, old_right_multiply(q, g)], dim=-1)

    return torch.stack([variant(g, a) for g in losses.SQ_FLIP_QUATS]
                       + [variant(g, a_sw)
                          for g in losses.SQ_GAUGE_QUATS_SWAP])


def old_canonicalize_gauge(p):
    a, e, t, q = p[..., 0:3], p[..., 3:5], p[..., 5:8], p[..., 8:12]
    swap = (a[..., 0] < a[..., 1])[..., None]
    q_sw = old_right_multiply(q, losses.SQ_GAUGE_QUATS_SWAP[0])
    return torch.cat([torch.where(swap, losses._swap_sizes(a), a), e, t,
                      torch.where(swap, q_sw, q)], dim=-1)


@pytest.fixture
def old_helpers(monkeypatch):
    """Within the test, the program's callers reach the old expressions:
    ``conjugate`` in every frame, the orbits in ``metrics``."""
    def use():
        monkeypatch.setattr(quat, "conjugate", old_conjugate)
        monkeypatch.setattr(losses, "_flip_orbit", old_flip_orbit)
        monkeypatch.setattr(losses, "param_gauge_orbit",
                            old_param_gauge_orbit)
        monkeypatch.setattr(metrics, "_flip_orbit", old_flip_orbit)
        monkeypatch.setattr(metrics, "param_gauge_orbit",
                            old_param_gauge_orbit)
        monkeypatch.setattr(losses, "canonicalize_gauge",
                            old_canonicalize_gauge)
    return use


# -- inputs and comparisons ---------------------------------------------------

SPECIALS = (0.0, -0.0, float("inf"), -float("inf"), float("nan"))


def rows(dtype, b: int = 24) -> torch.Tensor:
    """(b + 10, 12) eval-distribution rows, then rows whose quaternion
    holds ±0, ±inf or NaN in each slot, and whose sizes are ±0 or ±inf."""
    p = torch.from_numpy(random_params(23, b + 10))
    for i, v in enumerate(SPECIALS):
        p[b + i, 8 + i % 4] = v
        p[b + i, 9 + i % 3] = -v
        p[b + 5 + i, i % 3] = v
        p[b + 5 + i, 8:12] = torch.tensor([v, 0.0, -0.0, 1.0])
    p[b + 9, 8:12] = torch.tensor([-0.0, -0.0, -0.0, -0.0])
    return p.to(dtype)


def assert_same_bits(new, old, what: str) -> None:
    assert new.dtype == old.dtype and new.shape == old.shape, what
    if not new.is_floating_point():
        assert torch.equal(new, old), what
        return
    nan = torch.isnan(new)
    assert torch.equal(nan, torch.isnan(old)), f"{what}: NaNs moved"
    bits_new = new[~nan].contiguous().view(INTS[new.dtype])
    bits_old = old[~nan].contiguous().view(INTS[old.dtype])
    off = int((bits_new != bits_old).sum())
    assert off == 0, f"{what}: {off} of {bits_new.numel()} values differ"


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def floats(out) -> tuple:
    return tuple(x for x in as_tuple(out) if x.is_floating_point())


# Each helper and caller, with its arguments drawn from the rows.
CASES = {
    "conjugate": (lambda q: quat.conjugate(q), lambda p: (p[:, 8:12],)),
    "flip_orbit": (lambda q: losses._flip_orbit(q), lambda p: (p[:, 8:12],)),
    "param_gauge_orbit": (lambda p: losses.param_gauge_orbit(p),
                          lambda p: (p,)),
    "canonicalize_gauge": (lambda p: losses.canonicalize_gauge(p),
                           lambda p: (p,)),
    "quaternion_loss_sym": (
        lambda qp, qt: losses.quaternion_loss_sym(qp, qt, reduce=False),
        lambda p: (p.flip(0)[:, 8:12], p[:, 8:12])),
    "gauge_align": (metrics.gauge_align, lambda p: (p, p.flip(0))),
    "iou_full": (lambda t, q: metrics.iou_full(t, q, IOU_N),
                 lambda p: (p, p.flip(0))),
}


def outputs_and_grads(fn, args):
    """The outputs, each argument's gradient by ``backward`` of a weighted
    sum of the float outputs, and the float outputs' tangents by
    forward-mode AD."""
    args = [a.detach().clone().requires_grad_(True) for a in args]
    out = as_tuple(fn(*args))
    gen = torch.Generator().manual_seed(5)
    loss = sum((x * torch.rand(x.shape, generator=gen).to(x.dtype)).sum()
               for x in floats(out) if x.requires_grad)
    grads = torch.autograd.grad(loss, args, allow_unused=True)
    grads = tuple(g if g is not None else torch.zeros_like(a)
                  for g, a in zip(grads, args))
    primals = tuple(a.detach() for a in args)
    tangents = tuple(torch.rand(a.shape, generator=gen).to(a.dtype) - 0.5
                     for a in primals)
    _, tangent_out = torch.func.jvp(lambda *xs: floats(fn(*xs)), primals,
                                    tangents)
    return tuple(x.detach() for x in out), grads, tangent_out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", sorted(CASES))
def test_helper_keeps_its_bits(case, dtype, old_helpers):
    fn, make_args = CASES[case]
    args = make_args(rows(dtype))
    new = outputs_and_grads(fn, args)
    old_helpers()
    old = outputs_and_grads(fn, args)
    for kind, n_list, o_list in zip(("output", "gradient", "tangent"), new,
                                    old):
        assert len(n_list) == len(o_list)
        for i, (n, o) in enumerate(zip(n_list, o_list)):
            assert_same_bits(n, o, f"{case} {dtype} {kind} {i}")


@pytest.mark.parametrize("dtype", DTYPES + (torch.float16,), ids=str)
def test_gauge_table_is_what_new_tensor_made(dtype):
    table = losses.gauge_table(torch.zeros(4, dtype=dtype))
    assert table.shape == (8, 4)
    for row, g in zip(table, losses.SQ_GAUGE_QUATS):
        assert_same_bits(row, torch.zeros(4, dtype=dtype).new_tensor(g),
                         f"row {g}")
    assert losses.gauge_table(torch.ones(3, 4, dtype=dtype)) is table


def test_table_made_in_inference_mode_serves_a_training_step(monkeypatch):
    """An evaluation under ``torch.inference_mode()`` makes the table
    first; a later training step saves it for backward (the gauge loss
    of a differentiated label) and trains the net through the explicit
    gauge loss, as the trainer does after a validation pass."""
    from sqtpu_torch.models import build_model
    from sqtpu_torch.training.loop import make_train_step
    from sqtpu_torch.training.state import create_train_state
    from sqtpu_torch.utils.config import TrainConfig

    monkeypatch.setattr(losses, "_gauge_tables", {})
    p = rows(torch.float32, b=6)[:6]
    with torch.inference_mode():
        metrics.iou_full(p, p.flip(0), IOU_N)
        losses.canonicalize_gauge(p)
    assert not losses.gauge_table(p).is_inference()
    labels = p.clone().requires_grad_(True)
    pred = p.flip(0).clone().requires_grad_(True)
    losses.param_gauge_loss(pred, labels).backward()
    losses.quaternion_loss_sym(pred[:, 8:12], labels[:, 8:12]).backward()
    assert torch.isfinite(labels.grad).all()

    torch.manual_seed(0)
    cfg = TrainConfig(loss="explicit_sym", batch_size=2, image_size=32,
                      render_size=8, gauge_weight=2.0, use_pallas=False)
    step = make_train_step(create_train_state(
        build_model("resnet_sq", cfg.image_size), cfg), cfg)
    imgs = torch.rand(2, cfg.image_size, cfg.image_size, 1)
    loss = step(imgs, p[:2])
    assert torch.isfinite(loss)


class _HostTensors(TorchDispatchMode):
    """Counts tensors made from host data (``torch.tensor``,
    ``new_tensor``): on the card each is a copy that drains the stream."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            self.made.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_no_tensor_from_host_data_after_the_first_call(dtype):
    """After a first call has made the table, the helpers and the
    closed loop's scoring (``iou_full``, the caller's ``gauge_align``)
    make no tensor from host data."""
    p = rows(dtype, b=6)[:6]
    calls = [lambda: quat.conjugate(p[:, 8:12]),
             lambda: losses.canonicalize_gauge(p),
             lambda: losses.quaternion_loss_sym(p[:, 8:12], p[:, 8:12]),
             lambda: metrics.iou_full(p, p.flip(0), IOU_N),
             lambda: metrics.gauge_align(p, p.flip(0))]
    for call in calls:
        call()
    with _HostTensors() as seen:
        for call in calls:
            call()
    assert seen.made == []
    with _HostTensors() as seen:       # the yardstick sees the old copies
        old_conjugate(p[:, 8:12])
        old_flip_orbit(p[:, 8:12])
    assert seen.made == [(4,)] * 5


def test_smoke_counts_stream_waits_by_call_site(monkeypatch):
    """``chip_smoke.stream_waits`` (phase 40) counts each synchronization
    warning at the program's innermost frame; other warnings pass."""
    import warnings

    import chip_smoke

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    conjugate = quat.conjugate

    def waits(q):
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("something else")
        return conjugate(q)

    monkeypatch.setattr(quat, "conjugate", waits)
    q = rows(torch.float32, b=4)[:4, 8:12]
    out, sites = chip_smoke.stream_waits(
        lambda: [metrics.angle_error(q, q) for _ in range(3)])
    assert len(out) == 3
    [(site, n)] = sites.items()
    assert n == 3
    assert site.startswith("sqtpu_torch/ops/metrics.py:")
    assert site.endswith("(angle_error)")
