"""The boundary to the CUDA kernels (``sqtpu_torch/ops/kernels/_build.py``)
and the packers above it, on the CPU.

* The table of C entries equals the ``extern "C"`` functions of each
  ``csrc/*.cu``: names, return types and argument types.
* :func:`_build.launch` passes the device's current stream last and raises
  on a non-zero code; :func:`_build.build` keys a build by its defines and
  source root and keeps ptxas's log beside the library.
* Every packer (``hardrender.pack_frames``, both ``pack_params``,
  ``voxel_iou.pack_fields``) gives, with ``torch.equal``, the rows of the
  expressions the wrappers packed with before they shared one rotated
  frame and one row layout (copied here as the yardstick), and the same
  gradient.
* CPU tensors launch nothing, and ``reset_launches`` zeroes every key.
* ``explicit.py`` imports nothing from ``implicit.py``.
"""

import ast
import os
import re
import types

import pytest
import torch

from sqtpu_torch.data.synthetic import sample_params
from sqtpu_torch.ops import geometry, metrics
from sqtpu_torch.ops import quaternion as quat
from sqtpu_torch.ops.kernels import _build, launch_counts, reset_launches
from sqtpu_torch.ops.kernels import explicit as KE
from sqtpu_torch.ops.kernels import hardrender as H
from sqtpu_torch.ops.kernels import implicit as K
from sqtpu_torch.ops.kernels import voxel_iou as V
from sqtpu_torch.ops.kernels import (
    explicit_loss_auto, implicit_loss_auto, implicit_sums_slab_auto,
    render_hard_auto,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch(seed: int, b: int = 24, dtype=torch.float32):
    """Sampled truths and noisy predictions, two of them outside the
    clamp box."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    true = sample_params(b, gen)
    pred = true + 0.05 * torch.randn(true.shape, generator=gen)
    pred[0, 0], pred[1, 3], pred[2, 7] = -0.2, 1.7, 1.3
    return true.to(dtype), pred.to(dtype)


# ---- the C entries -----------------------------------------------------------

_C_TYPE = {"int": "i", "double": "d", "const char*": "s"}


def c_entries(source: str) -> dict:
    """The ``extern "C"`` functions of a CUDA source, name ->
    "return:arguments" in the table's letters."""
    block = source[source.index('extern "C" {'):
                   source.index('}  // extern "C"')]
    block = re.sub(r"//[^\n]*", "", block)
    out = {}
    for ret, name, args in re.findall(
            r"^(int|const char\*)\s+(sqtpu_\w+)\(([^)]*)\)", block,
            flags=re.MULTILINE):
        letters = "".join("p" if "*" in a else _C_TYPE[a.split()[0]]
                          for a in args.split(","))
        out[name] = f"{_C_TYPE[ret]}:{letters}"
    return out


@pytest.mark.parametrize("name", ["hardrender", "implicit", "explicit",
                                  "voxel_iou"])
def test_c_entries_match_the_table(name):
    with open(os.path.join(_build.CSRC_DIR, name + ".cu")) as f:
        got = c_entries(f.read())
    assert got == _build.ENTRIES[name]
    assert {k: len(v) - 2 for k, v in got.items()} == {
        k: len(v) - 2 for k, v in _build.ENTRIES[name].items()}


def test_the_table_names_every_source():
    sources = {f[:-3] for f in os.listdir(_build.CSRC_DIR)
               if f.endswith(".cu")}
    assert sources == set(_build.ENTRIES)


@pytest.mark.parametrize("err", [0, 9])
def test_launch_passes_the_current_stream_and_raises(monkeypatch, err):
    calls = []

    class FakeLib:
        @staticmethod
        def sqtpu_hardrender(*args):
            calls.append(args)
            return err

        @staticmethod
        def sqtpu_error_string(code):
            return f"error {code}".encode()

    entered = []

    class Device:
        def __init__(self, device):
            entered.append(device)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=77))
    dev = torch.device("cuda", 1)
    if err:
        with pytest.raises(RuntimeError,
                           match="hardrender kernel launch failed: error 9"):
            _build.launch(FakeLib, "sqtpu_hardrender", dev, 1, 2,
                          what="hardrender")
    else:
        _build.launch(FakeLib, "sqtpu_hardrender", dev, 1, 2,
                      what="hardrender")
    assert calls == [(1, 2, 77)] and entered == [dev]


def test_build_keys_defines_and_root_and_keeps_the_log(tmp_path,
                                                       monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nout=""; prev=""\n'
                    'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; '
                    'prev="$a"; done\n'
                    'echo "ptxas info : Used 40 registers" >&2\n'
                    'echo "$@" > "$out"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "build_log", {})
    other = tmp_path / "csrc"
    other.mkdir()
    for f in _build.source_files("explicit"):
        with open(f) as src:
            (other / os.path.basename(f)).write_text(src.read())

    own = _build.library_path("explicit")
    cut = _build.library_path("explicit", ("-DSQTPU_EXPLICIT_CULL=0",))
    assert own != cut
    assert _build.library_path("explicit", (), str(other)) == own
    log = _build.build("explicit", ("-DSQTPU_EXPLICIT_CULL=0",), str(other))
    assert "Used 40 registers" in log and os.path.exists(cut)
    with open(cut) as f:
        assert "-DSQTPU_EXPLICIT_CULL=0" in f.read()
    assert _build.build_log == {}            # another build: not recorded
    again = _build.build("explicit", ("-DSQTPU_EXPLICIT_CULL=0",),
                         str(other))
    assert again == log                      # from the log beside it
    assert _build.build("explicit") == log
    assert _build.build_log["explicit"]["built"] is True
    (other / "sq_field.cuh").write_text("// edited\n")
    assert _build.library_path("explicit", (), str(other)) != own


# ---- the packers against the expressions they replaced ---------------------

def _frame(p):
    a, e, t, q = geometry.split_params(p)
    rot = quat.to_matrix(quat.conjugate(q))
    return a, e, t, rot, torch.einsum("bij,bj->bi", rot, t)


def frames_before(p, n_sweep):
    p = p.to(torch.float32)
    b = p.shape[0]
    a, e, t, rot, tr = _frame(p)
    _, z_hi, step = geometry.z_support_window(a, rot, t, n_sweep)
    return torch.cat([
        a, (1.0 / e[:, 1])[:, None], (e[:, 1] / e[:, 0])[:, None],
        (1.0 / e[:, 0])[:, None], tr, rot.reshape(b, 9),
        z_hi[:, None], step[:, None], p.new_zeros((b, 4)),
    ], dim=-1).contiguous()


def frame_params_before(p):
    pp = geometry.clamp_params(p)
    a, e, _, rot, tr = _frame(pp)
    return torch.cat([a, e, tr, rot.reshape(-1, 9),
                      pp.new_zeros((pp.shape[0], 7))], dim=-1)


@torch.no_grad()
def support_before(p):
    pp = geometry.clamp_params(p)
    a, _, t, rot, _ = _frame(pp)
    zlo, zhi, _ = geometry.z_support_window(a, rot, t, 2)
    return zlo, zhi


def _with_tail(par, jlo, jhi, x0=0):
    tail = torch.zeros((par.shape[0], 7), dtype=par.dtype,
                       device=par.device)
    tail[:, 0], tail[:, 1], tail[:, 2] = jlo, jhi, float(x0)
    return torch.cat([par[:, :17], tail], dim=-1).contiguous()


def implicit_before(pred_p, n, z_window, margin, x0):
    par = frame_params_before(pred_p)
    if not z_window:
        return _with_tail(par, 0.0, float(n - 1), x0)
    zlo, zhi = support_before(pred_p)
    zlo = torch.clamp(zlo - margin, 0.0, 1.0)
    zhi = torch.clamp(zhi + margin, 0.0, 1.0)
    jlo = torch.ceil(zlo * (n - 1))
    jhi = torch.maximum(torch.floor(zhi * (n - 1)), jlo)
    return _with_tail(par, jlo, jhi, x0)


def explicit_before(true_p, pred_p, n, z_window, margin):
    par_t = frame_params_before(true_p.detach()).contiguous()
    par = frame_params_before(pred_p)
    if not z_window:
        return par_t, _with_tail(par, 0.0, float(n))
    lo_t, hi_t = support_before(true_p.to(torch.float32))
    lo_p, hi_p = support_before(pred_p.to(torch.float32))
    zlo = torch.clamp(torch.minimum(lo_t, lo_p) - margin, 0.0, 1.0)
    zhi = torch.clamp(torch.maximum(hi_t, hi_p) + margin, 0.0, 1.0)
    jlo = torch.ceil(zlo * n)
    jhi = torch.maximum(torch.floor(zhi * n), jlo)
    return par_t, _with_tail(par, jlo, jhi)


def fields_before(fields):
    dtype = V.row_dtype(fields)
    b = fields[0].shape[0]
    rows = [None] * len(fields)
    groups = dict.fromkeys(p.dtype for p in fields)
    for dt in groups:
        idx = [i for i, p in enumerate(fields) if p.dtype == dt]
        p = torch.stack([fields[i] for i in idx], dim=1).reshape(-1, 12)
        a, e, t, q = geometry.split_params(p)
        rot = quat.to_matrix(quat.conjugate(q))
        tr = torch.einsum("...ij,...j->...i", rot, t)
        e1, e2 = e[:, 0], e[:, 1]
        flag = p.new_full((p.shape[0], 1), float(dt == torch.bfloat16))
        packed = torch.cat([
            a, e, (1.0 / e2)[:, None], (e2 / e1)[:, None],
            (1.0 / e1)[:, None], tr, rot.reshape(-1, 9), flag,
            p.new_zeros((p.shape[0], 3)),
        ], dim=-1).to(dtype).reshape(b, len(idx), 24)
        if len(groups) == 1:
            return packed
        for j, i in enumerate(idx):
            rows[i] = packed[:, j]
    return torch.stack(rows, dim=1)


def _same_rows_and_gradient(pack, before, pred):
    """Rows equal and the gradient of a weighted sum of them equal."""
    a = pred.clone().requires_grad_()
    b = pred.clone().requires_grad_()
    got, want = pack(a), before(b)
    assert torch.equal(got, want) and got.is_contiguous()
    w = torch.randn(got.shape, generator=torch.Generator().manual_seed(1),
                    dtype=got.dtype)
    (got * w).sum().backward()
    (want * w).sum().backward()
    assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_sweep", [24, 48, 64])
def test_pack_frames_keeps_its_rows(seed, n_sweep):
    true, pred = _batch(seed)
    for p in (true, pred, pred.double()):
        assert torch.equal(H.pack_frames(p, n_sweep),
                           frames_before(p, n_sweep))


@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("z_window", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_implicit_pack_params_keeps_its_rows(seed, z_window, dtype):
    _, pred = _batch(seed, dtype=dtype)
    for n, x0 in ((16, 0), (64, 0), (64, 24)):
        _same_rows_and_gradient(
            lambda p: K.pack_params(p, n, z_window, x0=x0),
            lambda p: implicit_before(p, n, z_window, K.Z_MARGIN, x0), pred)
        if z_window:
            lo, hi = K.z_window_indices(pred, n)
            tail = implicit_before(pred, n, True, K.Z_MARGIN, x0)[:, 17:19]
            assert torch.equal(torch.stack([lo, hi], dim=-1), tail)


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("z_window", [True, False])
@pytest.mark.parametrize("sharp", [5.0, 20.0])
def test_explicit_pack_params_keeps_its_rows(seed, z_window, sharp):
    true, pred = _batch(seed)
    margin = KE.default_margin(sharp)
    for dtype in (torch.float32, torch.float64):
        t, p = true.to(dtype), pred.to(dtype)
        for n in (16, 32, 128):
            want_t, _ = explicit_before(t, p, n, z_window, margin)
            got_t, _ = KE.pack_params(t, p, n, z_window, margin)
            assert torch.equal(got_t, want_t) and got_t.is_contiguous()
            _same_rows_and_gradient(
                lambda q: KE.pack_params(t, q, n, z_window, margin)[1],
                lambda q: explicit_before(t, q, n, z_window, margin)[1], p)


@pytest.mark.parametrize("kind", ["float32", "float64", "bfloat16"])
def test_pack_fields_keeps_its_rows(kind):
    true, pred = _batch(6)
    if kind == "float32":
        fields = [true, pred, pred.flip(0)]
    elif kind == "float64":
        fields = [true.double(), pred.double()]
    else:
        fields = [true, pred.bfloat16(), pred, true.bfloat16()]
    got = V.pack_fields(fields)
    assert torch.equal(got, fields_before(fields))
    assert got.shape == (24, len(fields), V.PAR_STRIDE)


# ---- launches, imports, the metric's pair counts --------------------------

def test_cpu_tensors_launch_nothing_and_reset_zeroes_every_key():
    true, pred = _batch(7, b=4)
    for kernel in _build.KERNELS:
        _build.count(kernel)
    assert launch_counts() == dict.fromkeys(_build.KERNELS, 1)
    reset_launches()
    assert launch_counts() == dict.fromkeys(_build.KERNELS, 0)
    imgs = render_hard_auto(true, 32, n_sweep=24, n_bisect=4)
    implicit_loss_auto(imgs, pred.requires_grad_(), 16).backward()
    implicit_sums_slab_auto(imgs[:, :16, :4], pred, 0, 16)
    explicit_loss_auto(true, pred, 8).backward()
    metrics.iou_full(true, pred.detach(), 8)
    assert launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def test_explicit_imports_nothing_of_implicit():
    with open(KE.__file__) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert "implicit" not in (node.module or "")
            assert "implicit" not in [a.name for a in node.names]
        elif isinstance(node, ast.Import):
            assert not any("implicit" in a.name for a in node.names)


def test_pair_counts_build_each_grid_once_and_count_every_pair(
        monkeypatch):
    true, pred = _batch(8, b=20)
    fields, _ = metrics.full_fields(true, pred)
    built = []
    grids = metrics._binary_voxels
    monkeypatch.setattr(metrics, "_binary_voxels",
                        lambda p, n: built.append(p.shape[0]) or grids(p, n))
    got = metrics.pair_counts(fields, metrics.FULL_PAIRS, 12)
    assert built == [16] * 5 + [4] * 5      # two chunks of five fields
    monkeypatch.setattr(metrics, "_binary_voxels", grids)
    want = torch.stack([torch.stack(metrics.plain_iou_counts(
        fields[f], fields[g], 12), dim=-1) for f, g in metrics.FULL_PAIRS],
        dim=1)
    assert torch.equal(got, want)
