"""The port's corrector ``refine_sq`` (``IterativeSQ``) against the
benchmark's plain reference (``perfbench/reference/refiner.py``) on the
CPU, its weights through the benchmark's loader, and its spans.

* On seeded random weights whose delta head is drawn non-zero (the
  published init zeroes it, which makes every pass an identity), B=4,
  64², two passes, float32 and float64: with the reference fed the
  port's own in-loop renders (teacher-forced) the predictions agree to
  within a few float32 roundings (1e-5) or float64 ones (1e-12); with the
  reference rendering its own estimates, within 1e-4 and 1e-9: the
  in-loop render is float32 in both precisions, and a silhouette pixel
  that two estimates a rounding apart put on either side is a full depth
  step in the next pass's input.
* ``apply_delta`` equals the reference's bit for bit in float64.
* The c4r2 weights file's 218 arrays through the benchmark's loader equal
  the port's ``load_weights_npz`` tensors bit for bit, none left over.
* Under ``record_spans()`` a forward records ``refine.base`` once,
  ``refine.render`` and ``refine.pass`` once a pass, under
  ``eval.predict``; collecting changes no bit of the predictions.
"""

import contextlib
import os

import pytest
import torch

from perfbench import weights_refine
from perfbench.reference import refiner as ref_refiner
from sqtpu_torch import evaluate
from sqtpu_torch.data.synthetic import sample_params
from sqtpu_torch.models import apply_delta, build_model
from sqtpu_torch.ops.kernels import render_hard_auto
from sqtpu_torch.utils.checkpoint import load_weights_npz
from sqtpu_torch.utils.profiling import record_spans, span_totals

from test_torch_port_ops import _few_torch_threads  # noqa: F401
from test_torch_port_weights import ROOT

C4R2 = os.path.join(ROOT, "artifacts", "refine_sq_c4r2_fp16.npz")
C4R2_SHA256 = ("d7a1653b7e0569eea14d457caa28359901e275912ccf73072c07a7995"
               "0b24f8e")
SIZE, BATCH = 64, 4
CPU = torch.device("cpu")
# (teacher-forced, own renders) tolerances by dtype, see the docstring
TOLERANCES = {torch.float32: (1e-5, 1e-4), torch.float64: (1e-12, 1e-9)}


def _images(seed: int = 3) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    p = sample_params(BATCH, gen)
    return render_hard_auto(p, SIZE, n_sweep=64, n_bisect=16,
                            quantize=True)[..., None]


def _model(weights: dict, dtype):
    net = build_model("refine_sq", SIZE)
    net.load_state_dict(weights, strict=False)
    return net.to(dtype).eval()


def _recorded(net):
    """The port's forward with each pass's (estimate, render) recorded by
    a forward pre-hook on its block."""
    passes = []
    net.refine.register_forward_pre_hook(
        lambda module, args: passes.append((args[1].clone(),
                                            args[0][..., 1].clone())))
    return passes


@pytest.fixture(scope="module")
def random_weights():
    w = weights_refine.random(20260, CPU)
    assert float(w["refine.delta.weight"].abs().max()) > 0.05
    return w


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("renders", ["teacher_forced", "own"])
def test_forward_matches_the_plain_reference(random_weights, dtype,
                                             renders):
    w = {k: v.to(dtype) for k, v in random_weights.items()}
    net = _model(w, dtype)
    passes = _recorded(net)
    x = _images().to(dtype)
    with torch.no_grad():
        out = torch.cat(net(x), dim=-1)
    given = [r for _, r in passes] if renders == "teacher_forced" else None
    want, ref_passes = ref_refiner.forward(w, x, renders=given)
    tol = TOLERANCES[dtype][renders == "own"]
    assert out.dtype == want.dtype == dtype
    assert len(passes) == len(ref_passes) == 2
    # the passes move the estimate: the test is not of an identity
    assert float((out - passes[0][0]).abs().max()) > 1e-2
    for (est, _), (ref_est, _) in zip(passes, ref_passes):
        assert torch.allclose(est, ref_est, rtol=0, atol=tol)
    assert torch.allclose(out, want, rtol=0, atol=tol), float(
        (out - want).abs().max())


def test_apply_delta_matches_the_reference_to_the_bit():
    gen = torch.Generator().manual_seed(5)
    p = torch.cat([torch.rand(64, 8, generator=gen, dtype=torch.float64)
                   * 1.05,
                   torch.randn(64, 4, generator=gen, dtype=torch.float64)],
                  dim=-1)
    p[:, 8:] /= torch.linalg.vector_norm(p[:, 8:], dim=-1, keepdim=True)
    delta = torch.randn(64, 11, generator=gen, dtype=torch.float64) * 0.5
    delta[0] = 0.0
    for scale in (0.2, 1.0):
        got = apply_delta(p, delta, scale)
        want = ref_refiner.apply_delta(p, delta, scale)
        assert got.numpy().tobytes() == want.numpy().tobytes()


def test_the_c4r2_file_loads_as_the_port_loads_it():
    w = weights_refine.load_npz(C4R2, C4R2_SHA256, CPU)
    net = build_model("refine_sq")
    load_weights_npz(C4R2, net)
    sd = {k: v for k, v in net.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    assert len(w) == len(sd) == 218
    assert set(w) == set(sd) == {k for k, *_ in ref_refiner.spec()}
    for k, v in sd.items():
        assert w[k].dtype == v.dtype and torch.equal(w[k], v), k
    with pytest.raises(RuntimeError):
        weights_refine.load_npz(C4R2, "0" * 64, CPU)


def test_the_forward_records_its_spans_and_collecting_changes_no_bit(
        random_weights):
    net = _model(random_weights, torch.float32)
    x = _images(7)
    out = []
    for collect in (False, True):
        with record_spans() if collect else contextlib.nullcontext():
            out.append(evaluate.predict(net, x))
    assert out[0].numpy().tobytes() == out[1].numpy().tobytes()
    totals = span_totals()
    want = {"eval.predict": 1, "refine.base": 1, "refine.render": 2,
            "refine.pass": 2}
    assert {n: totals[n]["calls"] for n in want} == want
    for name in ("refine.base", "refine.render", "refine.pass"):
        assert totals[name]["parents"] == {"eval.predict": want[name]}
