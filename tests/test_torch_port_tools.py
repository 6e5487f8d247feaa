"""The port's tools (``sqtpu_torch.tools``) on the CPU: the 2019-landscape
probe against the JAX package's ``tools/probe_keras2019.py`` in float64,
and against its pinned float32 run (phase 36's inputs); the roofline and
serving-load tools end to end at a tiny size; the card's yardstick in one
module.

Tolerances: the probe's losses and gradients rtol 1e-6 (float64; the
2019 field's powers and sums in another order), 10 Adam steps 1e-6; the
port's float32 descent on the pinned truths and starts against the JAX
package's float32 run, the first 10 steps' losses 1e-4 where both are
finite (phase 36's bound; measured ≤ 5.2e-5, ``keras_raw``), and the
non-finite-gradient flags equal.
"""

import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sqtpu_torch.ops.kernels import bounds
from sqtpu_torch.tools import probe_keras2019 as tprobe
from sqtpu_torch.tools import roofline_explicit, serve_bench

from test_torch_port_ops import _few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINS = os.path.join(ROOT, "tests", "torch_port_probe_pins.json")
WEIGHTS = os.path.join(ROOT, "artifacts", "resnet_sq_c4_fp16.npz")
LOSSES = ("keras_raw", "keras_clip=100", "keras_clip=2", "explicit2020")


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_keras2019", os.path.join(ROOT, "tools",
                                            "probe_keras2019.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jprobe():
    return _jax_probe()


def _case(rot=0.35):
    """Two truths (the raw label convention) and starts near them, fp64."""
    gen = torch.Generator()
    gen.manual_seed(3)
    from sqtpu_torch.data.synthetic import sample_params

    truth = sample_params(2, gen, dtype=torch.float64, canonical=False)
    return truth, tprobe.perturb(gen, truth, rot)


@pytest.mark.parametrize("name", LOSSES)
def test_probe_losses_match_jax(name, jprobe):
    """Each seed's value, and the objective's gradient in each row equal
    to that seed's own loss's gradient."""
    truth, p0 = _case()
    objective, per_seed = tprobe.make_loss(name)
    p = p0.clone().requires_grad_(True)
    objective(truth, p).backward()
    values = per_seed(truth, p0)
    jfn = jprobe.make_loss(name)
    for b in range(2):
        tb, pb = jnp.asarray(truth[b].numpy()), jnp.asarray(p0[b].numpy())
        want_v, want_g = jax.value_and_grad(lambda q: jfn(tb, q))(pb)
        np.testing.assert_allclose(float(values[b]), float(want_v),
                                   rtol=1e-6)
        np.testing.assert_allclose(p.grad[b].numpy(), np.asarray(want_g),
                                   rtol=1e-6, atol=1e-9 * float(
                                       np.abs(np.asarray(want_g)).max()))


@pytest.mark.parametrize("name", LOSSES)
def test_probe_adam_steps_match_jax(name, jprobe):
    """10 steps of :func:`descend` from the same (truth, start) as the JAX
    tool's loop (its ``make_loss`` and ``optax.adam``)."""
    truth, p0 = _case()
    pf, ls, bad = tprobe.descend(name, truth, p0, 3e-3, 10)
    jfn = jprobe.make_loss(name)
    opt = optax.adam(3e-3)
    for b in range(2):
        tb = jnp.asarray(truth[b].numpy())
        p = jnp.asarray(p0[b].numpy())
        state = opt.init(p)
        for k in range(10):
            g = jax.grad(lambda q: jfn(tb, q))(p)
            g = jnp.where(jnp.isfinite(g), g, 0.0)
            upd, state = opt.update(g, state, p)
            p = p + upd
            p = p.at[8:12].set(p[8:12] / jnp.linalg.norm(p[8:12]))
            np.testing.assert_allclose(float(ls[b, k]), float(jfn(tb, p)),
                                       rtol=1e-6)
        np.testing.assert_allclose(pf[b].numpy(), np.asarray(p), rtol=1e-6,
                                   atol=1e-12)
    assert not bool(bad.any())


def test_perturb_keeps_the_probe_ranges():
    truth, p0 = _case(1.57)
    a, e = p0[:, 0:3], p0[:, 3:5]
    assert bool((a >= 25 / 255).all() and (a <= 75 / 255).all())
    assert bool((e >= 0.1).all() and (e <= 1.0).all())
    assert float((p0[:, 5:8] - truth[:, 5:8]).abs().max()) <= 0.04
    # the start's rotation is the truth's turned by 1.57 rad
    dot = torch.sum(p0[:, 8:] * truth[:, 8:], dim=-1).abs()
    np.testing.assert_allclose(2 * torch.acos(torch.clamp(dot, max=1.0)),
                               1.57, rtol=1e-9)


def _pins():
    with open(PINS) as f:
        return json.load(f)


@pytest.mark.parametrize("rot", ["0.35", "1.57"])
@pytest.mark.parametrize("name", LOSSES)
def test_probe_descent_matches_the_pinned_jax_run(rot, name):
    """Phase 36 on the CPU: the port's float32 descent fed the JAX tool's
    own truths and starts (``python tests/torch_port_pins.py probe``)."""
    pins = _pins()
    case = pins["rots"][rot]
    ref = case["losses"][name]
    truth = torch.tensor(case["truth"], dtype=torch.float32)
    p0 = torch.tensor(case["p0"], dtype=torch.float32)
    _, ls, bad = tprobe.descend(name, truth, p0, pins["lr"], 10)
    want = np.asarray(ref["losses_first_10"], np.float64)
    got = ls.double().numpy()
    assert (np.isfinite(got) == np.isfinite(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4)
    # ten steps flag no NaN gradient where the JAX run's 300 flag none
    if not any(ref["any_nan_grad"]):
        assert not bool(bad.any())


def test_probe_pins_hold_the_readme_finding():
    """At 1.57 rad the 2020 explicit loss recovers what the 2019 loss at
    the training cap does not (README's capture-range table): its mean
    final IoU at least 0.15 above ``keras_clip=100``'s in the JAX run."""
    rot = _pins()["rots"]["1.57"]["losses"]
    assert rot["explicit2020"]["mean_final_iou"] \
        >= rot["keras_clip=100"]["mean_final_iou"] + 0.15


def test_probe_cli_writes_records(tmp_path):
    out = tmp_path / "probe.jsonl"
    recs = tprobe.main(["--device", "cpu", "--steps", "3", "--seeds", "2",
                        "--losses", "keras_clip=2,explicit2020", "--lrs",
                        "3e-3", "--rots", "0.35", "--out", str(out)])
    lines = [json.loads(x) for x in open(out)]
    assert lines == json.loads(json.dumps(recs)) and len(lines) == 2
    keys = {"loss", "lr", "steps", "seeds", "rot_rad", "init_iou",
            "final_iou", "final_loss", "any_nan_grad", "mean_init_iou",
            "mean_final_iou"}
    assert all(set(r) == keys for r in lines)


def test_roofline_tool_on_the_cpu(monkeypatch, capsys):
    """End to end at batch 2 (64² images, N = 16 to keep the CPU's time
    small); the record's keys; no TPU constant left."""
    monkeypatch.setattr(roofline_explicit, "BATCH", 2)
    monkeypatch.setattr(roofline_explicit, "ITERS", 1)
    monkeypatch.setattr(roofline_explicit, "N", 16)
    monkeypatch.setattr(roofline_explicit, "IMAGE", 64)
    rec = roofline_explicit.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(rec))
    for key in ("kernel_ms", "bound_ms", "bound_by", "fraction_of_bound",
                "mean_window_planes", "encoder_fp32_ms", "encoder_bf16_ms",
                "full_step_ms", "full_step_bf16_ms",
                "full_imgs_per_sec_per_chip", "card", "device"):
        assert key in rec
    assert not any("vpu" in k or "light" in k for k in rec)
    assert rec["device"] == "cpu" and rec["fraction_of_bound"] is None
    assert rec["bound_by"] == "operations" and rec["bound_ms"] > 0
    assert all(rec[k] > 0 for k in ("kernel_ms", "encoder_fp32_ms",
                                    "full_step_ms", "full_step_bf16_ms"))
    assert not hasattr(roofline_explicit, "VPU_LIGHT_SPEED")


def test_serve_bench_on_the_cpu(tmp_path, monkeypatch):
    """2 clients × 3 requests on the c4 weights over 4 request images (32
    in the tool; the CPU's renderer takes seconds an image at the full
    sweep): no error, every request answered, each client's first answer
    the in-process model's."""
    import shutil

    from sqtpu_torch.data.bmp import read_bmp
    from sqtpu_torch.evaluate import load_eval_state, predict
    from sqtpu_torch.utils.config import ServeConfig

    render = serve_bench.render_request_images
    kept = tmp_path / "images"
    kept.mkdir()

    def render_and_keep(n, out_dir, device, seed=0):
        paths = render(n, out_dir, device, seed)
        for p in paths:
            shutil.copy(p, kept)
        return paths

    monkeypatch.setattr(serve_bench, "N_IMAGES", 4)
    monkeypatch.setattr(serve_bench, "render_request_images",
                        render_and_keep)
    out = tmp_path / "sb.json"
    rep = serve_bench.main(["--ckpt", WEIGHTS, "--device", "cpu",
                            "--clients", "2", "--requests", "3",
                            "--batch-size", "4", "--out", str(out)])
    assert json.load(open(out)) == json.loads(json.dumps(rep))
    assert rep["errors"] == 0 and rep["completed"] == 6
    assert set(rep["latency_ms"]) == {"p50", "p90", "p99", "mean", "max"}
    assert rep["server_stats"]["errors"] == 0
    assert rep["server_stats"]["requests"] == 4 + 6
    model = load_eval_state(ServeConfig(ckpt_dir=WEIGHTS, device="cpu"),
                            torch.device("cpu"))
    assert sorted(r["image"] for r in rep["first_responses"]) == [
        "req_000.bmp", "req_001.bmp"]
    for r in rep["first_responses"]:
        img = read_bmp(str(kept / r["image"])).astype(np.float32) / 255
        want = predict(model, torch.from_numpy(img)[None, ..., None])[0]
        np.testing.assert_allclose(r["params"], want.numpy(), atol=1e-5)


def test_the_yardstick_has_one_source():
    """chip_smoke.py reads the peaks and operation counts from
    ``sqtpu_torch.ops.kernels.bounds``; the numbers are those the earlier
    slices' bounds were computed with."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    names = ("PEAK_FP32_OPS", "PEAK_BYTES", "OPS_PER_TEST", "OPS_K1",
             "OPS_K2", "OPS_K1_CULLED", "OPS_K2_CULLED", "OPS_K4", "OPS_K5",
             "OPS_K4_CULLED", "OPS_K5_CULLED")
    assert not any(hasattr(smoke, n) for n in names)
    assert [getattr(bounds, n) for n in names] == [
        67e12, 3.35e12, 30, 59, 174, 44, 115, 226, 113, 152, 83]
    assert math.isclose(bounds.ops_ms(67e9, 1), 1.0)
    assert math.isclose(bounds.bytes_ms(3.35e9), 1.0)
    assert bounds.bound(2.0, 1.0) == (2.0, "operations")
    assert bounds.bound(1.0, 2.0) == (2.0, "bytes")


def test_explicit_bounds_count_the_cull():
    """K4's and K5's bounds at a small windowed batch: the emulation's
    points after the cull at 152 and 83 operations."""
    from sqtpu_torch.data.synthetic import sample_params
    from sqtpu_torch.ops.kernels import explicit as KE

    gen = torch.Generator()
    gen.manual_seed(5)
    t, p = sample_params(3, gen), sample_params(3, gen)
    par_t, par_p = KE.pack_params(t, p, 16, True, KE.default_margin(20.0))
    rows = bounds.explicit_bounds(par_t, par_p, 16, 20.0)
    culled = KE.cull_points(par_t, par_p, 16, 20.0)
    assert rows["K4"]["points_after_cull"] == culled > 0
    assert math.isclose(rows["K4"]["bound_ms"],
                        max(culled * 152 / 67e12 * 1e3,
                            (2 * 3 * KE.PAR_STRIDE * 4
                             + 3 * 4 * (1 + KE.PAR_STRIDE)) / 3.35e12 * 1e3))
    assert math.isclose(rows["K5"]["bound_ms"] / rows["K4"]["bound_ms"],
                        83 / 152) or rows["K5"]["bound_by"] == "bytes"
    assert rows["K4"]["in_window_points"] == KE.window_points(par_p, 16)
