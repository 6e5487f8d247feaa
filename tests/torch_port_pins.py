"""The JAX package's numbers that ``chip_smoke.py`` phases 24-29 and
``tests/test_torch_port_gpu.py`` hold the port to, computed on the CPU in
float32 (bfloat16 for phase 29).

Not a test module (pytest collects ``test_*.py`` only): a script of the
test suite, run from the repository root::

    python tests/torch_port_pins.py lm          # phase 24
    python tests/torch_port_pins.py gd          # phase 25
    python tests/torch_port_pins.py gd_window   # the window's gap at gd
    python tests/torch_port_pins.py corrector   # phase 26
    python tests/torch_port_pins.py fit         # phase 28
    python tests/torch_port_pins.py bf16        # phase 29
    python tests/torch_port_pins.py bf16_step   # phase 29, card tests
    python tests/torch_port_pins.py probe       # phase 36

Each prints one JSON line per result. The truths are the 1000 recorded in
``runs/eval_c4c3/accs.npz``; their images are rendered by the JAX
package's hard renderer at the evaluation setting (64 slabs, 16
bisections, quantized), predicted by the flax model on the CPU and scored
with ``iou_full`` at 128³, as ``sqtpu.evaluate`` does. ``fit`` runs the
JAX package's fitting functions on the truth and the initial parameters
that ``python -m sqtpu_torch.fit`` draws (the port's generator, on the
CPU), so both packages fit the same shape from the same start. ``bf16``
is the ssl artifact's implicit loss (64³, τ 1.5, sharpness 260) of the
bfloat16 ResNetSQ's eval-mode predictions on the first 16 truths rendered
at the training setting (48 slabs, 12 bisections), phase 9's number with
the model's ``dtype`` bfloat16. ``bf16_step`` is the bfloat16-against-
float32 gaps of one train step in both packages on the same inputs
(:func:`bf16_step_gaps`): phase 29's step and
``tests/test_torch_port_gpu.py::test_bf16_step_on_card``'s. ``probe``
is the JAX package's ``tools/probe_keras2019.py`` run at phase 36's
setting (PROBE_*), with its own truths and starts: it writes them, the
losses of the first 10 steps, the non-finite-gradient flags and the final
IoUs to PROBE_PINS, which phase 36 feeds the port's descent.
``gd_window`` measures, in float64, what a z-window does to the ``gd``
refinement's loss (64³, τ 1.5, sharpness 260) on c4's estimates of the
first 125 truths and on the LM's (``lm+gd``'s start): the port's
emulation of K1/K2 over each sample's window against the plain,
full-lattice loss that ``sqtpu/fit.py:332`` differentiates, and the
port's 30-step refinement through each.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from sqtpu import fit as jfit  # noqa: E402
from sqtpu.models import build_model, params_vector  # noqa: E402
from sqtpu.ops import metrics  # noqa: E402
from sqtpu.ops.kernels import render_hard_auto  # noqa: E402
from sqtpu.utils.checkpoint import load_weights_npz  # noqa: E402

TRUTHS = os.path.join(ROOT, "runs", "eval_c4c3", "accs.npz")
C4 = os.path.join(ROOT, "artifacts", "resnet_sq_c4_fp16.npz")
C4R1 = os.path.join(ROOT, "artifacts", "refine_sq_c4r1_fp16.npz")
BATCH = 125
SCORE_CHUNK = 25


def truths(n: int) -> np.ndarray:
    with np.load(TRUTHS) as d:
        return d["true_params"][:n].astype(np.float32)


_render = jax.jit(lambda p: render_hard_auto(p, 256, n_sweep=64,
                                             n_bisect=16, quantize=True))


def images(p: np.ndarray) -> np.ndarray:
    return np.concatenate([np.asarray(_render(jnp.asarray(p[i:i + BATCH])))
                           for i in range(0, p.shape[0], BATCH)])


_score = jax.jit(lambda t, p: metrics.iou_full(t, p, 128))


def score(true: np.ndarray, pred: np.ndarray) -> dict:
    tri = np.concatenate([
        np.asarray(_score(jnp.asarray(true[i:i + SCORE_CHUNK]),
                          jnp.asarray(pred[i:i + SCORE_CHUNK])))
        for i in range(0, true.shape[0], SCORE_CHUNK)])
    return {"full_iou": float(tri[:, 1].mean()),
            "rot_iou": float(tri[:, 0].mean()), "n": int(true.shape[0])}


def model_fn(name: str, weights: str):
    model = build_model(name)
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 1), jnp.float32))
    variables = load_weights_npz(weights, {
        "params": template["params"],
        "batch_stats": template["batch_stats"]})
    return jax.jit(lambda x: params_vector(
        model.apply(variables, x[..., None], train=False)))


def predict(fn, imgs: np.ndarray) -> np.ndarray:
    return np.concatenate([np.asarray(fn(jnp.asarray(imgs[i:i + BATCH])))
                           for i in range(0, imgs.shape[0], BATCH)])


def batched(fn, imgs: np.ndarray, *args) -> np.ndarray:
    """``fn`` over the rows of ``imgs`` (and of each of ``args``) in
    batches of BATCH."""
    out = []
    for i in range(0, imgs.shape[0], BATCH):
        out.append(np.asarray(fn(jnp.asarray(imgs[i:i + BATCH]),
                                 *(jnp.asarray(a[i:i + BATCH])
                                   for a in args))))
    return np.concatenate(out)


def emit(name: str, t0: float, **kw) -> None:
    print(json.dumps({"pin": name, "seconds": round(time.time() - t0, 1),
                      **kw}), flush=True)


def _classical(robust: bool):
    kw = (dict(robust_c=4.685, prefilter="median", residual="radial")
          if robust else {})
    return jax.jit(jax.vmap(lambda im: jfit.recover(
        im, n_points=64, iters=30, **kw)[0]))


def pin_lm(n: int) -> None:
    """Phase 24: (a) ``--model classical``, its moments init alone,
    (b) c4 + ``--refine lm --refine-steps 30``, c4 alone, (c) the robust
    classical setting."""
    t0 = time.time()
    p = truths(n)
    imgs = images(p)

    def init(im):
        img = jfit.apply_prefilter(im, "none")
        return jfit.moments_init(*jfit.image_points(img, 64))
    emit("moments_init", t0, **score(p, batched(jax.jit(jax.vmap(init)),
                                                 imgs)))
    emit("classical", t0, **score(p, batched(_classical(False), imgs)))
    emit("classical_robust", t0, **score(p, batched(_classical(True), imgs)))
    c4 = predict(model_fn("resnet_sq", C4), imgs)
    emit("c4", t0, **score(p, c4))
    lm = jax.jit(lambda im, q: jfit.refine_params(im, q, "lm", 30, 64))
    emit("c4_refine_lm", t0, **score(p, batched(lm, imgs, c4)))


def pin_gd(n: int) -> None:
    """Phase 25: c4 alone, c4 + ``--refine gd`` and ``lm+gd`` (30 steps,
    the first ``n`` truths)."""
    t0 = time.time()
    p = truths(n)
    imgs = images(p)
    c4 = predict(model_fn("resnet_sq", C4), imgs)
    emit(f"c4_first{n}", t0, **score(p, c4))
    for method in ("gd", "lm+gd"):
        fn = jax.jit(lambda im, q, m=method: jfit.refine_params(
            im, q, m, 30, 64))
        emit(f"c4_refine_{method}", t0, **score(p, batched(fn, imgs, c4)))


GD_CHUNK = 25


def _port_gd_gaps(imgs: np.ndarray, start: np.ndarray) -> dict:
    """The per-sample loss and gradient of the port's windowed emulation
    (what K1/K2 computed before the full sweep) and full-sweep emulation
    against the plain loss, float64, at the gd setting: the largest
    relative value gap, and the largest gradient gap of a sample over
    that sample's largest gradient component."""
    import torch

    from sqtpu_torch.ops import losses as tlosses
    from sqtpu_torch.ops.kernels import implicit as tK

    def per_sample(fn, im, q):
        x = q.clone().requires_grad_(True)
        v = fn(im, x)
        g, = torch.autograd.grad(v.sum(), x)
        return v.detach(), g

    fns = {
        "plain": lambda im, x: tlosses.implicit_loss(
            im, x, 64, 1.5, 260.0, reduce=False),
        "window": lambda im, x: tK.implicit_loss_emulated(
            im, x, 64, 1.5, 260.0, z_window=True, reduce=False),
        "full_sweep": lambda im, x: tK.implicit_loss_emulated(
            im, x, 64, 1.5, 260.0, z_window=False, reduce=False)}
    out = {k: ([], []) for k in fns}
    for i in range(0, imgs.shape[0], GD_CHUNK):
        im = torch.from_numpy(imgs[i:i + GD_CHUNK].astype(np.float64))
        q = torch.from_numpy(start[i:i + GD_CHUNK].astype(np.float64))
        for k, fn in fns.items():
            v, g = per_sample(fn, im, q)
            out[k][0].append(v)
            out[k][1].append(g)
    (vp, gp) = (torch.cat(x) for x in out["plain"])
    res = {}
    for k in ("window", "full_sweep"):
        v, g = (torch.cat(x) for x in out[k])
        rel = ((v - vp).abs() / vp.abs()).max()
        grel = ((g - gp).abs().amax(1) / gp.abs().amax(1))
        res[k] = {"value_rel_max": float(rel),
                  "mean_value_rel": float(abs(v.mean() - vp.mean())
                                          / vp.mean()),
                  "grad_rel_max": float(grel.max()),
                  "grad_rel_median": float(grel.median()),
                  "worst_sample": int(grel.argmax())}
    return res


def _port_gd(imgs: np.ndarray, start: np.ndarray, window: bool,
             steps: int = 30) -> np.ndarray:
    """The port's ``refine_params(..., "gd", steps, 64)`` in float64 on
    the CPU through the plain loss, or with K1/K2's windowed emulation in
    its place."""
    import torch

    from sqtpu_torch import fit as tfit
    from sqtpu_torch.ops.kernels import implicit as tK

    auto = tfit.implicit_loss_auto
    if window:
        tfit.implicit_loss_auto = (
            lambda *a, z_window=True, **k: tK.implicit_loss_emulated(
                *a, z_window=True, **k))
    try:
        return np.concatenate([tfit.refine_params(
            torch.from_numpy(imgs[i:i + GD_CHUNK].astype(np.float64)),
            torch.from_numpy(start[i:i + GD_CHUNK].astype(np.float64)),
            "gd", steps, 64).numpy()
            for i in range(0, imgs.shape[0], GD_CHUNK)])
    finally:
        tfit.implicit_loss_auto = auto


def pin_gd_window(n: int) -> None:
    """The z-window's gap at the gd refinement's setting (see the module's
    docstring), and what it does to the refined means."""
    import torch

    torch.set_num_threads(4)
    t0 = time.time()
    p = truths(n)
    imgs = images(p)
    c4 = predict(model_fn("resnet_sq", C4), imgs)
    lm = batched(jax.jit(lambda im, q: jfit.refine_params(
        im, q, "lm", 30, 64)), imgs, c4)
    emit("gd_window_gap_at_c4", t0, n=n, **_port_gd_gaps(imgs, c4))
    emit("gd_window_gap_at_lm", t0, n=n, **_port_gd_gaps(imgs, lm))
    plain = _port_gd(imgs, c4, window=False)
    windowed = _port_gd(imgs, c4, window=True)
    emit("gd_window_refined", t0, n=n,
         params_max_abs_gap=float(np.abs(windowed - plain).max()),
         plain=score(p, plain.astype(np.float32)),
         window=score(p, windowed.astype(np.float32)))


def pin_corrector(n: int) -> None:
    """Phase 26: the refine_sq corrector (c4r1) and it + LM."""
    t0 = time.time()
    p = truths(n)
    imgs = images(p)
    pred = predict(model_fn("refine_sq", C4R1), imgs)
    emit("c4r1", t0, **score(p, pred))
    lm = jax.jit(lambda im, q: jfit.refine_params(im, q, "lm", 30, 64))
    emit("c4r1_refine_lm", t0, **score(p, batched(lm, imgs, pred)))


def pin_fit() -> None:
    """Phase 28: the JAX package's fits of the port CLI's truth and
    start, each run of ``python -m sqtpu_torch.fit`` that the smoke makes:
    the full IoU at 64³ that ``sqtpu.fit.main`` reports."""
    from sqtpu.ops.render import render_depth_hard, render_depth_view
    from sqtpu.utils.config import FitConfig
    from sqtpu_torch import fit as tfit
    from sqtpu_torch.utils.config import FitConfig as TFitConfig

    t0 = time.time()
    for args in (["--optimizer", "lm"],
                 ["--optimizer", "lm", "--n-views", "4"],
                 ["--optimizer", "adam", "--loss", "implicit",
                  "--steps", "200"]):
        tcfg = tfit.parse_cli(TFitConfig, args + ["--device", "cpu"])
        true_p, p0 = (jnp.asarray(x.numpy()) for x in
                      tfit.draw_truth_and_start(tcfg))
        cfg = jfit.parse_cli(FitConfig, args)
        img = render_depth_hard(true_p, 256, n_bisect=12, quantize=True)
        iters = cfg.steps if cfg.steps <= 200 else 50
        if cfg.optimizer == "lm" and cfg.n_views > 1:
            angs = jnp.arange(cfg.n_views) * (2 * jnp.pi / cfg.n_views)
            half = angs / 2
            cam_qs = jnp.stack([jnp.zeros_like(half), jnp.sin(half),
                                jnp.zeros_like(half), jnp.cos(half)], -1)
            views = jax.vmap(lambda q: render_depth_view(true_p, q, 256))(
                cam_qs)
            p_fit, _ = jfit.recover_multiview(views, cam_qs, iters=iters)
        elif cfg.optimizer == "lm":
            p_fit, _ = jfit.recover(img, iters=iters)
        else:
            p_fit, _ = jfit.gd_fit(cfg, target_params=true_p,
                                   target_image=img, p0=p0)
        iou = float(metrics.iou(true_p[None], p_fit[None], 64))
        emit("fit " + " ".join(args), t0, iou=iou,
             true=np.asarray(true_p).tolist(),
             fit=np.asarray(p_fit).tolist())


def pin_bf16() -> None:
    """Phase 29: the ssl artifact's validation loss with the bfloat16
    model (flax's ``dtype``)."""
    from sqtpu.models import ResNetSQ
    from sqtpu.ops import losses

    t0 = time.time()
    p = jnp.asarray(truths(16))
    imgs = render_hard_auto(p, 256, n_sweep=48, n_bisect=12, quantize=True)
    model = ResNetSQ(dtype=jnp.bfloat16)
    template = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 1), jnp.float32))
    variables = load_weights_npz(
        os.path.join(ROOT, "artifacts", "resnet_sq_ssl_fp16.npz"),
        {"params": template["params"],
         "batch_stats": template["batch_stats"]})
    pred = params_vector(model.apply(variables, imgs[..., None],
                                     train=False))
    emit("ssl_bf16_val_loss", t0, loss=float(losses.implicit_loss(
        imgs, pred, 64, 1.5, 260.0)), pred_dtype=str(pred.dtype))


def _nest(flat: dict) -> dict:
    """Flat flax names (``params/encoder/conv1/kernel``) -> variables."""
    out = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(value)
    return out


def _step_loss_fn(model, variables, imgs, labels, dtype: str):
    """The JAX package's train step's loss (the plain implicit loss at
    64³, τ 1.5, sharpness 260) as a function of the parameters."""
    from sqtpu.training import loop as jloop
    from sqtpu.utils import config as jconfig

    cfg = jconfig.TrainConfig(batch_size=int(imgs.shape[0]),
                              use_pallas=False, dtype=dtype)

    def loss_fn(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             imgs, train=True, mutable=["batch_stats"])
        return jloop._compute_loss(cfg, params_vector(out), imgs, labels,
                                   None)
    return loss_fn


# The bf16 gaps' own spread: one statistic of one step moves by several
# times under a change far below bf16's resolution (2^-8), such as 4
# pixels one gray level apart; each run after the first scales every
# weight by 1 + SPREAD_SCALE·N(0, 1).
SPREAD_RUNS, SPREAD_SCALE, SPREAD_SEED = 16, 2.0 ** -18, 0


def jax_gap_spread(models: dict, variables: dict, imgs, labels,
                   runs: int = SPREAD_RUNS) -> dict:
    """Each statistic of ``bf16_gaps`` over ``runs`` runs of the JAX
    package's step, the first on ``variables`` as they are, as
    ``{statistic: [value of each run]}``."""
    from test_torch_port_gpu import bf16_gaps

    rng = np.random.default_rng(SPREAD_SEED)
    steps = {d: jax.jit(jax.value_and_grad(
        _step_loss_fn(m, variables, imgs, labels, d)))
        for d, m in models.items()}
    spread = {}
    for run in range(runs):
        params = variables["params"] if run == 0 else jax.tree_util.tree_map(
            lambda w: jnp.asarray(np.asarray(w) * (
                1 + SPREAD_SCALE * rng.standard_normal(np.shape(w))),
                jnp.float32), variables["params"])
        results = {d: step(params) for d, step in steps.items()}
        gaps = bf16_gaps({d: (float(loss), _flat(grads))
                          for d, (loss, grads) in results.items()})
        for key, value in gaps.items():
            spread.setdefault(key, []).append(value)
    return spread


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree, np.float64)}


def _port_step(model, imgs: np.ndarray, labels: np.ndarray, dtype: str):
    """The port's train step on the CPU: its loss and gradients."""
    import torch

    from sqtpu_torch.training.loop import make_train_step
    from sqtpu_torch.training.state import create_train_state
    from sqtpu_torch.utils.config import TrainConfig

    cfg = TrainConfig(batch_size=int(imgs.shape[0]), dtype=dtype,
                      device="cpu")
    loss = make_train_step(create_train_state(model, cfg), cfg)(
        torch.from_numpy(imgs), torch.from_numpy(labels))
    return float(loss), {n: p.grad.double().numpy()
                         for n, p in model.named_parameters()}


def bf16_step_gaps(case: str, runs: int = SPREAD_RUNS) -> dict:
    """The bf16-against-fp32 gaps of one ssl train step
    (``test_torch_port_gpu.bf16_gaps``): the JAX package's over ``runs``
    runs (:func:`jax_gap_spread`; ``jax`` is the first, ``jax_max`` each
    statistic's largest) and the port's on the same inputs, both on the
    CPU. ``case`` is ``ssl``, phase 29's step (the ssl artifact, the first
    8 truths at 256²), or ``random``, ``test_bf16_step_on_card``'s
    (ResNetSQ with ``numpy_weights(BF16_STEP_SEED)``, carried into flax,
    on 8 shapes of ``_params`` from the same seed at 128²); each rendered
    by the JAX package's plain renderer at the training setting."""
    from sqtpu.models import ResNetSQ
    from sqtpu.ops import render as jrender
    from sqtpu_torch.models import ResNetSQ as PortResNetSQ
    from sqtpu_torch.utils.checkpoint import (
        flax_from_state_dict, load_weights_npz as port_load_weights,
    )
    from sqtpu_torch.utils.config import MODEL_DTYPES
    from test_torch_port_gpu import (
        BF16_STEP_SEED, _params, bf16_gaps, numpy_weights,
    )

    if case == "ssl":
        p, size = truths(8), 256
        weights = os.path.join(ROOT, "artifacts", "resnet_sq_ssl_fp16.npz")
    else:
        p, size = _params(np.random.default_rng(BF16_STEP_SEED), 8), 128
        drawn = numpy_weights(PortResNetSQ(), BF16_STEP_SEED).state_dict()
        weights = None
    imgs = np.asarray(jrender.render_depth_hard_batch(
        jnp.asarray(p), size, n_bisect=12, quantize=True,
        n_sweep=48))[..., None]
    models, port_runs = {}, {}
    for dtype in ("float32", "bfloat16"):
        models[dtype] = ResNetSQ(
            dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
        port = PortResNetSQ(dtype=MODEL_DTYPES[dtype])
        if weights:
            template = jax.eval_shape(models[dtype].init,
                                      jax.random.PRNGKey(0),
                                      jnp.zeros((1, 32, 32, 1)))
            variables = load_weights_npz(weights, {
                "params": template["params"],
                "batch_stats": template["batch_stats"]})
            port_load_weights(weights, port)
        else:
            variables = _nest(flax_from_state_dict(drawn))
            port.load_state_dict(drawn)
        port_runs[dtype] = _port_step(port, imgs, p, dtype)
    spread = jax_gap_spread(models, variables, jnp.asarray(imgs),
                            jnp.asarray(p), runs)
    return {"jax": {k: v[0] for k, v in spread.items()},
            "jax_max": {k: max(v) for k, v in spread.items()},
            "jax_spread": spread, "port_cpu": bf16_gaps(port_runs)}


PROBE_PINS = os.path.join(ROOT, "tests", "torch_port_probe_pins.json")
PROBE_ROTS = (0.35, 1.57)
PROBE_LOSSES = ("keras_raw", "keras_clip=100", "keras_clip=2", "explicit2020")
PROBE_LR, PROBE_SEEDS, PROBE_STEPS = 3e-3, 4, 300


def jax_probe_tool():
    """The JAX package's ``tools/probe_keras2019.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_probe_keras2019",
        os.path.join(ROOT, "tools", "probe_keras2019.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_probe_run(loss_name: str, lr: float, steps: int, seeds: int,
                  rot_rad: float) -> dict:
    """``run_config`` of the JAX tool (its draws from PRNGKey(7), its
    loop), returning the truths, starts and every step's losses too."""
    import optax

    from sqtpu.data.synthetic import sample_params

    jp = jax_probe_tool()
    loss_fn = jp.make_loss(loss_name)

    def fit_one(key):
        kp, ki = jax.random.split(key)
        truth = sample_params(kp, 1, canonical=False)[0]
        p0 = jp.perturb(ki, truth, rot_rad)
        opt = optax.adam(lr)

        def step(carry, _):
            p, ostate = carry
            g = jax.grad(lambda pp: loss_fn(truth, pp))(p)
            g = jnp.where(jnp.isfinite(g), g, 0.0)
            upd, ostate = opt.update(g, ostate, p)
            p = p + upd
            p = p.at[8:12].set(p[8:12] / jnp.linalg.norm(p[8:12]))
            return (p, ostate), (loss_fn(truth, p),
                                 jnp.any(~jnp.isfinite(g)))
        (pf, _), (ls, nang) = jax.lax.scan(
            step, (p0, opt.init(p0)), None, length=steps)
        return truth, p0, pf, ls, nang

    keys = jax.random.split(jax.random.PRNGKey(7), seeds)
    truth, p0, pf, ls, nang = jax.jit(jax.vmap(fit_one))(keys)
    iouf = metrics.iou(truth, pf, 64, reduce=False)
    return {"truth": np.asarray(truth).tolist(),
            "p0": np.asarray(p0).tolist(),
            "losses_first_10": np.asarray(ls[:, :10]).tolist(),
            "any_nan_grad": [bool(x) for x in np.asarray(nang).any(1)],
            "final_iou": np.asarray(iouf).tolist(),
            "mean_final_iou": float(np.mean(np.asarray(iouf)))}


def pin_probe() -> None:
    """Phase 36: the JAX tool at each rotation and loss of PROBE_*, written
    to PROBE_PINS (the truths and starts once per rotation)."""
    out = {"lr": PROBE_LR, "seeds": PROBE_SEEDS, "steps": PROBE_STEPS,
           "rots": {}}
    for rot in PROBE_ROTS:
        t0 = time.time()
        runs = {name: jax_probe_run(name, PROBE_LR, PROBE_STEPS,
                                    PROBE_SEEDS, rot)
                for name in PROBE_LOSSES}
        first = runs[PROBE_LOSSES[0]]
        out["rots"][str(rot)] = {
            "truth": first["truth"], "p0": first["p0"],
            "losses": {k: {kk: v[kk] for kk in v if kk not in
                           ("truth", "p0")} for k, v in runs.items()}}
        emit(f"probe rot {rot}", t0, **{
            k: v["mean_final_iou"] for k, v in runs.items()})
    with open(PROBE_PINS, "w") as f:
        json.dump(out, f)
        f.write("\n")


def pin_bf16_step() -> None:
    """The JAX package's own bf16-against-fp32 step gaps that the card's
    are held to: phase 29's (``ssl``) and ``test_bf16_step_on_card``'s
    (``random``), the port's on the CPU beside them."""
    for case in ("ssl", "random"):
        t0 = time.time()
        emit(f"{case}_bf16_step_gaps", t0, **bf16_step_gaps(case))


if __name__ == "__main__":
    what = sys.argv[1]
    if what == "lm":
        pin_lm(int(sys.argv[2]) if len(sys.argv) > 2 else 1000)
    elif what == "gd":
        pin_gd(int(sys.argv[2]) if len(sys.argv) > 2 else BATCH)
    elif what == "gd_window":
        pin_gd_window(int(sys.argv[2]) if len(sys.argv) > 2 else BATCH)
    elif what == "corrector":
        pin_corrector(int(sys.argv[2]) if len(sys.argv) > 2 else 1000)
    elif what == "fit":
        pin_fit()
    elif what == "bf16":
        pin_bf16()
    elif what == "bf16_step":
        pin_bf16_step()
    elif what == "probe":
        pin_probe()
    else:
        raise SystemExit(f"unknown pin {what!r}")
