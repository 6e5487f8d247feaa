"""The JAX package's numbers that ``chip_smoke.py`` phases 24-28 hold the
port to, computed on the CPU in float32.

Not a test module (pytest collects ``test_*.py`` only): a script of the
test suite, run from the repository root::

    python tests/torch_port_pins.py lm          # phase 24
    python tests/torch_port_pins.py gd          # phase 25
    python tests/torch_port_pins.py corrector   # phase 26
    python tests/torch_port_pins.py fit         # phase 28

Each prints one JSON line per result. The truths are the 1000 recorded in
``runs/eval_c4c3/accs.npz``; their images are rendered by the JAX
package's hard renderer at the evaluation setting (64 slabs, 16
bisections, quantized), predicted by the flax model on the CPU and scored
with ``iou_full`` at 128³, as ``sqtpu.evaluate`` does. ``fit`` runs the
JAX package's fitting functions on the truth and the initial parameters
that ``python -m sqtpu_torch.fit`` draws (the port's generator, on the
CPU), so both packages fit the same shape from the same start.
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


if __name__ == "__main__":
    what = sys.argv[1]
    if what == "lm":
        pin_lm(int(sys.argv[2]) if len(sys.argv) > 2 else 1000)
    elif what == "gd":
        pin_gd(int(sys.argv[2]) if len(sys.argv) > 2 else BATCH)
    elif what == "corrector":
        pin_corrector(int(sys.argv[2]) if len(sys.argv) > 2 else 1000)
    elif what == "fit":
        pin_fit()
    else:
        raise SystemExit(f"unknown pin {what!r}")
