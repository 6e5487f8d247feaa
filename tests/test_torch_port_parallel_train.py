"""The port's trainer over several ranks on the CPU: one train step of each
layout against the JAX package's.

One train step of each layout on two gloo ranks spawned by
``sqtpu_torch.parallel.dryrun``, against ``sqtpu.training.loop
.make_train_step`` over ``make_mesh(n_data, n_grid)`` on the conftest's
8-device CPU mesh, from the same weights on the same batch (B=4, 64²
images, render size 16):

* 'grid' 1×2 and 'data' 2×1 with the implicit loss, from the ssl artifact;
* 'data' 2×1 with the c4c recipe's ``explicit_sym`` loss and ``remat``,
  from the c4 artifact.

Tolerances are tests/test_torch_port_train.py's: loss relative 1e-5; each
parameter tensor's gradient within 2e-3 of that tensor's largest gradient;
the BatchNorm statistics rtol 1e-5. Both ranks hold the same model after
the step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sqtpu.models import build_model as flax_build_model
from sqtpu.models import params_vector as flax_params_vector
from sqtpu.parallel.mesh import make_mesh
from sqtpu.training import loop as jloop
from sqtpu.training.state import create_train_state as jax_create_state
from sqtpu.utils import config as jconfig
from sqtpu.utils.checkpoint import load_weights_npz as flax_load_weights
from sqtpu_torch.ops import render as trender
from sqtpu_torch.parallel import dryrun
from sqtpu_torch.utils.checkpoint import flax_from_state_dict
from sqtpu_torch.utils.config import TrainConfig

from test_torch_port_ops import _few_torch_threads  # noqa: F401
from test_torch_port_weights import ROOT, SSL, TRUTHS, _flat_stats, _images

C4 = os.path.join(ROOT, "artifacts", "resnet_sq_c4_fp16.npz")
SMALL = dict(batch_size=4, image_size=64, render_size=16, acc_render_size=16)
C4C = dict(loss="explicit_sym", explicit_sharp=20.0, gauge_weight=2.0,
           elong_weight=1.5, learning_rate=5e-6, nan_policy="skip",
           remat=True)
# name -> (n_data, n_grid, weights, recipe)
LAYOUTS = {"grid_1x2": (1, 2, SSL, {}), "data_2x1": (2, 1, SSL, {}),
           "c4c_data_2x1": (2, 1, C4, C4C)}


@pytest.fixture(scope="module")
def batches():
    ssl = (_images(90, 4, 64)[..., None], np.zeros((4, 12), np.float32))
    with np.load(TRUTHS) as d:
        labels = d["true_params"][:4].astype(np.float32)
    imgs = trender.render_depth_hard_batch(
        torch.from_numpy(labels), 64, n_bisect=12, quantize=True,
        n_sweep=48).numpy()[..., None]
    return {SSL: ssl, C4: (imgs, labels)}


@pytest.fixture(scope="module")
def port_steps(batches):
    """Each layout's step on two spawned ranks: [rank][layout]."""
    plan = []
    for n_data, n_grid, weights, recipe in LAYOUTS.values():
        cfg = TrainConfig(**SMALL, **recipe, n_grid=n_grid, device="cpu")
        # tensors keep their strides through the spawn, so each rank's
        # model sees the memory layout the one-rank tests give it
        batch = tuple(torch.from_numpy(a) for a in batches[weights])
        plan.append((n_grid, dryrun.step_job, {
            "cfg": cfg, "weights": weights, "batch": batch,
            "grads": True}))
    return dryrun.spawn(2, plan)


def _jax_step(weights, recipe, imgs, labels, n_data, n_grid) -> dict:
    cfg = jconfig.TrainConfig(**SMALL, **recipe, n_grid=n_grid,
                              use_pallas=False, donate=False)
    model = flax_build_model("resnet_sq")
    state = jax_create_state(model, jax.random.PRNGKey(0), cfg)
    v = flax_load_weights(weights, {"params": state.params,
                                    "batch_stats": state.batch_stats})
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    mesh = make_mesh(n_data=n_data, n_grid=n_grid)
    state = jax.device_put(state, NamedSharding(mesh, P()))
    ji = jax.device_put(jnp.asarray(imgs), NamedSharding(mesh, P("data")))
    jl = jax.device_put(jnp.asarray(labels), NamedSharding(mesh, P("data")))
    with mesh:
        new_state, loss = jloop.make_train_step(model, cfg, mesh)(state, ji,
                                                                  jl)

        def loss_fn(params):
            out, _ = model.apply({"params": params,
                                  "batch_stats": state.batch_stats}, ji,
                                 train=True, mutable=["batch_stats"])
            return jloop._compute_loss(cfg, flax_params_vector(out), ji, jl,
                                       mesh)

        grads = jax.jit(jax.grad(loss_fn))(state.params)
    return {"loss": float(loss), "grads": _flat_stats({"params": grads}),
            "stats": _flat_stats({"batch_stats": new_state.batch_stats})}


def _flax(arrays: dict) -> dict:
    return flax_from_state_dict({k: torch.from_numpy(v)
                                 for k, v in arrays.items()})


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_step_matches_jax(batches, port_steps, name):
    i = list(LAYOUTS).index(name)
    n_data, n_grid, weights, recipe = LAYOUTS[name]
    want = _jax_step(weights, recipe, *batches[weights], n_data, n_grid)
    ranks = [r[i] for r in port_steps]
    assert len({r["digest"] for r in ranks}) == 1
    got = ranks[0]
    assert got["layout"] == (n_data, n_grid)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    grads = _flax(got["grads"])
    assert set(grads) == set(want["grads"])
    for key, g in want["grads"].items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(grads[key], g, rtol=0, atol=2e-3 * scale,
                                   err_msg=key)
    stats = _flax(got["stats"])
    for key, value in want["stats"].items():
        np.testing.assert_allclose(stats[key], value, rtol=1e-5, atol=1e-8,
                                   err_msg=key)
