"""The port's geometry of posed views and points, and the least-squares
loss, against the JAX package on the CPU in float64.

Seeded numpy inputs go through both packages: ``rotate``,
``field_points``, ``signed_distance``, ``radial_distance``,
``transform_params`` and ``camera_frame_params`` within rtol 1e-12 (the
same closed forms, summed in another order); ``intersect_ray`` and
``render_depth_view`` within the JAX tests' atol 2e-3
(tests/test_multiview.py:44, 115: the bisection's resolution), and
``render_depth_view`` at the identity camera equal to the port's
``render_depth_hard`` to the bit; ``least_squares_loss`` value and
gradient within rtol 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.ops import geometry as jgeo
from sqtpu.ops import losses as jlosses
from sqtpu.ops import quaternion as jquat
from sqtpu.ops import render as jrender
from sqtpu_torch.ops import geometry as tgeo
from sqtpu_torch.ops import losses as tlosses
from sqtpu_torch.ops import quaternion as tquat
from sqtpu_torch.ops import render as trender

from test_torch_port_ops import _few_torch_threads  # noqa: F401

RTOL = 1e-12


def _params(rng, b: int) -> np.ndarray:
    q = rng.normal(size=(b, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.concatenate([rng.uniform(0.12, 0.3, (b, 3)),
                           rng.uniform(0.2, 1.0, (b, 2)),
                           rng.uniform(0.35, 0.65, (b, 3)), q], axis=-1)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(12)
    return {"p": _params(rng, 4), "pts": rng.uniform(0.0, 1.0, (4, 50, 3)),
            "q2": _params(rng, 4)[:, 8:12], "t2": rng.normal(size=(4, 3))}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_rotate_matches_jax(inputs):
    want = jquat.rotate(jnp.asarray(inputs["pts"]),
                        jnp.asarray(inputs["p"][:, None, 8:12]))
    got = tquat.rotate(_t(inputs["pts"]), _t(inputs["p"][:, None, 8:12]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-15)


@pytest.mark.parametrize("fn", ["field_points", "signed_distance",
                                "radial_distance"])
def test_point_functions_match_jax(inputs, fn):
    want = jax.vmap(getattr(jgeo, fn))(jnp.asarray(inputs["pts"]),
                                       jnp.asarray(inputs["p"]))
    got = getattr(tgeo, fn)(_t(inputs["pts"]), _t(inputs["p"]))
    assert got.shape == (4, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    one = getattr(tgeo, fn)(_t(inputs["pts"][0]), _t(inputs["p"][0]))
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


def test_field_points_is_the_grid_field(inputs):
    """At the lattice's points, field_points is field_grid's field."""
    ax = tgeo.make_axis(6, "implicit", dtype=torch.float64)
    X, Y, Z = torch.meshgrid(ax, ax, ax, indexing="ij")
    pts = torch.stack([X, Y, Z], -1).reshape(-1, 3)
    p = _t(inputs["p"][1])
    np.testing.assert_allclose(
        tgeo.field_points(pts, p).numpy(),
        tgeo.field_grid(ax, ax, ax, p).reshape(-1).numpy(), rtol=RTOL)


def test_transform_and_camera_frame_match_jax(inputs):
    p, q2, t2 = inputs["p"], inputs["q2"], inputs["t2"]
    want = jax.vmap(jgeo.transform_params)(jnp.asarray(p), jnp.asarray(q2),
                                           jnp.asarray(t2))
    got = tgeo.transform_params(_t(p), _t(q2), _t(t2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-15)
    want = jax.vmap(jrender.camera_frame_params)(jnp.asarray(p),
                                                 jnp.asarray(q2))
    got = trender.camera_frame_params(_t(p), _t(q2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-15)
    # one superquadric seen by several cameras broadcasts
    views = trender.camera_frame_params(_t(p[0]), _t(q2))
    np.testing.assert_array_equal(views.numpy(),
                                  trender.camera_frame_params(
                                      _t(np.repeat(p[:1], 4, 0)),
                                      _t(q2)).numpy())


def test_intersect_ray_matches_jax(inputs):
    p = inputs["p"][0]
    rng = np.random.default_rng(3)
    origins = rng.uniform(0.0, 1.0, (64, 3))
    dirs = p[5:8] - origins + 0.1 * rng.normal(size=(64, 3))
    want_t, want_hit = jax.vmap(lambda o, d: jrender.intersect_ray(
        o, d, jnp.asarray(p)))(jnp.asarray(origins), jnp.asarray(dirs))
    got_t, got_hit = trender.intersect_ray(_t(origins), _t(dirs), _t(p))
    np.testing.assert_array_equal(got_hit.numpy(), np.asarray(want_hit))
    assert got_hit.sum() > 30
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=2e-3)


def test_intersect_ray_reproduces_the_render(inputs):
    """−z rays through the pixel lattice give the hard renderer's map
    (tests/test_multiview.py:29-44 on the port)."""
    p, s = _t(inputs["p"][2]), 48
    ax = torch.arange(s, dtype=torch.float64) / (s - 1)
    X, Y = torch.meshgrid(ax, ax, indexing="ij")
    origins = torch.stack([X, Y, torch.ones_like(X)], -1).reshape(-1, 3)
    t_hit, hit = trender.intersect_ray(
        origins, torch.tensor([0.0, 0.0, -1.0], dtype=torch.float64), p)
    z = torch.where(hit, 1.0 - t_hit, torch.zeros_like(t_hit))
    img = torch.flip(z.reshape(s, s).T, dims=(0,))
    depth = trender.render_depth_hard(p, s)
    assert (depth > 0).sum() > 100
    np.testing.assert_allclose(img.numpy(), depth.numpy(), atol=2e-3)


def test_render_depth_view_matches_jax(inputs):
    p = inputs["p"][3]
    cams = np.concatenate([[[0.0, 0.0, 0.0, 1.0]], inputs["q2"][:2]])
    want = np.stack([np.asarray(jrender.render_depth_view(
        jnp.asarray(p), jnp.asarray(c), 48)) for c in cams])
    got = trender.render_depth_view(_t(p), _t(cams), 48)
    assert got.shape == (3, 48, 48) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    assert [int((v > 0).sum()) for v in got] != [0, 0, 0]
    # the identity camera is the plain render, to the bit
    np.testing.assert_array_equal(
        got[0].numpy(), trender.render_depth_hard(_t(p), 48).numpy())
    # a sphere at the scene center looks the same from every camera
    sphere = torch.tensor([0.2, 0.2, 0.2, 1.0, 1.0, 0.5, 0.5, 0.5,
                           0.0, 0.0, 0.0, 1.0], dtype=torch.float64)
    views = trender.render_depth_view(sphere, _t(cams), 48)
    np.testing.assert_allclose(views[1:].numpy(),
                               views[:1].expand(2, 48, 48).numpy(),
                               atol=2e-3)


def test_least_squares_loss_matches_jax():
    rng = np.random.default_rng(5)
    img = rng.uniform(0.2, 0.8, (3, 64, 64)) * (rng.random((3, 64, 64)) > 0.4)
    p = _params(rng, 3)

    def jloss(q):
        return jlosses.least_squares_loss(jnp.asarray(img), q, 32)
    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(p))
    pt = _t(p).requires_grad_(True)
    got = tlosses.least_squares_loss(_t(img), pt, 32)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-10)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-10, atol=1e-12 * float(
                                   np.abs(want_g).max()))
    per = tlosses.least_squares_loss(_t(img)[:, None], _t(p), 32,
                                     reduce=False)
    np.testing.assert_allclose(per.numpy(), np.asarray(
        jlosses.least_squares_loss(jnp.asarray(img), jnp.asarray(p), 32,
                                   reduce=False)), rtol=1e-10)
