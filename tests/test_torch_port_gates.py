"""The multi-rank gates of ``sqtpu_torch.parallel.dryrun`` catch the faults
they are there for: two deliberately broken copies of the data-parallel
and grid-sharded step, run on two gloo ranks on the CPU, each fail the
committed gate. And the BatchNorm of a data group equals torch's own in
float64, so what parts a one-rank run from a data-parallel one is rounding.

* BatchNorm statistics per rank (no sums over the data group) fail the
  20-step convergence gate (loss and validation IoU within 1e-2, BatchNorm
  statistics within 0.05 of their scale) against one rank.
* A grid-sharded step whose ranks do not sum the params' cotangent over
  the grid group fails the one-step gate (gradient norm within 1e-3
  relative) against one rank.

* One train-mode step of ResNetSQ in float64, with its BatchNorm layers
  through the data group's code path (a group of one rank), equals the
  same step through ``F.batch_norm``: loss and every gradient within
  1e-10 relative, running statistics within 1e-12.

The jobs live in this module, which imports only torch, numpy,
pytest and the port: a spawned rank imports its job's module, and the
suite's ``conftest.py`` and the parity test modules import JAX.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sqtpu_torch.models import build_model, params_vector
from sqtpu_torch.models.resnet import use_global_batch_stats
from sqtpu_torch.parallel import dryrun, sharded_losses


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two torch threads in this worker (see test_torch_port_ops.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def per_rank_batch_norm_job(layout, spec):
    """``dryrun.converge_job`` with each rank's BatchNorm normalizing by
    its own rows' statistics."""
    dryrun.use_global_batch_stats = lambda model, group: None
    return dryrun.converge_job(layout, spec)


def no_grid_sum_job(layout, spec):
    """``dryrun.step_job`` with the grid-sharded loss's params cotangent
    left unsummed over the grid group: each rank's model backward sees its
    own slab's part only."""
    sharded_losses.sum_grad = lambda x, group: x
    return dryrun.step_job(layout, spec)


def test_per_rank_batch_norm_fails_the_convergence_gate():
    dev = torch.device("cpu")
    conv = dryrun.convergence_plan(2, dev)
    ranks = [r[0] for r in dryrun.spawn(2, [(1, per_rank_batch_norm_job,
                                             conv)])]
    one = dryrun.spawn(1, [(1, dryrun.converge_job, conv)])[0][0]
    with pytest.raises(AssertionError, match="diverged"):
        dryrun.check_convergence(ranks, one)


def test_unsummed_grid_gradient_fails_the_step_gate():
    dev = torch.device("cpu")
    n_grid, spec = dryrun._layout_spec("grid-sharded", 2, dev)
    assert n_grid == 2
    ranks = [r[0] for r in dryrun.spawn(2, [(n_grid, no_grid_sum_job,
                                             spec)])]
    one = dryrun.spawn(1, [(1, dryrun.step_job, spec)])[0][0]
    with pytest.raises(AssertionError, match="grad-norm parity broke"):
        dryrun.check_step_parity("grid-sharded", ranks, one)


def batch_norm_paths_job(layout, spec):
    """One float64 train-mode forward and backward of ResNetSQ from seed 0
    on a seeded batch, with BatchNorm through ``F.batch_norm`` (no group)
    and through the data group's path over this one-rank world: the loss,
    the gradients and the running statistics of each."""
    out = {}
    for name, group in (("torch", None), ("group", dist.group.WORLD)):
        torch.manual_seed(0)
        model = build_model("resnet_sq").double().train()
        use_global_batch_stats(model, group)
        x = torch.rand((4, 64, 64, 1), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(1))
        pred = params_vector(model(x))
        loss = torch.sum(pred * torch.linspace(-1.0, 1.0, pred.numel(),
                                               dtype=torch.float64)
                         .view_as(pred))
        loss.backward()
        out[name] = {"loss": float(loss),
                     "grads": {n: p.grad.numpy()
                               for n, p in model.named_parameters()},
                     "stats": {n: b.detach().numpy()
                               for n, b in model.named_buffers()
                               if b.is_floating_point()}}
    return out


def test_data_group_batch_norm_equals_torch_in_float64():
    out = dryrun.spawn(1, [(1, batch_norm_paths_job, {})])[0][0]
    want, got = out["torch"], out["group"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-10)
    for n, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=1e-10,
                                   atol=1e-10 * np.abs(g).max(), err_msg=n)
    for n, b in want["stats"].items():
        np.testing.assert_allclose(got["stats"][n], b, rtol=1e-12,
                                   atol=1e-12, err_msg=n)
