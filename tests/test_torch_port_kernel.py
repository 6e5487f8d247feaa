"""The hard-render kernel's wrapper, build and dispatch.

On the CPU the wrapper takes the plain version; the tests here hold its
checks, its packing of the frame scalars (against the JAX wrapper's
packing, fp32 rtol 1e-6: the same arithmetic in the same type), and the
build helper. The kernel itself is tested on the card by
tests/test_torch_port_gpu.py, which imports no JAX.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqtpu.ops import geometry as jgeom
from sqtpu.ops import quaternion as jquat
from sqtpu_torch.ops import render as trender
from sqtpu_torch.ops.kernels import _build, hardrender, launch_counts
from sqtpu_torch.ops.kernels import render_hard_auto

from test_torch_port_ops import _few_torch_threads, random_params  # noqa: F401


def test_cpu_tensor_goes_to_plain_version():
    p = torch.from_numpy(random_params(20, 3, np.float32))
    before = launch_counts()["K3"]
    got = render_hard_auto(p, 32, n_sweep=48, n_bisect=12, quantize=True)
    want = trender.render_depth_hard_batch(p, 32, n_bisect=12,
                                           quantize=True, n_sweep=48)
    assert torch.equal(got, want)
    assert launch_counts()["K3"] == before  # no kernel launch on the CPU


@pytest.mark.parametrize("bad", ["1d", "width", "int", "size", "sweep",
                                 "bisect"])
def test_wrapper_rejects_bad_input(bad):
    p = torch.from_numpy(random_params(21, 2, np.float32))
    kw = {"image_size": 32, "n_sweep": 48, "n_bisect": 12}
    if bad == "1d":
        p = p[0]
    elif bad == "width":
        p = p[:, :11]
    elif bad == "int":
        p = p.to(torch.int32)
    elif bad == "size":
        kw["image_size"] = 1
    elif bad == "sweep":
        kw["n_sweep"] = 1
    else:
        kw["n_bisect"] = -1
    with pytest.raises((ValueError, TypeError)):
        hardrender.render_depth_hard_cuda(p, **kw)


def test_pack_frames_matches_jax_packing():
    """The layout the kernel reads, against the JAX wrapper's packing
    (sqtpu/ops/kernels/hardrender.py:145-162) recomputed with the JAX
    package's own functions."""
    p = random_params(22, 5, np.float32)
    n_sweep = 64
    a, e, t, q = jgeom.split_params(jnp.asarray(p))
    rot = jquat.to_matrix(jquat.conjugate(q))
    tr = jnp.einsum("bij,bj->bi", rot, t)
    _, z_hi, step = jgeom.z_support_window(a, rot, t, n_sweep, jnp.float32)
    want = np.concatenate([
        np.asarray(a), np.asarray(1.0 / e[:, 1:2]),
        np.asarray(e[:, 1:2] / e[:, 0:1]), np.asarray(1.0 / e[:, 0:1]),
        np.asarray(tr), np.asarray(rot).reshape(5, 9),
        np.asarray(z_hi)[:, None], np.asarray(step)[:, None],
        np.zeros((5, 4), np.float32)], axis=-1)
    got = hardrender.pack_frames(torch.from_numpy(p), n_sweep)
    assert got.shape == (5, hardrender.PAR_STRIDE)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_library_path_follows_the_source(tmp_path, monkeypatch):
    path = _build.library_path("hardrender")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert path == _build.library_path("hardrender")  # stable
    fake = tmp_path / "csrc"
    fake.mkdir()
    src = open(os.path.join(_build.CSRC_DIR, "hardrender.cu")).read()
    (fake / "hardrender.cu").write_text(src + "\n// edited\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(fake))
    assert _build.library_path("hardrender") != path


def test_nvcc_missing_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_source_is_plain_c_for_sm90a():
    src = open(os.path.join(_build.CSRC_DIR, "hardrender.cu")).read()
    assert 'extern "C"' in src and "int sqtpu_hardrender(" in src
    assert "torch/extension.h" not in src
    assert "sqtpu/ops/kernels/hardrender.py::_kernel" in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
