"""The benchmark's frozen yardsticks on the CPU: the model's operation
count against a count written out layer by layer, and the frozen work
counts and constants against the port's ``bounds.py`` and emulations as
they stand."""

from __future__ import annotations

import pytest
import torch

from perfbench.counts import bounds, work


@pytest.fixture(autouse=True, scope="module")
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_resnet_sq_flops_layer_by_layer():
    """ResNet-18 on 256² grayscale: the 7x7/2 stem to 128², the 3x3/2 pool
    to 64², then stages at 64², 32², 16², 8²."""
    macs = 128 * 128 * 64 * 1 * 49                          # stem
    macs += 4 * (64 * 64 * 64 * 64 * 9)                     # layer1
    for side, cin, cout in ((32, 64, 128), (16, 128, 256), (8, 256, 512)):
        macs += side * side * cout * cin * 9                # conv1, stride 2
        macs += 3 * (side * side * cout * cout * 9)         # the other three
        macs += side * side * cout * cin                    # 1x1 projection
    macs += 512 * 256 + 256 * 256 + 256 * 12                # fc1, fc2, heads
    stem = 128 * 128 * 64 * 49
    assert sum(m for _, m in bounds.resnet_sq_layers(256)) == macs
    assert bounds.resnet_sq_train_flops(256) == 2.0 * (3 * macs - stem)
    assert 13.4e9 < bounds.resnet_sq_train_flops(256) < 13.6e9


def test_peaks_and_constants_match_the_ports_bounds():
    from sqtpu_torch.ops.kernels import bounds as port

    assert bounds.PEAK_FP32_OPS == port.PEAK_FP32_OPS
    assert bounds.PEAK_BYTES == port.PEAK_BYTES
    assert bounds.OPS_PER_TEST == port.OPS_PER_TEST
    assert bounds.OPS_K1_CULLED == port.OPS_K1_CULLED
    assert bounds.OPS_K2_CULLED == port.OPS_K2_CULLED
    assert bounds.OPS_K4_CULLED == port.OPS_K4_CULLED
    assert bounds.PEAKS == {"bfloat16": 989e12, "float32": 67e12}


def _shapes(seed: int, b: int = 6):
    from sqtpu_torch.data.synthetic import sample_params

    gen = torch.Generator()
    gen.manual_seed(seed)
    true_p = sample_params(b, gen)
    pred = (true_p + 0.03 * torch.randn(true_p.shape, generator=gen))
    return true_p, pred


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1k2_points_match_the_port(seed):
    from sqtpu_torch.ops.kernels import implicit as K

    _, pred = _shapes(seed)
    n = 32
    want = K.cull_points(K.pack_params(pred, n), n, n, 1.5, 260.0)
    assert work.k1k2_points(pred, n, 1.5, 260.0) == want
    assert work.implicit_pack(pred, n).equal(K.pack_params(pred, n))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sharp", [5.0, 20.0])
def test_k4_points_match_the_port(seed, sharp):
    from sqtpu_torch.ops.kernels import explicit as KE

    true_p, pred = _shapes(seed)
    n = 32
    par_t, par_p = KE.pack_params(true_p, pred, n, True,
                                  KE.default_margin(sharp))
    assert work.k4_points(true_p, pred, n, sharp) == KE.cull_points(
        par_t, par_p, n, sharp)


@pytest.mark.parametrize("seed", [0, 1])
def test_k3_tests_match_the_port(seed):
    from sqtpu_torch.ops.kernels import hardrender as H

    true_p, _ = _shapes(seed, b=3)
    s, n_sweep, n_bisect = 48, 24, 6
    _, tests = H.emulate_hardrender(H.pack_frames(true_p, n_sweep), s,
                                    n_sweep, n_bisect)
    assert work.k3_tests(true_p, s, n_sweep, n_bisect) == int(tests.sum())


def test_bounds_are_positive_and_grow_with_the_work():
    true_p, pred = _shapes(3)
    small = bounds.k4_bound_ms(true_p[:2], pred[:2], 16, 20.0)
    assert 0 < small < bounds.k4_bound_ms(true_p, pred, 16, 20.0)
    assert bounds.k1k2_bound_ms(pred, 16, 1.5, 260.0) > 0
    assert bounds.k3_bound_ms(true_p, 32, 16, 6) > 0
