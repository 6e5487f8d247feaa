"""The JAX package's bf16-against-fp32 train-step gaps that the card's
bf16 step is held to, recomputed on the CPU with the script that pinned
them (``python tests/torch_port_pins.py bf16_step``): the largest of each
statistic over 16 runs of the step, the weights moved by 2^-18 relative
in all but the first, and the whole gradient's smallest, for phase 29's
step (``chip_smoke.PINNED_BF16_STEP_GAPS``, ``PINNED_BF16_L2_MIN``) and
``test_torch_port_gpu.py::test_bf16_step_on_card``'s
(``JAX_BF16_STEP_GAPS``, ``JAX_BF16_L2_MIN``). Each constant is JAX's
number within 1e-2 relative (the card is held to twice it; XLA's CPU
convolutions may sum in another order on another host), and the port's
own gaps on the CPU lie within the card's bounds.
"""

import os
import sys

import pytest

import test_torch_port_gpu as gpu
import torch_port_pins

from test_torch_port_ops import _few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIN_RTOL = 1e-2


def _pinned(case: str) -> tuple:
    if case == "random":
        return (gpu.JAX_BF16_STEP_GAPS, gpu.JAX_BF16_L2_MIN,
                gpu.BF16_GAP_RATIO)
    sys.path.insert(0, ROOT)
    import chip_smoke

    return (chip_smoke.PINNED_BF16_STEP_GAPS, chip_smoke.PINNED_BF16_L2_MIN,
            chip_smoke.BF16_GAP_RATIO)


@pytest.mark.parametrize("case", ["ssl", "random"])
def test_pinned_bf16_step_gaps(case):
    pinned, l2_min, ratio = _pinned(case)
    got = torch_port_pins.bf16_step_gaps(case)
    assert set(pinned) <= set(got["jax_max"])
    for key, value in pinned.items():
        assert got["jax_max"][key] == pytest.approx(value, rel=PIN_RTOL), key
        assert 0 < got["port_cpu"][key] <= ratio * value, key
    assert min(got["jax_spread"]["grad_rel_l2"]) == pytest.approx(
        l2_min, rel=PIN_RTOL)
    assert got["port_cpu"]["grad_rel_l2"] >= l2_min / 4
