"""torchvision-layout encoder weights in and out of the port's ResNetSQ
(``sqtpu_torch/models/torch_port.py``), on the CPU against the JAX
package's ``sqtpu/models/torch_port.py``.

Both directions are held key for key and to the bit: the export of c4's
encoder, a torchvision state_dict with an RGB conv1 and an ``fc`` loaded
into each package, the export -> load round trip, ``.npz`` and ``.pt``
files. The trainer's ``pretrained`` option: one float32 step from the
loaded encoder against the JAX package's float64 step, with
``test_torch_port_keras_train.py``'s bounds.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sqtpu.models import build_model as flax_build_model
from sqtpu.models import torch_port as jport
from sqtpu.training import loop as jloop
from sqtpu.utils import config as jconfig
from sqtpu.utils.checkpoint import load_weights_npz as flax_load_weights
from sqtpu_torch.models import (
    ResNetSQ, build_model, export_torchvision_resnet18,
    load_state_dict_file, load_torchvision_resnet18,
)
from sqtpu_torch.training.loop import train
from sqtpu_torch.utils.checkpoint import flax_from_state_dict, load_weights_npz
from sqtpu_torch.utils.config import TrainConfig

from test_torch_port_keras_train import step_vs_jax
from test_torch_port_ops import _few_torch_threads  # noqa: F401
from test_torch_port_weights import _flat_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C4 = os.path.join(ROOT, "artifacts", "resnet_sq_c4_fp16.npz")


def _flax_variables(seed: int = 0):
    model = flax_build_model("resnet_sq")
    state = jloop.create_train_state(
        model, jax.random.PRNGKey(seed),
        jconfig.TrainConfig(image_size=32))
    return {"params": state.params, "batch_stats": state.batch_stats}


@pytest.fixture(scope="module")
def c4_export():
    port = export_torchvision_resnet18(load_weights_npz(C4, ResNetSQ()))
    jax_sd = jport.export_torchvision_resnet18(
        flax_load_weights(C4, _flax_variables()))
    return port, jax_sd


def test_export_matches_jax_key_for_key(c4_export):
    port, jax_sd = c4_export
    assert set(port) == set(jax_sd) and len(port) == 100
    for k, want in jax_sd.items():
        assert port[k].dtype == np.float32 and port[k].shape == want.shape, k
        np.testing.assert_array_equal(port[k], want, err_msg=k)


def _torchvision_sd(seed: int) -> dict:
    """A torchvision resnet18 state_dict made with numpy: c4's export's
    shapes, conv1 with three input channels, an ``fc`` and the
    ``num_batches_tracked`` counters torchvision writes."""
    rng = np.random.default_rng(seed)
    shapes = {k: v.shape for k, v in export_torchvision_resnet18(
        ResNetSQ()).items()}
    sd = {k: rng.normal(size=s).astype(np.float32)
          for k, s in shapes.items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    sd["conv1.weight"] = rng.normal(size=(64, 3, 7, 7)).astype(np.float32)
    sd["fc.weight"] = np.zeros((1000, 512), np.float32)
    sd["fc.bias"] = np.zeros((1000,), np.float32)
    sd["bn1.num_batches_tracked"] = np.array(7)
    return sd


def test_load_matches_jax():
    """An RGB torchvision state_dict: conv1 summed to one channel, ``fc``
    and the counters ignored, every encoder tensor as the JAX package
    loads it; the heads untouched."""
    sd = _torchvision_sd(3)
    want = _flat_stats(jport.load_torchvision_resnet18(_flax_variables(),
                                                       sd))
    model = ResNetSQ()
    heads = {k: v.clone() for k, v in model.state_dict().items()
             if not k.startswith("encoder.")}
    load_torchvision_resnet18(model, sd)
    got = flax_from_state_dict(model.state_dict())
    for k, v in got.items():
        if "/encoder/" in k:
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    np.testing.assert_array_equal(
        model.encoder.conv1.weight.detach().numpy(),
        sd["conv1.weight"].sum(axis=1, keepdims=True))
    for k, v in heads.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_export_load_round_trip_and_files(tmp_path, c4_export):
    """export -> ``.npz`` and ``.pt`` -> load: c4's encoder to the bit."""
    port, _ = c4_export
    npz, pt = str(tmp_path / "enc.npz"), str(tmp_path / "enc.pt")
    np.savez(npz, **port)
    torch.save({k: torch.from_numpy(v) for k, v in port.items()}, pt)
    c4 = load_weights_npz(C4, ResNetSQ()).encoder.state_dict()
    for path in (npz, pt):
        sd = load_state_dict_file(path)
        assert set(sd) == set(port)
        model = load_torchvision_resnet18(ResNetSQ(), sd)
        for k, v in model.encoder.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, c4[k]), (path, k)


def test_missing_key_raises():
    sd = _torchvision_sd(4)
    del sd["layer3.1.bn2.running_var"]
    with pytest.raises(KeyError):
        load_torchvision_resnet18(ResNetSQ(), sd)


def test_pretrained_train_step_matches_jax(c4_export):
    """``supervised_sym`` from c4's encoder loaded by each package's own
    loader into its seeded model (runs/queue.sh:33-40)."""
    from sqtpu_torch.data import synthetic as tsyn

    port_sd, jax_sd = c4_export

    def pretrained(variables, port):
        load_torchvision_resnet18(port, port_sd)
        return jport.load_torchvision_resnet18(variables, jax_sd)

    imgs, labels = tsyn.make_batch(torch.Generator().manual_seed(16), 4, 64)
    step_vs_jax("resnet_sq", imgs.numpy(), labels.numpy(), 17,
                init=pretrained, loss="supervised_sym")


def test_trainer_loads_the_pretrained_encoder(tmp_path, c4_export):
    """``train(cfg)`` with ``pretrained``: at 0 epochs the encoder is c4's
    to the bit and the rest is the seed's init."""
    path = str(tmp_path / "enc.npz")
    np.savez(path, **c4_export[0])
    cfg = TrainConfig(batch_size=2, image_size=32, max_epochs=0,
                      loss="supervised_sym", pretrained=path,
                      ckpt_dir=str(tmp_path / "run"), device="cpu")
    state, _ = train(cfg)
    c4 = load_weights_npz(C4, ResNetSQ()).encoder.state_dict()
    for k, v in state.model.encoder.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, c4[k]), k
    torch.manual_seed(0)
    fresh = build_model("resnet_sq")
    assert torch.equal(state.model.fc1.weight, fresh.fc1.weight)
