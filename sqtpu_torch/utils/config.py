"""Run configurations and the device switch of the port's entry points.

Counterpart of ``sqtpu/utils/config.py:137-176`` and ``parse_cli``, and of
``ServeConfig`` in ``sqtpu/serve.py``. ``device`` replaces the JAX
configs' ``platform``: entry points run on ``cuda`` unless the caller asks
for ``cpu``, and a missing card is an error, never a silent CPU run. The
JAX configs' options that this port does not run yet are kept so that
setting one raises (:func:`check_slice`) instead of being ignored; the
``refine_*`` tuning fields come with the refinement slice.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class EvalConfig:
    ckpt_dir: str = "checkpoints/run0"  # portable .npz weights artifact
    model: str = "resnet_sq"
    iso: bool = False                 # 2019 isometric-view protocol
    n: int = 1000
    batch_size: int = 32
    acc_render_size: int = 128
    seed: int = 0
    image_size: int = 256
    results_file: str = "results.txt"
    save_pairs: int = 0
    out_dir: str = "eval_out"
    device: str = "cuda"              # cuda | cpu
    noise_gaussian: float = 0.0
    noise_dropout: float = 0.0
    noise_salt: float = 0.0
    input_filter: str = "none"        # only "none" is ported
    refine: str = "none"              # only "none" is ported


@dataclass
class ServeConfig:
    ckpt_dir: str = "checkpoints/run0"  # portable .npz weights artifact
    model: str = "resnet_sq"
    socket: str = "/tmp/sqtpu.sock"   # UNIX socket path ("" -> TCP)
    host: str = "127.0.0.1"
    port: int = 7341
    batch_size: int = 64              # max micro-batch
    batch_window_ms: float = 2.0      # wait after the first queued request
    image_size: int = 256
    denormalize: bool = True
    refine: str = "none"              # only "none" is ported
    input_filter: str = "none"        # only "none" is ported
    device: str = "cuda"              # cuda | cpu
    queue_factor: int = 4             # queue bound = factor * batch_size
    send_timeout_s: float = 10.0      # per-connection SO_SNDTIMEO (0 = none)
    path_root: str = ""               # confine 'path' requests (TCP: required)


def check_slice(cfg) -> None:
    """Raise ``NotImplementedError`` for an option this port does not run
    yet, naming the ROADMAP.md slice that ports it."""
    from sqtpu_torch.models import build_model, MODEL_REGISTRY

    if cfg.model not in MODEL_REGISTRY:
        build_model(cfg.model)  # raises, naming the slice
    later = []
    if cfg.refine != "none":
        later.append(f"refine={cfg.refine!r}: Slice D (fit.refine_params)")
    if cfg.input_filter != "none":
        later.append(f"input_filter={cfg.input_filter!r}: "
                     "Slice C2 (ops/image.py)")
    for name in ("noise_gaussian", "noise_dropout", "noise_salt"):
        if getattr(cfg, name, 0.0):
            later.append(f"{name}: Slice C2 (data/augment.py)")
    if getattr(cfg, "iso", False):
        later.append("iso: Slice F (the 2019 isometric models)")
    if getattr(cfg, "save_pairs", 0) > 0:
        later.append("save_pairs > 0: Slice C1 (eval image pairs)")
    if later:
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md): " + "; ".join(later))


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` or ``"cpu"`` -> a torch.device, and set both TF32
    switches off: float32 matrix products and convolutions run in full
    float32, which is what the parity with the JAX package is held to."""
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {name!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch sees no CUDA device; "
            "pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def parse_cli(cls, argv: Optional[list] = None):
    """Build an argparse CLI from a config dataclass."""
    parser = argparse.ArgumentParser(
        description=f"sqtpu_torch {cls.__name__}",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    for f in dataclasses.fields(cls):
        arg = "--" + f.name.replace("_", "-")
        if f.type in ("bool", bool):
            parser.add_argument(arg, type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=f.default,
                                nargs="?", const=True)
        else:
            parser.add_argument(arg, type=type(f.default), default=f.default)
    ns = parser.parse_args(argv)
    return cls(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)})
