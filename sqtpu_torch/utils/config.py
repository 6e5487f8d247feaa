"""Run configurations and the device switch of the port's entry points.

Counterpart of ``sqtpu/utils/config.py:17-176`` and ``parse_cli``, of
``ServeConfig`` in ``sqtpu/serve.py``, ``PredictConfig`` in
``sqtpu/predict.py`` and ``GenerateConfig`` in ``sqtpu/generate.py``.
``device`` replaces the JAX configs' ``platform``: entry points run on
``cuda`` unless the caller asks for ``cpu``, and a missing card is an
error, never a silent CPU run. Every option of the JAX configs runs.
``FitConfig`` is ``sqtpu/utils/config.py:179-192``'s, for ``python -m
sqtpu_torch.fit``.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig``, field for field and flag for
    flag, plus ``device``. ``platform`` and ``donate`` mean nothing in
    PyTorch: they are accepted and ignored. ``use_pallas`` keeps its name
    for CLI parity and means "use the hand-written kernels" (K1/K2 for the
    implicit loss, K4/K5 for the explicit loss, on the card); off, the
    plain loss runs on any device."""

    # model / loss
    model: str = "resnet_sq"
    loss: str = "implicit"            # see training/loop.py _compute_loss
    aux_weight: float = 0.05
    gauge_weight: float = 1.0
    geo_weight: float = 1.0
    shape_weight: float = 1.0
    elong_weight: float = 0.0
    render_size: int = 64
    tau: float = 1.5
    sigmoid_sharpness: float = 260.0
    explicit_sharp: float = 5.0
    acc_render_size: int = 64         # IoU validation metric grid

    # optimization
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float = 0.0            # global-norm gradient clip, 0 = off
    batch_size: int = 32
    max_epochs: int = 100
    steps_per_epoch: int = 100        # synthetic data is infinite
    val_steps: int = 10
    plateau_patience: int = 25
    plateau_factor: float = 0.1
    seed: int = 0

    # data
    data: str = "synthetic"           # synthetic | online | <BMP dir>
    labels_csv: str = ""              # CSV for directory datasets
    image_size: int = 256
    renderer: str = "hard"            # on-device GT renderer: hard | soft
    train_split: float = 0.9
    shuffle: bool = True
    iso: bool = False
    synthetic_size: int = 0           # resident dataset size (0 = auto)
    data_cache: bool = False          # persist synthetic data under data_cache/
    lr_schedule: str = "plateau"      # plateau | step2019

    # training-time sensor-noise augmentation (data/augment.depth_noise on
    # the model input of train and validation batches, quantized; labels
    # untouched); randomize: per-sample magnitudes U(0, max)
    augment_gaussian: float = 0.0     # object-pixel depth noise std
    augment_dropout: float = 0.0      # object-pixel missing-return prob
    augment_salt: float = 0.0         # background flying-pixel prob
    augment_randomize: bool = False

    # precision / parallelism
    dtype: str = "float32"            # float32 | bfloat16 (flax's dtype)
    remat: bool = False
    n_grid: int = 1
    donate: bool = True               # accepted, ignored (no buffer donation)
    platform: str = ""                # accepted, ignored (see device)

    # warm starts
    pretrained: str = ""
    init_weights: str = ""            # full-model warm start from a .npz
    init_base: str = ""
    freeze_base: bool = False

    # checkpoint / logging
    ckpt_dir: str = "checkpoints/run0"
    continue_training: bool = False
    resume_from: str = "best"         # best | last
    reset_lr: float = 0.0             # >0: override LR after resume
    save_last: bool = True
    save_last_interval: int = 5
    log_interval: int = 10
    compare_images: int = 4           # epoch-0 true/pred BMP pairs
    nan_policy: str = "warn"          # warn | skip
    profile_dir: str = ""             # torch.profiler trace of the run

    # kernels
    use_pallas: bool = True           # the hand-written kernels on the card
    device: str = "cuda"              # cuda | cpu


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
    # the sensor-noise protocol: corrupt the model's input only
    noise_gaussian: float = 0.0       # object-pixel depth noise std
    noise_dropout: float = 0.0        # object-pixel missing-return prob
    noise_salt: float = 0.0           # background flying-pixel prob
    input_filter: str = "none"        # none | despeckle | median
    # test-time refinement of the predictions (fit.refine_params), and
    # the LM of --model classical (refine_steps iterations on
    # refine_size² points)
    refine: str = "none"              # none | lm | gd | lm+gd
    refine_steps: int = 30
    refine_size: int = 64             # LM point grid / GD render size
    refine_lr: float = 3e-3           # GD (Adam) step size
    refine_robust_c: float = 0.0      # IRLS Tukey constant (0 = off)
    refine_filter: str = "none"       # none | despeckle | median
    refine_residual: str = "sb"       # LM residual: sb | radial


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
    refine: str = "none"              # none | lm | gd | lm+gd
    refine_steps: int = 30
    refine_size: int = 64
    refine_lr: float = 3e-3
    refine_robust_c: float = 0.0
    refine_filter: str = "none"
    refine_residual: str = "sb"
    input_filter: str = "none"        # none | despeckle | median
    device: str = "cuda"              # cuda | cpu
    queue_factor: int = 4             # queue bound = factor * batch_size
    send_timeout_s: float = 10.0      # per-connection SO_SNDTIMEO (0 = none)
    path_root: str = ""               # confine 'path' requests (TCP: required)


@dataclass
class PredictConfig:
    """The JAX package's ``PredictConfig`` plus ``device``; ``platform`` is
    accepted and ignored."""
    inputs: str = ""                  # BMP directory or glob pattern
    ckpt_dir: str = "checkpoints/run0"  # portable .npz or a port run dir
    model: str = "resnet_sq"
    out: str = "predictions.csv"
    batch_size: int = 256
    image_size: int = 256
    denormalize: bool = True          # reference units (a, t in 0..255)
    refine: str = "none"              # none | lm | gd | lm+gd
    refine_steps: int = 30
    refine_size: int = 64
    refine_lr: float = 3e-3
    refine_robust_c: float = 0.0
    refine_filter: str = "none"
    refine_residual: str = "sb"
    input_filter: str = "none"        # none | despeckle | median
    platform: str = ""                # accepted, ignored (see device)
    device: str = "cuda"              # cuda | cpu


@dataclass
class GenerateConfig:
    """The JAX package's ``GenerateConfig`` plus ``device``, where the
    parameters are sampled and rendered. ``backend`` picks the renderer, as
    the JAX package's ``tpu | native`` does: ``device`` the hard
    ray-caster on ``device`` (K3 on the card, its plain version on the
    CPU), ``native`` the host C++ scanner; ``platform`` is accepted and
    ignored."""
    n: int = 1000
    out: str = "data/generated"
    iso: bool = False                 # the 2019 isometric view
    image_size: int = 256
    seed: int = 0
    batch_size: int = 128
    backend: str = "device"           # device | native (host C++ OpenMP)
    csv_name: str = "data_labels.csv"
    platform: str = ""                # accepted, ignored (see device)
    device: str = "cuda"              # cuda | cpu


@dataclass
class FitConfig:
    """The JAX package's ``FitConfig`` plus ``device``; ``platform`` is
    accepted and ignored."""
    loss: str = "explicit"            # explicit | implicit | leastsquares
    render_size: int = 32
    learning_rate: float = 1e-3
    steps: int = 2000
    seed: int = 0
    tau: float = 1.5
    sigmoid_sharpness: float = 260.0
    optimizer: str = "sgd"            # sgd (visu.py parity) | adam | lm
    n_views: int = 1                  # > 1 with lm: posed turntable views
    log_interval: int = 100
    platform: str = ""                # accepted, ignored (see device)
    device: str = "cuda"              # cuda | cpu


def check_slice(cfg) -> None:
    """Raise ``KeyError`` for a model name outside the registry
    (``classical`` is an evaluation mode, not a model to train); for a
    training config, raise ``ValueError`` when the ranks cannot be laid
    out (:func:`check_layout`) over the launcher's ``WORLD_SIZE`` (1
    without it)."""
    from sqtpu_torch.models import MODEL_REGISTRY

    if cfg.model not in MODEL_REGISTRY and not (
            cfg.model == "classical" and not isinstance(cfg, TrainConfig)):
        raise KeyError(cfg.model)
    if isinstance(cfg, TrainConfig):
        from sqtpu_torch.parallel.mesh import launcher_world_size

        check_layout(cfg, launcher_world_size())


def check_layout(cfg: TrainConfig, world_size: int) -> None:
    """Raise ``ValueError`` unless ``world_size`` ranks form a ('data',
    'grid') layout with ``cfg.n_grid`` ranks on the grid axis (the JAX
    package's ``make_mesh``): the world a multiple of ``n_grid``, the
    render size a multiple of ``n_grid`` (each rank sweeps as many
    columns, ``sharded_losses.py:154``) and the batch a multiple of the
    data axis (equal rows per rank)."""
    if cfg.n_grid < 1 or world_size % cfg.n_grid:
        raise ValueError(f"world size {world_size} is not a multiple of "
                         f"n_grid={cfg.n_grid}")
    if cfg.render_size % cfg.n_grid:
        raise ValueError(f"render_size {cfg.render_size} must divide the "
                         f"grid axis n_grid={cfg.n_grid}")
    n_data = world_size // cfg.n_grid
    if cfg.batch_size % n_data:
        raise ValueError(f"batch_size {cfg.batch_size} must divide the "
                         f"data axis of {n_data} ranks")


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


# TrainConfig.dtype -> the models' compute dtype (None: float32 throughout)
MODEL_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
