"""PyTorch regressors of the port (counterpart of ``sqtpu/models``)."""

from sqtpu_torch.models.heads import (  # noqa: F401
    PositionHead, RotationHead, ShapeHead, SizeHead,
)
from sqtpu_torch.models.resnet import (  # noqa: F401
    BasicBlock, ResNet18, ResNetSQ, params_vector,
)

MODEL_REGISTRY = {"resnet_sq": ResNetSQ}

# The JAX package's other models, and the ROADMAP.md slice that ports each.
_LATER = {
    "resnet_sq6d": "Slice F (Rotation6DHead)",
    "refine_sq": "Slice D (models/refiner.py)",
    "generic_sq": "Slice F (models/nets.py)",
    "keras_iso": "Slice F (models/nets.py)",
    "keras_rot": "Slice F (models/nets.py)",
    "keras_rot_fixed": "Slice F (models/nets.py)",
    "classical": "Slice D (fit.py)",
}


def build_model(name: str, **kwargs):
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name](**kwargs)
    if name in _LATER:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP.md {_LATER[name]}")
    raise ValueError(f"unknown model {name!r}")
