"""PyTorch regressors of the port (counterpart of ``sqtpu/models``)."""

from sqtpu_torch.models.heads import (  # noqa: F401
    PositionHead, RotationHead, ShapeHead, SizeHead,
)
from sqtpu_torch.models.refiner import (  # noqa: F401
    IterativeSQ, RefineBlock, apply_delta, warm_start_base,
)
from sqtpu_torch.models.resnet import (  # noqa: F401
    BasicBlock, ResNet18, ResNetSQ, params_vector,
)

MODEL_REGISTRY = {"resnet_sq": ResNetSQ, "refine_sq": IterativeSQ}

# parameter-vector width each model family regresses
OUTPUT_DIMS = {"resnet_sq": 12, "refine_sq": 12}

# The JAX package's other models, and the ROADMAP.md slice that ports each.
_LATER = {
    "resnet_sq6d": "Slice F (Rotation6DHead)",
    "generic_sq": "Slice F (models/nets.py)",
    "keras_iso": "Slice F (models/nets.py)",
    "keras_rot": "Slice F (models/nets.py)",
    "keras_rot_fixed": "Slice F (models/nets.py)",
}


def build_model(name: str, **kwargs):
    """The model registered as ``name``; a name outside the registry
    raises ``KeyError``, as the JAX package's lookup does (``classical``
    is an evaluation mode, not a model)."""
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name](**kwargs)
    if name in _LATER:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP.md {_LATER[name]}")
    raise KeyError(name)
