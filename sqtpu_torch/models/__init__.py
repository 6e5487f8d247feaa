"""PyTorch regressors of the port (counterpart of ``sqtpu/models``)."""

import functools

from sqtpu_torch.models.encoders import ConvEncoder, MLPNeck  # noqa: F401
from sqtpu_torch.models.heads import (  # noqa: F401
    BlockHead, PositionHead, Rotation6DHead, RotationHead, ShapeHead,
    SizeHead,
)
from sqtpu_torch.models.nets import (  # noqa: F401
    GenericNetSQ, KerasIsoNet, KerasRotNet, KerasRotNetFixed,
)
from sqtpu_torch.models.refiner import (  # noqa: F401
    IterativeSQ, RefineBlock, apply_delta, warm_start_base,
)
from sqtpu_torch.models.resnet import (  # noqa: F401
    BasicBlock, ResNet18, ResNetSQ, params_vector,
)
from sqtpu_torch.models.torch_port import (  # noqa: F401
    export_torchvision_resnet18, load_state_dict_file,
    load_torchvision_resnet18,
)

MODEL_REGISTRY = {
    "resnet_sq": ResNetSQ,
    # continuous 6D rotation representation head (Zhou et al. CVPR 2019)
    "resnet_sq6d": functools.partial(ResNetSQ, rot6d=True),
    "refine_sq": IterativeSQ,
    "generic_sq": GenericNetSQ,
    "keras_iso": KerasIsoNet,
    "keras_rot": KerasRotNet,
    "keras_rot_fixed": KerasRotNetFixed,
}

# parameter-vector width each model family regresses
OUTPUT_DIMS = {"resnet_sq": 12, "resnet_sq6d": 12, "refine_sq": 12,
               "generic_sq": 4, "keras_iso": 8, "keras_rot": 12,
               "keras_rot_fixed": 12}

# The models that flatten the encoder's map into a dense layer, whose
# width the input image's size sets.
SIZED_BY_IMAGE = ("generic_sq", "keras_iso", "keras_rot", "keras_rot_fixed")


def build_model(name: str, image_size: int = 256, **kwargs):
    """The model registered as ``name``, for ``image_size``² inputs (the
    width of the flattening models' dense layer; the others take any
    size). A name outside the registry raises ``KeyError``, as the JAX
    package's lookup does (``classical`` is an evaluation mode, not a
    model)."""
    if name in SIZED_BY_IMAGE:
        kwargs["image_size"] = image_size
    return MODEL_REGISTRY[name](**kwargs)
