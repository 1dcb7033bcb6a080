"""Model factories (port of ``ubpl_tpu/models/factory.py``; reference
models/pose/pose_model.py, models/classification/class_model.py).

Pose: "HG{n}" -> ``StackedHourglass(n_stack=n)``, "LitePose" ->
``LitePose``.  Classification: "VGG*" / "ResNet*" / "MobileNet", the bare
family names meaning VGG11 and ResNet18.
"""
from .classification import VGG, MobileNet, ResNet
from .hourglass import StackedHourglass
from .litepose import LitePose


def create_pose_model(model_type: str, kps_count: int, mode: str = "AvgPool"):
    if model_type.startswith("HG"):
        return StackedHourglass(k=kps_count, n_stack=int(model_type[2:]),
                                mode=mode)
    if model_type == "LitePose":
        return LitePose(k=kps_count, mode=mode)
    raise ValueError(f"unknown pose model {model_type!r}")


def create_class_model(model_type: str, num_classes: int,
                       mode: str = "AvgPool"):
    """A CIFAR classifier: bare family names ("VGG" -> VGG11, "ResNet" ->
    ResNet18) or the reference's variants ("VGG13", "ResNet50", ...)."""
    if model_type.startswith("VGG"):
        variant = model_type if len(model_type) > 3 else "VGG11"
        return VGG(num_classes, variant, mode)
    if model_type.startswith("ResNet"):
        variant = model_type if len(model_type) > 6 else "ResNet18"
        return ResNet(num_classes, variant, mode)
    if model_type == "MobileNet":
        return MobileNet(num_classes, mode)
    raise ValueError(f"unknown classification model {model_type!r}")


def param_count(model) -> int:
    return sum(p.numel() for p in model.parameters())
