"""Model factories (port of ``ubpl_tpu/models/factory.py``; reference
models/pose/pose_model.py, models/classification/class_model.py).

Pose: "HG{n}" -> ``StackedHourglass(n_stack=n)``, "LitePose" ->
``LitePose``, "ViTPose-B" / "-L" / "-H" -> ``ViTPose`` at its published
size for 256 x 256 inputs (or "ViTPose-<depth>x<width>x<heads>", a test
size for 64 x 64; port-only, no JAX counterpart).  Classification:
"VGG*" / "ResNet*" / "MobileNet", the bare family names meaning VGG11 and
ResNet18.
"""
import torch

from .classification import VGG, MobileNet, ResNet
from .hourglass import StackedHourglass
from .litepose import LitePose
from .vitpose import ViTPose, parse_name


def create_pose_model(model_type: str, kps_count: int, mode: str = "AvgPool",
                      device=None):
    """A pose network by name.  ``device``: where a ViTPose is built and
    drawn (the hourglass and LitePose draw on the CPU, in the JAX package's
    order; the caller moves them)."""
    if model_type.startswith("HG"):
        return StackedHourglass(k=kps_count, n_stack=int(model_type[2:]),
                                mode=mode)
    if model_type == "LitePose":
        return LitePose(k=kps_count, mode=mode)
    vit = parse_name(model_type)
    if vit is not None:
        width, depth, heads, drop_path_rate, res = vit
        with torch.device(device or "cpu"):
            return ViTPose(kps_count, depth, width, heads, mode,
                           drop_path_rate, res)
    raise ValueError(f"unknown pose model {model_type!r} (HG{{n}} | LitePose "
                     "| ViTPose-B | ViTPose-L | ViTPose-H)")


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
