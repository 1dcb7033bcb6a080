"""Model factory (port of ``ubpl_tpu/models/factory.py``; reference
models/pose/pose_model.py).  "HG{n}" -> ``StackedHourglass(n_stack=n)``;
LitePose and the classification models are not ported yet."""
from .hourglass import StackedHourglass


def create_pose_model(model_type: str, kps_count: int, mode: str = "AvgPool"):
    if model_type.startswith("HG"):
        return StackedHourglass(k=kps_count, n_stack=int(model_type[2:]),
                                mode=mode)
    raise ValueError(f"pose model {model_type!r} is not ported "
                     "(supported: HG{n})")


def param_count(model) -> int:
    return sum(p.numel() for p in model.parameters())
