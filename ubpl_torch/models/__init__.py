"""Pose models of the port (counterpart of ``ubpl_tpu/models``)."""
from .factory import create_pose_model, param_count
from .hourglass import StackedHourglass

__all__ = ["create_pose_model", "param_count", "StackedHourglass"]
