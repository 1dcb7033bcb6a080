"""Models of the port (counterpart of ``ubpl_tpu/models``): the stacked
hourglass, LitePose, ViTPose (port-only), the CIFAR classifiers and their
factories, the weight carriers and the init strategies."""
from .factory import create_class_model, create_pose_model, param_count
from .hourglass import StackedHourglass

__all__ = ["create_class_model", "create_pose_model", "param_count",
           "StackedHourglass"]
