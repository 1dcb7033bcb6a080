"""CIFAR classifiers of the port (counterpart of
``ubpl_tpu/models/classification``): VGG, ResNet and MobileNet, each with
the reference's two heads and the feature tap of the UBPL feature loss."""
from .mobilenet import MobileNet   # noqa: F401
from .resnet import ResNet         # noqa: F401
from .vgg import VGG               # noqa: F401
