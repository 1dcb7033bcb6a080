"""PyTorch/CUDA port of ``ubpl_tpu`` (semi-supervised 2D pose estimation).

The JAX package ``ubpl_tpu`` is the reference; this package runs the same
math with PyTorch on an NVIDIA GPU.  It imports neither ``jax`` nor
``ubpl_tpu``: host code it needs is kept here as its own copy.

Ported so far: the CLI (``python -m ubpl_torch <regime>``), the five pose
regimes (``train.{supervised,mean_teacher,mt_ubpl,dualpose_ubpl}``) on the
reference's on-disk datasets (``data``) and the ``exec`` sweep, serving
(``infer.PoseEstimator``), with the Gaussian heatmap synthesis kernel of
``ubpl_tpu/ops/pallas/heatmap_kernel.py`` rewritten in Triton
(``ops/kernels/heatmap_synth.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``device.resolve_device``).
"""
from .config import Config
from .device import resolve_device

__all__ = ["Config", "resolve_device"]
