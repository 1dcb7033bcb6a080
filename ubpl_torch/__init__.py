"""PyTorch/CUDA port of ``ubpl_tpu`` (semi-supervised 2D pose estimation).

The JAX package ``ubpl_tpu`` is the reference; this package runs the same
math with PyTorch on an NVIDIA GPU.  It imports neither ``jax`` nor
``ubpl_tpu``: host code it needs is kept here as its own copy.

Ported so far: serving (``infer.PoseEstimator``) and the supervised
training step (``train.supervised``), with the Gaussian heatmap synthesis
kernel of ``ubpl_tpu/ops/pallas/heatmap_kernel.py`` rewritten in Triton
(``ops/kernels/heatmap_synth.py``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``device.resolve_device``).
"""
from .config import Config
from .device import resolve_device

__all__ = ["Config", "resolve_device"]
