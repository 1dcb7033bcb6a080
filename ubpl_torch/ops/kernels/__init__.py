"""Hand-written GPU kernels of the port, one module each (counterpart of
``ubpl_tpu/ops/pallas``).

Every kernel module exposes ``NAME``, ``SOURCE``, ``REPLACES`` (the TPU
kernel it replaces, as file:line, or "none: ..." with what it stands for)
and an integer ``launches`` that its wrapper increments once per kernel
launch.  ``KERNELS`` lists them all.
"""
from . import batch_norm_relu, heatmap_synth

KERNELS = (heatmap_synth, batch_norm_relu)

__all__ = ["KERNELS", "batch_norm_relu", "heatmap_synth"]
