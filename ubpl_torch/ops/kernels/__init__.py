"""Hand-written GPU kernels of the port, one module each (counterpart of
``ubpl_tpu/ops/pallas``).

Every kernel module exposes ``NAME``, ``SOURCE``, ``REPLACES`` (the TPU
kernel it replaces, as file:line) and an integer ``launches`` that its
wrapper increments once per kernel launch.  ``KERNELS`` lists them all.
"""
from . import heatmap_synth

KERNELS = (heatmap_synth,)

__all__ = ["KERNELS", "heatmap_synth"]
