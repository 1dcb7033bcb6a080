"""Tensor ops of the port (counterpart of ``ubpl_tpu/ops``)."""
