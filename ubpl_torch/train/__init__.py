"""Training regimes of the port (counterpart of ``ubpl_tpu/train``).
Ported so far: supervised."""
