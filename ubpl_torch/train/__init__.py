"""Training regimes of the port (counterpart of ``ubpl_tpu/train``).
Ported so far: supervised, MT (mean teacher) and MT_UBPL."""
