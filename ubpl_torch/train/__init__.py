"""Training regimes of the port (counterpart of ``ubpl_tpu/train``):
supervised, MT (mean teacher), MT_UBPL, DualPose(_UBPL), and the ``exec``
sweep over them."""
