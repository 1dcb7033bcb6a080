"""Device milliseconds per training step of the attention kernels that
``scaled_dot_product_attention`` runs on the pinned backend (flash
attention's forward and backward kernels, or cuDNN's fused attention).
None where the stretch ran none."""
ATTENTION = ("flash", "fmha", "sdpa")


def read(m):
    if not m.trace.count(*ATTENTION):
        return None
    return m.trace.device_s(*ATTENTION) / m.trace.units * 1e3
