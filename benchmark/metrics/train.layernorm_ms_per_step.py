"""Device milliseconds of LayerNorm kernels per training step: ATen's
forward (``vectorized_layer_norm_kernel``), input gradient
(``layer_norm_grad_input_kernel``) and gamma / beta gradient
(``GammaBetaBackward``).  None where the stretch ran none."""
LAYERNORM = ("layer_norm", "layernorm", "gammabeta")


def read(m):
    if not m.trace.count(*LAYERNORM):
        return None
    return m.trace.device_s(*LAYERNORM) / m.trace.units * 1e3
