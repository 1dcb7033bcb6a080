"""Parameter (re)initialisation strategies.

Port of ``ubpl_tpu/models/init_strategies.py`` (reference
models/base/initStrategy.py, a dormant class of the reference's component
inventory): constant / uniform / normal / xavier / kaiming
re-initialisation.  The JAX package maps a flax params tree; here the
strategy runs over a module's parameters, with the same rules: every
weight with ndim >= 2 is redrawn, biases become 0 and BatchNorm weights 1,
buffers (running stats) are left alone.

Draws come from the given ``torch.Generator`` in flax's distributions:
``uniform`` is U[0, 1), ``normal`` has std 1, and the fans are those of
the flax kernel the weight stands for (a transposed conv's
``[in, out, k, k]`` weight is flax's ``[k, k, in, out]``).
``kaiming_normal`` is flax's ``he_normal``: a normal truncated at 2 std,
rescaled to std sqrt(2 / fan_in).
"""
import math

import torch
import torch.nn as nn

from .layers import flax_truncated_normal_


def _fans(module, weight):
    """(fan_in, fan_out) of the flax kernel behind ``weight``."""
    receptive = math.prod(weight.shape[2:])
    inp, out = weight.shape[1], weight.shape[0]
    if isinstance(module, nn.ConvTranspose2d):
        inp, out = out, inp
    return inp * receptive, out * receptive


def _uniform_(w, lo, hi, gen):
    return w.copy_(torch.rand(w.shape, generator=gen, dtype=w.dtype,
                              device=w.device) * (hi - lo) + lo)


_STRATEGIES = {
    "constant": lambda w, fi, fo, g: w.fill_(0.5),
    "uniform": lambda w, fi, fo, g: _uniform_(w, 0.0, 1.0, g),
    "normal": lambda w, fi, fo, g: w.copy_(torch.randn(
        w.shape, generator=g, dtype=w.dtype, device=w.device)),
    "xavier": lambda w, fi, fo, g: _uniform_(
        w, -math.sqrt(6.0 / (fi + fo)), math.sqrt(6.0 / (fi + fo)), g),
    "kaiming_uniform": lambda w, fi, fo, g: _uniform_(
        w, -math.sqrt(6.0 / fi), math.sqrt(6.0 / fi), g),
    "kaiming_normal": lambda w, fi, fo, g: flax_truncated_normal_(
        w, math.sqrt(2.0 / fi), g),
}


@torch.no_grad()
def parameters_initialize(model, generator=None, mode="kaiming_normal"):
    """Reinitialise every weight of ``model`` with ndim >= 2 by the chosen
    strategy; 1-d weights (BatchNorm scales) become 1, biases 0.  Returns
    the model."""
    if mode not in _STRATEGIES:
        raise ValueError(f"unknown init strategy {mode!r}; "
                         f"choices: {sorted(_STRATEGIES)}")
    init = _STRATEGIES[mode]
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
            elif p.ndim >= 2:
                init(p, *_fans(module, p), generator)
            else:
                p.fill_(1.0)
    return model
