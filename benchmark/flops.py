"""Work the algorithm needs, counted from the layer shapes: flops of the
networks' forward and training steps, and the bytes of the heatmap
kernel.

A convolution counts 2 x C_in x C_out x k x k flops at every output
position, the zero padding's taps included (the work an implicit-GEMM
convolution does, and what ``torch.utils.flop_counter`` counts); a
transposed one the same at every input position; a linear layer
2 x in x out per row.  The products of two activations that a network's
``registry`` entry declares (attention's) count as it says.  Elementwise
work, normalisation and the losses are not counted.  A backward pass
counts, for every layer on the loss's path, the weight gradient (one
forward's flops) and the input gradient (one forward's flops) of every
weighted layer but the first, whose input is the image, and both
operands' gradients (two forwards' flops) of a product.  The shapes come
from running the reference network on the ``meta`` device, which
computes no values.
"""
import torch

from .reference import nets, registry


def _positions(mod, inp, out):
    """Positions at which a weighted layer applies its whole weight."""
    if isinstance(mod, nets.Linear):
        return out[0].numel() // out.shape[-1]
    if isinstance(mod, nets.ConvTranspose):
        return inp[0][0].numel() // inp[0].shape[1]
    return out[0].numel() // out.shape[1]


def _counted(arch, classes_or_kps, res):
    """[(name, forward flops per image, weighted)] of the weighted layers
    and the declared products, in the order the forward runs them."""
    with torch.device("meta"):
        model = nets.build(arch, classes_or_kps)
    products = registry.lookup(arch).products
    seen = []

    def hook(name):
        def count(mod, inp, out):
            if isinstance(mod, nets.WEIGHTED):
                w = mod.weight
                seen.append((name, 2 * w.numel() * _positions(mod, inp, out),
                             True))
            else:
                seen.append((name, products[type(mod)](mod, inp, out),
                             False))
        return count

    for name, m in model.named_modules():
        if isinstance(m, nets.WEIGHTED) or type(m) in products:
            m.register_forward_hook(hook(name))
    with torch.no_grad():
        model.eval()(torch.empty(1, 3, res, res, device="meta"))
    return seen


def layers(arch, classes_or_kps, res):
    """[(name, forward flops per image)] of the weighted layers and the
    declared products in the order the forward runs them."""
    return [(n, f) for n, f, _ in _counted(arch, classes_or_kps, res)]


def forward_flops(arch, classes_or_kps, res):
    """Flops of one image's forward pass."""
    return sum(f for _, f in layers(arch, classes_or_kps, res))


def backward_flops(arch, classes_or_kps, res):
    """Flops of one image's backward pass over the loss's path: weight
    gradients, input gradients of every weighted layer but the first, and
    both operands' gradients of every product."""
    seen = _counted(arch, classes_or_kps, res)
    off = registry.lookup(arch).off_loss_path
    on_path = [(n, f, w) for n, f, w in seen if n not in off]
    return (sum(f if w else 2 * f for _, f, w in on_path)
            + sum(f for n, f, w in on_path if w and n != seen[0][0]))


def teacher_student_step_flops(arch, classes_or_kps, res, batch, views,
                               students, teachers):
    """Flops of one Mean Teacher step: per image and view, each student's
    forward and backward and each teacher's forward."""
    fwd = forward_flops(arch, classes_or_kps, res)
    bwd = backward_flops(arch, classes_or_kps, res)
    return batch * views * (students * (fwd + bwd) + teachers * fwd)


def heatmap_bytes(batch, kps, out_res):
    """Bytes the heatmap kernel must move at one launch: the keypoints
    [B, K, 3] float32 read once, the maps [B, K, out, out] float32 and the
    re-gated keypoints written once."""
    return 4 * batch * kps * (3 + out_res * out_res + 3)
