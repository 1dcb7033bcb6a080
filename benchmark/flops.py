"""Work the algorithm needs, counted from the layer shapes: flops of the
networks' forward and training steps, and the bytes of the heatmap
kernel.

A convolution counts 2 x C_in x C_out x k x k flops at every output
position, the zero padding's taps included (the work an implicit-GEMM
convolution does, and what ``torch.utils.flop_counter`` counts); a linear
layer 2 x in x out per row.  Elementwise work, BatchNorm and the losses
are not counted.  A backward pass counts the input gradient (one forward's
flops) of every layer but the first, whose input is the image, and the
weight gradient (one forward's flops) of every layer on the loss's path.
The shapes come from running the reference network on the ``meta``
device, which computes no values.
"""
import torch

from .reference import nets

#: layers whose output the training loss does not read (no backward)
OFF_LOSS_PATH = {"ResNet18": ("fc2",)}


def layers(arch, classes_or_kps, res):
    """[(name, forward flops per image)] of the convolution and linear
    layers in the order the forward runs them."""
    with torch.device("meta"):
        model = nets.build(arch, classes_or_kps)
    seen = []

    def hook(name):
        def count(mod, inp, out):
            w = mod.weight
            per_out = 2 * w[0].numel()
            positions = out[0].numel() // out.shape[1] if out.dim() > 2 \
                else 1
            seen.append((name, per_out * w.shape[0] * positions))
        return count

    for name, m in model.named_modules():
        if isinstance(m, (nets.Conv, nets.Linear)):
            m.register_forward_hook(hook(name))
    with torch.no_grad():
        model.eval()(torch.empty(1, 3, res, res, device="meta"))
    return seen


def forward_flops(arch, classes_or_kps, res):
    """Flops of one image's forward pass."""
    return sum(f for _, f in layers(arch, classes_or_kps, res))


def backward_flops(arch, classes_or_kps, res):
    """Flops of one image's backward pass: input gradients of every layer
    but the first, weight gradients of every layer on the loss's path."""
    seen = layers(arch, classes_or_kps, res)
    off = OFF_LOSS_PATH.get(arch, ())
    on_path = [(n, f) for n, f in seen if n not in off]
    return (sum(f for _, f in on_path)
            + sum(f for n, f in on_path if n != seen[0][0]))


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
