"""The numbers that decide ``correct``: gaps between the program's
readings and the plain reference's.

Training (per leaf, worst leaf): the gap between the program's norm and
the reference's, not the norm of their difference, over the reference's
norm of that leaf or of the median leaf, whichever is larger.  Leaves
whose first gradient in the reference is under a thousandth of the median
leaf's (a bias followed by BatchNorm, which only rounding moves under
Adam) are left out of the parameter change.

The first check step's loss terms, each against the reference's (worst
branch), before any update; the targets that the step's heatmap kernel
wrote, cell by cell, and the keypoints' visibility it gated.

Serving (per frame and joint, worst one): how far below the reference
map's maximum the reference map lies at the position the program
decoded, and the gap between the program's score and the reference's
maximum, both over the spread (standard deviation) of the reference map.
"""
import statistics

import torch

#: leaves whose reference gradient norm is under this share of the median
#: leaf's are rounding-only under Adam and left out of the change
TINY_GRADIENT = 1e-3


def relative_gap(program, reference):
    """Worst |p - r| / |r| over paired scalars."""
    return max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program, reference))


def leaf_gap(program, reference, keep=None):
    """Worst per-leaf |‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖) over the leaves
    of ``reference`` (dicts name -> norm), or of ``keep`` if given;
    returns (gap, the worst leaf's name)."""
    names = sorted(reference if keep is None else keep)
    med = statistics.median(reference[n] for n in names)
    return max((abs(program[n] - reference[n]) / max(reference[n], med,
                                                       1e-30), n)
               for n in names)


def median_leaf_gap(program, reference, keep):
    """The median over the leaves ``keep`` of |‖p‖ - ‖r‖| / ‖r‖."""
    return statistics.median(abs(program[n] - reference[n])
                             / max(reference[n], 1e-30) for n in keep)


def term_gap(program, reference, total):
    """Worst |p - r| / |r| over one loss term's per-branch values; where
    the reference's term is exactly 0, |p| over the step's summed loss
    ``total``."""
    return max(abs(p - r) / (abs(r) if r else max(abs(total), 1e-30))
               for p, r in zip(program, reference))


def map_gap(program, reference):
    """Worst difference of a target map's cell, or of a keypoint's
    visibility, over paired (maps [B, K, H, W], keypoints [B, K, 3]);
    1 (a peak's whole height) where the program wrote a different number
    or shape of them."""
    if len(program) != len(reference) or any(
            p[0].shape != r[0].shape for p, r in zip(program, reference)):
        return 1.0
    return max(max(float((p[0] - r[0]).abs().max()),
                   float((p[1][..., 2] - r[1][..., 2]).abs().max()))
               for p, r in zip(program, reference))


def count_gap(program, reference):
    """Worst |p - r| / max(r, 1) over the counts of every step: lists of
    dicts name -> list of numbers."""
    return max(abs(p - r) / max(abs(r), 1.0)
               for ps, rs in zip(program, reference) for k in rs
               for p, r in zip(ps[k], rs[k]))


def moving_leaves(first_grads):
    """The leaves whose reference first gradient is not rounding-only."""
    med = statistics.median(first_grads.values())
    return {n for n, g in first_grads.items() if g >= TINY_GRADIENT * med}


def decode_gaps(coords, scores, ref_maps, inp_res):
    """Serving gaps of one block of frames.  ``coords`` [N, K, 2] image
    pixels and ``scores`` [N, K] from the program; ``ref_maps`` [N, K, H, W]
    the reference's last-stack maps.  Returns (position gap, score gap),
    the worst over the block."""
    N, K, H, W = ref_maps.shape
    stride = inp_res // W
    flat = ref_maps.flatten(-2).double()
    top = flat.amax(-1)
    spread = flat.std(-1).clamp(min=1e-30)
    # an argmax (x, y), 1-indexed on the map, decodes to stride*(x-1)+1
    col = (coords[..., 0].double() - 1) / stride
    row = (coords[..., 1].double() - 1) / stride
    masked = (col == -1) & (row == -1)          # max <= 0: decoded from 0
    on_grid = ((col == col.round()) & (row == row.round())
               & (col >= 0) & (col < W) & (row >= 0) & (row < H))
    idx = (row.clamp(0, H - 1).round() * W
           + col.clamp(0, W - 1).round()).long()
    at = flat.gather(-1, idx[..., None])[..., 0]
    pos = torch.where(masked, top.clamp(min=0), top - at) / spread
    # a position off the map or between its cells is as wrong as can be:
    # the map's whole range
    worst = (top - flat.amin(-1)) / spread
    pos = torch.where(on_grid | masked, pos, worst)
    score = (scores.double() - top).abs() / spread
    return float(pos.max()), float(score.max())
