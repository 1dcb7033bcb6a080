"""Gaussian heatmap synthesis (plain version) and argmax decode.

Port of ``ubpl_tpu/ops/heatmap.py``:

  * ``synthesize_heatmaps`` (``:22-60``) — the plain PyTorch version of the
    Triton kernel in ``ops/kernels/heatmap_synth.py``, which is what the
    training path calls;
  * ``get_preds`` (``:63-79``) — argmax to 1-indexed (x, y), first maximum
    wins, zeroed where the maximum is <= 0;
  * ``decode_heatmaps`` (``:82-92``) — decode to image coordinates + scores;
  * ``get_preds_all``, ``refine_quarter_pixel``, ``decode_heatmaps_mul``
    (``:95-143``) — the unmasked argmax, the quarter-pixel refinement and
    the decode of several models' maps with their mean.

Layout: heatmaps are NCHW, ``[..., K, H, W]``; keypoints ``[..., K, 3]``
(x, y, vis) in input-resolution coordinates.
"""
import torch

from .transforms import transform_preds


def synthesize_heatmaps(kps, inp_res=256, out_res=64, kernel_size=3.0,
                        sigma=1.0):
    """Batched Gaussian target synthesis with visibility gating.

    kps: [..., K, 3] float (x, y, vis) in inp_res coords.
    Returns (heatmaps [..., K, H, W], kps_new [..., K, 3]).  ``kps_new``
    has vis zeroed for joints whose +-sigma box leaves the frame — the
    reference mutates visibility here and that gate feeds the loss.

    As in the reference: the centre is ``trunc(x) / stride``; a map is
    built for every joint whatever its visibility; values < 0.01 become 0.
    """
    stride = inp_res / out_res
    sig = sigma * kernel_size
    x, y, vis = kps[..., 0], kps[..., 1], kps[..., 2]
    xi, yi = torch.trunc(x), torch.trunc(y)
    in_bounds = ((xi + sig + 1 < inp_res) & (yi + sig + 1 < inp_res)
                 & (xi - sig >= 0) & (yi - sig >= 0))
    kps_new = torch.stack([x, y, vis * in_bounds.to(vis.dtype)], -1)
    cx, cy = xi / stride, yi / stride
    grid = torch.arange(out_res, dtype=kps.dtype, device=kps.device)
    dx2 = (grid - cx[..., None]) ** 2                      # [..., K, W]
    dy2 = (grid - cy[..., None]) ** 2                      # [..., K, H]
    d2 = dy2[..., :, None] + dx2[..., None, :]             # [..., K, H, W]
    kern = torch.exp(-d2 / (2.0 * sig * sig))
    kern = torch.where(kern < 0.01, torch.zeros_like(kern),
                       torch.clamp(kern, max=1.0))
    return kern, kps_new


def get_preds_all(heatmaps):
    """Reference get_preds_all: argmax decode to 1-indexed (x, y) WITHOUT
    the confidence mask.

    heatmaps: [B, K, H, W].  Returns float [B, K, 2]: row-major flatten
    over H*W, first maximum wins.
    """
    W = heatmaps.shape[-1]
    idx = heatmaps.flatten(-2).argmax(dim=-1)   # the first maximum
    p = (idx + 1).to(heatmaps.dtype)
    xs = torch.remainder(p - 1, W) + 1
    ys = torch.floor((p - 1) / W) + 1
    return torch.stack([xs, ys], -1)


def get_preds(heatmaps):
    """Argmax decode to 1-indexed (x, y); confidence-masked: coords are
    zeroed where the map's maximum is <= 0."""
    maxval = heatmaps.amax(dim=(-2, -1))
    return get_preds_all(heatmaps) * (maxval > 0).to(heatmaps.dtype)[..., None]


def refine_quarter_pixel(heatmaps, preds):
    """Quarter-pixel refinement (reference kps_fromHeatmap2): nudge each
    argmax by +-0.25 toward the larger neighbour, then +0.5.

    heatmaps: [B, K, H, W]; preds: [B, K, 2] 1-indexed coords.
    """
    H, W = heatmaps.shape[-2:]
    flat = heatmaps.flatten(-2)
    px = preds[..., 0].long()       # 1-indexed
    py = preds[..., 1].long()

    def at(y, x):
        idx = y.clamp(0, H - 1) * W + x.clamp(0, W - 1)
        return flat.gather(-1, idx[..., None])[..., 0]

    # reference indexing on the 0-indexed grid: hm[py-1][px] - hm[py-1][px-2]
    dx = at(py - 1, px) - at(py - 1, px - 2)
    dy = at(py, px - 1) - at(py - 2, px - 1)
    valid = (px > 1) & (px < W) & (py > 1) & (py < H)
    shift = torch.stack([torch.sign(dx), torch.sign(dy)], -1) * 0.25
    return preds + shift * valid[..., None].to(preds.dtype) + 0.5


def decode_heatmaps(heatmaps, center, scale, res=(64, 64)):
    """Reference kps_fromHeatmap(mode="batch"): decode + per-map max scores.

    heatmaps: [B, K, H, W]; center: [B, 2]; scale: [B].
    Returns (preds [B, K, 2] in original image coords, scores [B, K]).
    """
    preds = transform_preds(get_preds(heatmaps), center, scale, res)
    scores = heatmaps.amax(dim=(-2, -1))
    return preds, scores


def decode_heatmaps_mul(multi_heatmaps, center, scale, res=(64, 64)):
    """Reference kps_fromHeatmap_mul: decode M models' maps and their mean.

    multi_heatmaps: [M, B, K, H, W].  Returns (preds_multi [M, B, K, 2],
    preds_mean [B, K, 2], scores_multi [M, B, K], scores_mean [B, K]).
    """
    M, B = multi_heatmaps.shape[:2]
    preds, scores = decode_heatmaps(multi_heatmaps.flatten(0, 1),
                                    center.repeat(M, 1), scale.repeat(M), res)
    preds = preds.unflatten(0, (M, B))
    scores = scores.unflatten(0, (M, B))
    return preds, preds.mean(dim=0), scores, scores.mean(dim=0)
