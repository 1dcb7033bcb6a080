"""Plain PyTorch reference of the training views: random draws, flip,
photometric noise, the MPII crop/rotate warp, mean subtraction and the
Gaussian heatmap targets with their visibility re-gate.

Conventions of the reference pose code (utils/augment.py, utils/process.py
of the semi-supervised pose project): images NCHW in [0, 1]; keypoints
[B, K, 3] (x, y, vis) in input pixels, 1-indexed; crop transforms in
200-pixel units; a point moves by ``trunc(mat @ (p - 1)) + 1``, and only a
point with y > 0 moves; output pixel p of the warp (0-indexed) samples the
source bilinearly at ``inv(mat) @ (p - 1) + 1`` with zeros outside.
"""
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class Draws(NamedTuple):
    flip: torch.Tensor
    noise: torch.Tensor
    contrast: torch.Tensor
    brightness: torch.Tensor
    scale_normal: torch.Tensor
    angle_normal: torch.Tensor


def draw(batch, generator, device):
    """One view's random numbers, in the order the training step takes
    them from its generator: four uniform draws (flip, noise, contrast,
    brightness), then two normal ones (scale, angle), each [batch]."""
    u = [torch.rand(batch, generator=generator, device=device)
         for _ in range(4)]
    n = [torch.randn(batch, generator=generator, device=device)
         for _ in range(2)]
    return Draws(u[0] <= 0.5, u[1] <= 0.5, u[2] * 0.4 + 0.8,
                 u[3] * 0.4 - 0.2, n[0], n[1])


def crop_matrix(center, scale, res, angle):
    """[B, 3, 3] crop transform: scale to ``res`` pixels per 200*scale
    around ``center``, then rotate by -angle degrees about the crop's
    centre (the rotation is skipped where the angle is exactly 0)."""
    B = center.shape[0]
    h = 200.0 * scale
    t = torch.zeros(B, 3, 3, dtype=center.dtype, device=center.device)
    t[:, 0, 0] = res / h
    t[:, 1, 1] = res / h
    t[:, 0, 2] = res * (-center[:, 0] / h + 0.5)
    t[:, 1, 2] = res * (-center[:, 1] / h + 0.5)
    t[:, 2, 2] = 1.0
    r = -angle * (math.pi / 180.0)
    cs, sn = torch.cos(r), torch.sin(r)
    rot = torch.zeros_like(t)
    rot[:, 0, 0], rot[:, 0, 1] = cs, -sn
    rot[:, 1, 0], rot[:, 1, 1] = sn, cs
    rot[:, 2, 2] = 1.0
    shift = torch.eye(3, dtype=t.dtype, device=t.device).repeat(B, 1, 1)
    back = shift.clone()
    shift[:, 0, 2], shift[:, 1, 2] = -res / 2, -res / 2
    back[:, 0, 2], back[:, 1, 2] = res / 2, res / 2
    full = back @ (rot @ (shift @ t))
    return torch.where((angle == 0)[:, None, None], t, full)


def move_points(pts, mat):
    """``trunc(mat @ (p - 1)) + 1`` of [B, K, 2] points."""
    x, y = pts[..., 0] - 1.0, pts[..., 1] - 1.0
    m = mat[:, None]
    nx = m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2]
    ny = m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2]
    return torch.stack([torch.trunc(nx), torch.trunc(ny)], -1) + 1.0


def invert_affine(t):
    """Inverse of [B, 3, 3] affine matrices by the 2x2 block's adjugate."""
    a, b, c = t[:, 0, 0], t[:, 0, 1], t[:, 0, 2]
    d, e, f = t[:, 1, 0], t[:, 1, 1], t[:, 1, 2]
    det = a * e - b * d
    ia, ib, id_, ie = e / det, -b / det, -d / det, a / det
    inv = torch.zeros_like(t)
    inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2] = ia, ib, -(ia * c + ib * f)
    inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2] = id_, ie, -(id_ * c + ie * f)
    inv[:, 2, 2] = 1.0
    return inv


def warp(images, mat, res):
    """Bilinear warp of [B, C, H, W] images through the crop matrix."""
    B, _, H, W = images.shape
    inv = invert_affine(mat).to(images.dtype)
    r = torch.arange(res, dtype=images.dtype, device=images.device)
    ys, xs = r[:, None], r[None, :]
    # inv @ (p - 1) + 1, the constant terms gathered first
    c0 = inv[:, 0, 2] - inv[:, 0, 0] - inv[:, 0, 1] + 1.0
    c1 = inv[:, 1, 2] - inv[:, 1, 0] - inv[:, 1, 1] + 1.0
    sx = (inv[:, 0, 0, None, None] * xs + inv[:, 0, 1, None, None] * ys
          + c0[:, None, None])
    sy = (inv[:, 1, 0, None, None] * xs + inv[:, 1, 1, None, None] * ys
          + c1[:, None, None])
    grid = torch.stack([sx * (2.0 / (W - 1)) - 1.0,
                        sy * (2.0 / (H - 1)) - 1.0], -1)
    return F.grid_sample(images, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def augment(images, kps, draws, res, sf=0.25, rf=30.0):
    """flip -> contrast/brightness noise -> crop/rotate warp of a batch
    centred in its ``res`` x ``res`` frame; returns (images, kps)."""
    B, _, _, W = images.shape
    center = torch.full((B, 2), float(res // 2), device=images.device)
    f = draws.flip
    images = torch.where(f[:, None, None, None], images.flip(-1), images)
    kps = torch.where(f[:, None, None], torch.cat(
        [W - kps[..., :1], kps[..., 1:]], -1), kps)
    center = torch.where(f[:, None], torch.stack(
        [W - center[:, 0], center[:, 1]], -1), center)
    mu = images.mean(dim=(1, 2, 3), keepdim=True)
    noised = torch.clamp(draws.contrast[:, None, None, None] * (images - mu)
                         + mu + draws.brightness[:, None, None, None], 0, 1)
    images = torch.where(draws.noise[:, None, None, None], noised, images)
    scale = (res / 200.0) * torch.clamp(draws.scale_normal * sf + 1.0,
                                        1.0 - sf, 1.0 + sf)
    angle = torch.clamp(draws.angle_normal * rf, -rf, rf)
    mat = crop_matrix(center, scale, res, angle)
    images = warp(images, mat, res)
    moved = move_points(kps[..., :2], mat)
    xy = torch.where((kps[..., 1] > 0)[..., None], moved, kps[..., :2])
    return images, torch.cat([xy, kps[..., 2:]], -1)


def heatmaps(kps, inp_res, out_res, sigma=3.0):
    """Gaussian targets [B, K, out, out] at ``trunc(p) / stride``, values
    under 0.01 set to 0, and the keypoints with vis zeroed where the
    +-sigma box leaves the frame."""
    stride = inp_res / out_res
    x, y, vis = kps.unbind(-1)
    xi, yi = torch.trunc(x), torch.trunc(y)
    inside = ((xi + sigma + 1 < inp_res) & (yi + sigma + 1 < inp_res)
              & (xi - sigma >= 0) & (yi - sigma >= 0))
    g = torch.arange(out_res, dtype=kps.dtype, device=kps.device)
    d2 = ((g - yi[..., None] / stride) ** 2)[..., :, None] + \
        ((g - xi[..., None] / stride) ** 2)[..., None, :]
    hm = torch.exp(-d2 / (2 * sigma * sigma))
    hm = torch.where(hm < 0.01, torch.zeros_like(hm), hm.clamp(max=1.0))
    return hm, torch.stack([x, y, vis * inside.to(vis.dtype)], -1)


def to_float(images_u8):
    """[B, R, R, 3] uint8 -> [B, 3, R, R] float32 in [0, 1]."""
    return images_u8.permute(0, 3, 1, 2).float() / 255.0


def normalize(images, means):
    return images - means.to(images.dtype)[None, :, None, None]
