"""Batched MPII-style coordinate transforms and the bilinear affine warp.

Port of ``ubpl_tpu/ops/transforms.py``: the 200px-unit crop transform
(``get_transform_matrix``), its closed-form inverse, the integer point
transform with the reference's ``trunc(...) + 1`` quirk, the decode-side
inverse transform, the dataset warp matrix with its double ``1/scale``,
``affine_back`` (``:284-307``, the pseudo-label rounds' warp of heatmaps
back to the original frame) and horizontal flips.

The image warp samples where the JAX training path's ``warp_images_affine``
(``:220-257``) does: output pixel ``p`` (0-indexed) reads the source at
``inv(mat) @ (p - 1) + 1``, the reference's 1-indexed convention folded
into the offsets.  It is computed as exact single-pass bilinear sampling
with zero padding (``F.grid_sample(align_corners=True,
padding_mode="zeros")`` on the normalised source coordinates
``2x/(W-1) - 1``); the two-pass tent-matmul that the JAX function uses to
get there is a TPU lowering device and is not copied.

Conventions: points are (x, y) in the last dimension; matrices act on
1-indexed coordinates the way the reference does; images are NCHW.
"""
import math

import torch
import torch.nn.functional as F


def _mat3(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def compose_affine3(a, b):
    """Exact batched composition of affine 3x3s (last row [0,0,1]), in
    scalar arithmetic as the JAX package does."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    b00, b01, b02 = b[..., 0, 0], b[..., 0, 1], b[..., 0, 2]
    b10, b11, b12 = b[..., 1, 0], b[..., 1, 1], b[..., 1, 2]
    zero, one = torch.zeros_like(a00), torch.ones_like(a00)
    return _mat3([
        [a00 * b00 + a01 * b10, a00 * b01 + a01 * b11,
         a00 * b02 + a01 * b12 + a02],
        [a10 * b00 + a11 * b10, a10 * b01 + a11 * b11,
         a10 * b02 + a11 * b12 + a12],
        [zero, zero, one]])


def get_transform_matrix(center, scale, res, rot=None):
    """Batched 3x3 crop transform (reference get_transform).

    center: [..., 2] (x, y); scale: [...]; res: (h, w); rot: [...] degrees
    or None.  Returns [..., 3, 3] in at least float32.
    """
    center = torch.as_tensor(center)
    dtype = torch.promote_types(center.dtype, torch.float32)
    center = center.to(dtype)
    h = 200.0 * torch.as_tensor(scale, device=center.device).to(dtype)
    res_h, res_w = float(res[0]), float(res[1])
    zero, one = torch.zeros_like(h), torch.ones_like(h)
    t = _mat3([[res_w / h, zero, res_w * (-center[..., 0] / h + 0.5)],
               [zero, res_h / h, res_h * (-center[..., 1] / h + 0.5)],
               [zero, zero, one]])
    if rot is None:
        return t
    rot = torch.as_tensor(rot, device=center.device).to(dtype)
    rot, h = torch.broadcast_tensors(rot, h)
    zero, one = torch.zeros_like(h), torch.ones_like(h)
    # the reference rotates by -rot about the crop centre
    rr = -rot * (math.pi / 180.0)
    sn, cs = torch.sin(rr), torch.cos(rr)
    rot_mat = _mat3([[cs, -sn, zero], [sn, cs, zero], [zero, zero, one]])
    t_mat = _mat3([[one, zero, zero - res_w / 2],
                   [zero, one, zero - res_h / 2], [zero, zero, one]])
    t_inv = _mat3([[one, zero, zero + res_w / 2],
                   [zero, one, zero + res_h / 2], [zero, zero, one]])
    full = compose_affine3(t_inv, compose_affine3(rot_mat,
                                                  compose_affine3(t_mat, t)))
    return torch.where((rot == 0.0)[..., None, None], t, full)


def invert_affine3(t):
    """Closed-form inverse of a batched affine 3x3 (last row [0,0,1])."""
    a, b, c = t[..., 0, 0], t[..., 0, 1], t[..., 0, 2]
    d, e, f = t[..., 1, 0], t[..., 1, 1], t[..., 1, 2]
    det = a * e - b * d
    ia, ib = e / det, -b / det
    id_, ie = -d / det, a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return _mat3([[ia, ib, ic], [id_, ie, if_], [zero, zero, one]])


def transform_points_cont(pts, mat):
    """Continuous point transform ``mat @ [x-1, y-1, 1]``."""
    x = pts[..., 0] - 1.0
    y = pts[..., 1] - 1.0
    nx = mat[..., 0, 0] * x + mat[..., 0, 1] * y + mat[..., 0, 2]
    ny = mat[..., 1, 0] * x + mat[..., 1, 1] * y + mat[..., 1, 2]
    return torch.stack([nx, ny], -1)


def transform_points(pts, center, scale, res, invert=False, rot=None):
    """Reference ``transform``: ``trunc(mat @ (pt - 1)) + 1`` as int32."""
    mat = get_transform_matrix(center, scale, res, rot)
    if invert:
        mat = invert_affine3(mat)
    cont = transform_points_cont(pts, mat)
    return torch.trunc(cont).to(torch.int32) + 1


def transform_preds(coords, center, scale, res):
    """Reference transform_preds: per-point inverse transform (rot=0).

    coords [B, K, 2] 1-indexed heatmap coords; center [B, 2]; scale [B].
    Returns integer-valued float coords in original image space.
    """
    mat = invert_affine3(get_transform_matrix(center, scale, res))
    out = transform_points_cont(coords, mat[..., None, :, :])
    return (torch.trunc(out) + 1.0).to(coords.dtype)


def affine_warp_matrix(center, scale, angle, res):
    """Input->output matrix of the crop/rotate warp (reference
    utils/augment.py:86-138); keypoints move by ``transform_points`` with
    the same parameters."""
    return get_transform_matrix(center, scale, res, angle)


def warp_images_affine(images, mats_in2out, out_res):
    """Exact bilinear affine warp with zero padding.

    images: [B, C, H, W] float; mats_in2out: [B, 3, 3] (1-indexed
    convention, as ``affine_warp_matrix`` makes them).  Output pixel
    (x, y), 0-indexed, samples the source at ``inv(mat) @ (x - 1, y - 1, 1)
    + 1``, as the JAX training path's ``warp_images_affine`` does (its
    offsets ``c0 = m02 - m00 - m01 + 1``, ``c1 = m12 - m10 - m11 + 1``).
    Returns [B, C, out_res, out_res].
    """
    B, _, H, W = images.shape
    inv = invert_affine3(mats_in2out).to(images.dtype)
    m00, m01, m02 = inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2]
    m10, m11, m12 = inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2]
    c0 = (m02 - m00 - m01 + 1.0)[:, None, None]
    c1 = (m12 - m10 - m11 + 1.0)[:, None, None]
    r = torch.arange(out_res, dtype=images.dtype, device=images.device)
    ys, xs = r[:, None], r[None, :]
    sx = m00[:, None, None] * xs + m01[:, None, None] * ys + c0
    sy = m10[:, None, None] * xs + m11[:, None, None] * ys + c1
    grid = torch.stack([sx * (2.0 / (W - 1)) - 1.0,
                        sy * (2.0 / (H - 1)) - 1.0], -1)
    return F.grid_sample(images, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def affine_warpmat(angle, scale):
    """Reference warpmat as consumed by the datasets: ``(1/scale) *
    R(-angle)`` with zero translation (the reference divides by the scale
    twice).  angle in degrees; returns [..., 2, 3] float32."""
    angle = torch.as_tensor(angle, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=angle.device)
    rad = -angle * (math.pi / 180.0)
    cs, sn = torch.cos(rad) / scale, torch.sin(rad) / scale
    zero = torch.zeros_like(cs)
    return torch.stack([torch.stack([cs, -sn, zero], -1),
                        torch.stack([sn, cs, zero], -1)], -2)


def affine_back(heatmaps, warpmat, isflip):
    """Reference affine_back2: warp heatmaps back through ``warpmat`` with
    ``affine_grid`` / ``grid_sample`` semantics (``align_corners=True``,
    zeros outside), then undo the horizontal flips.  The JAX package
    computes the same sampling in XLA; here it is ``F.grid_sample``.

    heatmaps: [B, K, H, W]; warpmat: [B, 2, 3]; isflip: [B] bool.
    """
    grid = F.affine_grid(warpmat.to(heatmaps.dtype), list(heatmaps.shape),
                         align_corners=True)
    out = F.grid_sample(heatmaps, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return torch.where(isflip[:, None, None, None], out.flip(-1), out)


def fliplr_images(images):
    """Horizontal flip of [..., H, W] images (NCHW)."""
    return images.flip(-1)


def fliplr_kps(kps, img_width):
    """Reference kps_fliplr: x -> width - x (no joint-pair swap)."""
    out = kps.clone()
    out[..., 0] = img_width - kps[..., 0]
    return out
