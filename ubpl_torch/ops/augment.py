"""Device-side batched data augmentation, split into draw and apply steps.

Port of ``ubpl_tpu/ops/augment.py:34-117`` (reference utils/augment.py:
fliplr, noisy_mean, affine).  ``jax.random`` keys become a
``torch.Generator``: ``draw_augment`` takes one and returns every random
number the chain consumes as tensors (``AugmentDraws``); the apply
functions take those draws, so a test can feed them JAX's draws.

Distributions (as the reference):
  * flip:   Bernoulli(prob) per sample
  * noise:  Bernoulli(prob); contrast U(0.8, 1.2) about the mean,
            brightness U(-0.2, 0.2), clamp to [0, 1]
  * affine: scale *= clamp(N(1, sf), 1-sf, 1+sf);
            angle = clamp(N(0, rf), -rf, rf)

Images are NCHW floats in [0, 1]; keypoints [B, K, 3].
"""
from typing import NamedTuple

import torch

from .transforms import (affine_warp_matrix, affine_warpmat, fliplr_images,
                         fliplr_kps, transform_points, warp_images_affine)


class AugmentDraws(NamedTuple):
    flip: torch.Tensor          # [B] bool
    noise_apply: torch.Tensor   # [B] bool
    contrast: torch.Tensor      # [B] U(0.8, 1.2)
    brightness: torch.Tensor    # [B] U(-0.2, 0.2)
    scale_normal: torch.Tensor  # [B] N(0, 1)
    angle_normal: torch.Tensor  # [B] N(0, 1)


class AugmentedBatch(NamedTuple):
    images: torch.Tensor    # [B, C, H, W] augmented (pre colour-norm)
    kps: torch.Tensor       # [B, K, 3] transformed keypoints
    center: torch.Tensor    # [B, 2] post-flip centres
    scale: torch.Tensor     # [B] drawn scales
    angle: torch.Tensor     # [B] drawn angles (degrees)
    isflip: torch.Tensor    # [B] bool
    warpmat: torch.Tensor   # [B, 2, 3] inverse warp (for affine_back)


def draw_augment(batch, generator, device, flip_prob=0.5, noise_prob=0.5):
    """Every random number of one ``augment_batch`` call, from
    ``generator`` (which must live on ``device``)."""
    def uniform(lo=0.0, hi=1.0):
        u = torch.rand(batch, generator=generator, device=device)
        return u * (hi - lo) + lo

    def normal():
        return torch.randn(batch, generator=generator, device=device)

    return AugmentDraws(flip=uniform() <= flip_prob,
                        noise_apply=uniform() <= noise_prob,
                        contrast=uniform(0.8, 1.2),
                        brightness=uniform(-0.2, 0.2),
                        scale_normal=normal(), angle_normal=normal())


def random_flip(images, kps, center, flip):
    """Reference fliplr on the samples where ``flip``: mirror the image,
    x -> W - x for keypoints and centre."""
    W = images.shape[-1]
    images = torch.where(flip[:, None, None, None], fliplr_images(images),
                         images)
    kps = torch.where(flip[:, None, None], fliplr_kps(kps, W), kps)
    center_f = torch.stack([W - center[:, 0], center[:, 1]], -1)
    center = torch.where(flip[:, None], center_f, center)
    return images, kps, center


def noisy_mean(images, apply, contrast, brightness):
    """Reference noisy_mean: contrast about the per-image mean plus
    brightness, clamped to [0, 1], on the samples where ``apply``."""
    mu = images.mean(dim=(1, 2, 3))[:, None, None, None]
    con = contrast.to(images.dtype)[:, None, None, None]
    bri = brightness.to(images.dtype)[:, None, None, None]
    noised = torch.clamp(con * (images - mu) + mu + bri, 0.0, 1.0)
    a = apply.to(images.dtype)[:, None, None, None]
    return a * noised + (1 - a) * images


def affine_params(base_scale, scale_normal, angle_normal, sf, rf):
    """Per-sample scale/angle from standard normals, clipped as reference
    AugmentUtils.affine does."""
    s = torch.clamp(scale_normal * sf + 1.0, 1.0 - sf, 1.0 + sf)
    angle = torch.clamp(angle_normal * rf, -rf, rf)
    return base_scale * s, angle


def affine_batch(images, kps, center, scale, angle, inp_res):
    """MPII crop/rotate warp of a batch, keypoints moved to match.

    As reference affine_kps: only points with y > 0 move (the others pass
    through); moved points are integer-truncated + 1.
    """
    mat = affine_warp_matrix(center, scale, angle, (inp_res, inp_res))
    images = warp_images_affine(images, mat, inp_res)
    pts = transform_points(kps[..., 0:2], center[:, None, :], scale[:, None],
                           (inp_res, inp_res), rot=angle[:, None]
                           ).to(kps.dtype)
    movable = (kps[..., 1] > 0)[..., None]
    new_xy = torch.where(movable, pts, kps[..., 0:2])
    return images, torch.cat([new_xy, kps[..., 2:3]], -1)


def augment_batch(images, kps, center, base_scale, draws: AugmentDraws, *,
                  inp_res=256, use_flip=True, sf=0.25, rf=30.0):
    """Reference augmentation chain: flip -> noise -> affine.

    images: [B, C, H, W] in [0, 1]; kps: [B, K, 3]; center: [B, 2];
    base_scale: [B] (inp_res / 200 convention).
    """
    if use_flip:
        isflip = draws.flip
        images, kps, center = random_flip(images, kps, center, isflip)
    else:
        isflip = torch.zeros_like(draws.flip)
    images = noisy_mean(images, draws.noise_apply, draws.contrast,
                        draws.brightness)
    scale, angle = affine_params(base_scale, draws.scale_normal,
                                 draws.angle_normal, sf, rf)
    images, kps = affine_batch(images, kps, center, scale, angle, inp_res)
    return AugmentedBatch(images, kps, center, scale, angle, isflip,
                          affine_warpmat(angle, scale))


def color_normalize(images, means):
    """Reference image_colorNorm: channel mean subtraction only (NCHW)."""
    means = torch.as_tensor(means, dtype=images.dtype, device=images.device)
    return images - means[None, :, None, None]
