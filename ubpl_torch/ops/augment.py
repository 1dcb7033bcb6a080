"""Device-side batched data augmentation, split into draw and apply steps.

Port of ``ubpl_tpu/ops/augment.py:34-160`` (reference utils/augment.py:
fliplr, noisy_mean, affine; utils/udaap/utils_augment.py: occlusion).
``jax.random`` keys become a ``torch.Generator``: ``draw_augment`` (and
``draw_occlusion``) take one and return every random number the chain
consumes as tensors (``AugmentDraws``, ``OcclusionDraws``); the apply
functions take those draws, so a test can feed them JAX's draws.

Distributions (as the reference):
  * flip:   Bernoulli(prob) per sample
  * noise:  Bernoulli(prob); contrast U(0.8, 1.2) about the mean,
            brightness U(-0.2, 0.2), clamp to [0, 1]
  * affine: scale *= clamp(N(1, sf), 1-sf, 1+sf);
            angle = clamp(N(0, rf), -rf, rf)
  * occlusion: Bernoulli(aug_rate); per occluder a bank index, a scale
            U(0.2, 0.7) and a centre U(0.1, 0.9)^2 (``draw_occlusion``)

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


class OcclusionDraws(NamedTuple):
    apply: torch.Tensor     # [B] bool
    pick: torch.Tensor      # [B, N] int64 bank indices
    scale: torch.Tensor     # [B, N] patch scale (fraction of the image)
    pos: torch.Tensor       # [B, N, 2] patch centre (x, y), fractions


def draw_occlusion(batch, num_occluders, bank_size, generator, device,
                   scale_range=(0.2, 0.7), aug_rate=0.5):
    """Every random number of one ``composite_occluders`` call."""
    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (hi - lo) + lo

    n = num_occluders
    return OcclusionDraws(
        apply=uniform((batch,), 0.0, 1.0) < aug_rate,
        pick=torch.randint(0, bank_size, (batch, n), generator=generator,
                           device=device),
        scale=uniform((batch, n), *scale_range),
        pos=uniform((batch, n, 2), 0.1, 0.9))


def composite_occluders(images, occluder_rgb, occluder_alpha,
                        draws: OcclusionDraws):
    """Synthetic-occlusion augmentation (``ubpl_tpu/ops/augment.py:120-160``):
    on the samples where ``draws.apply``, alpha-paste ``N`` occluder patches
    one over the other, each nearest-sampled from the bank at its drawn
    scale and centre.

    images: [B, C, H, W]; occluder_rgb: [Nbank, oh, ow, C] and
    occluder_alpha: [Nbank, oh, ow] (the bank's layout, channel-last).
    """
    B, _, H, W = images.shape
    oh, ow = occluder_rgb.shape[1], occluder_rgb.shape[2]
    dev, dt = images.device, images.dtype
    rows = torch.arange(H, device=dev, dtype=torch.int32)
    cols = torch.arange(W, device=dev, dtype=torch.int32)
    pasted = images
    for n in range(draws.pick.shape[1]):
        s = draws.scale[:, n, None]
        cx, cy = draws.pos[:, n, 0:1], draws.pos[:, n, 1:2]
        ys = (rows - cy * H) / (s * H) * oh + oh / 2          # [B, H]
        xs = (cols - cx * W) / (s * W) * ow + ow / 2          # [B, W]
        yi = ys.to(torch.int32).clamp(0, oh - 1).long()
        xi = xs.to(torch.int32).clamp(0, ow - 1).long()
        inb = (((ys >= 0) & (ys < oh))[:, :, None]
               & ((xs >= 0) & (xs < ow))[:, None, :])
        pick = draws.pick[:, n, None, None]
        a = (occluder_alpha[pick, yi[:, :, None], xi[:, None, :]]
             * inb).to(dt)[:, None]                           # [B, 1, H, W]
        patch = occluder_rgb[pick, yi[:, :, None], xi[:, None, :]]
        patch = patch.permute(0, 3, 1, 2).to(dt)              # [B, C, H, W]
        pasted = pasted * (1 - a) + patch * a
    apply = draws.apply.to(dt)[:, None, None, None]
    return apply * pasted + (1 - apply) * images
