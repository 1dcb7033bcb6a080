"""Shared training-pipeline pieces: device-resident dataset, in-step view
construction with target synthesis, forward, validation step.

Port of ``ubpl_tpu/train/common.py``: the whole dataset lives on the device
as uint8 (``:20-44``); each step gathers its batch by index and builds its
view there — flip/noise/affine, colour normalisation, then the Gaussian
targets through the Triton kernel (``make_view``, ``:60-103``); the
classification branch's view is ``make_class_view`` (``:106-121``).  The
sample weights and the multi-head validation step of
``ubpl_tpu/train/base_trainer.py`` are here too, as plain functions.

Images of a view are NCHW float32; on the card they are handed to the model
in ``channels_last`` memory (``device.memory_format``).
"""
import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import autocast, memory_format
from ..models.layers import BatchNorm
from ..ops import augment as A
from ..ops import heatmap as HM
from ..ops import pck as PCK
from ..ops.kernels import heatmap_synth


class DeviceDataset(NamedTuple):
    images: torch.Tensor     # [N, R, R, 3] uint8 (BGR)
    kps: torch.Tensor        # [N, K, 3] float32 (inp_res coords)
    kps_test: torch.Tensor   # [N, K, 3]
    islabeled: torch.Tensor  # [N] int32
    means: torch.Tensor      # [3]


def put_dataset(images, kps, kps_test, islabeled, means, device):
    """Place a dataset (numpy arrays) in device memory."""
    def put(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype=dtype), device=device)
    return DeviceDataset(put(images), put(kps, np.float32),
                         put(kps_test, np.float32), put(islabeled, np.int32),
                         put(means, np.float32))


class ViewBatch(NamedTuple):
    """One augmented view ready for the model + losses."""
    images: torch.Tensor    # [B, 3, R, R] float32, colour-normalised
    heatmaps: torch.Tensor  # [B, K, H, W]
    kps: torch.Tensor       # [B, K, 3] post-augment (vis re-gated)
    gate: torch.Tensor      # [B, K] visibility gate
    warpmat: torch.Tensor   # [B, 2, 3]
    isflip: torch.Tensor    # [B]
    center: torch.Tensor    # [B, 2]
    scale: torch.Tensor     # [B]
    angle: torch.Tensor     # [B]


def images_to_float(images_u8):
    """[B, R, R, 3] uint8 -> [B, 3, R, R] float32 in [0, 1] (a permuted
    view, so the result keeps NHWC strides)."""
    return images_u8.permute(0, 3, 1, 2).float() / 255.0


def make_view(images_u8, kps, means, cfg, draws: Optional[A.AugmentDraws]
              = None, *, scale_range=None, rot_range=None, occlusion=None,
              targets=True):
    """Build one view on the device (reference CommDataset.__getitem__
    steps 2-5): (flip, noise, affine, occlusion) -> colorNorm -> heatmap
    targets with the visibility re-gate -> warpmat.  ``draws=None`` builds
    the un-augmented view.  ``occlusion``: None, or (bank rgb, bank alpha,
    ``A.OcclusionDraws``) to paste occluders after the affine warp.
    ``targets=False`` skips the target synthesis (no kernel launch): the
    view's ``heatmaps`` and ``gate`` are None and its ``kps`` are the
    augmented keypoints without the re-gate (the pseudo-label rounds' views,
    whose targets nothing reads)."""
    B, inp = images_u8.shape[0], cfg.inp_res
    dev = images_u8.device
    imgs = images_to_float(images_u8)
    center = torch.full((B, 2), float(inp // 2), device=dev)
    base_scale = torch.full((B,), inp / 200.0, device=dev)
    if draws is not None:
        aug = A.augment_batch(
            imgs, kps, center, base_scale, draws, inp_res=inp,
            use_flip=cfg.use_flip,
            sf=cfg.scale_range if scale_range is None else scale_range,
            rf=cfg.rot_range if rot_range is None else rot_range)
        imgs, kps, center = aug.images, aug.kps, aug.center
        scale, angle, isflip, warpmat = (aug.scale, aug.angle, aug.isflip,
                                         aug.warpmat)
        if occlusion is not None:
            imgs = A.composite_occluders(imgs, *occlusion)
    else:
        scale = base_scale
        angle = torch.zeros((B,), device=dev)
        isflip = torch.zeros((B,), dtype=torch.bool, device=dev)
        warpmat = torch.eye(2, 3, device=dev).expand(B, 2, 3)
    imgs = A.color_normalize(imgs, means)
    if not targets:
        return ViewBatch(imgs, None, kps, None, warpmat, isflip, center,
                         scale, angle)
    heatmaps, kps_new = heatmap_synth.synthesize_heatmaps(
        kps.contiguous(), inp_res=inp, out_res=cfg.out_res)
    return ViewBatch(imgs, heatmaps, kps_new, kps_new[..., 2], warpmat,
                     isflip, center, scale, angle)


def make_class_view(images_u8, means, cfg,
                    draws: Optional[A.AugmentDraws] = None):
    """Classification view (``ubpl_tpu/train/common.py:106-121``; reference
    datasets/classification/dataset.py): flip -> noise -> affine, run by
    ``augment_batch`` with one dummy keypoint per image, then colorNorm.
    ``draws=None`` builds the un-augmented view.  [B, R, R, 3] uint8 ->
    [B, 3, R, R] float32."""
    B, inp = images_u8.shape[0], cfg.inp_res
    dev = images_u8.device
    imgs = images_to_float(images_u8)
    if draws is not None:
        imgs = A.augment_batch(
            imgs, torch.zeros((B, 1, 3), device=dev),
            torch.full((B, 2), float(inp // 2), device=dev),
            torch.full((B,), inp / 200.0, device=dev), draws, inp_res=inp,
            use_flip=cfg.use_flip, sf=cfg.scale_range,
            rf=cfg.rot_range).images
    return A.color_normalize(imgs, means)


@contextlib.contextmanager
def _frozen_bn_stats(model):
    """While torch.utils.checkpoint recomputes a forward, keep BatchNorm
    from updating its running stats a second time."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


def forward_heatmaps(model, images, train, compute_dtype, remat=False):
    """Run a pose model; returns (preds float32, feats float32 or None).

    train=True runs BatchNorm on batch statistics and updates the module's
    running stats in place (the JAX version returns them).  remat=True
    (``Config.remat``) checkpoints the training forward: the backward
    recomputes activations instead of keeping them (same math).
    """
    model.train(train)
    x = images.contiguous(memory_format=memory_format(images.device))
    with autocast(images.device, compute_dtype):
        if train and remat:
            out = checkpoint(model, x, use_reentrant=False,
                             context_fn=lambda: (contextlib.nullcontext(),
                                                 _frozen_bn_stats(model)))
        else:
            out = model(x)
    preds, feats = out if isinstance(out, tuple) else (out, None)
    return preds.float(), None if feats is None else feats.float()


def predict_keypoints(model, images_u8, means, cfg):
    """Eval forward of a uint8 batch: normalise -> model -> decode the last
    stack at the image centre/scale (reference projects/supervised.py:
    178-211, utils/process.py:320-327).  Returns (coords [B, K, 2],
    scores [B, K])."""
    B, dev = images_u8.shape[0], images_u8.device
    imgs = A.color_normalize(images_to_float(images_u8), means)
    preds, _ = forward_heatmaps(model, imgs, False, cfg.compute_dtype)
    center = torch.full((B, 2), float(cfg.inp_res // 2), device=dev)
    scale = torch.full((B,), cfg.inp_res / 200.0, device=dev)
    return HM.decode_heatmaps(preds[:, -1], center, scale,
                              res=(cfg.out_res, cfg.out_res))


def sample_weights(islabeled, pseudo_weight):
    """Reference ProjectTools weights (projects/tools.py:14-54;
    ``ubpl_tpu/train/base_trainer.py:840-848``): pos (labeled 1, else 0),
    nega (unlabeled pseudo_weight, else 0), cons (labeled 1, unlabeled
    pseudo_weight)."""
    lab = (islabeled > 0).to(torch.float32)
    return lab, (1.0 - lab) * pseudo_weight, lab + (1.0 - lab) * pseudo_weight


@torch.inference_mode()
def validate_heads_batch(models, images_u8, kps, means, cfg, with_mean):
    """Validation step over several heads (``ubpl_tpu/train/base_trainer.
    py:554-584``): eval forward of every model on the same batch, last
    stack, ``decode_heatmaps_mul``, the mean of the heads' coordinates
    appended as one more head when ``with_mean``, then PCK per head
    (reference utils/evaluation.py:92-115).

    Returns (coords [M', B, K, 2], errs [M', K+1], accs [M', K+1]) with
    M' = len(models) + with_mean.
    """
    B, dev = images_u8.shape[0], images_u8.device
    imgs = A.color_normalize(images_to_float(images_u8), means)
    last = torch.stack([
        forward_heatmaps(m, imgs, False, cfg.compute_dtype)[0][:, -1]
        for m in models])                                # [M, B, K, H, W]
    center = torch.full((B, 2), float(cfg.inp_res // 2), device=dev)
    scale = torch.full((B,), cfg.inp_res / 200.0, device=dev)
    coords, coords_mean, _, _ = HM.decode_heatmaps_mul(
        last, center, scale, (cfg.out_res, cfg.out_res))
    if with_mean:
        coords = torch.cat([coords, coords_mean[None]], 0)
    pck_ref = tuple(int(i) for i in cfg.pck_ref)
    pck = [PCK.acc_pck(c, kps, pck_ref, float(cfg.pck_thr)) for c in coords]
    return (coords, torch.stack([e for e, _ in pck]),
            torch.stack([a for _, a in pck]))


def update_pck_counters(acc_counters, err_counters, accs, errs, bs, k):
    """Reference per-batch counter weighting (projects/supervised.py:
    202-205)."""
    for idx in range(k + 1):
        n = bs if idx < k else bs * k
        acc_counters.update(idx, float(accs[idx]), n)
        err_counters.update(idx, float(errs[idx]), n)
