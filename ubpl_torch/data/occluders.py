"""Synthetic-occlusion occluder bank (reference utils/udaap/utils_augment.py).

Port of ``ubpl_tpu/data/occluders.py``: non-animal segmented objects
harvested from VOC2012 (RGBA patches with border-softened alpha), padded
and resized into a fixed-shape bank that ``ops.augment.composite_occluders``
pastes from.  Where VOC2012 is absent, a bank of synthetic soft blobs keeps
the augmentation path running.

The JAX package reads VOC with PIL and erodes/resizes with cv2; here the
images go through ``native_io`` (PNG by the port's decoder, JPEG by cv2 or
PIL) and the erosion and the resize are numpy copies of cv2's.
"""
import os
import xml.etree.ElementTree

import numpy as np

from .native_io import imread_bgr, read_png, resize_linear

ANIMALish = {"cat", "dog", "cow", "horse", "sheep", "person"}


def ellipse_kernel(size):
    """``cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))``."""
    r = c = size // 2
    k = np.zeros((size, size), np.uint8)
    for i in range(size):
        dy = i - r
        if abs(dy) <= r:
            dx = int(round(c * np.sqrt((r * r - dy * dy) / (r * r))))
            k[i, max(c - dx, 0):min(c + dx + 1, size)] = 1
    return k


def erode(mask, kernel):
    """``cv2.erode(mask, kernel)``: the minimum over the kernel's support,
    anchored at its centre; outside the image counts as the maximum."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    h, w = mask.shape
    big = np.full((h + kh - 1, w + kw - 1), np.iinfo(mask.dtype).max,
                  mask.dtype)
    big[ay:ay + h, ax:ax + w] = mask
    out = np.full_like(mask, np.iinfo(mask.dtype).max)
    for i, j in zip(*np.nonzero(kernel)):
        np.minimum(out, big[i:i + h, j:j + w], out=out)
    return out


def harvest_voc_occluders(voc_root, min_pixels=500, downscale=0.5):
    """Reference load_occluders: segmented, non-animal objects as RGBA
    float32 patches in [0,1]; mask borders eroded to 192/255 opacity."""
    occluders = []
    se = ellipse_kernel(8)
    ann_dir = os.path.join(voc_root, "Annotations")
    for name in sorted(os.listdir(ann_dir)):
        root = xml.etree.ElementTree.parse(os.path.join(ann_dir, name)).getroot()
        if root.find("segmented").text == "0":
            continue
        boxes = []
        for i_obj, obj in enumerate(root.findall("object")):
            if obj.find("name").text in ANIMALish:
                continue
            bb = obj.find("bndbox")
            boxes.append((i_obj, [int(bb.find(s).text) for s in
                                  ("xmin", "ymin", "xmax", "ymax")]))
        if not boxes:
            continue
        im_name = root.find("filename").text
        im = imread_bgr(os.path.join(voc_root, "JPEGImages", im_name))[..., ::-1]
        seg, _ = read_png(os.path.join(voc_root, "SegmentationObject",
                                       im_name.replace("jpg", "png")))
        seg = seg[..., 0]
        for i_obj, (xmin, ymin, xmax, ymax) in boxes:
            mask = (seg[ymin:ymax, xmin:xmax] == i_obj + 1).astype(np.uint8) * 255
            if int(np.count_nonzero(mask)) < min_pixels:
                continue
            eroded = erode(mask, se)
            mask[eroded < mask] = 192
            patch = np.concatenate([im[ymin:ymax, xmin:xmax],
                                    mask[..., None]], axis=-1)
            h, w = patch.shape[:2]
            patch = resize_linear(np.ascontiguousarray(patch),
                                  max(int(w * downscale), 2),
                                  max(int(h * downscale), 2))
            occluders.append(patch.astype(np.float32) / 255.0)
    return occluders


def synthetic_occluders(n=32, size=48, seed=0):
    """Random soft blobs standing in for VOC objects when data is absent."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    out = []
    for _ in range(n):
        color = rng.random(3).astype(np.float32)
        cx, cy = rng.uniform(size * 0.3, size * 0.7, 2)
        rx, ry = rng.uniform(size * 0.15, size * 0.45, 2)
        d = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2
        alpha = np.clip(1.5 - d, 0, 1).astype(np.float32)
        rgb = np.broadcast_to(color, (size, size, 3)).copy()
        out.append(np.concatenate([rgb, alpha[..., None]], -1))
    return out


def build_occluder_bank(occluders=None, bank_size=64, patch_res=64,
                        voc_root=None, seed=0):
    """Pad/resize harvested occluders into fixed-shape arrays:
    (rgb [N, patch_res, patch_res, 3], alpha [N, patch_res, patch_res])."""
    if occluders is None:
        if voc_root and os.path.isdir(voc_root):
            occluders = harvest_voc_occluders(voc_root)
        else:
            occluders = synthetic_occluders(bank_size, patch_res, seed)
    rng = np.random.default_rng(seed)
    if len(occluders) > bank_size:
        sel = rng.choice(len(occluders), bank_size, replace=False)
        occluders = [occluders[i] for i in sel]
    rgb = np.zeros((bank_size, patch_res, patch_res, 3), np.float32)
    alpha = np.zeros((bank_size, patch_res, patch_res), np.float32)
    for i, occ in enumerate(occluders[:bank_size]):
        resized = resize_linear(np.asarray(occ, np.float32), patch_res,
                                patch_res)
        rgb[i] = resized[..., :3]
        alpha[i] = resized[..., 3]
    return rgb, alpha
