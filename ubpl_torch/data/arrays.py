"""Dataset materialization: records -> arrays ready for the device.

Port of ``ubpl_tpu/data/arrays.py``.  Each image is decoded and resized
exactly once (threaded host IO through ``native_io``) into one uint8 array
that ``train.common.put_dataset`` moves to the card whole; every per-sample
augmentation then runs in the training step on the device.  A 1248-image
Mouse split at 256x256x3 uint8 is about 245 MB.
"""
import concurrent.futures as cf
from typing import List, NamedTuple, Optional

import numpy as np

from .native_io import image_size, imread_resize


class PoseArrays(NamedTuple):
    images: np.ndarray     # [N, R, R, 3] uint8, BGR (cv2 order, like reference)
    kps: np.ndarray        # [N, K, 3] float32, coords in inp_res space
    kps_test: np.ndarray   # [N, K, 3] float32 (truth retained for pseudo audit)
    islabeled: np.ndarray  # [N] int32
    image_ids: list        # [N] str


def load_images_bgr(paths: List[str], inp_res: int, workers: int = 16,
                    cache: Optional[dict] = None) -> np.ndarray:
    """[N, inp_res, inp_res, 3] uint8 BGR, decoded on a thread pool.
    ``cache`` maps (path, inp_res) to an image decoded before; images
    decoded here are added to it."""
    cache = {} if cache is None else cache
    todo = sorted({p for p in paths if (p, inp_res) not in cache})
    with cf.ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        for p, img in zip(todo, ex.map(lambda p: imread_resize(p, inp_res),
                                       todo)):
            cache[(p, inp_res)] = img
    out = np.empty((len(paths), inp_res, inp_res, 3), np.uint8)
    for i, p in enumerate(paths):
        out[i] = cache[(p, inp_res)]
    return out


def _resize_kps(kps, orig_w, orig_h, inp_res):
    """Reference image_resize: non-aspect-preserving scale to inp_res^2."""
    k = np.asarray(kps, np.float32).reshape(-1, 3).copy()
    k[:, 0] *= inp_res / orig_w
    k[:, 1] *= inp_res / orig_h
    return k


def materialize(records: List[dict], inp_res: int = 256,
                workers: int = 16, cache: Optional[dict] = None) -> PoseArrays:
    """Load + resize every record once; resize kps into inp_res coords.
    ``cache``: see ``load_images_bgr`` (a datasource's ``image_cache``)."""
    paths = [r["imagePath"] for r in records]
    images = load_images_bgr(paths, inp_res, workers, cache)
    N = len(records)
    K = len(records[0]["kps"])
    kps = np.zeros((N, K, 3), np.float32)
    kps_test = np.zeros((N, K, 3), np.float32)
    islabeled = np.zeros((N,), np.int32)
    with cf.ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        sizes = list(ex.map(image_size, paths))
    for i, r in enumerate(records):
        w, h = sizes[i]
        kps[i] = _resize_kps(r["kps"], w, h, inp_res)
        kps_test[i] = _resize_kps(r["kps_test"], w, h, inp_res)
        islabeled[i] = int(r["islabeled"])
    return PoseArrays(images, kps, kps_test, islabeled,
                      [r["imageID"] for r in records])


def pad_to_multiple(arrays: PoseArrays, mult: int) -> PoseArrays:
    """Pad the sample axis to a multiple of `mult` (the JAX package's
    'data' mesh-axis size; 1 on one card).  Padding rows are never indexed:
    samplers draw from the real record count only."""
    if mult <= 1:
        return arrays
    n = arrays.images.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return arrays

    def padn(x):
        return np.concatenate(
            [x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)

    return PoseArrays(padn(arrays.images), padn(arrays.kps),
                      padn(arrays.kps_test), padn(arrays.islabeled),
                      list(arrays.image_ids) + [""] * pad)
