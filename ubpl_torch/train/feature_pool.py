"""Per-image feature history with recency-weighted mixtures (reference
utils/module.py FeaturePool + utils/process.py:33-44, dormant).

Port of ``ubpl_tpu/train/feature_pool.py``.  Stores, per image, the last
``max_length`` back-warped feature snapshots and returns their
recency-weighted mixture.  The back-warp to the original frame
(``affine_back`` + un-flip) runs on the features' device; the history is a
dense host ring buffer ``[N_images, T, C, H, W]`` (the port's channel-first
layout; the JAX package's is channel-last).
"""
import math

import numpy as np

from ..ops.transforms import affine_back


def _mixture_weight(epo, l=10):
    """Reference _feature_mixture_weight: smooth recency weight."""
    t = epo - l
    sign = (t > 0) - (t < 0)
    return (1 - sign + sign * math.exp(-sign * t)) / 2


class FeaturePool:
    def __init__(self, num_images, feature_shape, max_length):
        self.max_length = max_length
        self.buf = np.zeros((num_images, max_length) + tuple(feature_shape),
                            np.float32)
        self.count = np.zeros((num_images,), np.int32)

    def save_features(self, image_rows, features, warpmat, isflip):
        """Back-warp features to the original frame and push them into the
        history.  image_rows: [B] dataset rows; features: [B, C, H, W];
        warpmat: [B, 2, 3]; isflip: [B] bool."""
        warped = affine_back(features, warpmat, isflip).detach().cpu().numpy()
        for i, row in enumerate(np.asarray(image_rows)):
            self.buf[row] = np.roll(self.buf[row], -1, axis=0)
            self.buf[row, -1] = warped[i]
            self.count[row] = min(self.count[row] + 1, self.max_length)

    def get_features_mixture(self, image_rows, epo):
        """Recency-weighted mixture over each image's stored history."""
        out = []
        for row in np.asarray(image_rows):
            n = int(self.count[row])
            feats = self.buf[row, self.max_length - n:]
            ws = [_mixture_weight(e) for e in range(epo - n + 1, epo + 1)]
            acc = np.zeros_like(self.buf[row, -1])
            for w_idx, w in enumerate(ws):
                acc += w * feats[n - 1 - w_idx]
            out.append(acc / max(sum(ws), 1e-12))
        return np.stack(out)


def get_feature_pools(num_images, feature_shape, max_length, model_num=1,
                      aug_num=1, n_stack=1):
    """Reference get_feature_pools: [model][aug][stack] pool grid."""
    return [[[FeaturePool(num_images, feature_shape, max_length)
              for _ in range(n_stack)]
             for _ in range(aug_num)]
            for _ in range(model_num)]
