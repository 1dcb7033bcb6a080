"""Visual debug dumps (reference draw_point / _draw_testImage / debug
regions): the port's counterpart of ``ubpl_tpu/utils/draw.py``.

Writes each augmentation stage as an annotated PNG under
``{base_path}/draw/...`` when debug is on, as the reference's visual test
surface does (datasets/dataset.py:77-139, projects/MT.py:184-223).  The
JAX package draws and writes with cv2; here the keypoints are filled discs
drawn with numpy and the files are written by ``data.native_io.write_png``.
"""
import os

import numpy as np

from ..data.native_io import write_png


def draw_point(img, coord, color=(0, 95, 191), radius=3):
    """Reference ProcessUtils.draw_point: a filled disc at ``coord`` (x, y)
    on an [H, W, 3] uint8 image (a copy), skipped at x or y <= 1."""
    img = np.array(img, np.uint8)
    x, y = int(round(float(coord[0]))), int(round(float(coord[1])))
    if x > 1 and y > 1:
        h, w = img.shape[:2]
        ys, xs = np.ogrid[0:h, 0:w]
        img[(xs - x) ** 2 + (ys - y) ** 2 <= radius * radius] = color
    return img


def save_image(img, pathname):
    write_png(pathname, np.asarray(img).astype(np.uint8))


def draw_kps_image(image01, kps, pck_ref=()):
    """Annotate an [H, W, 3] image in [0,1] with keypoints (vis-gated)."""
    img = (np.asarray(image01) * 255).astype(np.uint8)
    for k_idx, kp in enumerate(np.asarray(kps)):
        if len(kp) < 3 or kp[2] > 0:
            color = (255, 0, 0) if k_idx in tuple(pck_ref) else (0, 95, 191)
            img = draw_point(img, kp[:2], color=color)
    return img


class DebugDrawer:
    """Stage-by-stage augmentation dumps (reference _draw_testImage)."""

    def __init__(self, base_path, ds_type="train"):
        self.base = os.path.join(base_path, "draw", "dataset", ds_type)

    def stage(self, image_id, step_id, image01, kps=None):
        img = np.clip(np.asarray(image01), 0, 1)
        img = (draw_kps_image(img, kps) if kps is not None
               else (img * 255).astype(np.uint8))
        save_image(img, os.path.join(self.base, f"{image_id}_{step_id}.png"))

    def dump_view(self, image_ids, view, prefix=""):
        """Dump a whole augmented ``train.common.ViewBatch`` (NCHW): the
        augmented image with its keypoints, and the max over the joints of
        its target heatmaps."""
        images = view.images.detach().float().permute(0, 2, 3, 1).cpu().numpy()
        kps = view.kps.detach().cpu().numpy()
        heatmaps = view.heatmaps.detach().float().cpu().numpy()
        for i, image_id in enumerate(image_ids):
            self.stage(image_id, prefix + "aug", images[i], kps[i])
            hm = heatmaps[i].max(0)
            hm_img = np.repeat((hm / max(hm.max(), 1e-6))[..., None], 3, -1)
            self.stage(image_id, prefix + "heatmap", hm_img)
