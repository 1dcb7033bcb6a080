"""The six pose datasources (reference datasources/{mouse,flic,lsp,ap10k,fly,pranav}.py):
the port's copy of ``ubpl_tpu/data/sources.py``.

Each subclass provides metadata + raw record loading; splits/caching/means
live in PoseDataSource.  Paths are {data_root}-relative (the reference
hardcodes D:/00Data/...).  Only Mouse ships with data in-repo upstream.
"""
import os
import pickle
from glob import glob

import json
import numpy as np

from .base import PoseDataSource


def _scan(pattern):
    return sorted(glob(pattern))


def _stem(path):
    return os.path.splitext(os.path.basename(path))[0]


class MouseData(PoseDataSource):
    """Bundled mouse crops: JSON labels + 1248 pngs (datasources/mouse.py)."""
    name = "Mouse"
    img_type = "png"
    pck_ref = (1, 2)   # left/right eye
    pck_thr = 0.2
    sel_kp_idxs = tuple(range(9))

    def __init__(self, **kw):
        super().__init__(**kw)
        base = os.path.join(self.data_root, "pose", "mouse", "croppeds_bbox")
        self.label_path = os.path.join(base, "labels_normal.json")
        self.img_path = os.path.join(base, "images")

    def _load_records(self):
        with open(self.label_path) as f:
            anns = json.load(f)
        records = []
        for i, ann in enumerate(anns):
            kps = [[kp[0], kp[1], 1] for j, kp in enumerate(ann["kps"])
                   if j in self.sel_kp_idxs]
            rid = "im{}".format(str(1000000 + i + 1)[3:])
            name = f"{ann['imageID']}.{self.img_type}"
            records.append({
                "islabeled": 1, "id": rid, "imageID": ann["imageID"],
                "imageName": name,
                "imagePath": os.path.join(self.img_path, name),
                "kps": kps, "kps_test": kps,
            })
        return records


class FLICData(PoseDataSource):
    """FLIC upper-body pose from examples.mat (datasources/flic.py)."""
    name = "FLIC"
    img_type = "jpg"
    pck_ref = (3, 7)
    pck_thr = 0.5
    sel_kp_idxs = tuple(range(11))

    def __init__(self, **kw):
        super().__init__(**kw)
        base = os.path.join(self.data_root, "pose", "FLIC")
        self.label_path = os.path.join(base, "examples.mat")
        self.img_path = os.path.join(base, "images")

    def default_means(self):
        return [0.25195965, 0.22432944, 0.20951675]

    def default_stds(self):
        return [0.23108867, 0.22090606, 0.22124061]

    def _load_records(self):
        import scipy.io as sio
        mat = sio.loadmat(self.label_path)["examples"]
        names, coords = mat["filepath"][0], mat["coords"][0]
        records = []
        for i, name in enumerate(names):
            name = name[0]
            kps = [[int(kp[0]), int(kp[1]), 1] for kp in coords[i].T
                   if not np.isnan(kp[0])]
            kps_new = self.select_complete(kps, self.sel_kp_idxs)
            if kps_new is None:
                continue
            rid = "im{}".format(str(1000000 + i + 1)[3:])
            records.append({
                "islabeled": 1, "id": rid, "imageID": _stem(name),
                "imageName": name,
                "imagePath": os.path.join(self.img_path, name),
                "kps": kps_new, "kps_test": kps_new,
            })
        return self.filter_single_person(records)


class LSPData(PoseDataSource):
    """LSP + LSPET full-body pose from the two joints.mat archives.

    The reference builds its candidate pool from the CONCATENATION of both
    datasets: ``_dataLoading("lsp") + _dataLoading("lspet")``
    (datasources/lsp.py:31,43), with per-variant id padding — lsp ids are
    4-digit (``str(1000000+i+1)[3:]``), lspet ids 5-digit (``[2:]``,
    datasources/lsp.py:80-83) — and the multi-person filter applied within
    each variant's records (datasources/lsp.py:94-99).
    """
    name = "LSP"
    img_type = "jpg"
    pck_ref = (12, 13)  # neck/head
    pck_thr = 0.5
    sel_kp_idxs = tuple(range(14))

    def __init__(self, **kw):
        super().__init__(**kw)
        base = os.path.join(self.data_root, "pose")
        self.lsp_label = os.path.join(base, "lsp", "lsp", "joints.mat")
        self.lsp_imgs = os.path.join(base, "lsp", "lsp", "images")
        self.lspet_label = os.path.join(base, "lsp", "lspet", "joints.mat")
        self.lspet_imgs = os.path.join(base, "lsp", "lspet", "images")

    def _load_variant(self, variant):
        import scipy.io as sio
        if variant == "lsp":
            label, img_path = self.lsp_label, self.lsp_imgs
        else:
            label, img_path = self.lspet_label, self.lspet_imgs
        joints = sio.loadmat(label)["joints"]
        anns = np.swapaxes(joints, 0, 2)          # [3,14,N] -> [N,14,3] (lsp)
        if variant == "lspet":
            anns = np.swapaxes(anns, 1, 2)        # lspet ships [14,3,N]
        records = []
        for i, ann in enumerate(anns):
            kps_new = self.select_complete(ann.tolist(), self.sel_kp_idxs)
            if kps_new is None:
                continue
            pad = 2 if variant == "lspet" else 3
            img_id = "im{}".format(str(1000000 + i + 1)[pad:])
            name = f"{img_id}.{self.img_type}"
            records.append({
                "islabeled": 1, "id": img_id, "imageID": img_id,
                "imageName": name,
                "imagePath": os.path.join(img_path, name),
                "kps": kps_new, "kps_test": kps_new,
            })
        return self.filter_single_person(records)

    def _load_records(self):
        return self._load_variant("lsp") + self._load_variant("lspet")


class AP10KData(PoseDataSource):
    """AP-10K COCO-style animal pose, per-category (datasources/ap10k.py).

    Reference getSemiData returns a 6-tuple (no idx lists); we keep the
    uniform SemiData return — callers needing reference behavior can ignore
    the idx fields.
    """
    name = "AP10K"
    img_type = "jpg"
    pck_ref = (0, 1)   # left/right eye
    pck_thr = 0.2
    sel_kp_idxs = tuple(range(17))

    def __init__(self, category="rat", **kw):
        super().__init__(**kw)
        self.category = category
        base = os.path.join(self.data_root, "pose", "ap10k")
        self.label_path = os.path.join(base, "annotations")
        self.img_path = os.path.join(base, "data")

    def _load_records(self):
        records = []
        for ann_path in _scan(os.path.join(self.label_path, "*.json")):
            with open(ann_path) as f:
                j = json.load(f)
            imgs = {im["id"]: im for im in j["images"]}
            cates = {c["name"]: c["id"] for c in j["categories"]}
            cate_id = cates.get(self.category)
            for i, ann in enumerate(j["annotations"]):
                if ann.get("category_id") != cate_id:
                    continue
                if not ann.get("keypoints") or max(ann["keypoints"]) == 0:
                    continue
                if not ann.get("num_keypoints"):
                    continue
                info = imgs.get(ann["image_id"])
                if info is None:
                    continue
                k = np.array(ann["keypoints"]).reshape(-1, 3)
                kps = [[int(x), int(y), 0 if x == 0 else 1] for x, y, _ in k]
                rid = "im{}".format(str(1000000 + i + 1)[1:])
                x0, y0, w, h = ann["bbox"]
                records.append({
                    "islabeled": 1, "id": rid,
                    "imageID": _stem(info["file_name"]),
                    "imageName": info["file_name"],
                    "imagePath": os.path.join(self.img_path, info["file_name"]),
                    "bbox": [[x0, y0], [x0 + w, y0 + h]],
                    "categoryID": ann["category_id"],
                    "kps": kps, "kps_test": kps,
                })
        return records


class FLYData(PoseDataSource):
    """Synthetic fly: pickled normalized coords + png scan (datasources/fly.py)."""
    name = "FLY"
    img_type = "png"
    pck_ref = (0, 5)
    pck_thr = 0.2
    sel_kp_idxs = tuple(range(6))
    img_width = 640
    img_height = 480

    def __init__(self, **kw):
        super().__init__(**kw)
        base = os.path.join(self.data_root, "pose", "fly")
        self.label_path = os.path.join(base, "syn_anno.pth")
        self.img_path = os.path.join(base, "trainA")

    def _load_records(self):
        with open(self.label_path, "rb") as f:
            kps_map = pickle.load(f)
        records = []
        for i, img_path in enumerate(_scan(
                os.path.join(self.img_path, f"*.{self.img_type}"))):
            img_id = _stem(img_path)
            name = f"{img_id}.{self.img_type}"
            kps = [[int(p[0] * self.img_width), int(p[1] * self.img_height), 1]
                   for p in kps_map[name]]
            kps = [[kp[0], kp[1], 1] for j, kp in enumerate(kps)
                   if j in self.sel_kp_idxs]
            rid = "im{}".format(str(1000000 + i + 1)[3:])
            records.append({
                "islabeled": 1, "id": rid, "imageID": img_id,
                "imageName": name, "imagePath": img_path,
                "kps": kps, "kps_test": kps,
            })
        return records


class PranavData(PoseDataSource):
    """Openfield-Pranav mouse: JSON labels + png scan (datasources/pranav.py)."""
    name = "Pranav"
    img_type = "png"
    pck_ref = (1, 2)  # ears
    pck_thr = 0.2
    sel_kp_idxs = tuple(range(4))

    def __init__(self, **kw):
        super().__init__(**kw)
        base = os.path.join(self.data_root, "pose", "Openfield-Pranav",
                            "box_train")
        self.label_path = os.path.join(base, "data.json")
        self.img_path = os.path.join(base, "img")

    def _load_records(self):
        with open(self.label_path) as f:
            kps_map = json.load(f)
        records = []
        for i, img_path in enumerate(_scan(
                os.path.join(self.img_path, f"*.{self.img_type}"))):
            img_id = _stem(img_path)
            name = f"{img_id}.{self.img_type}"
            kps = [[int(kp[0]), int(kp[1]), 1] for kp in kps_map[name]]
            rid = "im{}".format(str(1000000 + i + 1)[3:])
            records.append({
                "islabeled": 1, "id": rid, "imageID": img_id,
                "imageName": name, "imagePath": img_path,
                "kps": kps, "kps_test": kps,
            })
        return records


DATASOURCES = {
    "Mouse": MouseData,
    "FLIC": FLICData,
    "LSP": LSPData,
    "AP10K": AP10KData,
    "FLY": FLYData,
    "Pranav": PranavData,
}


def get_datasource(name, **kw) -> PoseDataSource:
    """Reference datasources.__dict__[name]() lookup."""
    return DATASOURCES[name](**kw)
