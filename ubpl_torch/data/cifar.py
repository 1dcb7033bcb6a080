"""CIFAR-10/100 semi-supervised datasources: the port's copy of
``ubpl_tpu/data/cifar.py`` (reference datasources/classification/
cifar10.py, cifar100.py).

Same split semantics as the pose datasources: shuffle, slice, knock labels
out (label = -1 when unlabeled), JSON cache, record for record and byte
for byte the JAX package's.  Data loads from torchvision's pickled batches
under a local root, read with ``pickle`` (no torchvision, no download);
``from_arrays`` serves synthetic and test data.
"""
import copy
import json
import os
import random
from typing import NamedTuple, Optional

import numpy as np

from .base import default_cache_dir, default_data_root


class ClassArrays(NamedTuple):
    images: np.ndarray       # [N, 32, 32, 3] uint8 RGB
    labels: np.ndarray       # [N] int32 (-1 = unlabeled)
    labels_test: np.ndarray  # [N] int32 (truth retained for audit)
    islabeled: np.ndarray    # [N] int32
    image_ids: list


class CIFARData:
    name = "cifar10"
    num_classes = 10
    inp_res = 32
    out_res = 32
    img_type = "png"

    def __init__(self, data_root: Optional[str] = None,
                 cache_dir: Optional[str] = None, seed: Optional[int] = None,
                 arrays=None):
        self.data_root = data_root or default_data_root()
        self.cache_dir = cache_dir or default_cache_dir()
        self._rng = random.Random(seed) if seed is not None else random
        if arrays is not None:
            self._train_images, self._train_targets = arrays["train"]
            self._valid_images, self._valid_targets = arrays["valid"]
        else:
            self._load_torchvision()

    @classmethod
    def from_arrays(cls, train_images, train_targets, valid_images,
                    valid_targets, **kw):
        return cls(arrays={"train": (train_images, train_targets),
                           "valid": (valid_images, valid_targets)}, **kw)

    # torchvision's on-disk layout (the reference downloads through
    # torchvision.datasets.CIFAR10, cifar10.py:61): pickled batch files
    # with uint8 [N, 3072] b"data" rows in CHW order
    _BATCHES = {
        "cifar10": ("cifar-10-batches-py",
                    [f"data_batch_{i}" for i in range(1, 6)],
                    ["test_batch"], b"labels"),
        "cifar100": ("cifar-100-python", ["train"], ["test"],
                     b"fine_labels"),
    }

    def _load_torchvision(self):
        root = os.path.join(self.data_root, f"{self.name}(Classification)",
                            "data")
        dirname, train_files, test_files, label_key = self._BATCHES[self.name]
        base = os.path.join(root, dirname)
        if not os.path.isdir(base):
            raise FileNotFoundError(
                f"{self.name} not found under {root}; place the torchvision "
                f"archive ({dirname}/) there (no network in this environment)")

        def read(files):
            import pickle
            datas, labels = [], []
            for fn in files:
                with open(os.path.join(base, fn), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                datas.append(np.asarray(d[b"data"], np.uint8)
                             .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
                labels.extend(d[label_key])
            return np.concatenate(datas), np.asarray(labels)

        self._train_images, self._train_targets = read(train_files)
        self._valid_images, self._valid_targets = read(test_files)

    def _records(self, targets, is_train):
        start = 1100000 if is_train else 1200000
        recs = []
        for i, t in enumerate(np.asarray(targets)):
            rid = "im{}".format(str(start + i + 1)[1:])
            recs.append({"islabeled": 1, "id": rid, "imageID": rid,
                         "imageName": f"{rid}.{self.img_type}",
                         "label": int(t), "label_test": int(t)})
        return recs

    def get_data(self, train_count, valid_count):
        train = self._records(self._train_targets, True)
        self._rng.shuffle(train)
        train = train[:train_count]
        valid = self._records(self._valid_targets, False)
        self._rng.shuffle(valid)
        valid = valid[:valid_count]
        train, valid = self._cache([train, valid], [train_count, valid_count])
        return train, valid, [0.5] * 3, [0.5] * 3

    def get_semi_data(self, train_count, valid_count, label_ratio):
        train = self._records(self._train_targets, True)
        self._rng.shuffle(train)
        train = train[:train_count]
        valid = self._records(self._valid_targets, False)
        self._rng.shuffle(valid)
        valid = valid[:valid_count]
        semi, labeled, unlabeled, lab_idxs, unlab_idxs = self._semi_organize(
            train, label_ratio)
        cached = self._cache([semi, valid, labeled, unlabeled, lab_idxs,
                              unlab_idxs], [train_count, valid_count,
                                            label_ratio])
        semi, valid, labeled, unlabeled, lab_idxs, unlab_idxs = cached
        return (semi, valid, labeled, unlabeled, lab_idxs, unlab_idxs,
                [0.5] * 3, [0.5] * 3)

    def _semi_organize(self, train, label_ratio):
        labeled_count = int(len(train) * label_ratio)
        void = set(self._rng.sample(range(len(train)),
                                    len(train) - labeled_count))
        semi, labeled, unlabeled, li, ui = [], [], [], [], []
        for idx, item in enumerate(train):
            rec = copy.deepcopy(item)
            if idx in void:
                rec["islabeled"] = 0
                rec["label"] = -1
                ui.append(idx)
                unlabeled.append(rec)
            else:
                rec["islabeled"] = 1
                li.append(idx)
                labeled.append(rec)
            semi.append(rec)
        return semi, labeled, unlabeled, li, ui

    def _cache(self, data_arrays, params):
        save_name = self.name + "".join(f"_{p}" for p in params)
        path = os.path.join(self.cache_dir, save_name + ".json")
        if os.path.isfile(path):
            with open(path) as f:
                return json.load(f)
        os.makedirs(self.cache_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(data_arrays, f)
        return data_arrays

    def materialize(self, records, is_train=True) -> ClassArrays:
        images = self._train_images if is_train else self._valid_images
        start = 1100000 if is_train else 1200000
        rows = [int(r["imageID"][2:]) + 1000000 - start - 1 for r in records]
        return ClassArrays(
            images=np.ascontiguousarray(images[rows]),
            labels=np.asarray([r["label"] for r in records], np.int32),
            labels_test=np.asarray([r["label_test"] for r in records],
                                   np.int32),
            islabeled=np.asarray([r["islabeled"] for r in records], np.int32),
            image_ids=[r["imageID"] for r in records])


class CIFAR10Data(CIFARData):
    name = "cifar10"
    num_classes = 10


class CIFAR100Data(CIFARData):
    name = "cifar100"
    num_classes = 100
