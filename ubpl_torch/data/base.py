"""Datasource contract + semi-supervised split machinery: the port's copy
of ``ubpl_tpu/data/base.py``.

Mirrors the duck-typed reference datasource contract (datasources/lsp.py:42-153):
attributes inp_res/out_res/kps_count/img_type/pck_ref/pck_thr/sel_kp_idxs and
get_data / get_semi_data returning the same tuples, with:

  * label knockout of (1 - label_ratio) of the train split (_semiOrgan)
  * JSON split cache pinned to {cache_dir}/{Name}_{params}.json so reruns
    reuse identical splits (the cache format is byte-compatible with the
    reference's datasources/temp_data files)
  * channel mean/std computation over every train+valid image, with the
    reference's BGR->RGB list reversal preserved (datasources/mouse.py:86-89)

Unlike the reference, paths come from a config (data_root) instead of
hardcoded Windows drives, and the per-datasource boilerplate lives here once.

Splits, the cache file and the means are the JAX package's, record for
record and byte for byte.  One difference in the work done, not in the
values: the images decoded for the means stay in ``image_cache``, and
``arrays.materialize`` takes them from there instead of decoding the set a
second time.
"""
import copy
import json
import os
import random
from typing import List, NamedTuple, Optional, Sequence

import numpy as np


class SemiData(NamedTuple):
    semi_train: list
    valid: list
    labeled: list
    unlabeled: list
    labeled_idxs: list
    unlabeled_idxs: list
    means: list
    stds: list


def default_cache_dir():
    return os.environ.get(
        "UBPL_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), "temp_data"))


def default_data_root():
    return os.environ.get("UBPL_DATA_ROOT") or "./data"


class PoseDataSource:
    """Base class; subclasses define metadata + _load_records()."""

    name: str = "Base"
    img_type: str = "png"
    inp_res: int = 256
    out_res: int = 64
    pck_ref: Sequence[int] = (0, 1)
    pck_thr: float = 0.5
    sel_kp_idxs: Sequence[int] = ()

    def __init__(self, data_root: Optional[str] = None,
                 cache_dir: Optional[str] = None, seed: Optional[int] = None):
        self.data_root = data_root or default_data_root()
        self.cache_dir = cache_dir or default_cache_dir()
        # the reference relies on the globally-seeded `random` module
        # (projects/supervised.py:229); we keep an explicit Random for
        # reproducible splits without global state.
        self._rng = random.Random(seed) if seed is not None else random
        # (path, res) -> decoded [res, res, 3] BGR image, filled by the
        # means and read by arrays.materialize
        self.image_cache = {}

    @property
    def kps_count(self):
        return len(self.sel_kp_idxs)

    # -- subclass hook ------------------------------------------------------
    def _load_records(self) -> List[dict]:
        raise NotImplementedError

    # -- public API (reference getData/getSemiData) -------------------------
    def get_data(self, train_count, valid_count, re_mean=True):
        candi = copy.deepcopy(self._load_records())
        self._rng.shuffle(candi)
        train = candi[:train_count]
        valid = candi[train_count:train_count + valid_count]
        train, valid = self._data_cache([train, valid],
                                        [train_count, valid_count])
        means, stds = self._norm_params(train + valid, re_mean)
        return train, valid, means, stds

    def get_semi_data(self, train_count, valid_count, label_ratio,
                      re_mean=True) -> SemiData:
        candi = copy.deepcopy(self._load_records())
        self._rng.shuffle(candi)
        train = candi[:train_count]
        valid = candi[train_count:train_count + valid_count]
        semi, labeled, unlabeled, lab_idxs, unlab_idxs = self._semi_organize(
            train, label_ratio)
        semi, valid, labeled, unlabeled, lab_idxs, unlab_idxs = self._data_cache(
            [semi, valid, labeled, unlabeled, lab_idxs, unlab_idxs],
            [train_count, valid_count, label_ratio])
        means, stds = self._norm_params(semi + valid, re_mean)
        return SemiData(semi, valid, labeled, unlabeled, lab_idxs,
                        unlab_idxs, means, stds)

    # -- internals -----------------------------------------------------------
    def _semi_organize(self, train, label_ratio):
        """Reference _semiOrgan: knock labels out of (1-ratio) of train."""
        labeled_count = int(len(train) * label_ratio)
        unlabeled_count = len(train) - labeled_count
        void_idxs = set(self._rng.sample(range(len(train)), unlabeled_count))
        semi, labeled, unlabeled, lab_idxs, unlab_idxs = [], [], [], [], []
        for idx, item in enumerate(train):
            rec = copy.deepcopy(item)
            if idx in void_idxs:
                rec["islabeled"] = 0
                rec["kps"] = [[0, 0, 0] for _ in range(self.kps_count)]
                unlab_idxs.append(idx)
                unlabeled.append(rec)
            else:
                rec["islabeled"] = 1
                lab_idxs.append(idx)
                labeled.append(rec)
            semi.append(rec)
        return semi, labeled, unlabeled, lab_idxs, unlab_idxs

    def _data_cache(self, data_arrays, params):
        save_name = self.name + "".join(f"_{p}" for p in params)
        path = os.path.join(self.cache_dir, save_name + ".json")
        if os.path.isfile(path):
            with open(path, "r") as f:
                return json.load(f)
        os.makedirs(self.cache_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(data_arrays, f)
        return data_arrays

    def _norm_params(self, records, re_mean):
        if not re_mean:
            return self.default_means(), self.default_stds()
        from .arrays import load_images_bgr
        imgs = load_images_bgr([r["imagePath"] for r in records],
                               self.inp_res, cache=self.image_cache
                               ).astype(np.float32) / 255.0
        means = [float(np.mean(imgs[..., c])) for c in range(3)]
        stds = [float(np.std(imgs[..., c])) for c in range(3)]
        # reference reverses the BGR stats into RGB order before applying
        # them to BGR-ordered channels (a quirk we reproduce for parity)
        means.reverse()
        stds.reverse()
        return means, stds

    def default_means(self):
        return [0.4920829, 0.4920829, 0.4920829]

    def default_stds(self):
        return [0.16629942, 0.16629942, 0.16629942]

    @staticmethod
    def filter_single_person(records):
        """Reference multi-person filter: drop imageIDs appearing > once."""
        counts = {}
        for r in records:
            counts[r["imageID"]] = counts.get(r["imageID"], 0) + 1
        return [r for r in records if counts[r["imageID"]] == 1]

    @staticmethod
    def select_complete(kps, sel_idxs):
        """Keep selected joints only if all are present/visible; None else."""
        kps_new = [[kp[0], kp[1], 1] for i, kp in enumerate(kps)
                   if i in sel_idxs and kp[2] > 0]
        return kps_new if len(kps_new) == len(sel_idxs) else None
