"""The port's data layer (``ubpl_torch.data``) against ``ubpl_tpu.data`` on
the same archives: the six pose datasources in the reference's on-disk
layouts (``tests/fixture_archives.py`` builders, and a Mouse tree written
here), their records, splits, JSON split caches, means and materialised
arrays; the occluder bank, the VOC harvest and ``composite_occluders``;
and a trainer set up from a dataset on disk."""
import json
import os
import xml.etree.ElementTree as ET

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import fixture_archives as FA
from ubpl_torch.config import Config
from ubpl_torch.data import arrays as PA
from ubpl_torch.data import occluders as PO
from ubpl_torch.data.native_io import write_png
from ubpl_torch.data.sources import DATASOURCES, get_datasource
from ubpl_torch.ops import augment as A

# source -> (train_count, valid_count, label_ratio) within its fixture
SPLITS = {"Mouse": (8, 4, 0.5), "FLIC": (3, 2, 0.5), "LSP": (4, 3, 0.5),
          "AP10K": (3, 1, 0.5), "FLY": (3, 1, 0.5), "Pranav": (3, 2, 0.5)}
SEED = 1388


def make_mouse(data_root, n=12, seed=6):
    """The reference Mouse layout: croppeds_bbox/labels_normal.json (a list
    of {imageID, kps [[x, y], ...9]}) and images/{imageID}.png; half the
    crops at 256x256, half at 96x80."""
    base = os.path.join(data_root, "pose", "mouse", "croppeds_bbox")
    rng = np.random.default_rng(seed)
    anns = []
    for i in range(n):
        h, w = (256, 256) if i % 2 else (80, 96)
        write_png(os.path.join(base, "images", f"m{i:03d}.png"),
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        anns.append({"imageID": f"m{i:03d}",
                     "kps": rng.uniform(1, min(h, w) - 1, (9, 2)).tolist()})
    with open(os.path.join(base, "labels_normal.json"), "w") as f:
        json.dump(anns, f)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    make_mouse(root)
    FA.make_flic(root, n=6)
    FA.make_lsp(root, n_lsp=4, n_lspet=5)
    FA.make_ap10k(root, n=5)
    FA.make_fly(root, n=4)
    FA.make_pranav(root, n=5)
    return root


@pytest.fixture(scope="module")
def both(data_root, tmp_path_factory):
    """Per source: the JAX package's and the port's get_semi_data and
    materialised splits, each with its own cache directory."""
    from ubpl_tpu.data import get_datasource as jget
    from ubpl_tpu.data import materialize as jmaterialize
    out = {}
    for name, (n_train, n_valid, ratio) in SPLITS.items():
        res = {}
        for side, get in (("jax", jget), ("port", get_datasource)):
            cache = str(tmp_path_factory.mktemp(f"cache_{side}_{name}"))
            ds = get(name, data_root=data_root, cache_dir=cache, seed=SEED)
            semi = ds.get_semi_data(n_train, n_valid, ratio)
            if side == "jax":
                mats = [jmaterialize(r, 64) for r in (semi.semi_train,
                                                      semi.valid)]
            else:
                mats = [PA.materialize(r, 64, cache=ds.image_cache)
                        for r in (semi.semi_train, semi.valid)]
            files = sorted(os.listdir(cache))
            with open(os.path.join(cache, files[0]), "rb") as f:
                raw = f.read()
            res[side] = {"ds": ds, "semi": semi, "arrays": mats,
                         "cache_name": files, "cache_bytes": raw}
        out[name] = res
    return out


@pytest.mark.parametrize("name", list(SPLITS))
def test_records_match(data_root, name):
    """The same records, in the same order, with the same metadata."""
    from ubpl_tpu.data import get_datasource as jget
    ours = get_datasource(name, data_root=data_root, seed=SEED)
    theirs = jget(name, data_root=data_root, seed=SEED)
    assert ours._load_records() == theirs._load_records()
    for attr in ("name", "img_type", "inp_res", "out_res", "pck_ref",
                 "pck_thr", "sel_kp_idxs", "kps_count"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr


@pytest.mark.parametrize("name", list(SPLITS))
def test_semi_split_matches(both, name):
    """get_semi_data: the same split, labeled/unlabeled records and
    indices (random.Random(seed) as the JAX package draws them)."""
    a, b = both[name]["port"]["semi"], both[name]["jax"]["semi"]
    for field in ("semi_train", "valid", "labeled", "unlabeled",
                  "labeled_idxs", "unlabeled_idxs"):
        assert getattr(a, field) == getattr(b, field), field
    assert len(a.semi_train) == SPLITS[name][0]


@pytest.mark.parametrize("name", list(SPLITS))
def test_split_cache_is_byte_identical(both, name):
    """The JSON split cache: same file name, same bytes."""
    a, b = both[name]["port"], both[name]["jax"]
    assert a["cache_name"] == b["cache_name"]
    assert a["cache_bytes"] == b["cache_bytes"]


@pytest.mark.parametrize("name", list(SPLITS))
def test_means_and_stds_match(both, name):
    """Channel means and stds over train + valid (BGR->RGB reversal
    kept): within 1e-4."""
    a, b = both[name]["port"]["semi"], both[name]["jax"]["semi"]
    np.testing.assert_allclose(a.means, b.means, atol=1e-4)
    np.testing.assert_allclose(a.stds, b.stds, atol=1e-4)


@pytest.mark.parametrize("name", list(SPLITS))
def test_materialize_matches(both, name):
    """materialize at 64: images within 1 level (PNG decodes exactly; the
    resize is cv2's to 1 level), kps and kps_test to 1e-6, labels and ids
    equal."""
    for ours, theirs in zip(both[name]["port"]["arrays"],
                            both[name]["jax"]["arrays"]):
        d = np.abs(ours.images.astype(int) - theirs.images.astype(int))
        assert ours.images.shape == theirs.images.shape
        assert d.max() <= 1
        np.testing.assert_allclose(ours.kps, theirs.kps, atol=1e-6)
        np.testing.assert_allclose(ours.kps_test, theirs.kps_test, atol=1e-6)
        np.testing.assert_array_equal(ours.islabeled, theirs.islabeled)
        assert ours.image_ids == theirs.image_ids


def test_png_at_inp_res_is_exact(data_root):
    """A PNG already at inp_res is copied, not resized: exactly cv2's
    decode."""
    from ubpl_tpu.data import materialize as jmaterialize
    ds = get_datasource("Mouse", data_root=data_root, seed=SEED)
    recs = [r for r in ds._load_records()
            if cv2.imread(r["imagePath"]).shape[0] == 256]
    np.testing.assert_array_equal(PA.materialize(recs, 256).images,
                                  jmaterialize(recs, 256).images)


def test_image_cache_decodes_each_image_once(data_root, monkeypatch):
    """get_semi_data decodes each image once at the source's inp_res for
    the means; materialize at the same resolution reuses them."""
    calls = []
    real = PA.imread_resize
    monkeypatch.setattr(PA, "imread_resize",
                        lambda p, r: calls.append((p, r)) or real(p, r))
    ds = get_datasource("Pranav", data_root=data_root, seed=SEED,
                        cache_dir=os.path.join(data_root, "cache_once"))
    semi = ds.get_semi_data(3, 2, 0.5)
    n = len(calls)
    assert n == len(set(calls)) == 5
    PA.materialize(semi.semi_train, ds.inp_res, cache=ds.image_cache)
    assert len(calls) == n


def test_pad_to_multiple():
    """Padding rows are zeros and never change the real ones."""
    arr = PA.PoseArrays(np.ones((5, 2, 2, 3), np.uint8),
                        np.ones((5, 1, 3), np.float32),
                        np.ones((5, 1, 3), np.float32),
                        np.ones((5,), np.int32), list("abcde"))
    assert PA.pad_to_multiple(arr, 1) is arr
    out = PA.pad_to_multiple(arr, 4)
    assert out.images.shape[0] == 8 and out.images[5:].sum() == 0
    assert out.image_ids[-3:] == ["", "", ""]


def test_every_source_is_registered():
    from ubpl_tpu.data.sources import DATASOURCES as J
    assert list(DATASOURCES) == list(J)


# ----------------------------------------------------------- the trainer
def test_trainer_on_disk_data(data_root, tmp_path):
    """A trainer set up from Mouse on disk: the datasource's metadata in
    the config (force_inp_res/force_out_res honoured), the split's indices
    and means, and the materialised arrays on the device."""
    from ubpl_torch.train.supervised import SupervisedTrainer
    cfg = Config(data_source="Mouse", data_root=data_root,
                 cache_dir=str(tmp_path), train_count=8, valid_count=4,
                 label_ratio=0.5, model="HG1", force_inp_res=64,
                 force_out_res=16, compute_dtype="float32")
    tr = SupervisedTrainer(cfg, device="cpu")
    ds = get_datasource("Mouse", data_root=data_root, seed=cfg.seed,
                        cache_dir=str(tmp_path))
    semi = ds.get_semi_data(8, 4, 0.5)
    assert (cfg.kps_count, cfg.inp_res, cfg.out_res) == (9, 64, 16)
    assert cfg.pck_ref == (1, 2) and cfg.pck_thr == 0.2
    assert tr.labeled_idxs == semi.labeled_idxs
    assert tr.unlabeled_idxs == semi.unlabeled_idxs
    assert tr.n_valid == 4
    np.testing.assert_allclose(tr.means.numpy(), semi.means, rtol=1e-6)
    want = PA.materialize(semi.semi_train, 64)
    np.testing.assert_array_equal(tr.train_data.images.numpy(), want.images)
    np.testing.assert_array_equal(tr.train_data.kps.numpy(), want.kps)


# ------------------------------------------------------------- occlusion
def test_synthetic_bank_matches_jax():
    """build_occluder_bank without VOC: the JAX package's bank exactly."""
    from ubpl_tpu.data.occluders import build_occluder_bank as jbuild
    for a, b in zip(PO.build_occluder_bank(seed=3), jbuild(seed=3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [3, 8, 9])
def test_ellipse_kernel_and_erode_match_cv2(size):
    k = PO.ellipse_kernel(size)
    np.testing.assert_array_equal(
        k, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size)))
    mask = (np.random.default_rng(size).random((30, 41)) > 0.3
            ).astype(np.uint8) * 255
    np.testing.assert_array_equal(PO.erode(mask, k), cv2.erode(mask, k))


def _make_voc(root):
    """A two-image VOC2012 tree: JPEGImages, SegmentationObject (palette
    PNGs of object indices) and Annotations; one image unsegmented, one
    object an animal (both skipped), one object too small."""
    rng = np.random.default_rng(0)
    for d in ("JPEGImages", "SegmentationObject", "Annotations"):
        os.makedirs(os.path.join(root, d))
    objs = {"a": [("chair", (10, 8, 70, 60)), ("dog", (5, 5, 40, 40)),
                  ("bottle", (60, 50, 70, 58))],
            "b": [("car", (0, 0, 50, 50))]}
    for stem, items in objs.items():
        img = rng.integers(0, 256, (72, 90, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "JPEGImages",
                                               f"{stem}.jpg"))
        seg = np.zeros((72, 90), np.uint8)
        ann = ET.Element("annotation")
        ET.SubElement(ann, "filename").text = f"{stem}.jpg"
        ET.SubElement(ann, "segmented").text = "1" if stem == "a" else "0"
        for i, (cls, (x0, y0, x1, y1)) in enumerate(items):
            yy, xx = np.mgrid[y0:y1, x0:x1]
            blob = (((xx - (x0 + x1) / 2) / ((x1 - x0) / 2)) ** 2
                    + ((yy - (y0 + y1) / 2) / ((y1 - y0) / 2)) ** 2) < 1
            seg[y0:y1, x0:x1][blob] = i + 1
            o = ET.SubElement(ann, "object")
            ET.SubElement(o, "name").text = cls
            bb = ET.SubElement(o, "bndbox")
            for k, v in zip(("xmin", "ymin", "xmax", "ymax"),
                            (x0, y0, x1, y1)):
                ET.SubElement(bb, k).text = str(v)
        pal = Image.fromarray(seg, mode="P")
        pal.putpalette([0, 0, 0, 128, 0, 0, 0, 128, 0, 128, 128, 0] * 64)
        pal.save(os.path.join(root, "SegmentationObject", f"{stem}.png"))
        ET.ElementTree(ann).write(os.path.join(root, "Annotations",
                                               f"{stem}.xml"))


def test_voc_harvest_matches_jax(tmp_path):
    """harvest_voc_occluders on a VOC fixture: the same patches as the JAX
    package's (cv2 + PIL) harvest.  The port decodes the JPEG with cv2
    where the JAX package takes PIL: patches within 2/255, alpha exact."""
    from ubpl_tpu.data.occluders import harvest_voc_occluders as jharvest
    voc = str(tmp_path / "VOC2012")
    _make_voc(voc)
    ours, theirs = PO.harvest_voc_occluders(voc), jharvest(voc)
    assert len(ours) == len(theirs) == 1
    assert ours[0].shape == theirs[0].shape
    np.testing.assert_array_equal(ours[0][..., 3], theirs[0][..., 3])
    np.testing.assert_allclose(ours[0], theirs[0], atol=2 / 255 + 1e-7)
    assert (ours[0][..., 3] == 192 / 255).any()


def _jax_occlusion_draws(key, B, n, nbank, scale_range=(0.2, 0.7),
                         aug_rate=0.5):
    """The draws JAX's composite_occluders makes from ``key``, as the
    port's OcclusionDraws."""
    r_apply, r_paste = jax.random.split(key)
    apply = np.asarray(jax.random.uniform(r_apply, (B,)) < aug_rate)
    pick = np.zeros((B, n), np.int64)
    scale = np.zeros((B, n), np.float32)
    pos = np.zeros((B, n, 2), np.float32)
    for b, r in enumerate(jax.random.split(r_paste, B)):
        for i in range(n):
            r, r_pick, r_scale, r_pos = jax.random.split(r, 4)
            pick[b, i] = int(jax.random.randint(r_pick, (), 0, nbank))
            scale[b, i] = float(jax.random.uniform(
                r_scale, (), minval=scale_range[0], maxval=scale_range[1]))
            pos[b, i] = np.asarray(jax.random.uniform(r_pos, (2,),
                                                      minval=0.1,
                                                      maxval=0.9))
    return A.OcclusionDraws(torch.as_tensor(np.array(apply)),
                            torch.as_tensor(pick),
                            torch.as_tensor(scale), torch.as_tensor(pos))


@pytest.mark.parametrize("seed,n_occ", [(0, 3), (4, 8)])
def test_composite_occluders_matches_jax(seed, n_occ):
    """composite_occluders fed JAX's draws reproduces JAX's on the same
    bank (48x40 images, a 12-patch synthetic bank of 16^2): atol 1e-6;
    some samples occluded, some not."""
    from ubpl_tpu.ops.augment import composite_occluders as jcomp
    B, H, W = 4, 48, 40
    rgb, alpha = PO.build_occluder_bank(bank_size=12, patch_res=16, seed=1)
    imgs = np.random.default_rng(seed).random((B, H, W, 3), np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jcomp(key, jnp.asarray(imgs), jnp.asarray(rgb),
                            jnp.asarray(alpha), n_occ))
    draws = _jax_occlusion_draws(key, B, n_occ, 12)
    got = A.composite_occluders(torch.as_tensor(imgs).permute(0, 3, 1, 2),
                                torch.as_tensor(rgb), torch.as_tensor(alpha),
                                draws).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    changed = np.abs(got - imgs).reshape(B, -1).max(1) > 0
    assert changed.any() and changed.tolist() == draws.apply.tolist()


def test_draw_occlusion_ranges():
    g = torch.Generator().manual_seed(0)
    d = A.draw_occlusion(64, 5, 7, g, "cpu")
    assert d.pick.shape == (64, 5) and 0 <= int(d.pick.min())
    assert int(d.pick.max()) < 7
    assert 0.2 <= float(d.scale.min()) and float(d.scale.max()) <= 0.7
    assert 0.1 <= float(d.pos.min()) and float(d.pos.max()) <= 0.9
    assert 0 < int(d.apply.sum()) < 64


def test_occluded_training_views(tmp_path):
    """use_occlusion builds the synthetic bank on the device and the
    trainer's views paste from it (their images differ from the same
    draws without occlusion); use_occlusion_ema alone builds no bank."""
    from ubpl_torch.train.dualpose_ubpl import DualPoseUBPLTrainer
    kw = dict(model="HG1", synthetic_data=True, synthetic_kps=3, inp_res=32,
              out_res=8, train_count=8, valid_count=2, train_bs=4,
              train_bs_labeled=2, compute_dtype="float32")
    tr = DualPoseUBPLTrainer(Config(use_occlusion=True, **kw), device="cpu")
    assert tr.occluder_bank[0].shape == (64, 64, 64, 3)
    imgs, kps, _ = tr.fetch_batch(tr.train_data, [0, 1, 2, 3])
    g = tr.generator.get_state()
    occluded = tr.augmented_view(imgs, kps)
    tr.generator.set_state(g)
    plain = tr.augmented_view(imgs, kps, occlude=False)
    assert not torch.equal(occluded.images, plain.images)
    assert torch.equal(occluded.heatmaps, plain.heatmaps)
    only_ema = DualPoseUBPLTrainer(Config(use_occlusion_ema=True, **kw),
                                   device="cpu")
    assert only_ema.occluder_bank is None
