"""The port's host image IO (``ubpl_torch.data.native_io``) against cv2 and
PIL: PNG decode (every colour type it takes, every row filter, the
compiled routine against its plain version), ``write_png``, the
INTER_LINEAR resize, ``image_size``, and the errors.  No JAX."""
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from ubpl_torch.data import native_io as N


def _smooth(h, w, c, seed=0):
    """An image with gradients and noise, so that adaptive filters vary."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (np.sin(xx / 7.0) * 60 + np.cos(yy / 5.0) * 50 + 128)[..., None]
    img = np.clip(base + rng.integers(0, 30, (h, w, c)), 0, 255)
    return img.astype(np.uint8)


def _png_with_filter(path, rgb, kind):
    """Encode ``rgb`` [H, W, 3] with PNG filter type ``kind`` on every row
    (a test-only encoder: cv2 and PIL choose their filters themselves)."""
    h, w, ch = rgb.shape
    x = rgb.reshape(h, w * ch).astype(np.int64)
    up = np.vstack([np.zeros((1, w * ch), np.int64), x[:-1]])
    left = np.hstack([np.zeros((h, ch), np.int64), x[:, :-ch]])
    ul = np.hstack([np.zeros((h, ch), np.int64), up[:, :-ch]])
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - ul
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
    rows = np.hstack([np.full((h, 1), kind), (x - pred) % 256])
    raw = rows.astype(np.uint8).tobytes()

    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(
            ">I", zlib.crc32(t + b))

    with open(path, "wb") as f:
        f.write(N.PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _write(tmp_path, how):
    """One PNG written by cv2 or PIL (or by the filter encoder)."""
    path = str(tmp_path / f"{how}.png")
    if how == "cv2_gray":
        cv2.imwrite(path, _smooth(41, 29, 1)[..., 0])
    elif how == "cv2_bgr":
        cv2.imwrite(path, _smooth(37, 53, 3))
    elif how == "cv2_bgra":
        cv2.imwrite(path, _smooth(33, 47, 4))
    elif how == "pil_gray":
        Image.fromarray(_smooth(35, 51, 1)[..., 0]).save(path)
    elif how == "pil_rgb":
        Image.fromarray(_smooth(35, 51, 3)).save(path)
    elif how == "pil_rgba":
        Image.fromarray(_smooth(31, 45, 4)).save(path)
    elif how == "pil_palette":
        Image.fromarray(_smooth(35, 51, 3)).convert(
            "P", palette=Image.ADAPTIVE, colors=256).save(path)
    else:
        _png_with_filter(path, _smooth(23, 19, 3, seed=1), int(how[-1]))
    return path


WRITERS = ["cv2_gray", "cv2_bgr", "cv2_bgra", "pil_gray", "pil_rgb",
           "pil_rgba", "pil_palette", "filter0", "filter1", "filter2",
           "filter3", "filter4"]


@pytest.mark.parametrize("how", WRITERS)
def test_png_decode_equals_cv2(tmp_path, how):
    """imread_bgr of a PNG is cv2.imread's array, exactly."""
    path = _write(tmp_path, how)
    got = N.imread_bgr(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.imread(path))


def _filtered_rows(path):
    with open(path, "rb") as f:
        chunks = list(N._chunks(f.read(), path))
    w, h, _, color = struct.unpack(">IIBB", chunks[0][1][:10])
    ch = N._CHANNELS[color]
    raw = zlib.decompress(b"".join(b for k, b in chunks if k == b"IDAT"))
    return raw, h, w * ch, ch


@pytest.mark.parametrize("how", ["pil_rgb", "pil_rgba", "filter3",
                                 "filter4"])
def test_compiled_unfilter_equals_plain(tmp_path, how):
    """The compiled routine and the numpy/Python reference reverse the
    same rows identically (PIL writes Sub, Up and Paeth rows; the filter
    encoder Average and Paeth)."""
    raw, h, stride, bpp = _filtered_rows(_write(tmp_path, how))
    assert {raw[i * (stride + 1)] for i in range(h)} - {0}
    assert N._build_unfilter() is not None
    np.testing.assert_array_equal(N.unfilter(raw, h, stride, bpp),
                                  N.unfilter_plain(raw, h, stride, bpp))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_write_png_round_trips(tmp_path, channels):
    """write_png takes cv2's channel order: cv2.imread and the port read
    back the image (gray repeated, alpha dropped), and PIL sees its size
    and mode."""
    img = _smooth(27, 38, channels, seed=channels)
    if channels == 1:
        img = img[..., 0]
    path = str(tmp_path / "w.png")
    N.write_png(path, img)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(N.imread_bgr(path), cv2.imread(path))
    with Image.open(path) as im:
        assert im.size == (38, 27)
        assert im.mode == {1: "L", 3: "RGB", 4: "RGBA"}[channels]


@pytest.mark.parametrize("src,dst", [
    ((240, 320), (256, 256)),       # non-square, up in y, down in x
    ((30, 40), (64, 64)),           # up
    ((480, 640), (256, 256)),       # down
    ((512, 512), (256, 256)),       # exact 2x: OpenCV's INTER_AREA
    ((220, 240), (256, 256)),
    ((77, 133), (256, 256)),
    ((300, 200), (128, 96)),        # non-square output
    ((100, 100), (64, 64)),
])
def test_resize_matches_cv2(src, dst):
    """resize_linear vs cv2.resize (INTER_LINEAR) on uint8: within 1 level
    everywhere, >= 99.9% of pixels exact."""
    img = np.random.default_rng(sum(src)).integers(0, 256, src + (3,),
                                                   dtype=np.uint8)
    want = cv2.resize(img, dst[::-1]).astype(np.int64)
    got = N.resize_linear(img, dst[1], dst[0]).astype(np.int64)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() <= 1
    assert (d == 0).mean() >= 0.999


@pytest.mark.parametrize("shape", [(45, 61, 4), (45, 61)])
def test_resize_float32_matches_cv2(shape):
    """The float32 path (occluder patches) to float rounding."""
    img = np.random.default_rng(2).random(shape, dtype=np.float32)
    want = cv2.resize(img, (64, 64))
    np.testing.assert_allclose(N.resize_linear(img, 64, 64), want,
                               atol=1e-6)


def test_imread_resize_matches_cv2(tmp_path):
    """imread_resize = cv2.resize(cv2.imread(path), (R, R)) for a PNG."""
    path = _write(tmp_path, "pil_rgb")
    want = cv2.resize(cv2.imread(path), (64, 64)).astype(int)
    assert np.abs(N.imread_resize(path, 64).astype(int) - want).max() <= 1
    assert N.imread_resize(path, 64).shape == (64, 64, 3)


@pytest.mark.parametrize("kind", ["png_cv2", "png_pil", "jpg_cv2",
                                  "jpg_pil_progressive", "jpg_pil_gray"])
def test_image_size_equals_pil(tmp_path, kind):
    """(width, height) from the header equals PIL's, PNG and JPEG."""
    img = _smooth(43, 71, 3)
    path = str(tmp_path / f"x.{kind[:3]}")
    if kind == "png_cv2" or kind == "jpg_cv2":
        cv2.imwrite(path, img)
    elif kind == "png_pil":
        Image.fromarray(img).save(path)
    elif kind == "jpg_pil_progressive":
        Image.fromarray(img).save(path, progressive=True)
    else:
        Image.fromarray(img[..., 0]).save(path)
    with Image.open(path) as im:
        assert N.image_size(path) == im.size == (71, 43)


def test_jpeg_decodes_as_cv2(tmp_path):
    """A JPEG goes through cv2 as in the JAX package: the same array."""
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, _smooth(43, 71, 3))
    np.testing.assert_array_equal(N.imread_bgr(path), cv2.imread(path))


def test_jpeg_without_decoder_raises(tmp_path, monkeypatch):
    """With neither cv2 nor PIL importable a JPEG raises ImportError naming
    both; a PNG still decodes."""
    jpg, png = str(tmp_path / "x.jpg"), str(tmp_path / "x.png")
    cv2.imwrite(jpg, _smooth(9, 9, 3))
    cv2.imwrite(png, _smooth(9, 9, 3))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="cv2.*PIL"):
        N.imread_bgr(jpg)
    assert N.imread_bgr(png).shape == (9, 9, 3)


@pytest.mark.parametrize("case", ["16bit", "interlaced", "palette4",
                                  "gray_alpha", "bad_crc"])
def test_unsupported_png_raises_naming_the_file(tmp_path, case):
    """What the decoder does not take raises ValueError with the path."""
    path = str(tmp_path / f"{case}.png")
    img = _smooth(12, 10, 3)
    if case == "16bit":
        cv2.imwrite(path, img.astype(np.uint16) * 257)
    elif case == "interlaced":
        N.write_png(path, img)      # then flag it as Adam7 in the IHDR
        with open(path, "rb") as f:
            data = bytearray(f.read())
        data[28] = 1
        data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
        with open(path, "wb") as f:
            f.write(data)
    elif case == "palette4":
        Image.fromarray(img).convert("P", palette=Image.ADAPTIVE,
                                     colors=8).save(path)
    elif case == "gray_alpha":
        Image.fromarray(img[..., 0]).convert("LA").save(path)
    else:
        N.write_png(path, img)
        with open(path, "rb") as f:
            data = bytearray(f.read())
        data[-20] ^= 0xFF           # inside IDAT: the CRC no longer fits
        with open(path, "wb") as f:
            f.write(data)
    with pytest.raises(ValueError, match=os.path.basename(path)):
        N.imread_bgr(path)
