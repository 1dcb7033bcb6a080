"""Host image IO of the port: PNG decode and encode, JPEG decode, the
reference's bilinear resize, and image sizes read from the file header.

Counterpart of ``ubpl_tpu/data/native_io.py`` with its C++ fast path
``ubpl_tpu/native/io.cc`` / ``io_lib.py``, under the same names
(``imread_bgr``, ``imread_resize``, ``image_size``).  The JAX package
decodes with libpng, cv2 or PIL; the machine with the card has none of
them, so the port decodes PNG itself:

  * the chunks are parsed and checked (CRC) here, the image data inflated
    with ``zlib``, and the five row filters reversed by a small C++ routine
    (``ubpl_torch/csrc/png_unfilter.cc``, no libpng) that the host compiler
    builds at first use into ``.kernel_build/`` and ``ctypes`` loads.
    Average and Paeth are sequential along a row; where no compiler is
    found, ``unfilter_plain`` (numpy for None/Sub/Up, a Python loop for the
    other two: tenths of a second per 256^2 image) does the same work;
  * 8-bit gray, RGB, RGBA and palette images, not interlaced, are decoded;
    anything else raises and names the file.  As ``cv2.imread`` does, the
    result is BGR, alpha dropped, gray repeated over three channels.

JPEG (FLIC, LSP, AP-10K) decodes with cv2, else PIL, as the JAX package
does; where neither is installed it raises ``ImportError``.

``resize_linear`` is ``cv2.resize(..., INTER_LINEAR)`` on uint8 in numpy:
half-pixel centres, 11-bit fixed-point coefficients, the vertical pass
rounded as OpenCV's vector code rounds it, and ``INTER_AREA``'s 2x2 mean
for an exact 2x downscale (OpenCV switches to it there).
"""
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CSRC = Path(__file__).resolve().parents[1] / "csrc" / "png_unfilter.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".kernel_build"
# color type -> channels (0 gray, 2 RGB, 3 palette index, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}

_lib_lock = threading.Lock()
_lib = None         # None: not tried yet; False: no compiler


# ------------------------------------------------------------------ unfilter
def _build_unfilter():
    """Compile png_unfilter.cc (once per source version) and load it;
    None where the host has no C++ compiler."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib or None
        cxx = next((c for c in ("c++", "g++", "clang++") if shutil.which(c)),
                   None)
        if cxx is None:
            _lib = False
            return None
        src = _CSRC.read_bytes()
        so = BUILD_DIR / f"libubpl_png_{hashlib.sha1(src).hexdigest()[:12]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-o", tmp,
                                str(_CSRC)], check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, so)   # atomic: concurrent builders agree
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(str(so))
        lib.ubpl_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int]
        lib.ubpl_png_unfilter.restype = ctypes.c_int
        _lib = lib
        return lib


def unfilter_plain(raw, h, stride, bpp):
    """Reverse the PNG row filters in numpy and Python: ``raw`` holds h
    rows of (1 + stride) bytes.  Returns [h, stride] uint8.  Reference
    version of the C++ routine (and what runs without a compiler)."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8
                            ).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            a_row = [0] * bpp + [0] * stride
            b, filt = prev.tolist(), line.tolist()
            for x in range(stride):
                a = a_row[x]
                if kind == 3:
                    pred = (a + b[x]) >> 1
                else:
                    c = b[x - bpp] if x >= bpp else 0
                    p = a + b[x] - c
                    pa, pb, pc = abs(p - a), abs(p - b[x]), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b[x] if pb <= pc else c)
                a_row[x + bpp] = (filt[x] + pred) & 255
            cur = np.asarray(a_row[bpp:], np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def unfilter(raw, h, stride, bpp):
    """``unfilter_plain`` through the compiled routine where there is one."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, not "
                         f"{h * (stride + 1)}")
    lib = _build_unfilter()
    if lib is None:
        return unfilter_plain(raw, h, stride, bpp)
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((h, stride), np.uint8)
    bad = lib.ubpl_png_unfilter(src.ctypes.data, out.ctypes.data, h, stride,
                                bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type "
                         f"{src[(bad - 1) * (stride + 1)]}")
    return out


# ----------------------------------------------------------------------- PNG
def _chunks(data, path):
    """(type, payload) of every chunk, CRC-checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def decode_png(data, path="<bytes>"):
    """PNG bytes -> ([H, W, C] uint8 in the file's channel order, palette):
    gray C=1, RGB 3, RGBA 4; a palette image gives its indices (C=1) and
    its PLTE entries [n, 3] (else the palette is None)."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type "
            f"{color}, interlace {interlace}); decoded are 8-bit gray, RGB, "
            "RGBA and palette images without interlace")
    ch = _CHANNELS[color]
    try:
        pixels = unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    except (ValueError, zlib.error) as e:
        raise ValueError(f"{path}: {e}") from None
    img = pixels.reshape(h, w, ch)
    if color != 3:
        return img, None
    if palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    if int(img.max(initial=0)) >= len(palette):
        raise ValueError(f"{path}: palette index out of range")
    return img, palette


def read_png(path):
    """A PNG file's pixels and palette, as ``decode_png`` gives them."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def read_png_bgr(path):
    """A PNG file as cv2.imread gives it: [H, W, 3] uint8 BGR."""
    img, palette = read_png(path)
    if palette is not None:
        img = palette[img[..., 0]]
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])


def write_png(path, img):
    """Write uint8 [H, W] gray, [H, W, 3] BGR or [H, W, 4] BGRA (cv2's
    order) as a PNG file: Sub filter on every row, zlib level 6."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"write_png: shape {img.shape} is not gray, BGR "
                         "or BGRA")
    h, w, ch = img.shape
    color = {1: 0, 3: 2, 4: 6}[ch]
    if ch >= 3:                                   # BGR(A) -> RGB(A)
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=2)
    rows = np.ascontiguousarray(img).reshape(h, w * ch)
    sub = rows.copy()
    sub[:, ch:] = rows[:, ch:] - rows[:, :-ch]    # uint8 wraps: filter 1
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------- JPEG
def _read_other_bgr(path):
    """JPEG (or anything else) through cv2, else PIL, as the JAX package
    reads it."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        return img
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"{path}: decoding this format needs cv2 (opencv-python) or PIL "
            "(pillow), and neither is installed; the port decodes only PNG "
            "by itself") from None
    with Image.open(path) as im:
        return np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])


def _is_png(path):
    with open(path, "rb") as f:
        return f.read(8) == PNG_SIGNATURE


def imread_bgr(path):
    """[H, W, 3] uint8 BGR (the reference's cv2 order)."""
    if _is_png(path):
        return read_png_bgr(path)
    return _read_other_bgr(path)


# -------------------------------------------------------------------- resize
_COEF_BITS = 11
_COEF_ONE = 1 << _COEF_BITS


def _taps(dst, src, clamp_weights, fixed=True):
    """OpenCV's INTER_LINEAR source index pairs and 11-bit weights along
    one axis (resize.cpp: float32 offsets; indices clipped to the image;
    the horizontal pass also zeroes the weight of a clipped tap, the
    vertical one keeps it)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
         ).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        f[(s < 0) | (s >= src - 1)] = 0.0
        s = np.clip(s, 0, src - 1)
    if fixed:
        w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_ONE)).astype(
            np.int64)
        w1 = np.rint(f * np.float32(_COEF_ONE)).astype(np.int64)
    else:
        w0, w1 = np.float32(1.0) - f, f
    return (np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1)


def resize_linear(img, width, height):
    """``cv2.resize(img, (width, height))`` (INTER_LINEAR) for uint8 or
    float32 [H, W] or [H, W, C] images (float32 in float arithmetic, as
    OpenCV computes it, to float rounding)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize_linear takes uint8 or float32, not "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    fixed = img.dtype == np.uint8
    x = img.astype(np.int64) if fixed else img
    if w == 2 * width and h == 2 * height:        # OpenCV takes INTER_AREA
        s = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2])
        return ((s + 2) >> 2).astype(np.uint8) if fixed else s * 0.25
    xs0, xs1, a0, a1 = _taps(width, w, True, fixed)
    ys0, ys1, b0, b1 = _taps(height, h, False, fixed)
    shape = (1, -1) + (1,) * (img.ndim - 2)
    rows = x[:, xs0] * a0.reshape(shape) + x[:, xs1] * a1.reshape(shape)
    bshape = (-1,) + (1,) * (img.ndim - 1)
    if not fixed:
        return rows[ys0] * b0.reshape(bshape) + rows[ys1] * b1.reshape(bshape)
    # OpenCV's vector path: (((r0 >> 4) * b0) >> 16) + same for r1,
    # then a rounding shift by 2
    t = (((rows[ys0] >> 4) * b0.reshape(bshape)) >> 16) \
        + (((rows[ys1] >> 4) * b1.reshape(bshape)) >> 16)
    return np.clip((t + 2) >> 2, 0, 255).astype(np.uint8)


def imread_resize(path, inp_res):
    """Decode and resize to [inp_res, inp_res, 3] BGR, as the reference's
    ``image_resize`` (cv2.resize, not aspect-preserving)."""
    img = imread_bgr(path)
    if img.shape[0] == inp_res and img.shape[1] == inp_res:
        return np.ascontiguousarray(img)
    return resize_linear(img, inp_res, inp_res)


# ---------------------------------------------------------------------- size
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF}


def image_size(path):
    """(width, height) from the PNG IHDR or the JPEG SOF marker, without
    decoding the image."""
    with open(path, "rb") as f:
        data = f.read(24)
        if data[:8] == PNG_SIGNATURE and data[12:16] == b"IHDR":
            return struct.unpack(">II", data[16:24])
        if data[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: neither PNG nor JPEG")
        f.seek(2)
        while True:
            byte = f.read(1)
            if not byte:
                break
            if byte != b"\xff":
                continue
            marker = f.read(1)
            while marker == b"\xff":              # fill bytes
                marker = f.read(1)
            if not marker:
                break
            m = marker[0]
            if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01:
                continue                          # no payload
            seg = f.read(2)
            if len(seg) < 2:
                break
            (n,) = struct.unpack(">H", seg)
            if m in _SOF:
                h, w = struct.unpack(">xHH", f.read(5))
                return (w, h)
            f.seek(n - 2, 1)
    raise ValueError(f"{path}: JPEG without a frame header")
