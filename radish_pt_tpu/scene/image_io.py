"""Image I/O: linear-float loading and PNG/HDR saving, on the standard
library and numpy alone.

Replaces the reference's stb-based ``Image`` class
(``/root/reference/src/image.cpp:14-90``): PNG images are loaded with gamma
1.0 (raw values as linear, matching ``stbi_ldr_to_hdr_gamma(1.f)`` at
scene.cpp:109), Radiance ``.hdr`` as float.  Device-side bilinear sampling
lives in :mod:`radish_pt_tpu.scene.device_scene`.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# Radiance HDR (.hdr, RGBE) — own reader/writer (the reference relies on stb).
# ---------------------------------------------------------------------------


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.exp2(e - 136.0), 0.0)  # 2^(e-128) / 256
    return rgbe[..., :3] * scale[..., None]


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    nz = maxc >= 1e-32
    m, e = np.frexp(np.where(nz, maxc, 0.5))  # maxc = m * 2^e, m in [0.5, 1)
    scale = m * 256.0 / np.where(nz, maxc, 1.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    out[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    return out


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance RGBE file (flat or RLE scanlines) to float32 [H,W,3]."""
    with open(path, "rb") as f:
        data = f.read()
    # header ends at empty line, then resolution line
    pos = 0
    lines = []
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
        lines.append(line)
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {res!r}")
    h, w = int(res[1]), int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    img = np.empty((h, w, 4), np.uint8)
    p = 0
    for row in range(h):
        if (
            w >= 8
            and w < 32768
            and p + 4 <= len(buf)
            and buf[p] == 2
            and buf[p + 1] == 2
            and (int(buf[p + 2]) << 8 | int(buf[p + 3])) == w
        ):
            # new-style RLE: 4 channel planes
            p += 4
            for ch in range(4):
                x = 0
                while x < w:
                    count = int(buf[p])
                    p += 1
                    if count > 128:  # run
                        img[row, x : x + count - 128, ch] = buf[p]
                        x += count - 128
                        p += 1
                    else:  # literal
                        img[row, x : x + count, ch] = buf[p : p + count]
                        x += count
                        p += count
        else:
            flat = buf[p : p + w * 4].reshape(w, 4)
            img[row] = flat
            p += w * 4
    return _rgbe_to_float(img)


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write float32 RGB [H,W,3] as a flat (non-RLE) Radiance file."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    rgbe = _float_to_rgbe(img[..., :3])
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


# ---------------------------------------------------------------------------
# PNG — own reader/writer on zlib: 8-bit, non-interlaced, gray / gray+alpha /
# RGB / RGBA / palette, all five scanline filters.
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples


def _png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters; returns uint8 [h, stride]."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 1:  # Sub: prefix sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average / Paeth: left-to-right dependency
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG to uint8 [H, W, C].  C is 1 (gray),
    2 (gray+alpha), 3 (RGB, also palette images) or 4 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace}); need 8-bit non-interlaced"
        )
    ch = _PNG_CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    img = _png_unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    if color == 3:
        img = palette[img[..., 0]]
    return img


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray) -> None:
    """Write uint8 [H, W] or [H, W, C] (C = 1..4) as an 8-bit PNG."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * ch)], axis=1
    )  # filter type 0 on every scanline
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def load_image(path: str, flip_vertical: bool = True) -> np.ndarray:
    """Load a ``.png`` or ``.hdr`` image as linear float32 RGB [H, W, 3].

    PNG values are divided by 255 with NO gamma decode (gamma 1.0, like the
    reference); gray is replicated and alpha dropped.  ``flip_vertical``
    mirrors ``stbi_set_flip_vertically_on_load`` (on for textures, off for
    env maps — scene.cpp:110,134-136).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        img = read_hdr(path)
    elif ext == ".png":
        img = read_png(path)
        img = img[..., :1] if img.shape[-1] < 3 else img[..., :3]
        img = img.astype(np.float32) / 255.0
    else:
        raise ValueError(f"{path}: unsupported image format (use .png or .hdr)")
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if flip_vertical:
        img = img[::-1]
    return np.ascontiguousarray(img, dtype=np.float32)


def save_image(path: str, img: np.ndarray) -> None:
    """Save float RGB [H, W, 3]: in [0,1] to 8-bit ``.png``, or raw HDR
    floats to ``.hdr``."""
    ext = os.path.splitext(path)[1].lower()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if ext == ".hdr":
        write_hdr(path, img)
    elif ext == ".png":
        arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
        write_png(path, arr)
    else:
        raise ValueError(f"{path}: unsupported image format (use .png or .hdr)")
