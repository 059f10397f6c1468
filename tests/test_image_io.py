"""PNG and Radiance HDR I/O on the standard library (scene/image_io.py)."""

import os
import struct
import zlib

import numpy as np
import pytest

from radish_pt_tpu.scene import image_io as io

TEXTURES = os.path.join(os.path.dirname(__file__), "..", "scenes", "textures")
PNG_TEXTURES = sorted(f for f in os.listdir(TEXTURES) if f.endswith(".png"))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (33, 5)])
def test_png_roundtrip(channels, shape, tmp_path):
    rng = np.random.default_rng(channels * 100 + shape[0])
    img = rng.integers(0, 256, shape + (channels,), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    io.write_png(p, img)
    np.testing.assert_array_equal(io.read_png(p), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_filtered(img: np.ndarray, ftype: int) -> bytes:
    """A PNG whose every scanline uses filter ``ftype`` (an independent
    encoder, the inverse of the reader's unfilter)."""
    h, w, ch = img.shape
    raw = img.reshape(h, w * ch).astype(np.int64)
    out = bytearray()
    for y in range(h):
        out.append(ftype)
        for i in range(w * ch):
            a = raw[y, i - ch] if i >= ch else 0
            b = raw[y - 1, i] if y > 0 else 0
            c = raw[y - 1, i - ch] if (y > 0 and i >= ch) else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
            out.append(int(raw[y, i] - pred) & 0xFF)

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_scanline_filters(ftype, tmp_path):
    img = np.random.default_rng(ftype).integers(0, 256, (9, 11, 3),
                                                dtype=np.uint8)
    p = tmp_path / f"f{ftype}.png"
    p.write_bytes(_encode_filtered(img, ftype))
    np.testing.assert_array_equal(io.read_png(str(p)), img)


@pytest.mark.parametrize("fname", PNG_TEXTURES)
def test_committed_texture_decodes_like_pil(fname):
    from PIL import Image

    path = os.path.join(TEXTURES, fname)
    ours = io.read_png(path)
    with Image.open(path) as im:
        ref = np.asarray(im)
    np.testing.assert_array_equal(ours.reshape(ref.shape), ref)
    # load_image: linear /255, vertical flip, RGB
    lin = io.load_image(path)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"), np.float32)[::-1] / 255.0
    np.testing.assert_array_equal(lin, want)


def test_palette_png_matches_pil(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(4).integers(0, 256, (12, 10, 3), np.uint8)
    p = str(tmp_path / "pal.png")
    Image.fromarray(rgb).quantize(200).save(p)  # 8-bit indices
    with Image.open(p) as im:
        assert im.mode == "P"
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(io.read_png(p), want)


def test_hdr_save_roundtrip(tmp_path):
    """save_image(.hdr) goes through the own RGBE writer."""
    img = (np.random.default_rng(8).random((6, 9, 3)) * 30).astype(np.float32)
    p = str(tmp_path / "sub" / "x.hdr")
    io.save_image(p, img)
    back = io.read_hdr(p)
    big = img > img.max(-1, keepdims=True) / 8  # shared-exponent precision
    assert (np.abs(back - img) / img)[big].max() < 0.02


def test_save_png_clips_and_quantizes(tmp_path):
    img = np.array([[[-1.0, 0.5, 2.0]]], np.float32)
    p = str(tmp_path / "c.png")
    io.save_image(p, img)
    np.testing.assert_array_equal(io.read_png(p), [[[0, 127, 255]]])


@pytest.mark.parametrize("ext", [".jpg", ".exr"])
def test_unsupported_formats_refused(ext, tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        io.save_image(str(tmp_path / f"x{ext}"), np.zeros((2, 2, 3)))
    with pytest.raises(ValueError, match="unsupported"):
        io.load_image(str(tmp_path / f"x{ext}"))


def test_png_16bit_refused(tmp_path):
    p = tmp_path / "d16.png"
    ihdr = struct.pack(">IIBBBBB", 1, 1, 16, 2, 0, 0, 0)
    body = b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR" + ihdr + \
        struct.pack(">I", zlib.crc32(b"IHDR" + ihdr))
    p.write_bytes(body)
    with pytest.raises(ValueError, match="unsupported PNG"):
        io.read_png(str(p))
