"""utils/image_io: PNG and PGM without third-party codecs."""

import sys
import zlib

import numpy as np
import pytest

from xrsfm_tpu.utils import image_io


@pytest.mark.parametrize("ext,channels", [(".png", 1), (".png", 3),
                                          (".png", 4), (".pgm", 1)])
def test_image_round_trip(tmp_path, ext, channels):
    rng = np.random.default_rng(channels)
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / f"im{ext}")
    image_io.write_image(path, img)
    back = image_io.read_image(path)
    np.testing.assert_array_equal(back, img)
    gray = image_io.read_gray(path)
    assert gray.shape == (37, 53) and gray.dtype == np.uint8
    if channels == 1:
        np.testing.assert_array_equal(gray, img)


def _png_with_filters(img):
    """Encode gray `img` cycling through PNG filter types 0-4 per row."""
    h, w = img.shape
    raw, prev = b"", np.zeros(w, np.int32)
    for y in range(h):
        ftype = y % 5
        cur = img[y].astype(np.int32)
        left = np.concatenate([[0], cur[:-1]])
        ul = np.concatenate([[0], prev[:-1]])
        if ftype == 0:
            pred = np.zeros(w, np.int32)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        raw += bytes([ftype]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (len(body).to_bytes(4, "big") + kind + body
                + (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, "big"))

    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 0, 0, 0, 0])
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_decoder_undoes_every_filter(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (10, 17), dtype=np.uint8)
    path = tmp_path / "filters.png"
    path.write_bytes(_png_with_filters(img))
    np.testing.assert_array_equal(image_io.read_image(str(path)), img)


def test_unsupported_format_without_cv2_names_the_file(tmp_path, monkeypatch):
    path = tmp_path / "photo.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0 not decoded here")
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 fails
    with pytest.raises(ValueError, match="photo.jpg"):
        image_io.read_gray(str(path))
    with pytest.raises(ValueError, match="out.jpg"):
        image_io.write_image(str(tmp_path / "out.jpg"),
                             np.zeros((4, 4), np.uint8))
