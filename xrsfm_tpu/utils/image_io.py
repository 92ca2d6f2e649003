"""Image reading and writing without third-party codecs.

8-bit PNG (grayscale, grayscale+alpha, RGB, RGBA; non-interlaced) is
decoded and encoded with the standard library's zlib, and binary PGM
(P5, maxval <= 255) directly.  Any other format (JPEG, ...) is handed
to OpenCV when it imports; otherwise the reader raises an error that
names the file.  Color images are returned in RGB order.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples/pixel


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    stride = w * c
    data = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = data[y, 0], data[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(w, c), axis=0, dtype=np.uint8)
            cur = cur.reshape(stride)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average / Paeth depend on the left pixel
            cur = np.zeros(stride, np.int32)
            up = prev.astype(np.int32)
            src = line.astype(np.int32)
            for x in range(stride):
                left = cur[x - c] if x >= c else 0
                if ftype == 3:
                    pred = (left + up[x]) >> 1
                else:
                    ul = up[x - c] if x >= c else 0
                    p = left + up[x] - ul
                    pa, pb, pc = abs(p - left), abs(p - up[x]), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else (
                        up[x] if pb <= pc else ul)
                cur[x] = (src[x] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, c)


def _read_png(path: str, buf: bytes) -> np.ndarray:
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos: pos + 4])
        kind = buf[pos + 4: pos + 8]
        body = buf[pos + 8: pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced gray/RGB(A) PNG is "
            f"supported (bit depth {depth}, color type {ctype}, "
            f"interlace {interlace})")
    c = _PNG_CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, c)
    return img[:, :, 0] if c == 1 else img


def _write_png(path: str, img: np.ndarray) -> None:
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    ctype = {v: k for k, v in _PNG_CHANNELS.items()}[c]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", crc)

    with open(path, "wb") as fh:
        fh.write(_PNG_SIG)
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                            0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        fh.write(chunk(b"IEND", b""))


def _read_pgm(path: str, buf: bytes) -> np.ndarray:
    """Binary PGM (P5), header comments allowed."""
    fields, pos = [], 2
    while len(fields) < 3:
        while buf[pos: pos + 1].isspace():
            pos += 1
        if buf[pos: pos + 1] == b"#":
            pos = buf.index(b"\n", pos) + 1
            continue
        end = pos
        while not buf[end: end + 1].isspace():
            end += 1
        fields.append(int(buf[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval > 255:
        raise ValueError(f"{path}: only 8-bit PGM is supported")
    data = np.frombuffer(buf, np.uint8, count=w * h, offset=pos + 1)
    return data.reshape(h, w)


def _write_pgm(path: str, img: np.ndarray) -> None:
    if img.ndim != 2:
        raise ValueError(f"{path}: PGM holds one channel, got {img.shape}")
    h, w = img.shape
    with open(path, "wb") as fh:
        fh.write(b"P5\n%d %d\n255\n" % (w, h))
        fh.write(np.ascontiguousarray(img).tobytes())


def _cv2(path: str):
    try:
        import cv2
    except ImportError:
        raise ValueError(
            f"{path}: unsupported image format without OpenCV (cv2); "
            f"PNG and PGM are read natively") from None
    return cv2


def read_image(path: str) -> np.ndarray:
    """Decode an image file: [H, W] uint8 gray or [H, W, C] uint8 RGB(A).
    Raises FileNotFoundError when the file does not exist."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:8] == _PNG_SIG:
        return _read_png(path, buf)
    if buf[:2] == b"P5":
        return _read_pgm(path, buf)
    cv2 = _cv2(path)
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"{path}: OpenCV could not decode the file")
    if img.ndim == 3:
        img = img[:, :, [2, 1, 0] + list(range(3, img.shape[2]))]
    return img


def read_gray(path: str) -> np.ndarray:
    """[H, W] uint8 luminance (ITU-R BT.601 weights, as OpenCV's
    grayscale conversion); alpha is ignored."""
    img = read_image(path)
    if img.ndim == 2:
        return img
    if img.shape[2] < 3:
        return np.ascontiguousarray(img[:, :, 0])
    rgb = img[:, :, :3].astype(np.float32)
    y = rgb @ np.array([0.299, 0.587, 0.114], np.float32)
    return np.clip(np.rint(y), 0, 255).astype(np.uint8)


def write_image(path: str, img: np.ndarray) -> None:
    """Encode [H, W] gray or [H, W, 3|4] RGB(A) uint8 by extension:
    .png and .pgm natively, anything else through OpenCV."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: expected uint8 pixels, got {img.dtype}")
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        _write_png(path, img)
    elif ext == ".pgm":
        _write_pgm(path, img)
    else:
        cv2 = _cv2(path)
        if img.ndim == 3:
            img = img[:, :, [2, 1, 0] + list(range(3, img.shape[2]))]
        if not cv2.imwrite(path, img):
            raise ValueError(f"{path}: OpenCV could not encode the file")
