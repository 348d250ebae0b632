"""PNG read and write with zlib and numpy (the port needs no Pillow).

`read_png` takes non-interlaced 8-bit gray, gray+alpha, RGB and RGBA and
16-bit gray, with any of the five row filters, and returns the array that
``np.asarray(PIL.Image.open(path))`` gives: (H, W) for gray, else
(H, W, C), uint8 (uint16 for 16-bit gray). Any other format raises.
`write_png` writes 8-bit gray, RGB or RGBA (filter 0 on every row), and
`png_bytes` gives the same file as bytes.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels; only these, at the bit depths below, are read
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before its IEND chunk")


def _header(data: bytes) -> Tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace) from IHDR."""
    kind, ihdr = next(_chunks(data))
    if kind != b"IHDR":
        raise ValueError("PNG file does not start with IHDR")
    width, height, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    return width, height, depth, color, interlace


def png_size(path) -> Tuple[int, int]:
    """(width, height) of a PNG, from its header alone."""
    with open(path, "rb") as f:
        head = f.read(33)
    width, height, _, _, _ = _header(head)
    return width, height


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (height, stride) uint8."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG image data has {len(raw)} bytes, expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: running sums along each byte of the pixel
            px = line.reshape(-1, bpp)  # stride = width * bpp
            cur = (np.cumsum(px, axis=0, dtype=np.int64) % 256).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior  # uint8 arithmetic wraps mod 256
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            buf = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                left = buf[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                buf[i] = (buf[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prior = cur
    return out


def read_png(path) -> np.ndarray:
    """The pixels of a PNG file, as np.asarray(PIL.Image.open(path)) gives them."""
    data = Path(path).read_bytes()
    width, height, depth, color, interlace = _header(data)
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if color not in _CHANNELS or not (depth == 8 or (depth == 16 and color == 0)):
        raise ValueError(f"{path}: unsupported PNG format (colour type {color}, bit depth "
                         f"{depth}); supported: 8-bit gray, gray+alpha, RGB, RGBA and 16-bit gray")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    idat = b"".join(body for kind, body in _chunks(data) if kind == b"IDAT")
    pixels = _unfilter(zlib.decompress(idat), height, width * bpp, bpp)
    if depth == 16:
        return pixels.reshape(height, width, 2).view(">u2")[..., 0].astype(np.uint16)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return pixels.reshape(shape)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def png_bytes(image: np.ndarray) -> bytes:
    """The PNG file of an (H, W) uint8 array as 8-bit gray, or of an
    (H, W, 3) or (H, W, 4) one as RGB or RGBA."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (
            image.ndim == 2 or (image.ndim == 3 and image.shape[2] in (3, 4))):
        raise ValueError("write_png takes an (H, W), (H, W, 3) or (H, W, 4) uint8 array")
    height, width = image.shape[:2]
    channels = 1 if image.ndim == 2 else image.shape[2]
    color = {1: 0, 3: 2, 4: 6}[channels]
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           np.ascontiguousarray(image).reshape(height, width * channels)], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray) -> None:
    """Write `png_bytes(image)` to `path`."""
    data = png_bytes(image)
    with open(path, "wb") as f:
        f.write(data)
