"""Image reading (PNG with zlib and numpy, no Pillow; JPEG and the rest
through Pillow, as the JAX package reads them) and PNG writing.

`read_image` returns, for any image file, the array that
``np.asarray(PIL.Image.open(path))`` gives, and `image_size` the
``Image.open(path).size``. PNG is decoded here (`read_png`, `png_size`):
every colour type at every bit depth the format allows, interlaced or not,
with any of the five row filters. Gray gives (H, W): bool at 1 bit, uint8
at 2, 4 and 8 bits (2 and 4 scaled to 0-255 by 85 and 17), uint16 at 16;
a palette image (H, W) uint8 indices (PIL's mode "P"), with or without
tRNS; gray+alpha (H, W, 2) uint8 at 8 bits and (H, W, 4) at 16 (gray
three times, then alpha: PIL's "RGBA"); RGB and RGBA (H, W, 3 or 4)
uint8, the high bytes at 16 bits. Other files are opened with Pillow,
imported inside the reading function, so only a scene with them needs it;
a JPEG's size comes from its SOF marker without Pillow. `write_png` writes
8-bit gray, RGB or RGBA (filter 0 on every row), and `png_bytes` gives the
same file as bytes.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel, and the bit depths the format allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


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


def _jpeg_size(path) -> Tuple[int, int]:
    """(width, height) of a JPEG from its first SOF marker."""
    data = Path(path).read_bytes()
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:  # no length
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if marker in _JPEG_SOF:
            height, width = struct.unpack(">HH", data[pos + 5:pos + 9])
            return width, height
        pos += 2 + length
    raise ValueError(f"{path}: JPEG file without a frame header")


def _pillow(path):
    try:
        from PIL import Image
    except ImportError as err:
        raise ValueError(f"{path}: reading this image format needs Pillow, which is not "
                         f"installed (PNG is read without it)") from err
    return Image.open(path)


def image_size(path) -> Tuple[int, int]:
    """(width, height) of an image, as ``PIL.Image.open(path).size``: PNG and
    JPEG from their headers, other formats through Pillow."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == SIGNATURE:
        return png_size(path)
    if head[:2] == b"\xff\xd8":
        return _jpeg_size(path)
    with _pillow(path) as img:
        return img.size


def read_image(path) -> np.ndarray:
    """The pixels of an image file, as ``np.asarray(PIL.Image.open(path))``
    gives them: PNG decoded here, any other format through Pillow."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == SIGNATURE:
        return read_png(path)
    with _pillow(path) as img:
        return np.asarray(img)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (height, stride) uint8. `bpp` is the
    filters' byte distance to the left neighbour (1 below 8 bits a pixel)."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG image data has {len(raw)} bytes, expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: running sums along each byte lane of the pixel
            pad = (-stride) % bpp
            px = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = (np.cumsum(px, axis=0, dtype=np.int64) % 256).astype(np.uint8).reshape(-1)
            cur = cur[:stride]
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


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, stride) -> samples (h, width, channels): uint8
    below 16 bits (sub-byte samples unpacked, most significant bits first),
    uint16 at 16."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, -1).view(">u2")[:, :width * channels].astype(np.uint16).reshape(
            h, width, channels)
    if depth < 8:
        per = 8 // depth
        shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
        vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        return vals.reshape(h, -1)[:, :width * channels].reshape(h, width, channels)
    return rows.reshape(h, -1)[:, :width * channels].reshape(h, width, channels)


def _decode(raw: bytes, interlace: int, width: int, height: int, channels: int,
            depth: int) -> np.ndarray:
    """The decompressed image data -> samples (height, width, channels),
    pass by pass where Adam7 interlaces it."""
    bits = channels * depth
    bpp = max(1, bits // 8)
    out = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        w, h = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
        if w <= 0 or h <= 0:
            continue  # a pass with no pixels has no rows at all
        stride = (w * bits + 7) // 8
        size = h * (stride + 1)
        rows = _unfilter(raw[pos:pos + size], h, stride, bpp)
        pos += size
        out[y0::dy, x0::dx] = _samples(rows, w, channels, depth)
    if pos != len(raw):
        raise ValueError(f"PNG image data has {len(raw)} bytes, expected {pos}")
    return out


def read_png(path) -> np.ndarray:
    """The pixels of a PNG file, as np.asarray(PIL.Image.open(path)) gives them."""
    data = Path(path).read_bytes()
    width, height, depth, color, interlace = _header(data)
    if color not in _DEPTHS or depth not in _DEPTHS[color] or interlace not in (0, 1):
        raise ValueError(f"{path}: not a valid PNG (colour type {color}, bit depth {depth}, "
                         f"interlace {interlace})")
    channels = _CHANNELS[color]
    idat = b"".join(body for kind, body in _chunks(data) if kind == b"IDAT")
    px = _decode(zlib.decompress(idat), interlace, width, height, channels, depth)
    if color in (0, 3):
        px = px[..., 0]
        if color == 0 and depth == 1:
            return px.astype(bool)
        if color == 0 and depth in (2, 4):
            return px * np.uint8(255 // ((1 << depth) - 1))
        return px
    if depth == 16:  # PIL keeps the high bytes; gray+alpha becomes RGBA
        px = (px >> 8).astype(np.uint8)
        if color == 4:
            px = px[..., [0, 0, 0, 1]]
    return px


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
