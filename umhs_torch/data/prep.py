"""Offline dataset preparation tools (port of umhs_tpu/data/prep.py).

Equivalents of the reference's L6 prep scripts (SURVEY.md §1):

- `convert_nespof_scene` — the reference's data/spec2rgb.py: read per-
  wavelength EXR Stokes frames (450-650 nm step 10 -> 21 bands), stack to an
  (H, W, 21) cube saved as `r_k.npy`, and write the gamma-corrected sRGB PNG
  via the same CIE colour-system math. Gated on OpenEXR availability.
- `add_camera_params` / `add_hyperspectral_paths` — data/adapt_transforms.py:
  inject fl_x/fl_y/cx/cy/w/h/camera_model=OPENCV (focal from camera_angle_x)
  and per-frame `hyperspectral_file_path` into Blender-style transforms.
- `merge_transforms` — data/add_val.py: concatenate val+train frame lists
  into a single transforms.json (the filename split happens at parse time).

All host-side; invoked from the CLI (python -m umhs_torch.data.prep ...).
PNGs are written by data/png.py, not Pillow.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..ops.spec_to_rgb import build_spec_to_rgb_matrix, srgb_gamma_np
from .png import write_png

NESPOF_WAVELENGTHS = list(range(450, 651, 10))  # 21 bands

# ---------------------------------------------------------------------------
# Minimal OpenEXR 2.0 scanline I/O (pure numpy).
#
# The NeSpoF captures the reference converts (its data/spec2rgb.py:141-150) are single-part uncompressed scanline EXRs; the
# OpenEXR python bindings are a heavyweight native dependency that is not
# always available, so `read_exr` falls back to this reader. Covers
# compression=NONE, pixel types HALF (IEEE 754 half == np.float16) and
# FLOAT, INCREASING_Y line order — the subset those files use.
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_EXR_PIXEL_DTYPES = {1: np.dtype("<f2"), 2: np.dtype("<f4")}  # HALF, FLOAT


def _read_cstring(buf: bytes, pos: int):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def read_exr_minimal(path: Path, channel: Optional[str] = None) -> np.ndarray:
    """Read one channel of an uncompressed single-part scanline EXR."""
    buf = Path(path).read_bytes()
    magic, version = np.frombuffer(buf[:8], dtype="<i4")
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: multi-part EXRs are not supported")
    pos = 8

    channels: List[tuple] = []  # (name, dtype)
    data_window = None
    compression = None
    while True:
        if buf[pos] == 0:  # end of header
            pos += 1
            break
        name, pos = _read_cstring(buf, pos)
        atype, pos = _read_cstring(buf, pos)
        size = int(np.frombuffer(buf[pos : pos + 4], "<i4")[0])
        pos += 4
        val = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while val[cpos] != 0:
                cname, cpos = _read_cstring(val, cpos)
                ptype = int(np.frombuffer(val[cpos : cpos + 4], "<i4")[0])
                cpos += 16  # type + pLinear/reserved + x/ySampling
                if ptype not in _EXR_PIXEL_DTYPES:
                    raise ValueError(f"{path}: pixel type {ptype} is not supported")
                channels.append((cname, _EXR_PIXEL_DTYPES[ptype]))
        elif name == "dataWindow":
            data_window = np.frombuffer(val, "<i4")
        elif name == "compression":
            compression = val[0]
    if compression != 0:
        raise ValueError(f"{path}: only compression=NONE is supported by the fallback")
    xmin, ymin, xmax, ymax = data_window
    h, w = ymax - ymin + 1, xmax - xmin + 1

    # channels are stored per scanline in ALPHABETICAL order
    channels.sort(key=lambda c: c[0])
    names = [c[0] for c in channels]
    want = channel or ("R" if "R" in names else names[0])
    if want not in names:
        raise ValueError(f"{path}: channel {want!r} not in {names}")

    pos += 8 * h  # skip the scanline offset table (blocks are contiguous)
    out = np.empty((h, w), dtype=np.float32)
    for row in range(h):
        size = int(np.frombuffer(buf[pos + 4 : pos + 8], "<i4")[0])
        dpos = pos + 8
        for cname, dt in channels:
            n = w * dt.itemsize
            if cname == want:
                out[row] = np.frombuffer(buf[dpos : dpos + n], dt).astype(
                    np.float32
                )
            dpos += n
        pos += 8 + size
    return out


def write_exr_minimal(
    path: Path, image: np.ndarray, channel: str = "R", half: bool = False
) -> None:
    """Write a single-channel uncompressed scanline EXR (fixture/export
    utility; round-trips with `read_exr_minimal` and with OpenEXR)."""
    import struct

    image = np.asarray(image, dtype=np.float32)
    h, w = image.shape
    dt = np.dtype("<f2") if half else np.dtype("<f4")

    def attr(name: str, atype: str, data: bytes) -> bytes:
        return (
            name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(data)) + data
        )

    chlist = (
        channel.encode() + b"\x00"
        + struct.pack("<i", 1 if half else 2)  # HALF / FLOAT
        + b"\x00\x00\x00\x00"  # pLinear + reserved
        + struct.pack("<ii", 1, 1)  # x/ySampling
        + b"\x00"
    )
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<ii", _EXR_MAGIC, 2)
        + attr("channels", "chlist", chlist)
        + attr("compression", "compression", b"\x00")
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\x00")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr(
            "screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)
        )
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00"
    )
    row_bytes = w * dt.itemsize
    table_start = len(header)
    data_start = table_start + 8 * h
    block_size = 8 + row_bytes
    offsets = struct.pack(
        "<%dQ" % h, *[data_start + r * block_size for r in range(h)]
    )
    blocks = b"".join(
        struct.pack("<ii", r, row_bytes) + image[r].astype(dt).tobytes()
        for r in range(h)
    )
    Path(path).write_bytes(header + offsets + blocks)


def read_exr(path: Path) -> np.ndarray:
    """Read a single-channel (or RGB) EXR as float array.

    Uses the OpenEXR bindings when importable, else the pure-numpy
    uncompressed-scanline fallback above (the reference's
    reader: data/spec2rgb.py:111-138)."""
    try:
        import OpenEXR  # noqa: F401
        import Imath

        f = OpenEXR.InputFile(str(path))
        dw = f.header()["dataWindow"]
        h = dw.max.y - dw.min.y + 1
        w = dw.max.x - dw.min.x + 1
        pt = Imath.PixelType(Imath.PixelType.FLOAT)
        channels = list(f.header()["channels"].keys())
        chan = "R" if "R" in channels else channels[0]
        data = np.frombuffer(f.channel(chan, pt), dtype=np.float32)
        return data.reshape(h, w)
    except ImportError:
        return read_exr_minimal(path)


def spec_cube_to_rgb_png(cube: np.ndarray, wavelengths, out_path: Path) -> None:
    """(H, W, B) cube -> gamma-corrected sRGB PNG (spec2rgb.py:152-162)."""
    m = build_spec_to_rgb_matrix(wavelengths)
    rgb = np.clip(cube, 0, 1) @ m
    rgb = np.clip(srgb_gamma_np(np.clip(rgb, 0, 1)), 0, 1)
    write_png(out_path, (rgb * 255).astype(np.uint8))


def convert_nespof_scene(
    scene_dir: Path,
    out_dir: Path,
    split: str = "train",
    wavelengths: Optional[List[int]] = None,
    stokes_component: str = "s0",
) -> int:
    """Convert a NeSpoF-style scene: per view, one EXR per wavelength under
    <scene>/<split>/<wavelength>/..._{s0}.exr -> (H, W, B) r_k.npy + r_k.png.

    Returns the number of views converted.
    """
    wavelengths = wavelengths or NESPOF_WAVELENGTHS
    scene_dir, out_dir = Path(scene_dir), Path(out_dir)
    (out_dir / split).mkdir(parents=True, exist_ok=True)

    wl_dirs = [scene_dir / split / str(wl) for wl in wavelengths]
    if not wl_dirs[0].exists():
        raise FileNotFoundError(f"missing wavelength dir {wl_dirs[0]}")
    frames = sorted(
        p.name for p in wl_dirs[0].iterdir() if stokes_component in p.name
    )
    for k, frame_name in enumerate(frames):
        bands = [read_exr(d / frame_name) for d in wl_dirs]
        cube = np.clip(np.stack(bands, axis=-1), 0.0, 1.0).astype(np.float32)
        np.save(out_dir / split / f"r_{k}.npy", cube)
        spec_cube_to_rgb_png(
            cube, wavelengths, out_dir / split / f"r_{k}.png"
        )
    return len(frames)


def add_camera_params(
    transforms_path: Path, width: int = 512, height: int = 512
) -> dict:
    """Inject intrinsics derived from camera_angle_x (adapt_transforms.py:6-24)."""
    with open(transforms_path) as f:
        meta = json.load(f)
    angle_x = meta["camera_angle_x"]
    focal = 0.5 * width / math.tan(0.5 * angle_x)
    meta.update(
        {
            "fl_x": focal,
            "fl_y": focal,
            "cx": width / 2.0,
            "cy": height / 2.0,
            "w": width,
            "h": height,
            "camera_model": "OPENCV",
        }
    )
    with open(transforms_path, "w") as f:
        json.dump(meta, f, indent=4)
    return meta


def add_hyperspectral_paths(transforms_path: Path) -> dict:
    """Add hyperspectral_file_path = file_path + '.npy' per frame
    (adapt_transforms.py:33-38)."""
    with open(transforms_path) as f:
        meta = json.load(f)
    for frame in meta["frames"]:
        fp = frame["file_path"]
        base = fp[:-4] if fp.endswith(".png") else fp
        frame["hyperspectral_file_path"] = base + ".npy"
    with open(transforms_path, "w") as f:
        json.dump(meta, f, indent=4)
    return meta


def merge_transforms(
    val_path: Path, train_path: Path, out_path: Path
) -> dict:
    """Concatenate val+train frames into one transforms.json (add_val.py)."""
    with open(val_path) as f:
        val = json.load(f)
    with open(train_path) as f:
        train = json.load(f)
    merged = dict(train)
    merged["frames"] = val["frames"] + train["frames"]
    with open(out_path, "w") as f:
        json.dump(merged, f, indent=4)
    return merged


def main(argv=None):
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        raise SystemExit("usage: prep {convert-nespof|add-camera-params|add-hs-paths|merge} ...")
    cmd, args = argv[0], argv[1:]
    if cmd == "convert-nespof":
        n = convert_nespof_scene(Path(args[0]), Path(args[1]), *args[2:])
        print(f"converted {n} views")
    elif cmd == "add-camera-params":
        add_camera_params(Path(args[0]))
    elif cmd == "add-hs-paths":
        add_hyperspectral_paths(Path(args[0]))
    elif cmd == "merge":
        merge_transforms(Path(args[0]), Path(args[1]), Path(args[2]))
    else:
        raise SystemExit(f"unknown prep command {cmd}")


if __name__ == "__main__":
    main()
