"""Native .npy cube loader (port of umhs_tpu/native/).

`loader.cpp` is umhs_tpu's source, its code copied byte for byte (only the
comment at its top differs): a multithreaded reader of same-shape .npy cubes
into one float32 stack (pread straight into the destination, no GIL). It is compiled by g++ into ``umhs_torch/_build/``
at first use, under a name keyed by a hash of the source and the flags, and
bound with ctypes. Nothing falls back quietly, unlike umhs_tpu/native: a
failed build raises with g++'s output, and a non-zero return on files the
loader takes raises.

The loader takes little-endian f32, f64, u8 and u16 payloads in C order
(loader.cpp:63-68); `takes` says whether a file's header is one of those.
data/dataset.py routes a call to `parallel_load_cubes` only when every file
is, and to its plain numpy loop otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# the payloads loader.cpp reads (its parse_header), by numpy dtype string
NATIVE_DTYPES = ("<f4", "<f8", "|u1", "<u2")

_LOCK = threading.Lock()
_LIBS: Dict[Path, ctypes.CDLL] = {}


class NpyHeader(NamedTuple):
    version: tuple
    shape: tuple
    fortran_order: bool
    dtype: np.dtype


def read_npy_header(path) -> NpyHeader:
    """The header of a .npy file, read without its payload."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:  # v3 (utf-8 field names): numpy's own reader, by a memory map
            arr = np.load(path, mmap_mode="r")
            shape, dtype = arr.shape, arr.dtype
            fortran = arr.flags.f_contiguous and not arr.flags.c_contiguous
    return NpyHeader(version, tuple(shape), bool(fortran), dtype)


def takes(header: NpyHeader) -> bool:
    """Whether the native loader reads this file: a v1 or v2 header, C
    order, and a <f4, <f8, |u1 or <u2 payload."""
    return (header.version in ((1, 0), (2, 0)) and not header.fortran_order
            and header.dtype.str in NATIVE_DTYPES)


def library_path() -> Path:
    """Build-output path of the loader, keyed by its source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{SOURCE.stem}-{digest.hexdigest()[:16]}.so"


def build() -> bool:
    """Compile the loader unless its library exists; True when this call
    compiled it. Raises with g++'s output when the compile fails."""
    out = library_path()
    if out.exists():
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return True


def library() -> ctypes.CDLL:
    """The loaded loader library (built first if missing)."""
    path = library_path()
    with _LOCK:
        if path not in _LIBS:
            build()
            lib = ctypes.CDLL(str(path))
            lib.umhs_load_npy_f32.restype = ctypes.c_int
            lib.umhs_load_npy_f32.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ]
            _LIBS[path] = lib
        return _LIBS[path]


def parallel_load_cubes(paths: Sequence, item_shape: Sequence[int], clamp01: bool = True,
                        n_threads: Optional[int] = None) -> np.ndarray:
    """N same-shape .npy arrays -> one (N, *item_shape) float32 stack by the
    native loader: u8 scaled by 1/255, u16 by 1/65535 (each a float32
    multiply), clamped to [0, 1] with clamp01. Every file must be one the
    loader takes (`takes`) and of `item_shape`; raises otherwise."""
    item_shape = tuple(item_shape)
    for p in paths:
        header = read_npy_header(p)
        if header.shape != item_shape:
            raise ValueError(f"{p}: shape {header.shape} != {item_shape}")
        if not takes(header):
            raise ValueError(f"{p}: the native loader does not take {header}")
    out = np.empty((len(paths), *item_shape), dtype=np.float32)
    if not paths:
        return out
    lib = library()
    c_paths = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
    threads = n_threads or min(os.cpu_count() or 4, 16)
    rc = lib.umhs_load_npy_f32(c_paths, len(paths),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                               int(np.prod(item_shape)), threads, 1 if clamp01 else 0)
    if rc != 0:
        raise RuntimeError(f"the native loader failed on {paths[rc - 1]} (return {rc})")
    return out
