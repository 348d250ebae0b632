"""Build and load the hand-written CUDA kernels in ``umhs_torch/csrc``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface (no PyTorch headers) and loaded with
``ctypes``. Libraries live in ``umhs_torch/_build/`` under a name keyed by a
hash of the source, the shared headers and the flags, so an edited source is
rebuilt and an unchanged one is reused. The first use of any kernel compiles
every source, one ``nvcc`` process per source, all started together. Nothing
is compiled or loaded when a module is imported.

Each `Kernel` counts its own launches in ``launches``: its wrapper adds one
after every launch that returned no error, and nowhere else. A launcher
with more than one route (K5's WIDE kernels, K6a's flat tiles, K6c's
long-ray backward) takes an ``int32_t*`` last and writes there the route it
launched; `Kernel.launch(..., routes=names)` passes it and counts the
launch under that route's name in ``routes`` too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    """Build-output path of one source, keyed by its content and the flags."""
    digest = hashlib.sha256()
    for path in [CSRC_DIR / source] + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, in parallel.

    Returns {source: ptxas report} for the sources compiled by this call.
    Raises with nvcc's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(CSRC_DIR.glob("*.cu")):
        out = library_path(src.name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[src.name] = (proc, tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    return reports


class Kernel:
    """One exported launcher of a compiled source, with its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.routes: Dict[str, int] = {}  # launches by the route the launcher reported
        self._lib = None
        self._fn = None
        self._checked = {}
        KERNELS[symbol] = self

    def _load(self):
        path = library_path(self.source)
        if not path.exists():
            build_all()
        self._lib = ctypes.CDLL(str(path))
        self._lib.umhs_error_string.argtypes = [ctypes.c_int]
        self._lib.umhs_error_string.restype = ctypes.c_char_p
        fn = getattr(self._lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def library(self) -> ctypes.CDLL:
        """The loaded library of this kernel's source (built if missing)."""
        if self._fn is None:
            self._load()
        return self._lib

    def check_struct(self, symbol: str, struct) -> None:
        """Raise unless the library's `symbol`() (a sizeof) equals the ctypes
        mirror's size: a parameter struct passed by pointer must match."""
        if symbol in self._checked:
            return
        fn = getattr(self.library(), symbol)
        fn.argtypes, fn.restype = [], ctypes.c_int
        size = fn()
        if size != ctypes.sizeof(struct):
            raise RuntimeError(f"{symbol}: the kernel's struct is {size} bytes, its ctypes "
                               f"mirror {ctypes.sizeof(struct)}")
        self._checked[symbol] = size

    def launch(self, *args, routes: Optional[Sequence[str]] = None) -> None:
        """Call the launcher; raise on a non-zero cudaError_t, else count.
        With `routes` (the launcher's route names, by the index it reports)
        the launcher gets an int32 out-parameter last, and the launch is
        counted under the route it wrote there too."""
        if self._fn is None:
            self._load()
        route = ctypes.c_int32(-1)
        err = self._fn(*args, *(() if routes is None else (ctypes.byref(route),)))
        if err != 0:
            msg = self._lib.umhs_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed: cudaError {err} ({msg})")
        self.launches += 1
        if routes is not None:
            if not 0 <= route.value < len(routes):
                raise RuntimeError(f"{self.symbol} reported route {route.value}, not one of "
                                   f"{list(routes)}")
            name = routes[route.value]
            self.routes[name] = self.routes.get(name, 0) + 1


KERNELS: Dict[str, Kernel] = {}

