"""K4 any-route probe: where the time of K4's any route goes, by building
csrc/hash_encode_bwd.cu again with one part of `row_sum_any_kernel` taken
out and timing each build.

    python -m umhs_torch.probes.k4_any_parts

Builds (umhs_torch/_build/k4_any_parts/<build>/): "base", the source as it
is; "no_stores", the row sums not written to the gradient table;
"no_gathers", the entries' values not read through their slots. Each is
loaded in place of the wrapper's library and timed on the L40 x F7
tetrahedral grid (2^17 rows a level, 65,536 random positions, chip_smoke's
phase 14 shape), both modes, by device kernel (device_ms_by_kernel; every
build's other kernels are the base's, so the difference in
row_sum_any_kernel is the part's share). The two ablated builds give other
bits, and say so. Needs the card and nvcc; without a card it raises.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess

import torch

from ..ops import _native
from ..ops import encodings as enc
from ..utils.device_time import device_ms_by_kernel

BUILD = _native.BUILD_DIR / "k4_any_parts"
ROWS = 65_536

# build: (text in hash_encode_bwd.cu, its replacement)
ABLATIONS = {
    "base": None,
    "no_stores": ("if (f < F && row != kSkip) row_at(row)[f] = s_res[wi][e][f];",
                  "if (f < F && row != kSkip && f < 0) row_at(row)[f] = s_res[wi][e][f];"),
    "no_gathers": ("if (e >= lo && e < hi && at + e < live)\n        s_val",
                   "if (e >= lo && e < hi && at + e < live && e < 0)\n        s_val"),
}


def build(name: str, change):
    """The source with `change` and csrc/'s headers in the build's
    directory; starts nvcc on it; returns (the process, the library)."""
    where = BUILD / name
    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    for header in _native.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, where)
    text = (_native.CSRC_DIR / "hash_encode_bwd.cu").read_text()
    if change is not None:
        if change[0] not in text:
            raise RuntimeError(f"build {name}: its text is not in hash_encode_bwd.cu")
        text = text.replace(change[0], change[1])
    (where / "hash_encode_bwd.cu").write_text(text)
    lib = where / "lib.so"
    cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-o", str(lib), str(where / "hash_encode_bwd.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def use(lib_path) -> None:
    """K4's wrapper calls the launcher of this library from now on."""
    kernel = enc.HASH_ENCODE_BWD
    lib = ctypes.CDLL(str(lib_path))
    lib.umhs_error_string.argtypes = [ctypes.c_int]
    lib.umhs_error_string.restype = ctypes.c_char_p
    fn = lib.umhs_hash_encode_bwd
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    kernel._lib, kernel._fn = lib, fn


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the K4 any-route probe needs the card")
    jobs = {name: build(name, change) for name, change in ABLATIONS.items()}
    for name, (proc, _) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build {name}: nvcc failed\n{log}")
    cfg = enc.HashEncodingConfig(num_levels=40, features_per_level=7, log2_hashmap_size=17,
                                 interpolation="tetrahedral")
    gen = torch.Generator().manual_seed(280)
    pos = torch.rand((ROWS, 3), generator=gen).cuda()
    g = torch.randn((ROWS, cfg.output_dim), generator=gen).cuda()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": ROWS, "grid": "L40xF7"}))
    reference = {}
    for name, (_, lib) in jobs.items():
        use(lib)
        for stochastic in (True, False):
            got = enc.hash_encode_bwd(pos, g, cfg, stochastic)
            reference.setdefault(stochastic, got)
            by = device_ms_by_kernel(lambda: enc.hash_encode_bwd(pos, g, cfg, stochastic))
            print(json.dumps({"build": name, "mode": "stochastic" if stochastic else "deterministic",
                              "base_bits": torch.equal(got, reference[stochastic]),
                              "ms_by_device_kernel": by}))


if __name__ == "__main__":
    main()
