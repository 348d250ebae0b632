"""F32 product probe: the general route's f32 product kernel (K1/K2's
`mlp_gemm_kernel`, csrc/mlp_general.cuh) at one hidden layer of a 512-wide
chain, in variants of its tile and pipeline, beside torch.mm and the card's
FMA ceiling.

    python -m umhs_torch.probes.f32_products

Each variant is a copy of csrc/'s headers with one constant changed (the
slice depth and stages, the launch bounds' blocks an SM), built with nvcc
into umhs_torch/_build/f32_products/<variant>/ and run as a program of its
own: [262,144 x 512] . [512 x 512] as K1's hidden layer (A k-contiguous, B
as packed) and as K2's dh . W^T, at 8 x 8 sums a thread (128 x 128 tiles)
and, on the wide build, 8 x 16 and 16 x 8; and the 512 x 512 dW product over
K2's 5 row ranges of 262,144 rows at 4 x 4, 8 x 4, 8 x 8 and 4 x 8 sums a
thread. Each time is CUDA events around back-to-back launches, printed with
its TFLOP/s. Then, in this process: torch.mm at the same product (TF32 off),
and an FMA-only kernel (16 independent chains a thread, no memory), the rate
no f32 product can pass on the card. Needs the card and nvcc; without a card
it raises.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess

import torch

from ..ops import _native

BUILD = _native.BUILD_DIR / "f32_products"
ROWS, WIDTH = 262_144, 512

# name: (a regex substitution on mlp_general.cuh, or None; the wide thread tiles built)
VARIANTS = {
    "base": (None, False),
    "slices16x4": (("kFk = 32, kFStages = 3", "kFk = 16, kFStages = 4"), False),
    "slices16x3": (("kFk = 32, kFStages = 3", "kFk = 16, kFStages = 3"), False),
    "one_block_an_sm": ((r"512 / FTile<kTM, kTN, kWM, kWN>::kThreads\)", "1)"), True),
}

BENCH = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include "mlp_general.cuh"
using namespace umhs::general;

template <class F>
float time_it(F f, int reps) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  f();
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int i = 0; i < reps; ++i) f();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms / reps;
}

__global__ void fill(float* p, size_t n, unsigned seed) {
  size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i < n) {
    unsigned h = (unsigned)i * 2654435761u ^ seed;
    h ^= h >> 13;
    h *= 0x5bd1e995u;
    h ^= h >> 15;
    p[i] = (h & 0xffff) / 65536.f - 0.5f;
  }
}

void report(const char* what, float ms, double fma) {
  printf("{\"case\": \"%s\", \"ms\": %.4f, \"tflops\": %.2f, \"error\": \"%s\"}\n", what, ms,
         2 * fma / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  const int R = ROWS, D = WIDTH;
  float *act, *w, *bias, *out, *dh, *part;
  cudaMalloc(&act, sizeof(float) * R * D);
  cudaMalloc(&dh, sizeof(float) * R * D);
  cudaMalloc(&out, sizeof(float) * R * D);
  cudaMalloc(&w, sizeof(float) * D * D);
  cudaMalloc(&bias, sizeof(float) * D);
  cudaMalloc(&part, sizeof(float) * D * D * 8);
  fill<<<(R * D + 255) / 256, 256>>>(act, (size_t)R * D, 1);
  fill<<<(R * D + 255) / 256, 256>>>(dh, (size_t)R * D, 2);
  fill<<<(D * D + 255) / 256, 256>>>(w, (size_t)D * D, 3);
  cudaMemset(bias, 0, sizeof(float) * D);
  cudaStream_t s = 0;
  const double fma = (double)R * D * D;
  Gemm g{};  // K1's hidden layer
  g.a = act; g.lda = D; g.a_end = R; g.b = w; g.ldb = D; g.b_end = D; g.k_end = D;
  g.k_split = D; g.m = R; g.n = D; g.n_out = D; g.bias = bias; g.out = out; g.ldo = D;
  report("hidden 8x8", time_it([&] { launch_ftile<kHidden, true, false, 8, 8, 4, 2>(g, D, 1, s); }, 5), fma);
#ifdef WIDE
  report("hidden 8x16", time_it([&] { launch_ftile<kHidden, true, false, 8, 16, 4, 1>(g, D, 1, s); }, 5), fma);
  report("hidden 16x8", time_it([&] { launch_ftile<kHidden, true, false, 16, 8, 2, 2>(g, D, 1, s); }, 5), fma);
#endif
  Gemm h = g;  // K2's dh . W^T (B k-outer)
  h.a = dh; h.mask = act; h.ldm = D; h.colsum = part; h.ldc = D;
  report("dh 8x8", time_it([&] { launch_ftile<kDh, true, false, 8, 8, 4, 2>(h, D, 1, s); }, 5), fma);
  Gemm d{};  // K2's dW over its row ranges
  d.a = act; d.lda = D; d.a_end = D; d.b = dh; d.ldb = D; d.b_end = D; d.k_end = R;
  const int z = dw_splits(D, D, R, d.k_split, false);
  d.m = D; d.n = D; d.out = part; d.ldo = D; d.out_z = (int64_t)D * D;
  report("dW 4x4 8 warps", time_it([&] { launch_ftile<kDw, false, false, 4, 4, 4, 2>(d, D, z, s); }, 3), fma);
  report("dW 8x4 2 warps", time_it([&] { launch_ftile<kDw, false, false, 8, 4, 2, 1>(d, D, z, s); }, 3), fma);
  report("dW 8x8 2 warps", time_it([&] { launch_ftile<kDw, false, false, 8, 8, 2, 1>(d, D, z, s); }, 3), fma);
  report("dW 4x8 4 warps", time_it([&] { launch_ftile<kDw, false, false, 4, 8, 4, 1>(d, D, z, s); }, 3), fma);
  return 0;
}
"""

FFMA = r"""
__global__ void ffma(float* out, int iters, float a, float b) {
  float x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = threadIdx.x * 0.001f + i;
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = fmaf(x[i], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += x[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
"""


RUN_FFMA = r"""
extern "C" float run_ffma(int blocks, int threads, int iters) {
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  ffma<<<blocks, threads>>>(out, 1024, 0.999f, 0.001f);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  ffma<<<blocks, threads>>>(out, iters, 0.999f, 0.001f);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  cudaFree(out);
  return ms;
}
"""


def build(name: str, sub, wide: bool):
    """Copies csrc/'s headers with the variant's change and starts nvcc on
    the bench; returns (the process, the program's path)."""
    where = BUILD / name
    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    for header in _native.CSRC_DIR.glob("*.cuh"):
        text = header.read_text()
        if header.name == "mlp_general.cuh" and sub is not None:
            changed = re.sub(sub[0], sub[1], text)
            if changed == text:
                raise RuntimeError(f"variant {name}: {sub[0]!r} not found")
            text = changed
        (where / header.name).write_text(text)
    (where / "bench.cu").write_text(BENCH.replace("ROWS", str(ROWS)).replace("WIDTH", str(WIDTH)))
    program = where / "bench"
    cmd = [_native._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           *(["-DWIDE"] if wide else []), "-o", str(program), str(where / "bench.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), program


def ffma_tflops() -> float:
    """The FMA-only kernel's rate: built by nvcc with a host launcher that
    times one launch by CUDA events, called through ctypes."""
    import ctypes

    where = BUILD / "ffma"
    where.mkdir(parents=True, exist_ok=True)
    source, lib = where / "ffma.cu", where / "ffma.so"
    source.write_text(FFMA + RUN_FFMA)
    subprocess.run([_native._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(source)], check=True)
    run = ctypes.CDLL(str(lib)).run_ffma
    run.argtypes, run.restype = [ctypes.c_int] * 3, ctypes.c_float
    blocks = torch.cuda.get_device_properties(0).multi_processor_count * 8
    threads, iters = 256, 1 << 16
    ms = run(blocks, threads, iters)
    return 2.0 * blocks * threads * iters * 16 / ms / 1e9


def torch_mm_tflops() -> float:
    """torch.mm at the same product, TF32 off: CUDA events around 5 calls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.randn(ROWS, WIDTH, device="cuda")
    w = torch.randn(WIDTH, WIDTH, device="cuda")
    for _ in range(2):
        torch.mm(a, w)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        torch.mm(a, w)
    end.record()
    torch.cuda.synchronize()
    return 2.0 * ROWS * WIDTH * WIDTH / (start.elapsed_time(end) / 5) / 1e9


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the f32 products probe needs the card")
    jobs = {name: build(name, sub, wide) for name, (sub, wide) in VARIANTS.items()}
    for name, (proc, program) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log}")
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    for name, (_, program) in jobs.items():
        out = subprocess.run([str(program)], capture_output=True, text=True, check=True).stdout
        for line in out.splitlines():
            print(json.dumps({"variant": name, **json.loads(line)}))
    print(json.dumps({"torch.mm TFLOP/s": torch_mm_tflops(), "FMA-only TFLOP/s": ffma_tflops()}))


if __name__ == "__main__":
    main()
