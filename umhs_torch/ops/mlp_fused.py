"""K1: the fused-MLP forward kernel's wrapper, and its plain version.

`mlp_fused_fwd` runs a whole layer chain (ReLU between layers, linear last
layer) in one launch of ``csrc/mlp_fused_fwd.cu``, the port of the Pallas
kernel ``umhs_tpu/ops/pallas/mlp_fused.py::_fwd_kernel``. On a CPU tensor it
runs `mlp_plain` instead; on a CUDA tensor the kernel is the only path and a
failed build or launch raises.

`mlp_plain` is the plain PyTorch version: the JAX package's unfused path
(``umhs_tpu/ops/mlp.py:95-104``). Under a bf16 compute dtype it rounds the
biases to bf16 as that path does, where the kernel (like the Pallas kernel)
adds them in f32; the bf16 tolerance of 2e-2 covers the gap.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._native import Kernel

MAX_LAYERS = 8
MAX_WIDTH = 256

MLP_FUSED_FWD = Kernel(
    "mlp_fused_fwd.cu",
    "umhs_mlp_fused_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


def mlp_plain(params, x: torch.Tensor,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain layer chain: inputs cast to `compute_dtype`, products summed in
    f32 (bf16 values multiply exactly in f32), ReLU between layers, f32 out."""
    layers = params["layers"]
    h = x if compute_dtype is None else x.to(compute_dtype)
    for i, layer in enumerate(layers):
        w, b = layer["w"], layer["b"]
        if compute_dtype is not None:
            w, b = w.to(compute_dtype), b.to(compute_dtype)
        h = h.float() @ w.float() + b.float()
        if i + 1 < len(layers):
            h = torch.relu(h)
            if compute_dtype is not None:
                h = h.to(compute_dtype)
    return h


def mlp_fused_fwd(params, x: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused chain over x (N, in) f32 -> (N, out) f32; the kernel on CUDA.

    compute_dtype None or float32 computes in f32, bfloat16 in bf16 with f32
    accumulation (the rounding points of the Pallas kernel)."""
    if x.device.type == "cpu":
        return mlp_plain(params, x, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_fused_fwd: unsupported device {x.device}")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"mlp_fused_fwd: unsupported compute dtype {compute_dtype}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("mlp_fused_fwd: x must be a contiguous 2-D float32 tensor")
    layers = params["layers"]
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"mlp_fused_fwd: 1..{MAX_LAYERS} layers supported")
    dims = [x.shape[1]]
    for layer in layers:
        w, b = layer["w"], layer["b"]
        if (w.dim() != 2 or w.shape[0] != dims[-1] or tuple(b.shape) != (w.shape[1],)
                or w.dtype != torch.float32 or b.dtype != torch.float32
                or w.device != x.device or b.device != x.device):
            raise ValueError("mlp_fused_fwd: layer shapes, dtypes or devices do not chain")
        dims.append(w.shape[1])
    if max(dims) > MAX_WIDTH:
        raise ValueError(f"mlp_fused_fwd: widths above {MAX_WIDTH} are not supported")
    n = x.shape[0]
    if n >= 2**31:
        raise ValueError("mlp_fused_fwd: too many rows for one launch")
    packed = torch.cat([t.reshape(-1) for layer in layers for t in (layer["w"], layer["b"])])
    y = torch.empty((n, dims[-1]), dtype=torch.float32, device=x.device)
    dims_c = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(x.device):
        MLP_FUSED_FWD.launch(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(), dims_c, len(layers), n,
            int(compute_dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    return y
