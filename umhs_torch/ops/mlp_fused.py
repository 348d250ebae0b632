"""K1 and K2: the fused-MLP forward and backward kernels' wrappers, the
autograd Function that joins them, and their plain versions.

`mlp_fused_fwd` runs a whole layer chain (ReLU between layers, linear last
layer) in one launch of ``csrc/mlp_fused_fwd.cu``, the port of the Pallas
kernel ``umhs_tpu/ops/pallas/mlp_fused.py::_fwd_kernel``. Its launcher picks
the kernel by mode and shape: under a bf16 compute dtype a chain whose widths,
padded (inputs to 16, hidden widths to 16, the output to 8), are all at most
128 runs on the tensor cores (mma.sync, activations kept in registers; the
four field chains); f32, and a bf16 chain with a wider layer (the DINO head's
256), run the f32 FMA kernel. Either way it is the one launch counted.

`mlp_fused_bwd` runs ``csrc/mlp_fused_bwd.cu``, the port of ``_bwd_kernel``:
it recomputes the forward per tile and returns dx (unless not wanted) and
every dW_i, db_i. `mlp_fused` is the `torch.autograd.Function` over both:
its forward saves only x and the weights, as the JAX custom VJP does.

On a CPU tensor each wrapper runs its plain version instead; on a CUDA
tensor the kernel is the only path and a failed build or launch raises.
`mlp_plain` is the plain forward (``umhs_tpu/ops/mlp.py:95-104``) at the
Pallas kernels' rounding points: under a bf16 compute dtype, x, W_i and the
hidden activations are rounded to bf16 and the biases are added in f32.
(The JAX package's unfused path also rounds the biases to bf16; that moves
pre-activations across the ReLU often enough to change bf16 gradients by
~4% in norm.) `mlp_plain_bwd`, autograd through `mlp_plain`, is K2's plain
version.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

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
MLP_FUSED_BWD = Kernel(
    "mlp_fused_bwd.cu",
    "umhs_mlp_fused_bwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p],
)

LayerGrads = List[Tuple[torch.Tensor, torch.Tensor]]


def mlp_plain(params, x: torch.Tensor,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain layer chain: inputs and weights cast to `compute_dtype`,
    products summed in f32 (bf16 values multiply exactly in f32), biases
    added in f32, ReLU between layers, f32 out."""
    layers = params["layers"]
    h = x if compute_dtype is None else x.to(compute_dtype)
    for i, layer in enumerate(layers):
        w = layer["w"] if compute_dtype is None else layer["w"].to(compute_dtype)
        h = h.float() @ w.float() + layer["b"].float()
        if i + 1 < len(layers):
            h = torch.relu(h)
            if compute_dtype is not None:
                h = h.to(compute_dtype)
    return h


def mlp_plain_bwd(params, x: torch.Tensor, g: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None, need_dx: bool = True
                  ) -> Tuple[Optional[torch.Tensor], LayerGrads]:
    """Plain version of K2: (dx or None, [(dW_i, db_i)]) of <mlp_plain(x), g>."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(need_dx)
        layers = [{"w": lay["w"].detach().requires_grad_(True),
                   "b": lay["b"].detach().requires_grad_(True)} for lay in params["layers"]]
        y = mlp_plain({"layers": layers}, x, compute_dtype)
        wanted = [t for lay in layers for t in (lay["w"], lay["b"])]
        grads = torch.autograd.grad(y, ([x] if need_dx else []) + wanted, g)
    dx = grads[0] if need_dx else None
    flat = grads[1:] if need_dx else grads
    return dx, [(flat[2 * i], flat[2 * i + 1]) for i in range(len(layers))]


def _chain_dims(name: str, params, x: torch.Tensor, compute_dtype) -> List[int]:
    """Layer widths [in, w1, ..., out] after checking what the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: unsupported compute dtype {compute_dtype}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 2-D float32 tensor")
    layers = params["layers"]
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"{name}: 1..{MAX_LAYERS} layers supported")
    dims = [x.shape[1]]
    for layer in layers:
        w, b = layer["w"], layer["b"]
        if (w.dim() != 2 or w.shape[0] != dims[-1] or tuple(b.shape) != (w.shape[1],)
                or w.dtype != torch.float32 or b.dtype != torch.float32
                or w.device != x.device or b.device != x.device):
            raise ValueError(f"{name}: layer shapes, dtypes or devices do not chain")
        dims.append(w.shape[1])
    if max(dims) > MAX_WIDTH:
        raise ValueError(f"{name}: widths above {MAX_WIDTH} are not supported")
    if x.shape[0] >= 2**31:
        raise ValueError(f"{name}: too many rows for one launch")
    return dims


def _packed(params) -> torch.Tensor:
    """[W0, b0, W1, b1, ...] flattened, the kernels' weight layout."""
    return torch.cat([t.detach().reshape(-1) for layer in params["layers"]
                      for t in (layer["w"], layer["b"])])


def mlp_fused_fwd(params, x: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused chain over x (N, in) f32 -> (N, out) f32; K1 on CUDA.

    compute_dtype None or float32 computes in f32, bfloat16 in bf16 with f32
    accumulation (the rounding points of the Pallas kernel)."""
    if x.device.type == "cpu":
        return mlp_plain(params, x, compute_dtype)
    dims = _chain_dims("mlp_fused_fwd", params, x, compute_dtype)
    if x.data_ptr() % 16:  # a view at an odd offset: the kernel copies rows in 16-byte pieces
        x = x.clone()
    packed = _packed(params)
    y = torch.empty((x.shape[0], dims[-1]), dtype=torch.float32, device=x.device)
    dims_c = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(x.device):
        MLP_FUSED_FWD.launch(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(), dims_c, len(dims) - 1, x.shape[0],
            int(compute_dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    return y


def mlp_fused_bwd(params, x: torch.Tensor, g: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None, need_dx: bool = True
                  ) -> Tuple[Optional[torch.Tensor], LayerGrads]:
    """Backward of the chain at x (N, in) for the output gradient g (N, out):
    (dx (N, in) f32 or None, [(dW_i, db_i)]); K2 on CUDA.

    The kernel sums dW/db per block into a scratch buffer of partials and
    then over the blocks in a fixed order, so its result is the same on
    every run."""
    if x.device.type == "cpu":
        return mlp_plain_bwd(params, x, g, compute_dtype, need_dx)
    dims = _chain_dims("mlp_fused_bwd", params, x, compute_dtype)
    n = x.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (n, dims[-1]) or g.device != x.device:
        raise ValueError("mlp_fused_bwd: g must be a float32 (N, out) tensor on x's device")
    g = g.contiguous()
    packed = _packed(params)
    max_blocks = 2 * torch.cuda.get_device_properties(x.device).multi_processor_count
    partials = torch.empty((max_blocks, packed.numel()), dtype=torch.float32, device=x.device)
    dparams = torch.empty_like(packed)
    dx = torch.empty((n, dims[0]), dtype=torch.float32, device=x.device) if need_dx else None
    dims_c = (ctypes.c_int * len(dims))(*dims)
    with torch.cuda.device(x.device):
        MLP_FUSED_BWD.launch(
            x.data_ptr(), g.data_ptr(), packed.data_ptr(),
            dx.data_ptr() if need_dx else None, partials.data_ptr(), dparams.data_ptr(),
            dims_c, len(dims) - 1, n, int(compute_dtype == torch.bfloat16), max_blocks,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    grads, off = [], 0
    for layer in params["layers"]:
        w, b = layer["w"], layer["b"]
        dw = dparams[off:off + w.numel()].view(w.shape)
        off += w.numel()
        grads.append((dw, dparams[off:off + b.numel()]))
        off += b.numel()
    return dx, grads


class _MLPFused(torch.autograd.Function):
    """K1 forward, K2 backward; saves x and the weights only."""

    @staticmethod
    def forward(ctx, x, compute_dtype, *weights):
        params = {"layers": [{"w": weights[i], "b": weights[i + 1]}
                             for i in range(0, len(weights), 2)]}
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(x, *weights)
        return mlp_fused_fwd(params, x, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        params = {"layers": [{"w": weights[i], "b": weights[i + 1]}
                             for i in range(0, len(weights), 2)]}
        dx, grads = mlp_fused_bwd(params, x, g.float(), ctx.compute_dtype,
                                  need_dx=ctx.needs_input_grad[0])
        return (dx, None, *[t for pair in grads for t in pair])


def mlp_fused(params, x: torch.Tensor,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Differentiable fused chain: K1 forward and K2 backward on CUDA."""
    weights = [t for layer in params["layers"] for t in (layer["w"], layer["b"])]
    return _MLPFused.apply(x, compute_dtype, *weights)
