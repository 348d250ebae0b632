"""K1 and K2: the fused-MLP forward and backward kernels' wrappers, the
autograd Function that joins them, and their plain versions.

`mlp_fused_fwd` runs a whole layer chain (ReLU between layers, linear last
layer) through ``csrc/mlp_fused_fwd.cu``, the port of the Pallas kernel
``umhs_tpu/ops/pallas/mlp_fused.py::_fwd_kernel``. Its launcher picks the
kernel by mode and shape. Under a bf16 compute dtype a chain whose widths,
padded (inputs to 16, hidden widths to 16, the output to 8), are all at most
128 runs on the tensor cores with its activations in registers (the four
field chains, the proposal chain); a chain of one or two layers up to 256
wide (the DINO head's 15 -> 256 -> 128) runs the wide tensor-core kernel,
its activations in shared memory; f32, and deeper chains wider than 128,
run the f32 FMA kernel in one launch. Every other chain (a width above 256,
more than 8 layers, or weights that leave the FMA kernels no room in a
block's shared memory) takes, in bf16, the fused route where its hidden
widths are at most 256 and its tiles fit (``csrc/mlp_chain_fused.cuh``: the
whole chain in one launch, 64 rows a tile, x read once, y written once),
else the general route (``csrc/mlp_general.cuh``: a product per layer, in
bf16 on wgmma over 128 x 256 tiles fed by TMA, in f32 on the FMA kernel over
64 x 64 tiles, the activations through a device scratch). The wrapper
allocates what the launcher asks for (`mlp_fused_fwd_scratch_bytes`: the
packed weights, the general route's activations). The launcher reports the
route it took (`MLP_FWD_ROUTES`, counted in `Kernel.routes`);
`mlp_fused_fwd_route` names it before a launch.

`mlp_fused_bwd` runs ``csrc/mlp_fused_bwd.cu``, the port of ``_bwd_kernel``:
it recomputes the forward and returns dx (unless not wanted) and every
dW_i, db_i. Its launcher, too, picks the kernel by mode and shape: a bf16
chain within 128 padded wide whose dW tiles fit its warps' registers (the
field chains) runs on the tensor cores, recomputing with K1's own chain; a
bf16 two-layer chain up to 256 wide (the DINO head) runs the wide
tensor-core kernel, which splits the hidden width into slices of 64
columns, one per block row of the grid, and recomputes with K1's wide
arithmetic; f32 and other chains within the FMA kernels' limits run the f32
FMA kernel; the rest take K1's rule: the fused route (one launch over
fixed row ranges, recomputing with K1's fused code, dW and db summed per
range, then over the ranges in order) or the general route, which
recomputes with K1's general products (`MLP_BWD_ROUTES`,
`mlp_fused_bwd_route`). With more than
one slice, dx comes from per-slice partials summed in slice order
(`dx_partials`). The scratch of partial sums is sized by the library
(`umhs_mlp_fused_bwd_scratch_bytes`). `mlp_fused` is the
`torch.autograd.Function` over both: its forward saves only x and the
weights, as the JAX custom VJP does.

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
import functools
from typing import List, Optional, Tuple

import torch

from ._native import Kernel

MLP_FUSED_FWD = Kernel(
    "mlp_fused_fwd.cu",
    "umhs_mlp_fused_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
     ctypes.c_void_p],
)
MLP_FUSED_BWD = Kernel(
    "mlp_fused_bwd.cu",
    "umhs_mlp_fused_bwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
)
# The routes the launchers report, by the index they write (the device
# kernel each runs, named as ptxas names it; "mlp_general<bf16>" is the
# general route's products in csrc/mlp_general.cuh, mlp_wgmma_kernel in bf16
# and mlp_gemm_kernel in f32; "mlp_chain_*_kernel" the fused route's
# kernels in csrc/mlp_chain_fused.cuh).
MLP_FWD_ROUTES = ("mlp_fused_fwd_kernel<0>", "mlp_fused_fwd_kernel<1>",
                  "mlp_fused_fwd_tc_kernel<4,2>", "mlp_fused_fwd_tc_kernel<8,1>",
                  "mlp_fused_fwd_wide_kernel", "mlp_general<0>", "mlp_general<1>",
                  "mlp_chain_fwd_kernel")
MLP_BWD_ROUTES = ("mlp_fused_bwd_kernel<0>", "mlp_fused_bwd_kernel<1>",
                  "mlp_fused_bwd_tc_kernel<8,8>", "mlp_fused_bwd_tc_kernel<4,8>",
                  "mlp_fused_bwd_tc_kernel<4,16>", "mlp_fused_bwd_wide_kernel",
                  "mlp_general<0>", "mlp_general<1>", "mlp_chain_bwd_kernel")

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
    if not layers:
        raise ValueError(f"{name}: a chain needs a layer")
    dims = [x.shape[1]]
    for layer in layers:
        w, b = layer["w"], layer["b"]
        if (w.dim() != 2 or w.shape[0] != dims[-1] or tuple(b.shape) != (w.shape[1],)
                or w.dtype != torch.float32 or b.dtype != torch.float32
                or w.device != x.device or b.device != x.device):
            raise ValueError(f"{name}: layer shapes, dtypes or devices do not chain")
        dims.append(w.shape[1])
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
    bf16 = int(compute_dtype == torch.bfloat16)
    dims_c = (ctypes.c_int * len(dims))(*dims)
    nbytes = _scratch_bytes(MLP_FUSED_FWD, "umhs_mlp_fused_fwd_scratch_bytes", dims_c,
                            len(dims) - 1, bf16, x.shape[0])
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device) if nbytes else None
    with torch.cuda.device(x.device):
        MLP_FUSED_FWD.launch(
            x.data_ptr(), packed.data_ptr(), y.data_ptr(), dims_c, len(dims) - 1, x.shape[0],
            bf16, scratch.data_ptr() if nbytes else None, nbytes,
            torch.cuda.current_stream(x.device).cuda_stream, routes=MLP_FWD_ROUTES,
        )
    return y


def mlp_fused_bwd(params, x: torch.Tensor, g: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None, need_dx: bool = True
                  ) -> Tuple[Optional[torch.Tensor], LayerGrads]:
    """Backward of the chain at x (N, in) for the output gradient g (N, out):
    (dx (N, in) f32 or None, [(dW_i, db_i)]); K2 on CUDA.

    The kernels sum dW/db per block into a scratch buffer of partials and
    then over the blocks in a fixed order, so the result is the same on
    every run."""
    if x.device.type == "cpu":
        return mlp_plain_bwd(params, x, g, compute_dtype, need_dx)
    dims = _chain_dims("mlp_fused_bwd", params, x, compute_dtype)
    n = x.shape[0]
    if g.dtype != torch.float32 or tuple(g.shape) != (n, dims[-1]) or g.device != x.device:
        raise ValueError("mlp_fused_bwd: g must be a float32 (N, out) tensor on x's device")
    g = g.contiguous()
    # views at an odd offset: the kernels copy rows in 16-byte pieces
    x = x.clone() if x.data_ptr() % 16 else x
    g = g.clone() if g.data_ptr() % 16 else g
    packed = _packed(params)
    max_blocks = 2 * torch.cuda.get_device_properties(x.device).multi_processor_count
    bf16 = int(compute_dtype == torch.bfloat16)
    dims_c = (ctypes.c_int * len(dims))(*dims)
    nbytes = _scratch_bytes(MLP_FUSED_BWD, "umhs_mlp_fused_bwd_scratch_bytes", dims_c,
                            len(dims) - 1, bf16, n, max_blocks)
    partials = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    dparams = torch.empty_like(packed)
    dx = torch.empty((n, dims[0]), dtype=torch.float32, device=x.device) if need_dx else None
    slices = (_call_int(MLP_FUSED_BWD, "umhs_mlp_fused_bwd_dx_slices", tuple(dims), bf16)
              if need_dx else 0)
    dx_partials = (torch.empty((slices, n, dims[0]), dtype=torch.float32, device=x.device)
                   if slices else None)
    with torch.cuda.device(x.device):
        MLP_FUSED_BWD.launch(
            x.data_ptr(), g.data_ptr(), packed.data_ptr(),
            dx.data_ptr() if need_dx else None,
            dx_partials.data_ptr() if slices else None, partials.data_ptr(), nbytes,
            dparams.data_ptr(), dims_c, len(dims) - 1, n, bf16, max_blocks,
            torch.cuda.current_stream(x.device).cuda_stream, routes=MLP_BWD_ROUTES,
        )
    grads, off = [], 0
    for layer in params["layers"]:
        w, b = layer["w"], layer["b"]
        dw = dparams[off:off + w.numel()].view(w.shape)
        off += w.numel()
        grads.append((dw, dparams[off:off + b.numel()]))
        off += b.numel()
    return dx, grads


@functools.lru_cache(maxsize=None)
def _call_int(kernel: Kernel, symbol: str, dims: Tuple[int, ...], bf16: int) -> int:
    """An int query of a kernel's library about the chain `dims` in a mode
    (loads, and builds, the kernels); asked once per chain and mode, since
    the wrappers ask it on every call."""
    fn = getattr(kernel.library(), symbol)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn((ctypes.c_int * len(dims))(*dims), len(dims) - 1, bf16)


def _scratch_bytes(kernel: Kernel, symbol: str, dims_c, num_layers: int, *args: int) -> int:
    """Bytes of device scratch a launcher needs for the chain (an int64
    query of its library; n-dependent, so not cached)."""
    fn = getattr(kernel.library(), symbol)
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   *[ctypes.c_int] * (len(args) - 2)]
    fn.restype = ctypes.c_int64
    return int(fn(dims_c, num_layers, *args))


def _route_name(stem: str, code: int, bf16: int) -> str:
    if code < 0:
        raise ValueError(f"{stem}: the launcher refuses this chain")
    if code == 0:
        return f"{stem}_kernel<{bf16}>"
    if code == 1:
        return f"{stem}_wide_kernel"
    if code == 2:
        return f"mlp_general<{bf16}>"
    if code == 3:
        return stem.replace("fused", "chain") + "_kernel"
    return f"{stem}_tc_kernel<{code // 100},{code % 100}>"


def mlp_fused_fwd_route(dims: List[int], compute_dtype: Optional[torch.dtype]) -> str:
    """The device kernel K1's launcher runs for the chain of widths `dims` in
    this mode, named as ptxas names it: "mlp_fused_fwd_tc_kernel<kKT,kM>" or
    "mlp_fused_fwd_wide_kernel" (the tensor cores),
    "mlp_fused_fwd_kernel<bf16>" (the FMA kernel), "mlp_chain_fwd_kernel"
    (the fused route) or "mlp_general<bf16>" (the general route). Loads (and
    builds) the kernels."""
    bf16 = int(compute_dtype == torch.bfloat16)
    code = _call_int(MLP_FUSED_FWD, "umhs_mlp_fused_fwd_route", tuple(dims), bf16)
    return _route_name("mlp_fused_fwd", code, bf16)


def mlp_fused_bwd_route(dims: List[int], compute_dtype: Optional[torch.dtype]) -> str:
    """The device kernel K2's launcher runs for the chain of widths `dims` in
    this mode, named as ptxas names it: "mlp_fused_bwd_tc_kernel<kKT,kOwn>"
    or "mlp_fused_bwd_wide_kernel" (the tensor cores),
    "mlp_fused_bwd_kernel<bf16>" (the FMA kernel), "mlp_chain_bwd_kernel"
    (the fused route) or "mlp_general<bf16>" (the general route). Loads (and
    builds) the kernels."""
    bf16 = int(compute_dtype == torch.bfloat16)
    code = _call_int(MLP_FUSED_BWD, "umhs_mlp_fused_bwd_route", tuple(dims), bf16)
    return _route_name("mlp_fused_bwd", code, bf16)


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
