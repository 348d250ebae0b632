"""Volume-rendering weights and accumulation on fixed shapes
(port of umhs_tpu/ops/compositing.py).

Every ray carries a fixed lane of samples with a validity mask.
Transmittance is an exclusive cumulative sum of sigma * delta. Samples whose
alpha falls below `alpha_thre` neither emit nor attenuate, and samples behind
transmittance below `early_stop_eps` are dropped (nerfacc's visibility
filter). Per-ray sums over a ray-major compact buffer are prefix sums read
at segment boundaries in the plain version.

K6c (`render_weights`) and K6d (`compact_accumulate`, the per-ray sums of
one stage of the compact buffer with the weights gathered through `src`)
launch ``csrc/composite.cu`` on a CUDA tensor with impl="auto", forward and
backward; a CPU tensor, or impl="plain", takes the plain versions. The
kernels sum each ray's terms directly in ascending order, where the plain
version of K6d takes a prefix sum's difference, so the two round apart.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from ._native import Kernel
from .compact import Compaction, _check_impl, _stream, device_total

_P, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
_RAY_ARGS = [_P, _I64, _P, _I64, _P, _I64, _P, _I64, _I32, _I32, _P, _F32, _I32, _F32]
RENDER_WEIGHTS_FWD = Kernel("composite.cu", "umhs_render_weights_fwd", _RAY_ARGS + [_P, _P])
RENDER_WEIGHTS_BWD = Kernel("composite.cu", "umhs_render_weights_bwd",
                            _RAY_ARGS + [_P, _P, _P, _P, _P])
SEGMENT_ACCUMULATE_FWD = Kernel(
    "composite.cu", "umhs_segment_accumulate_fwd",
    [_P, _I64, _I32, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P, _P])
SEGMENT_ACCUMULATE_BWD = Kernel(
    "composite.cu", "umhs_segment_accumulate_bwd",
    [_P, _I64, _I32, _P, _P, _P, _I64, _I32, _P, _I32, _I32, _I32, _P, _P, _P])
MAX_SAMPLES = 256  # K6c: lanes per ray (a warp a ray, 8 chunks of 32)


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def render_weights_plain(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    mask: torch.Tensor,
    alpha_thre: Union[float, torch.Tensor] = 0.0,
    early_stop_eps: float = 1e-4,
) -> torch.Tensor:
    """Plain version of K6c: w_i = T_i * (1 - exp(-sigma_i * delta_i)) on
    (R, S); 0 on dropped lanes. alpha_thre may be a 0-dim tensor
    (min(0.01, mean(occs)) in the model)."""
    zero = torch.zeros((), dtype=sigmas.dtype, device=sigmas.device)
    delta = torch.clamp_min(t_ends - t_starts, 0.0)
    sigma_delta = torch.where(mask, sigmas * delta, zero)
    alphas = 1.0 - torch.exp(-sigma_delta)
    if not (isinstance(alpha_thre, (int, float)) and alpha_thre <= 0.0):
        keep = mask & (alphas.detach() >= alpha_thre)
        sigma_delta = torch.where(keep, sigma_delta, zero)
        alphas = torch.where(keep, alphas, zero)
    trans = torch.exp(-exclusive_cumsum(sigma_delta, dim=-1))
    if early_stop_eps > 0.0:
        alphas = torch.where(trans.detach() >= early_stop_eps, alphas, zero)
    return alphas * trans


def _ray_args(t_starts, t_ends, sigmas, mask, alpha_thre, early_stop_eps):
    """The shared leading arguments of K6c's launchers, after the checks."""
    inputs = (("t_starts", t_starts, torch.float32), ("t_ends", t_ends, torch.float32),
              ("sigmas", sigmas, torch.float32), ("mask", mask, torch.bool))
    for name, x, dtype in inputs:
        if x.dtype != dtype or x.dim() != 2 or x.shape != sigmas.shape or x.stride(1) != 1:
            raise ValueError(f"render_weights_cuda: {name} must be {dtype} of shape "
                             f"{tuple(sigmas.shape)} with unit column stride")
    R, S = sigmas.shape
    if not 1 <= S <= MAX_SAMPLES or R >= 2**31:
        raise ValueError(f"render_weights_cuda: ({R}, {S}) lanes; S must be 1 to {MAX_SAMPLES}")
    for name, x, _ in inputs:
        if x.device.type != "cuda" or x.device != sigmas.device:
            raise ValueError(f"render_weights_cuda: {name} must lie on the card with sigmas")
    thre_ptr, thre_val = None, 0.0
    use_thre = not (isinstance(alpha_thre, (int, float)) and alpha_thre <= 0.0)
    if isinstance(alpha_thre, torch.Tensor):
        if alpha_thre.numel() != 1 or alpha_thre.device != sigmas.device:
            raise ValueError("render_weights_cuda: a tensor alpha_thre must be one value on the "
                             "card")
        alpha_thre = alpha_thre.detach().float().contiguous()
        thre_ptr = alpha_thre.data_ptr()
    else:
        thre_val = float(alpha_thre)
    args = (t_starts.data_ptr(), t_starts.stride(0), t_ends.data_ptr(), t_ends.stride(0),
            sigmas.data_ptr(), sigmas.stride(0), mask.data_ptr(), mask.stride(0), R, S,
            thre_ptr, thre_val, int(use_thre), float(early_stop_eps))
    return args, alpha_thre  # the threshold tensor stays referenced through the launch


def render_weights_cuda(t_starts, t_ends, sigmas, mask, alpha_thre=0.0,
                        early_stop_eps=1e-4) -> torch.Tensor:
    """K6c forward on the card: (R, S) f32 inputs (any row stride) and bool
    mask -> (R, S) f32 weights."""
    args, _keep = _ray_args(t_starts, t_ends, sigmas, mask, alpha_thre, early_stop_eps)
    w = torch.empty(sigmas.shape, dtype=torch.float32, device=sigmas.device)
    with torch.cuda.device(sigmas.device):
        RENDER_WEIGHTS_FWD.launch(*args, w.data_ptr(), _stream(sigmas))
    return w


def render_weights_bwd_cuda(t_starts, t_ends, sigmas, mask, alpha_thre, early_stop_eps, g,
                            need=(True, True, True)):
    """K6c backward on the card: the gradients of (sigmas, t_starts, t_ends)
    for g (R, S), each None where `need` says so."""
    args, _keep = _ray_args(t_starts, t_ends, sigmas, mask, alpha_thre, early_stop_eps)
    g = g.float().contiguous()
    if g.shape != sigmas.shape or g.device != sigmas.device:
        raise ValueError("render_weights_bwd_cuda: g must match sigmas")
    outs = [torch.empty(sigmas.shape, dtype=torch.float32, device=sigmas.device) if n else None
            for n in need]
    with torch.cuda.device(sigmas.device):
        RENDER_WEIGHTS_BWD.launch(*args, g.data_ptr(),
                                  *[o.data_ptr() if o is not None else None for o in outs],
                                  _stream(sigmas))
    return tuple(outs)


class _RenderWeights(torch.autograd.Function):
    """K6c forward and backward; saves the inputs, recomputes the rest."""

    @staticmethod
    def forward(ctx, t_starts, t_ends, sigmas, mask, alpha_thre, early_stop_eps):
        ctx.save_for_backward(t_starts, t_ends, sigmas, mask)
        ctx.alpha_thre, ctx.early_stop_eps = alpha_thre, early_stop_eps
        return render_weights_cuda(t_starts, t_ends, sigmas, mask, alpha_thre, early_stop_eps)

    @staticmethod
    def backward(ctx, g):
        t_starts, t_ends, sigmas, mask = ctx.saved_tensors
        need = ctx.needs_input_grad
        dsigma, dts, dte = render_weights_bwd_cuda(
            t_starts, t_ends, sigmas, mask, ctx.alpha_thre, ctx.early_stop_eps, g,
            need=(need[2], need[0], need[1]))
        return dts, dte, dsigma, None, None, None


def render_weights(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    mask: torch.Tensor,
    alpha_thre: Union[float, torch.Tensor] = 0.0,
    early_stop_eps: float = 1e-4,
    impl: str = "auto",
) -> torch.Tensor:
    """w_i = T_i * (1 - exp(-sigma_i * delta_i)) on (R, S); 0 on dropped lanes.
    alpha_thre may be a 0-dim tensor (min(0.01, mean(occs)) in the model).
    K6c on a CUDA tensor with impl="auto" (forward and backward, gradients
    to sigmas, t_starts and t_ends), else the plain version."""
    _check_impl(impl)
    if impl == "plain" or sigmas.device.type == "cpu":
        return render_weights_plain(t_starts, t_ends, sigmas, mask, alpha_thre, early_stop_eps)
    if isinstance(alpha_thre, torch.Tensor):
        alpha_thre = alpha_thre.detach()
    return _RenderWeights.apply(t_starts, t_ends, sigmas, mask, alpha_thre, early_stop_eps)


def accumulate(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """sum_s w[r, s] * v[r, s, c]: (R, S), (R, S, C) -> (R, C)."""
    return torch.einsum("rs,rsc->rc", weights, values)


def segment_accumulate(
    weighted_values: torch.Tensor,
    ray_starts: torch.Tensor,
    ray_counts: torch.Tensor,
) -> torch.Tensor:
    """Per-ray sums over a ray-major compact buffer (B, C) whose rays own
    contiguous runs [start, start + count): inclusive prefix sum read at the
    run ends minus at the run starts. Returns (R, C) in the values' dtype.

    The prefix sum is taken in f64: in f32 the difference of two prefixes
    of ~10^4 loses ~1e-4 of each ray's sum at phase 7's 79,360 rays, which
    biased the plain step's loss (the mean of its squares) upward by ~7e-5
    relative, past the kernel-vs-plain step's tolerance (chip_smoke.py,
    phase 6). The plain version is that check's reference, so it is the
    accurate side; K6d sums each run directly in f32."""
    # scan along the last axis of the (C, B) transpose: CUDA's scan along a
    # leading axis of a (B, C) tensor ran ~40 ms per call at B = 2^17
    prefix = torch.cumsum(weighted_values.t(), dim=1, dtype=torch.float64)  # (C, B)
    last = prefix.shape[1] - 1
    ends = torch.clamp(ray_starts + ray_counts - 1, 0, last)
    end_vals = prefix[:, ends].t()
    start_vals = prefix[:, torch.clamp(ray_starts - 1, 0, last)].t()
    start_vals = torch.where((ray_starts > 0)[:, None], start_vals, torch.zeros_like(start_vals))
    out = (end_vals - start_vals).to(weighted_values.dtype)
    return torch.where((ray_counts > 0)[:, None], out, torch.zeros_like(out))


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    """Opacity per ray: (R, S) -> (R, 1)."""
    return torch.sum(weights, dim=-1, keepdim=True)


def render_depth_expected(
    weights: torch.Tensor,
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    mask: torch.Tensor,
    eps: float = 1e-10,
) -> torch.Tensor:
    """sum(w * mid) / (sum(w) + eps), clipped to the batch's sample range
    (nerfstudio's expected depth, as the JAX package computes it)."""
    mids = (t_starts + t_ends) / 2.0
    depth = torch.sum(weights * mids, dim=-1, keepdim=True)
    acc = torch.sum(weights, dim=-1, keepdim=True)
    depth = depth / (acc + eps)
    big = torch.finfo(mids.dtype).max
    mid_min = torch.amin(torch.where(mask, mids, torch.full_like(mids, big)))
    mid_max = torch.amax(torch.where(mask, mids, torch.full_like(mids, -big)))
    return torch.minimum(torch.maximum(depth, mid_min), mid_max)


def compact_accumulate_plain(weights: torch.Tensor, values: torch.Tensor,
                             c: Compaction) -> torch.Tensor:
    """Plain version of K6d: the stage's (R, L) weights gathered to the
    buffer's rows through `src` (times `live`), times the rows' values
    (Bs, C), summed per ray by segment_accumulate -> (R, C)."""
    w = weights.reshape(-1)[c.src] * c.live
    return segment_accumulate(w[:, None] * values, c.starts, c.counts)


def _check_segments(weights, values, c):
    if weights.dtype != torch.float32 or weights.shape != c.mask.shape or weights.stride(1) != 1:
        raise ValueError(f"compact_accumulate_cuda: weights must be float32 "
                         f"{tuple(c.mask.shape)} with unit column stride")
    if (values.dtype not in (torch.float32, torch.bfloat16) or values.dim() != 2
            or values.shape[0] != c.src.shape[0] or values.stride(1) != 1):
        raise ValueError(f"compact_accumulate_cuda: values must be float32 or bfloat16 "
                         f"({c.src.shape[0]}, C) with unit column stride")
    if c.src.dtype != torch.int64 or c.starts.dtype != torch.int64 or c.counts.dtype != torch.int64:
        raise ValueError("compact_accumulate_cuda: src, starts and counts must be int64")
    if weights.device.type != "cuda" or values.device != weights.device:
        raise ValueError("compact_accumulate_cuda: weights and values must lie on one card")
    if c.src.device != weights.device:
        raise ValueError("compact_accumulate_cuda: the compaction lies on another device")


def compact_accumulate_cuda(weights: torch.Tensor, values: torch.Tensor,
                            c: Compaction) -> torch.Tensor:
    """K6d forward on the card: (R, L) f32 weights (any row stride), (Bs, C)
    f32 or bf16 values -> (R, C) f32."""
    _check_segments(weights, values, c)
    R, L = weights.shape
    Bs, C = values.shape
    out = torch.empty((R, C), dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        SEGMENT_ACCUMULATE_FWD.launch(
            weights.data_ptr(), weights.stride(0), L, c.src.data_ptr(), c.starts.data_ptr(),
            c.counts.data_ptr(), values.data_ptr(), values.stride(0),
            int(values.dtype == torch.bfloat16), R, C, Bs, out.data_ptr(), _stream(values))
    return out


def compact_accumulate_bwd_cuda(weights: torch.Tensor, values: torch.Tensor, c: Compaction,
                                g: torch.Tensor, need_dw: bool = True):
    """K6d backward on the card: (d values (Bs, C) in values' dtype,
    d weights (R, L) f32 or None) for g (R, C)."""
    _check_segments(weights, values, c)
    R, L = weights.shape
    Bs, C = values.shape
    g = g.float().contiguous()
    if g.shape != (R, C) or g.device != values.device:
        raise ValueError(f"compact_accumulate_bwd_cuda: g must be ({R}, {C}) on the card")
    total = device_total(c)
    dh = torch.empty((Bs, C), dtype=values.dtype, device=values.device)
    dw = torch.zeros((R, L), dtype=torch.float32, device=values.device) if need_dw else None
    with torch.cuda.device(values.device):
        SEGMENT_ACCUMULATE_BWD.launch(
            weights.data_ptr(), weights.stride(0), L, c.src.data_ptr(), total.data_ptr(),
            values.data_ptr(), values.stride(0), int(values.dtype == torch.bfloat16),
            g.data_ptr(), R, C, Bs, dh.data_ptr(), dw.data_ptr() if dw is not None else None,
            _stream(values))
    return dh, dw


class _CompactAccumulate(torch.autograd.Function):
    """K6d forward and backward; the weights' gradient only when they take
    one (the DINO head's are detached)."""

    @staticmethod
    def forward(ctx, weights, values, c):
        ctx.save_for_backward(weights, values)
        ctx.c = c
        return compact_accumulate_cuda(weights, values, c)

    @staticmethod
    def backward(ctx, g):
        weights, values = ctx.saved_tensors
        dh, dw = compact_accumulate_bwd_cuda(weights, values, ctx.c, g,
                                             need_dw=ctx.needs_input_grad[0])
        return dw, dh if ctx.needs_input_grad[1] else None, None


def compact_accumulate(weights: torch.Tensor, values: torch.Tensor, c: Compaction,
                       impl: str = "auto") -> torch.Tensor:
    """Per-ray sums of one stage of the compact buffer: sum over each ray's
    rows b of weights[src[b]] * values[b] -> (R, C), for the stage's (R, L)
    weights and the rows' (Bs, C) values. K6d on a CUDA tensor with
    impl="auto" (forward and backward), else the plain version."""
    _check_impl(impl)
    if impl == "plain" or values.device.type == "cpu":
        return compact_accumulate_plain(weights, values, c)
    return _CompactAccumulate.apply(weights, values, c)
