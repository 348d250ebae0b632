"""Volume-rendering weights and accumulation on fixed shapes
(port of umhs_tpu/ops/compositing.py).

Every ray carries a fixed lane of samples with a validity mask.
Transmittance is an exclusive cumulative sum of sigma * delta. Samples whose
alpha falls below `alpha_thre` neither emit nor attenuate, and samples behind
transmittance below `early_stop_eps` are dropped (nerfacc's visibility
filter). Per-ray sums over a ray-major compact buffer are prefix sums read
at segment boundaries in the plain version.

K6c (`render_weights`) and K6d (`compact_accumulate_stages`, a head's
per-ray sums over every stage of the compact buffer with the weights
gathered through each stage's `src`, in one launch; `compact_accumulate`
is one stage) launch ``csrc/composite.cu`` on a CUDA tensor with
impl="auto", forward and backward; a CPU tensor, or impl="plain", takes the
plain versions. The kernels sum each ray's terms directly in ascending
order, where the plain version of K6d takes a prefix sum's difference, so
the two round apart; the stage sums are added in stage order in both.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple, Union

import torch

from ._native import Kernel
from .compact import Compaction, _check_impl, _stream, device_total

_P, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
_RAY_ARGS = [_P, _I64, _P, _I64, _P, _I64, _P, _I64, _I32, _I32, _P, _F32, _I32, _F32]
RENDER_WEIGHTS_FWD = Kernel("composite.cu", "umhs_render_weights_fwd", _RAY_ARGS + [_P, _P])
RENDER_WEIGHTS_BWD = Kernel("composite.cu", "umhs_render_weights_bwd",
                            _RAY_ARGS + [_P, _P, _P, _P, _P, _P, _P])
RENDER_WEIGHTS_BWD_ROUTES = ("short", "long")  # the route umhs_render_weights_bwd reports
SEGMENT_ACCUMULATE_FWD = Kernel(
    "composite.cu", "umhs_segment_accumulate_fwd",
    [_P, _I64, _P, _I32, _I32, _I32, _I32, _I32, _I32, _P, _P])
SEGMENT_ACCUMULATE_BWD = Kernel(
    "composite.cu", "umhs_segment_accumulate_bwd",
    [_P, _I64, _I32, _P, _P, _P, _I64, _I32, _P, _I32, _I32, _I32, _P, _P, _I64, _P])
SHORT_SAMPLES = 256  # K6c's backward: lanes a ray in one go (a warp a ray, 8 chunks of
# 32); past it, the long-ray kernel (groups of 256 lanes, a float of scratch a group)
MAX_SAMPLES = 2**31 - 33  # K6c: a lane index stays an int32
MAX_STAGES = 8  # K6d's forward: stages a launch takes (more chain launches)


class SegmentStage(ctypes.Structure):
    """One stage of a head for K6d's forward (csrc/composite.cu
    `umhs::SegmentStage`)."""

    _fields_ = [("src", _P), ("starts", _P), ("counts", _P), ("h", _P), ("h_stride", _I64),
                ("lo", _I32), ("L", _I32), ("vec", _I32), ("pad", _I32)]


# a stage of a head: (lo, hi, values (Bs, C), its Compaction), the stage's
# lanes being columns [lo, hi) of the (R, S) weights
Stage = Tuple[int, int, torch.Tensor, Compaction]


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
    if S > MAX_SAMPLES or R >= 2**31:
        raise ValueError(f"render_weights_cuda: ({R}, {S}) lanes is beyond the kernel's int32 "
                         f"ray and lane indices (R < 2^31, S <= {MAX_SAMPLES})")
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
    R, S = sigmas.shape
    # past SHORT_SAMPLES lanes: the forward's carry at each 256-lane group, a float a group
    carries = (torch.empty((R, -(-S // SHORT_SAMPLES)), dtype=torch.float32,
                           device=sigmas.device) if S > SHORT_SAMPLES else None)
    with torch.cuda.device(sigmas.device):
        RENDER_WEIGHTS_BWD.launch(*args, g.data_ptr(),
                                  *[o.data_ptr() if o is not None else None for o in outs],
                                  None if carries is None else carries.data_ptr(),
                                  _stream(sigmas), routes=RENDER_WEIGHTS_BWD_ROUTES)
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
    """Plain version of K6d for one stage: the stage's (R, L) weights
    gathered to the buffer's rows through `src` (times `live`), times the
    rows' values (Bs, C), summed per ray by segment_accumulate -> (R, C)."""
    w = weights.reshape(-1)[c.src] * c.live
    return segment_accumulate(w[:, None] * values, c.starts, c.counts)


def compact_accumulate_stages_plain(weights: torch.Tensor,
                                    stages: Sequence[Stage]) -> torch.Tensor:
    """Plain version of K6d: each stage's sums (compact_accumulate_plain on
    its columns of the (R, S) weights) added in stage order."""
    return sum(compact_accumulate_plain(weights[:, lo:hi], v, c) for lo, hi, v, c in stages)


def accumulate_group_lanes(C: int) -> int:
    """K6d's forward: lanes a ray, four channels a lane, the fewest powers
    of two that cover C up to 32 (a 128-wide head takes a warp, a 6-wide
    one two lanes, 16 rays a warp)."""
    return min(32, 1 << max(0, (-(-C // 4) - 1).bit_length()))


def accumulate_vector_rows(values: torch.Tensor) -> bool:
    """K6d's forward: whether a stage's rows take vector loads (four
    channels a load: C and the row stride multiples of 4, the base 16-byte
    aligned for f32, 8-byte for bf16); else the same kernel's scalar loads."""
    C = values.shape[1]
    align = 8 if values.dtype == torch.bfloat16 else 16
    return C % 4 == 0 and values.stride(0) % 4 == 0 and values.data_ptr() % align == 0


def _check_stages(weights: torch.Tensor, stages: Sequence[Stage]) -> None:
    name = "compact_accumulate_stages_cuda"
    if weights.dtype != torch.float32 or weights.dim() != 2 or weights.stride(1) != 1:
        raise ValueError(f"{name}: weights must be float32 (R, S) with unit column stride")
    if not stages:
        raise ValueError(f"{name}: needs at least one stage")
    R, S = weights.shape
    dtype, C = stages[0][2].dtype, stages[0][2].shape[-1]
    for lo, hi, values, c in stages:
        if not 0 <= lo < hi <= S or c.mask.shape != (R, hi - lo):
            raise ValueError(f"{name}: a stage's lanes [{lo}, {hi}) and its compaction "
                             f"{tuple(c.mask.shape)} do not fit weights {(R, S)}")
        if (values.dtype not in (torch.float32, torch.bfloat16) or values.dim() != 2
                or values.shape[0] != c.src.shape[0] or values.stride(1) != 1):
            raise ValueError(f"{name}: values must be float32 or bfloat16 "
                             f"({c.src.shape[0]}, C) with unit column stride")
        if values.dtype != dtype or values.shape[1] != C:
            raise ValueError(f"{name}: every stage's values must be {dtype} with {C} channels")
        if any(t.dtype != torch.int64 for t in (c.src, c.starts, c.counts)):
            raise ValueError(f"{name}: src, starts and counts must be int64")
    if weights.device.type != "cuda":
        raise ValueError(f"{name}: weights and values must lie on one card")
    for _, _, values, c in stages:
        if values.device != weights.device or c.src.device != weights.device:
            raise ValueError(f"{name}: weights and values must lie on one card, with the "
                             "compactions")


def compact_accumulate_stages_cuda(weights: torch.Tensor,
                                   stages: Sequence[Stage]) -> torch.Tensor:
    """K6d forward on the card: one head's (R, C) f32 per-ray sums over every
    stage, one launch for up to MAX_STAGES stages. weights: the (R, S) f32
    weights (any row stride); each stage's values (Bs, C) f32 or bf16."""
    _check_stages(weights, stages)
    R = weights.shape[0]
    values0 = stages[0][2]
    C = values0.shape[1]
    out = torch.empty((R, C), dtype=torch.float32, device=weights.device)
    descs = [SegmentStage(c.src.data_ptr(), c.starts.data_ptr(), c.counts.data_ptr(),
                          v.data_ptr(), v.stride(0), lo, hi - lo, int(accumulate_vector_rows(v)),
                          0) for lo, hi, v, c in stages]
    SEGMENT_ACCUMULATE_FWD.check_struct("umhs_segment_stage_size", SegmentStage)
    with torch.cuda.device(weights.device):
        for k in range(0, len(descs), MAX_STAGES):
            chunk = descs[k:k + MAX_STAGES]
            SEGMENT_ACCUMULATE_FWD.launch(
                weights.data_ptr(), weights.stride(0), (SegmentStage * len(chunk))(*chunk),
                len(chunk), int(values0.dtype == torch.bfloat16), R, C,
                accumulate_group_lanes(C), int(k > 0), out.data_ptr(), _stream(weights))
    return out


def compact_accumulate_cuda(weights: torch.Tensor, values: torch.Tensor,
                            c: Compaction) -> torch.Tensor:
    """K6d forward on the card for one stage: (R, L) f32 weights (any row
    stride), (Bs, C) f32 or bf16 values -> (R, C) f32."""
    return compact_accumulate_stages_cuda(weights, [(0, weights.shape[-1], values, c)])


def compact_accumulate_stages_bwd_cuda(weights: torch.Tensor, stages: Sequence[Stage],
                                       g: torch.Tensor, need_dw: bool = True):
    """K6d backward on the card, a launch a stage: (d weights (R, S) f32,
    zero off the stages' columns, or None; [d values (Bs, C) in values'
    dtype] a stage) for g (R, C)."""
    _check_stages(weights, stages)
    R, S = weights.shape
    C = stages[0][2].shape[1]
    g = g.float().contiguous()
    if g.shape != (R, C) or g.device != weights.device:
        raise ValueError(f"compact_accumulate_stages_bwd_cuda: g must be ({R}, {C}) on the card")
    dw = torch.zeros((R, S), dtype=torch.float32, device=weights.device) if need_dw else None
    dhs: List[torch.Tensor] = []
    with torch.cuda.device(weights.device):
        for lo, hi, values, c in stages:
            total = device_total(c)
            Bs = values.shape[0]
            dh = torch.empty((Bs, C), dtype=values.dtype, device=values.device)
            w = weights[:, lo:hi]
            SEGMENT_ACCUMULATE_BWD.launch(
                w.data_ptr(), w.stride(0), hi - lo, c.src.data_ptr(), total.data_ptr(),
                values.data_ptr(), values.stride(0), int(values.dtype == torch.bfloat16),
                g.data_ptr(), R, C, Bs, dh.data_ptr(),
                dw[:, lo:hi].data_ptr() if dw is not None else None, S, _stream(values))
            dhs.append(dh)
    return dw, dhs


def compact_accumulate_bwd_cuda(weights: torch.Tensor, values: torch.Tensor, c: Compaction,
                                g: torch.Tensor, need_dw: bool = True):
    """K6d backward on the card for one stage: (d values (Bs, C) in values'
    dtype, d weights (R, L) f32 or None) for g (R, C)."""
    dw, (dh,) = compact_accumulate_stages_bwd_cuda(weights, [(0, weights.shape[-1], values, c)],
                                                   g, need_dw)
    return dh, dw


class _CompactAccumulateStages(torch.autograd.Function):
    """K6d forward (one launch over the stages) and backward (a launch a
    stage into one dw); the weights' gradient only when they take one (the
    DINO head's are detached)."""

    @staticmethod
    def forward(ctx, weights, meta, *values):
        ctx.save_for_backward(weights, *values)
        ctx.meta = meta
        return compact_accumulate_stages_cuda(
            weights, [(lo, hi, v, c) for (lo, hi, c), v in zip(meta, values)])

    @staticmethod
    def backward(ctx, g):
        weights, *values = ctx.saved_tensors
        stages = [(lo, hi, v, c) for (lo, hi, c), v in zip(ctx.meta, values)]
        dw, dhs = compact_accumulate_stages_bwd_cuda(weights, stages, g,
                                                     need_dw=ctx.needs_input_grad[0])
        return (dw, None, *(dh if need else None
                            for dh, need in zip(dhs, ctx.needs_input_grad[2:])))


def compact_accumulate_stages(weights: torch.Tensor, stages: Sequence[Stage],
                              impl: str = "auto") -> torch.Tensor:
    """A head's per-ray sums over every stage of the compact buffer, added in
    stage order: for each stage (lo, hi, values (Bs, C), compaction), the sum
    over each ray's rows b of weights[r, lo + src[b] - r * L] * values[b] ->
    (R, C). K6d on a CUDA tensor with impl="auto" (forward and backward),
    else the plain version."""
    _check_impl(impl)
    if impl == "plain" or weights.device.type == "cpu":
        return compact_accumulate_stages_plain(weights, stages)
    meta = [(lo, hi, c) for lo, hi, _, c in stages]
    return _CompactAccumulateStages.apply(weights, meta, *(v for _, _, v, _ in stages))


def compact_accumulate(weights: torch.Tensor, values: torch.Tensor, c: Compaction,
                       impl: str = "auto") -> torch.Tensor:
    """Per-ray sums of one stage of the compact buffer: sum over each ray's
    rows b of weights[src[b]] * values[b] -> (R, C), for the stage's (R, L)
    weights and the rows' (Bs, C) values (compact_accumulate_stages with
    one stage)."""
    return compact_accumulate_stages(weights, [(0, weights.shape[-1], values, c)], impl)
