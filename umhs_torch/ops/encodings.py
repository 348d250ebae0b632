"""Position and direction encodings (port of umhs_tpu/ops/encodings.py).

- `nerf_encoding`: sin/cos frequency features.
- `sh_encoding`: real spherical harmonics up to degree 4, closed form.
- The multi-resolution hash grid: `HashEncodingConfig`, `init_hash_table`,
  the readable `hash_encode_reference`, and `hash_encode`, an autograd
  Function whose forward is K3 (``csrc/hash_encode_fwd.cu``) and whose
  backward is K4 (``csrc/hash_encode_bwd.cu``) on a CUDA tensor, and their
  plain versions `hash_encode_plain` and `hash_encode_bwd_plain` on a CPU
  tensor. The table is flat, (T * F,), feature interleaved, as in the JAX
  package. The forward saves only the positions (the JAX residual) and the
  positions get no gradient, as in the JAX custom VJP.

On a CUDA tensor K3 and K4 take every configuration they accept (F in 1, 2,
4, 8; L up to 32; tetrahedral or trilinear) and K4 both modes, stochastic
(the main path's) and deterministic, in one kernel each: one thread per
sample and level in K3, one thread per sample looping over the levels in
K4, with vector reductions into the table and, on the dense levels, the
lanes of a warp that share a row summed before their one reduction.

Indices are computed in int64. The XOR-prime hash wraps in uint32 on the
TPU and in the kernel, so the plain versions mask it with 0xFFFFFFFF before
taking it modulo the (power-of-two) hashmap size.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ._native import Kernel


def nerf_encoding(
    x: torch.Tensor,
    num_frequencies: int = 2,
    min_freq_exp: float = 0.0,
    max_freq_exp: float = 1.0,
    include_input: bool = False,
) -> torch.Tensor:
    """sin/cos(2^f * 2*pi * x); output dim in_dim * num_frequencies * 2."""
    freqs = 2.0 ** np.linspace(min_freq_exp, max_freq_exp, num_frequencies)
    freqs = torch.as_tensor(freqs, dtype=x.dtype, device=x.device)
    scaled = (2.0 * math.pi * x)[..., None] * freqs  # (..., D, F)
    enc = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)
    enc = enc.reshape(*x.shape[:-1], x.shape[-1] * num_frequencies * 2)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def sh_encoding(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Real spherical harmonics of unit directions, degrees 0..levels-1."""
    if not 1 <= levels <= 4:
        raise ValueError("sh_encoding supports 1..4 levels")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    out = [torch.full_like(x, 0.28209479177387814)]
    if levels >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if levels >= 3:
        xy, yz, xz = x * y, y * z, x * z
        x2, y2, z2 = x * x, y * y, z * z
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (x2 - y2),
        ]
    if levels >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)


_HASH_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashEncodingConfig:
    """Static configuration of the multi-resolution hash grid."""

    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    max_resolution: int = 2048
    # "trilinear" = 8 cube corners; "tetrahedral" = 4 simplex vertices
    interpolation: str = "trilinear"
    # backward splats each (sample, level) gradient onto one vertex, drawn
    # with probability equal to its weight, instead of onto all V
    stochastic_grad: bool = True

    @property
    def verts_per_cell(self) -> int:
        return 4 if self.interpolation == "tetrahedral" else 8

    @property
    def growth_factor(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return math.exp(
            (math.log(self.max_resolution) - math.log(self.base_resolution))
            / (self.num_levels - 1)
        )

    @property
    def hashmap_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def scales(self) -> Sequence[float]:
        """Per-level grid scale: a position in [0, 1] is multiplied by it."""
        return tuple(
            self.base_resolution * self.growth_factor**lvl - 1.0
            for lvl in range(self.num_levels)
        )

    @property
    def resolutions(self) -> Sequence[int]:
        return tuple(int(math.ceil(s)) + 1 for s in self.scales)

    @property
    def dense(self) -> Sequence[bool]:
        """Per level: the dense grid fits the hashmap (linear index)."""
        return tuple(r**3 <= self.hashmap_size for r in self.resolutions)

    @property
    def level_sizes(self) -> Sequence[int]:
        return tuple(
            r**3 if d else self.hashmap_size
            for r, d in zip(self.resolutions, self.dense)
        )

    @property
    def level_offsets(self) -> Sequence[int]:
        offs, acc = [], 0
        for s in self.level_sizes:
            offs.append(acc)
            acc += s
        return tuple(offs)

    @property
    def table_size(self) -> int:
        return sum(self.level_sizes)

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.features_per_level


def init_hash_table(
    generator: torch.Generator, config: HashEncodingConfig, device="cpu"
) -> torch.Tensor:
    """Flat (T * F,) table, uniform(-1e-4, 1e-4) as in Instant-NGP."""
    n = config.table_size * config.features_per_level
    u = torch.rand((n,), generator=generator)
    return (u * 2e-4 - 1e-4).to(device)


def _level_tensors(config: HashEncodingConfig, device):
    """Per-level (scale f32, res, size, offset, dense) tensors, each (L,)."""
    scales = torch.as_tensor(np.asarray(config.scales, np.float32), device=device)
    res = torch.as_tensor(config.resolutions, dtype=torch.int64, device=device)
    sizes = torch.as_tensor(config.level_sizes, dtype=torch.int64, device=device)
    offsets = torch.as_tensor(config.level_offsets, dtype=torch.int64, device=device)
    dense = torch.as_tensor(config.dense, dtype=torch.bool, device=device)
    return scales, res, sizes, offsets, dense


def _row_index(cx, cy, cz, res, dense, offsets, mask: int) -> torch.Tensor:
    """Table row of integer vertex coords (N, L, V): dense linear index, or
    the XOR-prime hash wrapped to uint32 and masked; plus the level offset.
    res/dense/offsets broadcast as (1, L, 1)."""
    dense_idx = cx + cy * res + cz * res * res
    hashed = (
        (cx * _HASH_PRIMES[0]) ^ (cy * _HASH_PRIMES[1]) ^ (cz * _HASH_PRIMES[2])
    ) & _U32 & mask
    return torch.where(dense, dense_idx, hashed) + offsets


def hash_encode_reference(
    table: torch.Tensor, positions: torch.Tensor, config: HashEncodingConfig
) -> torch.Tensor:
    """Readable trilinear reference (golden value in tests)."""
    F = config.features_per_level
    table = table.reshape(config.table_size, F)
    batch_shape = positions.shape[:-1]
    pos = positions.reshape(-1, 3).float()
    n, dev = pos.shape[0], pos.device
    scales, res, sizes, offsets, dense = _level_tensors(config, dev)

    scaled = pos[:, None, :] * scales[None, :, None] + 0.5  # (N, L, 3)
    base = torch.floor(scaled)
    frac = scaled - base
    base = base.long()

    corners = torch.as_tensor(
        [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)],
        dtype=torch.int64, device=dev,
    )  # (8, 3)
    coords = base[:, :, None, :] + corners[None, None, :, :]  # (N, L, 8, 3)
    coords = torch.minimum(coords.clamp_min(0), (res - 1)[None, :, None, None])
    cx, cy, cz = coords[..., 0], coords[..., 1], coords[..., 2]
    r = res[None, :, None]
    size = sizes[None, :, None]
    dense_idx = cx + cy * r + cz * r * r
    hashed = (
        (cx * _HASH_PRIMES[0]) ^ (cy * _HASH_PRIMES[1]) ^ (cz * _HASH_PRIMES[2])
    ) & _U32
    idx = torch.where(dense[None, :, None], dense_idx % size, hashed % size)
    idx = idx + offsets[None, :, None]  # (N, L, 8)

    feats = table[idx.reshape(-1)].reshape(n, config.num_levels, 8, F)
    w = torch.where(corners[None, None] == 1, frac[:, :, None, :], 1.0 - frac[:, :, None, :])
    weights = w[..., 0] * w[..., 1] * w[..., 2]  # (N, L, 8)
    out = torch.sum(feats * weights[..., None], dim=2)  # (N, L, F)
    return out.reshape(*batch_shape, config.output_dim)


def hash_indices_weights(
    pos: torch.Tensor, config: HashEncodingConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vertex rows (N, L, V) int64 and interpolation weights (N, L, V) f32 of
    positions (N, 3): the lane computation of _hash_encode_impl
    (umhs_tpu/ops/encodings.py:339-436), V = 4 (tetrahedral) or 8."""
    scales, res, _, offsets, dense = _level_tensors(config, pos.device)
    s = pos[:, :, None] * scales[None, None, :] + 0.5  # (N, 3, L)
    base = torch.floor(s)
    frac = s - base
    base = base.long()
    bx, by, bz = base[:, 0], base[:, 1], base[:, 2]  # (N, L)
    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    res_m1 = (res - 1)[None, :, None]
    lvl = dict(res=res[None, :, None], dense=dense[None, :, None],
               offsets=offsets[None, :, None], mask=config.hashmap_size - 1)

    def coord(b, o):
        return torch.minimum((b[..., None] + o).clamp_min(0), res_m1)

    if config.interpolation == "tetrahedral":
        # distinct ranks 0..2 (0 = largest frac), ties broken by axis order
        rx = (fx < fy).long() + (fx < fz).long()
        ry = (fy <= fx).long() + (fy < fz).long()
        rz = (fz <= fx).long() + (fz <= fy).long()
        v = torch.arange(4, device=pos.device)
        idx = _row_index(
            coord(bx, (rx[..., None] < v).long()),
            coord(by, (ry[..., None] < v).long()),
            coord(bz, (rz[..., None] < v).long()),
            **lvl,
        )
        fmax = torch.maximum(fx, torch.maximum(fy, fz))
        fmin = torch.minimum(fx, torch.minimum(fy, fz))
        fmid = fx + fy + fz - fmax - fmin
        weights = torch.stack([1.0 - fmax, fmax - fmid, fmid - fmin, fmin], dim=-1)
    else:
        c = torch.arange(8, device=pos.device)
        ox, oy, oz = c & 1, (c >> 1) & 1, (c >> 2) & 1
        idx = _row_index(coord(bx, ox), coord(by, oy), coord(bz, oz), **lvl)

        def weight(f, o):
            return torch.where(o == 1, f[..., None], 1.0 - f[..., None])

        weights = weight(fx, ox) * weight(fy, oy) * weight(fz, oz)
    return idx, weights


def hash_encode_plain(
    table: torch.Tensor, pos: torch.Tensor, config: HashEncodingConfig
) -> torch.Tensor:
    """Plain version of K3: (N, 3) positions in [0, 1] -> (N, L * F)."""
    F = config.features_per_level
    idx, weights = hash_indices_weights(pos, config)
    rows = table.reshape(-1, F)[idx.reshape(-1)].reshape(*idx.shape, F)
    out = torch.sum(rows * weights[..., None], dim=2)  # (N, L, F)
    return out.reshape(pos.shape[0], config.output_dim)


_HASH_U_DOT = tuple(float(np.float32(c)) for c in (12.9898, 78.233, 37.719))
_HASH_U_SCALE = float(np.float32(43758.5453))
_HASH_U_LEVEL = float(np.float32(0.6180339887))


def level_uniforms(pos: torch.Tensor, num_levels: int) -> torch.Tensor:
    """The stochastic backward's uniform variate per (sample, level), (N, L):
    u = frac(sin(p . c) * 43758.5453), u_l = frac(u + l * 0.6180339887)
    (encodings.py:529-536), with the dot as ((x c0 + y c1) + z c2) in
    separate f32 roundings so that K4 computes the same bits."""
    c0, c1, c2 = _HASH_U_DOT
    dot = (pos[:, 0] * c0 + pos[:, 1] * c1) + pos[:, 2] * c2
    u = torch.remainder(torch.sin(dot) * _HASH_U_SCALE, 1.0)
    lv = torch.arange(num_levels, dtype=torch.float32, device=pos.device) * _HASH_U_LEVEL
    return torch.remainder(u[:, None] + lv[None, :], 1.0)


def stochastic_vertex(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index of the vertex each (sample, level) splats onto: the first v with
    u < w_0 + ... + w_v (running f32 sums), else the last one, so exactly
    one vertex is chosen. weights (N, L, V), u (N, L) -> (N, L) int64."""
    V = weights.shape[-1]
    sel = torch.full(u.shape, V - 1, dtype=torch.int64, device=u.device)
    found = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    cum = weights[..., 0]
    for v in range(V):
        if v > 0:
            cum = cum + weights[..., v]
        take = (u < cum) & ~found
        sel = torch.where(take, v, sel)
        found = found | take
    return sel


def hash_encode_bwd_plain(
    pos: torch.Tensor, g: torch.Tensor, config: HashEncodingConfig, stochastic: bool
) -> torch.Tensor:
    """Plain version of K4: the gradient (T * F,) of the flat table for the
    output gradient g (N, L * F) at positions (N, 3).

    Deterministic: each vertex gets w_v * g. Stochastic: one vertex per
    (sample, level), chosen by `stochastic_vertex`, gets g."""
    n, L, F = pos.shape[0], config.num_levels, config.features_per_level
    idx, weights = hash_indices_weights(pos, config)  # (N, L, V)
    g = g.reshape(n, L, F).float()
    feat = torch.arange(F, device=pos.device)
    grad = torch.zeros(config.table_size * F, dtype=torch.float32, device=pos.device)
    if stochastic:
        v = stochastic_vertex(weights, level_uniforms(pos, L))
        rows = torch.gather(idx, 2, v[..., None])[..., 0]  # (N, L)
        grad.index_add_(0, (rows[..., None] * F + feat).reshape(-1), g.reshape(-1))
    else:
        contrib = weights[..., None] * g[:, :, None, :]  # (N, L, V, F)
        grad.index_add_(0, (idx[..., None] * F + feat).reshape(-1), contrib.reshape(-1))
    return grad


@functools.lru_cache(maxsize=None)
def _level_args(config: HashEncodingConfig):
    """The launchers' per-level arguments, built once per configuration (the
    launchers only read them)."""
    L = config.num_levels
    return (
        (ctypes.c_float * L)(*np.asarray(config.scales, np.float32).tolist()),
        (ctypes.c_int * L)(*config.resolutions),
        (ctypes.c_int * L)(*config.level_offsets),
        (ctypes.c_int * L)(*[int(d) for d in config.dense]),
        config.log2_hashmap_size,
        int(config.interpolation == "tetrahedral"),
    )


def _check_positions(name: str, pos: torch.Tensor, config: HashEncodingConfig) -> None:
    if pos.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {pos.device}")
    if pos.dtype != torch.float32 or pos.dim() != 2 or pos.shape[1] != 3 or not pos.is_contiguous():
        raise ValueError(f"{name}: positions must be a contiguous (N, 3) float32 tensor")
    if config.features_per_level not in (1, 2, 4, 8) or config.num_levels > 32:
        raise ValueError(f"{name}: F must be 1, 2, 4 or 8 and L <= 32")


HASH_ENCODE_FWD = Kernel(
    "hash_encode_fwd.cu",
    "umhs_hash_encode_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
     ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
HASH_ENCODE_BWD = Kernel(
    "hash_encode_bwd.cu",
    "umhs_hash_encode_bwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
     ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p],
)


def hash_encode_fwd(
    table: torch.Tensor, pos: torch.Tensor, config: HashEncodingConfig
) -> torch.Tensor:
    """K3 on a CUDA tensor, `hash_encode_plain` on a CPU tensor."""
    if pos.device.type == "cpu":
        return hash_encode_plain(table, pos, config)
    _check_positions("hash_encode_fwd", pos, config)
    L, F = config.num_levels, config.features_per_level
    if (table.dtype != torch.float32 or table.device != pos.device or not table.is_contiguous()
            or table.numel() != config.table_size * F or table.data_ptr() % (4 * F) != 0):
        raise ValueError("hash_encode_fwd: table must be a contiguous, aligned float32 "
                         "(T * F,) tensor on the positions' device")
    n = pos.shape[0]
    out = torch.empty((n, L * F), dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        HASH_ENCODE_FWD.launch(
            pos.data_ptr(), table.data_ptr(), out.data_ptr(), n, L, F, *_level_args(config),
            torch.cuda.current_stream(pos.device).cuda_stream,
        )
    return out


def hash_encode_bwd(
    pos: torch.Tensor, g: torch.Tensor, config: HashEncodingConfig, stochastic: bool
) -> torch.Tensor:
    """K4 on a CUDA tensor, `hash_encode_bwd_plain` on a CPU tensor: the
    gradient (T * F,) of the flat table. The kernel adds with float atomics,
    so the order of the adds into a repeated row, and the sum's last bits,
    change from run to run. It reads g with vector loads, so g must be
    aligned to 4 * F bytes (a fresh tensor always is)."""
    if pos.device.type == "cpu":
        return hash_encode_bwd_plain(pos, g, config, stochastic)
    _check_positions("hash_encode_bwd", pos, config)
    L, F = config.num_levels, config.features_per_level
    n = pos.shape[0]
    if (g.dtype != torch.float32 or tuple(g.shape) != (n, L * F) or g.device != pos.device
            or not g.is_contiguous() or g.data_ptr() % (4 * F) != 0):
        raise ValueError("hash_encode_bwd: g must be a contiguous, aligned float32 (N, L * F) "
                         "tensor on the positions' device")
    grad = torch.zeros(config.table_size * F, dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        HASH_ENCODE_BWD.launch(
            pos.data_ptr(), g.data_ptr(), grad.data_ptr(), n, L, F, *_level_args(config),
            int(stochastic), torch.cuda.current_stream(pos.device).cuda_stream,
        )
    return grad


class _HashEncode(torch.autograd.Function):
    """K3 forward and K4 backward (impl="auto"), or their plain versions
    (impl="plain"); saves the positions only."""

    @staticmethod
    def forward(ctx, table, pos, config, impl):
        ctx.config, ctx.impl = config, impl
        ctx.save_for_backward(pos)
        if impl == "auto":
            return hash_encode_fwd(table, pos, config)
        return hash_encode_plain(table, pos, config)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        bwd = hash_encode_bwd if ctx.impl == "auto" else hash_encode_bwd_plain
        grad = bwd(pos, g.float().contiguous(), ctx.config, ctx.config.stochastic_grad)
        return grad, None, None, None


def hash_encode(
    table: torch.Tensor,
    positions: torch.Tensor,
    config: HashEncodingConfig,
    impl: str = "auto",
) -> torch.Tensor:
    """Hash-grid features of positions (..., 3) in [0, 1]^3 -> (..., L * F).

    impl="auto" runs K3 (and K4 in the backward) on a CUDA tensor and the
    plain versions on a CPU tensor; impl="plain" runs the plain versions
    anywhere. The table's gradient is deterministic or stochastic as
    config.stochastic_grad says."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    batch_shape = positions.shape[:-1]
    pos = positions.detach().reshape(-1, 3).float().contiguous()
    out = _HashEncode.apply(table, pos, config, impl)
    return out.reshape(*batch_shape, config.output_dim)
