"""Position and direction encodings (port of umhs_tpu/ops/encodings.py).

- `nerf_encoding`: sin/cos frequency features.
- `sh_encoding`: real spherical harmonics up to degree 4, closed form.
- The multi-resolution hash grid: `HashEncodingConfig`, `init_hash_table`,
  the readable `hash_encode_reference`, and `hash_encode`, whose forward is
  K3 (``csrc/hash_encode_fwd.cu``) on a CUDA tensor and its plain version
  `hash_encode_plain` on a CPU tensor. The table is flat, (T * F,), feature
  interleaved, as in the JAX package.

Indices are computed in int64. The XOR-prime hash wraps in uint32 on the
TPU and in the kernel, so the plain versions mask it with 0xFFFFFFFF before
taking it modulo the (power-of-two) hashmap size.
"""

from __future__ import annotations

import ctypes
import dataclasses
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


HASH_ENCODE_FWD = Kernel(
    "hash_encode_fwd.cu",
    "umhs_hash_encode_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
     ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


def hash_encode_fwd(
    table: torch.Tensor, pos: torch.Tensor, config: HashEncodingConfig
) -> torch.Tensor:
    """K3 on a CUDA tensor, `hash_encode_plain` on a CPU tensor."""
    if pos.device.type == "cpu":
        return hash_encode_plain(table, pos, config)
    if pos.device.type != "cuda":
        raise ValueError(f"hash_encode_fwd: unsupported device {pos.device}")
    L, F = config.num_levels, config.features_per_level
    if pos.dtype != torch.float32 or pos.dim() != 2 or pos.shape[1] != 3 or not pos.is_contiguous():
        raise ValueError("hash_encode_fwd: positions must be a contiguous (N, 3) float32 tensor")
    if (table.dtype != torch.float32 or table.device != pos.device or not table.is_contiguous()
            or table.numel() != config.table_size * F):
        raise ValueError("hash_encode_fwd: table must be a contiguous float32 (T * F,) tensor "
                         "on the positions' device")
    if F not in (1, 2, 4, 8) or L > 32 or table.data_ptr() % (4 * F) != 0:
        raise ValueError("hash_encode_fwd: F must be 1, 2, 4 or 8, L <= 32, table aligned")
    n = pos.shape[0]
    out = torch.empty((n, L * F), dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        HASH_ENCODE_FWD.launch(
            pos.data_ptr(), table.data_ptr(), out.data_ptr(), n, L, F,
            (ctypes.c_float * L)(*np.asarray(config.scales, np.float32).tolist()),
            (ctypes.c_int * L)(*config.resolutions),
            (ctypes.c_int * L)(*config.level_offsets),
            (ctypes.c_int * L)(*[int(d) for d in config.dense]),
            config.log2_hashmap_size,
            int(config.interpolation == "tetrahedral"),
            torch.cuda.current_stream(pos.device).cuda_stream,
        )
    return out


def hash_encode(
    table: torch.Tensor,
    positions: torch.Tensor,
    config: HashEncodingConfig,
    impl: str = "auto",
) -> torch.Tensor:
    """Hash-grid features of positions (..., 3) in [0, 1]^3 -> (..., L * F).

    impl="auto" runs K3 on a CUDA tensor and the plain version on a CPU
    tensor; impl="plain" runs the plain version anywhere."""
    batch_shape = positions.shape[:-1]
    pos = positions.reshape(-1, 3).float().contiguous()
    if impl == "auto":
        out = hash_encode_fwd(table, pos, config)
    elif impl == "plain":
        out = hash_encode_plain(table, pos, config)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return out.reshape(*batch_shape, config.output_dim)
