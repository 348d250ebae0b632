"""UMHS field: hash-grid density and spectral-unmixing heads
(port of umhs_tpu/models/field.py).

- `field_density`: scene contraction -> [0, 1] -> hash encode (K3) -> base
  MLP (K1) -> trunc_exp density and geometry features.
- `field_outputs`: the heads. feature_mlp gives per-class logits (plus the
  specular gate), abundances = softmax(logits / temperature); mlp_head gives
  sigmoid per-class scalars; the spectrum is the linear mixture
  sum_k a_k * s_k * E[k, :]; with pred_specular a view-dependent residual
  s1 * sigmoid(mlp_directional(SH(dir), posenc)) is added, its gate ramped in
  over the first `specular_ramp_steps` steps in f32. The rgb method has one
  head over (SH(dir), geo_feat).

Parameters are a plain dict with the JAX package's names and layouts.
`clamp_endmembers` is the after-step callback that keeps the endmembers in
[0, 1]; the hash grid's stochastic backward is set by
`FieldConfig.hash.stochastic_grad`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.activations import trunc_exp
from ..ops.encodings import (
    HashEncodingConfig,
    hash_encode,
    init_hash_table,
    nerf_encoding,
    sh_encoding,
)
from ..ops.mlp import apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    method: str = "rgb"  # rgb | spectral | rgb+spectral
    num_classes: int = 5
    num_bands: int = 0
    num_images: int = 1
    geo_feat_dim: int = 15
    base_mlp_layers: int = 2
    base_mlp_width: int = 64
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    appearance_embedding_dim: int = 0
    use_average_appearance_embedding: bool = False
    temperature: float = 0.2
    pred_specular: bool = False
    specular_ramp_steps: int = 1000
    use_scene_contraction: bool = True
    aabb_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    aabb_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    average_init_density: float = 1.0
    hash: HashEncodingConfig = dataclasses.field(default_factory=HashEncodingConfig)
    posenc_frequencies: int = 2
    sh_levels: int = 4
    compute_dtype: torch.dtype = torch.float32
    # "auto": kernels on CUDA tensors, plain versions on CPU; "plain": plain
    # versions everywhere (to hold the kernels against them on the card)
    impl: str = "auto"

    @property
    def spectral(self) -> bool:
        return "spectral" in self.method

    @property
    def posenc_dim(self) -> int:
        return 3 * self.posenc_frequencies * 2

    @property
    def sh_dim(self) -> int:
        return self.sh_levels**2


def init_field_params(
    generator: torch.Generator,
    cfg: FieldConfig,
    endmembers_init: Optional[np.ndarray] = None,
    device="cpu",
) -> Dict[str, object]:
    """Seeded field parameters. endmembers_init: optional (K, B) VCA result,
    else standard normal."""
    g = generator
    params: Dict[str, object] = {
        "hash_table": init_hash_table(g, cfg.hash, device),
        "mlp_base": init_mlp(g, cfg.hash.output_dim, cfg.base_mlp_layers,
                             cfg.base_mlp_width, 1 + cfg.geo_feat_dim, device),
    }
    if cfg.appearance_embedding_dim > 0:
        params["appearance_embedding"] = (
            torch.randn((cfg.num_images, cfg.appearance_embedding_dim), generator=g) * 0.1
        ).to(device)
    if cfg.spectral:
        head_out = cfg.num_classes + 1 if cfg.pred_specular else cfg.num_classes
        params["feature_mlp"] = init_mlp(
            g, cfg.posenc_dim + cfg.geo_feat_dim, 3, cfg.hidden_dim_color, head_out, device)
        params["mlp_head"] = init_mlp(
            g, cfg.posenc_dim + cfg.geo_feat_dim + cfg.appearance_embedding_dim,
            cfg.num_layers_color, cfg.hidden_dim_color, cfg.num_classes, device)
        params["mlp_directional"] = init_mlp(
            g, cfg.sh_dim + cfg.posenc_dim, 2, 16, cfg.num_bands, device)
        if endmembers_init is not None:
            em = torch.as_tensor(np.asarray(endmembers_init, np.float32))
            if tuple(em.shape) != (cfg.num_classes, cfg.num_bands):
                raise ValueError(
                    f"endmember init shape {tuple(em.shape)} != "
                    f"({cfg.num_classes}, {cfg.num_bands})")
        else:
            em = torch.randn((cfg.num_classes, cfg.num_bands), generator=g)
        params["endmembers"] = em.to(device)
    else:
        params["mlp_head"] = init_mlp(
            g, cfg.sh_dim + cfg.geo_feat_dim + cfg.appearance_embedding_dim,
            cfg.num_layers_color, cfg.hidden_dim_color, 3, device)
    return params


def scene_contract(positions: torch.Tensor) -> torch.Tensor:
    """SceneContraction(order=inf): identity inside the unit inf-ball, else
    (2 - 1/||x||_inf) * x/||x||_inf; output in [-2, 2]^3."""
    norm = torch.amax(torch.abs(positions), dim=-1, keepdim=True)
    safe = torch.clamp_min(norm, 1e-12)
    contracted = (2.0 - 1.0 / safe) * (positions / safe)
    return torch.where(norm <= 1.0, positions, contracted)


def normalized_positions(
    positions: torch.Tensor, cfg: FieldConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World positions -> hash-grid domain [0, 1]^3, and the selector of
    positions strictly inside (0, 1)^3 (outside ones are zeroed)."""
    if cfg.use_scene_contraction:
        unit = (scene_contract(positions) + 2.0) / 4.0
    else:
        lo = torch.as_tensor(cfg.aabb_min, dtype=positions.dtype, device=positions.device)
        hi = torch.as_tensor(cfg.aabb_max, dtype=positions.dtype, device=positions.device)
        unit = (positions - lo) / (hi - lo)
    selector = torch.all((unit > 0.0) & (unit < 1.0), dim=-1)
    unit = unit * selector[..., None]
    return unit, selector


def field_density(
    params, cfg: FieldConfig, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(density (...,), geo_feat (..., geo_feat_dim)) at world positions."""
    unit, selector = normalized_positions(positions, cfg)
    enc = hash_encode(params["hash_table"], unit, cfg.hash, impl=cfg.impl)
    h = apply_mlp(params["mlp_base"], enc, compute_dtype=cfg.compute_dtype, impl=cfg.impl)
    density = cfg.average_init_density * trunc_exp(h[..., 0].float())
    density = torch.where(selector, density, torch.zeros_like(density))
    return density, h[..., 1:]


def density_fn(params, cfg: FieldConfig):
    """Density-only closure (the occupancy update's probe)."""

    def fn(positions: torch.Tensor) -> torch.Tensor:
        return field_density(params, cfg, positions)[0]

    return fn


def _appearance_vector(params, cfg: FieldConfig, camera_indices, train: bool, n: int):
    if cfg.appearance_embedding_dim == 0:
        return None
    table = params["appearance_embedding"]
    if train:
        return table[camera_indices.reshape(-1).long()]
    if cfg.use_average_appearance_embedding:
        return table.mean(dim=0, keepdim=True).expand(n, -1)
    return torch.zeros((n, cfg.appearance_embedding_dim), dtype=table.dtype, device=table.device)


def field_outputs(
    params,
    cfg: FieldConfig,
    positions: torch.Tensor,
    directions: torch.Tensor,
    camera_indices: torch.Tensor,
    geo_feat: torch.Tensor,
    train: bool = True,
    step: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Heads at flat samples: positions/directions (N, 3), geo_feat (N, G).
    Returns 'rgb', or 'spectral' ('spectral2', 'specular') and 'abundances'."""
    n = positions.shape[0]
    out: Dict[str, torch.Tensor] = {}
    appearance = _appearance_vector(params, cfg, camera_indices, train, n)
    extra = [appearance] if appearance is not None else []
    mlp = dict(compute_dtype=cfg.compute_dtype, impl=cfg.impl)

    if not cfg.spectral:
        d_enc = sh_encoding(directions, cfg.sh_levels)
        h = torch.cat([d_enc, geo_feat] + extra, dim=-1)
        out["rgb"] = apply_mlp(params["mlp_head"], h, out_activation=torch.sigmoid, **mlp)
        return out

    posenc = nerf_encoding(
        positions, num_frequencies=cfg.posenc_frequencies,
        max_freq_exp=cfg.posenc_frequencies - 1.0,
    )
    h1 = torch.cat([posenc, geo_feat] + extra, dim=-1)
    scalar = torch.sigmoid(apply_mlp(params["mlp_head"], h1, **mlp))  # (N, K)
    logits = apply_mlp(params["feature_mlp"], torch.cat([posenc, geo_feat], dim=-1), **mlp)
    if cfg.pred_specular:
        logits, s1 = logits[..., : cfg.num_classes], logits[..., cfg.num_classes:]
        s1 = torch.sigmoid(s1)  # (N, 1)
        if cfg.specular_ramp_steps > 0 and step is not None:
            # f32 ramp: step / N in a bf16 dtype would keep ~8 mantissa bits
            ramp = np.clip(np.float32(step) / np.float32(cfg.specular_ramp_steps), 0.0, 1.0)
            s1 = s1 * float(ramp)
    abundances = torch.softmax(logits / cfg.temperature, dim=-1)  # (N, K)
    spec = torch.einsum("nk,nk,kb->nb", abundances, scalar, params["endmembers"])

    if cfg.pred_specular:
        spec_in = torch.cat([sh_encoding(directions, cfg.sh_levels), posenc], dim=-1)
        specular = apply_mlp(params["mlp_directional"], spec_in,
                             out_activation=torch.sigmoid, **mlp)  # (N, B)
        residual = s1 * specular
        out["spectral"] = spec + residual
        out["spectral2"] = spec
        out["specular"] = residual.detach()
    else:
        out["spectral"] = spec
    out["abundances"] = abundances
    return out


def clamp_endmembers(params):
    """After each optimizer step: clamp the endmember matrix to [0, 1]
    (umhs_tpu/models/field.py:387-393), in place so the optimizer keeps
    its parameter tensors."""
    if "endmembers" in params:
        with torch.no_grad():
            params["endmembers"].clamp_(0.0, 1.0)
    return params
