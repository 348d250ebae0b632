"""MLP parameters and application (port of umhs_tpu/ops/mlp.py).

Parameters keep the JAX package's layout: ``{"layers": [{"w": (in, out),
"b": (out,)}]}``, so ``h @ w + b`` is one layer. Init matches
torch.nn.Linear's default (uniform +/- 1/sqrt(fan_in) for weight and bias),
drawn from an explicit torch.Generator.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .mlp_fused import mlp_fused, mlp_plain


def init_mlp(
    generator: torch.Generator,
    in_dim: int,
    num_layers: int,
    layer_width: int,
    out_dim: int,
    device="cpu",
):
    """Params of an MLP with `num_layers` linear layers."""
    if num_layers == 1:
        dims = [(in_dim, out_dim)]
    else:
        dims = (
            [(in_dim, layer_width)]
            + [(layer_width, layer_width)] * (num_layers - 2)
            + [(layer_width, out_dim)]
        )
    layers = []
    for fan_in, fan_out in dims:
        bound = 1.0 / (fan_in**0.5)
        w = (torch.rand((fan_in, fan_out), generator=generator) * 2.0 - 1.0) * bound
        b = (torch.rand((fan_out,), generator=generator) * 2.0 - 1.0) * bound
        layers.append({"w": w.to(device), "b": b.to(device)})
    return {"layers": layers}


def apply_mlp(
    params,
    x: torch.Tensor,
    out_activation: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """ReLU MLP over the last axis of x; `out_activation` on the output.

    impl="auto" runs the fused kernels on a CUDA tensor (K1 forward, K2
    backward, through the autograd Function `mlp_fused`) and the plain
    version, differentiated by autograd, on a CPU tensor; impl="plain" runs
    the plain version anywhere (used to hold the kernels against it on the
    card)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if impl == "auto" and x2.device.type != "cpu":
        h = mlp_fused(params, x2, compute_dtype)
    elif impl in ("auto", "plain"):
        h = mlp_plain(params, x2, compute_dtype)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    h = h.reshape(*lead, h.shape[-1])
    return out_activation(h) if out_activation is not None else h
