"""Trainer: owns the model descriptor and the state (port of the render side
of umhs_tpu/engine/trainer.py).

This slice has `setup()` (seeded parameters, the empty occupancy grid),
the full occupancy update the JAX trainer runs before its first batch, and
`render_camera`, the chunked full-image render every view goes through.
The optimizer, the train step, the partial occupancy updates, dynamic
batching and the data pipeline come with the training slice; until then the
model config, wavelengths, class and image counts are given directly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.model import ModelConfig, UMHSModel


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    seed: int = 42
    # bf16 compute dtype for the field (f32 parameters and accumulation)
    mixed_precision: bool = True


class Trainer:
    def __init__(
        self,
        config: TrainerConfig,
        model_config: ModelConfig,
        wavelengths: Sequence[float],
        num_classes: int,
        num_images: int,
        scene_scale: float = 1.0,
        device="cuda",
    ):
        self.config = config
        self.device = resolve_device(device)
        if config.mixed_precision and model_config.compute_dtype == "float32":
            model_config = dataclasses.replace(model_config, compute_dtype="bfloat16")
        self.model = UMHSModel(model_config, wavelengths, num_classes, num_images,
                               scene_scale=scene_scale, device=self.device)
        self.state: Dict[str, object] = {}

    def setup(self, endmembers_init: Optional[np.ndarray] = None) -> "Trainer":
        """Seeded parameters (VCA endmembers when given) and an empty grid."""
        generator = torch.Generator().manual_seed(self.config.seed)
        params, occ = self.model.init(generator, endmembers_init)
        self.state = {"params": params, "occ": occ, "step": 0}
        return self

    def update_occupancy(self) -> None:
        """Full occupancy update of the state's grid, as the trainer runs at
        step 0; the in-cell jitter comes from a generator seeded with
        seed + 2 + step."""
        occ_cfg = self.model.occ_config
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed + 2 + int(self.state["step"]))
        jitter = torch.rand((occ_cfg.levels * occ_cfg.cells_per_level, 3),
                            generator=gen, device=self.device)
        with torch.no_grad():
            self.state["occ"] = self.model.update_occupancy(
                self.state["occ"], self.state["params"], jitter)

    def render_camera(
        self,
        rays: Dict[str, torch.Tensor],
        hw: Tuple[int, int],
        step: Optional[int] = None,
        chunk: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """Full-image render in chunks of `chunk` rays -> {name: (H, W, C)}.

        The chunk count is rounded up to a power of two and the tail padded
        with rays from the origin along +z, as the JAX trainer does: padded
        rays take part in each chunk's global sample budget and depth clip,
        so padding the same way gives the same image. `step` gates the
        specular warmup ramp (the state's step when None)."""
        h, w = hw
        n = h * w
        chunk = chunk or self.model.config.eval_num_rays_per_chunk
        num_chunks = 1 << max(0, (-(-n // chunk)) - 1).bit_length() if n > chunk else 1
        pad = num_chunks * chunk - n
        padded = {}
        for k, v in rays.items():
            if pad > 0:
                fill = torch.zeros((pad, *v.shape[1:]), dtype=v.dtype, device=v.device)
                if k == "directions":
                    fill[:] = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype)
                v = torch.cat([v, fill])
            padded[k] = v
        step = self.state["step"] if step is None else step
        outs = []
        with torch.no_grad():
            for c in range(num_chunks):
                sl = {k: v[c * chunk:(c + 1) * chunk] for k, v in padded.items()}
                outs.append(self.model.forward(
                    self.state["params"], self.state["occ"], sl, step=step))
        return {
            k: torch.cat([o[k].reshape(chunk, -1) for o in outs])[:n].reshape(h, w, -1)
            for k in outs[0]
        }
