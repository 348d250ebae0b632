"""Trainer: owns the model descriptor, the state and the optimizer
(port of umhs_tpu/engine/trainer.py).

`setup()` makes seeded parameters, the Adam state and the empty occupancy
grid; `train(num_iterations)` runs the loop of trainer.py:619-660: the
occupancy update before every update_interval-th step (full during warmup,
partial after), then `train_step()`: sample pixels and rays, march with a
start jitter, compact evaluation through the field, the loss with a random
background, the backward pass, one Adam step at the scheduled learning
rate, and the endmember clamp. `render_camera` renders a full view.

Every random draw is injectable: `train_step(draws)` takes the pixels, the
march jitter and the background (`draw_step` makes them from the step
generator, seeded with seed + 1), and the occupancy update draws its cells
and jitter from a generator seeded with seed + 2 + step.

The train split is given as arrays through an `InMemoryDataManager`.
Dynamic batching, gradient accumulation, reading datasets from disk,
checkpoints and the eval loops come later.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data.datamanager import InMemoryDataManager
from ..models.model import ModelConfig, UMHSModel
from ..ops.occupancy import draw_partial_cells


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 2e-2
    eps: float = 1e-15
    lr_final: float = 1e-5
    max_steps: int = 30000
    warmup_steps: int = 0


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    seed: int = 42
    # bf16 compute dtype for the field (f32 parameters and accumulation)
    mixed_precision: bool = True
    train_num_rays_per_batch: int = 4096
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)


def make_lr_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """Learning rate at update t (trainer.py:313-326): lr * (lr_final /
    lr)^(t / max_steps), held at lr_final after max_steps; with warmup, a
    linear ramp from 0 over warmup_steps first."""

    def decay(t: int) -> float:
        value = cfg.lr * (cfg.lr_final / cfg.lr) ** (t / cfg.max_steps)
        return max(value, cfg.lr_final)

    if cfg.warmup_steps <= 0:
        return decay

    def schedule(t: int) -> float:
        if t < cfg.warmup_steps:
            return cfg.lr * t / cfg.warmup_steps
        return decay(t - cfg.warmup_steps)

    return schedule


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted name, tensor) of every parameter, e.g. "mlp_base.layers.0.w"."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


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
        datamanager: Optional[InMemoryDataManager] = None,
    ):
        self.config = config
        self.device = resolve_device(device)
        if config.mixed_precision and model_config.compute_dtype == "float32":
            model_config = dataclasses.replace(model_config, compute_dtype="bfloat16")
        self.model = UMHSModel(model_config, wavelengths, num_classes, num_images,
                               scene_scale=scene_scale, device=self.device)
        self.datamanager = datamanager
        self.lr_schedule = make_lr_schedule(config.optimizer)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.state: Dict[str, object] = {}

    def setup(self, endmembers_init: Optional[np.ndarray] = None) -> "Trainer":
        """Seeded parameters (VCA endmembers when given), the Adam state, an
        empty grid and the step generator."""
        generator = torch.Generator().manual_seed(self.config.seed)
        params, occ = self.model.init(generator, endmembers_init)
        for _, t in named_leaves(params):
            t.requires_grad_(True)
        self.state = {"params": params, "occ": occ, "step": 0}
        # optax.scale_by_adam(eps) then the scheduled rate is this update
        self.optimizer = torch.optim.Adam(
            [t for _, t in named_leaves(params)], lr=self.lr_schedule(0),
            eps=self.config.optimizer.eps)
        self._step_gen = torch.Generator(device=self.device)
        self._step_gen.manual_seed(self.config.seed + 1)
        return self

    # ------------------------------------------------------------------
    def update_occupancy(self, full: bool = True) -> None:
        """Occupancy update of the state's grid, full or partial; its cells
        and in-cell jitter come from a generator seeded with seed + 2 + step."""
        occ_cfg = self.model.occ_config
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed + 2 + int(self.state["step"]))
        if full:
            cell_draws, m = None, occ_cfg.levels * occ_cfg.cells_per_level
        else:
            cell_draws = draw_partial_cells(occ_cfg, gen, self.device)
            m = sum(d["uniform"].shape[0] + d["u"].shape[0] for d in cell_draws)
        jitter = torch.rand((m, 3), generator=gen, device=self.device)
        with torch.no_grad():
            self.state["occ"] = self.model.update_occupancy(
                self.state["occ"], self.state["params"], jitter, full=full,
                cell_draws=cell_draws)

    def draw_step(self) -> Dict[str, object]:
        """One step's draws from the step generator: the pixels, the march
        jitter (R,) and the background (R, 3)."""
        R = self.config.train_num_rays_per_batch
        gen = self._step_gen
        return {
            "pixels": self.datamanager.draw(gen, R),
            "t_jitter": torch.rand((R,), generator=gen, device=self.device),
            "background": torch.rand((R, 3), generator=gen, device=self.device),
        }

    def loss_and_grads(self, draws: Dict[str, object]):
        """Forward and backward of one batch at the state's step: returns
        (total loss, loss terms, outputs, batch); the gradients are left in
        each parameter's .grad."""
        R = self.config.train_num_rays_per_batch
        rays, batch = self.datamanager.sample(R, draws["pixels"])
        params = self.state["params"]
        for _, t in named_leaves(params):
            t.grad = None
        outputs = self.model.forward(params, self.state["occ"], rays,
                                     step=int(self.state["step"]), train=True,
                                     t_jitter=draws["t_jitter"])
        loss_dict = self.model.loss(outputs, batch, draws["background"])
        total = sum(loss_dict.values())
        total.backward()
        return total, loss_dict, outputs, batch

    def apply_gradients(self) -> None:
        """One Adam update from the parameters' .grad at the scheduled rate
        (update t uses schedule(t), as optax's count does), then the
        endmember clamp; the step advances."""
        step = int(self.state["step"])
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_schedule(step)
        self.optimizer.step()
        self.model.post_step(self.state["params"])
        self.state["step"] = step + 1

    def train_step(self, draws: Optional[Dict[str, object]] = None) -> Dict[str, float]:
        """One training step (trainer.py:431-474); returns its loss terms and
        metrics as floats."""
        draws = self.draw_step() if draws is None else draws
        total, loss_dict, outputs, batch = self.loss_and_grads(draws)
        self.apply_gradients()
        with torch.no_grad():
            metrics = self.model.metrics(
                {k: v.detach() for k, v in outputs.items()}, batch)
        out = {f"loss/{k}": v.detach() for k, v in loss_dict.items()}
        out["loss/total"] = total.detach()
        out.update(metrics)
        values = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=self.device)
                              for v in out.values()]).tolist()  # one host sync
        return dict(zip(out.keys(), values))

    def train(self, num_iterations: int) -> List[Dict[str, object]]:
        """Run `num_iterations` steps (trainer.py:619-660): before every
        due step the occupancy update, then the step. Returns one record per
        step: its metrics, which occupancy update ran ("full", "partial" or
        None), and the host seconds of the update and of the step."""
        history = []
        for _ in range(num_iterations):
            step = int(self.state["step"])
            due, full = self.model.occ_update_due(step)
            t0 = time.perf_counter()
            if due:
                self.update_occupancy(full)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            metrics = self.train_step()
            t2 = time.perf_counter()
            history.append({
                "step": step, "metrics": metrics,
                "occ_update": ("full" if full else "partial") if due else None,
                "occ_s": t1 - t0, "step_s": t2 - t1,
            })
        return history

    # ------------------------------------------------------------------
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
