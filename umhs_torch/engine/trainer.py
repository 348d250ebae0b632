"""Trainer: owns the datamanager, the model descriptor, the state and the
optimizer (port of umhs_tpu/engine/trainer.py).

`Trainer(config, model_config, datamanager_config, num_classes)` parses a
dataset on disk (`UMHSDataManager`); an already-built datamanager can be
passed instead (`datamanager=`).
`setup()` makes seeded parameters (the dataset's VCA endmembers with
load_vca), the Adam state and the empty occupancy grid, or restores a
checkpoint (load_dir). `train(num_iterations)` runs to that absolute step, as
trainer.py:579-805 does: it advances in chunks up to the next multiple of
the occupancy interval (16), stepping one step at a time inside a chunk
(the occupancy update before every due step, then `train_step()`), and at
each chunk's end, with the last step's metrics, it decides and applies the
dynamic batch adaptations, logs, dumps the endmembers every 100 steps, runs
the eval loops and saves checkpoints, each at the step the JAX trainer
would. Every per-step record of the last call is in `history`.

A training step: sample pixels and rays at the current ray count, march
with a start jitter at the current samples per ray, compact evaluation
through the field with the current stage budgets, the loss with a random
background, the backward pass, then `MultiStepAdam` (Adam at the scheduled
rate, optax.MultiSteps accumulation over gradient_accumulation_steps) and
the endmember clamp.

Every random draw is injectable: `train_step(draws)` takes the pixels, the
march jitter and the background, and with the proposal sampler its
stratification jitters (`draw_step` makes them from the step generator,
seeded with seed + 1), the occupancy update draws its cells and jitter from
a generator seeded with seed + 2 + step, and `eval_batch` from one seeded
with the step; `render_camera` gives the proposal sampler the same jitters,
from a generator seeded with 0, in every chunk, as the JAX render does.

The proposal sampler runs no occupancy update and no dynamic batching, as
in the JAX trainer: its samples per ray are fixed by construction.

Data parallel (`mesh=`, one process per rank, parallel/mesh.py): every rank
holds the same state (broadcast from rank 0 at setup and after a restore),
draws the whole batch from the same generator and marches, shades and
differentiates its contiguous shard of it, at each stage's budget over the
ranks (`local_budget`); then one all_reduce (`reduce_step`) gives every rank
the mean gradients and loss and the metrics (counts summed), so every rank
makes the same update and the same adapt decisions. The occupancy update
runs replicated, the same bits on every rank. Eval and render shard the
rays when their count divides the world size. Rank 0 alone writes the
checkpoints, the writer's logs, the eval images and endmembers.npy.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data.datamanager import (
    DataManagerConfig, InMemoryDataManager, UMHSDataManager, draw_pixels, sample_pixel_batch)
from ..data.png import write_png
from ..models.model import ModelConfig, UMHSModel
from ..ops.occupancy import draw_partial_cells
from ..ops.ray_marching import MarchConfig
from ..parallel.mesh import (
    Mesh, barrier, local_budget, make_eval_forward, put_replicated, reduce_step, shard_draws)
from ..utils import metrics as metrics_utils
from ..utils.colormaps import apply_colormap, apply_depth_colormap
from ..utils.writer import MultiWriter, Writer, make_writer


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 2e-2
    eps: float = 1e-15
    lr_final: float = 1e-5
    max_steps: int = 30000
    warmup_steps: int = 0


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The fields of umhs_tpu's TrainerConfig that change what is computed,
    its writer and gradient-norm logging, and use_mesh; its XLA compile
    options have no counterpart here (configs.py lists them as inert)."""

    method_name: str = "umhsnerf"
    experiment_name: str = "unnamed"
    output_dir: Path = Path("outputs")
    max_num_iterations: int = 30000
    steps_per_save: int = 2000
    steps_per_eval_batch: int = 500
    steps_per_eval_image: int = 2000
    steps_per_log: int = 100
    save_only_latest_checkpoint: bool = False
    # checkpoint when a train() call reaches its target step (callers that
    # drive the loop in slices turn this off)
    save_final: bool = True
    # bf16 compute dtype for the field (f32 parameters and accumulation)
    mixed_precision: bool = True
    gradient_accumulation_steps: int = 1
    seed: int = 42
    # train over every visible card, one process per card (cli/train.py;
    # parallel/mesh.py); with one card, or off, one process
    use_mesh: bool = True
    # each step's metrics gain grad_norm/total, grad_norm/hash_table and
    # grad_norm/endmembers: global L2 norms of the gradients Adam receives
    log_gradients: bool = False
    vis: str = "console"  # console | tensorboard | wandb ('+' or ',' joined)
    load_dir: Optional[Path] = None
    load_step: Optional[int] = None
    # eval_image writes the segmentation as seg_pred_{idx}.png (class ids,
    # 8-bit gray) and color/{idx}.png here when set
    eval_seg_dump_dir: Optional[Path] = None
    # eval_image writes gt|pred, depth and accumulation composites (and the
    # segmentation) under run_dir/eval_images/ and to the writer
    save_eval_images: bool = True
    # dynamic batch sizing: at the scheduled steps (and, after them, every
    # adapt_every steps when the evaluated samples per ray drift by more than
    # adapt_drift) resize the rays per step, the samples per ray and the
    # compact stage budgets toward target_num_samples field evaluations per
    # step; a decision applies adapt_prefetch_steps later
    dynamic_batching: bool = True
    target_num_samples: int = 1 << 18
    adapt_steps: Tuple[int, ...] = (512, 2048)
    adapt_every: int = 1024
    adapt_drift: float = 0.2
    adapt_prefetch_steps: int = 96
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


class MultiStepAdam:
    """optax.chain(scale_by_adam(eps), scale_by_learning_rate(schedule)),
    wrapped in optax.MultiSteps(k) when k > 1.

    `step()` reads each parameter's .grad. With k > 1 it keeps the running
    mean of the gradients, acc += (g - acc) / (mini_step + 1), and Adam steps
    on every k-th call with that mean. The rate is schedule(number of earlier
    Adam steps), as optax's inner count gives it, whatever the step counter."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 eps: float, k: int = 1):
        self.params = list(params)
        self.schedule = schedule
        self.k = max(int(k), 1)
        self.adam = torch.optim.Adam(self.params, lr=schedule(0), eps=eps)
        self.updates = 0
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params] if self.k > 1 else None

    def step(self) -> bool:
        """One mini-step; True when Adam updated the parameters."""
        if self.acc is not None:
            for a, p in zip(self.acc, self.params):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            for a, p in zip(self.acc, self.params):
                p.grad = a.clone()
            self.mini_step = 0
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.adam.step()
        self.updates += 1
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        return True

    def state_dict(self) -> Dict[str, object]:
        return {"adam": self.adam.state_dict(), "updates": self.updates,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.adam.load_state_dict(state["adam"])
        self.updates, self.mini_step = int(state["updates"]), int(state["mini_step"])
        if self.acc is not None:
            for a, saved in zip(self.acc, state["acc"]):
                a.copy_(saved)


@dataclasses.dataclass(frozen=True)
class DynamicShapes:
    """The shapes a training step runs at: rays per step, the march (its
    samples per ray S), and the compact budgets, one for the whole batch or
    one per termination stage."""

    rays: int
    march: MarchConfig
    budgets: Tuple[int, ...]

    @property
    def compact_budget(self):
        return self.budgets[0] if len(self.budgets) == 1 else self.budgets


def eval_stage_metrics(metrics: Dict[str, float]) -> List[float]:
    """Per-stage field-evaluation counts [s1, s2, ...] of a metrics dict."""
    out, i = [], 1
    while f"num_eval_s{i}_per_batch" in metrics:
        out.append(float(metrics[f"num_eval_s{i}_per_batch"]))
        i += 1
    return out


class Trainer:
    def __init__(
        self,
        config: TrainerConfig,
        model_config: ModelConfig,
        datamanager_config: Optional[DataManagerConfig] = None,
        num_classes: int = 5,
        device="cuda",
        *,
        datamanager: Optional[InMemoryDataManager] = None,
        mesh: Optional[Mesh] = None,
    ):
        """From a DataManagerConfig (a dataset on disk), or from a built
        `datamanager`, which gives the model its wavelengths, image count
        and scene scale. `mesh`: this process's rank of a data-parallel
        mesh (its device is the trainer's); None trains in one process."""
        if mesh is not None and mesh.size > 1 and not config.use_mesh:
            raise ValueError(f"a mesh of {mesh.size} ranks with use_mesh=False")
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        if datamanager is None:
            if datamanager_config is None:
                raise ValueError("Trainer needs a datamanager_config or a datamanager")
            # one rank at a time: parsing deletes and rewrites vca.npy in the
            # working directory, which setup reads
            for r in range(mesh.size if mesh is not None else 1):
                if mesh is None or mesh.rank == r:
                    datamanager = UMHSDataManager(datamanager_config, num_classes=num_classes,
                                                  device=self.device)
                if mesh is not None:
                    barrier(mesh)
        self.datamanager = datamanager
        if config.mixed_precision and model_config.compute_dtype == "float32":
            model_config = dataclasses.replace(model_config, compute_dtype="bfloat16")
        self.model = UMHSModel(model_config, list(datamanager.wavelengths or []), num_classes,
                               datamanager.num_train_images,
                               scene_scale=datamanager.scene_scale, device=self.device)
        self.lr_schedule = make_lr_schedule(config.optimizer)
        self.optimizer: Optional[MultiStepAdam] = None
        self.writer: Writer = (make_writer(config.vis, self.run_dir) if self.is_main
                               else MultiWriter([]))
        self.state: Dict[str, object] = {}
        self.history: List[Dict[str, object]] = []
        self.adapt_log: List[Dict[str, object]] = []
        self._last_n = 0
        self.reset_dynamic_shapes()

    # ------------------------------------------------------------------
    @property
    def run_dir(self) -> Path:
        return Path(self.config.output_dir) / self.config.experiment_name / self.config.method_name

    @property
    def checkpoint_dir(self) -> Path:
        return self.run_dir / "umhs_models"

    @property
    def step(self) -> int:
        return int(self.state["step"])

    @property
    def is_main(self) -> bool:
        """True in one process per run: the only one, or rank 0."""
        return self.mesh is None or self.mesh.is_main

    def reset_dynamic_shapes(self) -> None:
        """Shapes before any adaptation: the configured rays per step, the
        model's march, and one budget of R * S (no compact truncation)."""
        rays = self.datamanager.config.train_num_rays_per_batch
        march = self.model.march_config
        self.dyn = DynamicShapes(rays, march, (rays * march.num_samples,))
        self.pending_adapt: Optional[Dict[str, object]] = None

    def setup(self, endmembers_init: Optional[np.ndarray] = None) -> "Trainer":
        """Seeded parameters (VCA endmembers when given, or the dataset's
        vca.npy with load_vca), the Adam state, an empty grid and the step
        generator; then the checkpoint of config.load_dir, if any."""
        cfg = self.config
        if endmembers_init is None and self.model.config.load_vca:
            cache = self.datamanager.config.dataparser.vca_cache
            if os.path.exists(cache):
                endmembers_init = np.load(cache)
        generator = torch.Generator().manual_seed(cfg.seed)
        params, occ = self.model.init(generator, endmembers_init)
        for _, t in named_leaves(params):
            t.requires_grad_(True)
        self.state = {"params": params, "occ": occ, "step": 0}
        self.optimizer = MultiStepAdam([t for _, t in named_leaves(params)], self.lr_schedule,
                                       cfg.optimizer.eps, cfg.gradient_accumulation_steps)
        self._step_gen = torch.Generator(device=self.device)
        self._step_gen.manual_seed(cfg.seed + 1)
        self.reset_dynamic_shapes()
        self._replicate()
        if cfg.load_dir is not None:
            self.load_checkpoint(cfg.load_dir, cfg.load_step)
        return self

    def _replicate(self) -> None:
        """Over a mesh, rank 0's parameters, occupancy state and optimizer
        state on every rank (trainer.py:403-408, 1401-1404). Adam's step
        counts stay on the host of each rank: every rank counts the same
        updates, from the same checkpoint."""
        if self.mesh is None:
            return
        opt = self.optimizer.state_dict()
        tensors = [t.detach() for _, t in named_leaves(self.state["params"])]
        tensors += list(self.state["occ"].values())
        tensors += [v for st in opt["adam"]["state"].values() for v in st.values()
                    if torch.is_tensor(v)]
        tensors += list(opt["acc"] or [])
        with torch.no_grad():
            put_replicated([t for t in tensors if t.device.type == self.device.type], self.mesh)

    # ------------------------------------------------------------------
    def update_occupancy(self, full: bool = True) -> None:
        """Occupancy update of the state's grid, full or partial; its cells
        and in-cell jitter come from a generator seeded with seed + 2 + step.
        The result replaces state["occ"]: on the card a partial update
        writes the old state's grids in place."""
        occ_cfg = self.model.occ_config
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed + 2 + self.step)
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
        """One step's draws from the step generator at the current ray count:
        the pixels, the march jitter (R,) and the background (R, 3); with the
        proposal sampler, then its jitters (P + 1, R, 1)."""
        R = self.dyn.rays
        gen = self._step_gen
        draws = {
            "pixels": self.datamanager.draw(gen, R),
            "t_jitter": torch.rand((R,), generator=gen, device=self.device),
            "background": torch.rand((R, 3), generator=gen, device=self.device),
        }
        prop = self.proposal_jitter(gen, R)
        if prop is not None:
            draws["prop_jitter"] = prop
        return draws

    def proposal_jitter(self, gen: torch.Generator, rays: int) -> Optional[torch.Tensor]:
        """The proposal sampler's stratification jitters for `rays` rays,
        (len(num_proposal_samples) + 1, rays, 1) uniform draws from `gen`;
        None with the occgrid sampler (nothing is drawn)."""
        cfg = self.model.config
        if cfg.sampler != "proposal":
            return None
        n = len(cfg.num_proposal_samples) + 1
        return torch.rand((n, rays, 1), generator=gen, device=self.device)

    def loss_and_grads(self, draws: Dict[str, object]):
        """Forward and backward of one batch at the state's step and the
        current shapes: returns (total loss, loss terms, outputs, batch); the
        gradients are left in each parameter's .grad. Over a mesh: of this
        rank's shard of the draws, at each stage's budget on one rank."""
        rays_count, budget = self.dyn.rays, self.dyn.compact_budget
        if self.mesh is not None:
            draws = shard_draws(draws, self.mesh)
            rays_count //= self.mesh.size
            budget = local_budget(budget, self.mesh.size)
        rays, batch = self.datamanager.sample(rays_count, draws["pixels"])
        params = self.state["params"]
        for _, t in named_leaves(params):
            t.grad = None
        outputs = self.model.forward(params, self.state["occ"], rays,
                                     compact_budget=budget, step=self.step,
                                     train=True, t_jitter=draws["t_jitter"],
                                     march_config=self.dyn.march,
                                     prop_jitter=draws.get("prop_jitter"))
        loss_dict = self.model.loss(outputs, batch, draws["background"], step=self.step)
        total = sum(loss_dict.values())
        total.backward()
        return total, loss_dict, outputs, batch

    def apply_gradients(self) -> None:
        """One optimizer mini-step from the parameters' .grad, then the
        endmember clamp; the step advances."""
        self.optimizer.step()
        self.model.post_step(self.state["params"])
        self.state["step"] = self.step + 1

    def gradient_norms(self) -> Dict[str, torch.Tensor]:
        """Global L2 norms of the parameters' .grad (trainer.py:452-464):
        all of them, the hash table's and the endmembers'."""
        params = self.state["params"]

        def norm(tensors) -> torch.Tensor:
            grads = [t.grad.float() for t in tensors if t.grad is not None]
            if not grads:
                return torch.zeros((), device=self.device)
            return torch.sqrt(sum(torch.sum(g * g) for g in grads))

        out = {"grad_norm/total": norm(t for _, t in named_leaves(params))}
        for key in ("hash_table", "endmembers"):
            if key in params:
                out[f"grad_norm/{key}"] = norm([params[key]])
        return out

    def reduced_step(self, draws: Dict[str, object]) -> Dict[str, torch.Tensor]:
        """`loss_and_grads` and the metrics of one batch, then, over a mesh,
        the step's one collective (`reduce_step`). Returns the loss terms
        ("loss/<term>"), their sum ("loss/total") and the metrics as 0-d
        tensors (over a mesh: means over the ranks, the *_per_batch counts
        summed); each parameter's .grad holds the (mean) gradient."""
        total, loss_dict, outputs, batch = self.loss_and_grads(draws)
        with torch.no_grad():
            metrics = self.model.metrics({k: v.detach() for k, v in outputs.items()}, batch)
        out = {f"loss/{k}": v.detach() for k, v in loss_dict.items()}
        out["loss/total"] = total.detach()
        out.update(metrics)
        if self.mesh is not None:
            # a parameter the step's graph does not reach has no gradient on
            # any rank: the graph's shape follows the config and the step
            grads = [t.grad for _, t in named_leaves(self.state["params"]) if t.grad is not None]
            out = reduce_step(self.mesh, grads, out)
        return out

    def train_step(self, draws: Optional[Dict[str, object]] = None) -> Dict[str, float]:
        """One training step (trainer.py:431-474); returns its loss terms and
        metrics (with log_gradients, the gradient norms of the reduced
        gradients) as floats."""
        draws = self.draw_step() if draws is None else draws
        out = self.reduced_step(draws)
        if self.config.log_gradients:
            out.update(self.gradient_norms())
        self.apply_gradients()
        values = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=self.device)
                              for v in out.values()]).tolist()  # one host sync
        return dict(zip(out.keys(), values))

    # ------------------------------------------------------------------
    def train(self, num_iterations: Optional[int] = None) -> Dict[str, float]:
        """Train until the step counter reaches `num_iterations` (an absolute
        step; max_num_iterations when None). Returns the last logged metrics
        with rays_per_sec, steps_per_sec, rays_per_batch and
        total_train_time_s. `history` gets one record per step of this call:
        its metrics, which occupancy update ran ("full", "partial" or None),
        and the host seconds of the update and of the step."""
        cfg = self.config
        interval = self.model.occ_config.update_interval
        total_iters = num_iterations or cfg.max_num_iterations
        self.history = []

        def crossed(period: int) -> bool:
            """True when a multiple of `period` lies in (step - last_n, step]."""
            return (self.step // period) > ((self.step - self._last_n) // period)

        last_metrics: Dict[str, float] = {}
        t_start = time.perf_counter()
        window_t0, window_steps, window_rays = t_start, 0, 0
        while self.step < total_iters:
            if self.pending_adapt is not None and self.step >= self.pending_adapt["apply_step"]:
                self.apply_adapt(self.pending_adapt)
                self.pending_adapt = None
            n = min(interval - self.step % interval, total_iters - self.step)
            for _ in range(n):
                self._train_one()
            metrics = self.history[-1]["metrics"]
            self._last_n = n
            window_steps += n
            window_rays += n * self.dyn.rays
            if (cfg.dynamic_batching and self.model.config.sampler == "occgrid"
                    and self.pending_adapt is None):
                self._maybe_adapt(metrics, crossed)

            if crossed(cfg.steps_per_log) or self.step == total_iters:
                metrics = dict(metrics)
                dt = time.perf_counter() - window_t0
                metrics["rays_per_sec"] = window_rays / dt
                metrics["steps_per_sec"] = window_steps / dt
                metrics["rays_per_batch"] = self.dyn.rays
                window_t0, window_steps, window_rays = time.perf_counter(), 0, 0
                self.writer.write(self.step, metrics)
                last_metrics = metrics
            if crossed(100) and "endmembers" in self.state["params"] and self.is_main:
                np.save("endmembers.npy", self.state["params"]["endmembers"].detach().cpu().numpy())
            if crossed(cfg.steps_per_eval_batch) and self.step < total_iters:
                self.writer.write(self.step, {f"eval/{k}": v for k, v in self.eval_batch().items()})
            if crossed(cfg.steps_per_eval_image) and self.step < total_iters:
                idx = (self.step // cfg.steps_per_eval_image) % max(
                    len(self.datamanager.eval_dataset), 1)
                self.writer.write(self.step, {f"eval_image/{k}": v
                                              for k, v in self.eval_image(idx).items()})
            if crossed(cfg.steps_per_save) or (cfg.save_final and self.step == total_iters):
                self.save_checkpoint()
        last_metrics["total_train_time_s"] = time.perf_counter() - t_start
        return last_metrics

    def _train_one(self) -> None:
        """The occupancy update when due, then one step, recorded in history."""
        step = self.step
        due, full = self.model.occ_update_due(step)
        t0 = time.perf_counter()
        if due:
            self.update_occupancy(full)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        metrics = self.train_step()
        self.history.append({
            "step": step, "metrics": metrics,
            "occ_update": ("full" if full else "partial") if due else None,
            "occ_s": t1 - t0, "step_s": time.perf_counter() - t1,
        })

    # ------------------------------------------------------------------
    def _maybe_adapt(self, metrics: Dict[str, float], crossed) -> None:
        """At a chunk's end: decide an adaptation at a scheduled step, or
        after the schedule on drift (trainer.py:713-768); a decision applies
        adapt_prefetch_steps later (at once when that is 0)."""
        cfg = self.config
        scheduled = any(self.step - self._last_n < s <= self.step for s in cfg.adapt_steps)
        periodic = False
        if (not scheduled and cfg.adapt_every > 0 and cfg.adapt_steps
                and self.step > max(cfg.adapt_steps) and crossed(cfg.adapt_every)):
            eval_now = sum(eval_stage_metrics(metrics))
            if eval_now <= 0.0:
                eval_now = float(metrics["num_samples_per_batch"])
            rays = max(self.dyn.rays, 1)
            b = self.dyn.budgets
            sized_for = (b[0] / 1.3 + sum(b[1:]) / 1.6) / rays
            periodic = abs(eval_now / rays - sized_for) > cfg.adapt_drift * sized_for
        if not (scheduled or periodic):
            return
        new = self.compute_adapt(float(metrics["num_samples_per_batch"]),
                                 p99=float(metrics.get("num_occupied_p99", 0.0)),
                                 eval_stages=eval_stage_metrics(metrics))
        if new is None:
            self.adapt_log.append({"decided": self.step, "noop": True})
            if self.is_main:
                print(f"[trainer] dynamic batch at step {self.step}: no change")
            return
        new["decided"] = self.step
        new["apply_step"] = self.step + cfg.adapt_prefetch_steps
        self.adapt_log.append(new)
        if cfg.adapt_prefetch_steps > 0:
            self.pending_adapt = new
        else:
            self.apply_adapt(new)

    def apply_adapt(self, new: Dict[str, object]) -> None:
        """Make a decision of compute_adapt the current shapes."""
        self.dyn = DynamicShapes(new["rays"], new["march"], tuple(new["budgets"]))
        new["applied"] = self.step
        if not self.is_main:
            return
        print(f"[trainer] dynamic batch at step {self.step}: mean eval samples/ray "
              f"{new['mean_eval']:.1f} (marched {new['mean_spr']:.1f}, p99 {new['p99']:.0f}) "
              f"-> rays {new['rays']}, samples/ray {new['march'].num_samples}, "
              f"budgets {'/'.join(str(b) for b in new['budgets'])}")

    def compute_adapt(self, samples_per_batch: float, p99: float = 0.0,
                      eval_stages: Optional[Sequence[float]] = None) -> Optional[dict]:
        """New (rays, march, stage budgets) from one step's measurements
        (trainer.py:1018-1157), or None when nothing would change.

        S' = 1.25 * p99 of the occupied candidates per ray (3x the mean
        without it), rounded up to occ_subsamples, at most the model's S. R' =
        target_num_samples / mean evaluated samples per ray, aligned to
        lcm(256, patch^2) and capped at 2^17. Budgets, each a multiple of 256
        and at least 4096: with stages, 1.3x the stage-1 demand and 1.6x each
        tail stage's (a bootstrap from the marched excess when unmeasured,
        doubled when the last one ran into its ceiling), each capped at R' x
        its lane gap; without, 1.3x the marched samples."""
        mean_spr = max(samples_per_batch / max(self.dyn.rays, 1), 1.0)
        osub = max(self.dyn.march.occ_subsamples, 1)
        s0 = self.model.march_config.num_samples

        def round_up(x, m):
            return int(-(-x // m) * m)

        eval_stages = list(eval_stages or [])
        eval_s1 = eval_stages[0] if eval_stages else 0.0
        tail = 1.25 * p99 if p99 > 0 else 3.0 * mean_spr
        new_s = min(s0, max(2 * osub, round_up(tail, osub)))
        mean_eval = sum(eval_stages) / max(self.dyn.rays, 1) if eval_s1 > 0 else mean_spr
        new_r = int(self.config.target_num_samples / max(mean_eval, 1.0))
        align = math.lcm(256, max(self.datamanager.patch_size, 1) ** 2)
        new_r = max(align, min((1 << 17) // align * align, (new_r // align) * align))
        shapes_unchanged = (new_s, new_r) == (self.dyn.march.num_samples, self.dyn.rays)
        scale_r = new_r / max(self.dyn.rays, 1)
        old_budgets = list(self.dyn.budgets)
        bounds = self.model.active_stage_boundaries(new_s)
        if eval_s1 > 0 and bounds:
            gaps = [bounds[0]] + [b - a for a, b in zip(bounds, list(bounds[1:]) + [new_s])]
            phys = [new_r * g for g in gaps]
            budgets = [max(4096, min(int(1.3 * eval_s1 * scale_r), phys[0]) // 256 * 256)]
            n_tail = len(bounds)
            est = max(mean_spr - bounds[0], 0.25 * mean_spr) * new_r
            for i in range(1, n_tail + 1):
                measured = eval_stages[i] if i < len(eval_stages) else 0.0
                prev = old_budgets[i] if i < len(old_budgets) else None
                if measured <= 0.0:  # unmeasured: bootstrap, at most stage 1's
                    want = min(budgets[0], int(1.6 * est / n_tail), phys[i])
                elif prev is not None and measured >= 0.9 * prev:  # hit its ceiling
                    want = min(int(2.0 * prev * scale_r), phys[i])
                else:
                    want = min(int(1.6 * measured * scale_r), phys[i])
                budgets.append(max(4096, want // 256 * 256))
        else:
            budgets = [max(4096, int(1.3 * mean_spr * new_r) // 256 * 256)]
        if shapes_unchanged and budgets == old_budgets:
            return None
        return {
            "rays": new_r,
            "march": dataclasses.replace(self.dyn.march, num_samples=new_s),
            "budgets": budgets,
            "mean_eval": mean_eval,
            "mean_spr": mean_spr,
            "p99": p99,
        }

    # ------------------------------------------------------------------
    def eval_batch(self) -> Dict[str, float]:
        """Metrics and loss terms on a random eval-split ray batch
        (trainer.py:1160-1186); the pixels and the background come from a
        generator seeded with the step (then the proposal sampler's jitters)."""
        dm = self.datamanager
        if not isinstance(dm, UMHSDataManager):
            raise ValueError("eval_batch needs a datamanager with an eval split")
        data, cam = dm.eval_device_data()
        R = dm.config.eval_num_rays_per_batch
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.step)
        rays, batch = sample_pixel_batch(data, cam, R, draw_pixels(gen, data, R),
                                         camera_type=dm.eval_outputs.cameras.camera_type)
        background = torch.rand((R, 3), generator=gen, device=self.device)
        prop_jitter = self.proposal_jitter(gen, R)
        outputs = self.eval_forward(rays, prop_jitter=prop_jitter)
        with torch.no_grad():
            out = {**self.model.metrics(outputs, batch),
                   **self.model.loss(outputs, batch, background, step=self.step)}
        values = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=self.device)
                              for v in out.values()]).tolist()
        return dict(zip(out.keys(), values))

    def eval_forward(self, rays: Dict[str, torch.Tensor], step: Optional[int] = None,
                     prop_jitter: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The inference forward of `rays` at `step` (the state's when None)
        with the proposal sampler's jitters, without gradients; over a mesh
        each rank renders its shard when the ray count divides the world
        size, and every rank gets every output (make_eval_forward)."""
        params, occ = self.state["params"], self.state["occ"]
        step = self.step if step is None else step

        def forward(r, pj):
            return self.model.forward(params, occ, r, step=step, prop_jitter=pj)

        with torch.no_grad():
            return make_eval_forward(forward, self.mesh)(rays, prop_jitter)

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
        specular warmup ramp (the state's step when None). The proposal
        sampler's jitters are drawn once, from a generator seeded with 0, and
        serve every chunk. Over a mesh each chunk is ray-sharded when the
        chunk divides the world size (eval_forward)."""
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
        step = self.step if step is None else step
        gen = torch.Generator(device=self.device).manual_seed(0)
        prop_jitter = self.proposal_jitter(gen, chunk)
        outs = []
        for c in range(num_chunks):
            sl = {k: v[c * chunk:(c + 1) * chunk] for k, v in padded.items()}
            outs.append(self.eval_forward(sl, step, prop_jitter))
        return {
            k: torch.cat([o[k].reshape(chunk, -1) for o in outs])[:n].reshape(h, w, -1)
            for k in outs[0]
        }

    def eval_image(self, idx: int = 0) -> Dict[str, float]:
        """Full-image metrics of eval view `idx` (trainer.py:1249-1296): PSNR,
        SSIM and RMSE on RGB over black; with spectra, spectral PSNR, SSIM,
        SAM and RMSE, and LPIPS on RGB (under "lpips" with ImageNet weights,
        else "lpips_vgg16random"), with the segmentation dump when
        eval_seg_dump_dir is set. Then the eval images, unless
        save_eval_images is off."""
        rays, batch, hw = self.datamanager.eval_image(idx)
        outputs = self.render_camera(rays, hw)
        outputs = {k: v.cpu().numpy() for k, v in outputs.items()}
        gt_rgb = self.model.blend_background(batch["image"]).cpu().numpy()
        pred_rgb = outputs["rgb"]
        m = {
            "psnr": metrics_utils.psnr(pred_rgb, gt_rgb),
            "ssim": metrics_utils.ssim(pred_rgb, gt_rgb),
            "rmse": metrics_utils.rmse(pred_rgb, gt_rgb),
        }
        if "spectral" in self.model.config.method and "hs_image" in batch:
            gt_s = batch["hs_image"].float().cpu().numpy()
            pred_s = outputs["spectral"]
            m.update({
                "psnr_spectral": metrics_utils.psnr(pred_s, gt_s),
                "ssim_spectral": metrics_utils.ssim(pred_s, gt_s),
                "sam_spectral": metrics_utils.sam(pred_s, gt_s),
                "rmse_spectral": metrics_utils.rmse(pred_s, gt_s),
            })
            lp = metrics_utils.lpips(pred_rgb, gt_rgb, self.device)
            calibrated = metrics_utils.LPIPS_VARIANT == "vgg16_imagenet"
            m["lpips" if calibrated else "lpips_vgg16random"] = lp
            if self.config.eval_seg_dump_dir is not None and self.is_main:
                d = Path(self.config.eval_seg_dump_dir)
                (d / "color").mkdir(parents=True, exist_ok=True)
                write_png(d / f"seg_pred_{idx}.png", outputs["seg_raw"][..., 0].astype(np.uint8))
                write_png(d / "color" / f"{idx}.png",
                          (np.clip(outputs["seg_pred"], 0, 1) * 255).astype(np.uint8))
        if self.config.save_eval_images and self.is_main:
            self._emit_eval_images(idx, gt_rgb, pred_rgb, outputs)
        return m

    def _emit_eval_images(self, idx: int, gt_rgb: np.ndarray, pred_rgb: np.ndarray,
                          outputs: Dict[str, np.ndarray]) -> None:
        """gt|pred side by side, turbo depth attenuated by the accumulation,
        turbo accumulation and, with classes, the segmentation: each to the
        writer and to run_dir/eval_images/step-{step:09d}-{idx}-{name}.png
        (trainer.py:1298-1324)."""
        composites = {
            "img": np.concatenate([np.clip(gt_rgb, 0, 1), np.clip(pred_rgb, 0, 1)], axis=1),
            "depth": apply_depth_colormap(outputs["depth"], outputs.get("accumulation")),
            "accumulation": apply_colormap(outputs["accumulation"]),
        }
        if "seg_pred" in outputs:
            composites["seg_pred"] = np.clip(outputs["seg_pred"], 0, 1)
        d = self.run_dir / "eval_images"
        d.mkdir(parents=True, exist_ok=True)
        for name, img in composites.items():
            self.writer.write_image(self.step, f"eval_img_{idx}/{name}", img)
            write_png(d / f"step-{self.step:09d}-{idx}-{name}.png", (img * 255).astype(np.uint8))

    def eval_all_images(self) -> Dict[str, float]:
        """eval_image's metrics averaged over the eval split."""
        n = len(self.datamanager.eval_dataset)
        sums: Dict[str, float] = {}
        for i in range(n):
            for k, v in self.eval_image(i).items():
                sums[k] = sums.get(k, 0.0) + v
        return {k: v / n for k, v in sums.items()}

    # ------------------------------------------------------------------
    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """A copy of every tensor a checkpoint holds, by name: parameters,
        occupancy state, Adam moments, the accumulator (k > 1) and the step
        generator's state."""
        opt = self.optimizer.state_dict()
        out = {f"param {n}": t.detach().clone() for n, t in named_leaves(self.state["params"])}
        out.update({f"occ {k}": v.clone() for k, v in self.state["occ"].items()})
        for i, st in opt["adam"]["state"].items():
            out.update({f"adam {i} {k}": torch.as_tensor(v).clone() for k, v in st.items()})
        out.update({f"acc {i}": a.clone() for i, a in enumerate(opt["acc"] or [])})
        out["step generator"] = self._step_gen.get_state()
        return out

    def save_checkpoint(self, directory: Optional[Path] = None) -> Path:
        """`step-{step:09d}/` under `directory` (checkpoint_dir when None):
        state.pt (parameters, optimizer, occupancy, step generator) and
        dynamic_batch.json (the applied shapes). Returns its path. Over a
        mesh rank 0 writes it while the others wait."""
        ckpt_dir = Path(directory) if directory is not None else self.checkpoint_dir
        path = ckpt_dir / f"step-{self.step:09d}"
        if self.is_main:
            self._write_checkpoint(ckpt_dir, path)
        if self.mesh is not None:
            barrier(self.mesh)
        return path

    def _write_checkpoint(self, ckpt_dir: Path, path: Path) -> None:
        path.mkdir(parents=True, exist_ok=True)
        torch.save({
            "step": self.step,
            "params": {name: t.detach() for name, t in named_leaves(self.state["params"])},
            "optimizer": self.optimizer.state_dict(),
            "occ": dict(self.state["occ"]),
            "step_generator": self._step_gen.get_state(),
        }, path / "state.pt")
        with open(path / "dynamic_batch.json", "w") as f:
            json.dump({"rays": self.dyn.rays, "num_samples": self.dyn.march.num_samples,
                       "budgets": list(self.dyn.budgets)}, f)
        if self.config.save_only_latest_checkpoint:
            for p in sorted(ckpt_dir.glob("step-*")):
                if p.name != path.name:
                    shutil.rmtree(p, ignore_errors=True)

    def load_checkpoint(self, load_dir: Path, load_step: Optional[int] = None) -> None:
        """Restore `load_dir/step-{load_step:09d}` (the latest when None) into
        the set-up state, with the applied shapes; a decision that was
        pending when it was saved is dropped. Over a mesh every rank reads
        it, then takes rank 0's tensors."""
        load_dir = Path(load_dir)
        if load_step is None:
            steps = sorted(int(p.name.split("-")[1]) for p in load_dir.glob("step-*"))
            if not steps:
                raise FileNotFoundError(f"no checkpoints under {load_dir}")
            load_step = steps[-1]
        path = load_dir / f"step-{load_step:09d}"
        saved = torch.load(path / "state.pt", map_location=self.device, weights_only=True)
        with torch.no_grad():
            for name, t in named_leaves(self.state["params"]):
                t.copy_(saved["params"][name])
        self.optimizer.load_state_dict(saved["optimizer"])
        self.state["occ"] = dict(saved["occ"])
        self.state["step"] = int(saved["step"])
        self._step_gen.set_state(saved["step_generator"].cpu())
        with open(path / "dynamic_batch.json") as f:
            dyn = json.load(f)
        self.dyn = DynamicShapes(
            int(dyn["rays"]),
            dataclasses.replace(self.model.march_config, num_samples=int(dyn["num_samples"])),
            tuple(int(b) for b in dyn["budgets"]))
        self.pending_adapt = None
        self._replicate()
        if "endmembers" in self.state["params"] and self.is_main:
            np.save("endmembers_loaded.npy",
                    self.state["params"]["endmembers"].detach().cpu().numpy())
