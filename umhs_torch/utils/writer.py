"""Metric writers: console (with the run's metrics.jsonl), tensorboard and
wandb (port of umhs_tpu/utils/writer.py).

`make_writer(vis, run_dir)` builds them from the trainer's `vis` spec.
Tensorboard and wandb are imported only when asked for; a backend that
cannot be built degrades to the console with a printed line. Metric names
match the JAX package's (psnr, psnr_spectral, num_samples_per_batch,
loss/*), and metrics.jsonl holds one {"step", "t", **metrics} record per
written step, as there.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


class Writer:
    def write(self, step: int, metrics: Dict[str, float]) -> None:
        raise NotImplementedError

    def write_image(self, step: int, name: str, image) -> None:
        """Log an (H, W, 3) float [0, 1] image (a no-op unless the backend
        takes images)."""

    def close(self) -> None:
        pass


class ConsoleWriter(Writer):
    """One printed line per written step and, with `log_file`, one JSON
    record appended to it."""

    def __init__(self, log_file: Optional[Path] = None):
        self.log_file = log_file
        if log_file is not None:
            log_file.parent.mkdir(parents=True, exist_ok=True)

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        parts = " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(metrics.items())
        )
        print(f"[step {step}] {parts}", flush=True)
        if self.log_file is not None:
            with open(self.log_file, "a") as f:
                f.write(json.dumps({"step": step, "t": time.time(), **metrics}) + "\n")


class TensorboardWriter(Writer):
    def __init__(self, log_dir: Path):
        from torch.utils.tensorboard import SummaryWriter

        self.tb = SummaryWriter(log_dir=str(log_dir))

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            try:
                self.tb.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def write_image(self, step: int, name: str, image) -> None:
        self.tb.add_image(name, np.clip(np.asarray(image), 0.0, 1.0), step, dataformats="HWC")

    def close(self) -> None:
        self.tb.close()


class WandbWriter(Writer):
    def __init__(self, project: str = "unmixNeRF", name: Optional[str] = None):
        import wandb

        # offline unless WANDB_MODE says otherwise
        self.run = wandb.init(project=project, name=name,
                              mode=os.environ.get("WANDB_MODE", "offline"))

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        import wandb

        wandb.log(metrics, step=step)

    def write_image(self, step: int, name: str, image) -> None:
        import wandb

        img = (np.clip(np.asarray(image), 0.0, 1.0) * 255).astype(np.uint8)
        wandb.log({name: wandb.Image(img)}, step=step)

    def close(self) -> None:
        self.run.finish()


class MultiWriter(Writer):
    def __init__(self, writers: List[Writer]):
        self.writers = writers

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        for w in self.writers:
            w.write(step, metrics)

    def write_image(self, step: int, name: str, image) -> None:
        for w in self.writers:
            w.write_image(step, name, image)

    def close(self) -> None:
        for w in self.writers:
            w.close()


def make_writer(vis: str, run_dir: Path) -> Writer:
    """Writers from a '+'- or ','-separated vis spec (console, viewer,
    tensorboard, wandb); an unknown spec adds nothing, and a backend that
    cannot be built falls back to the console."""
    run_dir = Path(run_dir)
    writers: List[Writer] = []
    for spec in vis.replace(",", "+").split("+"):
        spec = spec.strip()
        try:
            if spec in ("console", "viewer", ""):
                writers.append(ConsoleWriter(run_dir / "metrics.jsonl"))
            elif spec == "tensorboard":
                writers.append(TensorboardWriter(run_dir / "tb"))
            elif spec == "wandb":
                writers.append(WandbWriter(name=run_dir.parent.name))
        except Exception as e:  # a logging backend, not the computation
            print(f"writer '{spec}' unavailable ({e}); falling back to console")
            writers.append(ConsoleWriter(run_dir / "metrics.jsonl"))
    if not writers:
        writers.append(ConsoleWriter(run_dir / "metrics.jsonl"))
    return MultiWriter(writers)
