"""`umhs-torch-train`: the ns-train equivalent (port of umhs_tpu/cli/train.py).

The reference's surface, `ns-train umhsnerf --data PATH [--pipeline.model.*
...]`, with the same dotted flags (umhs_torch/configs.py); the resolved
config is written to <output>/<experiment>/<method>/config.yml for the eval,
render and viewer CLIs to reload. After max_num_iterations steps the eval
views are rendered and scored into final_metrics.json.

With more than one visible card it trains data-parallel, one process per
card on NCCL (parallel/mesh.py), as the JAX trainer shards over every chip:
`CUDA_VISIBLE_DEVICES=0,1,2,3` picks the cards, `--trainer.use-mesh False`
keeps one process on one card. `--machine.num-devices` stays inert, as in
the JAX package.

Usage:
    python -m umhs_torch.cli.train umhsnerf --data data/processed/hotdog \\
        --pipeline.model.method rgb+spectral --pipeline.num_classes 6 \\
        --pipeline.model.temperature 0.4 --pipeline.model.pred_specular True \\
        --pipeline.model.load_vca True \\
        --pipeline.datamanager.train-num-rays-per-batch 4096 \\
        --experiment-name hotdog-t0.4-k6 --vis console [--device cpu]
"""

from __future__ import annotations

import json
import sys
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from . import describe_device, split_device


class TrainResult(NamedTuple):
    final_metrics: Dict[str, float]  # the last logged training metrics
    evals: Dict[str, float]  # eval_all_images
    trainer: object  # the Trainer, at its last step (None when ranks trained it)


def run(config, method: str, device: torch.device, mesh=None) -> TrainResult:
    """Train `config` to its max_num_iterations in this process (one rank
    of `mesh`, or alone), then score the eval views; rank 0 writes
    config.yml and final_metrics.json."""
    from ..configs import save_config
    from ..engine.trainer import Trainer

    if config.pipeline.check_nan:
        # the reference: check_nan -> torch.autograd.set_detect_anomaly
        # (umhs_pipeline.py:77-78)
        from ..utils.hooks import enable_nan_checks

        enable_nan_checks(True)

    trainer = Trainer(config.trainer, config.pipeline.model, config.pipeline.datamanager,
                      num_classes=config.pipeline.num_classes, device=device, mesh=mesh)
    if trainer.is_main:
        save_config(config, trainer.run_dir / "config.yml")
        print(f"[umhs-train] method={method} run_dir={trainer.run_dir}")
        print(f"[umhs-train] device={describe_device(trainer.device)}")

    trainer.setup()
    final_metrics = trainer.train()
    evals = trainer.eval_all_images()
    if trainer.is_main:
        print(f"[umhs-train] done: {json.dumps(final_metrics)}")
        print(f"[umhs-train] eval: {json.dumps(evals)}")
        with open(trainer.run_dir / "final_metrics.json", "w") as f:
            json.dump({"train": final_metrics, "eval": evals}, f, indent=2)
    return TrainResult(final_metrics, evals, trainer)


def train_rank(mesh, config, method: str):
    """One rank of launch_training: (final metrics, eval metrics, the
    digest of the rank's final state)."""
    from ..parallel.mesh import state_digest

    result = run(config, method, mesh.device, mesh)
    return result.final_metrics, result.evals, state_digest(result.trainer.state_tensors())


def launch_training(config, method: str, devices: Sequence[str], backend: str,
                    init_method: Optional[str] = None) -> TrainResult:
    """Train `config` data-parallel, one process per device (rank r on
    devices[r]) joined by `backend` through `init_method` (a TCP rendezvous
    on a free localhost port when None); rank 0's metrics come back. Raises
    when a rank fails, or when the ranks end with states that differ in a
    bit. The ray counts must split evenly (parallel.check_shardable)."""
    from ..parallel.mesh import check_shardable, launch

    dm = config.pipeline.datamanager
    check_shardable(dm.train_num_rays_per_batch, dm.patch_size, len(devices))
    results = launch(train_rank, len(devices), backend, devices, args=(config, method),
                     init_method=init_method)
    digests = [digest for _, _, digest in results]
    if len(set(digests)) != 1:
        raise RuntimeError(f"the ranks end training with different states: {digests}")
    print(f"[umhs-train] {len(devices)} ranks end with the same state bits "
          f"(sha1 {digests[0]})")
    final_metrics, evals, _ = results[0]
    return TrainResult(final_metrics, evals, None)


def main(argv=None, device="cuda") -> TrainResult:
    """With trainer.use_mesh (the default) and more than one visible card
    (CUDA_VISIBLE_DEVICES chooses them), one rank per card on NCCL;
    otherwise one process on `device` (a card named by index, `cuda:1`,
    trains alone on it)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    from ..configs import apply_cli_overrides, umhs_method_defaults

    argv, dev = split_device(argv, device)
    method = "umhsnerf"
    if argv and not argv[0].startswith("--"):
        method = argv.pop(0)

    config, ignored = apply_cli_overrides(umhs_method_defaults(), argv)
    if ignored:
        print(f"[umhs-train] accepted-but-inert flags: {ignored}")
    cards = torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else 1
    if config.trainer.use_mesh and cards > 1:
        print(f"[umhs-train] data parallel: {cards} ranks, one per card, nccl")
        return launch_training(config, method, [f"cuda:{r}" for r in range(cards)], "nccl")
    return run(config, method, dev)


def script() -> None:
    """The console script: main() with its result left out of the exit code."""
    main()


if __name__ == "__main__":
    main()
