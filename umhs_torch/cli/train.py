"""`umhs-torch-train`: the ns-train equivalent (port of umhs_tpu/cli/train.py).

The reference's surface, `ns-train umhsnerf --data PATH [--pipeline.model.*
...]`, with the same dotted flags (umhs_torch/configs.py); the resolved
config is written to <output>/<experiment>/<method>/config.yml for the eval,
render and viewer CLIs to reload. After max_num_iterations steps the eval
views are rendered and scored into final_metrics.json.

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
from typing import Dict, NamedTuple

from . import describe_device, split_device


class TrainResult(NamedTuple):
    final_metrics: Dict[str, float]  # the last logged training metrics
    evals: Dict[str, float]  # eval_all_images
    trainer: object  # the Trainer, at its last step


def main(argv=None, device="cuda") -> TrainResult:
    argv = list(sys.argv[1:] if argv is None else argv)
    from ..configs import apply_cli_overrides, save_config, umhs_method_defaults
    from ..engine.trainer import Trainer

    argv, dev = split_device(argv, device)
    method = "umhsnerf"
    if argv and not argv[0].startswith("--"):
        method = argv.pop(0)

    config, ignored = apply_cli_overrides(umhs_method_defaults(), argv)
    if ignored:
        print(f"[umhs-train] accepted-but-inert flags: {ignored}")
    if config.pipeline.check_nan:
        # the reference: check_nan -> torch.autograd.set_detect_anomaly
        # (umhs_pipeline.py:77-78)
        from ..utils.hooks import enable_nan_checks

        enable_nan_checks(True)

    trainer = Trainer(config.trainer, config.pipeline.model, config.pipeline.datamanager,
                      num_classes=config.pipeline.num_classes, device=dev)
    save_config(config, trainer.run_dir / "config.yml")
    print(f"[umhs-train] method={method} run_dir={trainer.run_dir}")
    print(f"[umhs-train] device={describe_device(dev)}")

    trainer.setup()
    final_metrics = trainer.train()
    print(f"[umhs-train] done: {json.dumps(final_metrics)}")

    evals = trainer.eval_all_images()
    print(f"[umhs-train] eval: {json.dumps(evals)}")
    with open(trainer.run_dir / "final_metrics.json", "w") as f:
        json.dump({"train": final_metrics, "eval": evals}, f, indent=2)
    return TrainResult(final_metrics, evals, trainer)


def script() -> None:
    """The console script: main() with its result left out of the exit code."""
    main()


if __name__ == "__main__":
    main()
