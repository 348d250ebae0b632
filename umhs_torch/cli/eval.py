"""`umhs-torch-eval`: the ns-eval equivalent (port of umhs_tpu/cli/eval.py).

Reloads a run's config.yml and its latest checkpoint (or --load-step) and
reports the eval views' averaged metrics, printed and written as JSON
({experiment_name, checkpoint_step, results}).

Usage:
    python -m umhs_torch.cli.eval --load-config outputs/exp/umhsnerf/config.yml \\
        [--output-path metrics.json] [--load-step N] [--device cpu]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from . import load_trained, parse_options, split_device


def main(argv=None, device="cuda") -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, dev = split_device(argv, device)
    opts = parse_options(argv, "umhs-eval")
    if "load_config" not in opts:
        raise ValueError("[umhs-eval] --load-config is required")
    load_step = int(opts["load_step"]) if "load_step" in opts else None
    config, trainer = load_trained(Path(opts["load_config"]), dev, load_step)

    result = {
        "experiment_name": config.trainer.experiment_name,
        "checkpoint_step": trainer.step,
        "results": trainer.eval_all_images(),
    }
    print(json.dumps(result, indent=2))
    out = Path(opts.get("output_path", trainer.run_dir / "eval_metrics.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    return result


def script() -> None:
    """The console script: main() with its result left out of the exit code."""
    main()


if __name__ == "__main__":
    main()
