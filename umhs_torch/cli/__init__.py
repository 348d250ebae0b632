"""Command-line entry points (port of umhs_tpu/cli): train, eval, render and
viewer, with umhs_tpu's flags and config.yml. Each runs on the card unless
given `--device cpu` (or `main(argv, device="cpu")`), and raises without
one. The device flag is the CLI's own: it is not part of the config tree, so
config.yml keeps umhs_tpu's shape.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import torch

from .. import resolve_device


def split_device(argv: List[str], device="cuda") -> Tuple[List[str], torch.device]:
    """argv without its `--device X` (or `--device=X`), and the device: X,
    else `device`; raises when the card is asked for and absent."""
    rest, i = [], 0
    while i < len(argv):
        if argv[i] == "--device":
            if i + 1 >= len(argv):
                raise ValueError("flag --device missing a value")
            device = argv[i + 1]
            i += 2
        elif argv[i].startswith("--device="):
            device = argv[i].split("=", 1)[1]
            i += 1
        else:
            rest.append(argv[i])
            i += 1
    return rest, resolve_device(device)


def describe_device(device: torch.device) -> str:
    """The device's name and the count of its kind."""
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (cuda devices: {torch.cuda.device_count()})"
    return "cpu"


def parse_options(argv: List[str], tool: str) -> dict:
    """--key value pairs (dashes read as underscores) -> {key: value}."""
    if len(argv) % 2:
        raise ValueError(f"[{tool}] expected --flag value pairs, got {argv}")
    opts = {}
    for flag, value in zip(argv[::2], argv[1::2]):
        if not flag.startswith("--"):
            raise ValueError(f"[{tool}] expected --flag, got {flag!r}")
        opts[flag.lstrip("-").replace("-", "_")] = value
    return opts


def load_trained(config_path: Path, device: torch.device, load_step: Optional[int] = None):
    """(config, trainer) of a trained run: its config.yml, the dataset it
    names set up on `device`, and its latest checkpoint (or `load_step`)."""
    from ..configs import load_config
    from ..engine.trainer import Trainer

    config = load_config(Path(config_path))
    trainer = Trainer(config.trainer, config.pipeline.model, config.pipeline.datamanager,
                      num_classes=config.pipeline.num_classes, device=device)
    trainer.setup()
    trainer.load_checkpoint(trainer.checkpoint_dir, load_step)
    return config, trainer
