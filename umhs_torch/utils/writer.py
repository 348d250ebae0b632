"""Metric writers (port of the console part of umhs_tpu/utils/writer.py)."""

from __future__ import annotations

from typing import Dict


class ConsoleWriter:
    """Prints each written set of scalars on one line."""

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        body = ", ".join(f"{k}={float(v):.6g}" for k, v in scalars.items())
        print(f"[step {step}] {body}", flush=True)

    def write_image(self, step: int, name: str, image) -> None:
        """An (H, W, 3) image in [0, 1]: the console shows none."""
