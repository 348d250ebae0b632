"""Debug visualisation helpers (port of umhs_tpu/data/explore.py).

Equivalents of the reference's exploration scripts
(data/explore.py — EXR cube inspection — and
data/plot_curve_spectorgb.py — wavelength->RGB curve plot). Matplotlib is
imported lazily; functions degrade to returning arrays when unavailable.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..ops.spec_to_rgb import build_spec_to_rgb_matrix
from .png import write_png


def cube_stats(path: Path) -> dict:
    """Summary stats of a saved hyperspectral cube (.npy)."""
    cube = np.load(path)
    return {
        "shape": cube.shape,
        "dtype": str(cube.dtype),
        "min": float(cube.min()),
        "max": float(cube.max()),
        "mean": float(cube.mean()),
        "band_means": cube.reshape(-1, cube.shape[-1]).mean(0).tolist(),
    }


def wavelength_rgb_curve(
    wavelengths: Optional[Sequence[float]] = None, save_path: Optional[Path] = None
) -> np.ndarray:
    """The per-band RGB contribution curve (plot_curve_spectorgb.py).

    Returns the (B, 3) matrix; saves a plot when matplotlib is available and
    save_path is given.
    """
    if wavelengths is None:
        wavelengths = np.arange(380, 781, 5)
    m = build_spec_to_rgb_matrix(wavelengths)
    if save_path is not None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.figure()
            for i, c in enumerate("rgb"):
                plt.plot(wavelengths, m[:, i], color=c, label=c.upper())
            plt.xlabel("wavelength (nm)")
            plt.ylabel("contribution")
            plt.legend()
            plt.savefig(save_path)
            plt.close()
        except ImportError:
            pass
    return m


def band_image(cube_path: Path, band: int, save_path: Optional[Path] = None):
    """Extract one band of a cube as a grayscale image."""
    cube = np.load(cube_path)
    img = np.clip(cube[..., band], 0, 1)
    if save_path is not None:
        write_png(save_path, (img * 255).astype(np.uint8))
    return img


if __name__ == "__main__":
    import sys

    print(cube_stats(Path(sys.argv[1])))
