"""Spectrum -> sRGB projection (port of umhs_tpu/ops/spec_to_rgb.py).

A fixed (B, 3) matrix from the analytic CIE 1931 colour-matching functions
(piecewise Gaussians in Angstrom), projected through the colour space's
primaries and white point and column-normalised over the bands; then the
sRGB gamma and a clamp to [0, 1].
"""

from __future__ import annotations

import numpy as np
import torch


def _piecewise_gaussian(x, alpha, mu, sigma_l, sigma_r):
    x = np.asarray(x, dtype=np.float64)
    sigma = np.clip(np.where(x < mu, sigma_l, sigma_r), 1e-6, None)
    return alpha * np.exp(-((x - mu) ** 2) / (2.0 * sigma**2))


def cie_x(x):
    return (
        _piecewise_gaussian(x, 1.056, 5998.0, 379.0, 310.0)
        + _piecewise_gaussian(x, 0.362, 4420.0, 160.0, 267.0)
        + _piecewise_gaussian(x, -0.065, 5011.0, 204.0, 262.0)
    )


def cie_y(x):
    return _piecewise_gaussian(x, 0.821, 5688.0, 469.0, 405.0) + _piecewise_gaussian(
        x, 0.286, 5309.0, 163.0, 311.0
    )


def cie_z(x):
    return _piecewise_gaussian(x, 1.217, 4370.0, 118.0, 360.0) + _piecewise_gaussian(
        x, 0.681, 4590.0, 260.0, 138.0
    )


def _xy_to_xyz(x, y):
    return np.array((x, y, 1.0 - x - y), dtype=np.float64)


ILLUMINANT = {
    "D65": _xy_to_xyz(0.3127, 0.3291),
    "E": _xy_to_xyz(1.0 / 3.0, 1.0 / 3.0),
}

# (red, green, blue, white) chromaticities per colour space
COLOR_SPACE = {
    "sRGB": (_xy_to_xyz(0.64, 0.33), _xy_to_xyz(0.30, 0.60),
             _xy_to_xyz(0.15, 0.06), ILLUMINANT["D65"]),
    "AdobeRGB": (_xy_to_xyz(0.64, 0.33), _xy_to_xyz(0.21, 0.71),
                 _xy_to_xyz(0.15, 0.06), ILLUMINANT["D65"]),
    "AppleRGB": (_xy_to_xyz(0.625, 0.34), _xy_to_xyz(0.28, 0.595),
                 _xy_to_xyz(0.155, 0.07), ILLUMINANT["D65"]),
    "UHDTV": (_xy_to_xyz(0.708, 0.292), _xy_to_xyz(0.170, 0.797),
              _xy_to_xyz(0.131, 0.046), ILLUMINANT["D65"]),
    "CIERGB": (_xy_to_xyz(0.7347, 0.2653), _xy_to_xyz(0.2738, 0.7174),
               _xy_to_xyz(0.1666, 0.0089), ILLUMINANT["E"]),
}


def build_spec_to_rgb_matrix(wavelengths_nm, color_space: str = "sRGB") -> np.ndarray:
    """float32 (B, 3) matrix M with rgb_linear = spectrum @ M."""
    bands_angstrom = np.asarray(wavelengths_nm, dtype=np.float64) * 10.0
    cmf = np.stack([cie_x(bands_angstrom), cie_y(bands_angstrom), cie_z(bands_angstrom)], axis=0)
    red, green, blue, white = COLOR_SPACE[color_space]
    chroma_inv = np.linalg.inv(np.stack((red, green, blue), axis=0).T)
    white_scale = chroma_inv @ white
    xyz_to_rgb = chroma_inv / white_scale[:, None]
    rgb = cmf.T @ xyz_to_rgb.T  # (B, 3)
    rgb = rgb / np.sum(rgb, axis=0, keepdims=True)
    return rgb.astype(np.float32)


def srgb_gamma(x: torch.Tensor) -> torch.Tensor:
    """12.92 x below 0.0031308, else 1.055 x^(1/2.4) - 0.055."""
    return torch.where(
        x < 0.0031308,
        12.92 * x,
        1.055 * torch.pow(torch.clamp_min(x, 1e-6), 1.0 / 2.4) - 0.055,
    )


def srgb_gamma_np(x: np.ndarray) -> np.ndarray:
    return np.where(
        x < 0.0031308, 12.92 * x, 1.055 * np.power(np.clip(x, 1e-6, None), 1.0 / 2.4) - 0.055
    )


class ColourSystem:
    """rgb = clamp(gamma(spectrum @ M), 0, 1) with a fixed matrix M."""

    def __init__(self, wavelengths_nm, color_space: str = "sRGB", device="cpu"):
        self.wavelengths_nm = tuple(float(w) for w in wavelengths_nm)
        self.color_space = color_space
        self.matrix = torch.as_tensor(
            build_spec_to_rgb_matrix(wavelengths_nm, color_space), device=device)

    def __call__(self, spectrum: torch.Tensor) -> torch.Tensor:
        rgb = spectrum.float() @ self.matrix
        return torch.clamp(srgb_gamma(rgb), 0.0, 1.0)
