"""Image and spectral quality metrics: PSNR, SSIM, SAM, RMSE and LPIPS
(port of umhs_tpu/utils/metrics.py).

Host numpy on full eval images, not in the training loop: PSNR at data range
1, SSIM with an 11x11 Gaussian window (sigma 1.5) in valid mode, channels
averaged, the spectral angle per pixel nan-averaged over pixels with a
non-zero spectrum, RMSE. LPIPS is a perceptual distance over a VGG16 conv
trunk in torch, on the device it is given: ImageNet weights from a local
archive when one exists, else the seeded random trunk (`LPIPS_VARIANT`).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


def psnr(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2))
    return float(10.0 * np.log10(data_range**2 / max(mse, 1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _filter2d_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 2-D filter over the first two axes, valid region only (the
    kernel is symmetric, so correlation and convolution agree)."""
    out = np.lib.stride_tricks.sliding_window_view(img, len(k), axis=0) @ k
    return np.lib.stride_tricks.sliding_window_view(out, len(k), axis=1) @ k


def ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM over the valid windows, averaged over channels."""
    pred = np.asarray(pred, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    kern = _gaussian_kernel()
    vals = []
    for c in range(pred.shape[-1]):
        x, y = pred[..., c], gt[..., c]
        mu_x = _filter2d_valid(x, kern)
        mu_y = _filter2d_valid(y, kern)
        sigma_x = _filter2d_valid(x * x, kern) - mu_x**2
        sigma_y = _filter2d_valid(y * y, kern) - mu_y**2
        sigma_xy = _filter2d_valid(x * y, kern) - mu_x * mu_y
        num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
        den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
        vals.append(np.mean(num / den))
    return float(np.mean(vals))


def sam(pred: np.ndarray, gt: np.ndarray, eps: float = 1e-8) -> float:
    """Spectral Angle Mapper: mean angle (radians) between per-pixel spectra;
    pixels where either spectrum is ~0 are left out (nan-mean)."""
    pred = np.asarray(pred, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    dot = np.sum(pred * gt, axis=-1)
    denom = np.linalg.norm(pred, axis=-1) * np.linalg.norm(gt, axis=-1)
    ang = np.arccos(np.clip(dot / (denom + eps), -1.0, 1.0))
    return float(np.nanmean(np.where(denom < eps, np.nan, ang)))


def rmse(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2)))


def mse2psnr(mse: float) -> float:
    """MSE -> PSNR for [0, 1] images."""
    return float(-10.0 * np.log10(max(float(mse), 1e-12)))


# which trunk lpips() uses: "vgg16_imagenet" (a local weight archive) or
# "vgg16_random" (seeded random weights: a distance comparable within runs of
# this code, not with published LPIPS); None before the first call
LPIPS_VARIANT: Optional[str] = None

# VGG16 conv trunk: out-channels per conv, "M" = 2x2 max-pool
_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M")
# the ReLU outputs the distance reads; the trunk is built up to the last
_LPIPS_TAPS = (3, 8, 15, 22, 29)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_LPIPS_TRUNKS: Dict[torch.device, torch.nn.Sequential] = {}


def _vgg16_weight_file() -> Optional[Path]:
    """An ImageNet VGG16 weight archive (.npz with conv{i}_w / conv{i}_b, as
    scripts/convert_vgg16_weights.py writes it), looked for at
    $UMHS_VGG16_WEIGHTS, <repo>/assets/vgg16_imagenet.npz and
    ~/.cache/umhs_tpu/vgg16_imagenet.npz, in that order; None if absent.
    Nothing is downloaded."""
    env = os.environ.get("UMHS_VGG16_WEIGHTS")
    candidates = [Path(env)] if env else []
    candidates += [
        Path(__file__).resolve().parents[2] / "assets" / "vgg16_imagenet.npz",
        Path.home() / ".cache" / "umhs_tpu" / "vgg16_imagenet.npz",
    ]
    return next((p for p in candidates if p.is_file()), None)


def _build_vgg_trunk() -> torch.nn.Sequential:
    """The VGG16 trunk up to its last tapped ReLU, on the CPU, and set
    LPIPS_VARIANT. Its random weights are those that torch.manual_seed(0)
    followed by the layers' construction gives (the JAX package's trunk, bit
    for bit), drawn inside fork_rng so the global generator does not move;
    a weight archive then overwrites them."""
    global LPIPS_VARIANT
    layers, convs, c_in = [], [], 3
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(0)
        for spec in _VGG16_CFG:
            if spec == "M":
                layers.append(torch.nn.MaxPool2d(2, 2))
            else:
                convs.append(torch.nn.Conv2d(c_in, spec, 3, padding=1))
                layers += [convs[-1], torch.nn.ReLU(inplace=True)]
                c_in = spec
    wfile = _vgg16_weight_file()
    if wfile is not None:
        with np.load(wfile) as z, torch.no_grad():
            for i, conv in enumerate(convs):
                conv.weight.copy_(torch.from_numpy(z[f"conv{i}_w"]))
                conv.bias.copy_(torch.from_numpy(z[f"conv{i}_b"]))
    LPIPS_VARIANT = "vgg16_imagenet" if wfile is not None else "vgg16_random"
    return torch.nn.Sequential(*layers[:max(_LPIPS_TAPS) + 1]).eval()


def lpips(pred: np.ndarray, gt: np.ndarray, device="cpu") -> float:
    """LPIPS-style distance between two (H, W, 3) images in [0, 1]: the mean
    squared difference of the channel-normalised VGG16 features at each tap,
    summed over the taps. Runs on `device`, one image at a time, with f32
    convolutions (TF32 off). Raises on what the trunk cannot take (an image
    under 16 x 16)."""
    device = torch.device(device)
    if device not in _LPIPS_TRUNKS:
        _LPIPS_TRUNKS[device] = _build_vgg_trunk().to(device)
    trunk = _LPIPS_TRUNKS[device]
    mean = torch.tensor(_IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(_IMAGENET_STD, device=device).view(1, 3, 1, 1)

    def prep(x):
        t = torch.from_numpy(np.asarray(x, np.float32)).permute(2, 0, 1)[None].to(device)
        return (t - mean) / std

    xa, xb = prep(pred), prep(gt)
    dist = 0.0
    cudnn = torch.backends.cudnn
    with torch.no_grad(), cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                                      deterministic=cudnn.deterministic, allow_tf32=False):
        for i, layer in enumerate(trunk):
            xa, xb = layer(xa), layer(xb)
            if i in _LPIPS_TAPS:
                na = xa / (xa.norm(dim=1, keepdim=True) + 1e-10)
                nb = xb / (xb.norm(dim=1, keepdim=True) + 1e-10)
                dist += float(((na - nb) ** 2).mean())
    return dist
