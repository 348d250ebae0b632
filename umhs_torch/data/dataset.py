"""In-memory hyperspectral dataset (port of umhs_tpu/data/dataset.py).

Loads a parsed split into host arrays: RGB(A) images, per-frame `.npy`
hyperspectral cubes (integer cubes scaled by their type's maximum, all
clamped to [0, 1]), frame masks and the flat ids of their valid pixels,
segmentation PNGs and DINO feature tensors. It owns the `vca.npy` side
effect: when the cache is absent, VCA runs on the first cube and writes the
endmember matrix that the trainer's setup reads (load_vca). Cubes are read
by the native loader (umhs_torch/native) where it takes their format, else
one by one with numpy.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import native
from .dataparser import DataparserOutputs
from .png import read_image
from .vca import vca_endmembers_from_cube


def _load_image(path: Path) -> np.ndarray:
    img = read_image(path).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    return img


def load_cubes(paths: Sequence, item_shape: Sequence[int], impl: str = "auto") -> np.ndarray:
    """N same-shape .npy cubes -> one (N, *item_shape) float32 stack, integer
    types scaled by the float32 reciprocal of their maximum, clamped to
    [0, 1].

    The headers are read first. With impl="auto" a call whose files the
    native loader all takes (v1/v2 .npy, C order, <f4, <f8, |u1 or <u2:
    native.takes) goes to it; any other call, and impl="plain", takes the
    numpy loop below. Both give the same bits."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    item_shape = tuple(item_shape)
    headers = [native.read_npy_header(p) for p in paths]
    for p, h in zip(paths, headers):
        if h.shape != item_shape:
            raise ValueError(f"{p}: shape {h.shape} != {item_shape}")
    if impl == "auto" and all(native.takes(h) for h in headers):
        return native.parallel_load_cubes(paths, item_shape)
    out = np.empty((len(paths), *item_shape), dtype=np.float32)
    for i, p in enumerate(paths):
        raw = np.load(p)
        arr = raw.astype(np.float32)
        if np.issubdtype(raw.dtype, np.integer):  # loader.cpp's p[i] * (1.0f / max)
            arr = arr * (np.float32(1.0) / np.float32(np.iinfo(raw.dtype).max))
        out[i] = np.clip(arr, 0.0, 1.0)
    return out


class HyperspectralDataset:
    """A DataparserOutputs split loaded fully into host arrays."""

    def __init__(self, outputs: DataparserOutputs, vca_cache: str = "vca.npy",
                 compute_vca: bool = True):
        self.outputs = outputs
        self.metadata = outputs.metadata
        self.num_classes = outputs.metadata.get("num_classes", 5)
        self.images = np.stack([_load_image(p) for p in outputs.image_filenames])

        hs_files = outputs.metadata.get("hs_filenames")
        self.hs_images: Optional[np.ndarray] = None
        if hs_files:
            first = np.clip(np.load(hs_files[0]).astype(np.float32), 0.0, 1.0)
            if compute_vca and not os.path.exists(vca_cache):
                try:
                    np.save(vca_cache, vca_endmembers_from_cube(first, self.num_classes))
                except (ValueError, np.linalg.LinAlgError):
                    pass  # as the reference: the field keeps its random init
            self.hs_images = load_cubes(hs_files, first.shape)

        self.masks: Optional[np.ndarray] = None
        if outputs.mask_filenames:
            masks = []
            for p in outputs.mask_filenames:
                m = read_image(p)
                masks.append((m[..., 0] if m.ndim == 3 else m) > 0)
            self.masks = np.stack(masks)

        seg_files = outputs.metadata.get("seg_filenames")
        self.seg_images: Optional[np.ndarray] = None
        if seg_files:
            self.seg_images = np.stack([read_image(p) for p in seg_files]).astype(np.int32)

        dino_files = outputs.metadata.get("dino_filenames")
        self.dino_feats: Optional[np.ndarray] = None
        if dino_files:
            self.dino_feats = np.stack([
                torch.load(p, map_location="cpu", weights_only=True).permute(1, 2, 0).numpy()
                for p in dino_files]).astype(np.float32)

    def __len__(self) -> int:
        return self.images.shape[0]

    def valid_indices(self) -> Optional[np.ndarray]:
        """Flat img*H*W + row*W + col ids of the pixels the masks allow, or
        None when the split has no masks."""
        if self.masks is None:
            return None
        return np.flatnonzero(self.masks.reshape(-1)).astype(np.int32)

    def arrays(self) -> Dict[str, np.ndarray]:
        out = {"image": self.images}
        if self.hs_images is not None:
            out["hs_image"] = self.hs_images
        if self.seg_images is not None:
            out["seg_image"] = self.seg_images
        if self.dino_feats is not None:
            out["dino_feat"] = self.dino_feats
        return out
