"""Pixel sampling and the in-memory train split
(port of umhs_tpu/data/datamanager.py).

`sample_pixel_batch` gathers every batch key at given pixels and generates
their rays; the pixels are an argument (`draw`), so a test can hand it the
indices the JAX package drew. `draw_pixels` makes that draw from a
torch.Generator. `InMemoryDataManager` holds the train split's images,
hyperspectral cubes and cameras on the device; reading a dataset from disk
(the dataparser and dataset) comes later.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .cameras import Cameras, generate_rays

Draw = Tuple[torch.Tensor, ...]


def draw_pixels(
    generator: torch.Generator, data: Dict[str, torch.Tensor], count: int
) -> Draw:
    """`count` uniform pixels: (img, row, col), or (sel,) indices into
    data["valid_indices"] when the split has masks."""
    valid = data.get("valid_indices")
    dev = data["image"].device
    if valid is not None:
        return (torch.randint(0, valid.shape[0], (count,), generator=generator, device=dev),)
    n, h, w = data["image"].shape[:3]
    return tuple(torch.randint(0, size, (count,), generator=generator, device=dev)
                 for size in (n, h, w))


def sample_pixel_batch(
    data: Dict[str, torch.Tensor],
    cam: Dict[str, torch.Tensor],
    batch_size: int,
    draw: Draw,
    patch_size: int = 1,
    camera_type: str = "PERSPECTIVE",
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Values and rays of `batch_size` pixels (umhs_tpu/data/datamanager.py:41-112).

    data: {"image": (N, H, W, C), optional "hs_image": (N, H, W, B), ...,
    optional "valid_indices": (V,) flat img*H*W + row*W + col ids}.
    draw: the pixels (img, row, col), each (count,), or (sel,) into
    valid_indices; count = batch_size, or batch_size / patch_size^2 patch
    anchors when patch_size > 1 (patches are centred on the anchors and
    clamped to the image). Returns (rays, batch) with batch values
    (batch_size, C) float32 and batch["indices"] (batch_size, 3)."""
    images = data["image"]
    n, h, w = images.shape[:3]
    if "valid_indices" in data:
        (sel,) = draw
        flat = data["valid_indices"][sel.long()].long()
        img, rows, cols = flat // (h * w), (flat // w) % h, flat % w
    else:
        img, rows, cols = (t.long() for t in draw)
    if patch_size > 1:
        p = patch_size
        if batch_size % (p * p):
            raise ValueError(f"batch_size {batch_size} not divisible by patch_size^2 {p * p}")
        n_anchor = batch_size // (p * p)
        r_a = torch.clamp(rows - p // 2, 0, h - p)
        c_a = torch.clamp(cols - p // 2, 0, w - p)
        dr = torch.arange(p, device=r_a.device)
        rows = (r_a[:, None, None] + dr[None, :, None]).expand(n_anchor, p, p).reshape(-1)
        cols = (c_a[:, None, None] + dr[None, None, :]).expand(n_anchor, p, p).reshape(-1)
        img = img.repeat_interleave(p * p)
    if img.shape[0] != batch_size:
        raise ValueError(f"the draw gives {img.shape[0]} pixels, not {batch_size}")

    batch = {}
    for key, arr in data.items():
        if key == "valid_indices":
            continue
        vals = arr[img, rows, cols]
        batch[key] = vals if vals.dtype == torch.int32 else vals.float()
    batch["indices"] = torch.stack([img, rows, cols], dim=-1).int()
    rays = generate_rays(cam, img, rows, cols, camera_type=camera_type)
    return rays, batch


class InMemoryDataManager:
    """The train split on the device: images (N, H, W, 3 or 4), optional
    hyperspectral cubes (N, H, W, B), cameras, optional valid pixel ids."""

    def __init__(
        self,
        images: np.ndarray,
        cameras: Cameras,
        hs_images: Optional[np.ndarray] = None,
        valid_indices: Optional[Sequence[int]] = None,
        patch_size: int = 1,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.data = {"image": torch.as_tensor(np.asarray(images, np.float32), device=self.device)}
        if hs_images is not None:
            self.data["hs_image"] = torch.as_tensor(np.asarray(hs_images, np.float32),
                                                    device=self.device)
        if valid_indices is not None:
            self.data["valid_indices"] = torch.as_tensor(
                np.asarray(valid_indices, np.int64), device=self.device)
        self.cam = cameras.to_device_dict(self.device)
        self.camera_type = cameras.camera_type
        self.patch_size = patch_size

    @property
    def num_images(self) -> int:
        return self.data["image"].shape[0]

    def draw(self, generator: torch.Generator, batch_size: int) -> Draw:
        """The pixel draw of one batch (anchors when patch_size > 1)."""
        return draw_pixels(generator, self.data, batch_size // (self.patch_size ** 2))

    def sample(self, batch_size: int, draw: Draw):
        """(rays, batch) at the drawn pixels."""
        return sample_pixel_batch(self.data, self.cam, batch_size, draw,
                                  patch_size=self.patch_size, camera_type=self.camera_type)
