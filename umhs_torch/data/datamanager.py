"""Pixel sampling and the device-resident splits
(port of umhs_tpu/data/datamanager.py).

`sample_pixel_batch` gathers every batch key at given pixels and generates
their rays; the pixels are an argument (`draw`), so a test can hand it the
indices the JAX package drew. `draw_pixels` makes that draw from a
torch.Generator. `InMemoryDataManager` holds a train split's images,
hyperspectral cubes and cameras on the device; `UMHSDataManager` parses a
dataset on disk (both splits), stages the train split the same way and keeps
the eval split for the eval loops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from .cameras import Cameras, generate_camera_rays, generate_rays
from .dataparser import DataParserConfig, UMHSDataParser
from .dataset import HyperspectralDataset


@dataclasses.dataclass(frozen=True)
class DataManagerConfig:
    dataparser: DataParserConfig = dataclasses.field(default_factory=DataParserConfig)
    train_num_rays_per_batch: int = 9216 * 4
    eval_num_rays_per_batch: int = 4096
    patch_size: int = 1
    hs_dtype: str = "float32"  # "bfloat16" halves the cubes' device memory


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


def stage_arrays(arrays: Dict[str, np.ndarray], valid_indices: Optional[np.ndarray],
                 hs_dtype: str, device) -> Dict[str, torch.Tensor]:
    """A split's arrays on the device: cubes in hs_dtype, segmentation int32,
    the rest float32, and the valid pixel ids (int64) when there are masks."""
    staged = {}
    for k, v in arrays.items():
        if k == "hs_image":
            dt = torch.bfloat16 if hs_dtype == "bfloat16" else torch.float32
        elif k == "seg_image":
            dt = torch.int32
        else:
            dt = torch.float32
        staged[k] = torch.as_tensor(np.asarray(v), device=device).to(dt)
    if valid_indices is not None:
        staged["valid_indices"] = torch.as_tensor(np.asarray(valid_indices, np.int64),
                                                  device=device)
    return staged


class InMemoryDataManager:
    """A train split on the device: images (N, H, W, 3 or 4), optional
    hyperspectral cubes (N, H, W, B), cameras, optional valid pixel ids; the
    ray batch sizes and patch size come from `config`."""

    def __init__(
        self,
        images: np.ndarray,
        cameras: Cameras,
        hs_images: Optional[np.ndarray] = None,
        valid_indices: Optional[Sequence[int]] = None,
        config: Optional[DataManagerConfig] = None,
        wavelengths: Optional[Sequence[float]] = None,
        scene_scale: float = 1.0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.config = config or DataManagerConfig()
        arrays = {"image": images}
        if hs_images is not None:
            arrays["hs_image"] = hs_images
        self.data = stage_arrays(arrays, valid_indices, self.config.hs_dtype, self.device)
        self.cam = cameras.to_device_dict(self.device)
        self.camera_type = cameras.camera_type
        self.wavelengths = list(wavelengths) if wavelengths is not None else None
        self.scene_scale = scene_scale

    @property
    def patch_size(self) -> int:
        return self.config.patch_size

    @property
    def num_train_images(self) -> int:
        return self.data["image"].shape[0]

    def draw(self, generator: torch.Generator, batch_size: int) -> Draw:
        """The pixel draw of one batch (anchors when patch_size > 1)."""
        return draw_pixels(generator, self.data, batch_size // (self.patch_size ** 2))

    def sample(self, batch_size: int, draw: Draw):
        """(rays, batch) at the drawn pixels."""
        return sample_pixel_batch(self.data, self.cam, batch_size, draw,
                                  patch_size=self.patch_size, camera_type=self.camera_type)


class UMHSDataManager(InMemoryDataManager):
    """A dataset on disk: both splits parsed and loaded (the train split's
    loading writes vca.npy when it is absent), the train split staged on the
    device; the eval split is staged on first use by the eval loops."""

    def __init__(self, config: DataManagerConfig, num_classes: Optional[int] = None,
                 device="cuda"):
        device = resolve_device(device)
        dp_cfg = config.dataparser
        if num_classes is not None:
            dp_cfg = dataclasses.replace(dp_cfg, num_classes=num_classes)
        parser = UMHSDataParser(dp_cfg)
        self.train_outputs = parser.parse("train")
        self.eval_outputs = parser.parse("val")
        self.train_dataset = HyperspectralDataset(self.train_outputs, vca_cache=dp_cfg.vca_cache)
        self.eval_dataset = HyperspectralDataset(self.eval_outputs, vca_cache=dp_cfg.vca_cache,
                                                 compute_vca=False)
        arrays = self.train_dataset.arrays()
        super().__init__(
            arrays.pop("image"), self.train_outputs.cameras, hs_images=arrays.pop("hs_image", None),
            valid_indices=self.train_dataset.valid_indices(), config=config,
            wavelengths=self.train_outputs.metadata.get("wavelengths"),
            scene_scale=self.train_outputs.scene_scale, device=device)
        # the split's other arrays (masks, segmentation, features)
        self.data.update(stage_arrays(arrays, None, config.hs_dtype, self.device))
        self._eval_data: Optional[Dict[str, torch.Tensor]] = None

    @property
    def metadata(self) -> Dict:
        return self.train_outputs.metadata

    def eval_device_data(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The eval split's arrays and cameras on the device (staged once;
        cubes stay float32 whatever hs_dtype, as umhs_tpu's eval loops keep
        them)."""
        if self._eval_data is None:
            self._eval_data = stage_arrays(self.eval_dataset.arrays(),
                                           self.eval_dataset.valid_indices(),
                                           "float32", self.device)
            self._eval_cam = self.eval_outputs.cameras.to_device_dict(self.device)
        return self._eval_data, self._eval_cam

    def eval_image(self, idx: int):
        """(the camera's H * W rays, its full-image ground truth on the
        device, (H, W)) of eval view `idx`."""
        data, cam = self.eval_device_data()
        h = int(self.eval_outputs.cameras.height[idx])
        w = int(self.eval_outputs.cameras.width[idx])
        rays = generate_camera_rays(cam, idx, h, w,
                                    camera_type=self.eval_outputs.cameras.camera_type)
        batch = {k: v[idx] for k, v in data.items() if k != "valid_indices"}
        return rays, batch, (h, w)
