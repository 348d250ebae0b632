"""Camera model and ray generation (port of umhs_tpu/data/cameras.py).

nerfstudio's convention: OpenGL camera-to-world (x right, y up, z back),
pixel centres at (row, col) + 0.5, direction_cam = [(u - cx)/fx,
-(v - cy)/fy, -1]; OPENCV cameras may carry radial/tangential distortion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Cameras:
    """Batched pinhole cameras over N frames, held in numpy."""

    camera_to_worlds: np.ndarray  # (N, 3, 4) OpenGL c2w
    fx: np.ndarray  # (N,)
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: np.ndarray  # (N,) int
    height: np.ndarray
    distortion_params: Optional[np.ndarray] = None  # (N, 6) k1 k2 k3 k4 p1 p2
    camera_type: str = "PERSPECTIVE"

    def rescale_output_resolution(self, scaling_factor: float) -> "Cameras":
        """The same cameras at a resolution scaled by `scaling_factor`."""
        return dataclasses.replace(
            self,
            fx=self.fx * scaling_factor, fy=self.fy * scaling_factor,
            cx=self.cx * scaling_factor, cy=self.cy * scaling_factor,
            width=(self.width * scaling_factor).astype(self.width.dtype),
            height=(self.height * scaling_factor).astype(self.height.dtype),
        )

    def to_device_dict(self, device="cpu") -> Dict[str, torch.Tensor]:
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        d = {"c2w": f32(self.camera_to_worlds), "fx": f32(self.fx), "fy": f32(self.fy),
             "cx": f32(self.cx), "cy": f32(self.cy)}
        if self.distortion_params is not None and np.abs(self.distortion_params).max() > 0:
            d["distortion"] = f32(self.distortion_params)
        return d


def _undistort_radial(x, y, dist):
    """Fixed-point undistortion for OpenCV k1, k2, k3, p1, p2 (5 iterations)."""
    k1, k2, k3 = dist[..., 0], dist[..., 1], dist[..., 2]
    p1, p2 = dist[..., 4], dist[..., 5]
    xd, yd = x, y
    for _ in range(5):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x, y


def generate_rays(
    cam: Dict[str, torch.Tensor],
    camera_indices: torch.Tensor,
    pixel_rows: torch.Tensor,
    pixel_cols: torch.Tensor,
    camera_type: str = "PERSPECTIVE",
) -> Dict[str, torch.Tensor]:
    """World-space rays for (camera, row, col) triples:
    {"origins", "directions" (unit), "camera_indices"}."""
    idx = camera_indices.long()
    fx, fy, cx, cy = cam["fx"][idx], cam["fy"][idx], cam["cx"][idx], cam["cy"][idx]
    c2w = cam["c2w"][idx]  # (R, 3, 4)
    u = pixel_cols.float() + 0.5
    v = pixel_rows.float() + 0.5
    x = (u - cx) / fx
    y = (v - cy) / fy
    if "distortion" in cam and camera_type != "EQUIRECTANGULAR":
        x, y = _undistort_radial(x, y, cam["distortion"][idx])

    if camera_type in ("PERSPECTIVE", "OPENCV"):
        dirs_cam = torch.stack([x, -y, -torch.ones_like(x)], dim=-1)
    elif camera_type == "OPENCV_FISHEYE":
        # equidistant: the radius in the normalised image plane is the angle
        theta = torch.clamp(torch.sqrt(x * x + y * y), 1e-9, math.pi)
        sin_over_theta = torch.sin(theta) / theta
        dirs_cam = torch.stack(
            [x * sin_over_theta, -y * sin_over_theta, -torch.cos(theta)], dim=-1)
    elif camera_type == "EQUIRECTANGULAR":
        theta = -math.pi * x
        phi = -0.5 * math.pi * y
        cos_phi = torch.cos(phi)
        dirs_cam = torch.stack(
            [torch.sin(theta) * cos_phi, torch.sin(phi), -torch.cos(theta) * cos_phi], dim=-1)
    else:
        raise ValueError(f"unknown camera_type {camera_type!r}")
    dirs_world = torch.einsum("rij,rj->ri", c2w[:, :, :3], dirs_cam)
    dirs_world = dirs_world / torch.linalg.vector_norm(dirs_world, dim=-1, keepdim=True)
    return {"origins": c2w[:, :, 3], "directions": dirs_world,
            "camera_indices": idx.int()}


def generate_camera_rays(
    cam: Dict[str, torch.Tensor],
    camera_index: int,
    height: int,
    width: int,
    camera_type: str = "PERSPECTIVE",
) -> Dict[str, torch.Tensor]:
    """All pixel rays of one camera, row-major: an (H * W,) ray dict."""
    dev = cam["fx"].device
    rows, cols = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    idx = torch.full((height * width,), camera_index, dtype=torch.int32, device=dev)
    return generate_rays(cam, idx, rows.reshape(-1), cols.reshape(-1), camera_type)
