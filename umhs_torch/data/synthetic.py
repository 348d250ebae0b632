"""Procedural multi-view hyperspectral scene (port of umhs_tpu/data/synthetic.py).

Lambertian spheres, each with its own smooth endmember spectrum, ray traced
analytically from orbit cameras. It stands in for captures in tests and in
the GPU smoke run; everything is numpy and seeded.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..ops.spec_to_rgb import build_spec_to_rgb_matrix, srgb_gamma_np
from .cameras import Cameras
from .png import read_image, write_png


@dataclasses.dataclass(frozen=True)
class SyntheticSceneConfig:
    num_views_train: int = 24
    num_views_eval: int = 4
    image_size: int = 64
    num_bands: int = 21
    wavelength_start: float = 450.0
    wavelength_step: float = 10.0
    num_spheres: int = 4
    camera_radius: float = 3.0
    focal_scale: float = 1.2  # focal = focal_scale * image_size
    seed: int = 0

    @property
    def wavelengths(self) -> np.ndarray:
        return self.wavelength_start + self.wavelength_step * np.arange(self.num_bands)

    @property
    def focal(self) -> float:
        return self.focal_scale * self.image_size


def _look_at(eye: np.ndarray, target: np.ndarray, up=np.array([0.0, 0.0, 1.0])):
    """OpenGL camera-to-world: the camera looks down -z."""
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def make_spheres(cfg: SyntheticSceneConfig):
    """Sphere centres, radii and per-sphere spectra (K, B) in [0, 1]."""
    rng = np.random.default_rng(cfg.seed)
    centers, radii = [], []
    for i in range(cfg.num_spheres):
        ang = 2 * np.pi * i / cfg.num_spheres
        r = 0.45 if cfg.num_spheres > 1 else 0.0
        centers.append([r * np.cos(ang), r * np.sin(ang), 0.15 * (i % 2)])
        radii.append(0.28 + 0.05 * rng.random())
    t = np.linspace(0.0, 1.0, cfg.num_bands)
    spectra = [0.15 + 0.75 * np.exp(-((t - (i + 0.5) / cfg.num_spheres) ** 2) / 0.03)
               for i in range(cfg.num_spheres)]
    return np.asarray(centers), np.asarray(radii), np.asarray(spectra)


def _trace(origins, dirs, centers, radii, spectra, light_dir=np.array([0.4, 0.3, 0.85])):
    """Ray-trace lambertian spheres -> (spectra (n, B), alpha (n,))."""
    light = light_dir / np.linalg.norm(light_dir)
    n = origins.shape[0]
    best_t = np.full(n, np.inf)
    best_idx = np.full(n, -1, dtype=int)
    for i, (c, r) in enumerate(zip(centers, radii)):
        oc = origins - c
        b = np.sum(oc * dirs, axis=-1)
        disc = b * b - (np.sum(oc * oc, axis=-1) - r * r)
        sq = np.sqrt(np.maximum(disc, 0.0))
        t = -b - sq
        t = np.where(t > 1e-3, t, -b + sq)
        valid = (disc > 0) & (t > 1e-3) & (t < best_t)
        best_t = np.where(valid, t, best_t)
        best_idx = np.where(valid, i, best_idx)

    spec = np.zeros((n, spectra.shape[1]), dtype=np.float32)
    hit = best_idx >= 0
    if hit.any():
        pts = origins[hit] + dirs[hit] * best_t[hit, None]
        idx = best_idx[hit]
        normals = (pts - centers[idx]) / radii[idx][:, None]
        shade = 0.35 + 0.65 * np.maximum(normals @ light, 0.0)
        spec[hit] = spectra[idx] * shade[:, None]
    return np.clip(spec, 0.0, 1.0), hit.astype(np.float32)


def render_views(cfg: SyntheticSceneConfig, num_views: int, phase: float = 0.0):
    """Orbit views -> (poses (V, 4, 4), cubes (V, H, W, B), rgba (V, H, W, 4))."""
    centers, radii, spectra = make_spheres(cfg)
    H = W = cfg.image_size
    cx = cy = cfg.image_size / 2.0
    m = build_spec_to_rgb_matrix(cfg.wavelengths)
    poses, cubes, rgbas = [], [], []
    for v in range(num_views):
        ang = 2 * np.pi * v / num_views + phase
        elev = 0.45 + 0.25 * np.sin(3 * ang)
        eye = cfg.camera_radius * np.array(
            [np.cos(ang) * np.cos(elev), np.sin(ang) * np.cos(elev), np.sin(elev)])
        c2w = _look_at(eye, np.zeros(3))
        poses.append(c2w)
        vv, uu = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5, indexing="ij")
        x = (uu - cx) / cfg.focal
        y = (vv - cy) / cfg.focal
        dirs = np.stack([x, -y, -np.ones_like(x)], axis=-1).reshape(-1, 3) @ c2w[:3, :3].T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        spec, alpha = _trace(np.tile(eye, (H * W, 1)), dirs, centers, radii, spectra)
        cube = spec.reshape(H, W, cfg.num_bands)
        rgb = np.clip(srgb_gamma_np(np.clip(cube @ m, 0, 1)), 0, 1)
        cubes.append(cube)
        rgbas.append(np.concatenate([rgb, alpha.reshape(H, W, 1)], axis=-1).astype(np.float32))
    return np.stack(poses), np.stack(cubes), np.stack(rgbas)


def scene_cameras(cfg: SyntheticSceneConfig, poses: np.ndarray) -> Cameras:
    """Pinhole cameras of rendered views, with the scene's own poses."""
    n = poses.shape[0]
    full = lambda v: np.full((n,), v, dtype=np.float32)  # noqa: E731
    size = np.full((n,), cfg.image_size, dtype=np.int64)
    return Cameras(
        camera_to_worlds=poses[:, :3, :].astype(np.float32),
        fx=full(cfg.focal), fy=full(cfg.focal),
        cx=full(cfg.image_size / 2.0), cy=full(cfg.image_size / 2.0),
        width=size, height=size,
    )


def ray_samples(num_rays: int, samples: int, seed: int) -> np.ndarray:
    """(num_rays * samples, 3) f32 positions in [0, 1]^3: `num_rays` random
    lines through the unit cube, `samples` evenly spaced points on each
    inside it, ray-major as the compact buffer holds a batch's samples (so
    neighbouring samples share hash-grid rows at the coarse levels)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(num_rays, 3))
    d = rng.normal(size=(num_rays, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.where(np.abs(d) < 1e-6, 1e-6, d)
    t0, t1 = -a / d, (1 - a) / d
    near = np.minimum(t0, t1).max(axis=-1, keepdims=True)
    far = np.maximum(t0, t1).min(axis=-1, keepdims=True)
    t = near + (far - near) * (np.arange(samples) + 0.5) / samples
    pos = a[:, None] + t[..., None] * d[:, None]
    return np.clip(pos, 0.0, 1.0).reshape(-1, 3).astype(np.float32)


def write_dataset(root: Path, cfg: Optional[SyntheticSceneConfig] = None) -> Path:
    """Write the scene as a dataset directory (umhs_tpu/data/synthetic.py:151-191):
    train/ and eval/ RGBA PNGs and .npy cubes, and transforms.json with the
    intrinsics, an OPENCV camera model, the wavelengths and one frame per
    view. Returns the root path."""
    cfg = cfg or SyntheticSceneConfig()
    root = Path(root)
    frames: List[Dict] = []
    for split, n, phase in (("train", cfg.num_views_train, 0.0),
                            ("eval", cfg.num_views_eval, 0.13)):
        (root / split).mkdir(parents=True, exist_ok=True)
        poses, cubes, rgbas = render_views(cfg, n, phase)
        for i in range(n):
            img_rel, hs_rel = f"{split}/r_{i}.png", f"{split}/r_{i}.npy"
            write_png(root / img_rel, (rgbas[i] * 255).astype(np.uint8))
            np.save(root / hs_rel, cubes[i])
            frames.append({"file_path": img_rel, "hyperspectral_file_path": hs_rel,
                           "transform_matrix": poses[i].tolist()})
    meta = {
        "fl_x": cfg.focal_scale * cfg.image_size,
        "fl_y": cfg.focal_scale * cfg.image_size,
        "cx": cfg.image_size / 2.0,
        "cy": cfg.image_size / 2.0,
        "w": cfg.image_size,
        "h": cfg.image_size,
        "camera_model": "OPENCV",
        "wavelengths": [float(w) for w in cfg.wavelengths],
        "frames": frames,
    }
    with open(root / "transforms.json", "w") as f:
        json.dump(meta, f, indent=2)
    return root


def write_dino_sidecars(root: Path, dim: int = 128, seed: int = 0) -> None:
    """Give every frame of the dataset at `root` a DINO feature sidecar in
    the layout `data/dataset.py` reads: `<image>_dino.pt`, a torch.save'd
    (dim, H, W) float32 tensor, named by the frame's `dino_file_path` in
    transforms.json. The features are a fixed map of the view's RGB over
    black, tanh(rgb @ W) with W (3, dim) drawn from `seed`, so that they are
    a function of the scene a field can learn."""
    import torch

    root = Path(root)
    w = np.random.default_rng(seed).normal(size=(3, dim)).astype(np.float32)
    with open(root / "transforms.json") as f:
        meta = json.load(f)
    for frame in meta["frames"]:
        rgba = read_image(root / frame["file_path"]).astype(np.float32) / 255.0
        rgb = rgba[..., :3] * rgba[..., 3:4] if rgba.shape[-1] == 4 else rgba[..., :3]
        feat = np.tanh(rgb @ w)  # (H, W, dim)
        rel = str(Path(frame["file_path"]).with_suffix("")) + "_dino.pt"
        torch.save(torch.from_numpy(np.ascontiguousarray(feat.transpose(2, 0, 1))), root / rel)
        frame["dino_file_path"] = rel
    with open(root / "transforms.json", "w") as f:
        json.dump(meta, f, indent=2)


# The scene bench.py trains the flagship model on (bench.py:190-198).
BENCH_SCENE = SyntheticSceneConfig(
    num_views_train=16, num_views_eval=2, image_size=128, num_bands=128,
    wavelength_start=400.0, wavelength_step=2.0, num_spheres=6,
)
