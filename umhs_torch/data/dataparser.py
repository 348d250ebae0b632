"""transforms.json dataparser (port of umhs_tpu/data/dataparser.py).

What it reads and does, all host numpy at setup:
- global or per-frame intrinsics and distortion (a missing per-frame value
  raises), frames sorted by resolved file name;
- per-frame sidecar paths: mask_path, seg_file_path, depth_file_path,
  hyperspectral_file_path, dino_file_path;
- a stale `vca.npy` (vca_cache, in the working directory) is deleted when
  hyperspectral frames are present, so the endmember init reflects this
  dataset;
- the eval split modes fraction, filename (parent directory contains
  "train" or "eval"; the default), interval and all;
- pose orientation ("up"/"vertical", "pca", "none") and centring ("poses",
  "focus", "none"), then auto-scaling the translations into the +/-1 box;
- auto downscale to <= 1600 px through `images_N/`-style folders (the image
  size comes from the PNG header);
- an optional .ply point cloud (`load_ply_points`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cameras import Cameras
from .png import image_size

MAX_AUTO_RESOLUTION = 1600


@dataclasses.dataclass(frozen=True)
class DataParserConfig:
    data: Path = Path()
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None
    scene_scale: float = 1.0
    orientation_method: str = "up"  # pca | up | vertical | none
    center_method: str = "poses"  # poses | focus | none
    auto_scale_poses: bool = True
    eval_mode: str = "filename"  # fraction | filename | interval | all
    train_split_fraction: float = 0.9
    eval_interval: int = 8
    depth_unit_scale_factor: float = 1e-3
    load_3D_points: bool = False
    num_classes: int = 5
    vca_cache: str = "vca.npy"


@dataclasses.dataclass
class DataparserOutputs:
    image_filenames: List[Path]
    cameras: Cameras
    scene_scale: float
    dataparser_scale: float
    dataparser_transform: np.ndarray  # (3, 4)
    mask_filenames: Optional[List[Path]] = None
    metadata: Dict = dataclasses.field(default_factory=dict)


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-8:
        if c > 0:
            return np.eye(3)
        # 180 degrees: rotate around any axis orthogonal to a
        axis = np.cross(a, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(axis) < 1e-8:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0]))
        axis = axis / np.linalg.norm(axis)
        return 2.0 * np.outer(axis, axis) - np.eye(3)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * (1.0 / (1.0 + c))


def _focus_of_attention(poses: np.ndarray) -> np.ndarray:
    """Least-squares closest point to all camera optical axes."""
    origins = poses[:, :3, 3]
    dirs = -poses[:, :3, 2]  # cameras look down -z
    m = np.eye(3)[None] - dirs[:, :, None] * dirs[:, None, :]
    return np.linalg.solve(m.sum(0), (m @ origins[:, :, None]).sum(0))[:, 0]


def auto_orient_and_center_poses(
    poses: np.ndarray, method: str = "up", center_method: str = "poses"
) -> Tuple[np.ndarray, np.ndarray]:
    """Orient and centre (N, 4, 4) OpenGL c2w poses -> (poses, transform (3, 4))."""
    origins = poses[:, :3, 3]
    if center_method == "poses":
        translation = origins.mean(0)
    elif center_method == "focus":
        translation = _focus_of_attention(poses)
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(f"unknown center method {center_method}")

    if method in ("up", "vertical"):
        up = poses[:, :3, 1].mean(0)
        rotation = _rotation_between(up / np.linalg.norm(up), np.array([0.0, 0.0, 1.0]))
    elif method == "pca":
        centered = origins - origins.mean(0)
        _, eigvec = np.linalg.eigh(centered.T @ centered)
        rotation = eigvec[:, [1, 2, 0]].T  # the smallest-variance direction becomes z
        if np.linalg.det(rotation) < 0:
            rotation[2] *= -1
    elif method == "none":
        rotation = np.eye(3)
    else:
        raise ValueError(f"unknown orientation method {method}")

    transform = np.concatenate([rotation, (rotation @ -translation)[:, None]], axis=1)
    transform_h = np.vstack([transform, [0.0, 0.0, 0.0, 1.0]])
    return np.einsum("ij,njk->nik", transform_h, poses), transform


def get_train_eval_split_filename(image_filenames: List[Path]):
    """Split by the parent directory's name containing "train" or "eval"."""
    i_train, i_eval = [], []
    for idx, fname in enumerate(image_filenames):
        base = os.path.basename(os.path.dirname(str(fname)))
        if "train" in base:
            i_train.append(idx)
        elif "eval" in base:
            i_eval.append(idx)
        else:
            raise ValueError("frame should contain train/eval in its parent dir to use the "
                             "filename eval mode")
    return np.array(i_train), np.array(i_eval)


def get_train_eval_split_fraction(image_filenames, train_split_fraction: float):
    """Evenly spaced train subset; the rest is the eval split."""
    num_images = len(image_filenames)
    num_train = int(np.ceil(num_images * train_split_fraction))
    i_train = np.linspace(0, num_images - 1, num_train, dtype=int)
    i_eval = np.setdiff1d(np.arange(num_images), i_train)[:num_images - num_train]
    return i_train, i_eval


def get_train_eval_split_interval(image_filenames, eval_interval: int):
    i_all = np.arange(len(image_filenames))
    i_eval = i_all[::eval_interval]
    return np.setdiff1d(i_all, i_eval), i_eval


def get_train_eval_split_all(image_filenames):
    i_all = np.arange(len(image_filenames))
    return i_all, i_all


def _frame_distortion(src) -> np.ndarray:
    """(6,) k1 k2 k3 k4 p1 p2 from "distortion_params" or the named keys."""
    if "distortion_params" in src:
        d = np.asarray(src["distortion_params"], dtype=np.float32)
        out = np.zeros(6, dtype=np.float32)
        out[:len(d)] = d
        return out
    return np.array([float(src.get(k, 0.0)) for k in ("k1", "k2", "k3", "k4", "p1", "p2")],
                    dtype=np.float32)


class UMHSDataParser:
    """Parses a nerfstudio-style transforms.json dataset directory."""

    SIDECARS = (("mask_path", "masks_"), ("seg_file_path", "segs_"),
                ("depth_file_path", "depths_"), ("hyperspectral_file_path", "hs_"),
                ("dino_file_path", "dino_"))

    def __init__(self, config: DataParserConfig):
        self.config = config
        self.downscale_factor: Optional[int] = None

    def _get_fname(self, filepath: Path, data_dir: Path, prefix="images_") -> Path:
        if self.downscale_factor is None:
            if self.config.downscale_factor is None:
                max_res = max(image_size(data_dir / filepath))
                df = 0
                while (max_res / 2**df) > MAX_AUTO_RESOLUTION and (
                        data_dir / f"{prefix}{2 ** (df + 1)}" / filepath.name).exists():
                    df += 1
                self.downscale_factor = 2**df
            else:
                self.downscale_factor = self.config.downscale_factor
        if self.downscale_factor > 1:
            return data_dir / f"{prefix}{self.downscale_factor}" / filepath.name
        return data_dir / filepath

    def parse(self, split: str = "train") -> DataparserOutputs:
        cfg = self.config
        if not Path(cfg.data).exists():
            raise FileNotFoundError(f"Data directory {cfg.data} does not exist.")
        data = Path(cfg.data)
        if data.suffix == ".json":
            meta_path, data_dir = data, data.parent
        else:
            meta_path, data_dir = data / "transforms.json", data
        with open(meta_path) as f:
            meta = json.load(f)

        intrinsic_keys = ("fl_x", "fl_y", "cx", "cy", "h", "w")
        fixed = {k: k in meta for k in intrinsic_keys}
        distort_fixed = any(k in meta for k in ("k1", "k2", "k3", "p1", "p2", "distortion_params"))

        fnames = [self._get_fname(Path(fr["file_path"]), data_dir) for fr in meta["frames"]]
        order = np.argsort([str(f) for f in fnames])
        frames = [meta["frames"][i] for i in order]

        image_filenames, poses, distort = [], [], []
        per_frame = {k: [] for k in intrinsic_keys}
        sidecars = {key: [] for key, _ in self.SIDECARS}
        for frame in frames:
            for key in intrinsic_keys:
                if not fixed[key]:
                    if key not in frame:
                        raise ValueError(f"{key} not specified in frame")
                    per_frame[key].append(float(frame[key]))
            if not distort_fixed:
                distort.append(_frame_distortion(frame))
            image_filenames.append(self._get_fname(Path(frame["file_path"]), data_dir))
            poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))
            for key, prefix in self.SIDECARS:
                if key in frame:
                    sidecars[key].append(self._get_fname(Path(frame[key]), data_dir, prefix))

        hs_filenames = sidecars["hyperspectral_file_path"]
        if hs_filenames and os.path.exists(cfg.vca_cache):
            os.remove(cfg.vca_cache)  # stale VCA cache
        for (key, _), name in zip(self.SIDECARS, ("mask", "seg", "depth", "hyperspectral", "dino")):
            if len(sidecars[key]) not in (0, len(image_filenames)):
                raise ValueError(f"Different number of image and {name} filenames: "
                                 f"{len(sidecars[key])} vs {len(image_filenames)}")

        if cfg.eval_mode == "fraction":
            i_train, i_eval = get_train_eval_split_fraction(image_filenames,
                                                            cfg.train_split_fraction)
        elif cfg.eval_mode == "filename":
            i_train, i_eval = get_train_eval_split_filename(image_filenames)
        elif cfg.eval_mode == "interval":
            i_train, i_eval = get_train_eval_split_interval(image_filenames, cfg.eval_interval)
        elif cfg.eval_mode == "all":
            i_train, i_eval = get_train_eval_split_all(image_filenames)
        else:
            raise ValueError(f"unknown eval mode {cfg.eval_mode}")
        if split == "train":
            indices = i_train
        elif split in ("val", "test", "eval"):
            indices = i_eval
        else:
            raise ValueError(f"unknown split {split}")

        poses = np.stack(poses)
        poses, transform_matrix = auto_orient_and_center_poses(
            poses, method=meta.get("orientation_override", cfg.orientation_method),
            center_method=cfg.center_method)
        scale_factor = 1.0
        if cfg.auto_scale_poses:
            scale_factor /= float(np.max(np.abs(poses[:, :3, 3])))
        scale_factor *= cfg.scale_factor
        poses[:, :3, 3] *= scale_factor

        def select(lst):
            return [lst[i] for i in indices] if lst else []

        image_filenames = select(image_filenames)
        sidecars = {k: select(v) for k, v in sidecars.items()}
        wavelengths = None
        if sidecars["hyperspectral_file_path"]:
            if "wavelengths" not in meta:
                raise ValueError("Wavelengths not specified in metadata")
            wavelengths = [float(x) for x in meta["wavelengths"]]
        poses = poses[indices]

        def intrinsic(key, dtype):
            if fixed[key]:
                return np.full(len(indices), float(meta[key])).astype(dtype)
            return np.asarray(per_frame[key], dtype=dtype)[indices]

        heights, widths = intrinsic("h", np.int32), intrinsic("w", np.int32)
        if distort_fixed:
            distortion = np.tile(_frame_distortion(meta)[None], (len(indices), 1))
        else:
            distortion = np.stack(distort)[indices]
        cameras = Cameras(
            camera_to_worlds=poses[:, :3, :4],
            fx=intrinsic("fl_x", np.float32), fy=intrinsic("fl_y", np.float32),
            cx=intrinsic("cx", np.float32), cy=intrinsic("cy", np.float32),
            height=heights, width=widths, distortion_params=distortion,
            camera_type=meta.get("camera_model", "PERSPECTIVE"),
        ).rescale_output_resolution(1.0 / self.downscale_factor)

        if "applied_transform" in meta:
            applied = np.asarray(meta["applied_transform"], dtype=np.float64)
            dataparser_transform = (np.vstack([transform_matrix, [0, 0, 0, 1]])
                                    @ np.vstack([applied, [0, 0, 0, 1]]))[:3]
        else:
            dataparser_transform = transform_matrix
        if "applied_scale" in meta:
            scale_factor *= float(meta["applied_scale"])

        extra_meta = {}
        if cfg.load_3D_points and "ply_file_path" in meta:
            pts = load_ply_points(data_dir / meta["ply_file_path"], dataparser_transform,
                                  scale_factor)
            if pts is not None:
                extra_meta.update(pts)

        return DataparserOutputs(
            image_filenames=image_filenames,
            cameras=cameras,
            scene_scale=cfg.scene_scale,
            dataparser_scale=scale_factor,
            dataparser_transform=dataparser_transform,
            mask_filenames=sidecars["mask_path"] or None,
            metadata={
                "depth_filenames": sidecars["depth_file_path"] or None,
                "depth_unit_scale_factor": cfg.depth_unit_scale_factor,
                "hs_filenames": sidecars["hyperspectral_file_path"] or None,
                "dino_filenames": sidecars["dino_file_path"] or None,
                "seg_filenames": sidecars["seg_file_path"] or None,
                "split": split,
                "num_classes": cfg.num_classes,
                "wavelengths": wavelengths,
                "height": heights,
                "width": widths,
                **extra_meta,
            },
        )


_PLY_TYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "short": "i2",
    "ushort": "u2", "int": "i4", "uint": "u4",
}


def load_ply_points(ply_path: Path, transform: np.ndarray, scale: float):
    """A sparse point cloud from a .ply file (ascii or binary), moved into
    dataparser coordinates and scaled: {"points3D_xyz" (N, 3) f32, and
    "points3D_rgb" (N, 3) uint8 when the file has colours}, or None when it
    has no points."""
    with open(ply_path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next((ln.split()[1] for ln in header if ln.startswith("format")), "ascii")
        n_vertex, props, in_vertex = 0, [], False
        for ln in header:
            if ln.startswith("element vertex"):
                n_vertex, in_vertex = int(ln.split()[-1]), True
            elif ln.startswith("element"):
                in_vertex = False
            elif ln.startswith("property") and in_vertex:
                parts = ln.split()
                props.append((parts[1], parts[2]))
        if n_vertex == 0:
            return None
        if fmt == "ascii":
            data = np.asarray([f.readline().split() for _ in range(n_vertex)], dtype=np.float64)
            names = [name for _, name in props]
        else:
            endian = "<" if "little" in fmt else ">"
            dtype = np.dtype([(name, endian + _PLY_TYPES[t]) for t, name in props])
            raw = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype)
            names = list(raw.dtype.names)
            data = np.stack([raw[n].astype(np.float64) for n in names], axis=-1)

    def col(name):
        return data[:, names.index(name)]

    xyz = np.stack([col("x"), col("y"), col("z")], axis=-1)
    xyz_h = np.concatenate([xyz, np.ones_like(xyz[:, :1])], axis=-1)
    out = {"points3D_xyz": ((xyz_h @ np.vstack([transform, [0, 0, 0, 1]]).T)[:, :3]
                            * scale).astype(np.float32)}
    if "red" in names:
        rgb = np.stack([col("red"), col("green"), col("blue")], axis=-1)
        if rgb.max() <= 1.0:
            rgb = rgb * 255.0
        out["points3D_rgb"] = rgb.astype(np.uint8)
    return out
