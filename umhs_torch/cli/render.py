"""`umhs-torch-render`: the ns-render camera-path equivalent (port of
umhs_tpu/cli/render.py).

Renders a saved camera path, selecting named outputs: "rgb", per-band
"wv_i", abundance maps "abundances_i", specular residual bands "residual_i",
"seg_pred", "depth", "accumulation" (the reference's output names,
umhs_model.py:273-313).

The camera-path json is nerfstudio's: {"camera_path": [{"camera_to_world":
[16 floats], "fov": deg, "aspect": a}, ...], "render_height": H,
"render_width": W, "fps": n, "seconds": s}.

Each frame tiles the requested outputs side by side (ns-render's layout).
Frames are written as a video through imageio where it imports and can
write the output path, else as a PNG sequence (data/png.py) in a directory
named after the output path without its suffix; the CLI prints which.

Usage:
    python -m umhs_torch.cli.render camera-path \\
        --load-config outputs/exp/umhsnerf/config.yml \\
        --camera-path-filename path.json --output-path renders/out.mp4 \\
        --rendered-output-names rgb abundances_0 abundances_1 [--device cpu]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from . import load_trained, parse_options, split_device


def _colormap(x: np.ndarray) -> np.ndarray:
    """The render tool's turbo-ish colormap for scalar maps (depth,
    abundances, bands); utils/colormaps.py is the trainer's."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return np.stack([r, g, b], axis=-1)


def select_output(outputs: Dict[str, np.ndarray], name: str) -> np.ndarray:
    """Map an ns-render output name to an (H, W, 3) image of numpy outputs."""
    if name == "rgb":
        return np.clip(outputs["rgb"], 0, 1)
    if name in ("seg_pred", "specular"):
        return np.clip(outputs[name][..., :3], 0, 1)
    if name in ("accumulation",):
        return _colormap(outputs["accumulation"][..., 0])
    if name == "depth":
        d = outputs["depth"][..., 0]
        rng = np.ptp(d)
        return _colormap((d - d.min()) / (rng + 1e-9))
    if name.startswith("wv_"):
        i = int(name.split("_")[1])
        return np.repeat(np.clip(outputs["spectral"][..., i : i + 1], 0, 1), 3, axis=-1)
    if name.startswith("abundances_"):
        i = int(name.split("_")[1])
        a = outputs["abundances"][..., i]
        return _colormap(a / (a.max() + 1e-9))
    if name.startswith("residual_"):
        i = int(name.split("_")[1])
        return np.repeat(np.clip(outputs["specular"][..., i : i + 1], 0, 1), 3, axis=-1)
    raise KeyError(f"unknown rendered output name {name}")


def cameras_from_path_json(path_json: Dict, fallback_hw=(256, 256)):
    """Per-frame extrinsics and focal length from a camera-path json."""
    h = int(path_json.get("render_height", fallback_hw[0]))
    w = int(path_json.get("render_width", fallback_hw[1]))
    frames = []
    for cam in path_json["camera_path"]:
        c2w = np.asarray(cam["camera_to_world"], dtype=np.float32).reshape(4, 4)
        fov = float(cam.get("fov", 50.0))
        focal = 0.5 * h / np.tan(0.5 * np.deg2rad(fov))
        frames.append({"c2w": c2w[:3], "focal": focal})
    return frames, h, w


def camera_dict(c2w: np.ndarray, focal: float, h: int, w: int, device) -> Dict[str, torch.Tensor]:
    """One pinhole camera (principal point at the centre) as the device dict
    generate_camera_rays takes."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {"c2w": f32(c2w)[None], "fx": f32([focal]), "fy": f32([focal]),
            "cx": f32([w / 2.0]), "cy": f32([h / 2.0])}


def render_outputs(trainer, cam: Dict[str, torch.Tensor], h: int, w: int) -> Dict[str, np.ndarray]:
    """Trainer.render_camera of camera 0 of `cam`, as float32 numpy arrays."""
    from ..data.cameras import generate_camera_rays

    outputs = trainer.render_camera(generate_camera_rays(cam, 0, h, w), (h, w))
    return {k: v.float().cpu().numpy() for k, v in outputs.items()}


def write_frames(images: List[np.ndarray], out_path: Path, fps: int) -> Path:
    """A video at out_path through imageio, or, where imageio does not import
    or cannot write it, PNG frames in out_path without its suffix. Returns
    what was written."""
    from ..data.png import write_png

    out_path.parent.mkdir(parents=True, exist_ok=True)
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        reason = f"imageio does not import: {e}"
    else:
        try:
            imageio.mimwrite(out_path, images, fps=fps)
            print(f"[umhs-render] wrote the video {out_path}")
            return out_path
        except Exception as e:  # no codec for this path: the frames go to PNGs
            reason = f"imageio cannot write {out_path.name}: {e}"
    frame_dir = out_path.with_suffix("")
    frame_dir.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(images):
        write_png(frame_dir / f"frame_{i:05d}.png", img)
    print(f"[umhs-render] wrote {len(images)} PNG frames to {frame_dir} ({reason})")
    return frame_dir


class RenderResult(NamedTuple):
    images: List[np.ndarray]  # (H, W * outputs, 3) uint8 frames
    frame_s: List[float]  # seconds per frame: render, readback and tiling
    written: Path  # the video, or the directory of PNG frames


def main(argv=None, device="cuda") -> RenderResult:
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, dev = split_device(argv, device)
    if not argv or argv[0] != "camera-path":
        raise ValueError("[umhs-render] only the camera-path mode is supported")
    argv = argv[1:]
    names: List[str] = ["rgb"]
    rest, i = [], 0
    while i < len(argv):
        if argv[i].lstrip("-").replace("-", "_") == "rendered_output_names":
            names, i = [], i + 1
            while i < len(argv) and not argv[i].startswith("--"):
                names.append(argv[i].strip('"'))
                i += 1
        else:
            rest += argv[i:i + 2]
            i += 2
    opts = parse_options(rest, "umhs-render")
    _, trainer = load_trained(Path(opts["load_config"]), dev)

    with open(opts["camera_path_filename"]) as f:
        path_json = json.load(f)
    frames, h, w = cameras_from_path_json(path_json)
    images: List[np.ndarray] = []
    frame_s: List[float] = []
    for fi, fr in enumerate(frames):
        t0 = time.perf_counter()
        outputs = render_outputs(trainer, camera_dict(fr["c2w"], fr["focal"], h, w, dev), h, w)
        tiles = [select_output(outputs, n) for n in names]
        images.append((np.concatenate(tiles, axis=1) * 255).astype(np.uint8))
        frame_s.append(time.perf_counter() - t0)
        print(f"[umhs-render] frame {fi + 1}/{len(frames)} ({1e3 * frame_s[-1]:.1f} ms)")
    written = write_frames(images, Path(opts["output_path"]), int(path_json.get("fps", 24)))
    return RenderResult(images, frame_s, written)


def script() -> None:
    """The console script: main() with its result left out of the exit code."""
    main()


if __name__ == "__main__":
    main()
