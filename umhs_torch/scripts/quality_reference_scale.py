"""Reference-scale quality run of the port (the twin of
scripts/quality_reference_scale.py).

    python -m umhs_torch.scripts.quality_reference_scale [--steps N] [--out PATH]
        [--interp tetrahedral|trilinear] [--image-size S] [--bands B] [--device cuda|cpu] ...

Trains the reference's flagship envelope (Adam 2e-2, eps 1e-15, exponential
decay to 1e-5; 4096 rays per step; occupancy grid 128^3 x 4, cone 0.004;
hash L16xF2 2^19; rgb+spectral with the specular residual, VCA endmembers,
temperature 0.4; bf16 compute) on the synthetic scene (`--views` train and 4
eval views, 5 spheres), then evaluates every eval view (PSNR, SSIM, LPIPS,
spectral PSNR, SSIM, SAM, RMSE) and writes the JAX script's JSON keys to
`--out` (outputs/quality_reference_scale.json under the working directory by
default). The scene and the run live in a temporary directory, removed at
the end: parsing the dataset writes vca.npy into the working directory.
Runs on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--out", type=Path, default=Path("outputs") / "quality_reference_scale.json")
    ap.add_argument("--interp", default="tetrahedral", choices=["tetrahedral", "trilinear"])
    ap.add_argument("--image-size", type=int, default=512)
    ap.add_argument("--views", type=int, default=30)
    ap.add_argument("--seed", type=int, default=42,
                    help="trainer seed (initialisation and sampling); the scene does not "
                         "depend on it")
    ap.add_argument("--bands", type=int, default=21,
                    help="spectral bands: 21 is the NeSpoF envelope, 141 the Bayspec one")
    ap.add_argument("--wl-start", type=float, default=None)
    ap.add_argument("--wl-step", type=float, default=None)
    ap.add_argument("--hs-dtype", default=None, choices=[None, "float32", "bfloat16"],
                    help="staging dtype of the spectral cubes (bfloat16 by default above "
                         "64 bands)")
    ap.add_argument("--hash-levels", type=int, default=16)
    ap.add_argument("--hash-features", type=int, default=2)
    ap.add_argument("--log2-hashmap", type=int, default=19)
    ap.add_argument("--target-samples", type=int, default=24576,
                    help="dynamic batching's sample target; the default keeps the batch "
                         "near 4096 rays")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.wl_start is None:  # the Bayspec envelope: 400-1000 nm
        args.wl_start = 450.0 if args.bands == 21 else 400.0
    if args.wl_step is None:
        args.wl_step = 10.0 if args.bands == 21 else 600.0 / max(args.bands - 1, 1)
    if args.hs_dtype is None and args.bands > 64:
        args.hs_dtype = "bfloat16"
    return args


def configs(args: argparse.Namespace, root: Path):
    """The run's TrainerConfig, ModelConfig and DataManagerConfig (those of
    scripts/quality_reference_scale.py:95-148; no mesh) for the dataset at
    `root`."""
    from ..data.datamanager import DataManagerConfig
    from ..data.dataparser import DataParserConfig
    from ..engine.trainer import OptimizerConfig, TrainerConfig
    from ..models.model import ModelConfig

    trainer = TrainerConfig(
        max_num_iterations=args.steps, steps_per_save=10**9, steps_per_eval_batch=5000,
        steps_per_eval_image=10**9, steps_per_log=1000, mixed_precision=True,
        experiment_name="quality-ref-scale", target_num_samples=args.target_samples,
        seed=args.seed,
        optimizer=OptimizerConfig(lr=2e-2, eps=1e-15, lr_final=1e-5, max_steps=args.steps))
    model = ModelConfig(
        method="rgb+spectral", pred_specular=True, load_vca=True, temperature=0.4,
        grid_resolution=128, grid_levels=4, cone_angle=0.004,
        hash_num_levels=args.hash_levels, hash_features_per_level=args.hash_features,
        log2_hashmap_size=args.log2_hashmap, num_candidates=1024, max_samples_per_ray=64,
        hash_interpolation=args.interp)
    datamanager = DataManagerConfig(
        dataparser=DataParserConfig(data=root, num_classes=6),
        train_num_rays_per_batch=4096, eval_num_rays_per_batch=4096,
        **({"hs_dtype": args.hs_dtype} if args.hs_dtype else {}))
    return trainer, model, datamanager


def run(args: argparse.Namespace, inspect: Optional[Callable] = None) -> Dict[str, object]:
    """Train and evaluate in a temporary working directory; returns the
    result that main() writes. `inspect(trainer)` runs before the directory
    is removed."""
    from ..data.synthetic import SyntheticSceneConfig, write_dataset
    from ..engine.trainer import Trainer
    from ..utils import metrics as metrics_utils

    cwd = os.getcwd()
    workdir = tempfile.mkdtemp(prefix="umhs_quality_")
    os.chdir(workdir)
    try:
        scene = SyntheticSceneConfig(
            num_views_train=args.views, num_views_eval=4, image_size=args.image_size,
            num_bands=args.bands, wavelength_start=args.wl_start,
            wavelength_step=args.wl_step, num_spheres=5)
        root = write_dataset("scene", scene)
        t0 = time.time()
        trainer = Trainer(*configs(args, root), num_classes=6, device=args.device).setup()
        setup_s = time.time() - t0
        print(f"# setup {setup_s:.1f}s", file=sys.stderr)
        t1 = time.time()
        last = trainer.train()
        train_s = time.time() - t1
        final = trainer.eval_all_images()
        if inspect is not None:
            inspect(trainer)
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)
    return {
        "config": {
            "steps": args.steps,
            "image_size": args.image_size,
            "bands": args.bands,
            "hs_dtype": args.hs_dtype or "float32",
            "num_classes": 6,
            "hash": (f"L{args.hash_levels}xF{args.hash_features} "
                     f"2^{args.log2_hashmap} ({args.interp})"),
            "grid": "128^3 x 4, cone 0.004",
            "batch_rays": 4096,
            "target_samples": args.target_samples,
            "lr": "2e-2 -> 1e-5 exp",
            "seed": args.seed,
        },
        "train_wall_clock_s": round(train_s, 1),
        "setup_s": round(setup_s, 1),
        "train_rays_per_sec": round(last.get("rays_per_sec", 0.0), 1),
        "lpips_variant": metrics_utils.LPIPS_VARIANT,
        "eval_all_images": {k: round(float(v), 5) for k, v in final.items()},
        "last_train_metrics": {k: round(float(v), 6) for k, v in last.items()},
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    out = args.out.resolve()
    result = run(args)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2))
    print(json.dumps(result["eval_all_images"]))
    print(f"# wall clock {result['train_wall_clock_s'] / 60:.1f} min; wrote {out}",
          file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
