"""Training views against eval views after the toy proposal run, in the JAX
package and in the port, on the CPU.

    python tests/toy_proposal_view_gap.py [--steps 250] [--rays 256]

Both train tests/test_proposal_model.py::test_proposal_training_improves's
configuration (8 + 2 views of 32^2, rgb, proposals (64, 32) -> 16, lr 1e-2)
on the same scene from seed 42, then render every training view and every
eval view through their render_camera and read PSNR over black, as
eval_image does. A gap between the two that both packages share is the
novel views'; one the port alone shows would be a fault of its eval
forward. Prints one JSON object per package. Not a test: it takes about
1.5 minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def model_and_data(pkg: str, root: Path, rays: int, steps: int, out: Path):
    """The test's TrainerConfig, ModelConfig and DataManagerConfig in `pkg`
    (umhs_tpu or umhs_torch)."""
    mods = {name: __import__(f"{pkg}.{name}", fromlist=["_"])
            for name in ("data.datamanager", "data.dataparser", "engine.trainer",
                         "models.model")}
    tr = mods["engine.trainer"]
    extra = ({"use_mesh": False} if pkg == "umhs_tpu"
             else {"steps_per_eval_image": 10**9, "save_final": False})
    trainer_cfg = tr.TrainerConfig(
        max_num_iterations=steps, steps_per_save=10**9, steps_per_eval_batch=10**9,
        steps_per_log=10**9, output_dir=out, experiment_name="prop", mixed_precision=False,
        optimizer=tr.OptimizerConfig(lr=1e-2, max_steps=steps), **extra)
    model_cfg = mods["models.model"].ModelConfig(
        method="rgb", sampler="proposal", num_proposal_samples=(64, 32), num_nerf_samples=16,
        log2_hashmap_size=13, max_res=64, far_plane=20.0, eval_num_rays_per_chunk=512)
    dm_cfg = mods["data.datamanager"].DataManagerConfig(
        dataparser=mods["data.dataparser"].DataParserConfig(data=root, num_classes=2),
        train_num_rays_per_batch=rays, eval_num_rays_per_batch=128)
    return tr.Trainer, trainer_cfg, model_cfg, dm_cfg


def run_jax(root: Path, rays: int, steps: int, out: Path):
    from umhs_tpu.data.cameras import generate_camera_rays
    from umhs_tpu.utils.metrics import psnr

    Trainer, *cfgs = model_and_data("umhs_tpu", root, rays, steps, out)
    t = Trainer(*cfgs, num_classes=2).setup()
    t.train()
    dm = t.datamanager
    cam = dm.train_outputs.cameras.to_device_dict()
    images = dm.train_dataset.arrays()["image"]
    h, w = images.shape[1:3]
    train_views = [psnr(t.render_camera(generate_camera_rays(cam, i, h, w), (h, w))["rgb"],
                        np.asarray(t.model.blend_background(images[i])))
                   for i in range(images.shape[0])]
    return t.eval_all_images()["psnr"], train_views


def run_torch(root: Path, rays: int, steps: int, out: Path):
    from umhs_torch.data.cameras import generate_camera_rays
    from umhs_torch.utils.metrics import psnr

    Trainer, *cfgs = model_and_data("umhs_torch", root, rays, steps, out)
    t = Trainer(*cfgs, num_classes=2, device="cpu").setup()
    t.train()
    dm = t.datamanager
    n, h, w = dm.data["image"].shape[:3]
    train_views = [
        psnr(t.render_camera(generate_camera_rays(dm.cam, i, h, w, camera_type=dm.camera_type),
                             (h, w))["rgb"].numpy(),
             t.model.blend_background(dm.data["image"][i]).numpy())
        for i in range(n)]
    return t.eval_all_images()["psnr"], train_views


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--rays", type=int, default=256)
    args = ap.parse_args(argv)
    from umhs_tpu.data.synthetic import SyntheticSceneConfig, write_dataset

    results = []
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)  # parsing writes vca.npy into the working directory
        root = Path(d) / "scene"
        write_dataset(root, SyntheticSceneConfig(num_views_train=8, num_views_eval=2,
                                                 image_size=32, num_bands=6, num_spheres=1))
        for pkg, run in (("umhs_tpu", run_jax), ("umhs_torch", run_torch)):
            t0 = time.perf_counter()
            eval_psnr, train_views = run(root, args.rays, args.steps, Path(d) / pkg)
            results.append({"package": pkg, "steps": args.steps, "rays": args.rays,
                            "eval_views_psnr": eval_psnr,
                            "train_views_psnr": float(np.mean(train_views)),
                            "gap_db": float(np.mean(train_views)) - eval_psnr,
                            "seconds": time.perf_counter() - t0})
            print(json.dumps(results[-1]))
    return results


if __name__ == "__main__":
    main()
