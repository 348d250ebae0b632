"""The port's quality twin at toy widths, for
tests/test_torch_seed_variance.py, which runs it in processes of its own:

    python tests/toy_quality_run.py [umhs_torch.scripts.quality_reference_scale's flags]

The model and the batch are cut as tests/test_torch_eval.py cuts them for the
twin itself (16^3 grid, hash L4 2^10, 32 samples per ray, 256 rays).
"""

import dataclasses
import sys

import torch

from umhs_torch.scripts import quality_reference_scale as quality

MODEL_KW = dict(
    grid_resolution=16, grid_levels=1, march_pool=0, hash_num_levels=4, log2_hashmap_size=10,
    max_res=64, num_candidates=128, max_samples_per_ray=32, cone_angle=0.0, load_vca=True,
    eval_num_rays_per_chunk=256, stage_boundaries=(8, 16),
)
FULL = quality.configs


def toy(args, root):
    trainer, model, datamanager = FULL(args, root)
    return (trainer, dataclasses.replace(model, **MODEL_KW),
            dataclasses.replace(datamanager, train_num_rays_per_batch=256,
                                eval_num_rays_per_batch=256))


if __name__ == "__main__":
    torch.set_num_threads(1)
    quality.configs = toy
    quality.main(sys.argv[1:])
