"""The eval loop's side modules of umhs_torch against umhs_tpu on the CPU:
LPIPS and the turbo colormaps, the eval images' switch, and the quality twin
of scripts/quality_reference_scale.py at a toy size (the eval images and the
segmentation dump are held to umhs_tpu's Trainer in
test_torch_trainer_loop.py).

Inputs come from numpy seeds. LPIPS is held to the JAX package's (which runs
the same seeded VGG16 trunk in torch) within rtol 1e-5, the colormaps to the
JAX package's (matplotlib's turbo here) within atol 1e-7.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from umhs_tpu.utils import colormaps as j_colormaps
from umhs_tpu.utils import metrics as j_metrics
from umhs_torch.data.datamanager import DataManagerConfig
from umhs_torch.data.dataparser import DataParserConfig
from umhs_torch.data.synthetic import SyntheticSceneConfig, write_dataset
from umhs_torch.engine.trainer import Trainer, TrainerConfig
from umhs_torch.models.model import ModelConfig
from umhs_torch.scripts import quality_reference_scale as quality
from umhs_torch.utils import colormaps as t_colormaps
from umhs_torch.utils import metrics as t_metrics

ROOT = Path(__file__).resolve().parent.parent
SCENE = SyntheticSceneConfig(num_views_train=4, num_views_eval=2, image_size=32, num_bands=8,
                             num_spheres=2)
MODEL_KW = dict(
    method="rgb+spectral", grid_resolution=16, grid_levels=1, march_pool=0,
    hash_num_levels=4, log2_hashmap_size=10, max_res=64, num_candidates=128,
    max_samples_per_ray=32, cone_angle=0.0, pred_specular=False, load_vca=True,
    eval_num_rays_per_chunk=256, stage_boundaries=(8, 16),
)
QUIET = dict(steps_per_save=10**7, steps_per_eval_batch=10**7, steps_per_eval_image=10**7,
             steps_per_log=10**7, save_final=False, mixed_precision=False,
             dynamic_batching=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops beside the suite's other workers: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fresh_lpips():
    """Both packages build their trunks anew inside the test, and are reset
    after it."""
    saved = (dict(t_metrics._LPIPS_TRUNKS), t_metrics.LPIPS_VARIANT,
             dict(j_metrics._LPIPS_CACHE), j_metrics.LPIPS_VARIANT)
    t_metrics._LPIPS_TRUNKS.clear()
    j_metrics._LPIPS_CACHE.clear()
    yield
    t_metrics._LPIPS_TRUNKS.clear()
    t_metrics._LPIPS_TRUNKS.update(saved[0])
    t_metrics.LPIPS_VARIANT = saved[1]
    j_metrics._LPIPS_CACHE.clear()
    j_metrics._LPIPS_CACHE.update(saved[2])
    j_metrics.LPIPS_VARIANT = saved[3]


def _image_pair(size, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    return a, b


# ------------------------------------------------------------------ LPIPS
@pytest.mark.parametrize("size", [32, 64])
def test_lpips_matches_jax(fresh_lpips, size):
    """The seeded random trunk (no weight archive here): the same distance
    within rtol 1e-5, the same variant, and the global torch generator
    where it was."""
    a, b = _image_pair(size, size)
    rng_state = torch.random.get_rng_state()
    got = t_metrics.lpips(a, b)
    assert torch.equal(torch.random.get_rng_state(), rng_state)
    want = j_metrics.lpips(a, b)
    assert want is not None and got > 0
    assert got == pytest.approx(want, rel=1e-5)
    assert t_metrics.LPIPS_VARIANT == j_metrics.LPIPS_VARIANT == "vgg16_random"
    assert t_metrics.lpips(a, a) < 1e-8


def test_lpips_weight_archive_matches_jax(fresh_lpips, tmp_path, monkeypatch):
    """A weight archive in scripts/convert_vgg16_weights.py's layout (stand-in
    weights of the right shapes) is read by both, under "vgg16_imagenet"."""
    rng = np.random.default_rng(7)
    arrs, c_in, i = {}, 3, 0
    for spec in t_metrics._VGG16_CFG:
        if spec == "M":
            continue
        arrs[f"conv{i}_w"] = (rng.standard_normal((spec, c_in, 3, 3)) * 0.05).astype(np.float32)
        arrs[f"conv{i}_b"] = (rng.standard_normal(spec) * 0.01).astype(np.float32)
        c_in, i = spec, i + 1
    np.savez(tmp_path / "vgg16_imagenet.npz", **arrs)
    monkeypatch.setenv("UMHS_VGG16_WEIGHTS", str(tmp_path / "vgg16_imagenet.npz"))
    assert t_metrics._vgg16_weight_file() == tmp_path / "vgg16_imagenet.npz"
    a, b = _image_pair(32, 1)
    got, want = t_metrics.lpips(a, b), j_metrics.lpips(a, b)
    assert got == pytest.approx(want, rel=1e-5)
    assert t_metrics.LPIPS_VARIANT == j_metrics.LPIPS_VARIANT == "vgg16_imagenet"


def test_lpips_raises_where_the_trunk_cannot_run(fresh_lpips):
    """Below 16 x 16 the fourth max-pool has nothing to pool: the port raises
    (the JAX package returns None)."""
    a, b = _image_pair(8, 2)
    assert j_metrics.lpips(a, b) is None
    with pytest.raises(RuntimeError):
        t_metrics.lpips(a, b)


# -------------------------------------------------------------- colormaps
def test_colormap_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.2, 1.2, size=(40, 30)).astype(np.float32)
    x[0, :4] = [0.0, 1.0, np.nan, 255.5 / 256]
    ramp = np.linspace(0.0, 1.0, 4097, dtype=np.float32)[None]  # every entry and its edges
    for v in (x, x[..., None], ramp):
        got = t_colormaps.apply_colormap(v)
        want = j_colormaps.apply_colormap(v)
        assert got.shape == want.shape == v.shape[:2] + (3,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("acc,near,far", [(True, None, None), (False, None, None),
                                          (True, 1.5, 2.5)])
def test_depth_colormap_matches_jax(acc, near, far):
    rng = np.random.default_rng(1)
    depth = rng.uniform(1.0, 3.0, size=(24, 20, 1))
    accumulation = rng.uniform(0.0, 1.0, size=(24, 20, 1)) if acc else None
    got = t_colormaps.apply_depth_colormap(depth, accumulation, near, far)
    want = j_colormaps.apply_depth_colormap(depth, accumulation, near, far)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


# ------------------------------------------------------------ eval images
@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("scene32"), SCENE)


def test_eval_images_can_be_turned_off(scene_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    dm = DataManagerConfig(dataparser=DataParserConfig(data=scene_dir, num_classes=2),
                           train_num_rays_per_batch=256, eval_num_rays_per_batch=128)
    t = Trainer(TrainerConfig(**{**QUIET, "output_dir": tmp_path / "t",
                                 "save_eval_images": False}),
                ModelConfig(**MODEL_KW), dm, num_classes=2, device="cpu").setup()
    m = t.eval_image(0)
    assert np.isfinite(m["lpips_vgg16random"])
    assert not (t.run_dir / "eval_images").exists()


# ------------------------------------------------------ the quality twin
def test_quality_twin_at_a_toy_size(tmp_path, monkeypatch):
    """The twin at 32^2, 4 bands and 16 steps on the CPU, with the model and
    batch cut to toy widths, writes the JSON keys of
    docs/tetra_2000_256.json, and leaves its working directory behind it."""
    full = quality.configs

    def toy(args, root):
        trainer, model, datamanager = full(args, root)
        model = dataclasses.replace(model, **{k: v for k, v in MODEL_KW.items()
                                              if k not in ("method", "pred_specular")})
        return trainer, model, dataclasses.replace(datamanager, train_num_rays_per_batch=256,
                                                   eval_num_rays_per_batch=256)

    monkeypatch.setattr(quality, "configs", toy)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "q" / "result.json"
    quality.main(["--steps", "16", "--image-size", "32", "--bands", "4", "--views", "4",
                  "--device", "cpu", "--out", str(out)])
    got = json.loads(out.read_text())
    want = json.loads((ROOT / "docs" / "tetra_2000_256.json").read_text())
    assert set(got) == set(want)
    assert set(got["config"]) == set(want["config"])
    assert set(got["eval_all_images"]) == set(want["eval_all_images"])
    assert got["config"]["steps"] == 16 and got["config"]["bands"] == 4
    assert got["lpips_variant"] == "vgg16_random"
    assert all(np.isfinite(v) for v in got["eval_all_images"].values())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["q"]


def test_quality_twin_flags_match_the_jax_script():
    args = quality.parse_args([])
    assert (args.steps, args.image_size, args.views, args.seed, args.bands) == (
        30000, 512, 30, 42, 21)
    assert (args.wl_start, args.wl_step, args.hs_dtype, args.device) == (450.0, 10.0, None, "cuda")
    assert args.out == Path("outputs") / "quality_reference_scale.json"
    bay = quality.parse_args(["--bands", "141"])
    assert (bay.wl_start, bay.wl_step, bay.hs_dtype) == (400.0, 600.0 / 140, "bfloat16")
