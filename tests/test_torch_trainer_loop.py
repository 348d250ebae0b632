"""The trainer's loop in umhs_torch against umhs_tpu on the CPU: dynamic
batching (compute_adapt held to Trainer._compute_adapt, decisions and their
deferred application, the periodic re-adapt), gradient accumulation against
optax.MultiSteps, checkpoints and resume, train() to an absolute step, the
metrics and the eval loops.

Runs use a tiny scene written to disk by the port's write_dataset (4 + 2
views, 16^2, 8 bands) and a tiny rgb+spectral model (16^3 grid, hash L4
2^10, 32 samples per ray, stages at 8 and 16), each in its own working
directory because parsing a dataset writes vca.npy there.
"""

import dataclasses
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from umhs_tpu.engine import trainer as j_trainer
from umhs_tpu.engine.trainer import Trainer as JTrainer
from umhs_tpu.models.model import ModelConfig as JModelConfig
from umhs_tpu.models.model import UMHSModel as JModel
from umhs_tpu.utils import metrics as j_metrics
from umhs_torch.data.datamanager import DataManagerConfig, InMemoryDataManager
from umhs_torch.data.dataparser import DataParserConfig
from umhs_torch.data.synthetic import (
    SyntheticSceneConfig, render_views, scene_cameras, write_dataset)
from umhs_torch.engine import trainer as t_trainer
from umhs_torch.engine.trainer import (
    DynamicShapes, MultiStepAdam, OptimizerConfig, Trainer, TrainerConfig)
from umhs_torch.models.model import ModelConfig
from umhs_torch.utils import metrics as t_metrics

SCENE = SyntheticSceneConfig(num_views_train=4, num_views_eval=2, image_size=16, num_bands=8,
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


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("scene"), SCENE)


@pytest.fixture(scope="module")
def scene32_dir(tmp_path_factory):
    """The same scene at 32^2: the JAX package's LPIPS needs 32 x 32 (its
    trunk ends in a fifth max-pool), so eval_image parity runs here."""
    return write_dataset(tmp_path_factory.mktemp("scene32"),
                         dataclasses.replace(SCENE, image_size=32))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These runs are thousands of small ops: beside the suite's other
    workers, torch's intra-op threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(scene_dir, tmp_path, rays=256, model_kw=None, **trainer_kw):
    cfg = TrainerConfig(**{**QUIET, "output_dir": tmp_path / "outputs", "seed": 3,
                           "optimizer": OptimizerConfig(lr=1e-2, max_steps=1000),
                           **trainer_kw})
    dm_cfg = DataManagerConfig(dataparser=DataParserConfig(data=scene_dir, num_classes=2),
                               train_num_rays_per_batch=rays, eval_num_rays_per_batch=128)
    return Trainer(cfg, ModelConfig(**{**MODEL_KW, **(model_kw or {})}), dm_cfg, num_classes=2,
                   device="cpu")


# --------------------------------------------------------- compute_adapt
ADAPT_CASES = {
    # rays, S, budgets before; stage boundaries, patch, target; measurements
    "unstaged": dict(rays=4096, s=64, budgets=[4096 * 64], bounds=(), patch=1,
                     target=1 << 18, spb=4096 * 20.0, p99=0.0, stages=[4096 * 20.0, 0.0]),
    "first-staged-bootstrap": dict(rays=4096, s=64, budgets=[4096 * 64], bounds=(8, 16),
                                   patch=1, target=1 << 18, spb=4096 * 30.0, p99=44.0,
                                   stages=[4096 * 24.0, 0.0]),
    "measured": dict(rays=8192, s=48, budgets=[60416, 24576, 12288], bounds=(8, 16), patch=1,
                     target=1 << 18, spb=8192 * 14.0, p99=36.0,
                     stages=[40000.0, 12000.0, 5000.0]),
    "ceiling-escalation": dict(rays=8192, s=48, budgets=[60416, 24576, 12288], bounds=(8, 16),
                               patch=1, target=1 << 18, spb=8192 * 14.0, p99=36.0,
                               stages=[40000.0, 23000.0, 12000.0]),
    "rays-cap-2^17": dict(rays=4096, s=64, budgets=[65536, 16384, 8192], bounds=(8, 16),
                          patch=1, target=1 << 22, spb=4096 * 6.0, p99=20.0,
                          stages=[4096 * 2.0, 4096 * 1.0, 4096 * 0.5]),
    "patch-3": dict(rays=4608, s=64, budgets=[4608 * 64], bounds=(8, 16), patch=3,
                    target=1 << 18, spb=4608 * 18.0, p99=40.0, stages=[4608 * 12.0, 0.0]),
    "no-op": dict(rays=4096, s=64, budgets=[4096 * 64], bounds=(), patch=1, target=1 << 18,
                  spb=4096 * 16.0, p99=40.0, stages=None),
}


def _adapt_pair(case, rays, s, budgets):
    """The port's Trainer and a stand-in `self` for the JAX method, at the
    same shapes."""
    kw = dict(max_samples_per_ray=64, stage_boundaries=case["bounds"], stage_samples=0,
              march_pool=0, grid_levels=1, grid_resolution=16, hash_num_levels=2,
              log2_hashmap_size=8)
    img = np.zeros((1, 6, 6, 4), np.float32)
    poses, _, _ = render_views(SyntheticSceneConfig(image_size=6, num_bands=4), 1, 0.0)
    dm = InMemoryDataManager(
        img, scene_cameras(SyntheticSceneConfig(image_size=6, num_bands=4), poses),
        config=DataManagerConfig(train_num_rays_per_batch=rays, patch_size=case["patch"]),
        wavelengths=[500.0, 550.0, 600.0, 650.0], device="cpu")
    t = Trainer(TrainerConfig(target_num_samples=case["target"]), ModelConfig(**kw),
                num_classes=2, device="cpu", datamanager=dm)
    t.dyn = DynamicShapes(rays, dataclasses.replace(t.model.march_config, num_samples=s),
                          tuple(budgets))
    jm = JModel(JModelConfig(**kw), [500.0, 550.0, 600.0, 650.0], num_classes=2, num_images=1)
    stand_in = SimpleNamespace(
        config=SimpleNamespace(target_num_samples=case["target"]), model=jm,
        datamanager=SimpleNamespace(config=SimpleNamespace(patch_size=case["patch"])),
        _dyn_rays=rays, _dyn_march=dataclasses.replace(jm.march_config, num_samples=s),
        _dyn_budgets=list(budgets))
    return t, stand_in


def _adapt_both(case, rays, s, budgets, spb):
    t, stand_in = _adapt_pair(case, rays, s, budgets)
    got = t.compute_adapt(spb, p99=case["p99"], eval_stages=case["stages"])
    want = JTrainer._compute_adapt(stand_in, spb, p99=case["p99"], eval_stages=case["stages"])
    return got, want


@pytest.mark.parametrize("name", list(ADAPT_CASES))
def test_compute_adapt_matches_jax(name):
    case = ADAPT_CASES[name]
    got, want = _adapt_both(case, case["rays"], case["s"], case["budgets"], case["spb"])
    if name == "no-op":  # at the shapes it decided, the same per-ray demand changes nothing
        assert got is not None
        mean = case["spb"] / case["rays"]
        got, want = _adapt_both(case, got["rays"], got["march"].num_samples, got["budgets"],
                                mean * got["rays"])
        assert got is None and want is None
        return
    assert want is not None and got is not None
    assert got["rays"] == want["rays"]
    assert got["march"].num_samples == want["march"].num_samples
    assert list(got["budgets"]) == list(want["budgets"])
    for k in ("mean_eval", "mean_spr", "p99"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    if name == "rays-cap-2^17":
        assert got["rays"] == 1 << 17
    if name == "patch-3":
        assert got["rays"] % 2304 == 0
    if name == "ceiling-escalation":  # the tails doubled (R-rescaled), within their lane caps
        scale = got["rays"] / case["rays"]
        assert got["budgets"][1] == min(int(2 * 24576 * scale), got["rays"] * 8) // 256 * 256
    bounds = (8, 16) if case["bounds"] else ()
    assert len(got["budgets"]) == (len(bounds) + 1 if bounds and case["stages"] else 1)
    assert all(b % 256 == 0 and b >= 4096 for b in got["budgets"])


# ------------------------------------------------------------ the configs
def test_ray_batch_fields_live_on_the_datamanager_config():
    from umhs_tpu.data.datamanager import DataManagerConfig as JDataManagerConfig
    from umhs_tpu.engine.trainer import TrainerConfig as JTrainerConfig

    fields = ("train_num_rays_per_batch", "eval_num_rays_per_batch", "patch_size", "hs_dtype")
    t_dm = {f.name: f.default for f in dataclasses.fields(DataManagerConfig)}
    j_dm = {f.name: f.default for f in dataclasses.fields(JDataManagerConfig)}
    for name in fields:
        assert t_dm[name] == j_dm[name], name
    t_tr = {f.name for f in dataclasses.fields(TrainerConfig)}
    assert not t_tr & set(fields)
    j_tr = {f.name: f.default for f in dataclasses.fields(JTrainerConfig)}
    for name in t_tr - {"optimizer", "output_dir"}:  # the ported fields keep JAX's defaults
        assert TrainerConfig.__dataclass_fields__[name].default == j_tr[name], name


# ------------------------------------------------------------------ loop
def test_train_runs_to_an_absolute_step(scene_dir, tmp_path, monkeypatch):
    """train(n) stops when the step counter reaches n, in chunks that end on
    multiples of 16, and returns the last logged metrics with JAX's keys."""
    monkeypatch.chdir(tmp_path)
    t = _trainer(scene_dir, tmp_path, max_num_iterations=24).setup()
    # load_vca: setup() starts the endmembers from the vca.npy the dataset wrote
    np.testing.assert_array_equal(t.state["params"]["endmembers"].detach().numpy(),
                                  np.clip(np.load("vca.npy"), 0.0, 1.0).astype(np.float32))
    m = t.train(num_iterations=10)
    assert t.step == 10 and len(t.history) == 10
    m = t.train(num_iterations=t.step + 14)
    assert t.step == 24 and [r["step"] for r in t.history] == list(range(10, 24))
    want = {"loss/total", "loss/rgb_loss", "loss/spectral_loss", "psnr", "rmse",
            "num_samples_per_batch", "num_occupied_p99", "num_eval_s1_per_batch",
            "num_eval_s2_per_batch", "psnr_spectral", "rmse_spectral", "rays_per_sec",
            "steps_per_sec", "rays_per_batch", "total_train_time_s"}
    assert set(m) == want
    assert m["rays_per_batch"] == 256 and np.isfinite(m["loss/total"])
    m = t.train()  # max_num_iterations: already there
    assert t.step == 24 and t.history == [] and set(m) == {"total_train_time_s"}


def test_adapt_decided_at_48_applied_at_64(scene_dir, tmp_path, monkeypatch):
    """A scheduled adapt is decided at the chunk end that crosses 48 and
    applied adapt_prefetch_steps = 16 later, at 64; it decides the shapes
    the blocking path (prefetch 0) applies at once, and those shapes reach
    the pixel draw, the march and the stage budgets."""
    monkeypatch.chdir(tmp_path)
    kw = dict(dynamic_batching=True, adapt_steps=(48,), adapt_every=0,
              target_num_samples=2048, max_num_iterations=80)
    blocking = _trainer(scene_dir, tmp_path, adapt_prefetch_steps=0, **kw).setup()
    blocking.train(num_iterations=48)
    deferred = _trainer(scene_dir, tmp_path, adapt_prefetch_steps=16, **kw).setup()
    deferred.train()
    (log,) = deferred.adapt_log
    assert (log["decided"], log["apply_step"], log["applied"]) == (48, 64, 64)
    assert blocking.adapt_log[0]["applied"] == 48
    for t in (blocking, deferred):
        assert t.dyn.rays != 256 and t.dyn.march.num_samples <= 32
        assert len(t.dyn.budgets) == 3  # one per stage of (8, 16) at S > 16
    assert deferred.dyn == blocking.dyn
    by_step = {r["step"]: r["metrics"] for r in deferred.history}
    draws = deferred.draw_step()
    assert draws["pixels"][0].shape == (deferred.dyn.rays,)
    assert draws["t_jitter"].shape == (deferred.dyn.rays,)
    s1_cap = deferred.dyn.budgets[0]
    assert all(by_step[s]["num_eval_s1_per_batch"] <= s1_cap for s in range(64, 80))
    assert "num_eval_s3_per_batch" in by_step[79]


def test_periodic_readapt(scene_dir, tmp_path, monkeypatch):
    """After the scheduled steps, a drift check at every adapt_every crossing
    re-runs compute_adapt (drift 0 forces it), as trainer.py:729-747 does."""
    monkeypatch.chdir(tmp_path)
    t = _trainer(scene_dir, tmp_path, dynamic_batching=True, adapt_steps=(16,), adapt_every=16,
                 adapt_drift=0.0, adapt_prefetch_steps=0, target_num_samples=2048,
                 max_num_iterations=64).setup()
    calls = []
    orig = t.compute_adapt
    t.compute_adapt = lambda *a, **kw: (calls.append(t.step), orig(*a, **kw))[1]
    t.train(num_iterations=32)
    assert calls[:1] == [16]
    t.train()
    assert calls[1:] and set(calls[1:]) <= {32, 48, 64}, calls
    assert t.dyn.budgets[0] <= 1.35 * t.dyn.rays * 32


# --------------------------------------------------- gradient accumulation
def test_gradient_accumulation_matches_optax_multisteps():
    """k = 2 on one fixed sequence of gradients: the running-mean
    accumulator, Adam every second mini-step at the rate of the update
    count, within rtol 1e-6 of optax.MultiSteps."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(7)]
    opt_cfg = OptimizerConfig(lr=1e-2, max_steps=4)  # the rate moves at every update
    sched = t_trainer.make_lr_schedule(opt_cfg)
    j_sched = j_trainer.make_lr_schedule(j_trainer.OptimizerConfig(lr=1e-2, max_steps=4))
    tx = optax.MultiSteps(optax.chain(optax.scale_by_adam(eps=opt_cfg.eps),
                                      optax.scale_by_learning_rate(j_sched)), 2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = MultiStepAdam([tp["a"], tp["b"]], sched, opt_cfg.eps, k=2)
    for i, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        tp["a"].grad, tp["b"].grad = torch.from_numpy(g["a"]), torch.from_numpy(g["b"])
        with torch.no_grad():
            stepped = opt.step()
        assert stepped == (i % 2 == 1)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} after mini-step {i}")
        np.testing.assert_allclose(opt.acc[0].numpy(), np.asarray(state.acc_grads["a"]),
                                   rtol=1e-6, atol=1e-7)
    assert opt.updates == 3 and opt.mini_step == 1


def test_trainer_steps_every_mini_step_and_updates_every_kth(scene_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    t = _trainer(scene_dir, tmp_path, gradient_accumulation_steps=2).setup()
    t.update_occupancy()
    w0 = t.state["params"]["hash_table"].detach().clone()
    t.train_step()
    assert t.step == 1 and t.optimizer.updates == 0
    assert torch.equal(t.state["params"]["hash_table"], w0)  # accumulated, not applied
    t.train_step()
    assert t.step == 2 and t.optimizer.updates == 1
    assert not torch.equal(t.state["params"]["hash_table"], w0)


# ------------------------------------------------------------ checkpoints
def test_checkpoint_round_trip_and_resume(scene_dir, tmp_path, monkeypatch):
    """Save at step 17 (mid-accumulation with k = 2) and load into a fresh
    trainer: every parameter, Adam moment, accumulator, occupancy tensor and
    the step generator are equal bit for bit, as are the shapes; training on
    from there to 32 gives the uninterrupted run's state bit for bit."""
    monkeypatch.chdir(tmp_path)
    kw = dict(gradient_accumulation_steps=2, save_only_latest_checkpoint=True)
    a = _trainer(scene_dir, tmp_path, **kw).setup()
    a.train(num_iterations=16)
    a.save_checkpoint()
    a.train(num_iterations=17)
    a.dyn = DynamicShapes(256, dataclasses.replace(a.dyn.march, num_samples=24),
                          (4096, 4096, 4096))
    path = a.save_checkpoint()
    assert path.name == "step-000000017" and path.parent == a.checkpoint_dir
    assert sorted(p.name for p in a.checkpoint_dir.iterdir()) == ["step-000000017"]
    assert json.loads((path / "dynamic_batch.json").read_text()) == {
        "rays": 256, "num_samples": 24, "budgets": [4096, 4096, 4096]}
    b = _trainer(scene_dir, tmp_path, load_dir=a.checkpoint_dir, **kw).setup()
    assert b.step == 17 and b.dyn == a.dyn and b.optimizer.updates == a.optimizer.updates == 8
    assert (tmp_path / "endmembers_loaded.npy").exists()
    la, lb = a.state_tensors(), b.state_tensors()
    assert sorted(la) == sorted(lb) and any(k.startswith("acc ") for k in la)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for t in (a, b):
        t.train(num_iterations=32)
    la, lb = a.state_tensors(), b.state_tensors()
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert a.history[-1]["metrics"] == b.history[-1]["metrics"]


def test_periodic_actions_fire_at_chunk_ends(scene_dir, tmp_path, monkeypatch, capsys):
    """Each action fires at the first chunk end at or past its period:
    logs (every 40, and at the target), eval batches (every 48, never at
    the target), saves (every 50, and at the target) and the endmember dump
    (every 100)."""
    monkeypatch.chdir(tmp_path)
    t = _trainer(scene_dir, tmp_path, steps_per_save=50, steps_per_log=40, save_final=True,
                 steps_per_eval_batch=48, max_num_iterations=104).setup()
    t.train()
    assert sorted(p.name for p in t.checkpoint_dir.iterdir()) == ["step-000000064",
                                                                  "step-000000104"]
    out = capsys.readouterr().out
    logged = [int(line.split()[1].rstrip("]")) for line in out.splitlines()
              if line.startswith("[step") and "loss/total" in line]
    assert logged == [48, 80, 104]
    evals = [int(line.split()[1].rstrip("]")) for line in out.splitlines()
             if line.startswith("[step") and "eval/psnr" in line]
    assert evals == [48, 96]
    np.testing.assert_array_equal(np.load(tmp_path / "endmembers.npy"),
                                  t.state["params"]["endmembers"].detach().numpy())


# ---------------------------------------------------------- metrics, eval
@pytest.mark.parametrize("name", ["psnr", "ssim", "sam", "rmse", "mse2psnr"])
def test_metrics_match_jax(name):
    rng = np.random.default_rng(len(name))
    pred = rng.uniform(size=(24, 20, 5))
    gt = np.clip(pred + rng.normal(scale=0.05, size=pred.shape), 0, 1)
    gt[:3, :4] = 0.0  # zero spectra, left out of SAM
    if name == "mse2psnr":
        for mse in (0.0, 1e-3, 0.25):
            assert t_metrics.mse2psnr(mse) == j_metrics.mse2psnr(mse)
        return
    got = getattr(t_metrics, name)(pred, gt)
    want = getattr(j_metrics, name)(pred, gt)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-10, abs=1e-12)
    if name == "ssim":
        assert getattr(t_metrics, name)(pred[..., 0], gt[..., 0]) == pytest.approx(
            j_metrics.ssim(pred[..., 0], gt[..., 0]), rel=1e-10)


def test_eval_loops(scene_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    t = _trainer(scene_dir, tmp_path).setup()
    t.train(num_iterations=16)
    ev = t.eval_batch()
    assert set(ev) == {"psnr", "rmse", "num_samples_per_batch", "num_occupied_p99",
                       "num_eval_s1_per_batch", "num_eval_s2_per_batch", "psnr_spectral",
                       "rmse_spectral", "rgb_loss", "spectral_loss"}
    assert ev == t.eval_batch()  # seeded with the step
    image_keys = {"psnr", "ssim", "rmse", "psnr_spectral", "ssim_spectral", "sam_spectral",
                  "rmse_spectral", "lpips_vgg16random"}
    per_image = [t.eval_image(i) for i in range(2)]
    assert all(set(m) == image_keys for m in per_image)
    assert all(np.isfinite(v) for m in per_image for v in m.values())
    avg = t.eval_all_images()
    assert set(avg) == image_keys
    for k in image_keys:
        assert avg[k] == pytest.approx((per_image[0][k] + per_image[1][k]) / 2, rel=1e-12)


def _spectral_sam_parts(t, jt, idx):
    """Each trainer's spectral render of eval view `idx` with its ground
    truth, as its eval_image reads them, and the rays of no weight at all.
    On those rays the JAX compositing reads a ray's sum as a difference of
    an XLA prefix sum, whose order of addition leaves a residue under 1e-6,
    where the port's sequential prefix sum leaves exactly 0. SAM leaves out
    pixels with |pred| |gt| < 1e-8, so that residue alone moves it (by
    ~0.05 rad at 32^2)."""
    rays, batch, hw = t.datamanager.eval_image(idx)
    ours = {k: v.cpu().numpy() for k, v in t.render_camera(rays, hw).items()}
    jrays, jbatch, jhw = jt.datamanager.eval_image(idx)
    theirs = jt.render_camera(jrays, jhw)
    empty = ours["accumulation"][..., 0] == 0
    np.testing.assert_array_equal(np.asarray(theirs["accumulation"])[..., 0] == 0, empty)
    return ((ours["spectral"], batch["hs_image"].float().cpu().numpy()),
            (np.array(theirs["spectral"]), np.asarray(jbatch["hs_image"])), empty)


@pytest.mark.parametrize("background", ["random", "white"])
def test_eval_image_matches_jax(scene32_dir, tmp_path, monkeypatch, background):
    """eval_image and eval_all_images of a state trained 16 steps in the port
    against umhs_tpu's Trainer.eval_image on the same state (through
    umhs_torch.convert) and the same eval views, at 32^2: background
    blending (over black for "random", over white), the RGB and spectral
    pairs and every metric, LPIPS included, agree within 1e-5 (relative);
    the eval images and the segmentation dump are the same files under the
    same names, their pixels within 1 of 255 (uint8 truncation of values
    equal within 1e-5), read back by PIL and by the port's reader."""
    import jax
    from PIL import Image

    from umhs_tpu.data.datamanager import DataManagerConfig as JDataManagerConfig
    from umhs_tpu.data.dataparser import DataParserConfig as JDataParserConfig
    from umhs_tpu.engine.trainer import TrainerConfig as JTrainerConfig
    from umhs_torch import convert
    from umhs_torch.data.png import read_png

    monkeypatch.chdir(tmp_path)
    model_kw = {**MODEL_KW, "background_color": background}
    t = _trainer(scene32_dir, tmp_path, model_kw=model_kw,
                 eval_seg_dump_dir=tmp_path / "t_seg").setup()
    t.train(num_iterations=16)
    jt = JTrainer(JTrainerConfig(output_dir=tmp_path / "j", mixed_precision=False,
                                 use_mesh=False, eval_seg_dump_dir=tmp_path / "j_seg"),
                  JModelConfig(**model_kw),
                  JDataManagerConfig(dataparser=JDataParserConfig(data=scene32_dir, num_classes=2),
                                     train_num_rays_per_batch=256, eval_num_rays_per_batch=128),
                  num_classes=2)
    occ = convert.occ_state_to_numpy(t.state["occ"])
    jt.state = {"params": jax.tree.map(jnp.asarray, convert.params_to_numpy(t.state["params"])),
                "occ": {k: jnp.asarray(v) for k, v in occ.items()},
                "step": jnp.int32(t.step)}
    jt.step = t.step  # the host step, which names the eval images
    per_image = []
    for i in range(2):
        got, want = t.eval_image(i), jt.eval_image(i)
        assert set(got) == set(want) and "lpips_vgg16random" in got
        for k in set(got) - {"sam_spectral"}:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-6), (i, k)
        # SAM: the residue on rays of no weight, then SAM with it taken out
        # of both renders alike
        (ours, gt), (theirs, jgt), empty = _spectral_sam_parts(t, jt, i)
        assert (ours[empty] == 0).all() and (np.abs(theirs[empty]) < 1e-6).all()
        assert got["sam_spectral"] == t_metrics.sam(ours, gt)
        assert want["sam_spectral"] == j_metrics.sam(theirs, jgt)
        ours[empty], theirs[empty] = 0.0, 0.0
        want_sam = j_metrics.sam(theirs, jgt)
        assert t_metrics.sam(ours, gt) == pytest.approx(want_sam, rel=1e-5, abs=1e-6), i
        per_image.append({**want, "sam_spectral": want_sam})
    avg = t.eval_all_images()
    for k in avg:
        assert avg[k] == pytest.approx((per_image[0][k] + per_image[1][k]) / 2, rel=1e-5), k

    names = {f"step-{16:09d}-{i}-{n}.png" for i in range(2)
             for n in ("img", "depth", "accumulation", "seg_pred")}
    assert {p.name for p in (t.run_dir / "eval_images").iterdir()} == names
    for mine, theirs in ((t.run_dir / "eval_images", jt.run_dir / "eval_images"),
                         (tmp_path / "t_seg", tmp_path / "j_seg")):
        files = sorted(p.relative_to(mine) for p in mine.rglob("*.png"))
        assert files == sorted(p.relative_to(theirs) for p in theirs.rglob("*.png"))
        for rel in files:
            ours = read_png(mine / rel)
            np.testing.assert_array_equal(np.asarray(Image.open(mine / rel)), ours)
            ref = np.asarray(Image.open(theirs / rel)).astype(int)
            assert ours.shape == ref.shape and np.abs(ours.astype(int) - ref).max() <= 1, rel
    assert read_png(tmp_path / "t_seg" / "seg_pred_1.png").shape == (32, 32)
    assert read_png(t.run_dir / "eval_images" / f"step-{16:09d}-0-img.png").shape == (32, 64, 3)


def test_trainer_takes_wavelengths_as_an_array():
    """The model takes its wavelengths (here a numpy array), image count and
    scene scale from the datamanager; a trainer needs one."""
    scene = SyntheticSceneConfig(image_size=4, num_bands=8)
    poses, _, rgba = render_views(scene, 2, 0.0)
    dm = InMemoryDataManager(rgba, scene_cameras(scene, poses), scene_scale=0.5,
                             wavelengths=450.0 + 20.0 * np.arange(8), device="cpu")
    t = Trainer(TrainerConfig(), ModelConfig(**MODEL_KW), num_classes=2, device="cpu",
                datamanager=dm)
    assert t.model.wavelengths == list(450.0 + 20.0 * np.arange(8))
    assert t.model.num_images == 2
    assert t.model.render_step_size == pytest.approx(np.sqrt(3.0) / 1000.0)  # scale 0.5
    with pytest.raises(ValueError, match="datamanager"):
        Trainer(TrainerConfig(), ModelConfig(**MODEL_KW), num_classes=2, device="cpu")
