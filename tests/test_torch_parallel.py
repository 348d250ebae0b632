"""Data parallelism of umhs_torch (umhs_torch/parallel/mesh.py) on the CPU,
against umhs_tpu's make_grad_fn and make_eval_forward on two of the
conftest's virtual CPU devices, and against the port's own single process.

Two 2-rank groups are spawned in the whole file, each joined by gloo through
a FileStore under tmp_path: the training group (cli.train's launch_training,
the multi-card path of `python -m umhs_torch.cli.train`, on a dataset on
disk) and the check group (rank functions in tests/torch_parallel_ranks.py:
the reduced step of two cases and the sharded eval forward against JAX, then
the trained run's checkpoint restored on both ranks). The rest runs in this
process: local_budget, the draw slicing (patches whole), reduce_step's
packing, and world size 1 (a real gloo group of one) against no mesh, bit
for bit.

Tolerances are those of tests/test_torch_train.py: the loss, its terms and
the metrics within rtol 1e-5, counts exactly, every gradient within rtol
1e-3 and atol 1e-4 * max|g| of that tensor (sums in another order).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from umhs_tpu.data import datamanager as j_dm
from umhs_tpu.models.model import ModelConfig as JModelConfig
from umhs_tpu.models.model import UMHSModel as JModel
from umhs_tpu.parallel import mesh as j_mesh
from umhs_torch import convert
from umhs_torch.configs import FullConfig, PipelineConfig
from umhs_torch.data import datamanager as t_dm
from umhs_torch.data.cameras import generate_camera_rays
from umhs_torch.data.dataparser import DataParserConfig
from umhs_torch.data.synthetic import (
    SyntheticSceneConfig, render_views, scene_cameras, write_dataset)
from umhs_torch.engine.trainer import OptimizerConfig, Trainer, TrainerConfig, named_leaves
from umhs_torch.models.model import ModelConfig
from umhs_torch.parallel import mesh as t_mesh

# test_torch_train.py's shrunken bench config
KW = dict(
    method="rgb+spectral", pred_specular=True, temperature=0.4,
    grid_resolution=16, grid_levels=2, march_pool=4, max_samples_per_ray=64,
    hash_num_levels=4, log2_hashmap_size=10, max_res=256,
    hash_interpolation="tetrahedral", stage_boundaries=(8, 16),
    stochastic_hash_grad=False,
)
WAVELENGTHS = list(450.0 + 20.0 * np.arange(8))
STEP = 500
R = 128  # 64 rays a rank
CASES = {  # budgets over the whole batch: each rank takes max(256, b // 2)
    "single": dict(budgets=(R * 64,), samples=None),
    "three-stage-overflow": dict(budgets=(512, 1024, 1536), samples=24),
}


def _np(t):
    return t.detach().cpu().numpy()


def _store(tmp_path):
    return f"file://{tmp_path / 'rendezvous'}"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ in-process
def test_local_budget():
    assert t_mesh.local_budget(8192, 2) == 4096
    assert t_mesh.local_budget(300, 2) == 256  # never below 256 (mesh.py:68-74)
    assert t_mesh.local_budget((179200, 103936, 93440), 4) == (44800, 25984, 23360)
    assert t_mesh.local_budget([512, 1024, 1536], 2) == (256, 512, 768)
    assert t_mesh.local_budget(4096, 1) == 4096


@pytest.mark.parametrize("patch", [1, 2])
def test_draw_slicing_keeps_patches_whole(patch):
    """Sampling a rank's shard of the draws gives that rank's contiguous
    slice of the whole batch's rays and values, patches whole; the proposal
    jitters are cut along their ray axis."""
    scene = SyntheticSceneConfig(num_views_train=3, image_size=12, num_bands=4)
    poses, cubes, rgba = render_views(scene, 3, 0.0)
    dm = t_dm.InMemoryDataManager(rgba, scene_cameras(scene, poses), hs_images=cubes,
                                  config=t_dm.DataManagerConfig(patch_size=patch),
                                  wavelengths=[500.0, 550.0, 600.0, 650.0], device="cpu")
    n, rays = 2, 64
    gen = torch.Generator().manual_seed(0)
    draws = {"pixels": dm.draw(gen, rays), "t_jitter": torch.rand(rays, generator=gen),
             "prop_jitter": torch.rand((3, rays, 1), generator=gen)}
    full_rays, full_batch = dm.sample(rays, draws["pixels"])
    m = rays // n
    for rank in range(n):
        mesh = t_mesh.Mesh(rank, n, torch.device("cpu"))
        local = t_mesh.shard_draws(draws, mesh)
        assert local["pixels"][0].shape == (m // patch ** 2,)
        torch.testing.assert_close(local["t_jitter"], draws["t_jitter"][rank * m:(rank + 1) * m])
        torch.testing.assert_close(local["prop_jitter"],
                                   draws["prop_jitter"][:, rank * m:(rank + 1) * m])
        r_rays, r_batch = dm.sample(m, local["pixels"])
        for k, v in r_rays.items():
            assert torch.equal(v, full_rays[k][rank * m:(rank + 1) * m]), k
        for k, v in r_batch.items():
            assert torch.equal(v, full_batch[k][rank * m:(rank + 1) * m]), k
        if patch > 1:  # each patch of p x p pixels lies in one shard, in one image
            img = r_batch["indices"][:, 0].reshape(-1, patch * patch)
            assert bool((img == img[:, :1]).all())
    with pytest.raises(ValueError, match="do not split"):
        t_mesh.shard_draws({"t_jitter": torch.zeros(63)}, t_mesh.Mesh(0, 2, torch.device("cpu")))


def test_check_shardable():
    t_mesh.check_shardable(4096, 1, 4)
    t_mesh.check_shardable(4096, 2, 4)  # 256 rays in patches of 4 split over 4 ranks
    with pytest.raises(ValueError):
        t_mesh.check_shardable(4096, 1, 3)  # 256-aligned adapted counts do not split over 3
    with pytest.raises(ValueError):
        t_mesh.check_shardable(4097, 1, 2)
    t_mesh.check_shardable(4608, 3, 2)  # lcm(256, 9) = 2304 rays: 128 patches of 9 a rank
    with pytest.raises(ValueError):
        t_mesh.check_shardable(4608, 3, 3)


def test_reduce_step_packs_means_and_counts():
    """Without a group the buffer is reduced over one rank: every value
    comes back with its bits, in its order, and the gradients are
    untouched; float32 gradients only."""
    mesh = t_mesh.make_mesh("cpu")
    assert (mesh.size, mesh.backend) == (1, None)
    g = [torch.randn(5, 3), torch.randn(7)]
    before = [x.clone() for x in g]
    values = {"loss/rgb": torch.tensor(0.25), "num_samples_per_batch": torch.tensor(123456789),
              "psnr": torch.tensor(21.5, dtype=torch.float64), "num_eval_s1_per_batch":
              torch.tensor(77, dtype=torch.int32)}
    out = t_mesh.reduce_step(mesh, g, values)
    assert list(out) == list(values)
    for k, v in values.items():
        assert out[k].dtype == torch.float32
        assert out[k] == torch.as_tensor(v, dtype=torch.float32), k
    for a, b in zip(g, before):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        t_mesh.reduce_step(mesh, [torch.zeros(3, dtype=torch.bfloat16)], {})


SCENE = SyntheticSceneConfig(num_views_train=4, num_views_eval=2, image_size=16, num_bands=8,
                             num_spheres=2)
LOOP_KW = dict(
    method="rgb+spectral", grid_resolution=16, grid_levels=1, march_pool=0,
    hash_num_levels=4, log2_hashmap_size=10, max_res=64, num_candidates=128,
    max_samples_per_ray=32, cone_angle=0.0, pred_specular=False, load_vca=True,
    eval_num_rays_per_chunk=256, stage_boundaries=(8, 16),
)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("scene"), SCENE)


def _loop_config(scene_dir, out_dir, steps=40):
    """A full config of the toy run: 256 rays, an adapt decided at 16 and
    applied at 32, an eval batch at 32, the final checkpoint at `steps`."""
    trainer = TrainerConfig(
        output_dir=out_dir, max_num_iterations=steps, steps_per_save=10**7,
        steps_per_eval_batch=32, steps_per_eval_image=10**7, steps_per_log=16,
        mixed_precision=False, seed=3, adapt_steps=(16,), adapt_prefetch_steps=8,
        target_num_samples=4096, save_eval_images=False,
        optimizer=OptimizerConfig(lr=1e-2, max_steps=1000))
    dm = t_dm.DataManagerConfig(dataparser=DataParserConfig(data=scene_dir, num_classes=2),
                                train_num_rays_per_batch=256, eval_num_rays_per_batch=128)
    return FullConfig(trainer=trainer, pipeline=PipelineConfig(
        num_classes=2, model=ModelConfig(**LOOP_KW), datamanager=dm))


def test_world_size_one_equals_no_mesh(scene_dir, tmp_path, monkeypatch):
    """A mesh of one rank in a real gloo group (one all_reduce a step, the
    broadcasts, the barrier around the checkpoint) trains the same bits as
    no mesh: losses, adapts, every state tensor, the eval batch."""
    monkeypatch.chdir(tmp_path)
    cfg = _loop_config(scene_dir, tmp_path / "out")
    runs = {}
    for label in ("solo", "mesh"):
        mesh = (t_mesh.init_mesh(0, 1, "gloo", "cpu", _store(tmp_path))
                if label == "mesh" else None)
        try:
            assert mesh is None or (mesh.size, mesh.backend) == (1, "gloo")
            t = Trainer(dataclasses.replace(cfg.trainer, experiment_name=label),
                        cfg.pipeline.model, cfg.pipeline.datamanager, num_classes=2,
                        device="cpu", mesh=mesh).setup()
            t.train(40)
            runs[label] = (t.history, t.adapt_log, t.state_tensors(), t.eval_batch())
        finally:
            if mesh is not None:
                t_mesh.close_mesh(mesh)
    (h0, a0, s0, e0), (h1, a1, s1, e1) = runs["solo"], runs["mesh"]
    assert [r["metrics"] for r in h0] == [r["metrics"] for r in h1]
    assert len(a0) == 1 and not a0[0].get("noop") and a0 == a1
    assert sorted(s0) == sorted(s1)
    for k in s0:
        assert torch.equal(s0[k].reshape(-1).view(torch.uint8),
                           s1[k].reshape(-1).view(torch.uint8)), k
    assert e0 == e1


def test_a_failing_rank_makes_launch_raise():
    with pytest.raises(Exception, match="no such"):
        t_mesh.launch(ranks.fail_rank, 1, "gloo", ["cpu"])


# ----------------------------------------------- 2 ranks against JAX's mesh
@pytest.fixture(scope="module")
def jax_parity(tmp_path_factory, two_rank_run):
    """JAX's make_grad_fn and make_eval_forward on a 2-device mesh, and the
    port's two ranks (gloo) on the same inputs: each rank draws the whole
    batch, made of the JAX shards' draws (fold_in(key, shard), as
    mesh.py:103-105), and takes its half. The same ranks then restore the
    final checkpoint of two_rank_run (ranks.trained_run)."""
    scene = SyntheticSceneConfig(num_views_train=4, image_size=20, num_bands=8,
                                 wavelength_start=450.0, wavelength_step=20.0)
    poses, cubes, rgba = render_views(scene, 4, 0.0)
    cams = scene_cameras(scene, poses)
    jm = JModel(JModelConfig(**KW), WAVELENGTHS, num_classes=4, num_images=4)
    params, occ0 = jm.init(jax.random.PRNGKey(0))
    lay = params["mlp_base"]["layers"]
    params = dict(params, hash_table=params["hash_table"] * 1e4,
                  mlp_base={"layers": lay[:-1] + [dict(lay[-1], w=lay[-1]["w"] * 6.0)]})
    occ = jax.jit(lambda o, p, k: jm.update_occupancy(o, p, k, full=True))(
        occ0, params, jax.random.PRNGKey(3))
    jdata = {"image": jnp.asarray(rgba), "hs_image": jnp.asarray(cubes)}
    jcam = {k: jnp.asarray(_np(v)) for k, v in cams.to_device_dict().items()}

    # the key's samples sit clear of every discrete decision in both shards
    # (test_torch_train.py's loss test says why that matters): with key 12,
    # shard 1 alone, through make_grad_fn without a mesh against the port's
    # forward without one, parts at the stage cut-off by 5e-3 * max|g| in
    # 31 hash-table entries, while JAX's 2-device step equals the mean of
    # its two single-shard steps bit for bit; keys 13-15 part nowhere
    _, k_sample, k_march, k_bg = jax.random.split(jax.random.PRNGKey(13), 4)
    jrays, jbatch = j_dm.sample_pixel_batch(jdata, jcam, k_sample, R)
    mesh2 = j_mesh.make_mesh(jax.devices()[:2])
    half = R // 2
    jitter = np.concatenate([np.array(jax.random.uniform(jax.random.fold_in(k_march, i),
                                                         (half,))) for i in range(2)])
    background = np.concatenate([np.array(jax.random.uniform(jax.random.fold_in(k_bg, i),
                                                             (half, 3))) for i in range(2)])
    idx = torch.from_numpy(np.array(jbatch["indices"]))
    draws = {"pixels": (idx[:, 0], idx[:, 1], idx[:, 2]),
             "t_jitter": torch.from_numpy(jitter), "background": torch.from_numpy(background)}

    jax_out = {}
    for name, case in CASES.items():
        march = None
        if case["samples"] is not None:
            march = dataclasses.replace(jm.march_config, num_samples=case["samples"])
        budget = case["budgets"] if len(case["budgets"]) > 1 else case["budgets"][0]
        fn = jax.jit(j_mesh.make_grad_fn(jm, mesh2, march_cfg=march, compact_budget=budget))
        total, loss, metrics, grads = fn(params, occ, jrays, jbatch, k_march, k_bg,
                                         jnp.int32(STEP))
        values = {f"loss/{k}": float(v) for k, v in loss.items()}
        values["loss/total"] = float(total)
        values.update({k: float(v) for k, v in metrics.items()})
        jax_out[name] = (values, {n: np.asarray(g) for n, g in named_leaves(grads)})

    eval_rays = generate_camera_rays(cams.to_device_dict(), 1, scene.image_size,
                                     scene.image_size)
    eval_rays = {k: v[:256] for k, v in eval_rays.items()}
    jfwd = jax.jit(j_mesh.make_eval_forward(jm, mesh2))
    jeval = jfwd(params, occ, {k: jnp.asarray(_np(v)) for k, v in eval_rays.items()},
                 jax.random.PRNGKey(0), jnp.int32(STEP))
    jax_out["eval"] = {k: np.asarray(v) for k, v in jeval.items()}

    payload = {
        "rgba": rgba, "cubes": cubes, "cams": cams, "wavelengths": WAVELENGTHS, "rays": R,
        "model_kw": KW, "num_classes": 4, "step": STEP, "cases": CASES,
        "params": convert.params_to_torch(params), "occ": convert.occ_state_to_torch(occ),
        "draws": draws, "eval_rays": eval_rays,
        "trained_config": two_rank_run[0], "trained_checkpoints": _checkpoints(two_rank_run),
    }
    work = tmp_path_factory.mktemp("jax_parity")
    cwd = os.getcwd()
    os.chdir(work)  # parsing writes vca.npy into the working directory
    try:
        port = t_mesh.launch(ranks.grad_step_rank, 2, "gloo", ["cpu", "cpu"], args=(payload,),
                             init_method=_store(work))
    finally:
        os.chdir(cwd)
    return jax_out, port, payload


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_jax_make_grad_fn(jax_parity, name):
    jax_out, port, _ = jax_parity
    (jvalues, jgrads) = jax_out[name]
    for rank, result in enumerate(port):
        values, grads = result[name]
        assert sorted(values) == sorted(jvalues)
        for k, want in jvalues.items():
            if k.endswith("_per_batch"):  # counts: summed over the shards, exactly
                assert values[k] == want, (rank, k)
            else:  # means of the shards' values
                np.testing.assert_allclose(values[k], want, rtol=1e-5, err_msg=f"{rank} {k}")
        assert values["loss/total"] > 0.0
        for n, want in jgrads.items():
            assert np.abs(want).max() > 0.0, n
            np.testing.assert_allclose(_np(grads[n]), want, rtol=1e-3,
                                       atol=1e-4 * np.abs(want).max(), err_msg=f"{rank} {n}")
    # both ranks hold the same reduced bits
    (v0, g0), (v1, g1) = port[0][name], port[1][name]
    assert v0 == v1
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    if name == "three-stage-overflow":  # stage 1 ran into each rank's budget of 256
        assert jvalues["num_eval_s1_per_batch"] == 2 * 256
        assert jvalues["num_eval_s3_per_batch"] > 0


def test_two_ranks_match_jax_make_eval_forward(jax_parity):
    """The sharded eval forward, gathered on every rank, against JAX's
    ray-sharded forward on 2 devices: atol 1e-4 on every output (the
    forward's tolerance in test_torch_model.py), counts exactly; both ranks
    hold the same bits."""
    jax_out, port, _ = jax_parity
    want = jax_out["eval"]
    for rank, result in enumerate(port):
        got = result["eval"]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = _np(got[k])
            assert g.shape == w.shape, k
            if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
                np.testing.assert_array_equal(g, w, err_msg=f"{rank} {k}")
            else:
                np.testing.assert_allclose(g.astype(np.float64), w, rtol=0, atol=1e-4,
                                           err_msg=f"{rank} {k}")
    assert float(want["accumulation"].max()) > 0.5  # the rays hit the scene
    for k in port[0]["eval"]:
        assert torch.equal(port[0]["eval"][k], port[1]["eval"][k]), k


def test_two_ranks_match_one_process(jax_parity):
    """The port's 2-rank step against its own step in one process on the
    same global draws (no budget drops anything): the loss terms within rtol
    1e-5, counts exactly, every gradient within test_torch_train's
    tolerance."""
    _, port, p = jax_parity
    dm = t_dm.InMemoryDataManager(p["rgba"], p["cams"], hs_images=p["cubes"],
                                  config=t_dm.DataManagerConfig(train_num_rays_per_batch=R),
                                  wavelengths=WAVELENGTHS, device="cpu")
    solo = Trainer(TrainerConfig(seed=0, mixed_precision=False, save_final=False),
                   ModelConfig(**KW), num_classes=4, device="cpu", datamanager=dm)
    params = ranks._tree_clone(p["params"])
    for _, leaf in named_leaves(params):
        leaf.requires_grad_(True)
    solo.state = {"params": params, "occ": p["occ"], "step": STEP}
    solo.dyn = dataclasses.replace(solo.dyn, rays=R, budgets=CASES["single"]["budgets"])
    values, grads = ranks.step_values_and_grads(solo, p["draws"])
    mvalues, mgrads = port[0]["single"]
    for k, v in values.items():
        if k.endswith("_per_batch"):
            assert mvalues[k] == v, k
        elif k.startswith("loss/"):
            np.testing.assert_allclose(mvalues[k], v, rtol=1e-5, err_msg=k)
    for n, g in grads.items():
        ref = _np(g)
        np.testing.assert_allclose(_np(mgrads[n]), ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=n)


# ------------------------------------ 2 ranks through cli.train's launcher
@pytest.fixture(scope="module")
def two_rank_run(scene_dir, tmp_path_factory):
    """cli.train's launch_training of the toy run over two gloo ranks, as
    `python -m umhs_torch.cli.train` launches one rank per card."""
    from umhs_torch.cli import train as cli_train

    work = tmp_path_factory.mktemp("two_ranks")
    cfg = _loop_config(scene_dir, work / "out")
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(
        cfg.trainer, experiment_name="mesh", vis="console"))
    cwd, threads = os.getcwd(), os.environ.get("OMP_NUM_THREADS")
    os.chdir(work)  # parsing writes vca.npy into the working directory
    os.environ["OMP_NUM_THREADS"] = "1"  # each rank's torch: one thread, as in this process
    try:
        result = cli_train.launch_training(cfg, "umhsnerf", ["cpu", "cpu"], "gloo",
                                           init_method=_store(work))
    finally:
        os.chdir(cwd)
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    return cfg, result, work


def _run_dir(two_rank_run):
    return two_rank_run[2] / "out" / "mesh" / "umhsnerf"


def _checkpoints(two_rank_run):
    return _run_dir(two_rank_run) / "umhs_models"


def test_two_ranks_train_the_same_bits(two_rank_run, jax_parity, tmp_path, monkeypatch):
    """launch_training comes back only when every rank ends the run with
    the same state bits. Then: the run adapted once (three stages in its
    checkpoint); both ranks restore from the final checkpoint the state
    that one process restores, and get the same bits from a partial
    occupancy update; the eval metrics came back and were written."""
    cfg, result, _ = two_rank_run
    _, port, _ = jax_parity
    assert result.trainer is None
    ckpt = _checkpoints(two_rank_run) / "step-000000040"
    shapes = json.loads((ckpt / "dynamic_batch.json").read_text())
    assert len(shapes["budgets"]) == 3 and shapes["rays"] % 2 == 0
    t0, t1 = port[0]["trained"], port[1]["trained"]
    assert t0["occ_after_update"] == t1["occ_after_update"]
    assert t0["restored"] == t1["restored"]
    monkeypatch.chdir(tmp_path)
    alone = Trainer(dataclasses.replace(cfg.trainer, load_dir=ckpt.parent,
                                        output_dir=tmp_path / "out"),
                    cfg.pipeline.model, cfg.pipeline.datamanager, num_classes=2,
                    device="cpu").setup()
    assert t0["restored"] == ranks.digest(alone.state_tensors())
    assert alone.step == 40 and alone.dyn.budgets == tuple(shapes["budgets"])
    saved = json.loads((_run_dir(two_rank_run) / "final_metrics.json").read_text())
    assert json.dumps(saved["eval"]) == json.dumps(result.evals)  # NaN SAM on this toy too
    assert np.isfinite(result.evals["psnr"])
    assert saved["train"]["loss/total"] == result.final_metrics["loss/total"]


def test_launch_training_raises_when_the_ranks_part(monkeypatch):
    """Ranks that end with other state bits make launch_training raise."""
    from umhs_torch.cli import train as cli_train

    monkeypatch.setattr(t_mesh, "launch", lambda *a, **k: [({}, {}, "aa"), ({}, {}, "ab")])
    cfg = _loop_config("nowhere", "out")
    with pytest.raises(RuntimeError, match="different states"):
        cli_train.launch_training(cfg, "umhsnerf", ["cpu", "cpu"], "gloo")


def test_two_rank_step_matches_one_process_at_the_trained_state(jax_parity):
    """At the trained (adapted, three-stage) state, the ranks' reduced step
    against one process's step on the same global draws: loss terms within
    rtol 1e-5, counts exactly, gradients within test_torch_train's
    tolerance."""
    _, port, _ = jax_parity
    r0, r1 = port[0]["trained"], port[1]["trained"]
    (mvalues, mgrads), (svalues, sgrads) = r0["mesh_step"], r0["solo_step"]
    assert r1["mesh_step"][0] == mvalues
    assert "num_eval_s3_per_batch" in svalues
    for k, v in svalues.items():
        if k.endswith("_per_batch"):
            assert mvalues[k] == v, k
        elif k.startswith("loss/"):
            np.testing.assert_allclose(mvalues[k], v, rtol=1e-5, err_msg=k)
    for n, g in sgrads.items():
        ref = _np(g)
        np.testing.assert_allclose(_np(mgrads[n]), ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=n)


def test_rank_zero_writes_once(two_rank_run, jax_parity, tmp_path, monkeypatch):
    """One config.yml, one final checkpoint, one metrics.jsonl line per log;
    and the first step of the run over the ranks gives one process's loss
    terms within rtol 1e-5 and its counts exactly (the ranks' halves make
    up the same batch)."""
    cfg, _, _ = two_rank_run
    _, port, _ = jax_parity
    run_dir = _run_dir(two_rank_run)
    assert (run_dir / "config.yml").exists()
    assert [p.name for p in (run_dir / "umhs_models").iterdir()] == ["step-000000040"]
    logged = [json.loads(ln)["step"] for ln in
              (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert logged == [16, 32, 32, 40]  # the logs at 16, 32, 40 and the eval batch at 32
    first_mesh = port[0]["trained"]["first_step"]
    assert port[1]["trained"]["first_step"] == first_mesh
    monkeypatch.chdir(tmp_path)
    solo = Trainer(dataclasses.replace(cfg.trainer, output_dir=tmp_path / "out"),
                   cfg.pipeline.model, cfg.pipeline.datamanager, num_classes=2,
                   device="cpu").setup()
    solo.train(1)
    first = solo.history[0]["metrics"]
    for k, v in first.items():
        if k.endswith("_per_batch"):
            assert first_mesh[k] == v, k
        elif k.startswith("loss/"):
            np.testing.assert_allclose(first_mesh[k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("cards,extra,want", [
    (2, [], ("launch", ["cuda:0", "cuda:1"], "nccl")),
    (4, [], ("launch", ["cuda:0", "cuda:1", "cuda:2", "cuda:3"], "nccl")),
    (2, ["--trainer.use-mesh", "False"], ("run", "cuda")),
    (2, ["--device", "cuda:1"], ("run", "cuda:1")),
    (1, [], ("run", "cuda")),
], ids=["2-cards", "4-cards", "use-mesh-off", "one-card-named", "one-card"])
def test_cli_train_launches_one_rank_per_visible_card(monkeypatch, cards, extra, want):
    """cli.train's choice, with the card count faked: one rank per visible
    card on NCCL when use_mesh (the default) and more than one card is
    visible; one process otherwise, or on a card named by index."""
    from umhs_torch.cli import train as cli_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    calls = []
    monkeypatch.setattr(cli_train, "launch_training", lambda config, method, devices, backend:
                        calls.append(("launch", list(devices), backend)))
    monkeypatch.setattr(cli_train, "run", lambda config, method, device, mesh=None:
                        calls.append(("run", str(device))))
    cli_train.main(["umhsnerf", "--data", "nowhere", *extra])
    assert calls == [want]
