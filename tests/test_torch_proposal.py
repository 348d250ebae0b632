"""The proposal sampler (nerfacto's, scripts/nerfacto.sh) of umhs_torch against
umhs_tpu on the CPU: the parameter tree, the forward with the JAX package's
parameters (through convert.params_to_torch) and its jitters, the loss terms
and the gradient of every leaf, the eval forward, the trainer (no occupancy
update, no adapts, the new leaves in checkpoints and gradient norms, the
render's fixed jitters), a toy training run and cli.train.

The shrunken model: proposals (64, 32) -> 16 samples, main hash L16 2^13 to
resolution 64 (the proposal grids are nerfacto's, L5 2^17), 3 classes, 21
bands for rgb+spectral with the specular residual, f32, deterministic hash
gradients, 64 rays from z = -1.5. The hash tables are scaled to +/-0.1 so
densities spread. near 0.5 and far 6: the disparity warp's dt/ds = t^2 (1/near
- 1/far) carries the last-bit differences of XLA's and torch's cumsums in the
resampling into sample positions, 10x less than at near 0.05 and far 20.

Tolerances: outputs atol 1e-4 (resampled edges agree to ~1e-5); loss terms
rtol 1e-3 (the interlevel loss counts a bin when an edge falls on one side of
another, ~1e-4 apart); every gradient within 2e-3 of the JAX one in norm.
"""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umhs_tpu import configs as j_configs
from umhs_tpu.models.model import ModelConfig as JModelConfig
from umhs_tpu.models.model import UMHSModel as JModel
from umhs_torch import convert
from umhs_torch.cli import eval as t_eval
from umhs_torch.cli import render as t_render
from umhs_torch.cli import train as t_train
from umhs_torch.cli import viewer as t_viewer
from umhs_torch.data.datamanager import DataManagerConfig, InMemoryDataManager
from umhs_torch.data.dataparser import DataParserConfig
from umhs_torch.data.synthetic import (
    SyntheticSceneConfig, render_views, scene_cameras, write_dataset)
from umhs_torch.engine.trainer import OptimizerConfig, Trainer, TrainerConfig, named_leaves
from umhs_torch.models.model import ModelConfig as TModelConfig
from umhs_torch.models.model import UMHSModel as TModel

KW = dict(sampler="proposal", num_proposal_samples=(64, 32), num_nerf_samples=16,
          log2_hashmap_size=13, max_res=64, near_plane=0.5, far_plane=6.0,
          stochastic_hash_grad=False)
WAVELENGTHS = list(range(450, 651, 10))
R = 64
STEP = 500  # inside the specular ramp
AUX = ("prop_edges_0", "prop_edges_1", "prop_weights_0", "prop_weights_1", "final_edges",
       "final_weights")


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(method, **over):
    kw = dict(KW, method=method, pred_specular=method != "rgb", **over)
    wl = WAVELENGTHS if method != "rgb" else []
    return (JModel(JModelConfig(**kw), wl, num_classes=3, num_images=4),
            TModel(TModelConfig(**kw), wl, num_classes=3, num_images=4, device="cpu"))


def _jitters(key, n, r):
    """The JAX forward's stratification draws for the port: its key split in
    n, uniform(k_i, (R, 1)) each."""
    return torch.from_numpy(np.stack([np.array(jax.random.uniform(k, (r, 1)))
                                      for k in jax.random.split(key, n)]))


# nerfstudio's nerfacto-big sample counts (configs/method_configs.py): 512
# and 256 proposal samples, 128 NeRF samples, on fewer rays
BIG = dict(num_proposal_samples=(512, 256), num_nerf_samples=128)
R_BIG = 16


@pytest.fixture(scope="module", params=["rgb", "rgb+spectral", "rgb-nerfacto-big"])
def both(request):
    """One training forward, loss and gradient of each package on the same
    parameters, rays, batch and draws; rgb-nerfacto-big past K6c's old
    limit of 256 samples a ray (the first proposal level's render_weights
    at 512, with the distortion loss's t gradients)."""
    big = request.param.endswith("nerfacto-big")
    method = "rgb" if big else request.param
    n = R_BIG if big else R  # rays
    jm, tm = _models(method, **(BIG if big else {}))
    params, occ = jm.init(jax.random.PRNGKey(0))
    params = dict(params, hash_table=params["hash_table"] * 1e3)
    for k in ("proposal_0", "proposal_1"):
        params[k] = dict(params[k], hash_table=params[k]["hash_table"] * 1e3)
    rng = np.random.default_rng(4)
    d = np.concatenate([rng.uniform(-0.3, 0.3, (n, 2)), np.ones((n, 1))], -1)
    rays = {"origins": np.tile([[0.0, 0.0, -1.5]], (n, 1)).astype(np.float32),
            "directions": (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32),
            "camera_indices": rng.integers(0, 4, n).astype(np.int32)}
    batch = {"image": rng.uniform(0, 1, (n, 4)).astype(np.float32),
             "hs_image": rng.uniform(0, 1, (n, len(WAVELENGTHS))).astype(np.float32)}
    key, k_bg = jax.random.PRNGKey(1), jax.random.PRNGKey(3)
    jrays = {k: jnp.asarray(v) for k, v in rays.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def total(p):
        out = jm.forward(p, occ, jrays, rng=key, train=True, step=jnp.int32(STEP))
        loss = jm.loss(out, jbatch, k_bg, step=STEP)
        return sum(loss.values()), (out, loss)

    (jtotal, (jout, jloss)), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)

    tparams = convert.params_to_torch(params)
    for _, t in named_leaves(tparams):
        t.requires_grad_(True)
    trays = {k: torch.from_numpy(v) for k, v in rays.items()}
    jitter = _jitters(key, 3, n)
    tout = tm.forward(tparams, None, trays, train=True, step=STEP, prop_jitter=jitter)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss = tm.loss(tout, tbatch, torch.from_numpy(np.array(jax.random.uniform(k_bg, (n, 3)))),
                    step=STEP)
    ttotal = sum(tloss.values())
    ttotal.backward()
    return SimpleNamespace(method=method, jm=jm, tm=tm, params=params, tparams=tparams,
                           trays=trays, jitter=jitter, jtotal=jtotal, jout=jout, jloss=jloss,
                           jgrads=jgrads, ttotal=ttotal.detach(), tout=tout, tloss=tloss)


@pytest.mark.parametrize("method", ["rgb", "rgb+spectral"])
def test_parameter_tree_matches(method):
    """The tree of shapes equals the JAX one; the proposal grids are the
    JAX package's (nerfacto's L5 2^17, exact backward); the field's own
    leaves are drawn first, as with the occgrid sampler, bit for bit."""
    jm, tm = _models(method)
    jparams, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tparams, occ = tm.init(torch.Generator().manual_seed(0))
    assert convert._map(tparams, lambda t: tuple(t.shape)) == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jparams)
    assert {"proposal_0", "proposal_1"} <= set(tparams)
    for jh, th in zip(jm.proposal_hash_configs, tm.proposal_hash_configs):
        assert th.stochastic_grad is False
        for f in dataclasses.fields(th):
            assert getattr(th, f.name) == getattr(jh, f.name), f.name
    _, occgrid = _models(method, sampler="occgrid")
    plain, _ = occgrid.init(torch.Generator().manual_seed(0))
    assert sorted(plain) == sorted(k for k in tparams if not k.startswith("proposal_"))
    for name, t in named_leaves(plain):
        assert torch.equal(t, dict(named_leaves(tparams))[name]), name
    assert occgrid.occ_update_due(0) == (True, True) and tm.occ_update_due(0) == (False, False)


def test_forward_matches_jax(both):
    """Every output, the proposal histograms and the final bins included."""
    assert sorted(both.tout) == sorted(both.jout)
    assert set(AUX) <= set(both.tout)
    for k, ref in both.jout.items():
        got, ref = _np(both.tout[k]), np.asarray(ref)
        assert got.shape == ref.shape, k
        if k in ("num_samples_per_ray", "seg_raw"):
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4, err_msg=k)
    assert float(both.tout["accumulation"].detach().min()) > 0.05  # the rays see the grid


def test_loss_terms_and_gradients_match(both):
    """The loss terms (rgb or spectral, interlevel, distortion) and every
    leaf's gradient in norm, the proposal nets' included (they get theirs
    from the interlevel loss and through the resampled bins)."""
    assert sorted(both.tloss) == sorted(both.jloss)
    assert {"interlevel_loss", "distortion_loss"} <= set(both.tloss)
    for k, ref in both.jloss.items():
        np.testing.assert_allclose(float(both.tloss[k]), float(ref), rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(float(both.ttotal), float(both.jtotal), rtol=1e-4)
    jflat = dict(named_leaves(both.jgrads))
    for name, t in named_leaves(both.tparams):
        ref = np.asarray(jflat[name])
        assert np.linalg.norm(ref) > 0, name
        err = np.linalg.norm(_np(t.grad) - ref) / np.linalg.norm(ref)
        assert err <= 2e-3, (name, err)


def test_eval_forward_drops_the_aux_outputs(both):
    with torch.no_grad():
        out = both.tm.forward(both.tparams, None, both.trays, train=False, step=STEP,
                              prop_jitter=both.jitter)
    assert sorted(out) == sorted(k for k in both.tout if k not in AUX)
    for k, v in out.items():  # appearance off: train and eval compute the same
        assert torch.equal(v, both.tout[k].detach()), k
    with pytest.raises(ValueError, match="prop_jitter"):
        both.tm.forward(both.tparams, None, both.trays, prop_jitter=both.jitter[:2])


def _in_memory_trainer(rays=64, **trainer_kw):
    scene = SyntheticSceneConfig(num_views_train=4, image_size=16, num_bands=8)
    poses, cubes, rgba = render_views(scene, 4, 0.0)
    dm = InMemoryDataManager(rgba, scene_cameras(scene, poses), hs_images=cubes,
                             config=DataManagerConfig(train_num_rays_per_batch=rays),
                             wavelengths=scene.wavelengths, device="cpu")
    model = TModelConfig(**dict(KW, method="rgb+spectral", pred_specular=True,
                                num_proposal_samples=(32, 16), num_nerf_samples=8))
    return Trainer(TrainerConfig(seed=3, mixed_precision=False, save_final=False, **trainer_kw),
                   model, num_classes=3, device="cpu", datamanager=dm).setup()


def test_trainer_skips_occupancy_updates_and_adapts(tmp_path, monkeypatch):
    """No occupancy update and no dynamic-batch decision at their steps
    (the grid stays empty, the shapes as configured); the proposal leaves are
    optimised, counted in grad_norm/total and carried by a checkpoint."""
    monkeypatch.chdir(tmp_path)
    trainer = _in_memory_trainer(dynamic_batching=True, adapt_steps=(16,),
                                 adapt_prefetch_steps=0, log_gradients=True)
    occ0 = {k: v.clone() for k, v in trainer.state["occ"].items()}
    names = [n for n, _ in named_leaves(trainer.state["params"])]
    assert {"proposal_0.hash_table", "proposal_1.mlp.layers.1.w"} <= set(names)
    assert len(trainer.optimizer.params) == len(names)
    draws = trainer.draw_step()
    assert tuple(draws["prop_jitter"].shape) == (3, 64, 1)
    before = trainer.state["params"]["proposal_0"]["hash_table"].detach().clone()
    trainer.train(16)  # occgrid would update its grid at step 0 and adapt at step 16
    assert [r["occ_update"] for r in trainer.history] == [None] * 16
    assert trainer.adapt_log == [] and trainer.pending_adapt is None
    assert trainer.dyn.rays == 64
    for k, v in trainer.state["occ"].items():
        assert torch.equal(v, occ0[k]), k
    assert not torch.equal(trainer.state["params"]["proposal_0"]["hash_table"], before)

    trainer.loss_and_grads(trainer.draw_step())
    grads = {n: t.grad for n, t in named_leaves(trainer.state["params"])}
    total = float(trainer.gradient_norms()["grad_norm/total"])
    assert float(grads["proposal_0.hash_table"].norm()) > 0
    np.testing.assert_allclose(total, float(torch.sqrt(sum((g * g).sum() for g in
                                                           grads.values()))), rtol=1e-6)

    path = trainer.save_checkpoint(tmp_path / "ckpt")
    fresh = _in_memory_trainer()
    fresh.load_checkpoint(path.parent)
    a, b = trainer.state_tensors(), fresh.state_tensors()
    assert sorted(a) == sorted(b) and "param proposal_1.hash_table" in a
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_render_camera_gives_every_chunk_the_same_jitters():
    """render_camera draws the jitters once from a generator seeded with 0
    (the JAX render's PRNGKey(0) for every chunk) and each chunk's rays get
    them, so a chunk renders as the forward does on its own."""
    trainer = _in_memory_trainer()
    rays, _ = trainer.datamanager.sample(
        128, trainer.datamanager.draw(torch.Generator().manual_seed(1), 128))
    image = trainer.render_camera(rays, (8, 16), chunk=64)
    jitter = torch.rand((3, 64, 1), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for c in range(2):
            sl = {k: v[64 * c:64 * (c + 1)] for k, v in rays.items()}
            out = trainer.model.forward(trainer.state["params"], None, sl, step=0,
                                        prop_jitter=jitter)
            assert torch.equal(image["rgb"].reshape(128, 3)[64 * c:64 * (c + 1)], out["rgb"])


def test_proposal_training_improves(tmp_path, monkeypatch):
    """The twin of tests/test_proposal_model.py::test_proposal_training_improves,
    cut to 96 steps of 64 rays at lr 2e-2 (~10 s on one thread): the eval
    batch's PSNR rises by more than 2 dB."""
    monkeypatch.chdir(tmp_path)
    root = write_dataset(tmp_path / "scene", SyntheticSceneConfig(
        num_views_train=8, num_views_eval=2, image_size=32, num_bands=6, num_spheres=1))
    trainer = Trainer(
        TrainerConfig(max_num_iterations=96, steps_per_save=10**9, steps_per_eval_batch=10**9,
                      steps_per_eval_image=10**9, steps_per_log=10**9, save_final=False,
                      output_dir=tmp_path / "out", experiment_name="prop", mixed_precision=False,
                      optimizer=OptimizerConfig(lr=2e-2, max_steps=96)),
        TModelConfig(method="rgb", sampler="proposal", num_proposal_samples=(64, 32),
                     num_nerf_samples=16, log2_hashmap_size=13, max_res=64, far_plane=20.0,
                     eval_num_rays_per_chunk=512),
        DataManagerConfig(dataparser=DataParserConfig(data=root, num_classes=2),
                          train_num_rays_per_batch=64, eval_num_rays_per_batch=128),
        num_classes=2, device="cpu").setup()
    m0 = trainer.eval_batch()
    trainer.train()
    m1 = trainer.eval_batch()
    assert {"interlevel_loss", "distortion_loss"} <= {
        k.split("/")[1] for k in trainer.history[-1]["metrics"] if k.startswith("loss/")}
    assert np.isfinite(m1["psnr"]) and m1["psnr"] > m0["psnr"] + 2, (m0, m1)


def test_cli_runs_the_proposal_sampler(tmp_path, monkeypatch):
    """cli.train --pipeline.model.sampler proposal --device cpu at a toy size,
    then cli.eval, cli.render and the viewer on the run it wrote; its
    config.yml reads in the JAX package as the proposal sampler."""
    monkeypatch.chdir(tmp_path)
    root = write_dataset(tmp_path / "scene", SyntheticSceneConfig(
        num_views_train=4, num_views_eval=1, image_size=16, num_bands=8, num_spheres=2))
    flags = ["umhsnerf", "--data", str(root), "--pipeline.num_classes", "2",
             "--pipeline.model.method", "rgb+spectral", "--pipeline.model.sampler", "proposal",
             "--pipeline.model.num-proposal-samples", "32,16",
             "--pipeline.model.num-nerf-samples", "8", "--pipeline.model.hash-num-levels", "4",
             "--pipeline.model.log2-hashmap-size", "10", "--pipeline.model.max-res", "64",
             "--pipeline.model.eval-num-rays-per-chunk", "256",
             "--pipeline.datamanager.train-num-rays-per-batch", "64",
             "--pipeline.datamanager.eval-num-rays-per-batch", "64",
             "--max-num-iterations", "16", "--steps-per-save", "16", "--steps-per-log", "16",
             "--mixed-precision", "False", "--experiment-name", "prop", "--device", "cpu"]
    result = t_train.main(flags)
    trainer = result.trainer
    assert trainer.model.config.sampler == "proposal" and trainer.step == 16
    assert [r["occ_update"] for r in trainer.history] == [None] * 16
    assert np.isfinite(result.evals["psnr"])
    config = trainer.run_dir / "config.yml"
    assert j_configs.load_config(config).pipeline.model.sampler == "proposal"
    assert j_configs.load_config(config).pipeline.model.num_proposal_samples == (32, 16)

    got = t_eval.main(["--load-config", str(config), "--output-path", "eval.json",
                       "--device", "cpu"])
    assert got["results"] == json.loads((trainer.run_dir / "final_metrics.json").read_text())[
        "eval"]
    path = {"render_height": 8, "render_width": 8, "fps": 1, "camera_path": [
        {"camera_to_world": [1, 0, 0, 0, 0, 0, -1, -0.9, 0, 1, 0, 0, 0, 0, 0, 1], "fov": 60.0}]}
    Path("path.json").write_text(json.dumps(path))
    frames = t_render.main(["camera-path", "--load-config", str(config),
                            "--camera-path-filename", "path.json", "--output-path",
                            "renders/out.mp4", "--rendered-output-names", "rgb", "depth",
                            "--device", "cpu"])
    assert frames.images[0].shape == (8, 16, 3)
    server = t_viewer.make_server(["--load-config", str(config), "--port", "0",
                                   "--resolution", "8", "--device", "cpu"])
    try:
        assert server.state.render_view(1.0, 0.4, 1.2, 50.0, "rgb").shape == (8, 8, 3)
    finally:
        server.server_close()
