"""The training slice of umhs_torch against umhs_tpu on the CPU: the partial
occupancy update, pixel sampling, the whole loss with every parameter's
gradient (single-budget and three-stage compact evaluation), the update
schedule, and a short training run.

The JAX side draws its randomness from its own keys; the test replays the
same key splits to hand the port the same draws. The shrunken bench config:
rgb+spectral with the specular residual, 8 bands, 4 classes, a 16^3 x 2
grid with pool 4, hash L4 2^10 tetrahedral, 64 samples per ray, 64 rays,
f32, deterministic hash gradient. The hash table is scaled to +/-1 and the
density output layer by 6 (as in test_torch_model.py), so densities spread
and no occupancy cell sits within rounding of the threshold.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umhs_tpu.data import datamanager as j_dm
from umhs_tpu.models.model import ModelConfig as JModelConfig
from umhs_tpu.models.model import UMHSModel as JModel
from umhs_tpu.parallel.mesh import make_grad_fn
from umhs_torch import convert
from umhs_torch.data import datamanager as t_dm
from umhs_torch.data.synthetic import SyntheticSceneConfig, render_views, scene_cameras
from umhs_torch.engine.trainer import Trainer, TrainerConfig, named_leaves
from umhs_torch.models.model import ModelConfig as TModelConfig
from umhs_torch.models.model import UMHSModel as TModel
from umhs_torch.ops import occupancy as t_occ

KW = dict(
    method="rgb+spectral", pred_specular=True, temperature=0.4,
    grid_resolution=16, grid_levels=2, march_pool=4, max_samples_per_ray=64,
    hash_num_levels=4, log2_hashmap_size=10, max_res=256,
    hash_interpolation="tetrahedral", stage_boundaries=(8, 16),
    stochastic_hash_grad=False,
)
WAVELENGTHS = list(450.0 + 20.0 * np.arange(8))
STEP = 500  # inside the specular ramp
R = 64
NO_SAVE = dict(save_final=False)  # train() calls that end at their target write nothing


def _np(t):
    return t.detach().cpu().numpy()


def _models(kw, num_classes=4, wavelengths=WAVELENGTHS):
    """The JAX and the port's models of config `kw`, the JAX model's
    parameters (hash table scaled to +/-1, density layer by 6) and its full
    occupancy update from them."""
    jm = JModel(JModelConfig(**kw), wavelengths, num_classes=num_classes, num_images=4)
    tm = TModel(TModelConfig(**kw), wavelengths, num_classes=num_classes, num_images=4,
                device="cpu")
    params, occ0 = jm.init(jax.random.PRNGKey(0))
    lay = params["mlp_base"]["layers"]
    params = dict(params, hash_table=params["hash_table"] * 1e4,
                  mlp_base={"layers": lay[:-1] + [dict(lay[-1], w=lay[-1]["w"] * 6.0)]})
    occ = jax.jit(lambda o, p, k: jm.update_occupancy(o, p, k, full=True))(
        occ0, params, jax.random.PRNGKey(3))
    return {"jm": jm, "tm": tm, "params": params, "occ": occ}


def _scene_data(bands, start, step):
    """The 4-view 20^2 test scene at `bands` bands and its data and cameras
    for both packages."""
    scene = SyntheticSceneConfig(num_views_train=4, image_size=20, num_bands=bands,
                                 wavelength_start=start, wavelength_step=step)
    poses, cubes, rgba = render_views(scene, 4, 0.0)
    cams = scene_cameras(scene, poses)
    tcam = cams.to_device_dict()
    return {
        "jdata": {"image": jnp.asarray(rgba), "hs_image": jnp.asarray(cubes)},
        "tdata": {"image": torch.from_numpy(rgba), "hs_image": torch.from_numpy(cubes)},
        "jcam": {k: jnp.asarray(_np(v)) for k, v in tcam.items()}, "tcam": tcam,
        "scene": scene, "cams": cams, "rgba": rgba, "cubes": cubes,
    }


@pytest.fixture(scope="module")
def setup():
    return {**_models(KW), "configs": {}, **_scene_data(8, 450.0, 20.0)}


# ------------------------------------------------------- partial occupancy
def _jax_partial_draws(key, cfg):
    """The draws update_occ_state(full=False) makes from `key`
    (umhs_tpu/ops/occupancy.py:361-409), for the port."""
    k_jit, k_cells = jax.random.split(key)
    draws = []
    for m_uni, m_occ in t_occ.partial_sample_counts(cfg):
        k_cells, k_uni, k_fall, k_rank = jax.random.split(k_cells, 4)
        draws.append({
            "uniform": torch.from_numpy(np.array(jax.random.randint(
                k_uni, (m_uni,), 0, cfg.cells_per_level, dtype=jnp.int32))),
            "u": torch.from_numpy(np.array(jax.random.uniform(k_rank, (m_occ,)))),
            "fallback": torch.from_numpy(np.array(jax.random.randint(
                k_fall, (m_occ,), 0, cfg.cells_per_level, dtype=jnp.int32))),
        })
    m = sum(a + b for a, b in t_occ.partial_sample_counts(cfg))
    return draws, torch.from_numpy(np.array(jax.random.uniform(k_jit, (m, 3))))


def test_partial_occupancy_update_matches_on_cells_probed_once(setup):
    """occs, occs_low (atol 1e-6) and the bitfields agree on every cell the
    update probed once or not at all; a cell probed twice or more keeps the
    largest probe in occs and the smallest in occs_low (the port's rule)."""
    jm, tm, params, occ = setup["jm"], setup["tm"], setup["params"], setup["occ"]
    key = jax.random.PRNGKey(11)
    jout = jax.jit(lambda o, p, k: jm.update_occupancy(o, p, k, full=False))(occ, params, key)
    cfg = tm.occ_config
    draws, jitter = _jax_partial_draws(key, cfg)
    tocc, tparams = convert.occ_state_to_torch(occ), convert.params_to_torch(params)
    tout = tm.update_occupancy(tocc, tparams, jitter, full=False, cell_draws=draws)
    level, cells = t_occ.partial_cells(tocc, cfg, draws)
    flat = level * cfg.cells_per_level + cells
    count = torch.bincount(flat, minlength=tocc["occs"].numel())
    once = count <= 1
    dup = count > 1
    assert int((count == 1).sum()) > 500 and int(dup.sum()) > 10  # both kinds occur
    assert float(tocc["binaries"].float().mean()) > 0.05  # occupied cells get sampled
    for k in ("occs", "occs_low"):
        np.testing.assert_allclose(_np(tout[k])[_np(once)], np.asarray(jout[k])[_np(once)],
                                   rtol=0, atol=1e-6, err_msg=k)
    # the threshold is min(mean(occs), occ_thre), which the duplicate cells
    # move: the bitfields agree on every cell outside the two thresholds' gap
    thre = [min(float(np.mean(o)), cfg.occ_thre) for o in (_np(tout["occs"]), jout["occs"])]
    occs = _np(tout["occs"])
    clear = _np(once) & ((occs < min(thre) - 1e-6) | (occs > max(thre) + 1e-6))
    assert clear.sum() > 0.99 * once.sum().item()
    np.testing.assert_array_equal(_np(tout["binaries"])[clear], np.asarray(jout["binaries"])[clear])
    np.testing.assert_array_equal(_np(tout["binaries"]), occs > thre[0])
    # the duplicate rule, from the probes themselves
    from umhs_torch.models.field import density_fn
    from umhs_torch.ops.occupancy import _level_world_positions
    probe = density_fn(tparams, tm.field_config)(
        _level_world_positions(cfg, level, cells, jitter)) * tm.render_step_size
    new = torch.maximum(tocc["occs"][flat] * cfg.ema_decay, probe)
    best = torch.full_like(tocc["occs"], -1.0).scatter_reduce(0, flat, new, "amax")
    torch.testing.assert_close(tout["occs"][dup], best[dup], rtol=0, atol=0)
    low = torch.minimum(probe, torch.clamp_min(tocc["occs_low"][flat] * 2.0, cfg.occ_thre))
    lowest = torch.full_like(tocc["occs"], 1e30).scatter_reduce(0, flat, low, "amin")
    torch.testing.assert_close(tout["occs_low"][dup], lowest[dup], rtol=0, atol=0)


@pytest.mark.parametrize("every", [1, 2])
def test_occupancy_schedule_matches(setup, every):
    jm = JModel(JModelConfig(**dict(KW, occ_warmup_full_every=every)), WAVELENGTHS,
                num_classes=4, num_images=4)
    tm = TModel(TModelConfig(**dict(KW, occ_warmup_full_every=every)), WAVELENGTHS,
                num_classes=4, num_images=4, device="cpu")
    for step in range(0, 600, 4):
        assert tm.occ_update_due(step) == jm.occ_update_due(step), step
    assert tm.occ_update_due(16) == (True, every == 1)


# ---------------------------------------------------------- pixel batches
@pytest.mark.parametrize("mode", ["pixels", "patches", "valid"])
def test_sample_pixel_batch_matches_jax_draws(setup, mode):
    jdata, tdata = dict(setup["jdata"]), dict(setup["tdata"])
    n, h, w = setup["rgba"].shape[:3]
    patch = 2 if mode == "patches" else 1
    count = R // (patch * patch)
    key = jax.random.PRNGKey(5)
    if mode == "valid":
        valid = np.flatnonzero(setup["rgba"][..., 3] > 0.5).astype(np.int32)
        jdata["valid_indices"] = jnp.asarray(valid)
        tdata["valid_indices"] = torch.from_numpy(valid.astype(np.int64))
        draw = (torch.from_numpy(np.array(jax.random.randint(key, (count,), 0, valid.size))),)
    else:
        k1, k2, k3 = jax.random.split(key, 3)
        draw = tuple(torch.from_numpy(np.array(jax.random.randint(k, (count,), 0, size)))
                     for k, size in ((k1, n), (k2, h), (k3, w)))
    jrays, jbatch = j_dm.sample_pixel_batch(jdata, setup["jcam"], key, R, patch_size=patch)
    trays, tbatch = t_dm.sample_pixel_batch(tdata, setup["tcam"], R, draw, patch_size=patch)
    assert sorted(tbatch) == sorted(jbatch)
    for k in jbatch:
        np.testing.assert_array_equal(_np(tbatch[k]), np.asarray(jbatch[k]), err_msg=k)
    for k in jrays:
        np.testing.assert_allclose(_np(trays[k]), np.asarray(jrays[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    if mode == "valid":
        assert bool((tbatch["image"][:, 3] > 0.5).all())


# ------------------------------------------------------ loss and gradient
# the model configs the experiment scripts run besides the flagship's (KW):
# (KW's fields changed, the classes, the parameters the config leaves out of
# the loss: their JAX gradient is zero and the port's None or zero)
CONFIGS = {
    "flagship": ({}, 4, ()),
    "rgb": ({"method": "rgb"}, 4, ("endmembers", "mlp_directional")),
    "spectral-last-sample": ({"method": "spectral", "background_color": "last_sample"}, 4, ()),
    "no-specular": ({"pred_specular": False}, 4, ("mlp_directional",)),
    "black": ({"background_color": "black"}, 4, ()),
    "white": ({"background_color": "white"}, 4, ()),
    "seven-classes": ({"pred_specular": False}, 7, ("mlp_directional",)),
    # config A's march past the kernels' old limits: 512 samples a ray from
    # 8,192 candidates, 2 a cell (Sc 256, a pre-pass of 1,024 supercells,
    # M 2,048), the third stage 496 lanes
    "config-a-march": ({"max_samples_per_ray": 512, "num_candidates": 8192,
                        "occ_subsamples": 2}, 4, ()),
    # config C past K1-K4's old limits: a hash grid of 40 levels x 7
    # features (mlp_base 280 -> 64 -> 16) on a scene of 281 bands (the
    # specular residual 28 -> 16 -> 281), CONFIG_BANDS
    "config-c": ({"hash_num_levels": 40, "hash_features_per_level": 7}, 4, ()),
}
# the configs on a scene of their own: (bands, first wavelength, step), 400-1000 nm
CONFIG_BANDS = {"config-c": (281, 400.0, 600.0 / 280)}
BUDGETS = {"single": (None, None), "three-stage": ((1024, 1024, 2048), None),
           "three-stage-adapted": ((256, 512, 768), 24)}
# seven classes (ajar.sh's) and config C single-budget only: the file's
# time. Config A's march without the adapted case, which marches 24 samples,
# not 512.
CASES = [pytest.param(config, *BUDGETS[b], id=b if config == "flagship" else f"{config}-{b}")
         for config in CONFIGS for b in BUDGETS
         if (config not in ("seven-classes", "config-c") or b == "single")
         and (config != "config-a-march" or b != "three-stage-adapted")]
# the cases whose JAX step runs op by op, not under jax.jit (slower): at
# config A's march with the single budget, XLA's compile of the whole step
# moves 4 of the 8,192 hash-table gradient entries by up to 3e-4 x max|g|
# from the same step run op by op (this test's own assertion, under
# jax.jit), while the op-by-op step agrees with the port, and the port
# with the f64 sum of its per-sample contributions
# (test_hash_gradient_is_the_f64_sum_at_config_a_march)
EAGER = {("config-a-march", BUDGETS["single"][0])}  # (config, budget)
# the draw's key where the shared one (12) puts a sample within rounding of a
# discrete decision: at config C one of mlp_base's 280-term pre-activations
# lies 8.5e-8 from 0 (the f32 rounding of such a sum is ~1e-7), flips
# between the packages and moves its sample's gradient (every level's hash
# rows, mlp_base and mlp_head) by up to 5e-4 x max|g| while the loss agrees
# (the port's hash gradient stays within 3e-7 x max|g| of the f64 sum of its
# contributions). Of keys 12-23, 14, 15, 17, 20, 21 and 22 pass this test at
# config C; 14 is the first.
DRAW_KEYS = {"config-c": 14}


def _config_models(setup, config):
    if config == "flagship":
        return setup
    if config not in setup["configs"]:
        changes, classes, _ = CONFIGS[config]
        if config in CONFIG_BANDS:
            data = _scene_data(*CONFIG_BANDS[config])
            wavelengths = list(data["scene"].wavelengths)
            setup["configs"][config] = {**_models(dict(KW, **changes), classes, wavelengths),
                                        **data}
        else:
            setup["configs"][config] = {**_models(dict(KW, **changes), classes),
                                        **{k: setup[k] for k in ("jdata", "tdata", "jcam",
                                                                 "tcam")}}
    return setup["configs"][config]


@pytest.mark.parametrize("config,budget,samples", CASES)
def test_loss_and_every_gradient_match_jax(setup, config, budget, samples):
    """The loss within rtol 1e-5, each loss term and metric within 1e-5
    (sample counts exactly), and every parameter's gradient within rtol
    1e-3 and atol 1e-4 * max|g| of that tensor: scans and segment sums add
    in another order. The adapted case marches S = 24 through the
    march_config override, as dynamic batching does, with stage budgets
    below the demand, so each stage drops its overflow (make_grad_fn holds
    each budget at 256 or more). Each config of CONFIGS: the flagship's
    rgb+spectral with the specular residual, and the experiment scripts'
    method rgb, spectral with the last sample's background, no specular
    residual (with 4 and 7 classes), black and white backgrounds; a
    parameter the config leaves out of the loss has a zero JAX gradient and
    none, or a zero one, in the port.

    The draw's key is one whose samples sit clear of every discrete decision
    (ReLU signs, the alpha and transmittance filters, the stage cut-offs):
    with some keys one pre-activation or alpha lands within rounding of its
    threshold, flips between the two packages, and moves a few gradient
    entries by up to ~1e-3 * max|g| while the loss still agrees to 1e-6."""
    models = _config_models(setup, config)
    unused = CONFIGS[config][2]
    jm, tm, params, occ = models["jm"], models["tm"], models["params"], models["occ"]
    rng = jax.random.PRNGKey(DRAW_KEYS.get(config, 12))
    _, k_sample, k_march, k_bg = jax.random.split(rng, 4)
    jrays, jbatch = j_dm.sample_pixel_batch(models["jdata"], models["jcam"], k_sample, R)
    jmarch = tmarch = None
    if samples is not None:
        jmarch = dataclasses.replace(jm.march_config, num_samples=samples)
        tmarch = dataclasses.replace(tm.march_config, num_samples=samples)
    grad_fn = make_grad_fn(jm, None, march_cfg=jmarch, compact_budget=budget)
    if (config, budget) not in EAGER:
        grad_fn = jax.jit(grad_fn)
    jtotal, jloss, jmetrics, jgrads = grad_fn(params, occ, jrays, jbatch, k_march, k_bg,
                                              jnp.int32(STEP))
    jitter = torch.from_numpy(np.array(jax.random.uniform(k_march, (R,))))
    background = torch.from_numpy(np.array(jax.random.uniform(k_bg, (R, 3))))

    idx = torch.from_numpy(np.array(jbatch["indices"]))
    trays, tbatch = t_dm.sample_pixel_batch(models["tdata"], models["tcam"], R,
                                            (idx[:, 0], idx[:, 1], idx[:, 2]))
    tparams = convert.params_to_torch(params)
    for _, t in named_leaves(tparams):
        t.requires_grad_(True)
    out = tm.forward(tparams, convert.occ_state_to_torch(occ), trays, compact_budget=budget,
                     step=STEP, train=True, t_jitter=jitter, march_config=tmarch)
    tloss = tm.loss(out, tbatch, background)
    total = sum(tloss.values())
    total.backward()

    assert float(jtotal) > 0.0
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    assert sorted(tloss) == sorted(jloss)
    for k in jloss:
        np.testing.assert_allclose(float(tloss[k]), float(jloss[k]), rtol=1e-5, err_msg=k)
    tmetrics = tm.metrics({k: v.detach() for k, v in out.items()}, tbatch)
    assert sorted(tmetrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    assert int(tmetrics["num_samples_per_batch"]) > R  # the rays hit the scene
    if budget is not None:
        assert int(tmetrics["num_eval_s3_per_batch"]) > 0
    if samples is not None:
        assert int(out["num_samples_per_ray"].max()) <= samples
        assert int(tmetrics["num_eval_s1_per_batch"]) == budget[0]  # stage 1 overflowed

    jflat = dict(named_leaves(jgrads))
    for name, t in named_leaves(tparams):
        ref = np.asarray(jflat[name])
        if name.split(".")[0] in unused:
            assert np.abs(ref).max() == 0.0, name
            assert t.grad is None or float(t.grad.abs().max()) == 0.0, name
            continue
        assert np.abs(ref).max() > 0.0, name
        np.testing.assert_allclose(_np(t.grad), ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


def test_hash_gradient_is_the_f64_sum_at_config_a_march(setup, monkeypatch):
    """The port's hash-table gradient at config A's march with the single
    budget (the EAGER case above) is the f64 sum of its per-sample
    contributions, each sample's vertex rows and weights
    (hash_indices_weights) times d loss / d encoding, within 1e-6 x
    max|g|: the entries where JAX's jitted step parts from its op-by-op
    step are sums the port takes as exactly as f32 allows."""
    import umhs_torch.models.field as t_field
    from umhs_torch.ops.encodings import hash_indices_weights

    models = _config_models(setup, "config-a-march")
    jm, tm, params, occ = models["jm"], models["tm"], models["params"], models["occ"]
    _, k_sample, k_march, k_bg = jax.random.split(jax.random.PRNGKey(12), 4)
    _, jbatch = j_dm.sample_pixel_batch(setup["jdata"], setup["jcam"], k_sample, R)
    idx = torch.from_numpy(np.array(jbatch["indices"]))
    trays, tbatch = t_dm.sample_pixel_batch(setup["tdata"], setup["tcam"], R,
                                            (idx[:, 0], idx[:, 1], idx[:, 2]))
    seen = {}
    encode = t_field.hash_encode

    def recording(table, unit, cfg, *args, **kwargs):
        enc = encode(table, unit, cfg, *args, **kwargs)
        enc.retain_grad()
        seen["unit"], seen["enc"] = unit.detach(), enc
        return enc

    monkeypatch.setattr(t_field, "hash_encode", recording)
    tparams = convert.params_to_torch(params)
    for _, t in named_leaves(tparams):
        t.requires_grad_(True)
    out = tm.forward(tparams, convert.occ_state_to_torch(occ), trays, step=STEP, train=True,
                     t_jitter=torch.from_numpy(np.array(jax.random.uniform(k_march, (R,)))))
    background = torch.from_numpy(np.array(jax.random.uniform(k_bg, (R, 3))))
    sum(tm.loss(out, tbatch, background).values()).backward()
    cfg = tm.field_config.hash
    F = cfg.features_per_level
    rows, weights = hash_indices_weights(seen["unit"], cfg)  # (N, L, V)
    g = seen["enc"].grad.double().reshape(rows.shape[0], cfg.num_levels, 1, F)
    flat = (rows[..., None] * F + torch.arange(F)).reshape(-1)
    got = tparams["hash_table"].grad.double().reshape(-1)
    want = torch.zeros_like(got).index_add_(0, flat, (weights.double()[..., None] * g).reshape(-1))
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


# ----------------------------------------------------------- training run
def test_cpu_training_run_falls(setup):
    """Trainer(device="cpu") for 32 steps on a tiny config: occupancy
    updates at step 0 (full) and 16 (partial, warmup thinning 2), finite
    losses, and the mean loss of the last 4 steps below that of the first 4."""
    dm = t_dm.InMemoryDataManager(setup["rgba"], setup["cams"], hs_images=setup["cubes"],
                                  config=t_dm.DataManagerConfig(train_num_rays_per_batch=128),
                                  wavelengths=WAVELENGTHS, device="cpu")
    cfg = TModelConfig(**dict(KW, max_samples_per_ray=16, num_candidates=256,
                              stochastic_hash_grad=True, occ_warmup_full_every=2))
    trainer = Trainer(TrainerConfig(seed=0, mixed_precision=False, **NO_SAVE), cfg,
                      num_classes=4, device="cpu", datamanager=dm).setup()
    assert trainer.model.num_images == setup["scene"].num_views_train
    trainer.train(32)
    history = trainer.history
    assert [(r["step"], r["occ_update"]) for r in history if r["occ_update"]] == [
        (0, "full"), (16, "partial")]
    losses = [r["metrics"]["loss/total"] for r in history]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert trainer.state["step"] == 32
    em = trainer.state["params"]["endmembers"]
    assert float(em.min()) >= 0.0 and float(em.max()) <= 1.0  # post_step clamped them


def test_trainer_draws_are_reproducible(setup):
    """Same seed, same draws and the same first step; the step stream and
    the occupancy stream are separate generators."""
    dm = t_dm.InMemoryDataManager(setup["rgba"], setup["cams"], hs_images=setup["cubes"],
                                  config=t_dm.DataManagerConfig(train_num_rays_per_batch=32),
                                  wavelengths=WAVELENGTHS, device="cpu")
    runs = []
    for _ in range(2):
        t = Trainer(TrainerConfig(seed=4, mixed_precision=False),
                    TModelConfig(**dict(KW, max_samples_per_ray=16, num_candidates=256)),
                    num_classes=4, device="cpu", datamanager=dm).setup()
        t.update_occupancy()
        runs.append((t.draw_step(), t.train_step()))
    (d0, m0), (d1, m1) = runs
    for a, b in zip(d0["pixels"], d1["pixels"]):
        assert torch.equal(a, b)
    assert torch.equal(d0["t_jitter"], d1["t_jitter"])
    assert m0 == m1
