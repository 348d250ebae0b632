"""The render slice of umhs_torch against umhs_tpu on the CPU: field,
occupancy update, march, forward (single-budget and staged) and
render_camera, on a shrunken flagship (16 bands, 32^3 x 2 grid with pool 4,
hash L6xF2 2^12 tetrahedral, R = 256, S = 32).

Weights and the occupancy state come from the JAX package (UMHSModel.init,
update_occ_state) and reach the port through umhs_torch.convert. The hash
table is scaled to +/-1 and the density output layer by 6, so densities
spread over two decades: with the near-constant density of a fresh init,
thousands of cells sit within rounding of the occupancy threshold (the grid
mean) and a one-ulp difference in a matmul's summation order would flip
them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umhs_tpu.models import field as j_field
from umhs_tpu.models.model import ModelConfig as JModelConfig
from umhs_tpu.models.model import UMHSModel as JModel
from umhs_tpu.ops import occupancy as j_occ
from umhs_tpu.ops import ray_marching as j_march
from umhs_tpu.parallel.mesh import make_eval_forward
from umhs_torch import convert
from umhs_torch.data.cameras import generate_camera_rays
from umhs_torch.data.synthetic import SyntheticSceneConfig, render_views, scene_cameras
from umhs_torch.engine.trainer import Trainer, TrainerConfig
from umhs_torch.models import field as t_field
from umhs_torch.models.model import ModelConfig as TModelConfig
from umhs_torch.models.model import UMHSModel as TModel
from umhs_torch.ops import occupancy as t_occ
from umhs_torch.ops import ray_marching as t_march

MODEL_KW = dict(
    method="rgb+spectral", pred_specular=True, temperature=0.4,
    grid_resolution=32, grid_levels=2, march_pool=4, max_samples_per_ray=32,
    hash_num_levels=6, log2_hashmap_size=12, max_res=256,
    hash_interpolation="tetrahedral", stage_boundaries=(8, 16),
)
WAVELENGTHS = list(450.0 + 10.0 * np.arange(16))
STEP = 500  # inside the specular ramp
FORWARD_KEYS = ("rgb", "spectral", "spectral2", "specular", "abundances", "accumulation",
                "depth", "num_samples_per_ray", "num_occupied_per_ray",
                "num_eval_s1_per_ray", "num_eval_s2_per_ray", "seg_raw")


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def slice_state():
    jm = JModel(JModelConfig(**MODEL_KW), WAVELENGTHS, num_classes=6, num_images=4)
    tm = TModel(TModelConfig(**MODEL_KW), WAVELENGTHS, num_classes=6, num_images=4,
                device="cpu")
    params, occ0 = jm.init(jax.random.PRNGKey(0))
    lay = params["mlp_base"]["layers"]
    params = dict(params, hash_table=params["hash_table"] * 1e4,
                  mlp_base={"layers": lay[:-1] + [dict(lay[-1], w=lay[-1]["w"] * 6.0)]})
    key = jax.random.PRNGKey(3)
    occ = jax.jit(lambda o, p, k: jm.update_occupancy(o, p, k, full=True))(occ0, params, key)
    # the jitter update_occ_state draws from its key, for the port
    k_jit, _ = jax.random.split(key)
    jitter = np.array(jax.random.uniform(k_jit, (2 * 32**3, 3)))
    scene = SyntheticSceneConfig(image_size=20, num_bands=16)
    poses, _, _ = render_views(scene, 2, 0.13)
    cam = scene_cameras(scene, poses).to_device_dict()
    return {
        "jm": jm, "tm": tm, "params": params, "occ0": occ0, "occ": occ, "jitter": jitter,
        "tparams": convert.params_to_torch(params), "tocc": convert.occ_state_to_torch(occ),
        "cam": cam,
    }


def _rays(state, n=256):
    rays = generate_camera_rays(state["cam"], 0, 20, 20)
    return {k: v[:n] for k, v in rays.items()}


def _jrays(rays):
    return {k: jnp.asarray(_np(v)) for k, v in rays.items()}


# ----------------------------------------------------------------- field
def test_model_init_matches_tree(slice_state):
    tparams, _ = slice_state["tm"].init(torch.Generator().manual_seed(0))
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), slice_state["params"])
    tshapes = convert._map(tparams, lambda t: tuple(t.shape))
    assert tshapes == jshapes
    assert float(tparams["hash_table"].abs().max()) <= 1e-4
    tocc = t_occ.init_occ_state(slice_state["tm"].occ_config)
    jocc = convert.occ_state_to_numpy(tocc)
    assert {k: v.shape for k, v in jocc.items()} == {
        k: tuple(v.shape) for k, v in slice_state["occ0"].items()}


def test_field_matches(slice_state):
    jcfg, tcfg = slice_state["jm"].field_config, slice_state["tm"].field_config
    rng = np.random.default_rng(11)
    pos = rng.uniform(-1.8, 1.8, (700, 3)).astype(np.float32)
    dirs = rng.normal(size=(700, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cam = np.zeros(700, np.int32)
    jd, jg = j_field.field_density(slice_state["params"], jcfg, jnp.asarray(pos))
    td, tg = t_field.field_density(slice_state["tparams"], tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-5, atol=1e-5)
    jo = j_field.field_outputs(slice_state["params"], jcfg, jnp.asarray(pos), jnp.asarray(dirs),
                               jnp.asarray(cam), jg, train=False, step=jnp.int32(STEP))
    to = t_field.field_outputs(slice_state["tparams"], tcfg, torch.from_numpy(pos),
                               torch.from_numpy(dirs), torch.from_numpy(cam), tg,
                               train=False, step=STEP)
    assert sorted(to) == sorted(jo) == ["abundances", "spectral", "spectral2", "specular"]
    for k in jo:
        np.testing.assert_allclose(_np(to[k]), np.asarray(jo[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_field_rgb_method_matches():
    kw = dict(method="rgb", num_images=3, appearance_embedding_dim=4,
              use_average_appearance_embedding=True)
    jhash = dict(num_levels=4, log2_hashmap_size=10, max_resolution=64)
    jcfg = j_field.FieldConfig(hash=j_field.HashEncodingConfig(**jhash), **kw)
    tcfg = t_field.FieldConfig(hash=t_field.HashEncodingConfig(**jhash), **kw)
    params = j_field.init_field_params(jax.random.PRNGKey(5), jcfg)
    tparams = convert.params_to_torch(params)
    rng = np.random.default_rng(12)
    pos = rng.uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
    dirs = rng.normal(size=(300, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cam = rng.integers(0, 3, 300).astype(np.int32)
    jd, jg = j_field.field_density(params, jcfg, jnp.asarray(pos))
    td, tg = t_field.field_density(tparams, tcfg, torch.from_numpy(pos))
    for train in (True, False):
        jo = j_field.field_outputs(params, jcfg, jnp.asarray(pos), jnp.asarray(dirs),
                                   jnp.asarray(cam), jg, train=train)
        to = t_field.field_outputs(tparams, tcfg, torch.from_numpy(pos),
                                   torch.from_numpy(dirs), torch.from_numpy(cam), tg,
                                   train=train)
        np.testing.assert_allclose(_np(to["rgb"]), np.asarray(jo["rgb"]), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- occupancy
def test_occupancy_full_update_matches(slice_state):
    tm, occ = slice_state["tm"], slice_state["occ"]
    tocc0 = convert.occ_state_to_torch(slice_state["occ0"])
    jitter = torch.from_numpy(slice_state["jitter"])
    tout = tm.update_occupancy(tocc0, slice_state["tparams"], jitter)
    assert 0.1 < float(np.mean(np.asarray(occ["binaries"]))) < 0.9  # a non-trivial grid
    for k in ("binaries", "binaries_pooled", "packed_words"):
        np.testing.assert_array_equal(convert.occ_state_to_numpy(tout)[k], np.asarray(occ[k]),
                                      err_msg=k)
    for k in ("occs", "occs_low"):
        np.testing.assert_allclose(_np(tout[k]), np.asarray(occ[k]), rtol=0, atol=1e-6)


def test_packed_and_pooled_queries_match(slice_state):
    tm, occ, tocc = slice_state["tm"], slice_state["occ"], slice_state["tocc"]
    cfg = tm.occ_config
    pos = np.random.default_rng(13).uniform(-2.2, 2.2, (5000, 3)).astype(np.float32)
    tp, jp = torch.from_numpy(pos), jnp.asarray(pos)
    fine = t_occ.query_packed_occupancy(tocc["packed_words"], tp, cfg)
    np.testing.assert_array_equal(_np(fine), _np(t_occ.query_occupancy(tocc["binaries"], tp, cfg)))
    np.testing.assert_array_equal(
        _np(fine), np.asarray(j_occ.query_packed_occupancy(occ["packed_words"], jp,
                                                           slice_state["jm"].occ_config)))
    sup = t_occ.query_packed_supercell(tocc["packed_words"], tp, cfg)
    np.testing.assert_array_equal(
        _np(sup), _np(t_occ.query_occupancy(tocc["binaries_pooled"], tp, cfg, res=8)))
    np.testing.assert_array_equal(
        _np(sup), np.asarray(j_occ.query_packed_supercell(occ["packed_words"], jp,
                                                          slice_state["jm"].occ_config)))
    full = t_occ.mark_all_occupied(tocc)
    assert bool(t_occ.query_packed_occupancy(full["packed_words"], tp, cfg)[
        torch.amax(torch.abs(tp), -1) <= 2.0].all())


# ------------------------------------------------------------------ march
@pytest.mark.parametrize("path", ["packed", "bitfield"])
@pytest.mark.parametrize("total_budget", [None, 1500])
def test_march_matches(slice_state, path, total_budget):
    jm, tm, occ = slice_state["jm"], slice_state["tm"], slice_state["occ"]
    tocc = dict(slice_state["tocc"])
    rays = _rays(slice_state)
    jkw = dict(binaries_pooled=occ["binaries_pooled"])
    if path == "packed":
        jkw["packed_words"] = occ["packed_words"]
    else:
        del tocc["packed_words"]
    jr = j_march.march_rays(occ["binaries"], jm.occ_config, jm.march_config,
                            jnp.asarray(_np(rays["origins"])), jnp.asarray(_np(rays["directions"])),
                            total_budget=total_budget, **jkw)
    tr = t_march.march_rays(tocc, tm.occ_config, tm.march_config, rays["origins"],
                            rays["directions"], total_budget=total_budget)
    for k in ("mask", "num_samples", "num_occupied"):
        np.testing.assert_array_equal(_np(tr[k]), np.asarray(jr[k]), err_msg=k)
    for k in ("t_starts", "t_ends"):
        np.testing.assert_allclose(_np(tr[k]), np.asarray(jr[k]), rtol=1e-6, atol=0, err_msg=k)
    assert int(tr["num_samples"].sum()) > 0
    if total_budget is not None:
        assert int(tr["num_samples"].sum()) <= total_budget


def test_march_od_culling_matches(slice_state):
    jm, tm, occ = slice_state["jm"], slice_state["tm"], slice_state["occ"]
    rays = _rays(slice_state)
    jmc = dataclasses.replace(jm.march_config, early_stop_od=0.5)
    tmc = dataclasses.replace(tm.march_config, early_stop_od=0.5)
    jr = j_march.march_rays(occ["binaries"], jm.occ_config, jmc,
                            jnp.asarray(_np(rays["origins"])), jnp.asarray(_np(rays["directions"])),
                            binaries_pooled=occ["binaries_pooled"], occs=occ["occs_low"])
    tr = t_march.march_rays(slice_state["tocc"], tm.occ_config, tmc, rays["origins"],
                            rays["directions"])
    plain = t_march.march_rays(slice_state["tocc"], tm.occ_config, tm.march_config,
                               rays["origins"], rays["directions"])
    assert int(tr["num_occupied"].sum()) < int(plain["num_occupied"].sum())  # it culled
    for k in ("mask", "num_samples", "num_occupied"):
        np.testing.assert_array_equal(_np(tr[k]), np.asarray(jr[k]), err_msg=k)
    np.testing.assert_allclose(_np(tr["t_starts"]), np.asarray(jr["t_starts"]), rtol=1e-6)


def test_candidate_schedule_matches():
    march = j_march.MarchConfig(num_candidates=300, cone_angle=0.004)
    t0 = np.random.default_rng(14).uniform(0.05, 3.0, 64).astype(np.float32)
    jt, jd = j_march.candidate_ts(jnp.asarray(t0), march)
    tt, td = t_march.candidate_ts(torch.from_numpy(t0), t_march.MarchConfig(
        num_candidates=300, cone_angle=0.004))
    np.testing.assert_allclose(_np(tt), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=1e-6)


# ---------------------------------------------------------------- forward
def _denser(params, shift):
    """Params whose density logit is raised by `shift` (e^shift denser)."""
    lay = params["mlp_base"]["layers"]
    last = dict(lay[-1], b=lay[-1]["b"].at[0].add(shift))
    return dict(params, mlp_base={"layers": lay[:-1] + [last]})


@pytest.mark.parametrize(
    "budget,shift",
    [(None, 0.0), ((1024, 1024, 2048), 0.0), ((2048, 2048, 4096), 3.0)],
    ids=["single", "staged-overflow", "staged-termination"],
)
def test_forward_matches(slice_state, budget, shift):
    jm, tm = slice_state["jm"], slice_state["tm"]
    params = _denser(slice_state["params"], shift)
    rays = _rays(slice_state)
    jo = jax.jit(lambda p, o, r: jm.forward(p, o, r, rng=None, train=False,
                                            compact_budget=budget, step=jnp.int32(STEP)))(
        params, slice_state["occ"], _jrays(rays))
    to = tm.forward(convert.params_to_torch(params), slice_state["tocc"], rays,
                    compact_budget=budget, step=STEP)
    keys = FORWARD_KEYS + (("num_eval_s3_per_ray",) if budget else ())
    assert set(keys) <= set(to)
    for k in keys:
        np.testing.assert_allclose(_np(to[k]).astype(np.float64), np.asarray(jo[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
    assert float(to["accumulation"].max()) > 0.5  # the rays hit something
    if shift:  # exact termination skipped part of the later stages
        lanes = (to["num_samples_per_ray"] - 16).clamp_min(0).sum()
        assert 0 < int(to["num_eval_s3_per_ray"].sum()) < int(lanes)


def test_forward_uncompacted_matches(slice_state):
    kw = dict(MODEL_KW, compact_samples=False)
    jm = JModel(JModelConfig(**kw), WAVELENGTHS, num_classes=6, num_images=4)
    tm = TModel(TModelConfig(**kw), WAVELENGTHS, num_classes=6, num_images=4, device="cpu")
    rays = _rays(slice_state, n=64)
    jo = jax.jit(lambda p, o, r: jm.forward(p, o, r, rng=None, train=False,
                                            step=jnp.int32(STEP)))(
        slice_state["params"], slice_state["occ"], _jrays(rays))
    to = tm.forward(slice_state["tparams"], slice_state["tocc"], rays, step=STEP)
    for k in FORWARD_KEYS:
        np.testing.assert_allclose(_np(to[k]).astype(np.float64), np.asarray(jo[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("background", ["black", "white"])
def test_blend_background_matches(slice_state, background):
    kw = dict(MODEL_KW, background_color=background)
    jm = JModel(JModelConfig(**kw), WAVELENGTHS, num_classes=6, num_images=4)
    tm = TModel(TModelConfig(**kw), WAVELENGTHS, num_classes=6, num_images=4, device="cpu")
    img = np.random.default_rng(15).uniform(size=(7, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(_np(tm.blend_background(torch.from_numpy(img))),
                               np.asarray(jm.blend_background(jnp.asarray(img))), atol=1e-7)
    assert tm.blend_background(torch.from_numpy(img[..., :3])).shape == (7, 5, 3)


def test_render_camera_matches(slice_state):
    jm = slice_state["jm"]
    rays = generate_camera_rays(slice_state["cam"], 1, 20, 20)
    trainer = Trainer(TrainerConfig(mixed_precision=False), TModelConfig(**MODEL_KW),
                      WAVELENGTHS, num_classes=6, num_images=4, device="cpu")
    trainer.state = {"params": slice_state["tparams"], "occ": slice_state["tocc"], "step": STEP}
    out = trainer.render_camera(rays, (20, 20), chunk=256)

    # JAX: the padded chunks of trainer.py:1192-1208 through make_eval_forward
    n, chunk, num_chunks = 400, 256, 2
    pad = num_chunks * chunk - n
    padded = {}
    for k, v in rays.items():
        v = _np(v)
        fill = np.zeros((pad, *v.shape[1:]), v.dtype)
        if k == "directions":
            fill[:] = [0.0, 0.0, 1.0]
        padded[k] = np.concatenate([v, fill])
    fwd = jax.jit(make_eval_forward(jm, None))
    outs = [fwd(slice_state["params"], slice_state["occ"],
                {k: jnp.asarray(v[c * chunk:(c + 1) * chunk]) for k, v in padded.items()},
                jax.random.PRNGKey(0), jnp.int32(STEP))
            for c in range(num_chunks)]
    for k in ("rgb", "spectral", "accumulation", "depth", "abundances", "seg_raw"):
        ref = np.concatenate([np.asarray(o[k]).reshape(chunk, -1) for o in outs])[:n]
        assert out[k].shape[:2] == (20, 20)
        np.testing.assert_allclose(_np(out[k]).reshape(n, -1), ref, rtol=0, atol=1e-4, err_msg=k)


def test_trainer_setup_and_occupancy_update_on_cpu():
    cfg = dataclasses.replace(TModelConfig(**MODEL_KW), grid_resolution=16)
    trainer = Trainer(TrainerConfig(seed=1), cfg, WAVELENGTHS, num_classes=6, num_images=4,
                      device="cpu").setup(endmembers_init=np.full((6, 16), 0.5, np.float32))
    assert trainer.model.field_config.compute_dtype == torch.bfloat16  # mixed precision
    assert float(trainer.state["params"]["endmembers"].min()) == 0.5
    trainer.update_occupancy()
    occ = trainer.state["occ"]
    assert float(occ["occs"].min()) > 0.0
    assert 0 < int(occ["binaries"].sum()) < occ["binaries"].numel()
