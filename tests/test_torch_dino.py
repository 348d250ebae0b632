"""The DINO head (pred_dino) of umhs_torch against umhs_tpu on the CPU: the
parameters, the head at flat samples, the per-ray `dino`, `cluster_probs` and
`inner_products` on the staged compact path and on the padded path, the
NaN-ignoring `dino_mse` and the cluster loss on either side of step 3000, the
detached features (no DINO gradient reaches the hash grid or the base MLP),
and DINO sidecars on disk read by both datamanagers.

The shrunken flagship of tests/test_torch_model.py (16 bands, 6 classes,
32^3 x 2 grid, hash L6 2^12 tetrahedral, 256 rays, S = 32), f32, with the
deterministic hash gradient; the hash table scaled to +/-1 and the density
layer by 6. Tolerances: per-ray values atol 1e-4 (as the occgrid forward's
test), loss terms rtol 1e-5, the DINO leaves' gradients 1e-3 in norm.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umhs_tpu.data import datamanager as j_dm
from umhs_tpu.data.dataparser import DataParserConfig as JDataParserConfig
from umhs_tpu.models import field as j_field
from umhs_tpu.models.model import ModelConfig as JModelConfig
from umhs_tpu.models.model import UMHSModel as JModel
from umhs_torch import convert
from umhs_torch.data import datamanager as t_dm
from umhs_torch.data.cameras import generate_camera_rays
from umhs_torch.data.dataparser import DataParserConfig as TDataParserConfig
from umhs_torch.data.synthetic import (
    SyntheticSceneConfig, render_views, scene_cameras, write_dataset, write_dino_sidecars)
from umhs_torch.engine.trainer import named_leaves
from umhs_torch.models import field as t_field
from umhs_torch.models.model import ModelConfig as TModelConfig
from umhs_torch.models.model import UMHSModel as TModel

MODEL_KW = dict(
    method="rgb+spectral", pred_specular=True, pred_dino=True, temperature=0.4,
    grid_resolution=32, grid_levels=2, march_pool=4, max_samples_per_ray=32,
    hash_num_levels=6, log2_hashmap_size=12, max_res=256,
    hash_interpolation="tetrahedral", stage_boundaries=(8, 16), stochastic_hash_grad=False,
)
WAVELENGTHS = list(450.0 + 10.0 * np.arange(16))
STEP = 500
R = 256
BUDGETS = (1024, 1024, 2048)  # one per stage: the staged compact path
DINO_KEYS = ("dino", "cluster_probs", "inner_products")


def _np(t):
    return t.detach().cpu().numpy()


def _models(**over):
    kw = dict(MODEL_KW, **over)
    return (JModel(JModelConfig(**kw), WAVELENGTHS, num_classes=6, num_images=4),
            TModel(TModelConfig(**kw), WAVELENGTHS, num_classes=6, num_images=4, device="cpu"))


@pytest.fixture(scope="module")
def state():
    jm, tm = _models()
    params, occ0 = jm.init(jax.random.PRNGKey(0))
    lay = params["mlp_base"]["layers"]
    params = dict(params, hash_table=params["hash_table"] * 1e4,
                  mlp_base={"layers": lay[:-1] + [dict(lay[-1], w=lay[-1]["w"] * 6.0)]})
    occ = jax.jit(lambda o, p, k: jm.update_occupancy(o, p, k, full=True))(
        occ0, params, jax.random.PRNGKey(3))
    scene = SyntheticSceneConfig(image_size=20, num_bands=16)
    poses, _, _ = render_views(scene, 2, 0.13)
    rays = generate_camera_rays(scene_cameras(scene, poses).to_device_dict(), 0, 20, 20)
    rays = {k: v[:R] for k, v in rays.items()}
    return {"jm": jm, "tm": tm, "params": params, "occ": occ, "rays": rays,
            "tparams": convert.params_to_torch(params), "tocc": convert.occ_state_to_torch(occ)}


@pytest.fixture(scope="module")
def staged(state):
    return _forward_both(state, True)


def _forward_both(state, compact):
    """The eval forward of each package, staged compact or padded."""
    jm, tm = (state["jm"], state["tm"]) if compact else _models(compact_samples=False)
    budget = BUDGETS if compact else None
    jrays = {k: jnp.asarray(_np(v)) for k, v in state["rays"].items()}
    jo = jax.jit(lambda p, o, r: jm.forward(p, o, r, rng=None, train=False,
                                            compact_budget=budget, step=jnp.int32(STEP)))(
        state["params"], state["occ"], jrays)
    to = tm.forward(state["tparams"], state["tocc"], state["rays"], compact_budget=budget,
                    step=STEP)
    return jo, to


def test_dino_parameters_match_and_come_last():
    """dino_mlp 15 -> 256 -> 128 and dino_clusters (K, 128), shapes as in
    JAX; drawn after the field's other leaves, which keep their bits."""
    jm, tm = _models()
    jparams, _ = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tparams, _ = tm.init(torch.Generator().manual_seed(0))
    assert convert._map(tparams, lambda t: tuple(t.shape)) == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jparams)
    assert [tuple(la["w"].shape) for la in tparams["dino_mlp"]["layers"]] == [(15, 256),
                                                                             (256, 128)]
    assert tuple(tparams["dino_clusters"].shape) == (6, 128)
    _, plain_model = _models(pred_dino=False)
    plain, _ = plain_model.init(torch.Generator().manual_seed(0))
    assert sorted(plain) == sorted(k for k in tparams if not k.startswith("dino_"))
    for name, t in named_leaves(plain):
        assert torch.equal(t, dict(named_leaves(tparams))[name]), name


def test_dino_head_matches_at_flat_samples(state):
    jcfg, tcfg = state["jm"].field_config, state["tm"].field_config
    rng = np.random.default_rng(11)
    pos = rng.uniform(-1.8, 1.8, (500, 3)).astype(np.float32)
    dirs = rng.normal(size=(500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cam = np.zeros(500, np.int32)
    _, tg = t_field.field_density(state["tparams"], tcfg, torch.from_numpy(pos))

    def heads(p, x, d, c):
        _, g = j_field.field_density(p, jcfg, x)
        return j_field.field_outputs(p, jcfg, x, d, c, g, train=False, step=jnp.int32(STEP))

    jo = jax.jit(heads)(state["params"], jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(cam))
    to = t_field.field_outputs(state["tparams"], tcfg, torch.from_numpy(pos),
                               torch.from_numpy(dirs), torch.from_numpy(cam), tg,
                               train=False, step=STEP)
    assert tuple(to["dino"].shape) == (500, 128)
    np.testing.assert_allclose(_np(to["dino"]), np.asarray(jo["dino"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compact", [True, False], ids=["compact-staged", "padded"])
def test_dino_outputs_match_jax(state, staged, compact):
    jo, to = staged if compact else _forward_both(state, False)
    for k in DINO_KEYS:
        assert tuple(to[k].shape) == tuple(jo[k].shape) == ((R, 128) if k == "dino" else (R, 6))
        np.testing.assert_allclose(_np(to[k]), np.asarray(jo[k]), rtol=0, atol=1e-4, err_msg=k)
    assert float(to["dino"].abs().max()) > 1e-3
    assert torch.equal(to["cluster_probs"].sum(1), torch.ones(R))  # one-hot
    if compact:
        assert "num_eval_s3_per_ray" in to  # three stages


@pytest.mark.parametrize("step", [3000, 3001])
def test_dino_losses_match_jax(state, staged, step):
    """dino_mse ignores the NaNs of the features (torch.nanmean, as
    jnp.nanmean); the cluster loss counts only past step 3000."""
    jo, to = staged
    rng = np.random.default_rng(step)
    feat = rng.normal(size=(R, 128)).astype(np.float32)
    feat[rng.random((R, 128)) < 0.1] = np.nan
    feat[:5] = np.nan
    batch = {"image": rng.uniform(0, 1, (R, 4)).astype(np.float32),
             "hs_image": rng.uniform(0, 1, (R, 16)).astype(np.float32), "dino_feat": feat}
    k_bg = jax.random.PRNGKey(9)
    jl = state["jm"].loss(jo, {k: jnp.asarray(v) for k, v in batch.items()}, k_bg, step=step)
    tl = state["tm"].loss(to, {k: torch.from_numpy(v) for k, v in batch.items()},
                          torch.from_numpy(np.array(jax.random.uniform(k_bg, (R, 3)))),
                          step=step)
    assert sorted(tl) == sorted(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, err_msg=k)
    assert np.isfinite(float(tl["dino_mse"])) and float(tl["dino_mse"]) > 0
    assert (float(tl["cluster_loss"]) != 0.0) == (step > 3000)


def test_no_dino_gradient_reaches_the_field(state):
    """On the training forward at step 3001: the DINO terms' gradient reaches
    dino_mlp and dino_clusters and nothing else; the hash table's gradient
    of the whole loss is the same bits with them or without them; the DINO
    leaves' gradients equal jax.grad's (padded path) in norm."""
    jm, tm = _models(compact_samples=False)
    tparams = convert.params_to_torch(state["params"])
    for _, t in named_leaves(tparams):
        t.requires_grad_(True)
    rng = np.random.default_rng(5)
    batch = {"image": rng.uniform(0, 1, (R, 4)).astype(np.float32),
             "hs_image": rng.uniform(0, 1, (R, 16)).astype(np.float32),
             "dino_feat": rng.normal(size=(R, 128)).astype(np.float32)}
    out = tm.forward(tparams, state["tocc"], state["rays"], step=3001)
    loss = tm.loss(out, {k: torch.from_numpy(v) for k, v in batch.items()}, step=3001,
                   background=torch.full((R, 3), 0.5))
    dino_terms = loss["dino_mse"] + loss["cluster_loss"]
    rest = sum(v for k, v in loss.items() if k not in ("dino_mse", "cluster_loss"))
    names, leaves = zip(*named_leaves(tparams))
    g_dino = torch.autograd.grad(dino_terms, leaves, retain_graph=True, allow_unused=True)
    g_rest = torch.autograd.grad(rest, leaves, retain_graph=True, allow_unused=True)
    g_all = torch.autograd.grad(rest + dino_terms, leaves, allow_unused=True)
    reached = {n for n, g in zip(names, g_dino) if g is not None and bool(g.any())}
    assert reached == {"dino_clusters", "dino_mlp.layers.0.b", "dino_mlp.layers.0.w",
                       "dino_mlp.layers.1.b", "dino_mlp.layers.1.w"}
    i = names.index("hash_table")
    assert torch.equal(g_all[i], g_rest[i])

    def dino_loss(p):
        o = jm.forward(p, state["occ"], {k: jnp.asarray(_np(v)) for k, v in state["rays"].items()},
                       rng=None, train=False, step=jnp.int32(3001))
        lj = jm.loss(o, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
                     step=3001)
        return lj["dino_mse"] + lj["cluster_loss"]

    jg = dict(named_leaves(jax.jit(jax.grad(dino_loss))(state["params"])))
    assert not np.asarray(jg["hash_table"]).any()
    for n, g in zip(names, g_dino):
        if n in reached:
            ref = np.asarray(jg[n])
            assert np.linalg.norm(_np(g) - ref) <= 1e-3 * np.linalg.norm(ref), n


def test_dino_sidecars_load_as_in_the_jax_datamanager(tmp_path, monkeypatch):
    """write_dino_sidecars' (C, H, W) .pt files: both datamanagers stage the
    same (N, H, W, C) dino_feat, and the same pixels give the same features."""
    monkeypatch.chdir(tmp_path)
    root = write_dataset(tmp_path / "scene", SyntheticSceneConfig(
        num_views_train=3, num_views_eval=1, image_size=8, num_bands=4, num_spheres=1))
    write_dino_sidecars(root, dim=16, seed=2)
    frame = json.loads((root / "transforms.json").read_text())["frames"][0]
    assert tuple(torch.load(root / frame["dino_file_path"]).shape) == (16, 8, 8)
    jd = j_dm.UMHSDataManager(j_dm.DataManagerConfig(dataparser=JDataParserConfig(data=root)))
    td = t_dm.UMHSDataManager(t_dm.DataManagerConfig(dataparser=TDataParserConfig(data=root)),
                              device="cpu")
    jdata, jcam = jd.train_device_data()
    assert tuple(td.data["dino_feat"].shape) == (3, 8, 8, 16)
    np.testing.assert_array_equal(_np(td.data["dino_feat"]), np.asarray(jdata["dino_feat"]))
    key = jax.random.PRNGKey(4)
    k1, k2, k3 = jax.random.split(key, 3)
    draw = tuple(torch.from_numpy(np.array(jax.random.randint(k, (32,), 0, size)))
                 for k, size in ((k1, 3), (k2, 8), (k3, 8)))
    _, jbatch = j_dm.sample_pixel_batch(jdata, jcam, key, 32)
    _, tbatch = t_dm.sample_pixel_batch(td.data, td.cam, 32, draw)
    np.testing.assert_array_equal(_np(tbatch["dino_feat"]), np.asarray(jbatch["dino_feat"]))
    _, jeval, _ = jd.eval_image(0)
    _, teval, _ = td.eval_image(0)
    np.testing.assert_array_equal(_np(teval["dino_feat"]), np.asarray(jeval["dino_feat"]))
