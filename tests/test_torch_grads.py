"""The gradients of umhs_torch against umhs_tpu on the CPU: trunc_exp's
custom backward, K2's plain version (autograd of mlp_plain) against the
Pallas backward in interpret mode, the hash grid's backward (deterministic
against the JAX custom VJP, stochastic by its properties), and the Adam
update with the learning-rate schedule against optax.

Inputs are seeded numpy arrays handed to both sides; everything is f32 (or
bf16 where named), TF32 does not arise on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from umhs_tpu.engine import trainer as j_trainer
from umhs_tpu.models import field as j_field
from umhs_tpu.ops import activations as j_act
from umhs_tpu.ops import encodings as j_enc
from umhs_tpu.ops.pallas.mlp_fused import mlp_apply_fused
from umhs_torch.data.datamanager import InMemoryDataManager
from umhs_torch.data.synthetic import (
    SyntheticSceneConfig, ray_samples, render_views, scene_cameras)
from umhs_torch.engine import trainer as t_trainer
from umhs_torch.engine.trainer import Trainer, TrainerConfig, named_leaves
from umhs_torch.models import field as t_field
from umhs_torch.models.model import ModelConfig
from umhs_torch.ops import encodings as t_enc
from umhs_torch.ops.activations import trunc_exp
from umhs_torch.ops.mlp import apply_mlp
from umhs_torch.ops.mlp_fused import mlp_fused, mlp_fused_bwd, mlp_plain_bwd


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- trunc_exp
def test_trunc_exp_gradient_matches_jax():
    """Forward and backward to 1e-6 relative, the clamped range included:
    beyond |x| = 15 the gradient is g * exp(+-15), not 0."""
    x = np.concatenate([np.linspace(-20, 20, 101), [-15.0, 15.0, 0.0]]).astype(np.float32)
    g = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    jy, jvjp = jax.vjp(j_act.trunc_exp, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = trunc_exp(xt)
    y.backward(_t(g))
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-6)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jvjp(jnp.asarray(g))[0]), rtol=1e-6)
    assert float(xt.grad[0]) == pytest.approx(float(g[0]) * np.exp(-15.0), rel=1e-6)


# -------------------------------------------------------- K2 plain version
def _chain(dims, seed):
    rng = np.random.default_rng(seed)
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        lim = 1.0 / np.sqrt(din)
        layers.append({"w": rng.uniform(-lim, lim, (din, dout)).astype(np.float32),
                       "b": rng.uniform(-lim, lim, (dout,)).astype(np.float32)})
    jp = {"layers": [{k: jnp.asarray(v) for k, v in lay.items()} for lay in layers]}
    tp = {"layers": [{k: _t(v) for k, v in lay.items()} for lay in layers]}
    return jp, tp


@pytest.mark.parametrize(
    "dims,n,dtype,tol",
    [
        ([32, 64, 16], 300, "float32", 1e-4),  # mlp_base
        ([27, 64, 64, 7], 300, "float32", 1e-4),  # feature_mlp
        ([27, 64, 64, 6], 300, "bfloat16", 2e-2),  # mlp_head
        ([28, 16, 128], 300, "float32", 1e-4),  # mlp_directional
        ([28, 16, 128], 1300, "bfloat16", 2e-2),  # N not a multiple of the tile
        ([27, 64, 64, 7], 1300, "float32", 1e-4),
        ([32, 16], 700, "float32", 1e-4),  # a single layer
        ([27, 64, 64, 7], 1, "bfloat16", 2e-2),  # one row: the tensor-core K2's tile edges
        ([32, 64, 16], 17, "bfloat16", 2e-2),
        ([28, 16, 128], 33, "bfloat16", 2e-2),
        # the DINO head, on K2's wide route on the card: N off the 1024 tile, 1, 33
        ([15, 256, 128], 1300, "bfloat16", 2e-2),
        ([15, 256, 128], 1300, "float32", 1e-4),
        ([15, 256, 128], 1, "bfloat16", 2e-2),
        ([15, 256, 128], 1, "float32", 1e-4),
        ([15, 256, 128], 33, "bfloat16", 2e-2),
        ([15, 256, 128], 33, "float32", 1e-4),
        ([32, 256, 64, 8], 1300, "bfloat16", 2e-2),  # three layers wider than 128
        ([32, 256, 64, 8], 1300, "float32", 1e-4),
        # the chains past the kernels' old limits, the general route on the
        # card: 281 bands, 280 hash features, weights past shared memory, and
        # ten layers
        *[(dims, n, dt, 1e-4 if dt == "float32" else 2e-2)
          for dims, n in (([28, 16, 281], 200), ([280, 64, 16], 200),
                          ([64, 256, 256, 256], 100), ([24] + [32] * 9 + [8], 200))
          for dt in ("float32", "bfloat16")],
    ],
)
def test_k2_plain_matches_pallas_backward_interpret(dims, n, dtype, tol):
    """dx, every dW and db: f32 within 1e-4 (as tests/test_pallas_mlp.py),
    bf16 within 2e-2, both relative with an atol of tol times the tensor's
    largest entry (dW and db sum over all N rows)."""
    jp, tp = _chain(dims, seed=len(dims) + n)
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, dims[0])).astype(np.float32)
    g = rng.normal(size=(n, dims[-1])).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(p, xx):
        return jnp.sum(mlp_apply_fused(p, xx, compute_dtype=jdt) * jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        jgp, jgx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    dx, grads = mlp_plain_bwd(tp, _t(x), _t(g), tdt)
    pairs = [(dx, jgx)] + [(got, jgp["layers"][i][k])
                           for i, (dw, db) in enumerate(grads) for k, got in (("w", dw), ("b", db))]
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=tol, atol=tol * np.abs(ref).max())
    # on a CPU tensor the K2 wrapper, and the autograd Function, run the plain version
    dx2, grads2 = mlp_fused_bwd(tp, _t(x), _t(g), tdt)
    np.testing.assert_array_equal(_np(dx2), _np(dx))
    leaves = [t.requires_grad_(True) for lay in tp["layers"] for t in (lay["w"], lay["b"])]
    xt = _t(x).requires_grad_(True)
    (mlp_fused(tp, xt, tdt) * _t(g)).sum().backward()
    np.testing.assert_array_equal(_np(xt.grad), _np(dx))
    for leaf, want in zip(leaves, [t for pair in grads for t in pair]):
        np.testing.assert_array_equal(_np(leaf.grad), _np(want))


def _grid_chain(dims, seed):
    """A chain on a grid of quarters (x in {-1, 0, 1} later): every product
    and sum is exact in bf16 and f32, and with biases in {-0.5, 0, 0.5} many
    pre-activations are exactly 0.0, which the ReLU mask must gate off."""
    rng = np.random.default_rng(seed)
    layers = [{"w": rng.choice([-0.5, -0.25, 0.25, 0.5], (a, b)).astype(np.float32),
               "b": rng.choice([-0.5, 0.0, 0.5], (b,)).astype(np.float32)}
              for a, b in zip(dims[:-1], dims[1:])]
    jp = {"layers": [{k: jnp.asarray(v) for k, v in lay.items()} for lay in layers]}
    tp = {"layers": [{k: _t(v) for k, v in lay.items()} for lay in layers]}
    return jp, tp


@pytest.mark.parametrize("case", ["no_dx_bf16", "no_dx_dino_bf16", "zero_preactivations_bf16",
                                  "zero_preactivations_f32"])
def test_k2_plain_matches_pallas_backward_without_dx_and_at_zero(case):
    """K2's plain version against the Pallas backward in interpret mode:
    with dx not wanted (dW and db only, dx None; the mlp_directional chain
    and the DINO head's 15-256-128), and on a chain whose
    first layer has exactly-zero pre-activations (post-activation > 0 masks
    them, as `_bwd_kernel` does); bf16 within 2e-2, f32 within 1e-4 of each
    tensor's largest entry."""
    dtype = "float32" if case.endswith("f32") else "bfloat16"
    tol = 1e-4 if dtype == "float32" else 2e-2
    n, need_dx = 40, not case.startswith("no_dx")
    rng = np.random.default_rng(len(case))
    if need_dx:
        dims = [12, 16, 24, 5]
        jp, tp = _grid_chain(dims, seed=9)
        x = rng.choice([-1.0, 0.0, 1.0], (n, dims[0])).astype(np.float32)
        pre = x @ np.asarray(tp["layers"][0]["w"]) + np.asarray(tp["layers"][0]["b"])
        assert (pre == 0.0).mean() > 0.05  # the case the mask must decide
    else:  # the DINO head's chain: geo_feat is detached, so its K2 takes no dx
        dims = [15, 256, 128] if "dino" in case else [28, 16, 128]
        jp, tp = _chain(dims, seed=11)
        x = rng.normal(size=(n, dims[0])).astype(np.float32)
    g = rng.normal(size=(n, dims[-1])).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(p, xx):
        return jnp.sum(mlp_apply_fused(p, xx, compute_dtype=jdt) * jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        jgp, jgx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    dx, grads = mlp_plain_bwd(tp, _t(x), _t(g), tdt, need_dx=need_dx)
    assert (dx is None) == (not need_dx)
    pairs = [(got, jgp["layers"][i][k])
             for i, (dw, db) in enumerate(grads) for k, got in (("w", dw), ("b", db))]
    if need_dx:
        pairs.append((dx, jgx))
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=tol, atol=tol * np.abs(ref).max())


def test_apply_mlp_gradient_skips_dx_when_the_input_needs_none():
    _, tp = _chain([28, 16, 128], seed=3)
    leaves = [t.requires_grad_(True) for lay in tp["layers"] for t in (lay["w"], lay["b"])]
    x = torch.randn(50, 28, generator=torch.Generator().manual_seed(4))
    g = torch.randn(50, 128, generator=torch.Generator().manual_seed(5))
    (apply_mlp(tp, x) * g).sum().backward()
    dx, want = mlp_plain_bwd(tp, x, g, need_dx=False)
    assert dx is None
    for leaf, w in zip(leaves, [t for pair in want for t in pair]):
        torch.testing.assert_close(leaf.grad, w, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------- hash backward
HASH_KW = dict(num_levels=4, log2_hashmap_size=10, max_resolution=64)


def _positions(n, seed):
    pos = np.random.default_rng(seed).uniform(size=(n, 3)).astype(np.float32)
    pos[:4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.5, 1.0], [0.25, 0.25, 0.25]]
    return pos


def _hash_positions(kind, n, seed):
    """kind="rays": 40 rays x 64 ray-ordered samples, where many share rows."""
    return _positions(n, seed) if kind == "random" else ray_samples(40, 64, seed)


# ids without a suffix are the random position sets these tests always had
HASH_CASES = [pytest.param(interp, kind, id=interp + ("" if kind == "random" else "-" + kind))
              for kind in ("random", "rays") for interp in ("tetrahedral", "trilinear")]
# (L, F) past the kernels' old limits (more than 32 levels, F other than 1,
# 2, 4, 8) on random positions, beside HASH_CASES (L4xF2)
HASH_SHAPE_CASES = HASH_CASES + [
    pytest.param(interp, "random", levels, features,
                 id=f"{interp}-L{levels}xF{features}")
    for levels, features in ((40, 7), (16, 3), (33, 16)) for interp in ("tetrahedral", "trilinear")]


@pytest.mark.parametrize("interp,kind,levels,features",
                         [pytest.param(*c.values, 4, 2, id=c.id) for c in HASH_CASES]
                         + HASH_SHAPE_CASES[len(HASH_CASES):])
def test_hash_backward_deterministic_matches_jax_vjp(interp, kind, levels, features):
    """The table gradient within atol 1e-6 (entries up to ~1e1): sums over
    repeated rows are taken in another order. kind="rays": 40 rays x 64
    ray-ordered samples, where many samples share rows. Past L4xF2, the
    shapes the kernels' any route takes."""
    kw = dict(HASH_KW, num_levels=levels, features_per_level=features)
    jcfg = j_enc.HashEncodingConfig(interpolation=interp, stochastic_grad=False, **kw)
    tcfg = t_enc.HashEncodingConfig(interpolation=interp, stochastic_grad=False, **kw)
    # the wider shapes at 1,000 positions: the file's time
    pos = _hash_positions(kind, 3000 if (levels, features) == (4, 2) else 1000, seed=21)
    rng = np.random.default_rng(22)
    table = rng.uniform(-1, 1, tcfg.table_size * features).astype(np.float32)
    g = rng.normal(size=(pos.shape[0], tcfg.output_dim)).astype(np.float32)
    jout, jvjp = jax.vjp(lambda t: j_enc.hash_encode(t, jnp.asarray(pos), jcfg), jnp.asarray(table))
    jgrad = np.asarray(jvjp(jnp.asarray(g))[0])
    assert np.abs(jgrad).max() > 1.0
    np.testing.assert_allclose(_np(t_enc.hash_encode_bwd_plain(_t(pos), _t(g), tcfg, False)),
                               jgrad, rtol=0, atol=1e-6)
    tt = _t(table).requires_grad_(True)
    out = t_enc.hash_encode(tt, _t(pos), tcfg)
    np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=0, atol=1e-6)
    out.backward(_t(g))
    np.testing.assert_allclose(_np(tt.grad), jgrad, rtol=0, atol=1e-6)


@pytest.mark.parametrize("interp,kind", HASH_CASES)
def test_hash_backward_stochastic_adds_g_to_exactly_one_vertex(interp, kind):
    cfg = t_enc.HashEncodingConfig(interpolation=interp, stochastic_grad=True, **HASH_KW)
    pos = _t(_hash_positions(kind, 2000, seed=23))
    n = pos.shape[0]
    g = torch.randn(n, cfg.output_dim, generator=torch.Generator().manual_seed(24))
    idx, w = t_enc.hash_indices_weights(pos, cfg)
    sel = t_enc.stochastic_vertex(w, t_enc.level_uniforms(pos, cfg.num_levels))
    assert int(sel.min()) >= 0 and int(sel.max()) < cfg.verts_per_cell
    rows = torch.gather(idx, 2, sel[..., None])[..., 0]  # (N, L)
    want = torch.zeros(cfg.table_size * 2)
    flat = (rows[..., None] * 2 + torch.arange(2)).reshape(-1)
    want.index_add_(0, flat, g.reshape(-1))
    got = t_enc.hash_encode_bwd_plain(pos, g, cfg, True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # with unit gradients every (sample, level, feature) adds exactly 1
    ones = t_enc.hash_encode_bwd_plain(pos, torch.ones_like(g), cfg, True)
    assert float(ones.sum()) == n * cfg.output_dim
    # and the autograd path takes the stochastic backward when the config asks
    tt = torch.zeros(cfg.table_size * 2, requires_grad=True)
    t_enc.hash_encode(tt, pos, cfg).backward(g)
    torch.testing.assert_close(tt.grad, got, rtol=0, atol=0)


@pytest.mark.parametrize("interp,kind", HASH_CASES)
@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "stochastic"])
def test_hash_backward_plain_adds_in_ascending_entry_order(stochastic, interp, kind):
    """hash_encode_bwd_plain on the CPU adds each table entry from +0 in
    ascending entry order, (s * L + l) * V + v (deterministic, w_v * g
    rounded once) or s * L + l (stochastic): bit for bit what np.add.at, a
    sequential loop in index order, gives. K4 keeps this order on the card."""
    cfg = t_enc.HashEncodingConfig(interpolation=interp, **HASH_KW)
    pos = _hash_positions(kind, 3000, seed=27)
    n, L, F = pos.shape[0], cfg.num_levels, cfg.features_per_level
    g = np.random.default_rng(28).normal(size=(n, L * F)).astype(np.float32)
    g[::7] = 0.0  # rows that add nothing, as the compact buffer's padding
    if stochastic:
        rows = _np(t_enc.stochastic_rows(_t(pos), cfg))[..., None]  # (N, L, 1)
        vals = g.reshape(n, L, 1, F)
    else:
        idx, w = t_enc.hash_indices_weights(_t(pos), cfg)
        rows, vals = _np(idx), _np(w)[..., None] * g.reshape(n, L, 1, F)  # f32 products
    want = np.zeros(cfg.table_size * F, np.float32)
    np.add.at(want, (rows[..., None] * F + np.arange(F)).reshape(-1), vals.reshape(-1))
    got = _np(t_enc.hash_encode_bwd_plain(_t(pos), _t(g), cfg, stochastic))
    assert np.abs(want).max() > 1.0
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
def test_hash_backward_stochastic_selects_by_the_weights(interp):
    """Over 160k (sample, level) draws each vertex is chosen as often as its
    mean weight says, within 0.005 (4 standard errors of a 0.25-0.5
    frequency at this count)."""
    cfg = t_enc.HashEncodingConfig(interpolation=interp, **HASH_KW)
    pos = _t(_positions(40000, seed=25))
    _, w = t_enc.hash_indices_weights(pos, cfg)
    sel = t_enc.stochastic_vertex(w, t_enc.level_uniforms(pos, cfg.num_levels))
    V = cfg.verts_per_cell
    freq = torch.nn.functional.one_hot(sel, V).float().mean(dim=(0, 1))
    torch.testing.assert_close(freq, w.mean(dim=(0, 1)), rtol=0, atol=5e-3)
    # within each weight quartile as well: the draw follows each sample's weight
    for v in range(V):
        wv = w[..., v].reshape(-1)
        hit = (sel == v).float().reshape(-1)
        hi = wv > wv.median()
        assert abs(float(hit[hi].mean() - wv[hi].mean())) < 1e-2
        assert abs(float(hit[~hi].mean() - wv[~hi].mean())) < 1e-2


def test_hash_backward_stochastic_mean_approaches_deterministic():
    """Per-row sums of the stochastic gradient converge to the deterministic
    ones as the positions per row grow (coarse dense levels, unit g)."""
    cfg = t_enc.HashEncodingConfig(num_levels=2, base_resolution=4, max_resolution=8,
                                   log2_hashmap_size=10, interpolation="tetrahedral")
    errs = []
    for n in (2000, 50000):
        pos = _t(_positions(n, seed=26))
        g = torch.ones(n, cfg.output_dim)
        det = t_enc.hash_encode_bwd_plain(pos, g, cfg, False)
        sto = t_enc.hash_encode_bwd_plain(pos, g, cfg, True)
        errs.append(float((sto - det).norm() / det.norm()))
    assert errs[1] < 0.05 and errs[1] < errs[0] / 2


# ------------------------------------------------------- Adam + schedule
@pytest.mark.parametrize("warmup", [0, 2])
def test_lr_schedule_matches_optax(warmup):
    jcfg = j_trainer.OptimizerConfig(max_steps=100, warmup_steps=warmup)
    tcfg = t_trainer.OptimizerConfig(max_steps=100, warmup_steps=warmup)
    jsched, tsched = j_trainer.make_lr_schedule(jcfg), t_trainer.make_lr_schedule(tcfg)
    for t in (0, 1, 2, 3, 50, 100, 101, 150, 10000):
        assert tsched(t) == pytest.approx(float(jsched(t)), rel=1e-6), t
    assert tsched(10000) == pytest.approx(1e-5)


def test_trainer_adam_update_matches_optax():
    """Three Adam updates at the scheduled rate from the same parameters and
    the same gradient sequence, then the endmember clamp, agree with
    optax.scale_by_adam + scale_by_learning_rate to 1e-6."""
    cfg = ModelConfig(method="rgb+spectral", pred_specular=True, grid_resolution=8,
                      grid_levels=1, march_pool=0, hash_num_levels=2, log2_hashmap_size=8,
                      max_res=32)
    opt_cfg = t_trainer.OptimizerConfig(max_steps=10)
    scene = SyntheticSceneConfig(image_size=4, num_bands=4)
    poses, _, rgba = render_views(scene, 2, 0.0)
    dm = InMemoryDataManager(rgba, scene_cameras(scene, poses),
                             wavelengths=list(450.0 + 10.0 * np.arange(4)), device="cpu")
    trainer = Trainer(TrainerConfig(seed=3, mixed_precision=False, optimizer=opt_cfg), cfg,
                      num_classes=3, device="cpu", datamanager=dm).setup()
    params = trainer.state["params"]
    names = [n for n, _ in named_leaves(params)]
    # copies: jnp.asarray may alias a numpy view of memory that torch updates in place
    jparams = {n: jnp.array(_np(t).copy()) for n, t in named_leaves(params)}
    sched = j_trainer.make_lr_schedule(j_trainer.OptimizerConfig(max_steps=10))
    opt = optax.chain(optax.scale_by_adam(eps=1e-15), optax.scale_by_learning_rate(sched))
    jstate = opt.init(jparams)
    rng = np.random.default_rng(30)
    for _ in range(3):
        grads = {n: rng.normal(size=jparams[n].shape).astype(np.float32) for n in names}
        for n, t in named_leaves(params):
            t.grad = _t(grads[n])
        trainer.apply_gradients()
        updates, jstate = opt.update({n: jnp.asarray(g) for n, g in grads.items()}, jstate)
        jparams = optax.apply_updates(jparams, updates)
        jparams["endmembers"] = j_field.clamp_endmembers(
            {"endmembers": jparams["endmembers"]})["endmembers"]
    assert trainer.state["step"] == 3
    for n, t in named_leaves(params):
        np.testing.assert_allclose(_np(t), np.asarray(jparams[n]), rtol=0, atol=1e-6, err_msg=n)
    em = params["endmembers"]
    assert float(em.min()) >= 0.0 and float(em.max()) <= 1.0


def test_clamp_endmembers_matches_jax():
    em = np.random.default_rng(31).normal(size=(4, 6)).astype(np.float32)
    params = {"endmembers": _t(em.copy()), "hash_table": _t(em.copy())}
    out = t_field.clamp_endmembers(params)
    np.testing.assert_array_equal(
        _np(out["endmembers"]),
        np.asarray(j_field.clamp_endmembers({"endmembers": jnp.asarray(em)})["endmembers"]))
    np.testing.assert_array_equal(_np(out["hash_table"]), em)  # only the endmembers
