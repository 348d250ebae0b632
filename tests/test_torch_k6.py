"""K6, the compact path's compaction and compositing, on the CPU: the plain
versions of K6a-K6d (umhs_torch/ops/compact.py, ops/compositing.py) and the
staged compact forward against the JAX package, and the wrappers' dispatch.

Inputs come from numpy with a seed and go through both packages. On CPU
tensors the wrappers take the plain versions; the kernels themselves run on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umhs_tpu.models.model import ModelConfig as JModelConfig
from umhs_tpu.models.model import UMHSModel as JModel
from umhs_tpu.ops import compositing as j_comp
from umhs_torch import convert
from umhs_torch.data.cameras import generate_camera_rays
from umhs_torch.data.synthetic import SyntheticSceneConfig, render_views, scene_cameras
from umhs_torch.engine.trainer import named_leaves
from umhs_torch.models.model import ModelConfig as TModelConfig
from umhs_torch.models.model import UMHSModel as TModel
from umhs_torch.ops import compact as t_compact
from umhs_torch.ops import compositing as t_comp
from umhs_torch.ops._native import KERNELS


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------------ K6a
def _jax_compact(mask, live_rays, budget):
    """umhs_tpu/models/model.py:436-456 (the compact loop's slot map, src,
    live, counts and starts for one stage), written out on its own."""
    R, L = mask.shape
    m = jnp.asarray(mask)
    if live_rays is not None:
        m = m & jnp.asarray(live_rays)[:, None]
    flat_mask = m.reshape(-1)
    slot = jnp.cumsum(flat_mask.astype(jnp.int32)) - flat_mask.astype(jnp.int32)
    flat_mask = flat_mask & (slot < budget)
    m = flat_mask.reshape(R, L)
    total = jnp.sum(flat_mask.astype(jnp.int32))
    src = (jnp.zeros((budget,), jnp.int32).at[jnp.where(flat_mask, slot, budget)]
           .set(jnp.arange(R * L, dtype=jnp.int32), mode="drop"))
    live = (jnp.arange(budget) < total).astype(jnp.float32)
    counts = jnp.sum(m.astype(jnp.int32), axis=-1)
    starts = jnp.cumsum(counts) - counts
    return {"slot": slot, "mask": m, "src": src, "live": live, "counts": counts,
            "starts": starts, "total": total}


def _stage_mask(seed, R=300, S=24, lo=8, hi=16, dead=True):
    """The (R, S) mask of a march (each ray's valid lanes a prefix of
    random length, some rays empty) and, for a later stage, the rays still
    alive; the stage is lanes [lo, hi)."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, S + 1, R)
    n[::17] = 0  # rays with no sample
    mask = np.arange(S)[None, :] < n[:, None]
    live_rays = rng.uniform(size=R) < 0.7 if dead else None
    return mask, live_rays, lo, hi


@pytest.mark.parametrize("budget", [4096, 1024, 256], ids=["roomy", "overflow", "tight"])
@pytest.mark.parametrize("dead", [False, True], ids=["first-stage", "later-stage"])
def test_compact_stage_plain_matches_jax(budget, dead):
    """K6a's plain version gives JAX's slot map, kept mask, src, live, counts,
    starts and total exactly: a budget above, below and far below the kept
    count, rays with no sample, and a later stage with dead rays."""
    mask, live_rays, lo, hi = _stage_mask(1, dead=dead)
    ref = _jax_compact(mask[:, lo:hi], live_rays, budget)
    c = t_compact.compact_stage(_t(mask)[:, lo:hi], None if live_rays is None else _t(live_rays),
                                budget)
    for k in ("slot", "mask", "src", "live", "counts", "starts"):
        np.testing.assert_array_equal(_np(getattr(c, k)).reshape(-1),
                                      np.asarray(ref[k]).reshape(-1), err_msg=k)
    assert c.total == int(ref["total"])
    kept = int(mask[:, lo:hi][live_rays if dead else slice(None)].sum())
    assert c.total == min(kept, budget)
    if budget < kept:
        assert int(c.counts.sum()) == budget  # the overflow was dropped


def test_gather_lanes_plain_matches_jax():
    """K6b's plain version against JAX's density gather back through the
    slot map (model.py:483, mode="clip", masked), forward and VJP, exactly:
    each kept lane reads one row."""
    mask, live_rays, lo, hi = _stage_mask(2, dead=True)
    budget = 700
    ref = _jax_compact(mask[:, lo:hi], live_rays, budget)
    c = t_compact.compact_stage(_t(mask)[:, lo:hi], _t(live_rays), budget)
    rows = np.random.default_rng(3).normal(size=budget).astype(np.float32)
    g = np.random.default_rng(4).normal(size=c.mask.shape).astype(np.float32)
    R, L = c.mask.shape

    def jfn(d):
        return jnp.where(ref["mask"], jnp.take(d, ref["slot"].reshape(R, L), axis=0,
                                               mode="clip"), 0.0)

    jout, vjp = jax.vjp(jfn, jnp.asarray(rows))
    trows = _t(rows).requires_grad_(True)
    tout = t_compact.gather_lanes(trows, c)
    tout.backward(_t(g))
    np.testing.assert_array_equal(_np(tout), np.asarray(jout))
    np.testing.assert_array_equal(_np(trows.grad), np.asarray(vjp(jnp.asarray(g))[0]))


# ------------------------------------------------------------------ K6c
def _march_like(seed, R=96, S=40):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.005, 0.03, (R, S)).astype(np.float32)
    t_ends = (0.5 + np.cumsum(dt, axis=1)).astype(np.float32)
    t_starts = (t_ends - dt).astype(np.float32)
    sigmas = rng.exponential(20.0, (R, S)).astype(np.float32)
    mask = rng.uniform(size=(R, S)) < 0.8
    return t_starts, t_ends, sigmas, mask


@pytest.mark.parametrize("eps", [1e-4, 0.0], ids=["early-stop", "no-early-stop"])
@pytest.mark.parametrize("alpha_thre", ["none", "float", "tensor"])
def test_render_weights_vjp_matches_jax(alpha_thre, eps):
    """render_weights' plain version (K6c's) against jax.vjp of
    umhs_tpu/ops/compositing.py's: the weights within atol 1e-6 and the
    gradients of sigmas, t_starts and t_ends within rtol 1e-4 and atol 1e-5
    of each tensor's largest entry (the scans add in another order). The
    threshold is absent, a float, or a 0-dim tensor as the model passes it."""
    ts, te, sg, m = _march_like(5)
    thre = {"none": 0.0, "float": 0.01, "tensor": np.float32(0.02)}[alpha_thre]
    jthre = jnp.asarray(thre) if alpha_thre == "tensor" else thre
    tthre = torch.tensor(thre) if alpha_thre == "tensor" else thre
    g = np.random.default_rng(6).normal(size=sg.shape).astype(np.float32)
    jw, vjp = jax.vjp(lambda a, b, s: j_comp.render_weights(a, b, s, jnp.asarray(m), jthre, eps),
                      *map(jnp.asarray, (ts, te, sg)))
    tin = [_t(x).requires_grad_(True) for x in (ts, te, sg)]
    tw = t_comp.render_weights(*tin, _t(m), alpha_thre=tthre, early_stop_eps=eps)
    tw.backward(_t(g))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=0, atol=1e-6)
    assert float(tw.detach().sum()) > 1.0  # the weights are not all filtered away
    for name, t, ref in zip(("t_starts", "t_ends", "sigmas"), tin, vjp(jnp.asarray(g))):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(t.grad), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


# ------------------------------------------------------------------ K6d
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compact_accumulate_vjp_matches_jax(dtype):
    """compact_accumulate's plain version (K6d's: the weights gathered
    through src times live, then segment_accumulate) against the JAX
    package's lines 520-549 with its segment_accumulate, forward and VJP of
    the weights and the values, on a stage with overflow, empty and dead
    rays; within atol 1e-5 (the prefix sums add in another order). bf16
    values as the bf16 run's heads come, held to JAX on their f32 values."""
    mask, live_rays, lo, hi = _stage_mask(7, dead=True)
    budget = 900
    ref = _jax_compact(mask[:, lo:hi], live_rays, budget)
    c = t_compact.compact_stage(_t(mask)[:, lo:hi], _t(live_rays), budget)
    R, L = c.mask.shape
    rng = np.random.default_rng(8)
    w = rng.uniform(size=(R, L)).astype(np.float32)
    h = rng.normal(size=(budget, 5)).astype(np.float32)
    tdtype = getattr(torch, dtype)
    h = _np(_t(h).to(tdtype).float())  # the values bf16 can hold
    g = rng.normal(size=(R, 5)).astype(np.float32)

    def jfn(w_, h_):
        w_st = jnp.take(w_.reshape(-1), ref["src"], axis=0, mode="clip") * ref["live"]
        return j_comp.segment_accumulate(w_st[:, None] * h_, ref["starts"], ref["counts"])

    jout, vjp = jax.vjp(jfn, jnp.asarray(w), jnp.asarray(h))
    tw = _t(w).requires_grad_(True)
    th = _t(h).to(tdtype).requires_grad_(True)
    tout = t_comp.compact_accumulate(tw, th, c)
    tout.backward(_t(g))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(jout)).max() > 0.1
    jdw, jdh = vjp(jnp.asarray(g))
    np.testing.assert_allclose(_np(tw.grad), np.asarray(jdw), rtol=0, atol=1e-5)
    tol = 1e-5 if dtype == "float32" else 1e-2  # bf16: one rounding of each dh
    np.testing.assert_allclose(_np(th.grad.float()), np.asarray(jdh), rtol=tol, atol=tol)


# ----------------------------------------------------- the staged path
KW = dict(method="rgb+spectral", pred_specular=True, temperature=0.4, grid_resolution=16,
          grid_levels=1, march_pool=4, max_samples_per_ray=8, num_candidates=256,
          hash_num_levels=4, log2_hashmap_size=10, max_res=64,
          hash_interpolation="tetrahedral", stage_boundaries=(2, 5), stochastic_hash_grad=False)
WAVELENGTHS = list(450.0 + 20.0 * np.arange(8))
BUDGETS = (256, 512, 512)  # per stage; the first overflows
STEP = 500
OUT_KEYS = ("spectral", "spectral2", "rgb", "accumulation", "depth")


def test_staged_compact_forward_and_grads_match_jax():
    """The three-stage compact forward (K6a-K6d's plain versions in the
    model) and the gradient of a random linear function of its outputs with
    respect to every parameter, against the JAX package's model on the same
    parameters (convert.py): outputs within atol 1e-4, gradients within rtol
    1e-3 and atol 1e-4 of each tensor's largest entry (scans and segment
    sums add in another order)."""
    jm = JModel(JModelConfig(**KW), WAVELENGTHS, num_classes=3, num_images=2)
    tm = TModel(TModelConfig(**KW), WAVELENGTHS, num_classes=3, num_images=2, device="cpu")
    params, occ0 = jm.init(jax.random.PRNGKey(0))
    params = dict(params, hash_table=params["hash_table"] * 1e4)
    occ = jax.jit(lambda o, p, k: jm.update_occupancy(o, p, k, full=True))(
        occ0, params, jax.random.PRNGKey(1))
    scene = SyntheticSceneConfig(image_size=12, num_bands=len(WAVELENGTHS))
    poses, _, _ = render_views(scene, 1, 0.13)
    rays = generate_camera_rays(scene_cameras(scene, poses).to_device_dict(), 0, 12, 12)
    jrays = {k: jnp.asarray(_np(v)) for k, v in rays.items()}
    R = rays["origins"].shape[0]
    rng = np.random.default_rng(9)
    widths = {"spectral": len(WAVELENGTHS), "spectral2": len(WAVELENGTHS), "rgb": 3,
              "accumulation": 1, "depth": 1}
    cot = {k: rng.normal(size=(R, widths[k])).astype(np.float32) for k in OUT_KEYS}

    def jloss(p):
        o = jm.forward(p, occ, jrays, rng=None, train=False, compact_budget=BUDGETS,
                       step=jnp.int32(STEP))
        return sum(jnp.sum(o[k] * cot[k]) for k in OUT_KEYS), o

    (_, jo), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tparams = convert.params_to_torch(params)
    for _, t in named_leaves(tparams):
        t.requires_grad_(True)
    to = tm.forward(tparams, convert.occ_state_to_torch(occ), rays, compact_budget=BUDGETS,
                    step=STEP)
    sum((to[k] * _t(cot[k])).sum() for k in OUT_KEYS).backward()
    for k in OUT_KEYS + ("num_eval_s1_per_ray", "num_eval_s3_per_ray"):
        np.testing.assert_allclose(_np(to[k]).astype(np.float64), np.asarray(jo[k]), rtol=0,
                                   atol=1e-4, err_msg=k)
    assert int(to["num_eval_s1_per_ray"].sum()) == BUDGETS[0]  # stage 1 overflowed
    assert int(to["num_eval_s3_per_ray"].sum()) > 0
    jflat = dict(named_leaves(jgrads))
    for name, t in named_leaves(tparams):
        ref = np.asarray(jflat[name])
        if not np.abs(ref).max() > 0.0:
            assert t.grad is None or float(t.grad.abs().max()) == 0.0, name
            continue
        np.testing.assert_allclose(_np(t.grad), ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)


# -------------------------------------------------------------- dispatch
def _compaction():
    mask = _t(_stage_mask(10, R=40, S=12, lo=0, hi=12, dead=False)[0])
    return mask, t_compact.compact_stage(mask, None, 256)


def _launches():
    return {k.symbol: k.launches for k in KERNELS.values()}


def test_cpu_tensors_take_the_plain_versions():
    """With impl="auto" a CPU tensor takes each plain version, with the same
    bits as impl="plain", and launches nothing."""
    before = _launches()
    mask, c = _compaction()
    c2 = t_compact.compact_stage(mask, None, 256, impl="plain")
    assert all(torch.equal(getattr(c, k), getattr(c2, k))
               for k in ("slot", "mask", "src", "live", "counts", "starts"))
    rows = torch.randn(256, generator=torch.Generator().manual_seed(0))
    assert torch.equal(t_compact.gather_lanes(rows, c),
                       t_compact.gather_lanes(rows, c, impl="plain"))
    ts, te, sg, m = map(_t, _march_like(11, R=8, S=12))
    assert torch.equal(t_comp.render_weights(ts, te, sg, m, 0.01),
                       t_comp.render_weights(ts, te, sg, m, 0.01, impl="plain"))
    w = torch.rand(c.mask.shape, generator=torch.Generator().manual_seed(1))
    h = torch.randn((256, 3), generator=torch.Generator().manual_seed(2))
    assert torch.equal(t_comp.compact_accumulate(w, h, c),
                       t_comp.compact_accumulate(w, h, c, impl="plain"))
    assert _launches() == before


def test_kernel_entry_points_refuse_cpu_tensors():
    """Each kernel's own entry point raises on a CPU tensor, before any
    launch."""
    before = _launches()
    mask, c = _compaction()
    ts, te, sg, m = map(_t, _march_like(12, R=8, S=12))
    w = torch.rand(c.mask.shape)
    h = torch.randn((256, 3))
    calls = [
        lambda: t_compact.compact_stage_cuda(mask, None, 256),
        lambda: t_compact.lanes_from_rows_cuda(torch.zeros(256), c),
        lambda: t_compact.rows_from_lanes_cuda(torch.zeros(c.mask.shape), c),
        lambda: t_comp.render_weights_cuda(ts, te, sg, m),
        lambda: t_comp.render_weights_bwd_cuda(ts, te, sg, m, 0.0, 1e-4, torch.zeros_like(sg)),
        lambda: t_comp.compact_accumulate_cuda(w, h, c),
        lambda: t_comp.compact_accumulate_bwd_cuda(w, h, c, torch.zeros((40, 3))),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA|card"):
            call()
    assert _launches() == before


def test_bad_shapes_and_dtypes_are_refused():
    """Shapes, dtypes and strides the kernels do not take are refused with a
    ValueError naming them, before the device is looked at, and with
    impl not "auto" or "plain"."""
    mask, c = _compaction()
    ts, te, sg, m = map(_t, _march_like(13, R=8, S=12))
    w = torch.rand(c.mask.shape)
    h = torch.randn((256, 3))
    bad = {
        "mask must be": lambda: t_compact.compact_stage_cuda(mask.int(), None, 256),
        "budget": lambda: t_compact.compact_stage_cuda(mask, None, 0),
        "live_rays": lambda: t_compact.compact_stage_cuda(mask, torch.ones(3, dtype=torch.bool),
                                                          256),
        "rows must be": lambda: t_compact.lanes_from_rows_cuda(torch.zeros(255), c),
        "float32": lambda: t_compact.lanes_from_rows_cuda(torch.zeros(256).double(), c),
        "lanes must be": lambda: t_compact.rows_from_lanes_cuda(torch.zeros(c.mask.shape).t(), c),
        "sigmas must be": lambda: t_comp.render_weights_cuda(ts, te, sg.double(), m),
        "mask must be ": lambda: t_comp.render_weights_cuda(ts, te, sg, m.float()),
        "S must be": lambda: t_comp.render_weights_cuda(*(torch.zeros((2, 257)),) * 3,
                                                       torch.ones((2, 257), dtype=torch.bool)),
        "weights must be": lambda: t_comp.compact_accumulate_cuda(w.t(), h, c),
        "values must be": lambda: t_comp.compact_accumulate_cuda(w, h[:100], c),
        "values must be ": lambda: t_comp.compact_accumulate_cuda(w, h.half(), c),
    }
    for msg, call in bad.items():
        with pytest.raises(ValueError, match=msg.strip()):
            call()
    for call in (lambda: t_compact.compact_stage(mask, None, 256, impl="fast"),
                 lambda: t_comp.render_weights(ts, te, sg, m, impl="cuda"),
                 lambda: t_comp.compact_accumulate(w, h, c, impl="")):
        with pytest.raises(ValueError, match="impl"):
            call()


def test_model_impl_plain_is_the_cpu_path():
    """A model with impl="plain" gives the same bits as impl="auto" on CPU
    tensors (both the plain versions)."""
    kw = dict(KW, max_samples_per_ray=8, stage_boundaries=(4,))
    outs = []
    for impl in ("auto", "plain"):
        tm = TModel(dataclasses.replace(TModelConfig(**kw), impl=impl), WAVELENGTHS,
                    num_classes=3, num_images=2, device="cpu")
        params, occ = tm.init(torch.Generator().manual_seed(0))
        occ = dict(occ, binaries=torch.ones_like(occ["binaries"]),
                   occs=torch.ones_like(occ["occs"]))
        o = torch.tensor([[0.0, 0.0, -2.0]]).repeat(16, 1)
        d = torch.nn.functional.normalize(torch.rand((16, 3), generator=torch.Generator()
                                                     .manual_seed(1)) - 0.5 + torch.tensor(
                                                         [0.0, 0.0, 1.0]), dim=-1)
        outs.append(tm.forward(params, occ, {"origins": o, "directions": d},
                               compact_budget=(64, 64), step=STEP))
    for k in ("spectral", "accumulation", "depth"):
        assert torch.equal(outs[0][k], outs[1][k]), k
