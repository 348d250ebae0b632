"""K6, the compact path's compaction and compositing, on the CPU: the plain
versions of K6a-K6d (umhs_torch/ops/compact.py, ops/compositing.py) and the
staged compact forward against the JAX package, and the wrappers' dispatch.

Inputs come from numpy with a seed and go through both packages. On CPU
tensors the wrappers take the plain versions; the kernels themselves run on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
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


@pytest.mark.parametrize("L", [257, 496])
def test_compact_stage_plain_matches_jax_past_256_lanes(L):
    """Past K6a's old limit of 256 lanes a stage (257, a flat tile's ray
    crossing; 496, config A's third stage of S 512 after (8, 16)): the
    plain version against JAX's compact loop exactly, a later stage with
    dead rays and a budget that cuts inside a ray."""
    S, lo = 512, 16
    mask, live_rays, _, _ = _stage_mask(7, R=60, S=S, dead=True)
    m = mask[:, lo:lo + L]
    budget = int(m[live_rays].sum()) * 2 // 3
    ref = _jax_compact(m, live_rays, budget)
    c = t_compact.compact_stage(_t(mask)[:, lo:lo + L], _t(live_rays), budget)
    for k in ("slot", "mask", "src", "live", "counts", "starts"):
        np.testing.assert_array_equal(_np(getattr(c, k)).reshape(-1),
                                      np.asarray(ref[k]).reshape(-1), err_msg=k)
    assert c.total == int(ref["total"]) == budget


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


@pytest.mark.parametrize("S", [257, 512])
def test_render_weights_vjp_matches_jax_past_256_samples(S):
    """render_weights' plain version against jax.vjp past K6c's old limit
    of 256 samples a ray, on rays thin enough that transmittance lasts to
    their end (the alpha threshold a 0-dim tensor, early stop on): the
    weights within atol 1e-6, the gradients within rtol 1e-4 and atol 1e-5
    of each tensor's largest entry."""
    ts, te, sg, m = _march_like(8, R=32, S=S)
    sg = sg * (30.0 / S)
    thre = np.float32(0.002)
    g = np.random.default_rng(9).normal(size=sg.shape).astype(np.float32)
    jw, vjp = jax.vjp(lambda a, b, s: j_comp.render_weights(a, b, s, jnp.asarray(m),
                                                            jnp.asarray(thre), 1e-4),
                      *map(jnp.asarray, (ts, te, sg)))
    tin = [_t(x).requires_grad_(True) for x in (ts, te, sg)]
    tw = t_comp.render_weights(*tin, _t(m), alpha_thre=torch.tensor(thre), early_stop_eps=1e-4)
    tw.backward(_t(g))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=0, atol=1e-6)
    assert float(tw.detach()[:, 256:].sum()) > 0.0  # weights past the old limit
    for name, x, ref in zip(("t_starts", "t_ends", "sigmas"), tin, vjp(jnp.asarray(g))):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_np(x.grad), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max(),
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


# -------------------------------------------------- K6d over every stage
STAGE_BOUNDS = ((0, 8), (8, 16), (16, 24))
STAGE_BUDGETS = (700, 400, 300)  # the first overflows


def _stage_inputs(seed, C):
    """Three stages of a (300, 24) march as the model runs them: each
    stage's mask and-ed with the rays alive after the one before, budgets
    that overflow, the (R, S) weights and each stage's (Bs, C) values."""
    mask, _, _, _ = _stage_mask(seed, dead=False)
    rng = np.random.default_rng(seed + 1)
    R, S = mask.shape
    jc, tc, live = [], [], None
    for (lo, hi), Bs in zip(STAGE_BOUNDS, STAGE_BUDGETS):
        jc.append(_jax_compact(mask[:, lo:hi], live, Bs))
        tc.append(t_compact.compact_stage(_t(mask)[:, lo:hi], None if live is None else _t(live),
                                          Bs))
        live = rng.uniform(size=R) < 0.7
    w = rng.uniform(size=(R, S)).astype(np.float32)
    hs = [rng.normal(size=(Bs, C)).astype(np.float32) for Bs in STAGE_BUDGETS]
    g = rng.normal(size=(R, C)).astype(np.float32)
    return jc, tc, w, hs, g


@pytest.mark.parametrize("detached", [False, True], ids=["weights-grad", "detached-weights"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compact_accumulate_stages_vjp_matches_jax(dtype, detached):
    """compact_accumulate_stages' plain version (each stage's plain K6d on its
    columns of the (R, S) weights, added in stage order) against the JAX
    package's staged accumulate_fn and accumulate_sg (umhs_tpu/models/
    model.py:531-549: the weights gathered through each stage's src times
    live, segment_accumulate, summed over the stages), forward and VJP of
    the weights and every stage's values, within atol 1e-5 (the prefix sums
    add in another order); bf16 values held to JAX on their f32 values
    (their gradient within 1e-2: one rounding). With detached weights the
    weights take no gradient and the values' gradients are unchanged."""
    jc, tc, w, hs, g = _stage_inputs(21, 5)
    tdtype = getattr(torch, dtype)
    hs = [_np(_t(h).to(tdtype).float()) for h in hs]

    def jfn(w_, *h_):
        w_in = jax.lax.stop_gradient(w_) if detached else w_
        return sum(j_comp.segment_accumulate(
            (jnp.take(w_in[:, lo:hi].reshape(-1), c["src"], axis=0, mode="clip")
             * c["live"])[:, None] * h, c["starts"], c["counts"])
            for (lo, hi), c, h in zip(STAGE_BOUNDS, jc, h_))

    jout, vjp = jax.vjp(jfn, jnp.asarray(w), *map(jnp.asarray, hs))
    tw = _t(w).requires_grad_(True)
    ths = [_t(h).to(tdtype).requires_grad_(True) for h in hs]
    tout = t_comp.compact_accumulate_stages(
        tw.detach() if detached else tw,
        [(lo, hi, h, c) for (lo, hi), h, c in zip(STAGE_BOUNDS, ths, tc)])
    tout.backward(_t(g))
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(jout)).max() > 0.1
    jdw, *jdh = vjp(jnp.asarray(g))
    if detached:
        assert tw.grad is None and float(np.abs(np.asarray(jdw)).max()) == 0.0
    else:
        np.testing.assert_allclose(_np(tw.grad), np.asarray(jdw), rtol=0, atol=1e-5)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for th, ref in zip(ths, jdh):
        np.testing.assert_allclose(_np(th.grad.float()), np.asarray(ref), rtol=tol, atol=tol)


def test_compact_accumulate_is_one_stage():
    """compact_accumulate (one stage) is compact_accumulate_stages with that
    stage, and the stages' plain version is the stage sums added in stage
    order, bit for bit."""
    _, tc, w, hs, _ = _stage_inputs(22, 3)
    tw = _t(w)
    stages = [(lo, hi, _t(h), c) for (lo, hi), h, c in zip(STAGE_BOUNDS, hs, tc)]
    singles = [t_comp.compact_accumulate(tw[:, lo:hi], h, c) for lo, hi, h, c in stages]
    assert torch.equal(t_comp.compact_accumulate_stages(tw, stages),
                       singles[0] + singles[1] + singles[2])
    lo, hi, h, c = stages[1]
    assert torch.equal(t_comp.compact_accumulate_stages(tw, [stages[1]]),
                       t_comp.compact_accumulate_plain(tw[:, lo:hi], h, c))


# ------------------------------------------------------ the host's rules
@pytest.mark.parametrize("L", [1, 3, 7, 8, 16, 33, 48, 64, 96, 255, 256, 272, 496, 4096])
def test_compact_tile_rays_rule(L):
    """K6a's tile: whole rays within 4,096 lanes, a multiple of 16 lanes (a
    thread's 16 lanes start 64-byte aligned in slot), and the most such
    rays; every L up to 256 has one, and so do longer L that are multiples
    of 16 up to 4,096 (config A's third stage of 496 lanes: 8 rays)."""
    tr = t_compact.compact_tile_rays(L)
    assert tr >= 1 and tr * L <= t_compact.TILE_LANES
    assert tr * L % t_compact.LANES_PER_THREAD == 0
    more = [k for k in range(tr + 1, t_compact.TILE_LANES // L + 1)
            if k * L % t_compact.LANES_PER_THREAD == 0]
    assert not more, (tr, more[:3])


def test_compact_host_rules_refuse_and_pick():
    """K6a takes flat tiles of 4,096 lanes (compact_tile_rays 0) where no
    whole-ray tile exists (257 lanes, 4,097, 300 at the CPU tensor's refusal)
    and refuses an empty stage; its mask loads are the widest of 16, 8, 4
    bytes that divides L, the row stride and the address, else 1 (phase 7's
    stages: 8 bytes at offsets 0 and 8 of a 64-byte row, 16 at offset 16)."""
    for L in (257, 4097, 4104):
        assert t_compact.compact_tile_rays(L) == 0
    with pytest.raises(ValueError, match="L"):
        t_compact.compact_tile_rays(0)
    with pytest.raises(ValueError, match="int32"):
        t_compact.compact_stage_cuda(torch.zeros((4, 0), dtype=torch.bool), None, 8)
    with pytest.raises(ValueError, match="CUDA"):  # the shape passes; the CPU tensor not
        t_compact.compact_stage_cuda(torch.zeros((4, 300), dtype=torch.bool), None, 8)
    base = 1 << 20
    assert t_compact.mask_vector_bytes(8, 64, base) == 8
    assert t_compact.mask_vector_bytes(8, 64, base + 8) == 8
    assert t_compact.mask_vector_bytes(48, 64, base + 16) == 16
    assert t_compact.mask_vector_bytes(64, 64, base) == 16
    assert t_compact.mask_vector_bytes(48, 64, base + 4) == 4
    assert t_compact.mask_vector_bytes(28, 33, base + 5) == 1
    assert t_compact.mask_vector_bytes(8, 12, base) == 4
    assert t_compact.mask_vector_bytes(1, 1, base) == 1


def test_scan_workspace_epochs():
    """K6a's workspace: allocated zeroed once (a ticket, then at least
    MIN_FLAGS flags), one epoch a call from 1, grown (zeroed, epochs anew)
    when a stage has more tiles, and cleared once when the epochs run out,
    never on another call."""
    ws = t_compact.ScanWorkspace()
    buf, e = ws.take(10, "cpu")
    assert e == 1 and buf.numel() == 1 + t_compact.MIN_FLAGS and int(buf.abs().sum()) == 0
    buf.fill_(7)  # what launches leave behind
    for want in (2, 3):
        again, e = ws.take(t_compact.MIN_FLAGS, "cpu")
        assert again is buf and e == want and int(buf[5]) == 7  # no clear per call
    big, e = ws.take(t_compact.MIN_FLAGS + 1, "cpu")
    assert big is not buf and e == 1 and big.numel() == t_compact.MIN_FLAGS + 2
    assert int(big.abs().sum()) == 0
    big.fill_(7)
    ws.epoch = t_compact.EPOCH_LIMIT - 2
    same, e = ws.take(1, "cpu")
    assert e == t_compact.EPOCH_LIMIT - 1 and int(same[3]) == 7  # the last epoch a flag holds
    same, e = ws.take(1, "cpu")
    assert same is big and e == 1 and int(same.abs().sum()) == 0  # wrapped: cleared once
    assert (t_compact.EPOCH_LIMIT - 1) << 2 | 3 < 1 << 32  # epoch and status fit a flag's half


@pytest.mark.parametrize("C,G", [(1, 1), (3, 1), (4, 1), (5, 2), (6, 2), (8, 2), (9, 4),
                                 (16, 4), (17, 8), (21, 8), (33, 16), (64, 16), (65, 32),
                                 (128, 32), (141, 32)])
def test_accumulate_group_lanes_rule(C, G):
    """K6d's lanes a ray: a power of two, four channels a lane, the fewest
    that cover C, at most a warp (a 141-wide head takes two chunks)."""
    got = t_comp.accumulate_group_lanes(C)
    assert got == G and got & (got - 1) == 0 and got <= 32
    assert 4 * got >= C or got == 32
    assert got == 1 or 2 * got < C  # half as many would not cover C


def test_accumulate_vector_rows_and_stage_layout():
    """K6d's route per stage: vector loads where C and the row stride are
    multiples of 4 and the rows 16-byte (f32) or 8-byte (bf16) aligned,
    else the same kernel's scalar loads; the ctypes mirror of a stage is the
    C struct's 56 bytes (four pointers, the row stride, four int32)."""
    h = torch.zeros((10, 132))
    assert t_comp.accumulate_vector_rows(h[:, :128])
    assert not t_comp.accumulate_vector_rows(h[:, 1:129])
    assert not t_comp.accumulate_vector_rows(h[:, :6])
    assert not t_comp.accumulate_vector_rows(torch.zeros((10, 130))[:, :128])
    hb = torch.zeros((10, 132), dtype=torch.bfloat16)
    assert t_comp.accumulate_vector_rows(hb[:, 4:132])
    assert not t_comp.accumulate_vector_rows(hb[:, 2:130])
    S = t_comp.SegmentStage
    assert ctypes.sizeof(S) == 56 and S.h_stride.offset == 32 and S.lo.offset == 40
    assert S.vec.offset == 48


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
    stages = [(0, 12, h, c), (0, 12, h * 2, c)]
    assert torch.equal(t_comp.compact_accumulate_stages(w, stages),
                       t_comp.compact_accumulate_stages(w, stages, impl="plain"))
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
        lambda: t_comp.compact_accumulate_stages_cuda(w, [(0, 12, h, c)]),
        lambda: t_comp.compact_accumulate_stages_bwd_cuda(w, [(0, 12, h, c)],
                                                          torch.zeros((40, 3))),
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
        "int32 ray": lambda: t_comp.render_weights_cuda(  # 2^31 rays as stride-0 views
            *(torch.zeros((1, 257)).expand(2**31, 257),) * 3,
            torch.ones((1, 257), dtype=torch.bool).expand(2**31, 257)),
        "weights must be": lambda: t_comp.compact_accumulate_cuda(w.t(), h, c),
        "values must be": lambda: t_comp.compact_accumulate_cuda(w, h[:100], c),
        "values must be ": lambda: t_comp.compact_accumulate_cuda(w, h.half(), c),
        "at least one stage": lambda: t_comp.compact_accumulate_stages_cuda(w, []),
        "do not fit": lambda: t_comp.compact_accumulate_stages_cuda(w, [(4, 16, h, c)]),
        "every stage's values": lambda: t_comp.compact_accumulate_stages_cuda(
            w, [(0, 12, h, c), (0, 12, torch.randn((256, 4)), c)]),
        "every stage's values ": lambda: t_comp.compact_accumulate_stages_cuda(
            w, [(0, 12, h, c), (0, 12, h.bfloat16(), c)]),
    }
    for msg, call in bad.items():
        with pytest.raises(ValueError, match=msg.strip()):
            call()
    # 257 samples a ray pass the wrapper's checks: only the CPU tensor is refused
    with pytest.raises(ValueError, match="on the card"):
        t_comp.render_weights_cuda(*(torch.zeros((2, 257)),) * 3,
                                   torch.ones((2, 257), dtype=torch.bool))
    for call in (lambda: t_compact.compact_stage(mask, None, 256, impl="fast"),
                 lambda: t_comp.render_weights(ts, te, sg, m, impl="cuda"),
                 lambda: t_comp.compact_accumulate(w, h, c, impl=""),
                 lambda: t_comp.compact_accumulate_stages(w, [(0, 12, h, c)], impl="kernel")):
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
