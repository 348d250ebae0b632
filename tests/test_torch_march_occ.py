"""K5 and K7's plain versions against umhs_tpu on the CPU: the march at the
flagship's march settings (1024 candidates, 4 fine samples a cell, pool 4,
64 samples a ray) on a 32^3 x 2 grid, the occupancy update, the pooled and
packed bitfields, the budget scale's rounding, and the wrappers' dispatch.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
`-k "k5 or k7"`), where they are held to these plain versions bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umhs_tpu.ops import occupancy as j_occ
from umhs_tpu.ops import ray_marching as j_march
from umhs_torch.ops import occupancy as t_occ
from umhs_torch.ops import ray_marching as t_march

# an off-centre box, so that the centre and half extent round in the lookups
AABB_MIN, AABB_MAX = (-1.1, -0.7, -1.3), (1.3, 1.5, 0.9)
RES, LEVELS = 32, 2
RSS = float(np.linalg.norm(np.subtract(AABB_MAX, AABB_MIN))) / 1000.0  # the model's rule
FLAGSHIP_MARCH = dict(num_candidates=1024, num_samples=64, occ_subsamples=4, pool=4,
                      render_step_size=RSS, cone_angle=0.004)
RAYS = 320


def _np(t):
    return t.detach().cpu().numpy()


def _configs(pool=4, levels=LEVELS, res=RES, **march_kw):
    kw = dict(FLAGSHIP_MARCH, pool=pool, **march_kw)
    occ = dict(resolution=res, levels=levels, aabb_min=AABB_MIN, aabb_max=AABB_MAX, pool=pool)
    return (j_occ.OccGridConfig(**occ), j_march.MarchConfig(**kw),
            t_occ.OccGridConfig(**occ), t_march.MarchConfig(**kw))


def _bitfield(kind, seed=5, levels=LEVELS, res=RES):
    """A (levels * res^3,) bool bitfield: random with 30% of the outer
    levels' cells and a dense ball at the centre of level 0, every cell, or
    none."""
    n = levels * res**3
    if kind == "dense":
        return np.ones(n, bool)
    if kind == "empty":
        return np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    b = rng.random(n) < 0.3
    ijk = np.stack(np.meshgrid(*[np.arange(res)] * 3, indexing="ij"), -1)[..., ::-1]
    ball = (np.linalg.norm(ijk - res / 2 + 0.5, axis=-1) < res / 4).reshape(-1)
    b[:res**3] = ball | (rng.random(res**3) < 0.05)
    return b


def _states(bits, jcfg, tcfg, packed=True):
    """The JAX march's grid arguments and the port's occ_state from one
    bitfield, each package's own pool and pack."""
    jb = jnp.asarray(bits)
    jkw = {"binaries_pooled": j_occ._pool_binaries(jb, jcfg)} if jcfg.pool > 1 else {}
    tb = torch.from_numpy(bits)
    tstate = {"binaries": tb}
    if tcfg.pool > 1:
        tstate["binaries_pooled"] = t_occ._pool_binaries(tb, tcfg)
    if packed:
        jkw["packed_words"] = j_occ._pack_supercell_words(jb, jcfg)
        tstate["packed_words"] = t_occ._pack_supercell_words(tb, tcfg)
    return jb, jkw, tstate


def _rays(seed=7):
    """RAYS rays: most from a sphere of radius 4 toward points in the box,
    40 starting inside the level-0 box, 40 pointing away from it (they miss)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array(AABB_MIN), np.array(AABB_MAX)
    centre = (lo + hi) / 2
    o = rng.normal(size=(RAYS, 3))
    o = centre + 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = rng.uniform(lo, hi, (RAYS, 3))
    d = target - o
    o[:40] = rng.uniform(lo, hi, (40, 3))
    d[:40] = rng.normal(size=(40, 3))
    d[40:80] = o[40:80] - centre
    return o.astype(np.float32), d.astype(np.float32)


def _march_both(jcfg, jmarch, tcfg, tmarch, bits, total_budget=None, jitter=False,
                packed=True):
    jb, jkw, tstate = _states(bits, jcfg, tcfg, packed)
    o, d = _rays()
    key = jax.random.PRNGKey(4) if jitter else None
    jr = j_march.march_rays(jb, jcfg, jmarch, jnp.asarray(o), jnp.asarray(d), rng=key,
                            total_budget=total_budget, **jkw)
    # the jitter the JAX march draws from its key, for the port
    t_jitter = torch.from_numpy(np.array(jax.random.uniform(key, (RAYS,)))) if jitter else None
    tr = t_march.march_rays(tstate, tcfg, tmarch, torch.from_numpy(o), torch.from_numpy(d),
                            t_jitter=t_jitter, total_budget=total_budget)
    return jr, tr


def _assert_march_equal(jr, tr):
    """Masks and counts exact; t within rtol 1e-6 (XLA's and PyTorch's CPU
    exp and log may round one ulp apart)."""
    for k in ("mask", "num_samples", "num_occupied"):
        np.testing.assert_array_equal(_np(tr[k]), np.asarray(jr[k]), err_msg=k)
    for k in ("t_starts", "t_ends"):
        np.testing.assert_allclose(_np(tr[k]), np.asarray(jr[k]), rtol=1e-6, atol=0, err_msg=k)


# ------------------------------------------------------------ budget scale
def test_rank_select_budget_scale_divides_once():
    """The batch scale total_budget / total rounds once, as JAX divides: with
    a budget of 94,144 and per-ray budgets summing to 164,752 (scale 4/7), a
    ray with 7 occupied candidates keeps 4 samples (taking the reciprocal
    first, 7 * scale falls below 4 and it kept 3)."""
    R, M, S = 10_298, 128, 16
    counts = np.full(R, 16)
    counts[-2:] = (9, 7)
    assert counts.sum() == 164_752
    occ = np.zeros((R, M), bool)
    rng = np.random.default_rng(3)
    for r in (0, R - 2, R - 1):  # a few rays with spread occupancy, the rest a prefix
        occ[r, np.sort(rng.choice(M, counts[r], replace=False))] = True
    occ[1:R - 2, :16] = True
    ts = np.cumsum(rng.uniform(0.001, 0.01, (R, M)), 1).astype(np.float32)
    dts = rng.uniform(0.001, 0.01, (R, M)).astype(np.float32)
    jt, jdt, jv = j_march._rank_select(jnp.asarray(occ), jnp.asarray(ts), jnp.asarray(dts), S,
                                       total_budget=94_144)
    tt, tdt, tv = t_march._rank_select(torch.from_numpy(occ), torch.from_numpy(ts),
                                       torch.from_numpy(dts), S, total_budget=94_144)
    assert int(np.asarray(jv)[-1].sum()) == 4
    assert int(tv[-1].sum()) == 4
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    np.testing.assert_array_equal(_np(tdt), np.asarray(jdt))


# ------------------------------------------------------------------ march
@pytest.mark.parametrize("budget", [None, 16 * RAYS], ids=["no-budget", "binding"])
@pytest.mark.parametrize("grid", ["random", "dense", "empty"])
def test_march_matches_jax_at_flagship_settings(grid, budget):
    """Pool 4 with the packed words: the dense grid strides every ray in both
    rank-selects; the binding budget scales every ray's down."""
    jcfg, jmarch, tcfg, tmarch = _configs()
    jr, tr = _march_both(jcfg, jmarch, tcfg, tmarch, _bitfield(grid), total_budget=budget)
    _assert_march_equal(jr, tr)
    o, d = _rays()
    n = _np(tr["num_samples"])
    assert (n[40:80] == 0).all()  # the rays pointing away miss the box
    if grid == "empty":
        assert n.sum() == 0
    else:
        assert (n[:40] > 0).any() and (n[80:] > 0).any()
    if budget is not None and grid != "empty":
        assert n.sum() <= budget
        assert (_np(tr["num_occupied"]) > n).any()  # strided rays


@pytest.mark.parametrize("case", ["jitter", "no-pool", "pool-2", "bitfield"])
def test_march_matches_jax_in_other_layouts(case):
    """The train march's jitter; no pre-pass (256 candidates on the closed-
    form schedule); pool 2 (the pre-pass on the pooled bytes); no packed
    words (both queries on the bytes); each with a binding budget."""
    pool = {"no-pool": 0, "pool-2": 2}.get(case, 4)
    jcfg, jmarch, tcfg, tmarch = _configs(pool=pool)
    jr, tr = _march_both(jcfg, jmarch, tcfg, tmarch, _bitfield("random"),
                         total_budget=16 * RAYS, jitter=case == "jitter",
                         packed=case != "bitfield")
    _assert_march_equal(jr, tr)
    assert int(tr["num_samples"].sum()) > 0


# the marches past K5's old limit of 1,024 candidates a stage (32 words)
LONG_MARCHES = {  # label: (pool, MarchConfig fields)
    "4096-candidates": (0, dict(num_candidates=4096, occ_subsamples=1)),
    "prepass-2048": (4, dict(num_candidates=8192, occ_subsamples=1)),
    "config-A": (4, dict(num_candidates=8192, num_samples=512, occ_subsamples=2)),
}


@pytest.mark.parametrize("budget", [None, 16 * RAYS], ids=["no-budget", "binding"])
@pytest.mark.parametrize("grid", ["random", "dense"])
@pytest.mark.parametrize("case", list(LONG_MARCHES))
def test_march_matches_jax_past_1024_candidates(case, grid, budget):
    """The plain march against JAX's past 1,024 candidates a stage: 4,096
    candidates without a pre-pass, a pre-pass of 2,048 supercells (8,192
    candidates, pool 4), and config A's march (8,192 candidates, 2 fine
    samples a cell, 512 samples: 256 slots, a pre-pass of 1,024
    supercells, 512 of them subdivided into M 2,048 cell candidates)."""
    pool, kw = LONG_MARCHES[case]
    jcfg, jmarch, tcfg, tmarch = _configs(pool=pool, **kw)
    jr, tr = _march_both(jcfg, jmarch, tcfg, tmarch, _bitfield(grid), total_budget=budget,
                         jitter=True)
    _assert_march_equal(jr, tr)
    _, _, Ma, M = t_march.march_layout(_states(_bitfield(grid), jcfg, tcfg)[2], tcfg, tmarch)
    assert max(M, Ma) > 1024
    assert int(tr["num_samples"].sum()) > 0


# ---------------------------------------- what K5a's walk of the words relies on
@pytest.mark.parametrize("pool_supers", [0, 7, 9])
@pytest.mark.parametrize("grid", ["random", "dense"])
def test_candidates_past_the_prepass_budget_are_never_occupied(grid, pool_supers):
    """K5a walks a ray's cell candidates only up to ceil(budget * pool / 32)
    words, budget = min(the pre-pass's count, supers). In the plain march
    the kept supercells are a prefix of the slots (a kept slot's dt > 0, a
    dropped one's 0) and no candidate of a slot at or past the budget is
    occupied; rays that miss the box keep none."""
    jcfg, _, tcfg, tmarch = _configs(pool_supers=pool_supers)
    _, _, tstate = _states(_bitfield(grid), jcfg, tcfg)
    o, d = _rays()
    c = t_march.march_candidates_plain(tstate, tcfg, tmarch, torch.from_numpy(o),
                                       torch.from_numpy(d))
    supers, p = tmarch.supers, tmarch.pool
    slot_kept = c["dts"].reshape(RAYS, supers, p)[:, :, 0] > 0
    budget = slot_kept.sum(-1)
    assert torch.equal(slot_kept, torch.arange(supers)[None, :] < budget[:, None])
    assert not bool(c["occupied"].reshape(RAYS, supers, p)[~slot_kept].any())
    assert int(budget[40:80].max()) == 0
    assert int(budget.max()) == supers if grid == "dense" else int(budget.max()) > 0


@pytest.mark.parametrize("schedule", ["coarse", "pre-pass"])
@pytest.mark.parametrize("cone", [0.0, 0.004])
def test_candidate_schedule_never_decreases(cone, schedule):
    """K5a stops a ray's words at the first word whose last candidate starts
    at or past t_max; that relies on t never decreasing with the candidate
    index. Checked on the plain schedule (and its recompute at an index,
    which must agree) from starts at the near plane to far past the switch
    to geometric steps, around that switch one ulp at a time, at cone 0 and
    at the flagship's cone, for the schedule without a pre-pass and the
    pre-pass's."""
    _, _, _, tmarch = _configs(cone_angle=cone)
    sched = (t_march._super_config(tmarch) if schedule == "pre-pass"
             else t_march._coarse_config(tmarch))
    starts = [np.linspace(0.05, 40.0, 2001, dtype=np.float32)]
    if cone > 0.0:
        t_crit = np.float32(sched.render_step_size / sched.cone_angle)
        starts.append(t_crit + np.arange(-64, 65, dtype=np.float32) * np.spacing(t_crit))
        steps = np.arange(1, 9, dtype=np.float32)
        starts.append(t_crit - np.float32(sched.render_step_size) * steps)
    t0 = torch.from_numpy(np.concatenate(starts))
    ts, dts = t_march.candidate_ts(t0, sched)
    assert bool((ts[:, 1:] >= ts[:, :-1]).all())
    assert bool((dts > 0).all())
    idx = torch.arange(sched.num_candidates).expand(t0.shape[0], -1)
    again, _ = t_march._ts_at_index(t0, sched, idx)
    assert torch.equal(again, ts)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("k", range(8))
def test_division_by_a_power_of_two_is_a_product(k):
    """locate_cell takes rel / 2^lvl as rel * 2^-lvl: both round the same
    real number once, so the f32 bits agree, over seeded values of every
    magnitude and random bit patterns (subnormals, NaN among them) and the
    edges: +-0, subnormals, the smallest normal, the largest finite, +-inf
    and NaN."""
    rng = np.random.default_rng(k)
    scaled = rng.standard_normal(4096) * 10.0 ** rng.integers(-45, 39, 4096)
    patterns = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32).view(np.float32)
    tiny = np.finfo(np.float32).tiny
    edges = np.array([0.0, -0.0, tiny, -tiny, tiny / 2, tiny / 3, 1e-45, -1e-45, 3e-45,
                      np.finfo(np.float32).max, -np.finfo(np.float32).max, np.inf, -np.inf,
                      np.nan, 1.0, -1.0, 1.5, 2.0 ** 127], dtype=np.float32)
    with np.errstate(over="ignore"):
        x = torch.from_numpy(np.concatenate([scaled.astype(np.float32), patterns, edges]))
    quotient = x / torch.exp2(torch.tensor(float(k)))  # as the plain version divides
    product = x * torch.tensor(2.0 ** -k, dtype=torch.float32)
    nan = torch.isnan(quotient)
    assert torch.equal(nan, torch.isnan(product))
    assert torch.equal(_f32_bits(quotient[~nan]), _f32_bits(product[~nan]))
    assert bool((quotient[~nan].abs() < tiny).any())  # subnormal quotients were met


# -------------------------------------------------------------- the update
def _density(pos):
    """A density both packages compute exactly: 30 in a box around the
    centre, plus 2 where x > 0.2 (piecewise constant, so positions one ulp
    apart read the same but on the edges)."""
    if isinstance(pos, torch.Tensor):
        inner = (pos.abs() < 0.6).all(-1)
        return torch.where(inner, 30.0, 0.0) + torch.where(pos[..., 0] > 0.2, 2.0, 0.0)
    inner = jnp.all(jnp.abs(pos) < 0.6, -1)
    return jnp.where(inner, 30.0, 0.0) + jnp.where(pos[..., 0] > 0.2, 2.0, 0.0)


def test_full_update_matches_jax():
    jcfg, _, tcfg, _ = _configs()
    rng = np.random.default_rng(8)
    n = LEVELS * RES**3
    occs0 = rng.exponential(0.01, n).astype(np.float32)
    low0 = rng.exponential(0.005, n).astype(np.float32)
    jstate = {"occs": jnp.asarray(occs0), "occs_low": jnp.asarray(low0),
              "binaries": jnp.zeros(n, bool)}
    key = jax.random.PRNGKey(2)
    jout = j_occ.update_occ_state(jstate, jcfg, _density, 0.01, key, full=True)
    k_jit, _ = jax.random.split(key)
    jitter = torch.from_numpy(np.array(jax.random.uniform(k_jit, (n, 3))))
    tstate = {"occs": torch.from_numpy(occs0), "occs_low": torch.from_numpy(low0)}
    tout = t_occ.update_occ_state(tstate, tcfg, _density, 0.01, jitter)
    assert 0.05 < float(tout["binaries"].float().mean()) < 0.95
    for k in ("binaries", "binaries_pooled"):
        np.testing.assert_array_equal(_np(tout[k]), np.asarray(jout[k]), err_msg=k)
    np.testing.assert_array_equal(_np(tout["packed_words"]),
                                  np.asarray(jout["packed_words"]).astype(np.int64))
    for k in ("occs", "occs_low"):  # the same arithmetic: rtol 1e-6 for XLA's rounding
        np.testing.assert_allclose(_np(tout[k]), np.asarray(jout[k]), rtol=1e-6, atol=0,
                                   err_msg=k)


def test_partial_update_keeps_the_largest_and_the_smallest_probe():
    """Cells drawn twice and three times with probes of different densities:
    occs takes max(old * decay, largest probe), occs_low min(rise, smallest
    probe); cells drawn once as JAX's scatter sets them."""
    _, _, tcfg, _ = _configs()
    rng = np.random.default_rng(9)
    n = LEVELS * RES**3
    occs0 = rng.exponential(0.05, n).astype(np.float32)
    low0 = rng.exponential(0.01, n).astype(np.float32)
    cells = rng.integers(0, RES**3, 600)
    cells[100:200] = cells[:100]  # drawn twice
    cells[200:250] = cells[:50]  # and a third time
    level = rng.integers(0, LEVELS, 600)
    level[100:200], level[200:250] = level[:100], level[:50]
    jitter = rng.random((600, 3)).astype(np.float32)

    def density(p):  # varies inside a cell, so duplicates read apart
        return 10.0 * (p[..., 0] + 3.0) + 5.0 * p[..., 1] ** 2

    tstate = {"occs": torch.from_numpy(occs0), "occs_low": torch.from_numpy(low0)}
    tout = t_occ.update_occ_state(tstate, tcfg, density, 0.01, torch.from_numpy(jitter),
                                  cells=(torch.from_numpy(level), torch.from_numpy(cells)))
    pos = t_occ._level_world_positions(tcfg, torch.from_numpy(level), torch.from_numpy(cells),
                                       torch.from_numpy(jitter))
    probe = _np(density(pos) * 0.01)
    flat = level * RES**3 + cells
    want, want_low = occs0.copy(), low0.copy()
    for f in np.unique(flat):
        p = probe[flat == f]
        want[f] = max(np.float32(occs0[f] * np.float32(0.95)), p.max())
        want_low[f] = min(max(np.float32(low0[f] * 2), np.float32(0.01)), p.min())
    assert (np.bincount(flat)[np.unique(flat)] >= 3).sum() >= 50
    np.testing.assert_array_equal(_np(tout["occs"]), want)
    np.testing.assert_array_equal(_np(tout["occs_low"]), want_low)


def _partial_draws(key, cfg):
    """The draws JAX's update_occ_state(full=False) makes from `key`
    (umhs_tpu/ops/occupancy.py:361-407) and its jitter, for the port."""
    k_jit, k_cells = jax.random.split(key)
    draws = []
    for m_uni, m_occ in t_occ.partial_sample_counts(cfg):
        k_cells, k_uni, k_fall, k_rank = jax.random.split(k_cells, 4)
        draws.append({k: torch.from_numpy(np.array(v)) for k, v in (
            ("uniform", jax.random.randint(k_uni, (m_uni,), 0, cfg.cells_per_level, jnp.int32)),
            ("u", jax.random.uniform(k_rank, (m_occ,))),
            ("fallback", jax.random.randint(k_fall, (m_occ,), 0, cfg.cells_per_level,
                                            jnp.int32)))})
    m = sum(a + b for a, b in t_occ.partial_sample_counts(cfg))
    return draws, torch.from_numpy(np.array(jax.random.uniform(k_jit, (m, 3))))


@pytest.mark.parametrize("bits,levels,res", [
    ("random", LEVELS, RES), ("empty", LEVELS, RES),
    # past the kernel's old 16 levels (K7a reads the draws from a device table)
    ("random", 17, 16), ("random", 20, 16),
], ids=["random", "empty", "random-17-levels", "random-20-levels"])
def test_partial_update_from_draws_matches_jax_on_cells_probed_once(bits, levels, res):
    """The plain route of a partial update from its draws (update_occ_state
    with draws=, as the model calls it since the card chooses the cells):
    against JAX's partial update on every cell probed once or not at all,
    a grid with occupied cells and one without (the fallback cells), and
    grids of 17 and 20 levels; the same bits as the update at
    partial_cells' cells; the caller's state untouched (only the card's
    update takes the grids over)."""
    jcfg, _, tcfg, _ = _configs(levels=levels, res=res)
    rng = np.random.default_rng(12)
    n = levels * res**3
    occs0 = rng.exponential(0.01, n).astype(np.float32)
    low0 = rng.exponential(0.005, n).astype(np.float32)
    b = _bitfield(bits, levels=levels, res=res)
    key = jax.random.PRNGKey(6)
    jout = j_occ.update_occ_state({"occs": jnp.asarray(occs0), "occs_low": jnp.asarray(low0),
                                   "binaries": jnp.asarray(b)}, jcfg, _density, 0.01, key,
                                  full=False)
    draws, jitter = _partial_draws(key, tcfg)
    tstate = {"occs": torch.from_numpy(occs0), "occs_low": torch.from_numpy(low0),
              "binaries": torch.from_numpy(b)}
    before = {k: v.clone() for k, v in tstate.items()}
    tout = t_occ.update_occ_state(tstate, tcfg, _density, 0.01, jitter, draws=draws)
    for k, v in before.items():
        assert torch.equal(tstate[k], v), k
    level, cells = t_occ.partial_cells(tstate, tcfg, draws)
    at_cells = t_occ.update_occ_state(tstate, tcfg, _density, 0.01, jitter,
                                      cells=(level, cells))
    for k in at_cells:
        assert torch.equal(tout[k], at_cells[k]), k
    count = torch.bincount(level * res**3 + cells, minlength=n)
    once = _np(count <= 1)
    assert int((count == 1).sum()) > 500 and int((count > 1).sum()) > 10
    for k in ("occs", "occs_low"):
        np.testing.assert_allclose(_np(tout[k])[once], np.asarray(jout[k])[once], rtol=1e-6,
                                   atol=0, err_msg=k)
    with pytest.raises(ValueError, match="not both"):
        t_occ.update_occ_state(tstate, tcfg, _density, 0.01, jitter, cells=(level, cells),
                               draws=draws)


@pytest.mark.parametrize("pool", [4, 2])
def test_pack_and_pool_match_jax(pool):
    jcfg, _, tcfg, _ = _configs(pool=pool)
    bits = np.random.default_rng(10).random(LEVELS * RES**3) < 0.2
    np.testing.assert_array_equal(_np(t_occ._pool_binaries(torch.from_numpy(bits), tcfg)),
                                  np.asarray(j_occ._pool_binaries(jnp.asarray(bits), jcfg)))
    np.testing.assert_array_equal(
        _np(t_occ._pack_supercell_words(torch.from_numpy(bits), tcfg)),
        np.asarray(j_occ._pack_supercell_words(jnp.asarray(bits), jcfg)).astype(np.int64))


# ------------------------------------------------------------ the dispatch
def test_cpu_tensors_take_the_plain_versions():
    _, _, tcfg, tmarch = _configs()
    _, _, tstate = _states(_bitfield("random"), *_configs()[::2])
    o, d = (torch.from_numpy(a) for a in _rays())
    before = {k.symbol: k.launches for k in (t_march.MARCH_COUNT, t_march.MARCH_EMIT,
                                             t_occ.OCC_UPDATE, t_occ.OCC_PACK)}
    auto = t_march.march_rays(tstate, tcfg, tmarch, o, d, total_budget=4000)
    plain = t_march.march_rays_plain(tstate, tcfg, tmarch, o, d, total_budget=4000)
    for k in auto:
        assert torch.equal(auto[k], plain[k]), k
    n = LEVELS * RES**3
    state = {"occs": torch.zeros(n), "occs_low": torch.zeros(n)}
    jitter = torch.rand((n, 3), generator=torch.Generator().manual_seed(0))
    up = t_occ.update_occ_state(state, tcfg, _density, 0.01, jitter)
    ref = t_occ.update_occ_state_plain(state, tcfg, _density, 0.01, jitter)
    for k in ref:
        assert torch.equal(up[k], ref[k]), k
    after = {k.symbol: k.launches for k in (t_march.MARCH_COUNT, t_march.MARCH_EMIT,
                                            t_occ.OCC_UPDATE, t_occ.OCC_PACK)}
    assert after == before
    with pytest.raises(ValueError, match="impl"):
        t_march.march_rays(tstate, tcfg, tmarch, o, d, impl="fast")
    with pytest.raises(ValueError, match="impl"):
        t_occ.update_occ_state(state, tcfg, _density, 0.01, jitter, impl="fast")


def test_kernel_entry_points_refuse_cpu_tensors():
    _, _, tcfg, tmarch = _configs()
    _, _, tstate = _states(_bitfield("random"), *_configs()[::2])
    o, d = (torch.from_numpy(a) for a in _rays())
    with pytest.raises(ValueError, match="CUDA"):
        t_march.march_rays_cuda(tstate, tcfg, tmarch, o, d)
    n = LEVELS * RES**3
    state = {"occs": torch.zeros(n), "occs_low": torch.zeros(n)}
    with pytest.raises(ValueError, match="CUDA"):
        t_occ.update_occ_state_cuda(state, tcfg, _density, 0.01, torch.rand((n, 3)))
    with pytest.raises(ValueError, match="card"):
        t_occ.threshold_pack_cuda(state["occs"], state["occs"].mean(), tcfg)


@pytest.mark.parametrize("march_kw,pool,layout", [
    # 4096 candidates without a pre-pass: 128 words a stage
    (dict(num_candidates=4096, occ_subsamples=1), 0, (t_march.PRE_NONE, 4096, 0)),
    # a pre-pass of 2048 supercells, 128 of them subdivided
    (dict(num_candidates=8192, occ_subsamples=1), 4, (t_march.QUERY_PACKED, 512, 2048)),
    (dict(num_samples=2), 4, None),  # 2 samples, 4 a cell: the JAX package asserts
])
def test_shapes_beyond_the_kernel_are_refused_before_any_launch(march_kw, pool, layout):
    """K5 takes any stage the JAX march takes (march_layout gives its
    layout: pre-pass query, fine candidates M, pre-pass candidates Ma), and
    refuses, before looking at the device, what the JAX package's
    MarchConfig asserts (samples not a multiple of occ_subsamples) and
    grids past the int32 cell index."""
    _, _, tcfg, tmarch = _configs(pool=pool, **march_kw)
    _, _, tstate = _states(_bitfield("random"), *_configs(pool=pool)[::2])
    o, d = (torch.from_numpy(a) for a in _rays())
    if layout is None:
        with pytest.raises(ValueError, match="multiples of occ_subsamples"):
            t_march.march_layout(tstate, tcfg, tmarch)
        with pytest.raises(ValueError, match="multiples of occ_subsamples"):  # before the device
            t_march.march_rays_cuda(tstate, tcfg, tmarch, o, d)
    else:
        pre, fine, Ma, M = t_march.march_layout(tstate, tcfg, tmarch)
        assert (pre, M, Ma) == layout and fine == t_march.QUERY_PACKED
        with pytest.raises(ValueError, match="CUDA"):  # the shape passes; the CPU tensor not
            t_march.march_rays_cuda(tstate, tcfg, tmarch, o, d)
    big = dataclasses.replace(tcfg, resolution=1024)
    with pytest.raises(ValueError, match="int32"):
        t_occ.check_grid_limits(big, "update_occ_state_cuda")
