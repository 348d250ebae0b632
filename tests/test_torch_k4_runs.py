"""K4's runs route, modelled in numpy on the CPU, and the rule that picks
each level's route.

The runs route (csrc/hash_encode_bwd.cu) takes a chunk of C consecutive
samples at one level, drops the entries whose values are all zero, sorts the
rest stably by the low 16 bits of the level-local row, cuts them into runs
of equal rows, sorts all the chunks' runs stably by row, and adds each row's
runs in that order, one entry at a time from +0. `_runs_model` does the same
in numpy; it must give np.add.at's bits (a sequential sum in ascending entry
order), which are hash_encode_bwd_plain's and, on the CPU, JAX's custom VJP's
(tests/test_torch_grads.py). Inputs are seeded numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umhs_tpu.ops import encodings as j_enc
from umhs_torch.data.synthetic import ray_samples
from umhs_torch.ops import encodings as t_enc

# nerfacto's proposal grids (L5 F2 2^17 to resolution 128 and 256) and the
# flagship's grid (L16 F2 2^19 tetrahedral), by name
CONFIGS = {
    "proposal_0": dict(num_levels=5, max_resolution=128, log2_hashmap_size=17),
    "proposal_1": dict(num_levels=5, max_resolution=256, log2_hashmap_size=17),
    "flagship": dict(num_levels=16, log2_hashmap_size=19, interpolation="tetrahedral"),
}


def _entries(pos, g, cfg, stochastic):
    """Rows (N, L, VE) and their values (N, L, VE, F) in ascending entry
    order e = (s * L + l) * VE + v, as hash_encode_bwd_plain adds them."""
    n, L, F = pos.shape[0], cfg.num_levels, cfg.features_per_level
    gl = g.reshape(n, L, 1, F)
    if stochastic:
        rows = t_enc.stochastic_rows(torch.from_numpy(pos), cfg).numpy()[..., None]
        return rows, gl
    idx, w = t_enc.hash_indices_weights(torch.from_numpy(pos), cfg)
    return idx.numpy(), w.numpy()[..., None] * gl  # f32 products, each rounded once


def _runs_model(pos, g, cfg, stochastic):
    """The table gradient (T * F,) in the runs route's order, and the number
    of runs it made."""
    n, L, F = pos.shape[0], cfg.num_levels, cfg.features_per_level
    rows, vals = _entries(pos, g, cfg, stochastic)
    C = t_enc.hash_encode_bwd_chunk(cfg, stochastic)
    run_rows, run_vals = [], []  # chunk-major within each level
    for lvl in range(L):
        off = cfg.level_offsets[lvl]
        for c0 in range(0, n, C):
            r = rows[c0:c0 + C, lvl].reshape(-1)
            v = vals[c0:c0 + C, lvl].reshape(-1, F)
            keep = (v != 0).any(axis=1)
            r, v = r[keep], v[keep]
            order = np.argsort((r - off) & 0xFFFF, kind="stable")
            r, v = r[order], v[order]
            starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
            for a, b in zip(starts, np.r_[starts[1:], len(r)]):
                run_rows.append(r[a])
                run_vals.append(v[a:b])
    by_row = np.argsort(np.asarray(run_rows, np.int64), kind="stable")
    # each row's runs end to end, then the rows' sums one step at a time
    row_of = np.concatenate([np.full(len(run_vals[i]), run_rows[i]) for i in by_row])
    flat = np.concatenate([run_vals[i] for i in by_row]).astype(np.float32)
    starts = np.r_[0, np.flatnonzero(row_of[1:] != row_of[:-1]) + 1]
    step = np.arange(len(row_of)) - np.repeat(starts, np.diff(np.r_[starts, len(row_of)]))
    table = np.zeros((cfg.table_size, F), np.float32)
    for k in range(int(step.max()) + 1):
        at = step == k
        table[row_of[at]] = table[row_of[at]] + flat[at]  # each row once per step
    return table.reshape(-1), len(run_rows)


def _add_at(pos, g, cfg, stochastic):
    rows, vals = _entries(pos, g, cfg, stochastic)
    F = cfg.features_per_level
    want = np.zeros(cfg.table_size * F, np.float32)
    np.add.at(want, (rows[..., None] * F + np.arange(F)).reshape(-1), vals.reshape(-1))
    return want


def _positions(kind, n, seed):
    """Ray-ordered (64 samples a ray, as the compact buffer holds them),
    uniform with the cube's corners, or all at one point (one row per level
    and vertex holds every entry, over every chunk)."""
    if kind == "rays":
        return ray_samples((n + 63) // 64, 64, seed)[:n]
    if kind == "equal":
        return np.tile(np.float32([[0.3141, 0.5926, 0.5358]]), (n, 1))
    pos = np.random.default_rng(seed).uniform(size=(n, 3)).astype(np.float32)
    pos[:4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.5, 1.0], [0.25, 0.25, 0.25]][:n]
    return pos


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.int32),
                                  np.asarray(b, np.float32).view(np.int32))


# n: several chunks with a short last one, a multiple of every chunk, and
# fewer samples than one chunk
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "stochastic"])
@pytest.mark.parametrize("kind,n", [("rays", 3000), ("random", 3000), ("rays", 4096),
                                    ("random", 200)])
def test_runs_order_gives_the_bits_of_ascending_entry_order(name, stochastic, kind, n):
    cfg = t_enc.HashEncodingConfig(**CONFIGS[name])
    pos = _positions(kind, n, seed=n + len(name))
    g = np.random.default_rng(n).normal(size=(n, cfg.output_dim)).astype(np.float32)
    g[::5] = 0.0  # samples that add nothing, as the compact buffer's padding
    g[1::7, :2] = 0.0  # a level whose values are all zero in some samples
    got, runs = _runs_model(pos, g, cfg, stochastic)
    want = _add_at(pos, g, cfg, stochastic)
    assert np.abs(want).max() > 1.0 and runs > 0
    _bits_equal(got, want)
    plain = t_enc.hash_encode_bwd_plain(torch.from_numpy(pos), torch.from_numpy(g), cfg,
                                        stochastic).numpy()
    _bits_equal(got, plain)


@pytest.mark.parametrize("name", ["proposal_0", "flagship"])
def test_runs_order_on_a_row_spanning_many_chunks(name):
    """Every sample at one point: each level's vertex rows hold an entry of
    every sample, across all the chunks, in one run per chunk and row."""
    cfg = t_enc.HashEncodingConfig(**CONFIGS[name])
    n = 5 * t_enc.hash_encode_bwd_chunk(cfg, False) + 17
    pos = _positions("equal", n, seed=0)
    g = np.random.default_rng(1).normal(size=(n, cfg.output_dim)).astype(np.float32)
    got, runs = _runs_model(pos, g, cfg, False)
    assert runs <= 6 * cfg.num_levels * cfg.verts_per_cell
    _bits_equal(got, _add_at(pos, g, cfg, False))


def test_runs_order_matches_the_jax_vjp_on_a_proposal_grid():
    """The model's table against JAX's custom VJP of the same grid on the
    CPU, within the atol 1e-6 that test_hash_backward_deterministic_matches_jax_vjp
    holds the plain version to."""
    kw = dict(num_levels=5, max_resolution=128, log2_hashmap_size=17)
    jcfg = j_enc.HashEncodingConfig(stochastic_grad=False, **kw)
    tcfg = t_enc.HashEncodingConfig(stochastic_grad=False, **kw)
    pos = _positions("rays", 2560, seed=3)
    rng = np.random.default_rng(4)
    table = rng.uniform(-1, 1, tcfg.table_size * 2).astype(np.float32)
    g = rng.normal(size=(pos.shape[0], tcfg.output_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_enc.hash_encode(t, jnp.asarray(pos), jcfg), jnp.asarray(table))
    jgrad = np.asarray(vjp(jnp.asarray(g))[0])
    got, _ = _runs_model(pos, g, tcfg, False)
    assert np.abs(jgrad).max() > 1.0
    np.testing.assert_allclose(got, jgrad, rtol=0, atol=1e-6)


# ------------------------------------------------------------- the route rule
FLAGSHIP_N = (4096, 262144, 4096 * 64 * 4)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "stochastic"])
@pytest.mark.parametrize("n", [0, 1, 3000, 786432, 2097152])
def test_route_rule_names_a_route_per_level(name, stochastic, n):
    """A pure function of (config, n, mode): one name of HASH_BWD_ROUTES per
    level, the same on every call, "runs" only in the deterministic mode on
    trilinear levels of resolution <= RUNS_MAX_RESOLUTION."""
    cfg = t_enc.HashEncodingConfig(**CONFIGS[name])
    route = t_enc.hash_encode_bwd_route(cfg, n, stochastic)
    assert isinstance(route, tuple) and len(route) == cfg.num_levels
    assert set(route) <= set(t_enc.HASH_BWD_ROUTES)
    assert route == t_enc.hash_encode_bwd_route(
        t_enc.HashEncodingConfig(**CONFIGS[name]), n, stochastic)
    for r, res in zip(route, cfg.resolutions):
        if r == "runs":
            assert not stochastic and cfg.interpolation == "trilinear"
            assert res <= t_enc.RUNS_MAX_RESOLUTION


def test_route_rule_at_the_measured_shapes():
    """nerfacto's grids take runs where they pay (PERF.md section 6): grid 0
    on every level, grid 1 but for its finest (res 256); its main trilinear
    L16 2^19 hash on levels 0-3 at 8192 rays x 48 samples; the flagship's
    tetrahedral grid keeps the entries route everywhere, in both modes."""
    route = t_enc.hash_encode_bwd_route
    p0 = t_enc.HashEncodingConfig(**CONFIGS["proposal_0"])
    p1 = t_enc.HashEncodingConfig(**CONFIGS["proposal_1"])
    main = t_enc.HashEncodingConfig(num_levels=16, log2_hashmap_size=19, max_resolution=2048)
    assert route(p0, 2097152, False) == ("runs",) * 5
    assert route(p1, 786432, False) == ("runs",) * 4 + ("entries",)
    assert route(main, 393216, False) == ("runs",) * 4 + ("entries",) * 12
    for cfg, n in ((p0, 2097152), (p1, 786432), (main, 393216)):
        assert route(cfg, n, True) == ("entries",) * cfg.num_levels


@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "stochastic"])
@pytest.mark.parametrize("n", FLAGSHIP_N)
def test_route_rule_keeps_the_flagships_fine_levels_on_entries(stochastic, n):
    """The flagship's levels finer than RUNS_MAX_RESOLUTION (7-15, at ~1.1
    entries per run) keep the per-entry route, at any n."""
    for interp in ("tetrahedral", "trilinear"):
        cfg = t_enc.HashEncodingConfig(num_levels=16, log2_hashmap_size=19, interpolation=interp)
        route = t_enc.hash_encode_bwd_route(cfg, n, stochastic)
        fine = [lvl for lvl, res in enumerate(cfg.resolutions) if res > t_enc.RUNS_MAX_RESOLUTION]
        assert fine == list(range(7, 16))
        assert all(route[lvl] == "entries" for lvl in fine)


def test_route_rule_takes_runs_only_where_rows_repeat():
    """A level takes runs only where its rows get RUNS_MIN_ENTRIES_PER_ROW of
    the n * 8 entries on average: fewer samples move the finer levels to the
    entries route first, and no samples leave every level there."""
    cfg = t_enc.HashEncodingConfig(**CONFIGS["proposal_0"])
    counts = [t_enc.hash_encode_bwd_route(cfg, n, False).count("runs")
              for n in (0, 1, 8192, 65536, 262144, 2097152)]
    assert counts == sorted(counts) and counts[0] == 0 and counts[-1] == cfg.num_levels
    with pytest.raises(ValueError):
        t_enc.hash_encode_bwd_route(cfg, -1, False)


@pytest.mark.parametrize("features,entries", [(1, 2048), (2, 2048), (4, 1024), (8, 512)])
@pytest.mark.parametrize("interp,verts", [("trilinear", 8), ("tetrahedral", 4)])
def test_chunk_is_the_kernels(features, entries, interp, verts):
    """hash_encode_bwd_chunk: samples per chunk, as the kernel's
    chunk_entries(F) entries over the entries per sample (V, or 1 when
    stochastic)."""
    cfg = t_enc.HashEncodingConfig(features_per_level=features, interpolation=interp)
    assert t_enc.hash_encode_bwd_chunk(cfg, False) == entries // verts
    assert t_enc.hash_encode_bwd_chunk(cfg, True) == entries


# --------------------------------------------------- the any kernels' order
# grids past the template instances (odd F, F past a feature group of 8,
# more than 32 levels), as K4's any route takes them
ANY_CONFIGS = {
    "L40xF7-tetrahedral": dict(num_levels=40, features_per_level=7, log2_hashmap_size=12,
                               max_resolution=512, interpolation="tetrahedral"),
    "L40xF7-trilinear": dict(num_levels=40, features_per_level=7, log2_hashmap_size=12,
                             max_resolution=512, interpolation="trilinear"),
    "L33xF16-trilinear": dict(num_levels=33, features_per_level=16, log2_hashmap_size=10,
                              max_resolution=256, interpolation="trilinear"),
}
ANY_DIGIT_BITS = 9  # csrc/hash_encode_bwd.cu kAnyDigitBits


def _level_major_entries(pos, g, cfg, stochastic):
    """The entries of the any route's emit, level-major (slot
    ((l * n) + s) * VE + v), those whose values are all zero dropped:
    their rows and values."""
    F = cfg.features_per_level
    rows, vals = _entries(pos, g, cfg, stochastic)
    r = np.ascontiguousarray(rows.transpose(1, 0, 2)).reshape(-1)
    v = np.ascontiguousarray(np.broadcast_to(vals, rows.shape + (F,)).transpose(1, 0, 2, 3))
    v = v.reshape(-1, F)
    keep = (v != 0).any(axis=1)
    return r[keep], v[keep]


def _sum_runs(row_of, flat, table):
    """Each run of equal rows added onto its table row in order, one entry
    a step (the rows' sums go on from what `table` holds)."""
    starts = np.r_[0, np.flatnonzero(row_of[1:] != row_of[:-1]) + 1]
    step = np.arange(len(row_of)) - np.repeat(starts, np.diff(np.r_[starts, len(row_of)]))
    for k in range(int(step.max()) + 1 if len(step) else 0):
        at = step == k
        table[row_of[at]] = table[row_of[at]] + flat[at]
    return len(starts)


def _any_entries_model(pos, g, cfg, stochastic, ranges=1):
    """The any route's entries order: the level-major entries sorted stably
    by the low 9-bit digits that tell one level's rows apart (as many as
    the largest level needs), summed run by run from the table, the samples
    in `ranges` consecutive ranges (each range's sums going on from the
    ones before). Returns the table and whether every row's entries formed
    one run."""
    F = cfg.features_per_level
    largest = max(cfg.level_sizes)
    passes = max(1, -(-int(np.ceil(np.log2(largest))) // ANY_DIGIT_BITS))
    mask = (1 << (ANY_DIGIT_BITS * passes)) - 1
    table = np.zeros((cfg.table_size, F), np.float32)
    one_run = True
    for part in np.array_split(np.arange(pos.shape[0]), ranges):
        r, v = _level_major_entries(pos[part], g[part], cfg, stochastic)
        order = np.argsort(r & mask, kind="stable")
        r, v = r[order], v[order]
        runs = _sum_runs(r, v.astype(np.float32), table)
        one_run = one_run and runs == len(np.unique(r))
    return table.reshape(-1), one_run


@pytest.mark.parametrize("name", list(ANY_CONFIGS))
@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "stochastic"])
@pytest.mark.parametrize("kind,n,ranges", [("rays", 1500, 1), ("random", 1500, 1),
                                           ("rays", 1500, 3), ("equal", 300, 2)])
def test_any_route_order_gives_the_bits_of_ascending_entry_order(name, stochastic, kind, n,
                                                                 ranges):
    """The any route's level-local sort keeps each row's entries in one run
    in ascending entry order (two levels' rows with the same low bits stay
    apart, in level order), so its sums are np.add.at's bits, and the plain
    version's; cut into sample ranges whose sums go on from the table, the
    same bits."""
    cfg = t_enc.HashEncodingConfig(**ANY_CONFIGS[name])
    assert not t_enc.hash_kernel_fixed(cfg)
    pos = _positions(kind, n, seed=n + ranges)
    g = np.random.default_rng(n).normal(size=(n, cfg.output_dim)).astype(np.float32)
    g[::5] = 0.0
    got, one_run = _any_entries_model(pos, g, cfg, stochastic, ranges)
    assert one_run
    want = _add_at(pos, g, cfg, stochastic)
    assert np.abs(want).max() > 1.0
    _bits_equal(got, want)
    plain = t_enc.hash_encode_bwd_plain(torch.from_numpy(pos), torch.from_numpy(g), cfg,
                                        stochastic).numpy()
    _bits_equal(got, plain)


def test_any_route_sorts_two_levels_rows_apart_by_level():
    """The reason one level-local sort serves every level: rows of two levels
    can share their low bits (levels 0 and 1 of 4,096 rows each: rows r and
    r + 4,096), and a stable sort by those bits alone keeps level 0's run
    before level 1's, each whole."""
    cfg = t_enc.HashEncodingConfig(num_levels=40, features_per_level=7, log2_hashmap_size=12,
                                   max_resolution=512, interpolation="trilinear")
    sizes = cfg.level_sizes
    assert sizes[0] == sizes[1] == 4096 and max(sizes) <= 4096
    pos = _positions("random", 500, seed=0)
    r, _ = _level_major_entries(pos, np.ones((500, cfg.output_dim), np.float32), cfg, False)
    low = r & 0xFFF
    shared = np.intersect1d(low[r < 4096], low[(r >= 4096) & (r < 8192)])
    assert shared.size > 100  # the same low bits at both levels
    order = np.argsort(low, kind="stable")
    sr, sl = r[order], low[order]
    for b in shared:
        got = sr[sl == b]
        assert (np.diff(got) >= 0).all()  # each level's rows together, level by level
        assert len(np.unique(got)) == 1 + int((np.diff(got) != 0).sum())


@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "stochastic"])
def test_any_route_runs_order_gives_the_bits_of_ascending_entry_order(stochastic):
    """The runs route on the any kernels, a feature group at a time (its
    chunk the group's, hash_encode_bwd_chunk): np.add.at's bits."""
    cfg = t_enc.HashEncodingConfig(**ANY_CONFIGS["L40xF7-trilinear"])
    n = 3 * t_enc.hash_encode_bwd_chunk(cfg, stochastic) + 11
    pos = _positions("rays", n, seed=7)
    g = np.random.default_rng(8).normal(size=(n, cfg.output_dim)).astype(np.float32)
    got, runs = _runs_model(pos, g, cfg, stochastic)
    assert runs > 0
    _bits_equal(got, _add_at(pos, g, cfg, stochastic))


@pytest.mark.parametrize("features,entries", [(3, 1280), (5, 768), (6, 512), (7, 512),
                                              (16, 512), (33, 512)])
def test_chunk_of_the_any_kernels(features, entries):
    """hash_encode_bwd_chunk past the template instances: the first feature
    group's (at most 8 features) chunk_entries, whole 256-thread blocks."""
    cfg = t_enc.HashEncodingConfig(num_levels=40, features_per_level=features,
                                   interpolation="trilinear")
    assert t_enc.hash_encode_bwd_chunk(cfg, True) == entries
    assert t_enc.hash_encode_bwd_chunk(cfg, False) == entries // 8


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
def test_route_rule_on_the_any_kernels(interp):
    """The any kernels take the fixed ones' rule: "runs" on trilinear
    levels in the deterministic mode where rows repeat, "entries" elsewhere
    (configs C and E's tetrahedral grid: every level)."""
    cfg = t_enc.HashEncodingConfig(num_levels=40, features_per_level=7, log2_hashmap_size=17,
                                   interpolation=interp)
    assert not t_enc.hash_kernel_fixed(cfg)
    det = t_enc.hash_encode_bwd_route(cfg, 262144, False)
    assert t_enc.hash_encode_bwd_route(cfg, 262144, True) == ("entries",) * 40
    if interp == "tetrahedral":
        assert det == ("entries",) * 40
    else:
        assert det[0] == "runs" and det[-1] == "entries"
