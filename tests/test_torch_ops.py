"""umhs_torch leaf ops against their umhs_tpu counterparts, on the CPU.

Inputs come from numpy with a seed and go through both packages. The JAX
fused MLP runs its Pallas kernel in interpret mode, as tests/test_pallas_mlp.py
does; the port's K1 and K3 run their plain versions (CPU tensors).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from umhs_tpu.ops import activations as j_act
from umhs_tpu.ops import compositing as j_comp
from umhs_tpu.ops import encodings as j_enc
from umhs_tpu.ops import spec_to_rgb as j_s2r
from umhs_tpu.ops.pallas.mlp_fused import mlp_apply_fused
from umhs_tpu.utils import clusterprobe as j_cp
from umhs_torch.ops import activations as t_act
from umhs_torch.ops import compositing as t_comp
from umhs_torch.ops import encodings as t_enc
from umhs_torch.ops import spec_to_rgb as t_s2r
from umhs_torch.ops.mlp import apply_mlp, init_mlp
from umhs_torch.ops.mlp_fused import mlp_fused_fwd, mlp_plain
from umhs_torch.utils import clusterprobe as t_cp


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


# --------------------------------------------------------------- leaf ops
def test_trunc_exp_matches():
    x = np.random.default_rng(0).normal(scale=8.0, size=(4096,)).astype(np.float32)
    x[:3] = [-40.0, 15.0, 40.0]
    np.testing.assert_allclose(_np(t_act.trunc_exp(_t(x))),
                               np.asarray(j_act.trunc_exp(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("num_frequencies,include_input", [(2, False), (4, True)])
def test_nerf_encoding_matches(num_frequencies, include_input):
    x = np.random.default_rng(1).uniform(-2, 2, (500, 3)).astype(np.float32)
    kw = dict(num_frequencies=num_frequencies, max_freq_exp=num_frequencies - 1.0,
              include_input=include_input)
    np.testing.assert_allclose(_np(t_enc.nerf_encoding(_t(x), **kw)),
                               np.asarray(j_enc.nerf_encoding(jnp.asarray(x), **kw)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_sh_encoding_matches(levels):
    d = np.random.default_rng(2).normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(_np(t_enc.sh_encoding(_t(d), levels)),
                               np.asarray(j_enc.sh_encoding(jnp.asarray(d), levels)),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------ K1 plain version
def _mlp_params(dims, seed):
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
        ([27, 64, 64, 5], 300, "float32", 1e-5),
        ([27, 64, 64, 5], 1500, "bfloat16", 2e-2),
        ([32, 64, 16], 1300, "float32", 1e-5),  # N not a multiple of the tile
        ([28, 16, 128], 1300, "bfloat16", 2e-2),
        ([32, 16], 700, "float32", 1e-5),  # a single layer
        # the DINO head, on K1's wide route on the card: N off the 1024 tile, 1, 33
        ([15, 256, 128], 1300, "bfloat16", 2e-2),
        ([15, 256, 128], 1300, "float32", 1e-5),
        ([15, 256, 128], 1, "bfloat16", 2e-2),
        ([15, 256, 128], 1, "float32", 1e-5),
        ([15, 256, 128], 33, "bfloat16", 2e-2),
        ([15, 256, 128], 33, "float32", 1e-5),
        ([32, 256, 64, 8], 1300, "bfloat16", 2e-2),  # three layers wider than 128
        ([32, 256, 64, 8], 1300, "float32", 1e-5),
        # the chains past the kernels' old limits, the general route on the
        # card: 281 bands, 280 hash features, weights past shared memory, and
        # ten layers
        *[(dims, n, dt, 1e-5 if dt == "float32" else 2e-2)
          for dims, n in (([28, 16, 281], 200), ([280, 64, 16], 200),
                          ([64, 256, 256, 256], 100), ([24] + [32] * 9 + [8], 200))
          for dt in ("float32", "bfloat16")],
    ],
)
def test_k1_plain_matches_pallas_interpret(dims, n, dtype, tol):
    jp, tp = _mlp_params(dims, seed=len(dims) + n)
    x = np.random.default_rng(n).normal(size=(n, dims[0])).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(mlp_apply_fused(jp, jnp.asarray(x), compute_dtype=getattr(jnp, dtype)))
    tdt = getattr(torch, dtype)
    out = mlp_plain(tp, _t(x), tdt)
    np.testing.assert_allclose(_np(out), ref, rtol=tol, atol=tol)
    # on a CPU tensor the kernel wrapper and apply_mlp run the plain version
    np.testing.assert_array_equal(_np(mlp_fused_fwd(tp, _t(x), tdt)), _np(out))
    np.testing.assert_array_equal(_np(apply_mlp(tp, _t(x), compute_dtype=tdt)), _np(out))


def test_apply_mlp_shapes_activation_and_impl():
    tp = init_mlp(torch.Generator().manual_seed(0), 6, 3, 8, 4)
    assert [tuple(lay["w"].shape) for lay in tp["layers"]] == [(6, 8), (8, 8), (8, 4)]
    assert all(float(lay["w"].abs().max()) <= 1 / np.sqrt(lay["w"].shape[0])
               for lay in tp["layers"])
    x = torch.randn(5, 7, 6, generator=torch.Generator().manual_seed(1))
    y = apply_mlp(tp, x, out_activation=torch.sigmoid)
    assert y.shape == (5, 7, 4) and float(y.min()) > 0.0 and float(y.max()) < 1.0
    np.testing.assert_array_equal(
        _np(apply_mlp(tp, x, impl="plain")), _np(apply_mlp(tp, x, impl="auto")))
    with pytest.raises(ValueError):
        apply_mlp(tp, x, impl="fast")


# ------------------------------------------------------ K3 plain version
def _hash_pair(interp, levels=6, features=2):
    kw = dict(num_levels=levels, features_per_level=features, log2_hashmap_size=12,
              max_resolution=256, interpolation=interp)
    return j_enc.HashEncodingConfig(**kw), t_enc.HashEncodingConfig(**kw)


# (L, F) past the kernels' old limits (more than 32 levels, F other than 1,
# 2, 4, 8), beside L6xF2; the ids without a suffix are the cases these
# tests always had
HASH_SHAPE_CASES = [pytest.param(interp, shape, id=interp + ("" if shape == (6, 2) else
                                                             "-L{}xF{}".format(*shape)))
                    for shape in ((6, 2), (40, 7), (16, 3), (33, 16))
                    for interp in ("tetrahedral", "trilinear")]


def _hash_inputs(cfg, n=4000, seed=3):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1e-4, 1e-4, cfg.table_size * cfg.features_per_level).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    pos[:4] = [[0, 0, 0], [1, 1, 1], [0, 0.5, 1], [0.25, 0.25, 0.25]]  # edges and ties
    return table, pos


def test_hash_config_matches():
    jc, tc = _hash_pair("tetrahedral")
    for name in ("scales", "resolutions", "level_sizes", "level_offsets", "table_size",
                 "output_dim", "verts_per_cell", "growth_factor"):
        assert getattr(jc, name) == getattr(tc, name), name
    # the test config has dense and hashed levels
    assert tc.dense[0] and not tc.dense[-1]
    flag = j_enc.HashEncodingConfig()
    assert t_enc.HashEncodingConfig().table_size == flag.table_size == 6_098_108


@pytest.mark.parametrize("interp,shape", HASH_SHAPE_CASES)
def test_k3_plain_matches_hash_encode(interp, shape):
    jc, tc = _hash_pair(interp, *shape)
    table, pos = _hash_inputs(jc)
    ref = np.asarray(j_enc.hash_encode(jnp.asarray(table), jnp.asarray(pos), jc))
    out = t_enc.hash_encode(_t(table), _t(pos), tc)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(_np(t_enc.hash_encode_fwd(_t(table), _t(pos), tc)), _np(out))


def test_k3_plain_matches_reference():
    jc, tc = _hash_pair("trilinear")
    table, pos = _hash_inputs(jc, seed=4)
    ref = np.asarray(j_enc.hash_encode_reference(jnp.asarray(table), jnp.asarray(pos), jc))
    np.testing.assert_allclose(_np(t_enc.hash_encode(_t(table), _t(pos), tc)), ref, atol=1e-7)
    np.testing.assert_allclose(_np(t_enc.hash_encode_reference(_t(table), _t(pos), tc)), ref,
                               atol=1e-7)


def test_hash_index_wraps_uint32():
    # coordinates whose prime products overflow uint32: the int64 plain
    # version must wrap exactly like the TPU's uint32 arithmetic
    c = np.array([[4095, 4095, 4095], [3000, 17, 2900]], np.int64)
    mask = (1 << 19) - 1
    expect = [  # uint32 arithmetic: Python ints reduced mod 2^32
        (((x * 1) % 2**32) ^ ((y * 2654435761) % 2**32) ^ ((z * 805459861) % 2**32)) & mask
        for x, y, z in c.tolist()
    ]
    assert any(y * 2654435761 >= 2**32 for _, y, _ in c.tolist())
    cx, cy, cz = (torch.from_numpy(c[:, i]) for i in range(3))
    got = t_enc._row_index(cx, cy, cz, res=4096, dense=torch.tensor(False),
                           offsets=0, mask=mask)
    assert got.tolist() == expect


# --------------------------------------------------------- compositing
def _march_like(seed=5, R=64, S=24):
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.001, 0.05, (R, S)).astype(np.float32)
    t_starts = (np.cumsum(dt, axis=1) - dt + 0.5).astype(np.float32)
    t_ends = (t_starts + dt).astype(np.float32)
    sigmas = rng.exponential(20.0, (R, S)).astype(np.float32)
    mask = rng.uniform(size=(R, S)) < 0.8
    return t_starts, t_ends, sigmas, mask


@pytest.mark.parametrize("alpha_thre", [0.0, 0.01])
def test_render_weights_depth_accumulation_match(alpha_thre):
    ts, te, sg, m = _march_like()
    jw = j_comp.render_weights(*map(jnp.asarray, (ts, te, sg, m)), alpha_thre=alpha_thre)
    tw = t_comp.render_weights(*map(_t, (ts, te, sg, m)), alpha_thre=alpha_thre)
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(t_comp.render_accumulation(tw)),
                               np.asarray(j_comp.render_accumulation(jw)), atol=1e-6)
    jd = j_comp.render_depth_expected(jw, jnp.asarray(ts), jnp.asarray(te), jnp.asarray(m))
    td = t_comp.render_depth_expected(tw, _t(ts), _t(te), _t(m))
    np.testing.assert_allclose(_np(td), np.asarray(jd), rtol=1e-5)
    vals = np.random.default_rng(6).uniform(size=(*ts.shape, 5)).astype(np.float32)
    np.testing.assert_allclose(_np(t_comp.accumulate(tw, _t(vals))),
                               np.asarray(j_comp.accumulate(jw, jnp.asarray(vals))), atol=1e-5)


def test_segment_accumulate_matches():
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 6, 40).astype(np.int32)
    counts[:3] = 0
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    wv = rng.normal(size=(int(counts.sum()) + 9, 4)).astype(np.float32)
    ref = j_comp.segment_accumulate(jnp.asarray(wv), jnp.asarray(starts), jnp.asarray(counts))
    out = t_comp.segment_accumulate(_t(wv), _t(starts), _t(counts))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)


# ---------------------------------------------- colour and segmentation
def test_colour_system_matches():
    wl = 400.0 + 2.0 * np.arange(128)
    np.testing.assert_array_equal(t_s2r.build_spec_to_rgb_matrix(wl),
                                  j_s2r.build_spec_to_rgb_matrix(wl))
    spec = np.random.default_rng(8).uniform(0, 1.2, (300, 128)).astype(np.float32)
    np.testing.assert_allclose(_np(t_s2r.ColourSystem(wl)(_t(spec))),
                               np.asarray(j_s2r.ColourSystem(wl)(jnp.asarray(spec))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("alpha,log_probs", [(0.2, False), (0.2, True), (None, False)])
def test_cluster_probe_and_palette_match(alpha, log_probs):
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(200, 16)).astype(np.float32)
    clusters = rng.normal(size=(6, 16)).astype(np.float32)
    ji, jp = j_cp.cluster_probe(jnp.asarray(feats), jnp.asarray(clusters), alpha, log_probs)
    ti, tp = t_cp.cluster_probe(_t(feats), _t(clusters), alpha, log_probs)
    np.testing.assert_allclose(_np(ti), np.asarray(ji), atol=1e-6)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), atol=1e-6)
    labels = np.arange(40) % 23
    np.testing.assert_allclose(_np(t_cp.label_to_rgb(_t(labels))),
                               np.asarray(j_cp.label_to_rgb(jnp.asarray(labels))), atol=1e-7)
