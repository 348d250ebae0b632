"""umhs_torch's hand-written kernels against their plain versions, on the card.

Marked `cuda` and skipped without an NVIDIA card. On a machine with one
(it needs no JAX, so skip the repo's conftest, which imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

chip_smoke.py runs the same checks at the flagship shapes; these cover the
edge cases at small sizes, including the 256-wide chain of the DINO head,
and a small training step with the kernels against the plain path.
"""

import dataclasses

import numpy as np
import pytest
import torch

from umhs_torch.data.cameras import generate_camera_rays
from umhs_torch.data.synthetic import (
    SyntheticSceneConfig, ray_samples, render_views, scene_cameras)
from umhs_torch.engine.trainer import Trainer, TrainerConfig
from umhs_torch.models.model import ModelConfig
from umhs_torch.data.datamanager import DataManagerConfig, InMemoryDataManager
from umhs_torch.engine.trainer import named_leaves
from umhs_torch.ops._native import KERNELS
from umhs_torch.ops.encodings import (
    HASH_ENCODE_BWD, HASH_ENCODE_FWD, HashEncodingConfig, hash_encode_bwd,
    hash_encode_bwd_plain, hash_encode_fwd, hash_encode_plain)
from umhs_torch.ops.mlp import init_mlp
from umhs_torch.ops.mlp_fused import (
    MLP_FUSED_BWD, MLP_FUSED_FWD, mlp_fused, mlp_fused_bwd, mlp_fused_fwd, mlp_plain,
    mlp_plain_bwd)
from umhs_torch.ops.row_gather import ROW_GATHER, row_gather, row_gather_plain

pytestmark = pytest.mark.cuda
# the kernels a training step launches (P1, the row gather, is on no path)
TRAIN_KERNELS = sorted(k.symbol for k in (MLP_FUSED_FWD, MLP_FUSED_BWD, HASH_ENCODE_FWD,
                                          HASH_ENCODE_BWD))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "dims",
    [[32, 64, 16], [27, 64, 64, 7], [28, 16, 128], [32, 16], [15, 256, 128], [5, 3, 9, 2, 4]],
    ids=lambda d: "-".join(map(str, d)),
)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 3001])
def test_k1_matches_plain(cuda, dims, dtype, tol, n):
    gen = torch.Generator().manual_seed(n + len(dims))
    params = {"layers": [
        {"w": ((torch.rand((a, b), generator=gen) * 2 - 1) / a**0.5).to(cuda),
         "b": ((torch.rand((b,), generator=gen) * 2 - 1) / a**0.5).to(cuda)}
        for a, b in zip(dims[:-1], dims[1:])]}
    x = torch.randn((n, dims[0]), generator=gen).to(cuda)
    before = MLP_FUSED_FWD.launches
    y = mlp_fused_fwd(params, x, dtype)
    torch.cuda.synchronize()
    assert MLP_FUSED_FWD.launches == before + 1
    assert y.shape == (n, dims[-1]) and y.dtype == torch.float32
    torch.testing.assert_close(y, mlp_plain(params, x, dtype), rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "dims",
    [[32, 64, 16], [27, 64, 64, 7], [27, 64, 64, 6], [28, 16, 128], [5, 3, 9, 2, 4],
     [15, 256, 128]],
    ids=lambda d: "-".join(map(str, d)),
)
def test_k1_bf16_at_odd_n(cuda, dims):
    """bf16 at n = 2^16 - 333 (a partial last tile): the four field chains
    and the odd widths run on the tensor cores, the 256-wide chain on the FMA
    kernel by its shape; one launch each, within 2e-2 of the plain version.
    An x 4 bytes off 16-byte alignment gives the same result."""
    n = (1 << 16) - 333
    gen = torch.Generator().manual_seed(len(dims) + dims[-1])
    params = _chain(dims, gen, cuda)
    x = torch.randn((n, dims[0]), generator=gen).to(cuda)
    before = MLP_FUSED_FWD.launches
    y = mlp_fused_fwd(params, x, torch.bfloat16)
    torch.cuda.synchronize()
    assert MLP_FUSED_FWD.launches == before + 1
    ref = mlp_plain(params, x, torch.bfloat16)
    torch.testing.assert_close(y, ref, rtol=2e-2, atol=2e-2)
    off = torch.empty(n * dims[0] + 1, device=cuda)[1:].view(n, dims[0])
    off.copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    assert torch.equal(mlp_fused_fwd(params, off, torch.bfloat16), y)
    assert MLP_FUSED_FWD.launches == before + 2


def test_k1_rejects_what_it_does_not_take(cuda):
    params = init_mlp(torch.Generator().manual_seed(0), 8, 2, 16, 4, cuda)
    x = torch.randn(64, 8, device=cuda)
    with pytest.raises(ValueError):
        mlp_fused_fwd(params, x.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        mlp_fused_fwd(params, x.double())
    with pytest.raises(ValueError):
        mlp_fused_fwd(params, x[:, :6].contiguous())  # widths do not chain
    wide = init_mlp(torch.Generator().manual_seed(0), 8, 2, 300, 4, cuda)
    with pytest.raises(ValueError):
        mlp_fused_fwd(wide, x)


def _chain(dims, gen, dev):
    return {"layers": [
        {"w": ((torch.rand((a, b), generator=gen) * 2 - 1) / a**0.5).to(dev),
         "b": ((torch.rand((b,), generator=gen) * 2 - 1) / a**0.5).to(dev)}
        for a, b in zip(dims[:-1], dims[1:])]}


@pytest.mark.parametrize(
    "dims",
    [[32, 64, 16], [27, 64, 64, 7], [28, 16, 128], [32, 16], [15, 256, 128], [5, 3, 9, 2, 4]],
    ids=lambda d: "-".join(map(str, d)),
)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 3001])
def test_k2_matches_plain(cuda, dims, dtype, tol, n):
    """dx, dW, db against autograd of mlp_plain; f32 1e-4 as the Pallas
    backward's test, bf16 2e-2 (sums in another order; the plain path rounds
    dx to bf16 and keeps the output gradient in f32)."""
    gen = torch.Generator().manual_seed(7 * n + len(dims))
    params = _chain(dims, gen, cuda)
    x = torch.randn((n, dims[0]), generator=gen).to(cuda)
    g = torch.randn((n, dims[-1]), generator=gen).to(cuda)
    before = MLP_FUSED_BWD.launches
    dx, grads = mlp_fused_bwd(params, x, g, dtype)
    torch.cuda.synchronize()
    assert MLP_FUSED_BWD.launches == before + 1
    dx_ref, grads_ref = mlp_plain_bwd(params, x, g, dtype)
    # scale the atol by each tensor's size: dW and db sum over all N rows
    for got, ref in [(dx, dx_ref)] + [t for pair in zip(grads, grads_ref) for t in zip(*pair)]:
        assert got.shape == ref.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, ref, rtol=tol, atol=tol * float(ref.abs().max()) + tol)
    again = mlp_fused_bwd(params, x, g, dtype)[1]
    for (w1, b1), (w2, b2) in zip(grads, again):  # the fixed-order reduction repeats bit for bit
        assert torch.equal(w1, w2) and torch.equal(b1, b2)


def test_k2_skips_dx_and_trains_through_the_function(cuda):
    gen = torch.Generator().manual_seed(3)
    params = _chain([28, 16, 128], gen, cuda)
    x = torch.randn((777, 28), generator=gen).to(cuda)
    g = torch.randn((777, 128), generator=gen).to(cuda)
    dx, grads = mlp_fused_bwd(params, x, g, torch.float32, need_dx=False)
    assert dx is None
    ref = mlp_plain_bwd(params, x, g, torch.float32, need_dx=False)[1]
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-3)
    leaves = [t.requires_grad_(True) for lay in params["layers"] for t in (lay["w"], lay["b"])]
    fwd, bwd = MLP_FUSED_FWD.launches, MLP_FUSED_BWD.launches
    (mlp_fused(params, x) * g).sum().backward()  # x needs no gradient
    torch.cuda.synchronize()
    assert (MLP_FUSED_FWD.launches, MLP_FUSED_BWD.launches) == (fwd + 1, bwd + 1)
    for t, want in zip(leaves, [w for pair in ref for w in pair]):
        torch.testing.assert_close(t.grad, want, rtol=1e-4, atol=1e-3)


def test_k2_rejects_what_it_does_not_take(cuda):
    params = init_mlp(torch.Generator().manual_seed(0), 8, 2, 16, 4, cuda)
    x = torch.randn(64, 8, device=cuda)
    with pytest.raises(ValueError):
        mlp_fused_bwd(params, x, torch.randn(64, 5, device=cuda))  # g of the wrong width
    with pytest.raises(ValueError):
        mlp_fused_bwd(params, x, torch.randn(64, 4, device=cuda).double())
    with pytest.raises(ValueError):
        mlp_fused_bwd(params, x.t().contiguous().t(), torch.randn(64, 4, device=cuda))


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
@pytest.mark.parametrize("levels,log2,features", [(6, 12, 2), (16, 19, 2), (8, 14, 4), (4, 10, 1)])
def test_k4_matches_plain(cuda, interp, levels, log2, features):
    """Deterministic: atol 1e-5 on sums of ~1e0 terms (float atomics add in
    another order on every run). Stochastic: the same vertex as the plain
    version for all but a 1e-4 share of (sample, level) pairs (sin of the
    same f32 argument on one card), compared through the selection."""
    cfg = HashEncodingConfig(num_levels=levels, features_per_level=features,
                             log2_hashmap_size=log2, interpolation=interp)
    gen = torch.Generator().manual_seed(levels + log2 + features)
    pos = torch.rand((5000, 3), generator=gen)
    pos[:3] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.5, 1.0]])
    pos, g = pos.to(cuda), torch.randn((5000, levels * features), generator=gen).to(cuda)
    before = HASH_ENCODE_BWD.launches
    got = hash_encode_bwd(pos, g, cfg, stochastic=False)
    torch.cuda.synchronize()
    assert HASH_ENCODE_BWD.launches == before + 1
    torch.testing.assert_close(got, hash_encode_bwd_plain(pos, g, cfg, False), rtol=1e-5, atol=1e-5)
    # stochastic: with unit gradients each (sample, level) adds 1 to one row
    # per feature, so the kernel's choices can be read back from the table
    ones = torch.ones_like(g)
    total = hash_encode_bwd(pos, ones, cfg, stochastic=True)
    torch.testing.assert_close(total.sum(), ones.sum())  # exactly one vertex each
    ref = hash_encode_bwd_plain(pos, ones, cfg, True)
    differ = float((total - ref).abs().sum()) / (2 * 5000 * levels * features)
    assert differ <= 1e-4


def test_k4_rejects_what_it_does_not_take(cuda):
    cfg = HashEncodingConfig(num_levels=4, log2_hashmap_size=10)
    pos = torch.rand(10, 3, device=cuda)
    with pytest.raises(ValueError):
        hash_encode_bwd(pos, torch.zeros(10, 7, device=cuda), cfg, False)
    with pytest.raises(ValueError):
        hash_encode_bwd(pos.double(), torch.zeros(10, 8, device=cuda), cfg, False)
    with pytest.raises(ValueError):
        hash_encode_bwd(pos, torch.zeros(8, 10, device=cuda).t(), cfg, False)


# six levels, two of them dense (16^3 and 28^3 rows fit 2^16), four hashed
K4_SMALL = dict(num_levels=6, log2_hashmap_size=16, max_resolution=256)


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
@pytest.mark.parametrize("features", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 33, 3001])
def test_k4_tail_warps_and_widths(cuda, interp, features, n):
    """Ray-ordered samples (neighbours share rows at the dense levels, where
    the kernel groups lanes) at n that leave a partial last warp, each F, both
    modes: deterministic within 1e-5; stochastic with unit gradients exactly
    n * L * F in all, on the plain version's rows for all but a 1e-4 share."""
    cfg = HashEncodingConfig(features_per_level=features, interpolation=interp, **K4_SMALL)
    assert cfg.dense[:2] == (True, True) and not any(cfg.dense[2:])
    gen = torch.Generator().manual_seed(100 * features + n)
    pos = torch.from_numpy(ray_samples((n + 63) // 64, 64, seed=n)[:n]).to(cuda)
    g = torch.randn((n, cfg.output_dim), generator=gen).to(cuda)
    before = HASH_ENCODE_BWD.launches
    got = hash_encode_bwd(pos, g, cfg, stochastic=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, hash_encode_bwd_plain(pos, g, cfg, False), rtol=1e-5, atol=1e-5)
    ones = torch.ones_like(g)
    sto = hash_encode_bwd(pos, ones, cfg, stochastic=True)
    assert HASH_ENCODE_BWD.launches == before + 2
    assert float(sto.sum()) == n * cfg.output_dim
    differ = float((sto - hash_encode_bwd_plain(pos, ones, cfg, True)).abs().sum())
    assert differ / (2 * n * cfg.output_dim) <= 1e-4


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
@pytest.mark.parametrize("features", [1, 2, 8])
def test_k4_all_positions_equal(cuda, interp, features):
    """Every lane of every warp shares each level's rows: with unit gradients
    the stochastic table holds exactly n at each level's chosen row, per
    feature, and nothing else; the deterministic one n * w_v per vertex,
    against n times one sample's gradient taken in f64 within rtol n * 2^-24
    (the bound of n sequential f32 adds: on the hashed levels the kernel
    adds each lane's w_v on its own, as the plain version does)."""
    cfg = HashEncodingConfig(features_per_level=features, interpolation=interp, **K4_SMALL)
    n, L, F = 3001, cfg.num_levels, features
    pos = torch.tensor([[0.3141, 0.5926, 0.5358]], device=cuda).expand(n, 3).contiguous()
    ones = torch.ones((n, L * F), device=cuda)
    sto = hash_encode_bwd(pos, ones, cfg, stochastic=True).reshape(-1, F)
    ref = hash_encode_bwd_plain(pos, ones, cfg, True).reshape(-1, F)
    hit = sto[:, 0] != 0
    assert int(hit.sum()) == L and torch.equal(sto[hit], torch.full((L, F), float(n), device=cuda))
    assert torch.equal(sto, ref)
    det = hash_encode_bwd(pos, ones, cfg, stochastic=False)
    one = hash_encode_bwd_plain(pos[:1], ones[:1], cfg, False).double()
    torch.testing.assert_close(det.double(), n * one, rtol=n * 2.0**-24, atol=0)


@pytest.mark.parametrize("stochastic", [True, False], ids=["stochastic", "deterministic"])
def test_k4_padding_rows_add_nothing(cuda, stochastic):
    """The compact buffer's padding: many rows at one position with zero
    gradients. The kernel issues no reduction for them, and the table is the
    plain version's; all-zero gradients leave it +0 everywhere."""
    cfg = HashEncodingConfig(interpolation="tetrahedral", **K4_SMALL)
    gen = torch.Generator().manual_seed(11)
    real = torch.from_numpy(ray_samples(8, 64, seed=11))
    pos = torch.cat([real, real[:1].expand(2500, 3)]).contiguous().to(cuda)
    g = torch.cat([torch.randn((512, cfg.output_dim), generator=gen),
                   torch.zeros((2500, cfg.output_dim))]).to(cuda)
    got = hash_encode_bwd(pos, g, cfg, stochastic)
    torch.testing.assert_close(got, hash_encode_bwd_plain(pos, g, cfg, stochastic),
                               rtol=1e-5, atol=1e-5)
    zero = hash_encode_bwd(pos, torch.zeros_like(g), cfg, stochastic)
    assert not bool(zero.ne(0).any()) and not bool(torch.signbit(zero).any())


@pytest.mark.parametrize("features", [2, 4, 8])
def test_k4_refuses_a_misaligned_gradient(cuda, features):
    """g is read with vector loads of 4 * F bytes: a view 4 bytes off is refused."""
    cfg = HashEncodingConfig(features_per_level=features, **K4_SMALL)
    n = 64
    pos = torch.rand((n, 3), device=cuda)
    g = torch.zeros(n * cfg.output_dim + 1, device=cuda)[1:].view(n, cfg.output_dim)
    assert g.is_contiguous() and g.data_ptr() % (4 * features) != 0
    before = HASH_ENCODE_BWD.launches
    with pytest.raises(ValueError, match="aligned"):
        hash_encode_bwd(pos, g, cfg, stochastic=True)
    assert HASH_ENCODE_BWD.launches == before


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
@pytest.mark.parametrize("levels,log2,features", [(6, 12, 2), (16, 19, 2), (8, 14, 4), (4, 10, 1)])
def test_k3_matches_plain(cuda, interp, levels, log2, features):
    cfg = HashEncodingConfig(num_levels=levels, features_per_level=features,
                             log2_hashmap_size=log2, interpolation=interp)
    gen = torch.Generator().manual_seed(levels + log2)
    table = ((torch.rand((cfg.table_size * features,), generator=gen) * 2 - 1) * 1e-4).to(cuda)
    pos = torch.rand((5000, 3), generator=gen)
    pos[:3] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.5, 1.0]])
    pos = pos.to(cuda)
    before = HASH_ENCODE_FWD.launches
    out = hash_encode_fwd(table, pos, cfg)
    torch.cuda.synchronize()
    assert HASH_ENCODE_FWD.launches == before + 1
    torch.testing.assert_close(out, hash_encode_plain(table, pos, cfg), rtol=0, atol=1e-6)


def test_k3_rejects_what_it_does_not_take(cuda):
    cfg = HashEncodingConfig(num_levels=4, log2_hashmap_size=10)
    table = torch.zeros(cfg.table_size * 2, device=cuda)
    pos = torch.rand(10, 3, device=cuda)
    with pytest.raises(ValueError):
        hash_encode_fwd(table, pos.t().contiguous().t(), cfg)
    with pytest.raises(ValueError):
        hash_encode_fwd(table[:-2], pos, cfg)
    with pytest.raises(ValueError):
        hash_encode_fwd(table, pos.double(), cfg)


def test_render_kernels_match_plain_path(cuda):
    kw = dict(method="rgb+spectral", pred_specular=True, temperature=0.4,
              grid_resolution=32, grid_levels=2, max_samples_per_ray=32,
              hash_num_levels=8, log2_hashmap_size=14, hash_interpolation="tetrahedral")
    scene = SyntheticSceneConfig(image_size=32, num_bands=16)
    poses, _, rgba = render_views(scene, 1, 0.13)
    cameras = scene_cameras(scene, poses)
    rays = generate_camera_rays(cameras.to_device_dict(cuda), 0, 32, 32)
    dm = InMemoryDataManager(rgba, cameras, wavelengths=scene.wavelengths, device=cuda)
    outs, state = {}, None
    for impl in ("auto", "plain"):
        t = Trainer(TrainerConfig(seed=3, mixed_precision=False),
                    dataclasses.replace(ModelConfig(**kw), impl=impl),
                    num_classes=4, device=cuda, datamanager=dm)
        if state is None:  # one grid for both, from the kernel path
            t.setup().update_occupancy()
            state = t.state
        t.state = state
        outs[impl] = t.render_camera(rays, (32, 32), step=100, chunk=512)
    for k in ("rgb", "spectral", "accumulation", "depth"):
        assert bool(torch.isfinite(outs["auto"][k]).all())
        np.testing.assert_allclose(outs["auto"][k].cpu().numpy(), outs["plain"][k].cpu().numpy(),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_train_step_kernels_match_plain_path(cuda):
    """One training step's loss (rtol 1e-5) and every gradient (rtol 1e-3,
    atol 1e-4 of the tensor's largest entry) with the kernels and with the
    plain versions, f32, deterministic hash gradient, same draws."""
    kw = dict(method="rgb+spectral", pred_specular=True, temperature=0.4,
              grid_resolution=32, grid_levels=2, max_samples_per_ray=32,
              hash_num_levels=8, log2_hashmap_size=14, hash_interpolation="tetrahedral",
              stochastic_hash_grad=False)
    scene = SyntheticSceneConfig(num_views_train=3, image_size=32, num_bands=16)
    poses, cubes, rgba = render_views(scene, 3, 0.0)
    dm = InMemoryDataManager(rgba, scene_cameras(scene, poses), hs_images=cubes,
                             config=DataManagerConfig(train_num_rays_per_batch=512),
                             wavelengths=scene.wavelengths, device=cuda)
    cfg = TrainerConfig(seed=5, mixed_precision=False)
    results, state, draws = {}, None, None
    for impl in ("auto", "plain"):
        t = Trainer(cfg, dataclasses.replace(ModelConfig(**kw), impl=impl), num_classes=4,
                    device=cuda, datamanager=dm).setup()
        if state is None:
            t.update_occupancy()
            state, draws = t.state, t.draw_step()
        t.state = state
        before = {k.symbol: k.launches for k in KERNELS.values()}
        total = t.loss_and_grads(draws)[0]
        torch.cuda.synchronize()
        ran = sorted(k.symbol for k in KERNELS.values() if k.launches > before[k.symbol])
        assert ran == (TRAIN_KERNELS if impl == "auto" else [])
        results[impl] = (float(total), {n: p.grad.clone() for n, p in named_leaves(state["params"])})
    (la, ga), (lp, gp) = results["auto"], results["plain"]
    assert np.isfinite(la) and la == pytest.approx(lp, rel=1e-5)
    for name, g in ga.items():
        torch.testing.assert_close(g, gp[name], rtol=1e-3, atol=1e-4 * float(gp[name].abs().max()),
                                   msg=name)


# ------------------------------------------------------------------- P1
@pytest.mark.parametrize("n", [0, 1, 2047, 2049])
def test_p1_matches_plain_bit_for_bit(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    table = torch.randn((5000, 2), generator=gen, device=cuda)
    idx = torch.randint(0, 5000, (n,), generator=gen, device=cuda, dtype=torch.int32)
    before = ROW_GATHER.launches
    out = row_gather(table, idx)
    torch.cuda.synchronize()
    assert out.shape == (n, 2) and out.dtype == torch.float32
    assert torch.equal(out, row_gather_plain(table, idx))
    assert ROW_GATHER.launches == before + (1 if n else 0)
    assert torch.equal(row_gather(table, idx, impl="plain"), out)
    assert ROW_GATHER.launches == before + (1 if n else 0)


def test_p1_first_and_last_rows(cuda):
    table = torch.randn((1 << 20, 2), device=cuda)
    t = table.shape[0]
    idx = torch.tensor([0, t - 1, t - 1, 0, t // 2], dtype=torch.int32, device=cuda)
    out = row_gather(table, idx)
    assert torch.equal(out, table[idx.long()])
    assert torch.equal(out[1], table[t - 1]) and torch.equal(out[0], table[0])


def test_p1_refuses_bad_inputs(cuda):
    table = torch.randn((10, 2), device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    for bad_table, bad_idx in ((table.double(), idx), (torch.randn((10, 3), device=cuda), idx),
                               (table, idx.long()), (table, idx.cpu()), (table.t(), idx)):
        with pytest.raises(ValueError):
            row_gather(bad_table, bad_idx)


# ------------------------------------------------ a dataset on disk, adapted
def test_disk_dataset_training_through_one_adapt(cuda, tmp_path, monkeypatch):
    """A small dataset written to disk, parsed and staged on the card,
    trained through one scheduled adapt (decided at 16, applied at 32):
    the applied shapes reach the step, with three stage budgets, and the
    loss stays finite."""
    from umhs_torch.data.dataparser import DataParserConfig
    from umhs_torch.data.synthetic import write_dataset

    monkeypatch.chdir(tmp_path)
    root = write_dataset(tmp_path / "scene", SyntheticSceneConfig(
        num_views_train=4, num_views_eval=2, image_size=32, num_bands=16))
    model = ModelConfig(method="rgb+spectral", grid_resolution=32, grid_levels=2,
                        max_samples_per_ray=32, hash_num_levels=8, log2_hashmap_size=14,
                        stage_boundaries=(8, 16), load_vca=True)
    cfg = TrainerConfig(seed=1, max_num_iterations=48, adapt_steps=(16,), adapt_every=0,
                        adapt_prefetch_steps=16, target_num_samples=1 << 14,
                        steps_per_log=16, save_final=False, output_dir=tmp_path / "out")
    dm = DataManagerConfig(dataparser=DataParserConfig(data=root, num_classes=3),
                           train_num_rays_per_batch=1024, eval_num_rays_per_batch=256,
                           hs_dtype="bfloat16")
    t = Trainer(cfg, model, dm, num_classes=3, device=cuda).setup()
    assert t.datamanager.data["hs_image"].dtype == torch.bfloat16
    assert t.datamanager.data["image"].device.type == "cuda"
    m = t.train()
    (log,) = t.adapt_log
    assert (log["decided"], log["applied"]) == (16, 32)
    assert len(t.dyn.budgets) == 3 and all(b % 256 == 0 for b in t.dyn.budgets)
    last = t.history[-1]["metrics"]
    assert np.isfinite(m["loss/total"]) and "num_eval_s3_per_batch" in last
    assert m["rays_per_batch"] == t.dyn.rays != 1024
    assert np.isfinite(t.eval_batch()["psnr"])
