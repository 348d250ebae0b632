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
from umhs_torch.data.synthetic import SyntheticSceneConfig, render_views, scene_cameras
from umhs_torch.engine.trainer import Trainer, TrainerConfig
from umhs_torch.models.model import ModelConfig
from umhs_torch.data.datamanager import InMemoryDataManager
from umhs_torch.engine.trainer import named_leaves
from umhs_torch.ops._native import KERNELS
from umhs_torch.ops.encodings import (
    HASH_ENCODE_BWD, HASH_ENCODE_FWD, HashEncodingConfig, hash_encode_bwd,
    hash_encode_bwd_plain, hash_encode_fwd, hash_encode_plain)
from umhs_torch.ops.mlp import init_mlp
from umhs_torch.ops.mlp_fused import (
    MLP_FUSED_BWD, MLP_FUSED_FWD, mlp_fused, mlp_fused_bwd, mlp_fused_fwd, mlp_plain,
    mlp_plain_bwd)

pytestmark = pytest.mark.cuda


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
    poses, _, _ = render_views(scene, 1, 0.13)
    rays = generate_camera_rays(scene_cameras(scene, poses).to_device_dict(cuda), 0, 32, 32)
    outs, state = {}, None
    for impl in ("auto", "plain"):
        t = Trainer(TrainerConfig(seed=3, mixed_precision=False),
                    dataclasses.replace(ModelConfig(**kw), impl=impl),
                    scene.wavelengths, num_classes=4, num_images=1, device=cuda)
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
    dm = InMemoryDataManager(rgba, scene_cameras(scene, poses), hs_images=cubes, device=cuda)
    cfg = TrainerConfig(seed=5, mixed_precision=False, train_num_rays_per_batch=512)
    results, state, draws = {}, None, None
    for impl in ("auto", "plain"):
        t = Trainer(cfg, dataclasses.replace(ModelConfig(**kw), impl=impl), scene.wavelengths,
                    num_classes=4, num_images=3, device=cuda, datamanager=dm).setup()
        if state is None:
            t.update_occupancy()
            state, draws = t.state, t.draw_step()
        t.state = state
        before = {k.symbol: k.launches for k in KERNELS.values()}
        total = t.loss_and_grads(draws)[0]
        torch.cuda.synchronize()
        ran = sorted(k.symbol for k in KERNELS.values() if k.launches > before[k.symbol])
        assert ran == (sorted(before) if impl == "auto" else [])
        results[impl] = (float(total), {n: p.grad.clone() for n, p in named_leaves(state["params"])})
    (la, ga), (lp, gp) = results["auto"], results["plain"]
    assert np.isfinite(la) and la == pytest.approx(lp, rel=1e-5)
    for name, g in ga.items():
        torch.testing.assert_close(g, gp[name], rtol=1e-3, atol=1e-4 * float(gp[name].abs().max()),
                                   msg=name)
