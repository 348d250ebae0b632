"""umhs_torch's hand-written kernels against their plain versions, on the card.

Marked `cuda` and skipped without an NVIDIA card. On a machine with one
(it needs no JAX, so skip the repo's conftest, which imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

chip_smoke.py runs the same checks at the flagship shapes; these cover the
edge cases at small sizes, including the 256-wide chain of the DINO head
and other chains on K1's and K2's wide tensor-core kernels, and a small
training step with the kernels against the plain path.
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
    hash_encode_bwd_plain, hash_encode_bwd_route, hash_encode_fwd, hash_encode_plain,
    stochastic_rows)
from umhs_torch.ops.mlp import init_mlp
from umhs_torch.ops.mlp_fused import (
    MLP_FUSED_BWD, MLP_FUSED_FWD, mlp_fused, mlp_fused_bwd, mlp_fused_bwd_route, mlp_fused_fwd,
    mlp_fused_fwd_route, mlp_plain, mlp_plain_bwd)
from umhs_torch.ops.row_gather import (
    SLICE_BYTES, WAVE, ROW_GATHER, row_gather, row_gather_plain, row_gather_slices)
from umhs_torch.ops import compact as k6_compact
from umhs_torch.ops import compositing as k6_comp
from umhs_torch.ops import occupancy as k7_occ
from umhs_torch.ops import ray_marching as k5_march

pytestmark = pytest.mark.cuda
# the kernels a training step launches (P1, the row gather, is on no path;
# the occupancy update's K7 runs beside the step, not in it)
TRAIN_KERNELS = sorted(k.symbol for k in (
    MLP_FUSED_FWD, MLP_FUSED_BWD, HASH_ENCODE_FWD, HASH_ENCODE_BWD, k6_compact.COMPACT_STAGE,
    k6_compact.COMPACT_GATHER, k6_comp.RENDER_WEIGHTS_FWD, k6_comp.RENDER_WEIGHTS_BWD,
    k6_comp.SEGMENT_ACCUMULATE_FWD, k6_comp.SEGMENT_ACCUMULATE_BWD, k5_march.MARCH_COUNT,
    k5_march.MARCH_EMIT))
# the proposal sampler's step: no compact buffer, K6c only
PROPOSAL_TRAIN_KERNELS = sorted(k.symbol for k in (
    MLP_FUSED_FWD, MLP_FUSED_BWD, HASH_ENCODE_FWD, HASH_ENCODE_BWD, k6_comp.RENDER_WEIGHTS_FWD,
    k6_comp.RENDER_WEIGHTS_BWD))


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
    and the odd widths run on the tensor cores (mlp_fused_fwd_tc_kernel), the
    256-wide chain on the wide tensor-core kernel by its shape; f32 on the
    FMA kernel; one launch each, within 2e-2 of the plain version. An x 4
    bytes off 16-byte alignment gives the same result."""
    n = (1 << 16) - 333
    gen = torch.Generator().manual_seed(len(dims) + dims[-1])
    params = _chain(dims, gen, cuda)
    x = torch.randn((n, dims[0]), generator=gen).to(cuda)
    assert mlp_fused_fwd_route(dims, torch.bfloat16).startswith(_routes(dims)[0])
    assert mlp_fused_fwd_route(dims, torch.float32) == "mlp_fused_fwd_kernel<0>"
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


def _routes(dims):
    """The bf16 routes K1 and K2 take by shape, as their launchers choose
    (route prefixes for the narrow tensor-core kernels, whose template
    arguments depend on the widths): every padded width within 128, the
    tensor cores; a chain of up to two layers (K2: of two) up to 256, the
    wide tensor-core kernels; else the FMA kernels."""
    padded = [-(-d // 16) * 16 for d in dims]
    if max(padded) <= 128:
        return "mlp_fused_fwd_tc_kernel<", "mlp_fused_bwd_tc_kernel<"
    return ("mlp_fused_fwd_wide_kernel" if len(dims) <= 3 else "mlp_fused_fwd_kernel<1>",
            "mlp_fused_bwd_wide_kernel" if len(dims) == 3 else "mlp_fused_bwd_kernel<1>")


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
@pytest.mark.parametrize("n", [1, 15, 16, 17, 33, 3001])
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


@pytest.mark.parametrize(
    "dims",
    [[32, 64, 16], [27, 64, 64, 7], [27, 64, 64, 6], [28, 16, 128], [5, 3, 9, 2, 4], [32, 16],
     [15, 256, 128]],
    ids=lambda d: "-".join(map(str, d)),
)
def test_k2_bf16_routes_and_edges(cuda, dims):
    """bf16 at n = 2^16 - 333 (a partial last tile): the field chains and the
    odd widths run on the tensor cores (mlp_fused_bwd_tc_kernel), the
    256-wide chain on the wide tensor-core kernel by its shape, f32 on the
    FMA kernel; one launch each, within 2e-2 of each tensor's largest
    entry. The run repeats bit for bit; dx skipped leaves dW and db's bits
    as they were; an x 4 bytes off 16-byte alignment gives the same bits;
    an all-zero g gives exactly zero gradients."""
    n = (1 << 16) - 333
    gen = torch.Generator().manual_seed(len(dims) + dims[-1] + 1)
    params = _chain(dims, gen, cuda)
    x = torch.randn((n, dims[0]), generator=gen).to(cuda)
    g = torch.randn((n, dims[-1]), generator=gen).to(cuda)
    assert mlp_fused_bwd_route(dims, torch.bfloat16).startswith(_routes(dims)[1])
    assert mlp_fused_bwd_route(dims, torch.float32) == "mlp_fused_bwd_kernel<0>"
    before = MLP_FUSED_BWD.launches
    dx, grads = mlp_fused_bwd(params, x, g, torch.bfloat16)
    torch.cuda.synchronize()
    assert MLP_FUSED_BWD.launches == before + 1
    dx_ref, grads_ref = mlp_plain_bwd(params, x, g, torch.bfloat16)
    flat = [dx] + [t for pair in grads for t in pair]
    for got, ref in zip(flat, [dx_ref] + [t for pair in grads_ref for t in pair]):
        torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2 * float(ref.abs().max()))
    again = mlp_fused_bwd(params, x, g, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(flat, [again[0]] + [t for p in again[1] for t in p]))
    no_dx, grads_no_dx = mlp_fused_bwd(params, x, g, torch.bfloat16, need_dx=False)
    assert no_dx is None
    assert all(torch.equal(a, b) for a, b in zip(flat[1:], [t for p in grads_no_dx for t in p]))
    off = torch.empty(n * dims[0] + 1, device=cuda)[1:].view(n, dims[0])
    off.copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    moved = mlp_fused_bwd(params, off, g, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(flat, [moved[0]] + [t for p in moved[1] for t in p]))
    zdx, zgrads = mlp_fused_bwd(params, x, torch.zeros_like(g), torch.bfloat16)
    assert not any(bool(t.ne(0).any()) for t in [zdx] + [t for p in zgrads for t in p])
    assert MLP_FUSED_BWD.launches == before + 5


@pytest.mark.parametrize("dims", [[15, 256, 128], [15, 200, 128], [31, 256, 250], [40, 256]],
                         ids=lambda d: "-".join(map(str, d)))
@pytest.mark.parametrize("n", [1, 17, 33, 1300])
def test_wide_chains_match_plain(cuda, dims, n):
    """bf16 chains wider than 128 (the DINO head's 15-256-128, a hidden width
    off the 64-column slices, an output width off the 16-column tiles, one
    layer): K1 on its wide kernel within 2e-2 of the plain version; K2 (on
    its wide kernel for two layers) with and without dx within 2e-2 of each
    tensor's largest entry, each run twice bit for bit, dW and db the same
    bits with dx and without; one launch each."""
    gen = torch.Generator().manual_seed(n + sum(dims))
    params = _chain(dims, gen, cuda)
    x = torch.randn((n, dims[0]), generator=gen).to(cuda)
    g = torch.randn((n, dims[-1]), generator=gen).to(cuda)
    routes = _routes(dims)
    assert mlp_fused_fwd_route(dims, torch.bfloat16) == routes[0] == "mlp_fused_fwd_wide_kernel"
    assert mlp_fused_bwd_route(dims, torch.bfloat16) == routes[1]
    before = MLP_FUSED_FWD.launches
    y = mlp_fused_fwd(params, x, torch.bfloat16)
    torch.cuda.synchronize()
    assert MLP_FUSED_FWD.launches == before + 1
    torch.testing.assert_close(y, mlp_plain(params, x, torch.bfloat16), rtol=2e-2, atol=2e-2)
    for need_dx in (True, False):
        before = MLP_FUSED_BWD.launches
        dx, grads = mlp_fused_bwd(params, x, g, torch.bfloat16, need_dx)
        torch.cuda.synchronize()
        assert MLP_FUSED_BWD.launches == before + 1 and (dx is None) != need_dx
        dx_ref, grads_ref = mlp_plain_bwd(params, x, g, torch.bfloat16, need_dx)
        flat = [t for pair in grads for t in pair]
        pairs = list(zip(flat, [t for pair in grads_ref for t in pair]))
        for got, ref in pairs + ([(dx, dx_ref)] if need_dx else []):
            assert got.shape == ref.shape and got.dtype == torch.float32
            torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2 * float(ref.abs().max()))
        again_dx, again = mlp_fused_bwd(params, x, g, torch.bfloat16, need_dx)
        assert all(torch.equal(a, b) for a, b in zip(flat, [t for p in again for t in p]))
        assert not need_dx or torch.equal(dx, again_dx)
        if need_dx:
            with_dx = flat
        else:
            assert all(torch.equal(a, b) for a, b in zip(flat, with_dx))


def test_deeper_wide_chain_routes(cuda):
    """A three-layer bf16 chain wider than 128 is not one the wide kernels
    take: K1 and K2 both run their FMA kernels (so K2's recompute decides
    each ReLU as K1's forward does), within 2e-2 of the plain version."""
    dims = [32, 256, 64, 8]
    assert mlp_fused_fwd_route(dims, torch.bfloat16) == "mlp_fused_fwd_kernel<1>"
    assert mlp_fused_bwd_route(dims, torch.bfloat16) == "mlp_fused_bwd_kernel<1>"
    gen = torch.Generator().manual_seed(4)
    params = _chain(dims, gen, cuda)
    x = torch.randn((1300, 32), generator=gen).to(cuda)
    g = torch.randn((1300, 8), generator=gen).to(cuda)
    torch.testing.assert_close(mlp_fused_fwd(params, x, torch.bfloat16),
                               mlp_plain(params, x, torch.bfloat16), rtol=2e-2, atol=2e-2)
    dx, grads = mlp_fused_bwd(params, x, g, torch.bfloat16)
    dx_ref, grads_ref = mlp_plain_bwd(params, x, g, torch.bfloat16)
    for got, ref in zip([dx] + [t for p in grads for t in p],
                        [dx_ref] + [t for p in grads_ref for t in p]):
        torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2 * float(ref.abs().max()))


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


# the share of stochastic draws that may land on another vertex on the card
# than on the CPU: torch.sin on the two differs by an ulp now and then, and
# u = frac(sin(.) * 43758.5453) scales that by ~4e4
K4_DRAW_DIFFER_SHARE = 1e-2


def _bits(t):
    return t.detach().cpu().view(torch.int32)


def _k4_holds(pos, g, cfg):
    """K4 in both modes: a second run gives the same bits, and the table is
    the plain version's on CPU copies bit for bit (both add each row from +0
    in ascending entry order). Stochastic: bit for bit against the plain sum
    on the CPU over the rows the card's draw chooses, and against the plain
    version itself off the rows of any (sample, level) whose draw differs
    between the card's sin and the CPU's. Returns that draw's differing share."""
    F = cfg.features_per_level
    cpu_pos, cpu_g = pos.cpu(), g.cpu()
    before = HASH_ENCODE_BWD.launches
    for stochastic in (False, True):
        got = hash_encode_bwd(pos, g, cfg, stochastic)
        again = hash_encode_bwd(pos, g, cfg, stochastic)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(again))
        ref = hash_encode_bwd_plain(cpu_pos, cpu_g, cfg, stochastic)
        if not stochastic:
            assert torch.equal(_bits(got), _bits(ref))
            continue
        rows_card, rows_cpu = stochastic_rows(pos, cfg).cpu(), stochastic_rows(cpu_pos, cfg)
        feat = torch.arange(F)
        on_card_rows = torch.zeros_like(ref).index_add_(
            0, (rows_card[..., None] * F + feat).reshape(-1), cpu_g.reshape(-1))
        assert torch.equal(_bits(got), _bits(on_card_rows))
        differ = rows_card != rows_cpu
        touched = torch.zeros(cfg.table_size, dtype=torch.bool)
        touched[rows_card[differ]] = True
        touched[rows_cpu[differ]] = True
        keep = ~touched.repeat_interleave(F)
        assert torch.equal(_bits(got)[keep], _bits(ref)[keep])
    assert HASH_ENCODE_BWD.launches == before + 4
    return float(differ.float().mean())


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
@pytest.mark.parametrize("levels,log2,features", [(6, 12, 2), (16, 19, 2), (8, 14, 4), (4, 10, 1)])
def test_k4_matches_plain(cuda, interp, levels, log2, features):
    """Both modes bit for bit against the plain version on the CPU, and
    repeated (_k4_holds); the card's stochastic draw is the kernel's on every
    pair and differs from the CPU's on at most K4_DRAW_DIFFER_SHARE."""
    cfg = HashEncodingConfig(num_levels=levels, features_per_level=features,
                             log2_hashmap_size=log2, interpolation=interp)
    gen = torch.Generator().manual_seed(levels + log2 + features)
    pos = torch.rand((5000, 3), generator=gen)
    pos[:3] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.5, 1.0]])
    pos, g = pos.to(cuda), torch.randn((5000, levels * features), generator=gen).to(cuda)
    assert _k4_holds(pos, g, cfg) <= K4_DRAW_DIFFER_SHARE
    # with unit gradients each (sample, level) adds 1 to one row per feature
    ones = torch.ones_like(g)
    assert float(hash_encode_bwd(pos, ones, cfg, stochastic=True).sum()) == 5000 * cfg.output_dim


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


def _k4_positions(kind, n, seed):
    """n positions: uniform ("random", with the cube's corners and faces
    first), ray-ordered (synthetic.ray_samples) or all at one point."""
    if kind == "rays":
        return torch.from_numpy(ray_samples((n + 63) // 64, 64, seed=seed)[:n])
    if kind == "equal":
        return torch.tensor([[0.3141, 0.5926, 0.5358]]).expand(n, 3).contiguous()
    pos = torch.rand((n, 3), generator=torch.Generator().manual_seed(seed))
    edge = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.5, 1.0], [1.0, 0.0, 0.25]])
    pos[:min(n, 4)] = edge[:min(n, 4)]
    return pos


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
@pytest.mark.parametrize("features", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 31, 33, 3001])
@pytest.mark.parametrize("kind", ["random", "rays", "equal"])
def test_k4_tail_warps_and_widths(cuda, kind, n, features, interp):
    """The order-fixed K4 at n that leave a partial warp and tile, every F,
    on random, ray-ordered (neighbours share rows at the dense levels) and
    all-equal positions, both modes: the same bits on a second run and the
    plain version's bits on the CPU (_k4_holds); stochastic with unit
    gradients exactly n * L * F in all."""
    cfg = HashEncodingConfig(features_per_level=features, interpolation=interp, **K4_SMALL)
    assert cfg.dense[:2] == (True, True) and not any(cfg.dense[2:])
    pos = _k4_positions(kind, n, seed=7 * n + features).to(cuda)
    g = torch.randn((n, cfg.output_dim), generator=torch.Generator().manual_seed(n)).to(cuda)
    differ = _k4_holds(pos, g, cfg)
    assert n < 1000 or differ <= K4_DRAW_DIFFER_SHARE
    ones = torch.ones_like(g)
    assert float(hash_encode_bwd(pos, ones, cfg, stochastic=True).sum()) == n * cfg.output_dim


# nerfacto's proposal grids: L5 F2 2^17 trilinear to resolution 128 and 256
K4_PROPOSAL = {128: 256, 256: 96}  # max resolution: samples per ray


@pytest.mark.parametrize("max_res", sorted(K4_PROPOSAL))
def test_k4_proposal_grids_on_rays(cuda, max_res):
    """A proposal grid on 256 ray-ordered rays of its samples (the coarse
    levels on the runs route, the rest on entries: hash_encode_bwd_route),
    both modes through _k4_holds: repeated and the plain version's bits."""
    cfg = HashEncodingConfig(num_levels=5, max_resolution=max_res, log2_hashmap_size=17)
    pos = torch.from_numpy(ray_samples(256, K4_PROPOSAL[max_res], seed=max_res))
    n = pos.shape[0]
    assert "runs" in hash_encode_bwd_route(cfg, n, False)
    g = torch.randn((n, cfg.output_dim), generator=torch.Generator().manual_seed(n))
    g[::9] = 0.0  # samples that add nothing, as the compact buffer's padding
    assert _k4_holds(pos.to(cuda), g.to(cuda), cfg) <= K4_DRAW_DIFFER_SHARE


K4_ROUTE_CONFIGS = {
    **{f"small-{interp}-F{f}": dict(features_per_level=f, interpolation=interp, **K4_SMALL)
       for interp in ("tetrahedral", "trilinear") for f in (1, 2, 4, 8)},
    "proposal_0": dict(num_levels=5, max_resolution=128, log2_hashmap_size=17),
    "flagship": dict(num_levels=16, log2_hashmap_size=19, interpolation="tetrahedral"),
}


@pytest.mark.parametrize("name", list(K4_ROUTE_CONFIGS))
@pytest.mark.parametrize("n", [1, 255, 3001])
@pytest.mark.parametrize("kind", ["random", "rays", "equal"])
def test_k4_routes_give_the_same_bits(cuda, kind, n, name):
    """Every level on the runs route, every level on the entries route, and
    the two alternating by level: the same bits in both modes, and in the
    deterministic one the plain version's on the CPU (chunks shorter than n,
    longer than n, a short last chunk; rows across every chunk)."""
    cfg = HashEncodingConfig(**K4_ROUTE_CONFIGS[name])
    L = cfg.num_levels
    routes = [("runs",) * L, ("entries",) * L,
              tuple("runs" if lvl % 2 == 0 else "entries" for lvl in range(L))]
    pos = _k4_positions(kind, n, seed=3 * n + L).to(cuda)
    g = torch.randn((n, cfg.output_dim), generator=torch.Generator().manual_seed(n))
    g[::5] = 0.0
    g = g.to(cuda)
    for stochastic in (False, True):
        got = [hash_encode_bwd(pos, g, cfg, stochastic, route) for route in routes]
        torch.cuda.synchronize()
        for other in got[1:]:
            assert torch.equal(_bits(got[0]), _bits(other))
        if not stochastic:
            assert torch.equal(_bits(got[0]), _bits(hash_encode_bwd_plain(pos.cpu(), g.cpu(), cfg,
                                                                          False)))


def test_k4_rejects_an_unknown_route(cuda):
    cfg = HashEncodingConfig(num_levels=4, log2_hashmap_size=10)
    pos, g = torch.rand(10, 3, device=cuda), torch.zeros(10, 8, device=cuda)
    with pytest.raises(ValueError):
        hash_encode_bwd(pos, g, cfg, False, ("runs", "sorted", "entries", "entries"))
    with pytest.raises(ValueError):
        hash_encode_bwd(pos, g, cfg, False, ("runs",) * 3)


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
@pytest.mark.parametrize("features", [1, 2, 8])
def test_k4_all_positions_equal(cuda, interp, features):
    """Every sample shares each level's rows: with unit gradients the
    stochastic table holds exactly n at each level's chosen row, per
    feature, and nothing else; the deterministic one the plain version's
    bits on the CPU, the n * w_v sums taken in the same order."""
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
    assert torch.equal(_bits(det), _bits(hash_encode_bwd_plain(pos.cpu(), ones.cpu(), cfg, False)))


@pytest.mark.parametrize("stochastic", [True, False], ids=["stochastic", "deterministic"])
def test_k4_padding_rows_add_nothing(cuda, stochastic):
    """The compact buffer's padding: many rows at one position with zero
    gradients. The kernel skips them and the table is the plain version's
    on the CPU, bit for bit (_k4_holds); all-zero gradients leave it +0
    everywhere."""
    cfg = HashEncodingConfig(interpolation="tetrahedral", **K4_SMALL)
    gen = torch.Generator().manual_seed(11)
    real = torch.from_numpy(ray_samples(8, 64, seed=11))
    pos = torch.cat([real, real[:1].expand(2500, 3)]).contiguous().to(cuda)
    g = torch.cat([torch.randn((512, cfg.output_dim), generator=gen),
                   torch.zeros((2500, cfg.output_dim))]).to(cuda)
    _k4_holds(pos, g, cfg)
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


@pytest.mark.parametrize("interp", ["tetrahedral", "trilinear"])
@pytest.mark.parametrize("features", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 31, 33, 3001])
@pytest.mark.parametrize("kind", ["random", "rays", "equal"])
def test_k3_edge_sizes(cuda, kind, n, features, interp):
    """K3 at K4's edge sizes and position sets, within atol 1e-6 of its plain
    version: a block's partial tile of samples and every F."""
    cfg = HashEncodingConfig(features_per_level=features, interpolation=interp, **K4_SMALL)
    gen = torch.Generator().manual_seed(n + features)
    table = ((torch.rand((cfg.table_size * features,), generator=gen) * 2 - 1) * 1e-4).to(cuda)
    pos = _k4_positions(kind, n, seed=3 * n + features).to(cuda)
    out = hash_encode_fwd(table, pos, cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, hash_encode_plain(table, pos, cfg), rtol=0, atol=1e-6)


@pytest.mark.parametrize("levels,features", [(32, 8), (32, 1), (11, 4)])
def test_k3_wide_outputs(cuda, levels, features):
    """L * F of 256, 32 and 44 floats a sample (a tile of 32 padded rows of
    up to 32.9 KB), and levels that do not fill the block's eight warps'
    two-level steps."""
    cfg = HashEncodingConfig(num_levels=levels, features_per_level=features,
                             log2_hashmap_size=12, max_resolution=512)
    gen = torch.Generator().manual_seed(levels * features)
    table = ((torch.rand((cfg.table_size * features,), generator=gen) * 2 - 1) * 1e-4).to(cuda)
    pos = torch.rand((1000, 3), generator=gen).to(cuda)
    torch.testing.assert_close(hash_encode_fwd(table, pos, cfg),
                               hash_encode_plain(table, pos, cfg), rtol=0, atol=1e-6)


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
P1_N = [0, 1, 3, 4, 5, 2047, 2049, 8 * 127 - 1, 8 * 127 + 1, WAVE - 1, WAVE, WAVE + 1,
        8 * WAVE - 1, 8 * WAVE + 1, 37 * WAVE + 5]


# tables that the kernel walks in 1, 3 and 6 slices
P1_TABLE_ROWS = [5000, 2 * SLICE_BYTES // 8 + 5, 5 * SLICE_BYTES // 8 + 5]


@pytest.mark.parametrize("n", P1_N)
def test_p1_matches_plain_bit_for_bit(cuda, n):
    """At each edge N, with the table's first and last rows among the
    indices, on tables of 1, 3 and 6 slices (the grid strides over the
    waves at the largest N); a launch is counted per call with rows."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    for t, slices in zip(P1_TABLE_ROWS, (1, 3, 6)):
        assert row_gather_slices(t) == slices
        table = torch.randn((t, 2), generator=gen, device=cuda)
        idx = torch.randint(0, t, (n,), generator=gen, device=cuda, dtype=torch.int32)
        if n:
            idx[0], idx[-1] = t - 1, 0
        want = row_gather_plain(table, idx)
        before = ROW_GATHER.launches
        out = row_gather(table, idx)
        torch.cuda.synchronize()
        assert out.shape == (n, 2) and out.dtype == torch.float32
        assert torch.equal(out, want)
        assert ROW_GATHER.launches == before + (1 if n else 0)
        assert torch.equal(row_gather(table, idx, impl="plain"), want)
        assert ROW_GATHER.launches == before + (1 if n else 0)


def test_p1_first_and_last_rows(cuda):
    """The flagship's table (six slices), rows 0, T/2 and T - 1."""
    t = 6_098_108
    table = torch.randn((t, 2), device=cuda)
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


# ------------------------------------------------------------------ LPIPS
def test_lpips_on_the_card_matches_the_cpu(cuda):
    """Two unrelated seeded 256^2 images (a distance far from 0): the trunk
    on the card, f32 convolutions (TF32 off), within rtol 1e-4 of the CPU."""
    from umhs_torch.utils import metrics

    a = np.random.default_rng(0).random((256, 256, 3)).astype(np.float32)
    b = np.random.default_rng(1).random((256, 256, 3)).astype(np.float32)
    want = metrics.lpips(a, b, "cpu")
    got = metrics.lpips(a, b, cuda)
    assert want > 1e-3
    assert got == pytest.approx(want, rel=1e-4)


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


# ------------------------------------- the proposal sampler and the DINO head
def test_proposal_chains_match_plain(cuda):
    """The proposal nets' 10 -> 16 -> 1 chain at an odd N: K1 within 2e-2
    (bf16, on the tensor cores) and 1e-5 (f32) of the plain version; K2, dx
    and the weight gradients, within 2e-2 of the largest entry (bf16) and
    1e-4 (f32) of autograd through the plain version, each one launch."""
    n, dims = (1 << 16) - 333, [10, 16, 1]
    gen = torch.Generator().manual_seed(10)
    params = _chain(dims, gen, cuda)
    x = torch.randn((n, 10), generator=gen).to(cuda)
    g = torch.randn((n, 1), generator=gen).to(cuda)
    assert mlp_fused_bwd_route(dims, torch.bfloat16).startswith("mlp_fused_bwd_tc_kernel")
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        torch.testing.assert_close(mlp_fused_fwd(params, x, dtype), mlp_plain(params, x, dtype),
                                   rtol=tol, atol=tol)
        before = MLP_FUSED_BWD.launches
        dx, grads = mlp_fused_bwd(params, x, g, dtype)
        assert MLP_FUSED_BWD.launches == before + 1
        dx_ref, grads_ref = mlp_plain_bwd(params, x, g, dtype)
        btol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        for got, ref in zip([dx] + [t for p in grads for t in p],
                            [dx_ref] + [t for p in grads_ref for t in p]):
            torch.testing.assert_close(got, ref, rtol=btol, atol=btol * float(ref.abs().max()))


@pytest.mark.parametrize("max_res", [128, 256])
def test_proposal_grids_match_plain(cuda, max_res):
    """nerfacto's proposal grids (L5 F2 2^17, trilinear, from 16 to max_res):
    K3 within 1e-6 of the plain version, K4 in both modes bit for bit
    against the plain version on the CPU (_k4_holds); the proposal nets use
    the deterministic mode."""
    cfg = HashEncodingConfig(num_levels=5, max_resolution=max_res, log2_hashmap_size=17,
                             base_resolution=16)
    gen = torch.Generator().manual_seed(max_res)
    pos = torch.from_numpy(ray_samples(512, 64, seed=max_res)).to(cuda)
    table = ((torch.rand((cfg.table_size * 2,), generator=gen) * 2 - 1) * 1e-1).to(cuda)
    torch.testing.assert_close(hash_encode_fwd(table, pos, cfg), hash_encode_plain(table, pos, cfg),
                               rtol=0, atol=1e-6)
    g = torch.randn((pos.shape[0], cfg.output_dim), generator=gen).to(cuda)
    assert _k4_holds(pos, g, cfg) <= K4_DRAW_DIFFER_SHARE


def _step_both(model_kw, dm, cuda, step=0, seed=5):
    """One training step at `step` with the kernels and with the plain
    versions (f32, same state and draws): {impl: (loss, {leaf: grad})}; the
    kernel step must launch its sampler's kernels and the plain one none."""
    results, state, draws = {}, None, None
    for impl in ("auto", "plain"):
        t = Trainer(TrainerConfig(seed=seed, mixed_precision=False),
                    dataclasses.replace(ModelConfig(**model_kw), impl=impl), num_classes=4,
                    device=cuda, datamanager=dm).setup()
        if state is None:
            if t.model.config.sampler == "occgrid":
                t.update_occupancy()
            state, draws = dict(t.state, step=step), t.draw_step()
        t.state = state
        before = {k.symbol: k.launches for k in KERNELS.values()}
        total, loss, _, _ = t.loss_and_grads(draws)
        torch.cuda.synchronize()
        ran = sorted(k.symbol for k in KERNELS.values() if k.launches > before[k.symbol])
        want = PROPOSAL_TRAIN_KERNELS if t.model.config.sampler == "proposal" else TRAIN_KERNELS
        assert ran == (want if impl == "auto" else [])
        results[impl] = (float(total.detach()), {k: float(v.detach()) for k, v in loss.items()},
                         {n: p.grad.clone() for n, p in named_leaves(state["params"])})
        for _, p in named_leaves(state["params"]):
            p.grad = None
    return results


def _small_scene_dm(cuda, rays=512, dino=False):
    scene = SyntheticSceneConfig(num_views_train=3, image_size=32, num_bands=16)
    poses, cubes, rgba = render_views(scene, 3, 0.0)
    dm = InMemoryDataManager(rgba, scene_cameras(scene, poses), hs_images=cubes,
                             config=DataManagerConfig(train_num_rays_per_batch=rays),
                             wavelengths=scene.wavelengths, device=cuda)
    if dino:  # a fixed map of each view's RGB, as write_dino_sidecars makes it
        w = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 128)).astype(np.float32))
        dm.data["dino_feat"] = torch.tanh(dm.data["image"][..., :3].cpu() @ w).to(cuda)
    return dm


def test_proposal_train_step_kernels_match_plain_path(cuda):
    """The proposal sampler's training step at step 500 (rgb+spectral,
    proposals (64, 32) -> 16, f32): the loss within rtol 1e-4 and every gradient, each proposal
    net's too, within 1e-3 in norm of the plain path's."""
    kw = dict(method="rgb+spectral", pred_specular=True, sampler="proposal",
              num_proposal_samples=(64, 32), num_nerf_samples=16, hash_num_levels=8,
              log2_hashmap_size=14, near_plane=0.5, far_plane=6.0, stochastic_hash_grad=False)
    res = _step_both(kw, _small_scene_dm(cuda), cuda, step=500)  # inside the specular ramp
    (la, terms, ga), (lp, _, gp) = res["auto"], res["plain"]
    assert {"interlevel_loss", "distortion_loss"} <= set(terms)
    assert np.isfinite(la) and la == pytest.approx(lp, rel=1e-4)
    assert {"proposal_0.hash_table", "proposal_1.mlp.layers.0.w"} <= set(ga)
    for name, g in ga.items():
        ref = gp[name]
        assert float(ref.norm()) > 0, name
        assert float((g - ref).norm()) <= 1e-3 * float(ref.norm()), name


def test_dino_train_step_kernels_match_plain_path(cuda):
    """The flagship's step with pred_dino past step 3000 (the cluster loss
    in the sum), f32: the loss within rtol 1e-5, every gradient within 1e-3
    in norm of the plain path's, the DINO leaves' included."""
    kw = dict(method="rgb+spectral", pred_specular=True, pred_dino=True, temperature=0.4,
              grid_resolution=32, grid_levels=2, max_samples_per_ray=32, hash_num_levels=8,
              log2_hashmap_size=14, hash_interpolation="tetrahedral", stochastic_hash_grad=False)
    res = _step_both(kw, _small_scene_dm(cuda, dino=True), cuda, step=3001)
    (la, terms, ga), (lp, _, gp) = res["auto"], res["plain"]
    assert terms["cluster_loss"] != 0.0 and np.isfinite(terms["dino_mse"])
    assert np.isfinite(la) and la == pytest.approx(lp, rel=1e-5)
    for name, g in ga.items():
        ref = gp[name]
        assert float(ref.norm()) > 0, name
        assert float((g - ref).norm()) <= 1e-3 * float(ref.norm()), name


# -------------------------------------------------------------------- K6
def _k6_mask(R, S, seed, hit=0.3):
    """A march's (R, S) mask: a share `hit` of the rays holds a valid prefix
    of 1 to S lanes, the others none."""
    gen = torch.Generator().manual_seed(seed)
    n = torch.randint(1, S + 1, (R,), generator=gen)
    n = torch.where(torch.rand(R, generator=gen) < hit, n, torch.zeros_like(n))
    return torch.arange(S)[None, :] < n[:, None]


K6A_CASES = [  # R, S, lo, hi, budget, later stage (dead rays)
    (1, 1, 0, 1, 1, False), (37, 8, 0, 8, 256, False), (300, 64, 0, 8, 256, False),
    (300, 64, 8, 16, 100, True), (3001, 64, 16, 64, 8192, True), (5000, 96, 0, 96, 1 << 17, False),
    (4096, 64, 0, 64, 262144, False), (9000, 33, 5, 33, 7000, True)]


@pytest.mark.parametrize("R,S,lo,hi,budget,dead", K6A_CASES)
def test_k6a_matches_plain(cuda, R, S, lo, hi, budget, dead):
    """K6a gives the plain version's slot map, kept lanes, src, live,
    counts, starts and total exactly, on a column slice of an (R, S) mask,
    with overflow and empty rays; a second run gives the same bits."""
    mask = _k6_mask(R, S, R + S)
    live = (torch.rand(R, generator=torch.Generator().manual_seed(R)) < 0.6) if dead else None
    ref = k6_compact.compact_stage_plain(mask[:, lo:hi], live, budget)
    m = mask.to(cuda)
    lv = live.to(cuda) if dead else None
    got = k6_compact.compact_stage(m[:, lo:hi], lv, budget)
    again = k6_compact.compact_stage(m[:, lo:hi], lv, budget)
    torch.cuda.synchronize()
    for k in ("slot", "mask", "src", "live", "counts", "starts"):
        assert torch.equal(getattr(got, k).cpu(), getattr(ref, k)), k
        assert torch.equal(getattr(got, k), getattr(again, k)), k
    assert int(got.total) == ref.total


def test_k6a_nothing_kept(cuda):
    """An empty mask: total 0, src 0 and live 0 on every row, no ray counted."""
    mask = torch.zeros((50, 16), dtype=torch.bool, device=cuda)
    c = k6_compact.compact_stage(mask, None, 512)
    assert int(c.total) == 0 and int(c.src.abs().sum()) == 0 and float(c.live.sum()) == 0.0
    assert int(c.counts.sum()) == 0 and int(c.starts.abs().sum()) == 0


K6A_SCAN_CASES = [  # R, S, lo, hi, budget, later stage: tiles' edges (512 rays at L = 8, 85
    # at 48), phase 7's steady shapes, look-backs over hundreds of tiles,
    # budgets that cut inside a tile, L 1 to 96, unaligned column slices
    (511, 64, 0, 8, 1 << 14, False), (512, 64, 0, 8, 1 << 14, False),
    (513, 64, 8, 16, 1 << 14, True), (84, 64, 16, 64, 1 << 14, False),
    (85, 64, 16, 64, 1 << 14, False), (86, 64, 16, 64, 1 << 14, True),
    (79_360, 64, 0, 8, 179_200, False), (79_360, 64, 8, 16, 103_936, True),
    (79_360, 64, 16, 64, 93_440, True), ((1 << 17) + 1, 1, 0, 1, 5_000, False),
    ((1 << 17) + 1, 64, 0, 64, 1 << 20, False), (20_000, 96, 0, 96, 123_457, False),
    (30_000, 64, 3, 11, 40_001, True), (9_001, 33, 5, 33, 7_000, True),
    (4_097, 100, 2, 50, 30_000, False)]


@pytest.mark.parametrize("R,S,lo,hi,budget,dead", K6A_SCAN_CASES)
def test_k6a_single_pass_scan_matches_plain(cuda, R, S, lo, hi, budget, dead):
    """K6a's single-pass scan gives the plain version's slot map, kept
    lanes, src, live, counts, starts and total exactly, 50 times in a row
    (a race in the look-back would change a bit), in one launch a call."""
    mask = _k6_mask(R, S, R + S + lo, hit=0.4).to(cuda)
    live = (torch.rand(R, device=cuda) < 0.6) if dead else None
    m = mask[:, lo:hi]
    ref = k6_compact.compact_stage_plain(m, live, budget)
    before = k6_compact.COMPACT_STAGE.launches
    for _ in range(50):
        got = k6_compact.compact_stage(m, live, budget)
        for k in ("slot", "mask", "src", "live", "counts", "starts"):
            assert torch.equal(getattr(got, k), getattr(ref, k)), k
        assert int(got.total) == ref.total
    assert k6_compact.COMPACT_STAGE.launches == before + 50


K6D_STAGES = ((0, 8), (8, 16), (16, 64))


def _k6d_stage_inputs(cuda, C, dtype, aligned, bounds=K6D_STAGES, R=9_000, seed=0):
    """Each stage's compaction of a (R, S) march (budgets that overflow), the
    (R, S) weights with an odd row stride, and each stage's (Bs, C) values,
    leaves with their gradient; unaligned values sit one element into rows
    one wider (no vector loads)."""
    S = bounds[-1][1]
    mask = _k6_mask(R, S, seed + C, hit=0.5).to(cuda)
    gen = torch.Generator(cuda).manual_seed(seed)
    comps, live = [], None
    for lo, hi in bounds:
        budget = max(256, int(mask[:, lo:hi].sum()) * 3 // 4)
        comps.append(k6_compact.compact_stage(mask[:, lo:hi], live, budget))
        live = torch.rand(R, device=cuda, generator=gen) < 0.7
    wide = torch.rand((R, S + 1), device=cuda, generator=gen).requires_grad_(True)
    values = []
    for c in comps:
        Bs = c.src.shape[0]
        h = torch.randn((Bs, C + (0 if aligned else 1)), device=cuda, generator=gen).to(dtype)
        values.append((h if aligned else h[:, 1:]).detach().requires_grad_(True))
    return wide, comps, values


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 6, 33, 128])
def test_k6d_stages_equal_stage_sums(cuda, C, dtype, aligned):
    """K6d's one launch over the stages equals the single-stage calls added
    in stage order (torch.equal), holds to f64 as the plain version does
    (its error no larger than the plain version's plus 1e-6 of the largest
    entry), and its backward (a launch a stage into one dw) equals the
    single-stage backward's dh and dw; with detached weights the values'
    gradients are the same and the weights take none."""
    wide, comps, values = _k6d_stage_inputs(cuda, C, dtype, aligned)
    w = wide[:, 1:]
    stages = [(lo, hi, v, c) for (lo, hi), v, c in zip(K6D_STAGES, values, comps)]
    before = k6_comp.SEGMENT_ACCUMULATE_FWD.launches
    out = k6_comp.compact_accumulate_stages(w, stages)
    assert k6_comp.SEGMENT_ACCUMULATE_FWD.launches == before + 1
    singles = [k6_comp.compact_accumulate_cuda(w.detach()[:, lo:hi], v.detach(), c)
               for lo, hi, v, c in stages]
    assert torch.equal(out, singles[0] + singles[1] + singles[2])
    wd = w.detach()
    plain = k6_comp.compact_accumulate_stages(wd, stages, impl="plain")
    ref = k6_comp.compact_accumulate_stages(
        wd.double(), [(lo, hi, v.detach().double(), dataclasses.replace(c, live=c.live.double()))
                      for lo, hi, v, c in stages], impl="plain")
    e, pe = (float((x.double() - ref).abs().max()) for x in (out, plain))
    assert e <= pe + 1e-6 * float(ref.abs().max()), (e, pe)
    g = torch.randn(out.shape, device=cuda)
    dwide, *dhs = torch.autograd.grad(out, [wide] + values, g)
    for (lo, hi, v, c), dh in zip(stages, dhs):
        dh1, dw1 = k6_comp.compact_accumulate_bwd_cuda(wd[:, lo:hi], v.detach(), c, g)
        assert torch.equal(dh, dh1) and torch.equal(dwide[:, 1 + lo:1 + hi], dw1)
    assert float(dwide[:, 0].abs().max()) == 0.0
    out2 = k6_comp.compact_accumulate_stages(wd, stages)
    dhs2 = torch.autograd.grad(out2, values, g)
    assert torch.equal(out2, out) and all(torch.equal(a, b) for a, b in zip(dhs2, dhs))


def test_k6d_stages_past_one_launch(cuda):
    """Ten stages of two lanes (more than MAX_STAGES a launch): the launches
    chain onto out, and the sums still equal the single-stage calls added
    in stage order."""
    bounds = tuple((2 * k, 2 * k + 2) for k in range(10))
    wide, comps, values = _k6d_stage_inputs(cuda, 128, torch.float32, True, bounds, R=3_000)
    w = wide.detach()[:, 1:]
    stages = [(lo, hi, v.detach(), c) for (lo, hi), v, c in zip(bounds, values, comps)]
    before = k6_comp.SEGMENT_ACCUMULATE_FWD.launches
    out = k6_comp.compact_accumulate_stages_cuda(w, stages)
    assert k6_comp.SEGMENT_ACCUMULATE_FWD.launches == before + 2
    ref = None
    for lo, hi, v, c in stages:
        one = k6_comp.compact_accumulate_cuda(w[:, lo:hi], v, c)
        ref = one if ref is None else ref + one
    assert torch.equal(out, ref)


@pytest.mark.parametrize("R,S,lo,hi,budget,dead", K6A_CASES[1:])
def test_k6b_gathers_match_plain(cuda, R, S, lo, hi, budget, dead):
    """K6b both ways, bit for bit: lanes from rows against the plain gather,
    rows from lanes against the plain gather's autograd (each kept lane
    reads one row, each row below the total one lane; rows past it get 0)."""
    mask = _k6_mask(R, S, R + S + 1).to(cuda)
    live = (torch.rand(R, device=cuda) < 0.6) if dead else None
    c = k6_compact.compact_stage(mask[:, lo:hi], live, budget)
    rows = torch.randn(budget, device=cuda, requires_grad=True)
    g = torch.randn(c.mask.shape, device=cuda)
    got = k6_compact.gather_lanes(rows, c)
    ref = k6_compact.gather_lanes(rows, c, impl="plain")
    assert torch.equal(got, ref)
    (dg,) = torch.autograd.grad(got, rows, g)
    (dr,) = torch.autograd.grad(ref, rows, g)
    assert torch.equal(dg, dr)
    wide = torch.randn((R, S), device=cuda)  # a column slice, row stride S
    assert torch.equal(k6_compact.rows_from_lanes_cuda(wide[:, lo:hi], c),
                       wide[:, lo:hi].reshape(-1)[c.src] * c.live)


def _rw_reference(ts, te, sg, m, thre, eps):
    """render_weights in f64 with the alpha and early-stop decisions of the
    plain version in f32: the arithmetic's reference, without the filters'
    discontinuities (a lane within rounding of a threshold may fall either
    way in f32)."""
    with torch.no_grad():
        delta = torch.clamp_min(te - ts, 0.0)
        x = torch.where(m, sg * delta, torch.zeros_like(sg))
        a = 1.0 - torch.exp(-x)
        use = not (isinstance(thre, float) and thre <= 0.0)
        keep = (m & (a >= thre)) if use else torch.ones_like(m)
        x = torch.where(keep, x, torch.zeros_like(x))
        trans = torch.exp(-(torch.cumsum(x, -1) - x))
        alive = (trans >= eps) if eps > 0 else torch.ones_like(m)
    ts64, te64, sg64 = (t.double().requires_grad_(True) for t in (ts, te, sg))
    delta = torch.clamp_min(te64 - ts64, 0.0)
    x = torch.where(m, sg64 * delta, torch.zeros_like(sg64))
    a = torch.where(keep, 1.0 - torch.exp(-x), torch.zeros_like(x))
    x = torch.where(keep, x, torch.zeros_like(x))
    w = torch.where(alive, a, torch.zeros_like(a)) * torch.exp(-(torch.cumsum(x, -1) - x))
    return w, (ts64, te64, sg64)


@pytest.mark.parametrize("S", [1, 7, 32, 33, 48, 64, 96, 256])
@pytest.mark.parametrize("thre,eps", [(0.0, 0.0), (0.01, 1e-4), ("tensor", 1e-4)],
                         ids=["no-filters", "float", "tensor"])
def test_k6c_matches_plain_and_f64(cuda, S, thre, eps):
    """K6c forward and backward against the f64 reference: the kernel's
    error no larger than the plain version's plus 1e-6 (weights, in [0, 1])
    and plus 1e-5 of the largest entry (each gradient; the plain version's
    backward scans in f32 too); the same bits when run again."""
    R = 513
    gen = torch.Generator().manual_seed(S)
    dt = torch.rand((R, S), generator=gen) * 0.02 + 0.002
    te = 0.5 + torch.cumsum(dt, 1)
    ts = te - dt
    sg = torch.distributions.Exponential(0.05).sample((R, S))
    m = torch.rand((R, S), generator=gen) < 0.8
    ts, te, sg, m = (t.to(cuda) for t in (ts, te, sg, m))
    tthre = torch.tensor(0.02, device=cuda) if thre == "tensor" else thre
    g = torch.randn((R, S), device=cuda)
    ins = [t.clone().requires_grad_(True) for t in (ts, te, sg)]
    pins = [t.clone().requires_grad_(True) for t in (ts, te, sg)]
    w = k6_comp.render_weights(*ins, m, tthre, eps)
    wp = k6_comp.render_weights(*pins, m, tthre, eps, impl="plain")
    ref, refs = _rw_reference(ts, te, sg, m, tthre, eps)
    grads = torch.autograd.grad(w, ins, g)
    pgrads = torch.autograd.grad(wp, pins, g)
    rgrads = torch.autograd.grad(ref, refs, g.double())
    err, perr = (float((x.double() - ref).abs().max()) for x in (w, wp))
    assert err <= perr + 1e-6, (err, perr)
    for name, a, p, r in zip(("t_starts", "t_ends", "sigmas"), grads, pgrads, rgrads):
        e, pe = (float((x.double() - r).abs().max()) for x in (a, p))
        assert e <= pe + 1e-5 * float(r.abs().max()), (name, e, pe)
    again = k6_comp.render_weights_bwd_cuda(ts, te, sg, m, tthre, eps, g)
    assert torch.equal(k6_comp.render_weights_cuda(ts, te, sg, m, tthre, eps), w)
    for a, b in zip((grads[2], grads[0], grads[1]), again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S", [1, 7, 32, 33, 48, 64, 96, 256])
@pytest.mark.parametrize("thre,eps", [(0.01, 1e-4), (0.01, 0.0), ("tensor", 1e-4),
                                      ("tensor", 0.0)],
                         ids=["float-eps", "float", "tensor-eps", "tensor"])
def test_k6c_backward_every_shape(cuda, S, thre, eps):
    """K6c's backward at every lane count the forward takes, on rows of
    stride S + 5 (column slices of wider tensors): each of dsigma, dts and
    dte wanted or not gives the bits of the call that wants all three;
    where the forward dropped a lane (masked, or alpha under the threshold)
    every gradient is 0; the backward's t gradient is 0 exactly where the
    forward kernel's weight is 0 (its recomputed keep, alive and T are the
    forward's); the gradients within the plain version's error of f64 plus
    1e-5 of the largest entry."""
    R, W = 300, S + 5
    gen = torch.Generator().manual_seed(100 + S)
    dt = torch.rand((R, W), generator=gen) * 0.02 + 0.002
    te = 0.5 + torch.cumsum(dt, 1)
    ts = te - dt
    ts[::17, 0] += 0.05  # negative intervals: clamp_min passes no t gradient
    sg = torch.distributions.Exponential(0.05).sample((R, W))
    sg[::5] *= 0.02  # many lanes under the alpha threshold
    m = torch.rand((R, W), generator=gen) < 0.8
    ts, te, sg, m = (t.to(cuda)[:, 2:2 + S] for t in (ts, te, sg, m))
    assert ts.stride(0) == W
    tthre = torch.tensor(0.01, device=cuda) if thre == "tensor" else thre
    g = torch.randn((R, S), device=cuda, generator=torch.Generator(cuda).manual_seed(S))
    full = k6_comp.render_weights_bwd_cuda(ts, te, sg, m, tthre, eps, g)
    for need in [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]:
        got = k6_comp.render_weights_bwd_cuda(ts, te, sg, m, tthre, eps, g, need)
        for want, x, y in zip(need, got, full):
            assert (x is None) == (not want)
            if want:
                assert torch.equal(x, y), need
    w = k6_comp.render_weights_cuda(ts, te, sg, m, tthre, eps)
    assert torch.equal(full[2] != 0, w != 0)
    x = torch.where(m, sg * torch.clamp_min(te - ts, 0.0), torch.zeros_like(sg))
    dropped = ~m | (1.0 - torch.exp(-x) < 0.01 * (1.0 - 1e-5))  # clear of rounding at 0.01
    for y in full:
        assert bool((y[dropped] == 0).all())
    ref, refs = _rw_reference(ts, te, sg, m, tthre, eps)
    pins = [t.clone().requires_grad_(True) for t in (ts, te, sg)]
    wp = k6_comp.render_weights(*pins, m, tthre, eps, impl="plain")
    pgrads = torch.autograd.grad(wp, pins, g)
    rgrads = torch.autograd.grad(ref, refs, g.double())
    for name, a, p, r in zip(("t_starts", "t_ends", "sigmas"), (full[1], full[2], full[0]),
                             pgrads, rgrads):
        e, pe = (float((v.double() - r).abs().max()) for v in (a, p))
        assert e <= pe + 1e-5 * float(r.abs().max()), (name, e, pe)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [1, 6, 33, 128])
@pytest.mark.parametrize("R,S,lo,hi,budget,dead", [K6A_CASES[3], K6A_CASES[4], K6A_CASES[6]])
def test_k6d_matches_plain_and_f64(cuda, R, S, lo, hi, budget, dead, C, dtype):
    """K6d forward and backward against the plain version evaluated in f64
    (the same sums): the kernel's error no larger than the plain version's
    plus 1e-6 of the largest entry (the plain version's prefix difference
    loses to cancellation on long buffers); bf16 values are read exactly, and
    dh, which rounds to bf16 once, within one bf16 ulp of the f64 product.
    Rows past the total get dh = 0 and add to no lane; detached weights take
    no gradient; a second run gives the same bits."""
    mask = _k6_mask(R, S, R + C).to(cuda)
    live = (torch.rand(R, device=cuda) < 0.6) if dead else None
    c = k6_compact.compact_stage(mask[:, lo:hi], live, budget)
    wide = torch.rand((R, S), device=cuda, requires_grad=True)
    wl = wide[:, lo:hi]  # the model's column slice, row stride S
    h = torch.randn((budget, C), device=cuda).to(dtype).requires_grad_(True)
    g = torch.randn((R, C), device=cuda)
    out = k6_comp.compact_accumulate(wl, h, c)
    dwide, dh = torch.autograd.grad(out, (wide, h), g)
    dw = dwide[:, lo:hi]
    wp = wl.detach().clone().requires_grad_(True)
    outp = k6_comp.compact_accumulate(wp, h.detach(), c, impl="plain")
    (dwp,) = torch.autograd.grad(outp, (wp,), g)
    w64, h64 = wl.detach().double().requires_grad_(True), h.detach().double().requires_grad_(True)
    c64 = dataclasses.replace(c, live=c.live.double())
    ref = k6_comp.compact_accumulate(w64, h64, c64, impl="plain")
    dw64, dh64 = torch.autograd.grad(ref, (w64, h64), g.double())
    for name, a, p, r in (("out", out, outp, ref), ("dw", dw, dwp, dw64)):
        e, pe = (float((x.double() - r).abs().max()) for x in (a, p))
        assert e <= pe + 1e-6 * float(r.abs().max()), (name, e, pe)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -22
    assert float(((dh.double() - dh64).abs() - ulp * dh64.abs()).max()) <= 1e-30
    total = int(c.total)
    assert float(dh[total:].abs().max() if total < budget else 0.0) == 0.0
    assert float(dw[~c.mask].abs().max() if (~c.mask).any() else 0.0) == 0.0
    out2 = k6_comp.compact_accumulate(wl.detach(), h, c)  # detached weights
    (dh2,) = torch.autograd.grad(out2, (h,), g)
    assert torch.equal(out2, out) and torch.equal(dh2, dh)
    dh3, dw3 = k6_comp.compact_accumulate_bwd_cuda(wl.detach(), h.detach(), c, g)
    assert torch.equal(dh3, dh) and torch.equal(dw3, dw)


def test_k6_kernels_refuse_bad_inputs(cuda):
    mask = _k6_mask(40, 16, 3).to(cuda)
    c = k6_compact.compact_stage(mask, None, 256)
    w = torch.rand((40, 16), device=cuda)
    with pytest.raises(ValueError):
        k6_comp.compact_accumulate_cuda(w, torch.randn((256, 3), device=cuda).half(), c)
    with pytest.raises(ValueError):
        k6_comp.compact_accumulate_cuda(w.cpu(), torch.randn((256, 3), device=cuda), c)
    with pytest.raises(ValueError):
        k6_comp.render_weights_cuda(*(torch.rand((4, 300), device=cuda),) * 3,
                                    torch.ones((4, 300), dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):
        k6_compact.lanes_from_rows_cuda(torch.zeros(256), c)
    with pytest.raises(ValueError):
        k6_compact.compact_stage_cuda(torch.ones((8, 300), dtype=torch.bool, device=cuda), None,
                                      64)
    with pytest.raises(ValueError):
        k6_comp.compact_accumulate_stages_cuda(
            w, [(0, 16, torch.randn((256, 3), device=cuda), c),
                (0, 16, torch.randn((256, 4), device=cuda), c)])


# ------------------------------------------------------------- K5 and K7
K5_BOX = ((-1.1, -0.7, -1.3), (1.3, 1.5, 0.9))  # off-centre: the centre and half round


def _k5_grid(cuda, res, levels, pool, kind, seed=5, packed=True):
    """(OccGridConfig, occ_state on the card): a bitfield with a dense ball in
    level 0 and 30% of the outer shells ("random"), every cell ("dense") or
    none ("empty"), its pooled bytes and packed words by the plain versions,
    and a random occs_low for the od culling."""
    cfg = k7_occ.OccGridConfig(resolution=res, levels=levels, aabb_min=K5_BOX[0],
                               aabb_max=K5_BOX[1], pool=pool)
    n = levels * res**3
    gen = torch.Generator().manual_seed(seed)
    if kind == "dense":
        bits = torch.ones(n, dtype=torch.bool)
    elif kind == "empty":
        bits = torch.zeros(n, dtype=torch.bool)
    else:
        bits = torch.rand(n, generator=gen) < 0.3
        ijk = torch.stack(torch.meshgrid(*[torch.arange(res)] * 3, indexing="ij"), -1).flip(-1)
        ball = ((ijk - res / 2 + 0.5).norm(dim=-1) < res / 4).reshape(-1)
        bits[:res**3] = ball | (torch.rand(res**3, generator=gen) < 0.05)
    state = {"binaries": bits.to(cuda),
             "occs_low": (-0.02 * torch.log1p(-torch.rand(n, generator=gen))).to(cuda)}
    if pool > 1:
        state["binaries_pooled"] = k7_occ._pool_binaries(state["binaries"], cfg)
    if packed and res % 4 == 0:
        state["packed_words"] = k7_occ._pack_supercell_words(state["binaries"], cfg)
    return cfg, state


def _k5_rays(cuda, R, seed=7):
    """R rays: from a sphere of radius 4 toward points in the box; a tenth
    start inside the level-0 box, a tenth point away from it (they miss)."""
    gen = torch.Generator().manual_seed(seed)
    lo, hi = torch.tensor(K5_BOX[0]), torch.tensor(K5_BOX[1])
    centre = (lo + hi) / 2
    o = torch.randn((R, 3), generator=gen)
    o = centre + 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = lo + (hi - lo) * torch.rand((R, 3), generator=gen) - o
    m = R // 10
    o[:m] = lo + (hi - lo) * torch.rand((m, 3), generator=gen)
    d[:m] = torch.randn((m, 3), generator=gen)
    d[m:2 * m] = o[m:2 * m] - centre
    return o.to(cuda), d.to(cuda), torch.rand(R, generator=gen).to(cuda)


def _k5_march(res, pool, **kw):
    rss = float(np.linalg.norm(np.subtract(K5_BOX[1], K5_BOX[0]))) / 1000.0
    args = dict(num_candidates=1024, num_samples=64, occ_subsamples=4, pool=pool,
                render_step_size=rss, cone_angle=0.004)
    args.update(kw)
    return k5_march.MarchConfig(**args)


K5_CASES = {  # label: (R, res, levels, pool, grid, samples a ray in budget, jitter, march kw)
    "random": (3001, 32, 2, 4, "random", None, False, {}),
    "random-binding": (3001, 32, 2, 4, "random", 16, False, {}),
    "dense-binding": (3001, 32, 2, 4, "dense", 16, False, {}),
    "dense": (3001, 32, 2, 4, "dense", None, True, {}),
    "empty-binding": (3001, 32, 2, 4, "empty", 16, True, {}),
    "jitter-binding": (3001, 32, 2, 4, "random", 24, True, {}),
    "no-pool": (3001, 32, 2, 0, "random", 16, True, {}),
    "pool-2": (3001, 32, 2, 2, "random", 16, True, {}),
    "bytes": (3001, 32, 2, 4, "random", 16, True, {"packed": False}),
    "res-36-pool-2": (1000, 36, 2, 2, "random", 16, True, {}),
    "k-1": (1000, 32, 2, 0, "random", 8, True, dict(num_candidates=256, num_samples=48,
                                                     occ_subsamples=1)),
    "linear": (1000, 32, 2, 4, "random", 16, True, dict(cone_angle=0.0)),
    "fine-1024": (500, 32, 2, 4, "random", None, True, dict(num_candidates=4096, num_samples=512,
                                                          pool_supers=256)),
    "one-ray": (1, 32, 2, 4, "random", 4, True, {}),
    "phase-3": (4096, 128, 4, 4, "random", 32, False, {}),
    "phase-5": (4096, 128, 4, 4, "random", 32, True, {}),
    "phase-7": (79_360, 128, 4, 4, "random", 376_576 / 79_360, True, {}),
}


@pytest.mark.parametrize("case", list(K5_CASES))
def test_k5_matches_plain_bit_for_bit(cuda, case):
    """K5 against the plain march on the card: t_starts, t_ends, mask,
    num_samples and num_occupied the same bits, and again on a second run.
    Dense grids stride every ray in both rank-selects, binding budgets scale
    every ray's down; rays miss the box or start inside it."""
    R, res, levels, pool, grid, per_ray, jitter, kw = K5_CASES[case]
    kw = dict(kw)
    cfg, state = _k5_grid(cuda, res, levels, pool, grid, packed=kw.pop("packed", True))
    march = _k5_march(res, pool, **kw)
    o, d, jit = _k5_rays(cuda, R)
    budget = None if per_ray is None else int(per_ray * R)
    args = (state, cfg, march, o, d, jit if jitter else None, budget)
    got = k5_march.march_rays_cuda(*args)
    again = k5_march.march_rays_cuda(*args)
    ref = k5_march.march_rays_plain(*args)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got[k], again[k]), k
    n = got["num_samples"]
    if grid != "empty":
        assert int(n.sum()) > 0
    if budget is not None:
        assert int(n.sum()) <= budget


@pytest.mark.parametrize("grid", ["dense", "random"])
@pytest.mark.parametrize("supers", [1, 7, 8, 9, 31, 32, 40])
def test_k5_prepass_budgets_bit_for_bit(cuda, supers, grid):
    """The pre-pass budget min(count, supers) at 1, 7, 8, 9, 31, 32 and 40
    supercells (pool 4: budget x pool on and beside the 32-candidate words'
    edges, and past one round of 32 slots), with rays that miss the box or
    keep nothing (budget 0): K5 against the plain march bit for bit, with a
    batch budget and without."""
    cfg, state = _k5_grid(cuda, 32, 2, 4, grid)
    march = _k5_march(32, 4, pool_supers=supers)
    o, d, jit = _k5_rays(cuda, 1001, seed=supers)
    for budget in (None, 8 * 1001):
        ref = k5_march.march_rays_plain(state, cfg, march, o, d, jit, budget)
        got = k5_march.march_rays_cuda(state, cfg, march, o, d, jit, budget)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    counted = k5_march.march_count_cuda(state, cfg, march, o, d, jit)
    kept = torch.clamp_max(counted.state[:, 2], supers)
    assert bool((kept == 0).any())
    if grid == "dense":
        assert bool((kept == supers).any())


K5_STOP_CASES = {  # label: (pool, march kw, rays kind)
    "no-pre-pass": (0, {}, "rays"),
    "no-pre-pass-cone-0": (0, dict(cone_angle=0.0), "rays"),
    "pre-pass-cone-0": (4, dict(cone_angle=0.0), "rays"),
    "no-pre-pass-k-1": (0, dict(num_candidates=256, num_samples=48, occ_subsamples=1), "rays"),
    "all-miss": (4, {}, "miss"),
    "all-miss-no-pre-pass": (0, {}, "miss"),
}


@pytest.mark.parametrize("case", list(K5_STOP_CASES))
def test_k5_stops_past_t_max_bit_for_bit(cuda, case):
    """K5a stops a ray's candidate words at the first word that ends past
    t_max: without a pre-pass, at cone 0, and on rays that all miss the box
    (no candidate in range, the first word the last): the plain march's
    bits."""
    pool, kw, kind = K5_STOP_CASES[case]
    cfg, state = _k5_grid(cuda, 32, 2, pool, "random")
    march = _k5_march(32, pool, **kw)
    o, d, jit = _k5_rays(cuda, 1001)
    if kind == "miss":
        o, d = o + 50.0, d.abs() + 0.1
    for budget in (None, 12 * 1001):
        got = k5_march.march_rays_cuda(state, cfg, march, o, d, jit, budget)
        ref = k5_march.march_rays_plain(state, cfg, march, o, d, jit, budget)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
    if kind == "miss":
        assert int(got["num_occupied"].sum()) == 0


def test_k5_launches_through_the_wrapper(cuda):
    cfg, state = _k5_grid(cuda, 32, 2, 4, "random")
    o, d, _ = _k5_rays(cuda, 100)
    before = (k5_march.MARCH_COUNT.launches, k5_march.MARCH_EMIT.launches)
    k5_march.march_rays(state, cfg, _k5_march(32, 4), o, d)
    k5_march.march_rays(state, cfg, _k5_march(32, 4), o, d, impl="plain")
    assert (k5_march.MARCH_COUNT.launches, k5_march.MARCH_EMIT.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("binding", [False, True])
@pytest.mark.parametrize("pool", [0, 4])
@pytest.mark.parametrize("slots", [1, 16, 17, 32, 33, 64])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_k5b_slots_and_samples_a_cell_bit_for_bit(cuda, k, slots, pool, binding):
    """K5b, a lane a slot: k fine samples a cell (at 4 a lane's 16-byte
    stores, else the columns shuffled to their lanes) and Sc slots a ray on
    and beside 16 (two rays a warp up to it) and one round of 32, with a
    pre-pass and without, the batch budget binding or not: the plain
    march's bits, twice."""
    cfg, state = _k5_grid(cuda, 32, 2, pool, "random")
    march = _k5_march(32, pool, num_candidates=1024 * k, num_samples=slots * k,
                      occ_subsamples=k)
    R = 1001
    o, d, jit = _k5_rays(cuda, R, seed=k + slots)
    free = int(k5_march.march_rays_plain(state, cfg, march, o, d, jit)["num_samples"].sum())
    budget = free // 2 if binding else None
    args = (state, cfg, march, o, d, jit, budget)
    got = k5_march.march_rays_cuda(*args)
    again = k5_march.march_rays_cuda(*args)
    ref = k5_march.march_rays_plain(*args)
    for key in ref:
        assert torch.equal(got[key], ref[key]), key
        assert torch.equal(got[key], again[key]), key
    n = got["num_samples"]
    assert int(n.sum()) > 0 and int(n.max()) <= slots * k
    if binding:  # within the budget but for a ray's one kept slot, which the scale keeps
        assert int(n.sum()) <= budget + k * int((got["num_occupied"] > 0).sum())
        assert slots == 1 or int(n.sum()) < free


def k5_od_reference(state, cfg, march, o, d, od_max):
    """The od culling in f64 over the plain march's own candidates: (the
    occupied mask, the od before each candidate, the mask before the
    culling)."""
    c = k5_march.march_candidates_plain(state, cfg, march, o, d)
    vals, _ = k7_occ.query_grid_values(state["occs_low"], c["positions"], cfg)
    occ = c["occupied"]
    contrib = torch.where(occ, vals, torch.zeros_like(vals)).double() * (
        c["dts"].double() / march.render_step_size)
    od = torch.cumsum(contrib, -1) - contrib
    return occ & (od < od_max), od, occ


@pytest.mark.parametrize("pool", [0, 4])
@pytest.mark.parametrize("od_max", [0.05, 0.5, float("inf")])
def test_k5_od_culling_against_f64(cuda, od_max, pool):
    """The od culling sums in candidate order in f32 where the plain version's
    cumsum takes another order: held with the plain version to an f64
    evaluation. A ray with a candidate whose od lies within 1e-5 (relative)
    of od_max may go either way; every other ray's count equals f64's."""
    cfg, state = _k5_grid(cuda, 32, 2, pool, "random")
    march = _k5_march(32, pool, early_stop_od=0.5)
    o, d, _ = _k5_rays(cuda, 3001)
    got = k5_march.march_rays_cuda(state, cfg, march, o, d, None, None, od_max)
    ref = k5_march.march_rays_plain(state, cfg, march, o, d, None, None, od_max)
    mask64, od, unculled = k5_od_reference(state, cfg, march, o, d, od_max)
    near = ((od - od_max).abs() <= 1e-5 * od_max).any(-1) if od_max < float("inf") else \
        torch.zeros(o.shape[0], dtype=torch.bool, device=cuda)
    want = mask64.sum(-1).int() * march.occ_subsamples
    for r in (got, ref):
        assert torch.equal(r["num_occupied"][~near], want[~near])
    same = ~near
    for k in ref:
        assert torch.equal(got[k][same], ref[k][same]), k
    if od_max < float("inf"):
        assert int(mask64.sum()) < int(unculled.sum())  # it culled


def _k7_density(p):
    """A density that varies inside a cell, so probes of one cell differ."""
    return torch.relu(30.0 - 20.0 * p.norm(dim=-1)) + 2.0 * (p[..., 0] > 0.2).float()


K7_GRIDS = [(32, 2, 4), (32, 2, 2), (32, 2, 0), (36, 2, 2), (36, 1, 0), (128, 4, 4)]


@pytest.mark.parametrize("res,levels,pool", K7_GRIDS)
def test_k7_full_update_matches_plain(cuda, res, levels, pool):
    """K7 against the plain update on the card, full: occs, occs_low, the
    bitfield, its pooled bytes and packed words the same bits, twice."""
    cfg = k7_occ.OccGridConfig(resolution=res, levels=levels, aabb_min=K5_BOX[0],
                               aabb_max=K5_BOX[1], pool=pool)
    n = levels * res**3
    gen = torch.Generator(cuda).manual_seed(res + pool)
    state = {"occs": 0.02 * torch.rand(n, device=cuda, generator=gen),
             "occs_low": 0.01 * torch.rand(n, device=cuda, generator=gen)}
    jitter = torch.rand((n, 3), device=cuda, generator=gen)
    got = k7_occ.update_occ_state_cuda(state, cfg, _k7_density, 0.004, jitter)
    again = k7_occ.update_occ_state_cuda(state, cfg, _k7_density, 0.004, jitter)
    ref = k7_occ.update_occ_state_plain(state, cfg, _k7_density, 0.004, jitter)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got[k], again[k]), k
    assert 0.0 < float(got["binaries"].float().mean()) < 1.0


@pytest.mark.parametrize("res,levels,pool", [(32, 2, 4), (36, 2, 2), (128, 4, 4)])
def test_k7_partial_update_with_repeated_cells_matches_plain(cuda, res, levels, pool):
    """A partial update whose cells repeat (each drawn up to four times):
    the largest probe in occs, the smallest in occs_low, the same bits as
    the plain version's scatter_reduce; a NaN density maps to 0."""
    cfg = k7_occ.OccGridConfig(resolution=res, levels=levels, aabb_min=K5_BOX[0],
                               aabb_max=K5_BOX[1], pool=pool)
    n = levels * res**3
    gen = torch.Generator(cuda).manual_seed(res)
    state = {"occs": 0.05 * torch.rand(n, device=cuda, generator=gen),
             "occs_low": 0.01 * torch.rand(n, device=cuda, generator=gen)}
    m = max(n // 9, 64)
    cell = torch.randint(0, res**3, (m,), device=cuda, generator=gen)
    level = torch.randint(0, levels, (m,), device=cuda, generator=gen)
    q = m // 4
    cell[q:2 * q], level[q:2 * q] = cell[:q], level[:q]
    cell[2 * q:2 * q + q // 2], level[2 * q:2 * q + q // 2] = cell[:q // 2], level[:q // 2]
    jitter = torch.rand((m, 3), device=cuda, generator=gen)

    def density(p):
        out = _k7_density(p)
        out[::97] = float("nan")
        return out

    args = (cfg, density, 0.004, jitter, (level, cell))
    # the update takes its state's grids over on the card: each run gets a copy
    mine = [{k: v.clone() for k, v in state.items()} for _ in range(2)]
    got, again = (k7_occ.update_occ_state_cuda(s, *args) for s in mine)
    ref = k7_occ.update_occ_state_plain(state, *args)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got[k], again[k]), k
    for k in ("occs", "occs_low"):  # in place
        assert got[k].data_ptr() == mine[0][k].data_ptr(), k


K7_CHOICE_GRIDS = {  # label: (res, levels, pool, each level's occupied share)
    "empty-and-full-levels": (32, 3, 4, (0.2, 0.0, 1.0)),
    "sparse": (32, 2, 0, (0.0005, 0.3)),
    "res-30": (30, 2, 2, (0.1, 0.05)),  # rows off the 4-byte words
    "res-33": (33, 2, 0, (0.3, 0.02)),
    "flagship": (128, 4, 4, (0.03, 0.01, 0.004, 0.0)),
}


def _k7_choice_state(cuda, res, levels, pool, shares, seed):
    """A grid with each level's bitfield at its share (a level at 0 empty,
    at 1 full), occs above the threshold where a bit is set."""
    cfg = k7_occ.OccGridConfig(resolution=res, levels=levels, aabb_min=K5_BOX[0],
                               aabb_max=K5_BOX[1], pool=pool)
    gen = torch.Generator(cuda).manual_seed(seed)
    bits = torch.cat([torch.rand(res**3, device=cuda, generator=gen) < share
                      for share in shares])
    occs = torch.where(bits, 0.05, 0.001) * torch.rand(bits.shape, device=cuda, generator=gen)
    state = {"occs": occs + bits * 0.02, "occs_low": 0.01 * torch.rand(
        bits.shape, device=cuda, generator=gen), "binaries": bits}
    return cfg, state


@pytest.mark.parametrize("case", list(K7_CHOICE_GRIDS))
def test_k7_cell_choice_matches_partial_cells(cuda, case):
    """K7a's cell choice from the draws against partial_cells on the card:
    the same (level, cell) at every probe, with a level with no occupied
    cell (its fallback cells), a full level, the stratified ranks 0, count
    - 1 and count (clamped to the level's last cell), and a res that is not
    a multiple of 4; the bitfield untouched; then the whole update from the
    draws the plain one's bits, its grids written in place."""
    res, levels, pool, shares = K7_CHOICE_GRIDS[case]
    cfg, state = _k7_choice_state(cuda, res, levels, pool, shares, seed=res + levels)
    draws = k7_occ.draw_partial_cells(cfg, torch.Generator(cuda).manual_seed(3), cuda)
    for d in draws:  # the first draw at rank 0, the last two at count - 1 and at count
        d["u"][0] = 0.0
        d["u"][-2] = 0.5
        d["u"][-1] = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
    level, cell = k7_occ.partial_cells(state, cfg, draws)
    m = level.shape[0]
    jitter = torch.rand((m, 3), device=cuda, generator=torch.Generator(cuda).manual_seed(4))
    binaries = state["binaries"].clone()
    probes = k7_occ.occ_probe_cuda({k: v.clone() for k, v in state.items()}, cfg, jitter,
                                   draws=draws)
    assert torch.equal(probes.flat.long(), level * cfg.cells_per_level + cell)
    assert torch.equal(state["binaries"], binaries)
    counts = state["binaries"].reshape(levels, -1).sum(-1)
    ranks_seen = set()
    for lvl, d in enumerate(draws):  # the ranks as partial_cells computes them
        m_occ = d["u"].shape[0]
        strat = (torch.arange(m_occ, dtype=torch.float32, device=cuda) + d["u"]) / m_occ
        rank = torch.floor(strat * counts[lvl].float()).long()
        c = int(counts[lvl])
        if c:
            ranks_seen |= {r for r in (0, c - 1, c) if bool((rank == r).any())}
    assert 0 in ranks_seen
    mine = {k: v.clone() for k, v in state.items()}
    got = k7_occ.update_occ_state_cuda(mine, cfg, _k7_density, 0.004, jitter, draws=draws)
    ref = k7_occ.update_occ_state_plain(state, cfg, _k7_density, 0.004, jitter, draws=draws)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    for k in ("occs", "occs_low"):
        assert got[k].data_ptr() == mine[k].data_ptr(), k
    assert torch.equal(state["binaries"], binaries)


def test_k7_cell_choice_reaches_every_rank_edge(cuda):
    """On the flagship grid the edge ranks all occur: 0, count - 1 and count
    (which partial_cells clamps to the level's last cell)."""
    res, levels, pool, shares = K7_CHOICE_GRIDS["flagship"]
    cfg, state = _k7_choice_state(cuda, res, levels, pool, shares, seed=1)
    draws = k7_occ.draw_partial_cells(cfg, torch.Generator(cuda).manual_seed(5), cuda)
    d = draws[0]
    d["u"][0], d["u"][-2] = 0.0, 0.5
    d["u"][-1] = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
    count = int(state["binaries"][:res**3].sum())
    m_occ = d["u"].shape[0]
    strat = (torch.arange(m_occ, dtype=torch.float32, device=cuda) + d["u"]) / m_occ
    rank = torch.floor(strat * float(count)).long()
    assert int(rank[0]) == 0 and int(rank[-2]) == count - 1 and int(rank[-1]) == count
    level, cell = k7_occ.partial_cells(state, cfg, draws)
    jitter = torch.rand((level.shape[0], 3), device=cuda)
    probes = k7_occ.occ_probe_cuda({k: v.clone() for k, v in state.items()}, cfg, jitter,
                                   draws=draws)
    assert torch.equal(probes.flat.long(), level * cfg.cells_per_level + cell)
    last = int(torch.nonzero(state["binaries"][:res**3])[-1])
    first = int(torch.nonzero(state["binaries"][:res**3])[0])
    uni = d["uniform"].shape[0]
    assert int(cell[uni]) == first and int(cell[uni + m_occ - 2]) == last
    assert int(cell[uni + m_occ - 1]) == res**3 - 1


K7B_GRIDS = [(128, 4, 4), (128, 4, 2), (64, 2, 4), (64, 2, 2), (32, 2, 4), (32, 2, 2),
             (32, 1, 0), (30, 2, 2), (33, 1, 0)]


@pytest.mark.parametrize("scale", [0.04, 0.01], ids=["occ_thre", "mean"])
@pytest.mark.parametrize("res,levels,pool", K7B_GRIDS)
def test_k7b_threshold_pack_matches_plain(cuda, res, levels, pool, scale):
    """K7b alone against _threshold_pack_plain, bit for bit and repeated: a
    thread a supercell where res % 4 == 0 (pool 4 from the word, another
    pool in a second pass), a thread a cell at res 30 and 33. An eighth of
    the cells are 0 and a thirteenth sit on the threshold (exactly, where it
    is occ_thre: scale 0.04; near it where it is the mean: 0.01)."""
    cfg = k7_occ.OccGridConfig(resolution=res, levels=levels, pool=pool)
    gen = torch.Generator(cuda).manual_seed(res + pool)
    occs = scale * torch.rand(levels * res**3, device=cuda, generator=gen)
    occs[::8] = 0.0
    occs[::13] = torch.clamp_max(torch.mean(occs), cfg.occ_thre)
    mean = torch.mean(occs)
    before = k7_occ.OCC_PACK.launches
    got = k7_occ.threshold_pack_cuda(occs, mean, cfg)
    again = k7_occ.threshold_pack_cuda(occs, mean, cfg)
    ref = k7_occ._threshold_pack_plain(occs, mean, cfg)
    assert k7_occ.OCC_PACK.launches == before + 2
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got[k], again[k]), k
    assert 0.0 < float(got["binaries"].float().mean()) < 1.0


@pytest.mark.parametrize("res", [32, 30])
def test_k7b_refuses_a_misaligned_grid(cuda, res):
    """A view of occs 4 bytes past a 16-byte boundary: refused before any
    launch where K7b reads rows as float4 (res % 4 == 0), taken with the
    plain version's bits where it reads a cell a thread."""
    cfg = k7_occ.OccGridConfig(resolution=res, levels=2, pool=2)
    n = 2 * res**3
    occs = torch.zeros(n + 4, device=cuda)[1:n + 1]
    occs.copy_(0.02 * torch.rand(n, device=cuda))
    assert occs.is_contiguous() and occs.data_ptr() % 16 == 4
    mean = torch.mean(occs)
    before = k7_occ.OCC_PACK.launches
    if res % 4 == 0:
        with pytest.raises(ValueError, match="16-byte aligned"):
            k7_occ.threshold_pack_cuda(occs, mean, cfg)
        assert k7_occ.OCC_PACK.launches == before
    else:
        got = k7_occ.threshold_pack_cuda(occs, mean, cfg)
        ref = k7_occ._threshold_pack_plain(occs, mean, cfg)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k


def test_k7_launches_and_the_model_path(cuda):
    """The model's update goes through K7a twice (before and after the
    density) and K7b once; impl="plain" launches neither."""
    cfg = k7_occ.OccGridConfig(resolution=32, levels=2, pool=4)
    n = 2 * 32**3
    state = {"occs": torch.zeros(n, device=cuda), "occs_low": torch.zeros(n, device=cuda)}
    jitter = torch.rand((n, 3), device=cuda)
    before = (k7_occ.OCC_UPDATE.launches, k7_occ.OCC_PACK.launches)
    k7_occ.update_occ_state(state, cfg, _k7_density, 0.004, jitter)
    k7_occ.update_occ_state(state, cfg, _k7_density, 0.004, jitter, impl="plain")
    assert (k7_occ.OCC_UPDATE.launches, k7_occ.OCC_PACK.launches) == (before[0] + 2,
                                                                       before[1] + 1)


def test_k5_k7_refuse_bad_inputs(cuda):
    cfg, state = _k5_grid(cuda, 32, 2, 4, "random")
    o, d, jit = _k5_rays(cuda, 64)
    march = _k5_march(32, 4)
    with pytest.raises(ValueError):
        k5_march.march_rays_cuda(state, cfg, march, o.double(), d)
    with pytest.raises(ValueError):
        k5_march.march_rays_cuda(state, cfg, march, o, d, jit[:10])
    with pytest.raises(ValueError):
        k5_march.march_rays_cuda(dict(state, packed_words=state["packed_words"].int()), cfg,
                                 march, o, d)
    with pytest.raises(ValueError, match="candidates"):
        k5_march.march_rays_cuda(state, cfg, _k5_march(32, 0, num_candidates=8192,
                                                       occ_subsamples=1), o, d)
    n = 2 * 32**3
    occs = torch.zeros(n, device=cuda)
    with pytest.raises(ValueError):
        k7_occ.update_occ_state_cuda({"occs": occs, "occs_low": occs}, cfg, _k7_density, 0.004,
                                     torch.rand((n, 2), device=cuda))
    with pytest.raises(ValueError):
        k7_occ.update_occ_state_cuda({"occs": occs, "occs_low": occs}, cfg,
                                     lambda p: _k7_density(p).double(), 0.004,
                                     torch.rand((n, 3), device=cuda))
    with pytest.raises(ValueError):
        k7_occ.threshold_pack_cuda(occs[:-1], occs.mean(), cfg)
