"""umhs_torch's hand-written kernels against their plain versions, on the card.

Marked `cuda` and skipped without an NVIDIA card. On a machine with one
(it needs no JAX, so skip the repo's conftest, which imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

chip_smoke.py runs the same checks at the flagship shapes; these cover the
edge cases at small sizes, including the 256-wide chain of the DINO head.
"""

import dataclasses

import numpy as np
import pytest
import torch

from umhs_torch.data.cameras import generate_camera_rays
from umhs_torch.data.synthetic import SyntheticSceneConfig, render_views, scene_cameras
from umhs_torch.engine.trainer import Trainer, TrainerConfig
from umhs_torch.models.model import ModelConfig
from umhs_torch.ops.encodings import (
    HASH_ENCODE_FWD, HashEncodingConfig, hash_encode_fwd, hash_encode_plain)
from umhs_torch.ops.mlp import init_mlp
from umhs_torch.ops.mlp_fused import MLP_FUSED_FWD, mlp_fused_fwd, mlp_plain

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
