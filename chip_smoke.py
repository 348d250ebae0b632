#!/usr/bin/env python3
"""GPU smoke run of umhs_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
1. Device and build: the card's name and power limit, then every kernel in
   umhs_torch/csrc is compiled by nvcc into umhs_torch/_build/ (timed).
2. Each kernel against its plain PyTorch version on the card, at the
   flagship shapes, with its median time, the plain version's, one PyTorch
   yardstick's and the bound from bytes or operations:
   - K1 mlp_fused_fwd: the four field MLP chains, f32 (rtol/atol 1e-5) and
     bf16 (2e-2), at N = 2^20 and at an N that is not a multiple of the
     tile, plus a single-layer chain;
   - K3 hash_encode_fwd: tetrahedral and trilinear at L16xF2 2^19 on 2^20
     positions including exact 0 and 1 (atol 1e-6; table values ~1e-4);
   - K2 mlp_fused_bwd: the four chains at the training buffer's N = 131,072
     rows, f32 (rtol 1e-4, atol 1e-4 * max) and bf16 (2e-2), dx, dW and db
     against autograd of mlp_plain;
   - K4 hash_encode_bwd: tetrahedral L16xF2 2^19 at 131,072 positions,
     deterministic (rtol/atol 1e-5: float atomics add in a run-dependent
     order) and stochastic (the share of (sample, level) pairs whose vertex
     differs from the plain version's, at most 1e-4).
3. The serving path at full width: the bench scene (16 + 2 views, 128^2,
   128 bands, 6 spheres) with VCA endmembers, Trainer.setup() from seed 0
   with a bf16 compute dtype, the step-0 full occupancy update (and one
   more, timed as the steady state), then render_camera of both eval views
   at step 1000. Launch counts are zeroed
   just before and read just after; K1 and K3 must have launched.
   One more render runs under torch.profiler for the device-time breakdown.
4. The same render with kernels against plain versions, both in f32, on a
   64x64 crop (atol 1e-3 on rgb, spectral and accumulation); the first must
   launch the render's kernels and the second none.
5. The training path at full width: the same scene's 16 train views,
   Trainer.setup() from seed 0 (bf16, stochastic hash gradient, 4096 rays
   per step, warmup thinning 2), then train(48): full occupancy updates at
   steps 0 and 32, a partial one at 16. Launch counts are zeroed just before
   and read just after; K1-K4 must have launched; the loss must be finite
   and fall (mean of the last 4 steps below the first 4). One more step
   runs under torch.profiler.
6. One training step from the trained state with kernels against plain
   versions, both in f32 with the deterministic hash gradient and the same
   draws: loss within rtol 1e-5, every gradient within rtol 1e-3 (atol
   1e-4 * max of the tensor); the first launches every kernel, the second
   none.

The last lines are the card (nvidia-smi), one JSON object of kernel numbers
and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core bf16
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores

K1_CHAINS = {  # flagship widths (6 classes, 128 bands, L16xF2 encoding)
    "mlp_base": [32, 64, 16],
    "feature_mlp": [27, 64, 64, 7],
    "mlp_head": [27, 64, 64, 6],
    "mlp_directional": [28, 16, 128],
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_k1(dev):
    from umhs_torch.ops.mlp import init_mlp
    from umhs_torch.ops.mlp_fused import mlp_fused_fwd, mlp_plain

    gen = torch.Generator().manual_seed(1)
    n_full, n_odd = 1 << 20, (1 << 20) - 333
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    max_err = 0.0
    cases = [(name, dims) for name, dims in K1_CHAINS.items()] + [("single_layer", [32, 16])]
    chains = {}
    for name, dims in cases:
        params = init_mlp(gen, dims[0], len(dims) - 1, dims[1], dims[-1], dev)
        for n in (n_full, n_odd):
            x = torch.randn((n, dims[0]), generator=gen).to(dev)
            for dt in (torch.float32, torch.bfloat16):
                y = mlp_fused_fwd(params, x, dt)
                ref = mlp_plain(params, x, dt)
                torch.cuda.synchronize()
                err = float((y - ref).abs().max())
                ok = torch.allclose(y, ref, rtol=tol[dt], atol=tol[dt])
                print(f"K1 {name} N={n} {str(dt)[6:]}: max_abs_err {err:.3e} "
                      f"(tol {tol[dt]:g}) {'ok' if ok else 'MISMATCH'}")
                check(ok, f"K1 {name} N={n} {dt} disagrees with its plain version")
                max_err = max(max_err, err)
        if name not in K1_CHAINS:
            continue
        # timing at the main path's shape and dtype: N = 2^20 rows, bf16
        x = torch.randn((n_full, dims[0]), generator=gen).to(dev)
        wb = [(lay["w"].bfloat16(), lay["b"].bfloat16()) for lay in params["layers"]]

        def library(x=x, wb=wb):
            h = x.bfloat16()
            for i, (w, b) in enumerate(wb):
                h = torch.addmm(b, h, w)
                if i + 1 < len(wb):
                    h = torch.relu(h)
            return h

        macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        nbytes = n_full * (dims[0] + dims[-1]) * 4 + sum(
            lay["w"].numel() * 4 + lay["b"].numel() * 4 for lay in params["layers"])
        b_ms, b_by = bound(nbytes, 2.0 * n_full * macs, H100_BF16_FLOPS)
        chains[name] = {
            "dims": dims,
            "ms": median_ms(lambda: mlp_fused_fwd(params, x, torch.bfloat16)),
            "plain_ms": median_ms(lambda: mlp_plain(params, x, torch.bfloat16), iters=10),
            "library_ms": median_ms(library),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        print(f"K1 {name} N=2^20 bf16: " + json.dumps(chains[name]))
    total = {k: sum(c[k] for c in chains.values())
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_bytes = sum(c["bound_by"] == "bytes" for c in chains.values()) >= len(chains) / 2
    return {
        "name": "mlp_fused_fwd",
        "route": "cuda",
        "source": "umhs_torch/csrc/mlp_fused_fwd.cu",
        "replaces": "umhs_tpu/ops/pallas/mlp_fused.py:39",
        "max_abs_err": max_err,
        **total,
        "bound_by": "bytes" if by_bytes else "operations",
        "shape": "sum of the four flagship chains, 2^20 rows each, bf16",
        "chains": chains,
    }


def phase_k3(dev):
    from umhs_torch.ops.encodings import (
        HashEncodingConfig, hash_encode_fwd, hash_encode_plain, hash_indices_weights)

    gen = torch.Generator().manual_seed(2)
    n = 1 << 20
    pos = torch.rand((n, 3), generator=gen)
    pos[0], pos[1] = 0.0, 1.0
    pos[2] = torch.tensor([0.0, 0.5, 1.0])
    pos[3] = torch.tensor([1.0, 0.0, 0.25])
    pos = pos.to(dev)
    entries = {}
    max_err = 0.0
    for interp in ("tetrahedral", "trilinear"):
        cfg = HashEncodingConfig(num_levels=16, features_per_level=2, log2_hashmap_size=19,
                                 interpolation=interp)
        table = ((torch.rand((cfg.table_size * 2,), generator=gen) * 2 - 1) * 1e-4).to(dev)
        out = hash_encode_fwd(table, pos, cfg)
        ref = hash_encode_plain(table, pos, cfg)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = err <= 1e-6 and bool(torch.isfinite(out).all())
        print(f"K3 {interp} N=2^20 L16xF2 2^19: max_abs_err {err:.3e} (atol 1e-6) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"K3 {interp} disagrees with its plain version")
        max_err = max(max_err, err)

        idx, w = hash_indices_weights(pos, cfg)
        table2d = table.reshape(-1, 2)

        def library(idx=idx, w=w, table2d=table2d):
            rows = torch.index_select(table2d, 0, idx.reshape(-1)).reshape(*idx.shape, 2)
            return (rows * w[..., None]).sum(2)

        V = cfg.verts_per_cell
        sectors = int(torch.unique(idx.reshape(-1) * 8 // 32).numel())
        nbytes = n * 3 * 4 + n * cfg.output_dim * 4 + sectors * 32
        b_ms, b_by = bound(nbytes, 2.0 * n * cfg.num_levels * V * 2, H100_F32_FLOPS)
        entries[interp] = {
            "ms": median_ms(lambda: hash_encode_fwd(table, pos, cfg)),
            "plain_ms": median_ms(lambda: hash_encode_plain(table, pos, cfg), iters=5),
            "library_ms": median_ms(library, iters=10),
            "bound_ms": b_ms,
            "bound_by": b_by,
            # the stricter count: one 32-byte sector read per vertex row
            "sector_bound_ms": (n * 3 * 4 + n * cfg.output_dim * 4
                                + n * cfg.num_levels * V * 32) / H100_BYTES_PER_S * 1e3,
            "unique_sectors": sectors,
        }
        print(f"K3 {interp}: " + json.dumps(entries[interp]))
        del idx, w
    main = entries["tetrahedral"]
    return {
        "name": "hash_encode_fwd",
        "route": "cuda",
        "source": "umhs_torch/csrc/hash_encode_fwd.cu",
        "replaces": "umhs_tpu/ops/encodings.py:439",
        "max_abs_err": max_err,
        **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "shape": "tetrahedral, L16xF2 2^19, 2^20 positions",
        "trilinear": entries["trilinear"],
        "sector_bound_ms": main["sector_bound_ms"],
    }


K2_ROWS = 131072  # the training step's compact buffer: 0.5 * 4096 rays * 64 samples


def phase_k2(dev):
    from umhs_torch.ops.mlp import init_mlp
    from umhs_torch.ops.mlp_fused import mlp_fused_bwd, mlp_plain_bwd

    gen = torch.Generator().manual_seed(3)
    n = K2_ROWS
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    max_err = 0.0
    max_rel = {"float32": 0.0, "bfloat16": 0.0}  # max |err| / max |ref| per tensor
    chains = {}
    for name, dims in K1_CHAINS.items():
        params = init_mlp(gen, dims[0], len(dims) - 1, dims[1], dims[-1], dev)
        x = torch.randn((n, dims[0]), generator=gen).to(dev)
        g = torch.randn((n, dims[-1]), generator=gen).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            dx, grads = mlp_fused_bwd(params, x, g, dt)
            dx_ref, grads_ref = mlp_plain_bwd(params, x, g, dt)
            torch.cuda.synchronize()
            worst = 0.0
            for got, ref in [(dx, dx_ref)] + [t for pr in zip(grads, grads_ref) for t in zip(*pr)]:
                err = float((got - ref).abs().max())
                ok = torch.allclose(got, ref, rtol=tol[dt], atol=tol[dt] * float(ref.abs().max()))
                check(ok, f"K2 {name} {dt} disagrees with its plain version (max abs err {err})")
                worst = max(worst, err / max(float(ref.abs().max()), 1e-30))
                max_err = max(max_err, err)
            max_rel[str(dt)[6:]] = max(max_rel[str(dt)[6:]], worst)
            print(f"K2 {name} N={n} {str(dt)[6:]}: max error / max|ref| {worst:.3e} "
                  f"(tol {tol[dt]:g}) ok")
        # timing at the main path's dtype and dx: mlp_directional's input
        # (SH + posenc) has no parameters upstream, so it takes no dx
        need_dx = name != "mlp_directional"
        leaves = [t.bfloat16().requires_grad_(True) for lay in params["layers"]
                  for t in (lay["w"], lay["b"])]
        xb = x.bfloat16().requires_grad_(need_dx)
        gb = g.bfloat16()

        def library(leaves=leaves, xb=xb, gb=gb, need_dx=need_dx):
            h = xb
            for i in range(0, len(leaves), 2):
                h = torch.addmm(leaves[i + 1], h, leaves[i])
                if i + 2 < len(leaves):
                    h = torch.relu(h)
            return torch.autograd.grad(h, ([xb] if need_dx else []) + leaves, gb)

        macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        # recompute, dW and dh per layer (no dh below the first without dx)
        flops = 2.0 * n * (3 * macs - (0 if need_dx else dims[0] * dims[1]))
        nparams = sum(lay["w"].numel() + lay["b"].numel() for lay in params["layers"])
        nbytes = n * (dims[0] + dims[-1] + (dims[0] if need_dx else 0)) * 4 + 2 * nparams * 4
        b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
        chains[name] = {
            "dims": dims, "dx": need_dx,
            "ms": median_ms(lambda: mlp_fused_bwd(params, x, g, torch.bfloat16, need_dx)),
            "plain_ms": median_ms(lambda: mlp_plain_bwd(params, x, g, torch.bfloat16, need_dx),
                                  iters=10),
            "library_ms": median_ms(library),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        print(f"K2 {name} N={n} bf16: " + json.dumps(chains[name]))
    total = {k: sum(c[k] for c in chains.values())
             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by_bytes = sum(c["bound_by"] == "bytes" for c in chains.values()) >= len(chains) / 2
    return {
        "name": "mlp_fused_bwd",
        "route": "cuda",
        "source": "umhs_torch/csrc/mlp_fused_bwd.cu",
        "replaces": "umhs_tpu/ops/pallas/mlp_fused.py:52",
        "max_abs_err": max_err,
        "max_rel_err": max_rel,
        **total,
        "bound_by": "bytes" if by_bytes else "operations",
        "shape": "sum of the four flagship chains, 131,072 rows each, bf16, "
                 "dx except for mlp_directional; library = bf16 addmm chain forward + "
                 "torch.autograd.grad",
        "chains": chains,
    }


def phase_k4(dev):
    from umhs_torch.ops.encodings import (
        HashEncodingConfig, hash_encode_bwd, hash_encode_bwd_plain, hash_indices_weights,
        level_uniforms, stochastic_vertex)

    gen = torch.Generator().manual_seed(4)
    n = K2_ROWS
    cfg = HashEncodingConfig(num_levels=16, features_per_level=2, log2_hashmap_size=19,
                             interpolation="tetrahedral")
    L, F = cfg.num_levels, cfg.features_per_level
    pos = torch.rand((n, 3), generator=gen)
    pos[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.5, 1.0], [1.0, 0.0, 0.25]])
    pos = pos.to(dev)
    g = torch.randn((n, L * F), generator=gen).to(dev)

    det = hash_encode_bwd(pos, g, cfg, False)
    ref = hash_encode_bwd_plain(pos, g, cfg, False)
    torch.cuda.synchronize()
    err = float((det - ref).abs().max())
    check(torch.allclose(det, ref, rtol=1e-5, atol=1e-5),
          f"K4 deterministic disagrees with its plain version (max abs err {err})")
    # stochastic: with unit gradients each (sample, level, feature) adds 1 to
    # one row, so |kernel - plain| / 2 counts the differing selections
    ones = torch.ones_like(g)
    sto = hash_encode_bwd(pos, ones, cfg, True)
    sto_ref = hash_encode_bwd_plain(pos, ones, cfg, True)
    torch.cuda.synchronize()
    check(float(sto.sum()) == n * L * F, "K4 stochastic did not add each gradient exactly once")
    differ = float((sto - sto_ref).abs().sum()) / 2 / F / (n * L)
    print(f"K4 deterministic N={n} L16xF2 2^19: max_abs_err {err:.3e} (rtol/atol 1e-5) ok; "
          f"stochastic: share of differing vertex selections {differ:.3e} (limit 1e-4)")
    check(differ <= 1e-4, f"K4 stochastic selections differ from the plain version's: {differ}")
    sto_g = hash_encode_bwd(pos, g, cfg, True)
    check(bool(torch.isfinite(sto_g).all()), "K4 stochastic: non-finite gradient")

    idx, w = hash_indices_weights(pos, cfg)
    feat = torch.arange(F, device=dev)
    flat_det = (idx[..., None] * F + feat).reshape(-1)
    contrib = (w[..., None] * g.reshape(n, L, 1, F)).reshape(-1)
    sel = stochastic_vertex(w, level_uniforms(pos, L))
    flat_sto = (torch.gather(idx, 2, sel[..., None]) * F + feat).reshape(-1)
    g_flat = g.reshape(-1)
    size = cfg.table_size * F

    def library_sto():
        return torch.zeros(size, device=dev).index_add_(0, flat_sto, g_flat)

    def library_det():
        return torch.zeros(size, device=dev).index_add_(0, flat_det, contrib)

    # bytes: positions and g read once, the gradient table zeroed and written
    nbytes = n * 3 * 4 + n * L * F * 4 + size * 4
    flops_det = n * L * cfg.verts_per_cell * F * 2.0
    entries = {}
    for mode, stochastic, lib, flops in (("stochastic", True, library_sto, n * L * F),
                                         ("deterministic", False, library_det, flops_det)):
        b_ms, b_by = bound(nbytes, flops, H100_F32_FLOPS)
        entries[mode] = {
            "ms": median_ms(lambda: hash_encode_bwd(pos, g, cfg, stochastic)),
            "plain_ms": median_ms(lambda: hash_encode_bwd_plain(pos, g, cfg, stochastic), iters=5),
            "library_ms": median_ms(lib, iters=10),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        print(f"K4 {mode}: " + json.dumps(entries[mode]))
    main = entries["stochastic"]
    return {
        "name": "hash_encode_bwd",
        "route": "cuda",
        "source": "umhs_torch/csrc/hash_encode_bwd.cu",
        "replaces": "umhs_tpu/ops/encodings.py:501",
        "max_abs_err": err,
        **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "shape": "tetrahedral, L16xF2 2^19, 131,072 positions, stochastic (the main path's "
                 "mode), the 48.8 MB table zeroed in the call; library = zeros + index_add_ "
                 "on precomputed rows",
        "stochastic_selection_differ_share": differ,
        "deterministic": entries["deterministic"],
    }


RENDER_KERNELS = ("umhs_mlp_fused_fwd", "umhs_hash_encode_fwd")


def flagship_model_config():
    from umhs_torch.models.model import ModelConfig

    # bench.py:279-333 at its defaults (stochastic hash gradient, the
    # default, and warmup thinning 2 as bench.py:320)
    return ModelConfig(
        method="rgb+spectral", pred_specular=True, temperature=0.4,
        grid_resolution=128, grid_levels=4, num_candidates=1024, max_samples_per_ray=64,
        cone_angle=0.004, hash_num_levels=16, hash_features_per_level=2,
        log2_hashmap_size=19, hash_interpolation="tetrahedral",
        stage_boundaries=(8, 16), march_pool=4, occ_warmup_full_every=2,
    )


def phase_render(dev):
    from umhs_torch.data.cameras import generate_camera_rays
    from umhs_torch.data.synthetic import BENCH_SCENE, render_views, scene_cameras
    from umhs_torch.data.vca import vca_endmembers_from_cube
    from umhs_torch.engine.trainer import Trainer, TrainerConfig
    from umhs_torch.ops._native import KERNELS

    scene = BENCH_SCENE
    _, cubes, _ = render_views(scene, 1, 0.0)  # the first train view feeds VCA
    poses_eval, _, _ = render_views(scene, scene.num_views_eval, 0.13)
    endmembers = vca_endmembers_from_cube(cubes[0], 6)
    cam = scene_cameras(scene, poses_eval).to_device_dict(dev)
    size = scene.image_size

    for k in KERNELS.values():
        k.launches = 0
    trainer = Trainer(TrainerConfig(seed=0, mixed_precision=True), flagship_model_config(),
                      scene.wavelengths, num_classes=6, num_images=scene.num_views_train,
                      device=dev).setup(endmembers)
    occ_s = []
    for _ in range(2):  # step 0, then once more for the steady-state time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.update_occupancy()
        torch.cuda.synchronize()
        occ_s.append(time.perf_counter() - t0)
    launches_occ = {k.symbol: k.launches for k in KERNELS.values()}
    renders, times = [], []
    for i in range(scene.num_views_eval):
        rays = generate_camera_rays(cam, i, size, size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renders.append(trainer.render_camera(rays, (size, size), step=1000))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k.symbol: k.launches for k in KERNELS.values()}
    for sym in RENDER_KERNELS:
        check(launches[sym] > 0, f"kernel {sym} was not launched on the render path")
    profile("render", lambda: trainer.render_camera(rays, (size, size), step=1000))

    occ = trainer.state["occ"]
    for i, out in enumerate(renders):
        for key in ("rgb", "spectral", "depth", "accumulation"):
            check(bool(torch.isfinite(out[key]).all()), f"view {i}: non-finite {key}")
        acc = out["accumulation"]
        # sum of weights is 1 - T_final <= 1 exactly; allow f32 rounding
        check(float(acc.min()) >= 0.0 and float(acc.max()) <= 1.0 + 1e-6,
              f"view {i}: accumulation outside [0, 1]")
        check(int(out["num_samples_per_ray"].max()) <= 64, f"view {i}: > 64 samples per ray")
        check(tuple(out["spectral"].shape) == (size, size, 128), f"view {i}: spectral shape")
    mean_samples = float(torch.stack(
        [o["num_samples_per_ray"].float().mean() for o in renders]).mean())
    summary = {
        "occ_update_s": occ_s,  # first and second full update
        "occupied_share": float(occ["binaries"].float().mean()),
        "render_s_per_image": times,
        "render_ms_per_image_last": times[-1] * 1e3,
        "rays_per_s_last": size * size / times[-1],
        "mean_samples_per_ray": mean_samples,
        "launches_occ_update": launches_occ,
        "launches_total": launches,
    }
    print("render: " + json.dumps(summary))
    return trainer, cam, launches


def profile(label: str, fn, top: int = 12) -> None:
    """fn() once more under torch.profiler (not timed elsewhere): device time
    by kernel and by PyTorch op, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [e for e in events if "CUDA" in str(e.device_type)]
    ops = [e for e in events if "CUDA" not in str(e.device_type) and e.key.startswith("aten::")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile {label}: wall {wall_us / 1e3:.1f} ms (traced), device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  kernel {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:100]}")
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:top]:
        print(f"  op     {e.device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key}")


def phase_kernels_vs_plain(trainer, cam, dev):
    from umhs_torch.data.cameras import generate_camera_rays
    from umhs_torch.engine.trainer import Trainer, TrainerConfig
    from umhs_torch.ops._native import KERNELS

    size = 128
    rays = generate_camera_rays(cam, 0, size, size)
    rows = torch.arange(32, 96, device=dev)
    sel = (rows[:, None] * size + rows[None, :]).reshape(-1)  # 64x64 centre crop
    crop = {k: v[sel] for k, v in rays.items()}
    outs = {}
    for impl in ("auto", "plain"):
        cfg = dataclasses.replace(flagship_model_config(), compute_dtype="float32", impl=impl)
        t = Trainer(TrainerConfig(seed=0, mixed_precision=False), cfg,
                    trainer.model.wavelengths, num_classes=6, num_images=16, device=dev)
        t.state = trainer.state
        before = {k.symbol: k.launches for k in KERNELS.values()}
        outs[impl] = t.render_camera(crop, (64, 64), step=1000)
        ran = sorted(k.symbol for k in KERNELS.values() if k.launches > before[k.symbol])
        want = sorted(RENDER_KERNELS) if impl == "auto" else []
        check(ran == want, f"impl={impl} render launched {ran}, expected {want}")
    errs = {k: float((outs["auto"][k] - outs["plain"][k]).abs().max())
            for k in ("rgb", "spectral", "accumulation")}
    print("path kernels vs plain (f32, 64x64 crop): " + json.dumps(errs))
    for k, e in errs.items():
        check(e <= 1e-3, f"path with kernels disagrees with plain path on {k}: {e}")


TRAIN_STEPS = 48


def phase_train(dev):
    from umhs_torch.data.datamanager import InMemoryDataManager
    from umhs_torch.data.synthetic import BENCH_SCENE, render_views, scene_cameras
    from umhs_torch.data.vca import vca_endmembers_from_cube
    from umhs_torch.engine.trainer import Trainer, TrainerConfig
    from umhs_torch.ops._native import KERNELS

    scene = BENCH_SCENE
    t0 = time.perf_counter()
    poses, cubes, rgba = render_views(scene, scene.num_views_train, 0.0)
    endmembers = vca_endmembers_from_cube(cubes[0], 6)
    dm = InMemoryDataManager(rgba, scene_cameras(scene, poses), hs_images=cubes, device=dev)
    trainer = Trainer(TrainerConfig(seed=0, mixed_precision=True, train_num_rays_per_batch=4096),
                      flagship_model_config(), scene.wavelengths, num_classes=6,
                      num_images=scene.num_views_train, device=dev, datamanager=dm)
    trainer.setup(endmembers)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)

    for k in KERNELS.values():
        k.launches = 0
    history = trainer.train(TRAIN_STEPS)
    launches = {k.symbol: k.launches for k in KERNELS.values()}
    for sym, count in launches.items():
        check(count > 0, f"kernel {sym} was not launched on the training path")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    updates = [(r["step"], r["occ_update"]) for r in history if r["occ_update"]]
    check(updates == [(0, "full"), (16, "partial"), (32, "full")],
          f"occupancy updates {updates}, expected full at 0 and 32, partial at 16")
    losses = [r["metrics"]["loss/total"] for r in history]
    check(all(np.isfinite(losses)), "non-finite training loss")
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    check(last < first, f"training loss did not fall: {first} -> {last}")
    plain_steps = [r["step_s"] for r in history if r["occ_update"] is None]
    step_ms = 1e3 * float(np.mean(plain_steps[2:]))  # past the first steps' allocator warm-up
    R = trainer.config.train_num_rays_per_batch

    # launches of one step and of one partial update, counted on their own
    before = {k.symbol: k.launches for k in KERNELS.values()}
    trainer.train_step()
    per_step = {k.symbol: k.launches - before[k.symbol] for k in KERNELS.values()}
    before = {k.symbol: k.launches for k in KERNELS.values()}
    trainer.update_occupancy(full=False)
    per_partial = {k.symbol: k.launches - before[k.symbol] for k in KERNELS.values()}
    profile("step", trainer.train_step)

    last_m = history[-1]["metrics"]
    summary = {
        "setup_s": setup_s,
        "steps": TRAIN_STEPS,
        "loss_first4": first, "loss_last4": last,
        "loss_per_step": losses,
        "psnr_last": last_m["psnr"], "psnr_spectral_last": last_m["psnr_spectral"],
        "ms_per_step_without_occ_update": step_ms,
        "rays_per_s": R / step_ms * 1e3,
        "step_ms_all": [1e3 * r["step_s"] for r in history],
        "occ_update_ms": {f"{r['step']} {r['occ_update']}": 1e3 * r["occ_s"]
                          for r in history if r["occ_update"]},
        "samples_per_batch_last": last_m["num_samples_per_batch"],
        "num_occupied_p99_last": last_m["num_occupied_p99"],
        "peak_memory_gb": peak_gb,
        "launches_total": launches,
        "launches_per_step": per_step,
        "launches_per_partial_update": per_partial,
    }
    print("train: " + json.dumps(summary))
    return trainer, launches, summary


def phase_train_vs_plain(trainer, dev):
    from umhs_torch.engine.trainer import Trainer, TrainerConfig, named_leaves
    from umhs_torch.ops._native import KERNELS

    draws = trainer.draw_step()
    state = trainer.state
    results = {}
    for impl in ("auto", "plain"):
        cfg = dataclasses.replace(flagship_model_config(), compute_dtype="float32",
                                  stochastic_hash_grad=False, impl=impl)
        t = Trainer(TrainerConfig(seed=0, mixed_precision=False), cfg, trainer.model.wavelengths,
                    num_classes=6, num_images=trainer.model.num_images, device=dev,
                    datamanager=trainer.datamanager)
        t.state = state
        before = {k.symbol: k.launches for k in KERNELS.values()}
        total = t.loss_and_grads(draws)[0]
        torch.cuda.synchronize()
        ran = sorted(k.symbol for k in KERNELS.values() if k.launches > before[k.symbol])
        want = sorted(before) if impl == "auto" else []
        check(ran == want, f"impl={impl} training step launched {ran}, expected {want}")
        results[impl] = (float(total.detach()),
                         {n: p.grad.clone() for n, p in named_leaves(state["params"])})
    (la, ga), (lp, gp) = results["auto"], results["plain"]
    loss_rel = abs(la - lp) / abs(lp)
    worst = {}
    for name, g in ga.items():
        ref = gp[name]
        scale = float(ref.abs().max())
        worst[name] = float(((g - ref).abs() / (1e-3 * ref.abs() + 1e-4 * scale + 1e-30)).max())
    print("train step kernels vs plain (f32, deterministic hash gradient): "
          + json.dumps({"loss_auto": la, "loss_plain": lp, "loss_rel_err": loss_rel,
                        "worst_err_over_tolerance": worst}))
    check(np.isfinite(la) and loss_rel <= 1e-5, f"training loss with kernels {la} vs plain {lp}")
    for name, r in worst.items():
        check(r <= 1.0, f"gradient of {name} with kernels disagrees with the plain path ({r})")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    from umhs_torch.ops import _native

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = _native.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'cached'}")
    for src, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    k1 = phase_k1(dev)
    k3 = phase_k3(dev)
    k2 = phase_k2(dev)
    k4 = phase_k4(dev)
    trainer, cam, render_launches = phase_render(dev)
    phase_kernels_vs_plain(trainer, cam, dev)
    del trainer
    trainer, launches, _ = phase_train(dev)
    phase_train_vs_plain(trainer, dev)

    for entry in (k1, k2, k3, k4):
        sym = "umhs_" + entry["name"]
        entry["launches"] = launches[sym]  # the training path's run
        entry["launches_render"] = render_launches[sym]
    print(smi)
    print(json.dumps({"kernels": [k1, k2, k3, k4]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
