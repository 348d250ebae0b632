#!/usr/bin/env python3
"""GPU smoke run of umhs_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --repeat-schedule
    python3 chip_smoke.py --sweep-vs-plain 100

The second form runs only phase 7's schedule, twice in each of three
settings (the kernels; the kernels with torch's deterministic algorithms;
the plain versions with them), and prints, for each setting, whether the
two runs' losses agree bit for bit and where they first part, their adapt
decisions and their steady ms per step. The third runs only phase 7's
schedule with phase 6's check after every slice from step 144 on and after
each of 100 single steps past it, and prints the largest readings.

Phases (any failure exits non-zero; nothing is caught and passed over):
1. Device and build: the card's name and power limit, then every kernel in
   umhs_torch/csrc is compiled by nvcc into umhs_torch/_build/ (timed), with
   ptxas's registers and spill bytes per kernel; any spill fails the run.
2. Each kernel against its plain PyTorch version on the card, at the
   flagship shapes, with its median time, the plain version's, one PyTorch
   yardstick's and the bound from bytes or operations:
   - K1 mlp_fused_fwd: the four field MLP chains, f32 (rtol/atol 1e-5, the
     FMA kernel) and bf16 (2e-2, the tensor-core kernel), at N = 2^20 and at
     an N that is not a multiple of the tile, plus a single-layer chain;
   - K3 hash_encode_fwd: tetrahedral and trilinear at L16xF2 2^19 on 2^20
     positions including exact 0 and 1 (atol 1e-6; table values ~1e-4);
   - K2 mlp_fused_bwd: the four chains at the training buffer's N = 262,144
     rows, f32 (rtol 1e-4, atol 1e-4 * max) and bf16 (2e-2), dx, dW and db
     against autograd of mlp_plain;
   - K4 hash_encode_bwd: tetrahedral L16xF2 2^19 at 262,144 random
     positions and at 4,096 rays x 64 evenly spaced samples in ray-major
     order (the compact buffer's layout, where neighbours share rows),
     deterministic (rtol/atol 1e-5: float atomics add in a run-dependent
     order) and stochastic (the share of (sample, level) pairs whose vertex
     differs from the plain version's, at most 1e-4; with unit gradients
     the table sums to exactly N x L x F); each timed beside zeros +
     index_add_ on the same precomputed rows. With every position equal
     (each warp's lanes on one row per level) the stochastic table holds
     exactly N at each level's chosen row.
   - P1 row_gather: the probe twin's check (umhs_torch.probes.gather), bit
     for bit against table[idx] on the probe's 12,000,000 x 2 f32 table and
     the flagship's 6,098,108 x 2 table at 16,318,464 rows, and at N = 2049
     and 1 (rows 0 and T-1 among the indices); then its own path, the probe
     twin, measures it beside torch.index_select with the launch counts
     zeroed before and read after.
3. The serving path at full width: the bench scene (16 + 2 views, 128^2,
   128 bands, 6 spheres) as an in-memory train split (rendered once, also
   for phase 5) with VCA endmembers, Trainer.setup() from seed 0
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
   draws. The kernel step, run twice, repeats bit for bit outside the hash
   table's gradient. On each of three draws: the loss within rtol 1e-5 and
   every gradient within rtol 1e-3 in norm, each plus 4x the plain path's
   own change when it runs from the parameters moved one ulp; each passes
   on the median of the draws (why: phase_train_vs_plain). The kernel run
   launches K1-K4, the plain runs none.
7. bench.py's training schedule from a dataset on disk, at full width, in a
   temporary working directory: the bench scene written by write_dataset,
   Trainer(TrainerConfig, ModelConfig, DataManagerConfig) with bench.py's
   settings (dynamic batching with adapts decided at 64, 176, 304 and 448
   and applied 80 steps later, load_vca, lr 2e-2 over 10,000 steps, bf16,
   stages (8, 16), warmup thinning 2, 4096 rays, 1024 eval rays, seed 42),
   driven in slices of 16 steps to step 576 and one slice of 96 steady
   steps, with the launch counts zeroed before and read after (the
   `launches` of K1-K4). At step 576 a checkpoint is saved and loaded into a
   fresh Trainer: every state tensor, the generator and the shapes equal bit
   for bit, the next draws equal, the next loss within rtol 1e-6. Checked:
   decisions only at the scheduled steps (the one at 64 not a no-op), each
   applied 80 steps later, one budget per stage, each a multiple of 256 and
   within max(4096, R' x its lane gap), finite losses, eval_batch PSNR up by
   5 dB or more; eval_all_images on both eval views. Phase 6 runs again at
   the end of the first slice at adapted (three-stage) shapes and at the
   end of the steady window, at its last adapted shapes. The launches of
   those two steps and of the round trip are left out of the schedule's
   counts. One steady step runs under torch.profiler at the end, with the
   device ms of K1-K4 in it beside their launches.

The last lines are the card (nvidia-smi), one JSON object of kernel numbers
and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
    """Median time of fn() over `iters` calls, by CUDA events around each
    call: the device's time, or the host's where its enqueue takes longer."""
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


def device_ms(fn, iters: int = 10) -> float:
    """Device time per call of fn(): the summed durations of every kernel and
    memset it launched, under torch.profiler over `iters` calls (gaps left
    by the host's enqueue are not counted)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if "CUDA" in str(e.device_type))
    return busy_us / iters / 1e3


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
            "ms": device_ms(lambda: mlp_fused_fwd(params, x, torch.bfloat16)),
            "call_ms": median_ms(lambda: mlp_fused_fwd(params, x, torch.bfloat16)),
            "plain_ms": device_ms(lambda: mlp_plain(params, x, torch.bfloat16), iters=5),
            "library_ms": device_ms(library),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        print(f"K1 {name} N=2^20 bf16: " + json.dumps(chains[name]))
    total = {k: sum(c[k] for c in chains.values())
             for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")}
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
            "ms": device_ms(lambda: hash_encode_fwd(table, pos, cfg)),
            "call_ms": median_ms(lambda: hash_encode_fwd(table, pos, cfg)),
            "plain_ms": device_ms(lambda: hash_encode_plain(table, pos, cfg), iters=5),
            "library_ms": device_ms(library),
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
        **{k: main[k] for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
        "shape": "tetrahedral, L16xF2 2^19, 2^20 positions",
        "trilinear": entries["trilinear"],
        "sector_bound_ms": main["sector_bound_ms"],
    }


# the training step's compact buffer before the first adapt: 4096 rays x 64
# samples (after the adapts the stage-1 budget runs 150k-190k rows, the
# tails 80k-320k)
K2_ROWS = 4096 * 64


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
            "ms": device_ms(lambda: mlp_fused_bwd(params, x, g, torch.bfloat16, need_dx)),
            "call_ms": median_ms(lambda: mlp_fused_bwd(params, x, g, torch.bfloat16, need_dx)),
            "plain_ms": device_ms(lambda: mlp_plain_bwd(params, x, g, torch.bfloat16, need_dx),
                                  iters=5),
            "library_ms": device_ms(library),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        print(f"K2 {name} N={n} bf16: " + json.dumps(chains[name]))
    total = {k: sum(c[k] for c in chains.values())
             for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")}
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
        "shape": "sum of the four flagship chains, 262,144 rows each, bf16, "
                 "dx except for mlp_directional; library = bf16 addmm chain forward + "
                 "torch.autograd.grad",
        "chains": chains,
    }


def k4_case(label, pos, g, cfg, dev):
    """K4 against its plain version on one position set, then timed in both
    modes beside zeros + index_add_ on the same precomputed rows."""
    from umhs_torch.ops.encodings import (
        hash_encode_bwd, hash_encode_bwd_plain, hash_indices_weights, level_uniforms,
        stochastic_vertex)

    n, L, F = pos.shape[0], cfg.num_levels, cfg.features_per_level
    det = hash_encode_bwd(pos, g, cfg, False)
    ref = hash_encode_bwd_plain(pos, g, cfg, False)
    torch.cuda.synchronize()
    err = float((det - ref).abs().max())
    check(torch.allclose(det, ref, rtol=1e-5, atol=1e-5),
          f"K4 {label} deterministic disagrees with its plain version (max abs err {err})")
    # stochastic: with unit gradients each (sample, level, feature) adds 1 to
    # one row, so |kernel - plain| / 2 counts the differing selections
    ones = torch.ones_like(g)
    sto = hash_encode_bwd(pos, ones, cfg, True)
    sto_ref = hash_encode_bwd_plain(pos, ones, cfg, True)
    torch.cuda.synchronize()
    check(float(sto.sum()) == n * L * F,
          f"K4 {label} stochastic did not add each gradient exactly once")
    differ = float((sto - sto_ref).abs().sum()) / 2 / F / (n * L)
    print(f"K4 {label} deterministic N={n} L{L}xF{F}: max_abs_err {err:.3e} (rtol/atol 1e-5) "
          f"ok; stochastic: share of differing vertex selections {differ:.3e} (limit 1e-4)")
    check(differ <= 1e-4, f"K4 {label} stochastic selections differ from the plain version's: "
                          f"{differ}")
    sto_g = hash_encode_bwd(pos, g, cfg, True)
    check(bool(torch.isfinite(sto_g).all()), f"K4 {label} stochastic: non-finite gradient")
    del det, ref, sto, sto_ref, sto_g

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
    entries = {"max_abs_err": err, "stochastic_selection_differ_share": differ}
    for mode, stochastic, lib, flops in (("stochastic", True, library_sto, n * L * F),
                                         ("deterministic", False, library_det, flops_det)):
        b_ms, b_by = bound(nbytes, flops, H100_F32_FLOPS)
        entries[mode] = {
            "ms": device_ms(lambda: hash_encode_bwd(pos, g, cfg, stochastic)),
            "call_ms": median_ms(lambda: hash_encode_bwd(pos, g, cfg, stochastic)),
            "plain_ms": device_ms(lambda: hash_encode_bwd_plain(pos, g, cfg, stochastic), iters=5),
            "library_ms": device_ms(lib),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        print(f"K4 {label} {mode}: " + json.dumps(entries[mode]))
    return entries


def phase_k4(dev):
    from umhs_torch.data.synthetic import ray_samples
    from umhs_torch.ops.encodings import (
        HashEncodingConfig, hash_encode_bwd, hash_encode_bwd_plain)

    gen = torch.Generator().manual_seed(4)
    n = K2_ROWS
    cfg = HashEncodingConfig(num_levels=16, features_per_level=2, log2_hashmap_size=19,
                             interpolation="tetrahedral")
    L, F = cfg.num_levels, cfg.features_per_level
    pos = torch.rand((n, 3), generator=gen)
    pos[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.5, 1.0], [1.0, 0.0, 0.25]])
    g = torch.randn((n, L * F), generator=gen).to(dev)
    cases = {"random": pos.to(dev), "rays": torch.from_numpy(ray_samples(4096, 64, seed=4)).to(dev)}
    entries = {label: k4_case(label, p, g, cfg, dev) for label, p in cases.items()}

    # every lane of every warp on one row per level: with unit gradients the
    # stochastic table holds exactly n at each level's chosen row, per feature
    same = torch.tensor([[0.3141, 0.5926, 0.5358]], device=dev).expand(n, 3).contiguous()
    ones = torch.ones_like(g)
    sto = hash_encode_bwd(same, ones, cfg, True).reshape(-1, F)
    ref = hash_encode_bwd_plain(same, ones, cfg, True).reshape(-1, F)
    hit = sto[:, 0] != 0
    exact = int(hit.sum()) == L and bool((sto[hit] == n).all()) and torch.equal(sto, ref)
    print(f"K4 all positions equal N={n}: {int(hit.sum())} rows hit, each holding "
          f"{sorted(set(sto[hit].reshape(-1).tolist()))} {'ok' if exact else 'MISMATCH'}")
    check(exact, "K4 with every position equal: the stochastic table does not hold exactly n "
                 "at each level's chosen row")
    del same, ones, sto, ref

    main, rays = entries["random"]["stochastic"], entries["rays"]["stochastic"]
    return {
        "name": "hash_encode_bwd",
        "route": "cuda",
        "source": "umhs_torch/csrc/hash_encode_bwd.cu",
        "replaces": "umhs_tpu/ops/encodings.py:501",
        "max_abs_err": max(e["max_abs_err"] for e in entries.values()),
        **{k: main[k] for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
        "shape": "tetrahedral, L16xF2 2^19, 262,144 random positions, stochastic (the main "
                 "path's mode), the 48.8 MB table zeroed in the call; library = zeros + "
                 "index_add_ on precomputed rows; rays_* = 4,096 rays x 64 samples, ray-major",
        "rays_ms": rays["ms"],
        "rays_call_ms": rays["call_ms"],
        "rays_library_ms": rays["library_ms"],
        "rays_plain_ms": rays["plain_ms"],
        "stochastic_selection_differ_share": max(
            e["stochastic_selection_differ_share"] for e in entries.values()),
        "deterministic": entries["random"]["deterministic"],
        "rays_deterministic": entries["rays"]["deterministic"],
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


def bench_scene_in_memory(dev):
    """The bench scene's 16 train views as an in-memory train split (4096
    rays per step), the first view's VCA endmembers, and the cameras of its
    two eval views on the device."""
    from umhs_torch.data.datamanager import DataManagerConfig, InMemoryDataManager
    from umhs_torch.data.synthetic import BENCH_SCENE, render_views, scene_cameras
    from umhs_torch.data.vca import vca_endmembers_from_cube

    scene = BENCH_SCENE
    t0 = time.perf_counter()
    poses, cubes, rgba = render_views(scene, scene.num_views_train, 0.0)
    endmembers = vca_endmembers_from_cube(cubes[0], 6)
    dm = InMemoryDataManager(rgba, scene_cameras(scene, poses), hs_images=cubes,
                             config=DataManagerConfig(train_num_rays_per_batch=4096),
                             wavelengths=scene.wavelengths, device=dev)
    poses_eval, _, _ = render_views(scene, scene.num_views_eval, 0.13)
    cam = scene_cameras(scene, poses_eval).to_device_dict(dev)
    print(f"bench scene rendered and staged in {time.perf_counter() - t0:.1f} s")
    return dm, endmembers, cam


def phase_render(dev, dm, endmembers, cam):
    from umhs_torch.data.cameras import generate_camera_rays
    from umhs_torch.data.synthetic import BENCH_SCENE
    from umhs_torch.engine.trainer import Trainer, TrainerConfig

    scene = BENCH_SCENE
    size = scene.image_size

    zero_launch_counts()
    trainer = Trainer(TrainerConfig(seed=0, mixed_precision=True), flagship_model_config(),
                      num_classes=6, device=dev, datamanager=dm).setup(endmembers)
    occ_s = []
    for _ in range(2):  # step 0, then once more for the steady-state time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.update_occupancy()
        torch.cuda.synchronize()
        occ_s.append(time.perf_counter() - t0)
    launches_occ = launch_counts()
    renders, times = [], []
    for i in range(scene.num_views_eval):
        rays = generate_camera_rays(cam, i, size, size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renders.append(trainer.render_camera(rays, (size, size), step=1000))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = launch_counts()
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
    return trainer, launches


# device kernels of each wrapper, by name (K2 launches a second, reducing kernel)
KERNEL_NAMES = {
    "umhs_mlp_fused_fwd": ("mlp_fused_fwd_kernel", "mlp_fused_fwd_tc_kernel"),
    "umhs_mlp_fused_bwd": ("mlp_fused_bwd_kernel", "reduce_partials_kernel"),
    "umhs_hash_encode_fwd": ("hash_encode_fwd_kernel",),
    "umhs_hash_encode_bwd": ("hash_encode_bwd_kernel",),
}


def profile(label: str, fn, top: int = 12) -> dict:
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
    n_launches = sum(e.count for e in kernels)
    print(f"profile {label}: wall {wall_us / 1e3:.1f} ms (traced), device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), "
          f"{n_launches} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  kernel {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:100]}")
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:top]:
        print(f"  op     {e.device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key}")
    ours = {name: {"ms": sum(e.self_device_time_total for e in kernels
                             if any(p in e.key for p in patterns)) / 1e3,
                   "device_kernels": sum(e.count for e in kernels
                                         if any(p in e.key for p in patterns))}
            for name, patterns in KERNEL_NAMES.items()}
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us, "device_launches": n_launches,
            "kernels": ours}


def phase_kernels_vs_plain(trainer, cam, dev):
    from umhs_torch.data.cameras import generate_camera_rays
    from umhs_torch.engine.trainer import Trainer, TrainerConfig

    size = 128
    rays = generate_camera_rays(cam, 0, size, size)
    rows = torch.arange(32, 96, device=dev)
    sel = (rows[:, None] * size + rows[None, :]).reshape(-1)  # 64x64 centre crop
    crop = {k: v[sel] for k, v in rays.items()}
    outs = {}
    for impl in ("auto", "plain"):
        cfg = dataclasses.replace(flagship_model_config(), compute_dtype="float32", impl=impl)
        t = Trainer(TrainerConfig(seed=0, mixed_precision=False), cfg, num_classes=6,
                    device=dev, datamanager=trainer.datamanager)
        t.state = trainer.state
        before = launch_counts()
        outs[impl] = t.render_camera(crop, (64, 64), step=1000)
        ran = sorted(k for k, v in launch_counts().items() if v > before[k])
        want = sorted(RENDER_KERNELS) if impl == "auto" else []
        check(ran == want, f"impl={impl} render launched {ran}, expected {want}")
    errs = {k: float((outs["auto"][k] - outs["plain"][k]).abs().max())
            for k in ("rgb", "spectral", "accumulation")}
    print("path kernels vs plain (f32, 64x64 crop): " + json.dumps(errs))
    for k, e in errs.items():
        check(e <= 1e-3, f"path with kernels disagrees with plain path on {k}: {e}")


TRAIN_STEPS = 48
# the kernels of the training path (P1, the row gather, is on no path of it)
TRAIN_KERNELS = ("umhs_hash_encode_bwd", "umhs_hash_encode_fwd", "umhs_mlp_fused_bwd",
                 "umhs_mlp_fused_fwd")


def launch_counts():
    from umhs_torch.ops._native import KERNELS

    return {k.symbol: k.launches for k in KERNELS.values()}


def zero_launch_counts():
    from umhs_torch.ops._native import KERNELS

    for k in KERNELS.values():
        k.launches = 0


@contextlib.contextmanager
def uncounted():
    """Launches inside the block are left out of the counts: a check run
    beside the main path is not part of it."""
    from umhs_torch.ops._native import KERNELS

    saved = launch_counts()
    try:
        yield
    finally:
        for k in KERNELS.values():
            k.launches = saved[k.symbol]


def phase_train(dev, dm, endmembers):
    from umhs_torch.engine.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    trainer = Trainer(TrainerConfig(seed=0, mixed_precision=True, save_final=False),
                      flagship_model_config(), num_classes=6, device=dev, datamanager=dm)
    trainer.setup(endmembers)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)

    zero_launch_counts()
    trainer.train(TRAIN_STEPS)
    launches = launch_counts()
    for sym in TRAIN_KERNELS:
        check(launches[sym] > 0, f"kernel {sym} was not launched on the training path")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    history = trainer.history
    check(trainer.step == TRAIN_STEPS, f"train({TRAIN_STEPS}) stopped at {trainer.step}")
    updates = [(r["step"], r["occ_update"]) for r in history if r["occ_update"]]
    check(updates == [(0, "full"), (16, "partial"), (32, "full")],
          f"occupancy updates {updates}, expected full at 0 and 32, partial at 16")
    losses = [r["metrics"]["loss/total"] for r in history]
    check(all(np.isfinite(losses)), "non-finite training loss")
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    check(last < first, f"training loss did not fall: {first} -> {last}")
    plain_steps = [r["step_s"] for r in history if r["occ_update"] is None]
    step_ms = 1e3 * float(np.mean(plain_steps[2:]))  # past the first steps' allocator warm-up
    R = trainer.dyn.rays

    # launches of one step and of one partial update, counted on their own
    before = launch_counts()
    trainer.train_step()
    per_step = {k: v - before[k] for k, v in launch_counts().items()}
    before = launch_counts()
    trainer.update_occupancy(full=False)
    per_partial = {k: v - before[k] for k, v in launch_counts().items()}
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


def moved_one_ulp(params, seed: int, dev):
    """A copy of the parameter tree with every element moved one ulp up or
    down (a fair coin per element, from `seed`), as leaves that take grads."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(move(v) for v in tree)
        up = torch.rand(tree.shape, generator=gen, device=dev) < 0.5
        toward = torch.where(up, float("inf"), float("-inf")).to(tree.dtype)
        return torch.nextafter(tree.detach(), toward).requires_grad_(True)

    return move(params)


# the kernel-vs-plain training step (phase 6): see phase_train_vs_plain
VS_PLAIN_DRAWS = 3
VS_PLAIN_RTOL = 1e-3  # gradients, in norm
VS_PLAIN_LOSS_RTOL = 1e-5
SPREAD_FACTOR = 4.0


def step_grads(trainer, dev, draws, impl, moved_seed=None):
    """Loss, gradients and stage count of one training step from `trainer`'s
    state at its current shapes, in f32 with the deterministic hash
    gradient, from the parameters moved one ulp if `moved_seed` is given.
    The kernel run must launch K1-K4 and the plain run none."""
    from umhs_torch.engine.trainer import Trainer, TrainerConfig, named_leaves

    cfg = dataclasses.replace(trainer.model.config, compute_dtype="float32",
                              stochastic_hash_grad=False, impl=impl)
    t = Trainer(TrainerConfig(seed=0, mixed_precision=False), cfg, num_classes=6,
                device=dev, datamanager=trainer.datamanager)
    state = trainer.state
    if moved_seed is not None:
        state = dict(state, params=moved_one_ulp(state["params"], moved_seed, dev))
    t.state, t.dyn = state, trainer.dyn
    before = launch_counts()
    total, _, outputs, _ = t.loss_and_grads(draws)
    torch.cuda.synchronize()
    ran = sorted(k for k, v in launch_counts().items() if v > before[k])
    want = sorted(TRAIN_KERNELS) if impl == "auto" else []
    check(ran == want, f"{impl} training step launched {ran}, expected {want}")
    grads = {n: p.grad.clone() for n, p in named_leaves(state["params"])}
    for _, p in named_leaves(state["params"]):
        p.grad = None
    return (float(total.detach()), grads,
            sum(1 for k in outputs if k.startswith("num_eval_s")))


def phase_train_vs_plain(trainer, dev, label):
    """One training step from `trainer`'s state at its current shapes
    (rays, samples per ray, stage budgets), with the kernels and with the
    plain versions, f32 and the deterministic hash gradient, same draws.

    Two checks. (1) The kernel run, repeated, gives the same loss and the
    same bits in every gradient but the hash table's (K4's float atomics add
    in any order): no kernel races. (2) On each of VS_PLAIN_DRAWS draws of
    the step, the plain step also runs from the parameters moved one ulp,
    and each gradient with the kernels must lie within VS_PLAIN_RTOL of the
    plain one in norm, plus SPREAD_FACTOR times the norm of the moved plain
    run's change (the loss: within VS_PLAIN_LOSS_RTOL plus SPREAD_FACTOR
    times its change); a tensor passes if its median over the draws does.

    Why in norm and over draws: near convergence the gradients are sums of
    ~10^5 terms that nearly cancel, and now and then f32 rounding puts a
    ReLU on the other side for a sample with a large gradient. The plain
    path against itself, moved one ulp, crosses an elementwise rtol 1e-3
    (atol 1e-4 x max) on many draws (the endmembers), and such an event
    moves feature_mlp's gradient and every one upstream of it at once, on
    either side (PERF.md, section 6). An event falls on one draw; a fault
    of the kernels or of their wiring shows on every draw. The elementwise
    readings of the kernels and of the moved plain run are printed beside.
    Returns the readings."""
    gen_state = trainer._step_gen.get_state()
    draws = [trainer.draw_step() for _ in range(VS_PLAIN_DRAWS)]
    trainer._step_gen.set_state(gen_state)  # the trainer's own stream goes on unchanged
    loss_r, grad_r, elem_k, elem_m = [], [], [], []
    for i, d in enumerate(draws):
        la, ga, stages = step_grads(trainer, dev, d, "auto")
        if i == 0:
            la2, ga2, _ = step_grads(trainer, dev, d, "auto")
            same = la2 == la and all(torch.equal(ga2[n], g) for n, g in ga.items()
                                     if n != "hash_table")
            check(same, f"{label}: the kernel step, repeated, gave other bits outside the "
                        "hash table's gradient")
            del ga2
        lp, gp, _ = step_grads(trainer, dev, d, "plain")
        lm, gm, _ = step_grads(trainer, dev, d, "plain", moved_seed=i + 1)
        check(np.isfinite(la), f"{label}: non-finite loss with kernels")
        loss_r.append(abs(la - lp) / (VS_PLAIN_LOSS_RTOL * abs(lp) + SPREAD_FACTOR * abs(lm - lp)))
        ratio, ek, em = {}, {}, {}
        for name, g in ga.items():
            ref, moved = gp[name], gm[name]
            ratio[name] = float((g - ref).norm()) / (
                VS_PLAIN_RTOL * float(ref.norm()) + SPREAD_FACTOR * float((moved - ref).norm())
                + 1e-30)
            fixed = 1e-3 * ref.abs() + 1e-4 * float(ref.abs().max()) + 1e-30
            ek[name] = float(((g - ref).abs() / fixed).max())
            em[name] = float(((moved - ref).abs() / fixed).max())
        grad_r.append(ratio)
        elem_k.append(ek)
        elem_m.append(em)
        del ga, gp, gm

    def worst(d):
        name = max(d, key=d.get)
        return [d[name], name]

    loss_med = float(np.median(loss_r))
    grad_med = {n: float(np.median([r[n] for r in grad_r])) for n in grad_r[0]}
    out = {
        "shapes": {"rays": trainer.dyn.rays, "samples_per_ray": trainer.dyn.march.num_samples,
                   "budgets": list(trainer.dyn.budgets), "stages_reported": stages},
        "loss_over_tolerance": loss_r,
        "worst_over_tolerance_per_draw": [worst(r) for r in grad_r],
        "worst_median_over_tolerance": worst(grad_med),
        "elementwise_kernels_per_draw": [worst(r) for r in elem_k],
        "elementwise_plain_moved_per_draw": [worst(r) for r in elem_m],
    }
    print(f"train step kernels vs plain, {label} (f32, deterministic hash gradient, "
          f"{VS_PLAIN_DRAWS} draws): " + json.dumps(out))
    check(loss_med <= 1.0, f"{label}: training loss with kernels disagrees with the plain path "
                           f"({loss_med} of its tolerance, median of the draws)")
    for name, r in grad_med.items():
        check(r <= 1.0, f"{label}: gradient of {name} with kernels disagrees with the plain "
                        f"path ({r} of its tolerance, median of the draws)")
    return out


def phase_p1(dev):
    """P1, the row gather: the probe twin's check, bit for bit against
    table[idx] at the probe's shape, on the flagship table and at N = 2049
    and 1; then the probe twin's measurement (its entry point, the kernel's
    only path) with the launch counts zeroed before and read after; then
    the plain version's time."""
    from umhs_torch.ops.row_gather import ROW_GATHER, row_gather_plain
    from umhs_torch.probes import gather as probe

    T, FT, N = probe.PROBE_TABLE_ROWS, probe.FLAGSHIP_TABLE_ROWS, probe.PROBE_ROWS
    for line in probe.check(dev):  # raises on a mismatch
        print(f"P1 {line}")

    zero_launch_counts()
    results = {label: probe.measure(rows, N, dev)
               for label, rows in (("probe_table", T), ("flagship_table", FT))}
    launches = ROW_GATHER.launches
    check(launches > 0, "the probe twin did not launch P1")
    table, idx = probe.make_case(T, N, dev)
    plain_ms = median_ms(lambda: row_gather_plain(table, idx))
    for label, r in results.items():
        print(f"P1 {label}: " + json.dumps(r))
    main = results["probe_table"]
    return {
        "name": "row_gather",
        "route": "cuda",
        "source": "umhs_torch/csrc/row_gather.cu",
        "replaces": "scripts/probe_pallas_gather.py:39",
        "max_abs_err": 0.0,
        "ms": main["kernel_ms"],
        "plain_ms": plain_ms,
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],
        "launches": launches,
        "launches_train": 0,
        "launches_render": 0,
        "ns_per_row": main["kernel_ns_per_row"],
        "sector_bound_ms": main["sector_bound_ms"],
        "shape": f"table {T:,} x 2 f32 (96 MB), {N:,} int32 indices; launches = the probe "
                 "twin's run (its path); library = torch.index_select",
        "flagship_table": results["flagship_table"],
    }


BENCH_ADAPT_STEPS = (64, 176, 304, 448)  # bench.py:241-247
BENCH_PREFETCH = 80  # bench.py:258
BENCH_WARMUP_UNTIL = (max(BENCH_ADAPT_STEPS) + BENCH_PREFETCH + 32 + 31) // 32 * 32  # 576
BENCH_STEADY_STEPS = 96


def bench_trainer(root, dev, load_dir=None, **model_overrides):
    """bench.py:203-340's Trainer on the dataset at `root`, with the model's
    fields in `model_overrides` replaced."""
    from umhs_torch.data.datamanager import DataManagerConfig
    from umhs_torch.data.dataparser import DataParserConfig
    from umhs_torch.engine.trainer import OptimizerConfig, Trainer, TrainerConfig

    cfg = TrainerConfig(
        max_num_iterations=1504, steps_per_save=10**9, steps_per_eval_batch=10**9,
        steps_per_eval_image=10**9, steps_per_log=10**9, output_dir=Path("outputs"),
        experiment_name="bench", mixed_precision=True, dynamic_batching=True,
        adapt_steps=BENCH_ADAPT_STEPS, adapt_every=0, adapt_prefetch_steps=BENCH_PREFETCH,
        save_final=False, optimizer=OptimizerConfig(lr=2e-2, max_steps=10000),
        load_dir=load_dir, load_step=BENCH_WARMUP_UNTIL if load_dir else None)
    dm = DataManagerConfig(dataparser=DataParserConfig(data=root, num_classes=6),
                           train_num_rays_per_batch=4096, eval_num_rays_per_batch=1024)
    model = dataclasses.replace(flagship_model_config(), load_vca=True, **model_overrides)
    return Trainer(cfg, model, dm, num_classes=6, device=dev).setup()


@contextlib.contextmanager
def bench_dataset():
    """The bench scene written by write_dataset, in a temporary working
    directory (parsing writes vca.npy into the working directory), removed
    afterwards; yields (that directory, the dataset's root, seconds to
    write it)."""
    from umhs_torch.data.synthetic import BENCH_SCENE, write_dataset

    work = Path(tempfile.mkdtemp(prefix="umhs_smoke_"))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        root = write_dataset(work / "scene", BENCH_SCENE)
        yield work, root, time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def drive_schedule(trainer, after_slice=None):
    """bench.py's slices: 16 steps at a time to step 576, then one slice of
    96 steady steps; `after_slice(trainer)` runs after each. Returns the
    slices' records and every step's loss."""
    slices, losses = [], []
    while trainer.step < BENCH_WARMUP_UNTIL + BENCH_STEADY_STEPS:
        steady = trainer.step >= BENCH_WARMUP_UNTIL
        n = BENCH_STEADY_STEPS if steady else 16
        t_slice = time.perf_counter()
        m = trainer.train(num_iterations=trainer.step + n)
        dt = time.perf_counter() - t_slice
        losses += [r["metrics"]["loss/total"] for r in trainer.history]
        slices.append({"end": trainer.step, "steps": n, "s": dt, "rays": m["rays_per_batch"],
                       "rays_per_s": m["rays_per_batch"] * n / dt, "ms_per_step": 1e3 * dt / n,
                       "steady": steady})
        print(f"  slice to step {trainer.step}: {n} steps in {dt:.2f} s, "
              f"{m['rays_per_batch']} rays/step, {1e3 * dt / n:.1f} ms/step, "
              f"{m['rays_per_batch'] * n / dt:,.0f} rays/s")
        if after_slice is not None:
            after_slice(trainer)
    return slices, losses


def steady_rates(slices):
    steady = [s for s in slices if s["steady"]]
    seconds, steps = sum(s["s"] for s in steady), sum(s["steps"] for s in steady)
    return {"steady_rays_per_s": sum(s["rays"] * s["steps"] for s in steady) / seconds,
            "steady_ms_per_step": 1e3 * seconds / steps}


def adapt_records(trainer):
    return [{k: (v.num_samples if k == "march" else v) for k, v in d.items()}
            for d in trainer.adapt_log]


def phase_bench_schedule(dev):
    """bench.py's training schedule from a dataset on disk, at full width."""
    with bench_dataset() as (work, root, write_s):
        t0 = time.perf_counter()
        trainer = bench_trainer(root, dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        print(f"bench schedule: dataset written in {write_s:.1f} s, parsed, staged and set up "
              f"in {setup_s:.1f} s")
        psnr0 = trainer.eval_batch()["psnr"]
        torch.cuda.reset_peak_memory_stats(dev)
        side = {}

        def after_slice(t):
            with uncounted():  # checks beside the schedule, not part of it
                if "staged" not in side and len(t.dyn.budgets) > 1:
                    phase_train_vs_plain(t, dev, f"bench schedule's first adapted shapes, "
                                                 f"step {t.step}")
                    side["staged"] = t.step
                if t.step == BENCH_WARMUP_UNTIL:
                    side["round_trip"] = checkpoint_round_trip(t, dev, work)

        zero_launch_counts()
        slices, losses = drive_schedule(trainer, after_slice)
        launches = launch_counts()
        check("staged" in side, "the bench schedule never ran at three-stage shapes")
        for sym in TRAIN_KERNELS:
            check(launches[sym] > 0, f"kernel {sym} was not launched on the bench schedule")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        check(all(np.isfinite(losses)), "non-finite loss on the bench schedule")
        check_adapts(trainer)
        with uncounted():
            phase_train_vs_plain(trainer, dev, f"bench schedule's last adapted shapes, "
                                               f"step {trainer.step}")

        psnr1 = trainer.eval_batch()["psnr"]
        print(f"  eval_batch PSNR {psnr0:.2f} dB at step 0 -> {psnr1:.2f} dB at step "
              f"{trainer.step}")
        check(psnr1 >= psnr0 + 5.0, f"eval_batch PSNR rose from {psnr0} only to {psnr1}")
        t_eval = time.perf_counter()
        eval_all = trainer.eval_all_images()
        eval_all_s = time.perf_counter() - t_eval
        print(f"  eval_all_images ({len(trainer.datamanager.eval_dataset)} views, "
              f"{eval_all_s:.2f} s): " + json.dumps(eval_all))
        check(all(np.isfinite(v) for v in eval_all.values()), "eval_all_images: non-finite metric")

        before = launch_counts()
        prof = profile("bench steady step", trainer.train_step)
        per_step = {k: v - before[k] for k, v in launch_counts().items()}
        for sym in TRAIN_KERNELS:
            k = prof["kernels"][sym]
            print(f"  {sym} in the traced steady step: {k['ms']:.3f} ms of device time, "
                  f"{per_step[sym]} launches ({k['device_kernels']} device kernels)")
    applied = trainer.dyn
    summary = {
        "write_dataset_s": write_s, "setup_s": setup_s,
        "adapts": adapt_records(trainer),
        "shapes": {"rays": applied.rays, "samples_per_ray": applied.march.num_samples,
                   "budgets": list(applied.budgets)},
        "slices": slices,
        **steady_rates(slices),
        "eval_batch_psnr": [psnr0, psnr1],
        "eval_all_images": eval_all,
        "eval_all_images_s": eval_all_s,
        "loss_first16": float(np.mean(losses[:16])), "loss_last16": float(np.mean(losses[-16:])),
        "peak_memory_gb": peak_gb,
        "profiled_step": {**prof, "kernel_launches_by_wrapper": per_step},
        "launches": launches,
        "checkpoint_round_trip": side["round_trip"],
    }
    print("bench schedule: " + json.dumps(summary))
    return launches


def check_adapts(trainer):
    """Decisions only at the scheduled steps (the first not a no-op), each
    applied 80 steps later with one budget per stage, each a multiple of 256
    within max(4096, R' x its lane gap); the steady window ran three stages."""
    for d in trainer.adapt_log:
        if d.get("noop"):
            print(f"  adapt decided at {d['decided']}: no-op (compute_adapt returned None)")
        else:
            print(f"  adapt decided at {d['decided']}, applied at {d['applied']}: rays "
                  f"{d['rays']}, samples/ray {d['march'].num_samples}, budgets {d['budgets']}")
    decided = [d["decided"] for d in trainer.adapt_log]
    check(decided == list(BENCH_ADAPT_STEPS), f"adapts decided at {decided}, expected "
                                               f"{list(BENCH_ADAPT_STEPS)}")
    check(not trainer.adapt_log[0].get("noop"), "the adapt at step 64 was a no-op")
    for d in trainer.adapt_log:
        if d.get("noop"):
            continue
        check(d["applied"] == d["decided"] + BENCH_PREFETCH,
              f"adapt decided at {d['decided']} applied at {d['applied']}")
        s_new, r_new = d["march"].num_samples, d["rays"]
        bounds = trainer.model.active_stage_boundaries(s_new)
        gaps = [bounds[0]] + [b - a for a, b in zip(bounds, list(bounds[1:]) + [s_new])]
        check(len(d["budgets"]) == len(bounds) + 1,
              f"adapt at {d['decided']}: {len(d['budgets'])} budgets for stages {bounds}")
        for b, g in zip(d["budgets"], gaps):
            check(b % 256 == 0 and b <= max(4096, r_new * g),
                  f"adapt at {d['decided']}: budget {b} not a multiple of 256 within "
                  f"max(4096, {r_new} x {g})")
    for r in trainer.history:  # the steady window runs three stages
        check("num_eval_s3_per_batch" in r["metrics"], f"step {r['step']}: no third stage")


def checkpoint_round_trip(trainer, dev, work):
    """Save at the warm-up's end, load into a fresh Trainer: every tensor of
    the state, the generator and the shapes equal bit for bit, the next
    step's draws equal, and its loss within rtol 1e-6."""
    t0 = time.perf_counter()
    ckpt = work / "warm"
    trainer.save_checkpoint(directory=ckpt)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fresh = bench_trainer(trainer.datamanager.config.dataparser.data, dev, load_dir=ckpt)
    load_s = time.perf_counter() - t0
    check(fresh.step == trainer.step, f"restored step {fresh.step} != {trainer.step}")
    check(fresh.dyn == trainer.dyn, f"restored shapes {fresh.dyn} != {trainer.dyn}")
    a, b = trainer.state_tensors(), fresh.state_tensors()
    check(sorted(a) == sorted(b), "restored state has other tensors")
    for k in a:
        check(a[k].dtype == b[k].dtype and torch.equal(a[k].to(b[k].device), b[k]),
              f"checkpoint round trip changed {k}")
    del a, b
    gen_state = trainer._step_gen.get_state()
    da, db = trainer.draw_step(), fresh.draw_step()
    trainer._step_gen.set_state(gen_state)
    for k in da:
        same = (all(torch.equal(x, y) for x, y in zip(da[k], db[k])) if k == "pixels"
                else torch.equal(da[k], db[k]))
        check(same, f"the restored trainer draws other {k}")
    la = float(trainer.loss_and_grads(da)[0].detach())
    lb = float(fresh.loss_and_grads(db)[0].detach())
    for t in (trainer, fresh):
        for p in t.optimizer.params:
            p.grad = None
    check(abs(la - lb) <= 1e-6 * abs(la), f"next step's loss {la} vs restored {lb}")
    out = {"step": trainer.step, "save_s": save_s, "load_s": load_s,
           "next_loss": la, "next_loss_restored": lb}
    print("  checkpoint round trip: " + json.dumps(out))
    del fresh
    return out


REPEAT_SETTINGS = (  # label, torch's deterministic algorithms, model overrides
    ("kernels", False, {}),
    ("kernels, deterministic torch ops", True, {}),
    ("plain, deterministic torch ops", True, {"impl": "plain"}),
)


def repeat_schedule(dev):
    """Phase 7's schedule twice in each of REPEAT_SETTINGS: whether the two
    runs' losses agree bit for bit, the first step where they part, their
    adapt decisions and steady rates. The ops that torch reports as having
    no deterministic implementation are printed."""
    import warnings

    import torch.utils.deterministic

    # deterministic mode would fill fresh tensors with NaN: keep that apart
    torch.utils.deterministic.fill_uninitialized_memory = False
    notes = set()
    results = {}
    for label, deterministic, overrides in REPEAT_SETTINGS:
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        runs = []
        for _ in range(2):
            with warnings.catch_warnings(record=True) as caught, \
                    bench_dataset() as (_, root, _):
                warnings.simplefilter("always")
                trainer = bench_trainer(root, dev, **overrides)
                slices, losses = drive_schedule(trainer)
            notes |= {str(w.message)[:200] for w in caught if "determinis" in str(w.message)}
            runs.append({"losses": losses, "adapts": adapt_records(trainer),
                         **steady_rates(slices)})
            del trainer
        a, b = runs
        parted = next((i for i, (x, y) in enumerate(zip(a["losses"], b["losses"])) if x != y),
                      None)
        results[label] = {
            "identical_losses": parted is None, "first_step_apart": parted,
            "adapts_equal": a["adapts"] == b["adapts"],
            "runs": [{k: r[k] for k in ("adapts", "steady_rays_per_s", "steady_ms_per_step")}
                     | {"loss_last": r["losses"][-1]} for r in runs],
        }
        print(f"repeat [{label}]: " + json.dumps(results[label]))
    torch.use_deterministic_algorithms(False)
    for note in sorted(notes):
        print(f"  torch: {note}")
    return results


def sweep_vs_plain(dev, extra_steps: int):
    """Phase 7's schedule with phase 6's kernel-vs-plain step after every
    slice from step 144 on (the first adapt's shapes), then after each of
    `extra_steps` single steps past the schedule; prints the largest
    readings over all of them. A failing step fails the sweep."""
    readings = []
    with bench_dataset() as (_, root, _):
        trainer = bench_trainer(root, dev)

        def after_slice(t):
            if t.step >= BENCH_ADAPT_STEPS[0] + BENCH_PREFETCH:
                readings.append(phase_train_vs_plain(t, dev, f"sweep, step {t.step}"))

        drive_schedule(trainer, after_slice)
        for _ in range(extra_steps):
            trainer.train(num_iterations=trainer.step + 1)
            readings.append(phase_train_vs_plain(trainer, dev, f"sweep, step {trainer.step}"))

    def largest(key):
        return max((r for rd in readings for r in rd[key]), key=lambda r: r[0])

    summary = {
        "steps_compared": len(readings), "draws_each": VS_PLAIN_DRAWS,
        "largest_median_over_tolerance": max((rd["worst_median_over_tolerance"]
                                              for rd in readings), key=lambda r: r[0]),
        "largest_single_draw_over_tolerance": largest("worst_over_tolerance_per_draw"),
        "draws_over_tolerance": sum(r[0] > 1.0 for rd in readings
                                    for r in rd["worst_over_tolerance_per_draw"]),
        "largest_loss_over_tolerance": max(x for rd in readings
                                           for x in rd["loss_over_tolerance"]),
        "largest_elementwise_kernels": largest("elementwise_kernels_per_draw"),
        "largest_elementwise_plain_moved": largest("elementwise_plain_moved_per_draw"),
        "draws_elementwise_kernels_over_1": sum(r[0] > 1.0 for rd in readings
                                                for r in rd["elementwise_kernels_per_draw"]),
        "draws_elementwise_plain_moved_over_1": sum(
            r[0] > 1.0 for rd in readings for r in rd["elementwise_plain_moved_per_draw"]),
    }
    print("sweep vs plain: " + json.dumps(summary))


def ptxas_usage(log: str) -> dict:
    """{kernel<template args>: registers and spill bytes} from nvcc -Xptxas=-v."""
    usage, kernel = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\S*?([a-z_]+_kernel)(\S*)'", line)
        if entry:  # template arguments: the literals (Li8E, Lb1E) after the name
            args = re.findall(r"L[a-z](\d+)E", entry.group(2))
            kernel = entry.group(1) + (f"<{','.join(args)}>" if args else "")
            usage[kernel] = {}
        elif kernel and "spill stores" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes", line)]
            usage[kernel].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif kernel and "registers" in line:
            usage[kernel]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return usage


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat-schedule", action="store_true",
                    help="only repeat phase 7's schedule in three settings")
    ap.add_argument("--sweep-vs-plain", type=int, metavar="STEPS", default=None,
                    help="only run phase 7's schedule with phase 6's check after every "
                         "slice and after each of STEPS single steps past it")
    args = ap.parse_args()
    if args.repeat_schedule:  # cuBLAS reads this at its first call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    spills = []
    for src, log in reports.items():
        for kernel, usage in ptxas_usage(log).items():
            print(f"  ptxas {src} {kernel}: " + json.dumps(usage))
            if usage["spill_stores"] or usage["spill_loads"]:
                spills.append(kernel)
    check(not spills, f"ptxas spilled registers in {spills}")

    only = args.repeat_schedule or args.sweep_vs_plain is not None
    if args.repeat_schedule:
        repeat_schedule(dev)
    elif args.sweep_vs_plain is not None:
        sweep_vs_plain(dev, args.sweep_vs_plain)
    else:
        k1 = phase_k1(dev)
        k3 = phase_k3(dev)
        k2 = phase_k2(dev)
        k4 = phase_k4(dev)
        p1 = phase_p1(dev)
        dm, endmembers, cam = bench_scene_in_memory(dev)
        trainer, render_launches = phase_render(dev, dm, endmembers, cam)
        phase_kernels_vs_plain(trainer, cam, dev)
        del trainer
        trainer, train_launches, _ = phase_train(dev, dm, endmembers)
        phase_train_vs_plain(trainer, dev, f"after train({TRAIN_STEPS})")
        del trainer, dm
        bench_launches = phase_bench_schedule(dev)

        for entry in (k1, k2, k3, k4):
            sym = "umhs_" + entry["name"]
            entry["launches"] = bench_launches[sym]  # the bench schedule's run
            entry["launches_train"] = train_launches[sym]
            entry["launches_render"] = render_launches[sym]
    print(smi)
    if not only:
        print(json.dumps({"kernels": [k1, k2, k3, k4, p1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
