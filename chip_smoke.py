#!/usr/bin/env python3
"""GPU smoke run of umhs_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py [--quality all] [--baseline TREE]
    python3 chip_smoke.py --repeat-schedule
    python3 chip_smoke.py --sweep-vs-plain 100
    python3 chip_smoke.py --seed-variance
    python3 chip_smoke.py --mesh-cards    (on more than one card)

The second form runs only phase 7's schedule, twice in each of three
settings (the kernels; the kernels with torch's deterministic algorithms;
the plain versions with them), and prints, for each setting, whether the
two runs' losses agree bit for bit and where they first part, their adapt
decisions and their steady ms per step; it fails unless both runs of the
first setting, the Trainer as shipped, agree. The third runs only phase 7's
schedule with phase 6's check after every slice from step 144 on and after
each of 100 single steps past it, and prints the largest readings. The
fourth runs only the seed-variance twin (umhs_torch.scripts.
quality_seed_variance) at 3 seeds, 2,000 steps, 256^2 and prints its spread
beside the JAX package's docs/seed_variance.json. The fifth runs only phase
9's cli.train command line, `python -m umhs_torch.cli.train`, in a process
of its own over every visible card (one rank per card on NCCL), and then on
one card (mesh_cards).

Phases (any failure exits non-zero; nothing is caught and passed over):
1. Device and build: the card's name and power limit, then every kernel in
   umhs_torch/csrc is compiled by nvcc into umhs_torch/_build/ (timed), with
   ptxas's registers and spill bytes per kernel; any spill fails the run.
   Then the native cube loader (umhs_torch/native/loader.cpp) by g++, timed.
2. Each kernel against its plain PyTorch version on the card, at the
   flagship shapes, with its device time (device_ms: CUDA events around
   back-to-back calls held behind a spin kernel), the plain version's, one
   PyTorch yardstick's and the bound from bytes or operations:
   - K1 mlp_fused_fwd: the four field MLP chains, f32 (rtol/atol 1e-5, the
     FMA kernel) and bf16 (2e-2, the tensor-core kernel), at N = 2^20 and at
     an N that is not a multiple of the tile, plus a single-layer chain;
     each chain's route (the device kernel its launcher picks) with that
     kernel's ptxas registers;
   - K3 hash_encode_fwd: tetrahedral and trilinear at L16xF2 2^19 on 2^20
     positions including exact 0 and 1, and tetrahedral on 16,384 rays x 64
     ray-ordered samples (atol 1e-6; table values ~1e-4);
   - K2 mlp_fused_bwd: the four chains at the training buffer's N = 262,144
     rows, f32 (rtol 1e-4, atol 1e-4 * max; the FMA kernel) and bf16 (2e-2;
     the tensor-core kernel), dx, dW and db against autograd of mlp_plain
     (bf16: also against the same backward on K1's own forward, and dx
     against mlp_plain's only on rows whose ReLUs both forwards decide
     alike; why: k2_against_plain), each repeated bit for bit; bf16 also at the steady step's stage sizes
     174,336 and 101,632 rows and at 101,299; each chain's route (the
     device kernel its launcher picks) with that kernel's ptxas registers;
   - K4 hash_encode_bwd: tetrahedral L16xF2 2^19 at 262,144 random
     positions, at 4,096 rays x 64 evenly spaced samples in ray-major order
     (the compact buffer's layout, where neighbours share rows) and with
     every position equal (one row per level holds every entry), each mode
     run twice (the same bits again) and held bit for bit to the plain
     version on CPU copies: both add each entry from +0 in ascending entry
     order. Stochastic: bit for bit against the plain sum on the CPU over
     the rows the card draws, and against the plain version itself off the
     rows of the draws that differ between the card's sin and the CPU's
     (their share printed, at most K4_DRAW_DIFFER_SHARE); with unit
     gradients the table sums to exactly N x L x F. Each case timed beside
     zeros + index_add_ on the same precomputed rows, and with every level
     on each route; each level's route (hash_encode_bwd_route: "runs" or
     "entries") is printed with its entries per run on these inputs.
   - P1 row_gather: the probe twin's check (umhs_torch.probes.gather), bit
     for bit against table[idx] on the probe's 12,000,000 x 2 f32 table and
     the flagship's 6,098,108 x 2 table at 16,318,464 rows and at the edge
     N (rows 0 and T-1 among the indices); then its own path, the probe
     twin, measures it beside torch.index_select with the launch counts
     zeroed before and read after: each arm timed the same way and in
     turns, by device time under torch.profiler with the device kernels it
     launched listed by name and by CUDA events around a batch of calls, with
     a warm L2 and
     with a cold one (256 MB written before each call; a profile that lost
     device events is left out, and an arm with none whole reads null);
     then the kernel's, index_select's and the plain version's device time
     by device_ms (the kernels line's ms, library_ms and plain_ms).
   - K6 (phase_k6), the compact path's compaction and compositing, at
     phase 7's steady shapes (79,360 rays x 64 lanes, stages 0-8, 8-16,
     16-64 with budgets 179,200 / 103,936 / 93,440, the flagship's heads
     of 128, 128, 128 and 6 channels): K6a compact_stage and K6b
     compact_gather (both ways) bit for bit against their plain versions;
     K6c render_weights forward and backward (also at nerfacto's 8192 rays
     x 256, 96 and 48 samples, with the t gradients) and K6d
     segment_accumulate forward (a launch a head over the three stages,
     equal to the single-stage calls added in stage order) and backward (a
     launch a stage), each held with its plain version to an f64
     evaluation of the same function: the kernel's error at most the plain
     version's plus K6_TOL; each repeated bit for bit; timed as above, with
     torch.segment_reduce (a call a stage and head) as K6d's yardstick and
     the bounds by bytes; each launcher's ptxas registers and spills.
   - K5 and K7 (phase_k5k7, once the bench scene is staged), the occupancy
     grid's march and update at the flagship's shapes: K7 (K7a occ_update,
     K7b occ_pack) updates the 128^3 x 4 grid from a density like the bench
     scene's trained field (bench_sphere_density; full, again, then a
     partial update of ~918,000 probes, cells drawn twice among them, at
     partial_cells' cells and from the draws: K7a's cells those of
     partial_cells, the bitfield untouched, each run on a copy of the grid,
     which a partial update on the card writes in place), its
     occupied share printed; K5 (K5a march_count, K5b march_emit) marches
     phase 7's steady batch on it (79,360 training rays with jitter, S 64,
     total budget 376,576), on a dense and an empty grid, a 4,096-ray eval
     chunk and without a budget. Every output bit for bit against the plain
     version and again on a second run; the od culling (off in every
     shipped configuration; K5 sums it one candidate at a time) held with
     the plain version to f64, the rays with a candidate within 1e-5 of
     od_max counted. Device ms, ms per call, the plain version's device ms
     (K5: the whole plain march; K7a: the plain positions and fold, and the
     whole update beside the plain one), the bound by bytes (K5a: the larger
     of it and the bound by operations on the candidates this data needs,
     k5a_candidates_needed), ptxas; K5a also alone on the dense and empty
     grids and the eval chunk. K7b also alone (k7b_cases): bit for bit
     against the plain version at res 128, 64 and 32 with pool 4 and 2 (a
     thread a supercell) and at res 30 and 33 (a thread a cell), the
     threshold from occ_thre and from the mean; a misaligned occs refused
     before any launch.
   With --baseline TREE (another checkout, e.g. the parent commit unpacked
   by git archive into the git-ignored chip_archive/): every kernel at
   phase 2's and phase 10's shapes through each tree's own wrappers, a
   process each, in turns (TREE, this, this, TREE: baseline_against_tree),
   device ms and ms per call; K3, K4 (both modes, random and ray-ordered
   flagship inputs, both proposal grids) and P1 must give TREE's bits,
   K1 and K2 on the DINO chain within 2e-2 of them; K6 at phase 7's steady
   shapes through the tree's own code (the plain PyTorch of its model in a
   tree without K6: k6_parent_code), K6a's, K6b's and (in a tree with K6's
   kernels) K6c's (its backward alone too, also at nerfacto's shapes) and
   K6d's forward bits the tree's; K7 (full and partial) and K5 (K5a and K5b
   alone, the march on the bench-scene, dense and empty grids and an eval
   chunk)
   through the tree's own update_occ_state (the partial one whole: the
   tree's cell choice, partial_cells or K7a's), march_count_cuda,
   march_emit_cuda and march_rays
   (k5k7_tree_cases; K7b alone too, on that grid and three of k7b_cases'
   grids), K7's bits the tree's, K5's too in a tree with K5's
   kernels (a tree before the budget scale's one-division repair may round
   apart), and the SASS of the tree's K5a and K5b beside this one's
   (sass_loops: instructions and each loop's body).
3. The serving path at full width: the bench scene (16 + 2 views, 128^2,
   128 bands, 6 spheres) as an in-memory train split (rendered once, also
   for phase 5) with VCA endmembers, Trainer.setup() from seed 0
   with a bf16 compute dtype, the step-0 full occupancy update (and one
   more, timed as the steady state), then render_camera of both eval views
   at step 1000. Launch counts are zeroed before setup and read after the
   renders; K1, K3, K5 and K6's forward kernels (K6a, K6b, K6c's and K6d's
   forwards) must have launched, and K7 by the updates. One more render
   runs under torch.profiler for the device-time breakdown, and one under
   host_syncs (the calls that make the host wait, by source line).
4. The same render with kernels against plain versions, both in f32, on a
   64x64 crop (atol 1e-3 on rgb, spectral and accumulation); the first must
   launch the render's kernels and the second none.
5. The training path at full width: the same scene's 16 train views,
   Trainer.setup() from seed 0 (bf16, stochastic hash gradient, 4096 rays
   per step, warmup thinning 2), then train(48): full occupancy updates at
   steps 0 and 32, a partial one at 16. Launch counts are zeroed just before
   and read just after; K1-K7 must have launched; the loss must be finite
   and fall (mean of the last 4 steps below the first 4). A second
   train(48) from seed 0, its launches uncounted, must give the same loss
   at every step and the same state, bit for bit. One more step runs under
   torch.profiler.
6. One training step from the trained state with kernels against plain
   versions, both in f32 with the deterministic hash gradient and the same
   draws. The kernel step, run twice, repeats bit for bit in every
   gradient. On each of three draws: the loss within rtol 1e-5 and
   every gradient within rtol 1e-3 in norm, each plus 4x the plain path's
   own change when it runs from the parameters moved one ulp; each passes
   on the median of the draws (why: phase_train_vs_plain). The kernel run
   launches K1-K4, the plain runs none. Then the same step in bf16 (the
   tensor-core K1 and K2): the loss within rtol 1e-3 and every gradient
   within rtol 1e-2 in norm, each plus 4x the moved plain run's change
   (why: VS_PLAIN_RTOL).
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
   device ms of K1-K4 and K6 in it beside their launches. With --baseline
   TREE the schedule runs from that tree and from this checkout, a process
   each, in turns (TREE, this, this, TREE: schedule_against_tree), each
   followed by one traced steady step (with its indexing_backward_kernel
   calls named by their forward op), phase 5's configuration's traced step
   and a traced 128^2 render, with the host syncs of a steady step and of
   the render by source line: this checkout's runs must give this run's 672
   losses and adapts bit for bit, and the tree's runs each other's; the
   first step where the trees' losses part, both trees' adapts and their
   eval_all_images are printed, and this tree's eval_all_images PSNR must
   be at most 1.0 dB below the tree's (K6 sums in another order than the
   plain code, so the training bits of a tree before it part); a tree with
   K5's kernels must give this run's losses and adapts bit for bit. After the traced step,
   K5 and K7 against their plain versions on the schedule's own steady
   state (a steady batch's march at its budget, a partial update from its
   draws with the field's density; k5k7_on_trained_state), that partial
   update whole (device ms, launches) and in pieces, the cell choice's
   among them (partial_update_split; under --baseline in each tree's
   schedule_measurements, in turns), and the host syncs of one step.

8. The quality twin (umhs_torch.scripts.quality_reference_scale, the twin of
   scripts/quality_reference_scale.py) through its entry point: 2,000 steps,
   256^2, 21 bands, seed 42, tetrahedral, at full width (L16xF2 2^19 hash,
   128^3 x 4 occupancy, 6 classes, the specular residual, bf16), with the
   launch counts zeroed before and read after (K1-K4 must launch). It prints
   the JSON, the LPIPS variant, steps/s and the card, reads one eval image
   it wrote back through data/png.py, and fails unless eval_all_images comes
   within reach of docs/tetra_2000_256.json: PSNR and spectral PSNR at most
   1.0 dB below (~4x the 0.26 dB seed stdev of docs/seed_variance.json), SAM
   at most 1.25x. --quality all also runs the trilinear and the 141-band
   bf16 configurations against docs/trilinear_2000_256.json and
   docs/bayspec141_2000_256.json, under the same rule.

9. The user's entry points, at full width, in a temporary working
   directory with the bench scene written by write_dataset: load_cubes on
   its 16 train cubes, the native loader against the plain loop in turns
   (the same bits; seconds of each). Then cli.train with the command line a
   user would type (printed): the README's flags, the flagship model's as
   dotted flags and bench.py's trainer settings, to step 672 with one
   checkpoint, --vis console --log-gradients True; the launch counts zeroed
   before and read after (K1-K4 must launch). Its losses and adapt decisions
   must equal phase 7's bit for bit, step for step; otherwise the first step
   where they part and every field in which the resolved configs differ
   are printed and the run fails. config.yml, metrics.jsonl (with
   grad_norm/total) and final_metrics.json must exist, and eval_all_images
   PSNR must reach 25 dB. `python -m umhs_torch.cli.eval --load-config`
   runs in a fresh process, on the card by default: its results within a
   relative 1e-6 of final_metrics.json's (the largest difference printed).
   cli.render camera-path renders 8 frames of an orbit (128^2, fov 50) with
   the README's outputs rgb, abundances_0, wv_10 and seg_pred: each PNG
   frame reads back as (128, 512, 3), frame 0's rgb tile equals
   Trainer.render_camera on the same rays bit for bit, the render's kernels
   (K1, K3, K6's forwards) launch and K2, K4 and K6's backwards do not; ms
   per frame. The viewer on port 0 in a thread: /,
   /outputs, and /render of rgb, depth and abundances_0 (PNGs of (128, 128,
   3); ms per request), an unknown output answered with 500, and one
   /render under utils/profiler.trace, whose Chrome trace must name K1's
   and K3's device kernels; the render's kernels launch, K2, K4 and K6's
   backwards do not.

10. The proposal sampler and the DINO head, at full width, each part timed.
   First K1-K4 at this phase's shapes against their plain versions, timed
   as in phase 2 (phase_slice_kernels): the proposal chain 10 -> 16 -> 1 at
   2,097,152 and 786,432 rows, the DINO chain 15 -> 256 -> 128 at 262,144
   (K1's and K2's wide tensor-core kernels), each chain's routes with their
   ptxas registers and spills, the proposal grids L5 F2 2^17 on as many
   ray-ordered positions, K4 deterministic (84M and 31M (row, entry)
   pairs), each grid's K4 route per level printed with its entries per run.
   10a: scripts/nerfacto.sh through cli.train with a literal argv (printed)
   on the bench scene written to disk: the rgb method, the proposal sampler
   ((256, 96) -> 48), 8192 rays, seed 42, the method's defaults otherwise
   (bf16, main hash L16xF2 2^19 trilinear), cut to 500 steps; the launch
   counts zeroed before and read after (K1-K4 must launch; no K5 or K7,
   no occupancy update, no adapt; K6c forward and backward launch, K6a,
   K6b and K6d do not: no compact buffer). eval_all_images must be finite and 5 dB or more above
   the step-0 eval batch's PSNR (a fresh Trainer from the run's config.yml);
   the training views' PSNR through the same render is printed beside.
   cli.render renders 2 orbit frames (K1, K3 and K6c's forward launch, the
   rest do not).
   One more step runs under torch.profiler (K1-K4's device ms in it).
   Two Trainers from seed 0 run train(48): the same losses bit for bit.
   Phase 6's kernel-vs-plain step at the trained state, 8192 rays, f32,
   every proposal table and MLP among the gradients and each loss term
   apart. Then the calls in one step that make the host wait for the device
   (host_syncs), by source line, and the step's busy share without the
   profiler (step_busy: one step behind a spin against the wall time).
   10b: phase 7's configuration with pred_dino on the bench scene with
   128-channel DINO sidecars (write_dino_sidecars: a seeded fixed map of
   each view's RGB): train(96) at 4096 rays, the launch counts zeroed
   before and read after; the mean dino_mse of the last 8 steps below that
   of the first 8. The DINO chain's routes (K1's and K2's wide kernels, or
   the run fails), and those kernels in a traced step (their device ms). At
   step 3001 (the cluster loss in the sum): phase 6's
   kernel-vs-plain step over every leaf (dino_mlp and dino_clusters
   included), and the hash table's gradient the same bits with the DINO
   terms and without them, which reach the DINO leaves only. render_camera
   of one eval view: dino finite, (128, 128, 128).

11. Data-parallel training (umhs_torch/parallel/mesh.py), each part timed.
   11a: phase 5's train(48) through a mesh of one card in a real NCCL group
   (the step's one all_reduce, setup's broadcasts), the launch counts zeroed
   before and read after (K1-K4 must launch): every loss and every state
   tensor equal to phase 5's bit for bit. 11b: two ranks on the one card,
   joined by gloo by name (NCCL refuses two ranks on one device), started by
   umhs_torch.parallel.mesh.launch as cli.train starts its ranks; each renders
   the bench scene and runs phase 5's configuration at 4096 global rays
   (2048 a rank, the initial stage budget dropping nothing) for train(32),
   the counts zeroed before and read after on each rank (K1-K4 must launch
   on both). Checked: both ranks read the same metrics and end with the
   same state bits, and the same occupancy bits after a partial update; on
   three draws, the ranks' step (bf16, deterministic hash gradient) against
   one process's on the same global draws, each loss term and gradient
   under phase 6's bf16 gate (median of the draws, none above
   VS_PLAIN_DRAW_CAP) and the *_per_batch counts equal; one eval view
   rendered ray-sharded, the same bits on both ranks and its rgb, spectral
   and accumulation within atol 1e-3 of one process's render (phase 4's
   check); a repeat of train(32) from seed 0 bit for bit.
   11c: 11b's wall ms per step and the seconds of an all_reduce of the
   step's flat buffer (its bytes printed): two ranks share one card and its
   host, so this measures correctness, not scaling.

12. The experiment scripts' twins (umhs_torch/scripts/sh/, read by
   umhs_torch.scripts.shell_argv.script_argv), each timed. Every training
   twin but nerfacto.sh (phase 10a) runs through cli.train in this process
   with its own argv (printed), only --data (the bench scene written to
   disk: 128 bands, 141 for the three Bayspec scripts), --output-dir (the
   temporary directory), --max-num-iterations and --steps-per-save (256)
   changed: the scripts' own configurations (the defaults' trilinear
   L16xF2 2^19 hash, S 96, bf16; methods rgb, spectral with last_sample
   and rgb+spectral; 4-7 classes; random, black backgrounds; 2048-8192
   rays; gradient accumulation 3). Gates per twin: the mean loss of the
   last 16 steps below the first 16's; eval_all_images PSNR above the
   step-0 eval batch's (a fresh Trainer from the run's config.yml); every
   kernel of path_kernels (and K7) launched, the counts zeroed before and
   read after; phase 6's kernel-vs-plain step at the run's final state and
   config; with accumulation, Adam stepped on every third step only. Each
   twin's ms a step over its last 64 steps is printed with the card. Then
   render.sh's twin renders 2 orbit frames of the hotdog twin's run with
   its rgb and abundances_0-5 (the render's kernels launch, the training
   ones do not), visualize/hotdog.sh's twin (cli.eval) runs in a process
   of its own (its results within 1e-6 of the run's eval_all_images), and
   visualize/ajar.sh's twin starts the viewer of the ajar run (7 classes)
   on port 0 for one /render of abundances_6. The phase's seconds are
   printed.

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


SPIN_CYCLES = (1 << 22, 1 << 28)  # the spin kernel's first and largest length (~2-140 ms)


def device_ms(fn, iters: int = 10) -> float:
    """Device time per call of fn(): CUDA events around `iters` back-to-back
    calls enqueued behind a spin kernel (torch.cuda._sleep) that holds the
    stream until the host has enqueued them all, so that the host's enqueue
    leaves no gap on the device; the spin grows until the start event is
    still pending when the last call is enqueued. It counts the device's own
    gaps between kernels (~1-2 us each). torch.profiler was seen to drop
    device events now and then, in bursts (readings of 0, or of one call in
    ten), so it serves only a call that waits for the device on its own (a
    copy from the host), which no spin can hold: then the kernels' summed
    device time under the profiler, a profile that lost events retaken
    (device_ms_by_kernel), and the run fails if every one did."""
    from umhs_torch.utils.device_time import device_ms_by_kernel

    ms = held_ms(fn, iters)
    if ms is not None:
        return ms
    print("  device_ms: a call waits for the device; timed under torch.profiler instead")
    by_kernel = device_ms_by_kernel(fn, iters=iters)
    check(by_kernel is not None, "device_ms: torch.profiler lost device events in every profile")
    return sum(by_kernel.values())


def held_ms(fn, iters: int):
    """device_ms's CUDA-event reading: ms per call of `iters` calls enqueued
    behind a spin; None when no spin up to SPIN_CYCLES[1] outlasts their
    enqueue (a call waits for the device, or the enqueue takes longer)."""
    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES[0]
    while cycles <= SPIN_CYCLES[1]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()  # the spin still ran when the last call was enqueued
        end.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        cycles *= 4
    return None


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_times(params, x, dims):
    """K1 on x (N, dims[0]) in bf16: its device ms, ms per call, the plain
    version's and one PyTorch call's (a bf16 addmm chain) device ms, and the
    bound (each input read once and the output written once, or the MACs on
    the bf16 tensor cores)."""
    from umhs_torch.ops.mlp_fused import mlp_fused_fwd, mlp_plain

    n = x.shape[0]
    wb = [(lay["w"].bfloat16(), lay["b"].bfloat16()) for lay in params["layers"]]

    def library():
        h = x.bfloat16()
        for i, (w, b) in enumerate(wb):
            h = torch.addmm(b, h, w)
            if i + 1 < len(wb):
                h = torch.relu(h)
        return h

    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = n * (dims[0] + dims[-1]) * 4 + sum(
        lay["w"].numel() * 4 + lay["b"].numel() * 4 for lay in params["layers"])
    b_ms, b_by = bound(nbytes, 2.0 * n * macs, H100_BF16_FLOPS)
    return {
        "ms": device_ms(lambda: mlp_fused_fwd(params, x, torch.bfloat16)),
        "call_ms": median_ms(lambda: mlp_fused_fwd(params, x, torch.bfloat16)),
        "plain_ms": device_ms(lambda: mlp_plain(params, x, torch.bfloat16), iters=5),
        "library_ms": device_ms(library),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def phase_k1(dev, ptxas):
    from umhs_torch.ops.mlp import init_mlp
    from umhs_torch.ops.mlp_fused import mlp_fused_fwd, mlp_fused_fwd_route, mlp_plain

    gen = torch.Generator().manual_seed(1)
    n_full, n_odd = 1 << 20, (1 << 20) - 333
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    max_err = 0.0
    cases = [(name, dims) for name, dims in K1_CHAINS.items()] + [("single_layer", [32, 16])]
    chains = {}
    for name, dims in cases:
        params = init_mlp(gen, dims[0], len(dims) - 1, dims[1], dims[-1], dev)
        route = mlp_fused_fwd_route(dims, torch.bfloat16)
        print(f"K1 {name} bf16 runs {route}: ptxas {json.dumps(ptxas.get(route))}; "
              f"f32 runs {mlp_fused_fwd_route(dims, torch.float32)}")
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
        chains[name] = {"dims": dims, "route": route, **k1_times(params, x, dims)}
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


def k3_times(table, pos, cfg):
    """K3 on positions (N, 3): its device ms, ms per call, the plain
    version's and one PyTorch call's (index_select of the vertex rows and the
    weighted sum) device ms; the bound counts each touched 32-byte sector of
    the table once (sector_bound_ms: one sector per vertex row)."""
    from umhs_torch.ops.encodings import hash_encode_fwd, hash_encode_plain, hash_indices_weights

    n, F = pos.shape[0], cfg.features_per_level
    idx, w = hash_indices_weights(pos, cfg)
    table2d = table.reshape(-1, F)

    def library():
        rows = torch.index_select(table2d, 0, idx.reshape(-1)).reshape(*idx.shape, F)
        return (rows * w[..., None]).sum(2)

    V = cfg.verts_per_cell
    sectors = int(torch.unique(idx.reshape(-1) * (4 * F) // 32).numel())
    nbytes = n * 3 * 4 + n * cfg.output_dim * 4 + sectors * 32
    b_ms, b_by = bound(nbytes, 2.0 * n * cfg.num_levels * V * F, H100_F32_FLOPS)
    return {
        "ms": device_ms(lambda: hash_encode_fwd(table, pos, cfg)),
        "call_ms": median_ms(lambda: hash_encode_fwd(table, pos, cfg)),
        "plain_ms": device_ms(lambda: hash_encode_plain(table, pos, cfg), iters=5),
        "library_ms": device_ms(library),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "sector_bound_ms": (n * 3 * 4 + n * cfg.output_dim * 4
                            + n * cfg.num_levels * V * 32) / H100_BYTES_PER_S * 1e3,
        "unique_sectors": sectors,
    }


def phase_k3(dev):
    from umhs_torch.data.synthetic import ray_samples
    from umhs_torch.ops.encodings import HashEncodingConfig, hash_encode_fwd, hash_encode_plain

    gen = torch.Generator().manual_seed(2)
    n = 1 << 20
    pos = torch.rand((n, 3), generator=gen)
    pos[0], pos[1] = 0.0, 1.0
    pos[2] = torch.tensor([0.0, 0.5, 1.0])
    pos[3] = torch.tensor([1.0, 0.0, 0.25])
    positions = {"random": pos.to(dev),
                 "rays": torch.from_numpy(ray_samples(n // 64, 64, seed=2)).to(dev)}
    entries = {}
    max_err = 0.0
    for interp, kind in (("tetrahedral", "random"), ("tetrahedral", "rays"),
                         ("trilinear", "random")):
        pos = positions[kind]
        cfg = HashEncodingConfig(num_levels=16, features_per_level=2, log2_hashmap_size=19,
                                 interpolation=interp)
        table = ((torch.rand((cfg.table_size * 2,), generator=gen) * 2 - 1) * 1e-4).to(dev)
        out = hash_encode_fwd(table, pos, cfg)
        ref = hash_encode_plain(table, pos, cfg)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = err <= 1e-6 and bool(torch.isfinite(out).all())
        print(f"K3 {interp} {kind} N=2^20 L16xF2 2^19: max_abs_err {err:.3e} (atol 1e-6) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"K3 {interp} {kind} disagrees with its plain version")
        max_err = max(max_err, err)

        entry = k3_times(table, pos, cfg)
        entries[f"{interp} {kind}"] = entry
        print(f"K3 {interp} {kind}: " + json.dumps(entry))
    main = entries["tetrahedral random"]
    return {
        "name": "hash_encode_fwd",
        "route": "cuda",
        "source": "umhs_torch/csrc/hash_encode_fwd.cu",
        "replaces": "umhs_tpu/ops/encodings.py:439",
        "max_abs_err": max_err,
        **{k: main[k] for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
        "shape": "tetrahedral, L16xF2 2^19, 2^20 random positions; rays = 16,384 rays x 64 "
                 "samples, ray-major (synthetic.ray_samples)",
        "rays": entries["tetrahedral rays"],
        "trilinear": entries["trilinear random"],
        "sector_bound_ms": main["sector_bound_ms"],
    }


# the training step's compact buffer before the first adapt: 4096 rays x 64
# samples (after the adapts the stage-1 budget runs 150k-190k rows, the
# tails 80k-320k)
K2_ROWS = 4096 * 64


# the steady step's stage sizes (bench schedule, PERF.md section 5) and a ragged N
K2_STEADY_ROWS = (174336, 101632, 101632 - 333)


def k1_forward_reference(params, x, g):
    """K2's backward in f64 on K1's own forward: each hidden layer's
    pre-activation is K1's output on the chain cut after that layer, ReLU'd
    and rounded to bf16 as the kernels do; dh is rounded to bf16 for both
    products, db summed before. Returns (dx, [(dW, db)], the rows where some
    hidden ReLU of K1 decides otherwise than mlp_plain's)."""
    from umhs_torch.ops.mlp_fused import mlp_fused_fwd, mlp_plain

    layers = params["layers"]
    acts = [x.bfloat16().double()]
    flipped = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for l in range(len(layers) - 1):
        cut = {"layers": layers[:l + 1]}
        pre = mlp_fused_fwd(cut, x, torch.bfloat16)
        flipped |= ((pre > 0) != (mlp_plain(cut, x, torch.bfloat16) > 0)).any(1)
        acts.append(torch.relu(pre).bfloat16().double())
    dh, grads = g.double(), []
    for l in reversed(range(len(layers))):
        if l + 1 < len(layers):
            dh = dh * (acts[l + 1] > 0)
        db = dh.sum(0)
        dh = dh.float().bfloat16().double()
        grads.insert(0, (acts[l].T @ dh, db))
        dh = dh @ layers[l]["w"].bfloat16().double().T
    return dh, grads, flipped


# bf16: at most this share of rows may take a hidden ReLU otherwise in K1's
# forward than in mlp_plain's (see k2_against_plain)
K2_FLIPPED_ROWS_SHARE = 1e-4


def k2_against_plain(name, params, x, g, dt):
    """K2 against autograd of mlp_plain on one input: every tensor within
    2e-2 (bf16) or 1e-4 (f32) of its largest entry, and a second run equal
    bit for bit. Returns (max abs error, max error / max |ref|).

    bf16: K1 and K2 sum on the tensor cores, mlp_plain in f32 on cuBLAS, so
    a hidden pre-activation within rounding of 0 can take the ReLU one way
    in K1's forward and the other in mlp_plain's (3 of 16.7M hidden units in
    feature_mlp at 262,144 rows). K2 follows K1's decision, as it must, and
    a row's dx then moves by that unit's whole share. So dx is held to the
    plain version on the rows where the two forwards decide alike, and
    every tensor, those rows included, to the same backward in f64 on K1's
    own forward (k1_forward_reference), within the same tolerance; the
    rows that differ must stay below K2_FLIPPED_ROWS_SHARE."""
    from umhs_torch.ops.mlp_fused import mlp_fused_bwd, mlp_plain_bwd

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dt]
    n = x.shape[0]
    dx, grads = mlp_fused_bwd(params, x, g, dt)
    again = mlp_fused_bwd(params, x, g, dt)
    dx_ref, grads_ref = mlp_plain_bwd(params, x, g, dt)
    torch.cuda.synchronize()
    flat = [dx] + [t for pair in grads for t in pair]
    same = all(torch.equal(a, b) for a, b in zip(flat, [again[0]] + [t for p in again[1] for t in p]))
    check(same, f"K2 {name} N={n} {dt}: a second run gave other bits")
    refs = {"plain": [dx_ref] + [t for pair in grads_ref for t in pair]}
    keep = torch.ones(n, dtype=torch.bool, device=x.device)
    if dt == torch.bfloat16:
        dx_k, grads_k, flipped = k1_forward_reference(params, x, g)
        refs["K1's forward, f64"] = [dx_k] + [t for pair in grads_k for t in pair]
        keep = ~flipped
        check(int(flipped.sum()) <= K2_FLIPPED_ROWS_SHARE * n,
              f"K2 {name} N={n}: {int(flipped.sum())} rows take a ReLU otherwise in K1's "
              "forward than in mlp_plain's")
    worst, max_err, line = 0.0, 0.0, []
    for label, ref_list in refs.items():
        worst_ref = 0.0
        for i, (got, ref) in enumerate(zip(flat, ref_list)):
            if i == 0 and label == "plain":
                got, ref = got[keep], ref[keep]
            got, ref = got.double(), ref.double()
            err = float((got - ref).abs().max())
            ok = torch.allclose(got, ref, rtol=tol, atol=tol * float(ref.abs().max()))
            check(ok, f"K2 {name} N={n} {dt} disagrees with {label} (max abs err {err})")
            worst_ref = max(worst_ref, err / max(float(ref.abs().max()), 1e-30))
            max_err = max(max_err, err)
        worst = max(worst, worst_ref)
        line.append(f"{label} {worst_ref:.3e}")
    flips = f", rows deciding a ReLU otherwise than mlp_plain: {int((~keep).sum())}" \
        if dt == torch.bfloat16 else ""
    print(f"K2 {name} N={n} {str(dt)[6:]}: max error / max|ref|: {'; '.join(line)} "
          f"(tol {tol:g}){flips}; repeats bit for bit, ok")
    return max_err, worst


def k2_times(params, x, g, dims, need_dx):
    """K2 on x (N, dims[0]) and g (N, dims[-1]) in bf16, with dx when
    `need_dx`: its device ms, ms per call, the plain version's and one
    PyTorch call's (a bf16 addmm chain and torch.autograd.grad) device ms,
    and the bound (the MACs of the recompute below the last layer, dW and
    dh on the bf16 tensor cores, or x, g and the weights read and dx and the
    weight gradients written)."""
    from umhs_torch.ops.mlp_fused import mlp_fused_bwd, mlp_plain_bwd

    n = x.shape[0]
    leaves = [t.bfloat16().requires_grad_(True) for lay in params["layers"]
              for t in (lay["w"], lay["b"])]
    xb = x.bfloat16().requires_grad_(need_dx)
    gb = g.bfloat16()

    def library():
        h = xb
        for i in range(0, len(leaves), 2):
            h = torch.addmm(leaves[i + 1], h, leaves[i])
            if i + 2 < len(leaves):
                h = torch.relu(h)
        return torch.autograd.grad(h, ([xb] if need_dx else []) + leaves, gb)

    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    # recompute, dW and dh per layer; no recompute of the last layer (its
    # output is not used: g stands for it) and no dh below the first without dx
    flops = 2.0 * n * (3 * macs - dims[-2] * dims[-1] - (0 if need_dx else dims[0] * dims[1]))
    nparams = sum(lay["w"].numel() + lay["b"].numel() for lay in params["layers"])
    nbytes = n * (dims[0] + dims[-1] + (dims[0] if need_dx else 0)) * 4 + 2 * nparams * 4
    b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
    return {
        "ms": device_ms(lambda: mlp_fused_bwd(params, x, g, torch.bfloat16, need_dx)),
        "call_ms": median_ms(lambda: mlp_fused_bwd(params, x, g, torch.bfloat16, need_dx)),
        "plain_ms": device_ms(lambda: mlp_plain_bwd(params, x, g, torch.bfloat16, need_dx),
                              iters=5),
        "library_ms": device_ms(library),
        "bound_ms": b_ms,
        "bound_by": b_by,
    }


def phase_k2(dev, ptxas):
    from umhs_torch.ops.mlp import init_mlp
    from umhs_torch.ops.mlp_fused import mlp_fused_bwd_route

    gen = torch.Generator().manual_seed(3)
    gen_steady = torch.Generator().manual_seed(30)
    n = K2_ROWS
    max_err = 0.0
    max_rel = {"float32": 0.0, "bfloat16": 0.0}  # max |err| / max |ref| per tensor
    chains = {}
    for name, dims in K1_CHAINS.items():
        params = init_mlp(gen, dims[0], len(dims) - 1, dims[1], dims[-1], dev)
        route = mlp_fused_bwd_route(dims, torch.bfloat16)
        print(f"K2 {name} bf16 runs {route}: ptxas {json.dumps(ptxas.get(route))}; "
              f"f32 runs {mlp_fused_bwd_route(dims, torch.float32)}")
        x = torch.randn((n, dims[0]), generator=gen).to(dev)
        g = torch.randn((n, dims[-1]), generator=gen).to(dev)
        cases = [(x, g, dt) for dt in (torch.float32, torch.bfloat16)]
        for rows in K2_STEADY_ROWS:  # inputs of their own: `gen` draws as in earlier runs
            cases.append((torch.randn((rows, dims[0]), generator=gen_steady).to(dev),
                          torch.randn((rows, dims[-1]), generator=gen_steady).to(dev),
                          torch.bfloat16))
        for xc, gc, dt in cases:
            err, worst = k2_against_plain(name, params, xc, gc, dt)
            max_err = max(max_err, err)
            max_rel[str(dt)[6:]] = max(max_rel[str(dt)[6:]], worst)
        del cases
        # timing at the main path's dtype and dx: mlp_directional's input
        # (SH + posenc) has no parameters upstream, so it takes no dx
        need_dx = name != "mlp_directional"
        chains[name] = {"dims": dims, "dx": need_dx, "route": route,
                        **k2_times(params, x, g, dims, need_dx)}
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
                 "torch.autograd.grad; also checked at 174,336, 101,632 and 101,299 rows",
        "chains": chains,
    }


def bits(t):
    """A tensor's bits, on the CPU: equal bits, not merely equal values
    (+0 and -0 differ)."""
    return t.detach().cpu().view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                                  8: torch.int64}[t.element_size()])


# the share of stochastic draws (sample, level) that may land on another
# vertex on the card than on the CPU: torch.sin on the two differs by an ulp
# now and then, and u = frac(sin(.) * 43758.5453) scales that by ~4e4
K4_DRAW_DIFFER_SHARE = 1e-2


def k4_against_cpu(label, pos, g, cfg):
    """K4 against its plain version on CPU copies, bit for bit: both add each
    table entry from +0 in ascending entry order. Each mode runs twice and
    must repeat bit for bit. Stochastic: bit for bit against the plain sum on
    the CPU over the rows the card draws (torch's ops on the card), and
    against the plain version itself off the rows of every (sample, level)
    whose draw differs between the card and the CPU; their count is printed.
    With unit gradients the stochastic table sums to exactly N x L x F.
    Returns (largest |kernel - plain| on the compared entries, the share of
    differing draws)."""
    from umhs_torch.ops.encodings import (
        hash_encode_bwd, hash_encode_bwd_plain, stochastic_rows)

    n, L, F = pos.shape[0], cfg.num_levels, cfg.features_per_level
    cpu_pos, cpu_g = pos.cpu(), g.cpu()
    out = {}
    for mode, stochastic in (("deterministic", False), ("stochastic", True)):
        got = hash_encode_bwd(pos, g, cfg, stochastic)
        again = hash_encode_bwd(pos, g, cfg, stochastic)
        torch.cuda.synchronize()
        check(torch.equal(bits(got), bits(again)),
              f"K4 {label} {mode}: a second run gave other bits")
        out[mode] = (got.cpu(), hash_encode_bwd_plain(cpu_pos, cpu_g, cfg, stochastic))
        del got, again
    det, det_ref = out["deterministic"]
    check(torch.equal(bits(det), bits(det_ref)),
          f"K4 {label} deterministic: not the plain version's bits on the CPU "
          f"(max abs err {float((det - det_ref).abs().max())})")
    sto, sto_ref = out["stochastic"]
    rows_card, rows_cpu = stochastic_rows(pos, cfg).cpu(), stochastic_rows(cpu_pos, cfg)
    feat = torch.arange(F)
    on_card_rows = torch.zeros_like(sto_ref).index_add_(
        0, (rows_card[..., None] * F + feat).reshape(-1), cpu_g.reshape(-1))
    check(torch.equal(bits(sto), bits(on_card_rows)),
          f"K4 {label} stochastic: not the plain sum over the card's draws, bit for bit")
    differ = rows_card != rows_cpu
    touched = torch.zeros(cfg.table_size, dtype=torch.bool)
    touched[rows_card[differ]] = True
    touched[rows_cpu[differ]] = True
    keep = ~touched.repeat_interleave(F)
    check(torch.equal(bits(sto)[keep], bits(sto_ref)[keep]),
          f"K4 {label} stochastic: not the plain version's bits where the draws agree")
    share = float(differ.float().mean())
    err = max(float((det - det_ref).abs().max()), float((sto - sto_ref)[keep].abs().max()))
    ones = torch.ones_like(g)
    check(float(hash_encode_bwd(pos, ones, cfg, True).sum()) == n * L * F,
          f"K4 {label} stochastic did not add each gradient exactly once")
    print(f"K4 {label} N={n} L{L}xF{F}: both modes repeat bit for bit and equal the plain "
          f"version on the CPU bit for bit (stochastic: on the {int(keep.sum())} of "
          f"{keep.numel()} entries off the rows of {int(differ.sum())} of {differ.numel()} "
          f"draws ({share:.3e}) that differ between the card's sin and the CPU's, limit "
          f"{K4_DRAW_DIFFER_SHARE:g}; all of them against the plain sum over the card's draws)")
    check(share <= K4_DRAW_DIFFER_SHARE, f"K4 {label}: {share} of the draws differ")
    return err, share


def k4_times(pos, g, cfg, stochastic):
    """K4 in one mode on positions (N, 3) and g (N, L * F): its device ms
    (also by device kernel), ms per call, the plain version's and one
    PyTorch call's (zeros + index_add_ on the same precomputed rows, float
    atomics) device ms, the bound (positions and g read once, the gradient
    table zeroed and written), and the device ms with every level on each
    route (every_level_ms), which the rule's choice is held against."""
    from umhs_torch.ops.encodings import (
        HASH_BWD_ROUTES, hash_encode_bwd, hash_encode_bwd_plain, hash_indices_weights,
        stochastic_rows)
    from umhs_torch.utils.device_time import device_ms_by_kernel

    n, L, F = pos.shape[0], cfg.num_levels, cfg.features_per_level
    feat = torch.arange(F, device=pos.device)
    size = cfg.table_size * F
    if stochastic:
        flat = (stochastic_rows(pos, cfg)[..., None] * F + feat).reshape(-1)
        values = g.reshape(-1)
        flops = n * L * F
    else:
        idx, w = hash_indices_weights(pos, cfg)
        flat = (idx[..., None] * F + feat).reshape(-1)
        values = (w[..., None] * g.reshape(n, L, 1, F)).reshape(-1)
        flops = n * L * cfg.verts_per_cell * F * 2.0
        del idx, w

    def library():
        return torch.zeros(size, device=pos.device).index_add_(0, flat, values)

    b_ms, b_by = bound(n * 3 * 4 + n * L * F * 4 + size * 4, flops, H100_F32_FLOPS)
    # the rule's route against every level on each route (the same bits)
    every = {name: (name,) * L for name in HASH_BWD_ROUTES}
    with uncounted():
        route_ms = {name: device_ms(lambda: hash_encode_bwd(pos, g, cfg, stochastic, route))
                    for name, route in every.items()}
    return {
        "ms": device_ms(lambda: hash_encode_bwd(pos, g, cfg, stochastic)),
        "call_ms": median_ms(lambda: hash_encode_bwd(pos, g, cfg, stochastic)),
        "plain_ms": device_ms(lambda: hash_encode_bwd_plain(pos, g, cfg, stochastic), iters=5),
        "library_ms": device_ms(library),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "ms_by_device_kernel": device_ms_by_kernel(
            lambda: hash_encode_bwd(pos, g, cfg, stochastic)),
        "every_level_ms": route_ms,
    }


def k4_route_report(label, pos, g, cfg):
    """Each level's K4 route (hash_encode_bwd_route) in both modes, printed
    with its entries per run on these inputs: the entries that add something
    over their distinct (chunk, row) pairs, chunks of hash_encode_bwd_chunk
    samples (the runs route's; there a row's run splits further only where
    two rows of a chunk share the low 16 bits of the level-local row and
    interleave)."""
    from umhs_torch.ops.encodings import (
        hash_encode_bwd_chunk, hash_encode_bwd_route, hash_indices_weights, stochastic_rows)

    n, L, F = pos.shape[0], cfg.num_levels, cfg.features_per_level
    idx, w = hash_indices_weights(pos, cfg)  # (n, L, V)
    gl = g.reshape(n, L, F)
    report = {}
    for mode, stochastic in (("deterministic", False), ("stochastic", True)):
        route = hash_encode_bwd_route(cfg, n, stochastic)
        chunk = torch.arange(n, device=pos.device) // hash_encode_bwd_chunk(cfg, stochastic)
        drawn = stochastic_rows(pos, cfg) if stochastic else None
        per_run = []
        for lvl in range(L):
            if stochastic:
                rows, keep = drawn[:, lvl:lvl + 1], (gl[:, lvl] != 0).any(-1, keepdim=True)
            else:
                rows, keep = idx[:, lvl], ((w[:, lvl, :, None] * gl[:, lvl, None, :]) != 0).any(-1)
            key = (chunk[:, None] * cfg.table_size + rows)[keep]
            per_run.append(key.numel() / max(int(torch.unique(key).numel()), 1))
        report[mode] = {"route": list(route), "entries_per_run": per_run}
        print(f"K4 {label} {mode}: route by level {list(route)}; entries per run by level "
              + json.dumps([round(v, 3) for v in per_run]))
    return report


def k4_case(label, pos, g, cfg):
    """k4_against_cpu on one position set, then both modes timed beside
    zeros + index_add_ on the same precomputed rows, with each level's route."""
    err, differ = k4_against_cpu(label, pos, g, cfg)
    entries = {"max_abs_err": err, "stochastic_draws_differ_cpu_share": differ,
               "routes": k4_route_report(label, pos, g, cfg)}
    for mode, stochastic in (("stochastic", True), ("deterministic", False)):
        entries[mode] = k4_times(pos, g, cfg, stochastic)
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
    entries = {label: k4_case(label, p, g, cfg) for label, p in cases.items()}

    # every sample on one row per level, each row's n entries summed in one
    # lane: with unit gradients the stochastic table holds exactly n at each
    # level's chosen row, per feature
    same = torch.tensor([[0.3141, 0.5926, 0.5358]], device=dev).expand(n, 3).contiguous()
    k4_against_cpu("all positions equal", same, g, cfg)
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
                 "path's mode), the 48.8 MB table zeroed and the sort's scratch allocated in "
                 "the call; library = zeros + index_add_ on precomputed rows (float atomics, "
                 "any order); rays_* = 4,096 rays x 64 samples, ray-major",
        "rays_ms": rays["ms"],
        "rays_call_ms": rays["call_ms"],
        "rays_library_ms": rays["library_ms"],
        "rays_plain_ms": rays["plain_ms"],
        "stochastic_draws_differ_cpu_share": max(
            e["stochastic_draws_differ_cpu_share"] for e in entries.values()),
        "deterministic": entries["random"]["deterministic"],
        "rays_deterministic": entries["rays"]["deterministic"],
    }


K6_DEVICE_KERNELS = {  # the device kernels each K6 launcher runs
    "compact_stage": ("compact_stage_kernel",),
    "compact_gather": ("lanes_from_rows_kernel", "rows_from_lanes_kernel"),
    "render_weights_fwd": ("render_weights_fwd_kernel",),
    "render_weights_bwd": ("render_weights_bwd_kernel",),
    "segment_accumulate_fwd": ("segment_accumulate_fwd_kernel",),
    "segment_accumulate_bwd": ("segment_accumulate_bwd_kernel",),
}
# the K6 kernels of a forward, and those of its backward
K6_FORWARD = ("umhs_compact_stage", "umhs_compact_gather", "umhs_render_weights_fwd",
              "umhs_segment_accumulate_fwd")
K6_BACKWARD = ("umhs_render_weights_bwd", "umhs_segment_accumulate_bwd")
# K5 and K7: the occupancy grid's march (every occgrid forward) and its
# update (beside the training steps, and at setup)
MARCH_KERNELS = ("umhs_march_count", "umhs_march_emit")
OCC_KERNELS = ("umhs_occ_pack", "umhs_occ_update")
K5K7_DEVICE_KERNELS = {  # the device kernels each K5 / K7 launcher runs
    "march_count": ("march_count_kernel",),
    "march_emit": ("march_emit_kernel",),
    "occ_update": ("occ_cells_kernel", "occ_probe_kernel", "occ_ema_kernel", "occ_fold_kernel"),
    "occ_pack": ("occ_pack_kernel", "occ_threshold_kernel", "occ_pool_kernel"),
}
RENDER_KERNELS = ("umhs_mlp_fused_fwd", "umhs_hash_encode_fwd") + K6_FORWARD + MARCH_KERNELS
# the proposal sampler's render (no compact buffer: K6c only)
PROPOSAL_RENDER_KERNELS = ("umhs_mlp_fused_fwd", "umhs_hash_encode_fwd",
                           "umhs_render_weights_fwd")


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
    for sym in RENDER_KERNELS + OCC_KERNELS:  # the setup's updates and the renders
        check(launches[sym] > 0, f"kernel {sym} was not launched on the render path")
    for sym in OCC_KERNELS:
        check(launches_occ[sym] > 0, f"kernel {sym} was not launched by the occupancy update")
    profile("render", lambda: trainer.render_camera(rays, (size, size), step=1000))
    with uncounted():
        render_syncs = host_syncs(lambda: trainer.render_camera(rays, (size, size), step=1000))

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
        "host_syncs_per_render": render_syncs,
    }
    print("render: " + json.dumps(summary))
    return trainer, launches


# device kernels of each wrapper, by name (K2 launches a second, reducing kernel)
KERNEL_NAMES = {
    "umhs_mlp_fused_fwd": ("mlp_fused_fwd_kernel", "mlp_fused_fwd_tc_kernel",
                           "mlp_fused_fwd_wide_kernel"),
    "umhs_mlp_fused_bwd": ("mlp_fused_bwd_kernel", "mlp_fused_bwd_tc_kernel",
                           "mlp_fused_bwd_wide_kernel", "reduce_partials_kernel"),
    "umhs_hash_encode_fwd": ("hash_encode_fwd_kernel",),
    "umhs_hash_encode_bwd": ("emit_kernel", "run_emit_kernel", "digit_count_kernel",
                             "digit_scan_kernel", "digit_scatter_kernel",
                             "digit_scatter_walk_kernel", "row_sum_kernel",
                             "compact_runs_kernel", "run_fold_kernel"),
    **{"umhs_" + name: kernels for name, kernels in K6_DEVICE_KERNELS.items()},
    **{"umhs_" + name: kernels for name, kernels in K5K7_DEVICE_KERNELS.items()},
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
    top_kernels = [[e.key[:100], e.self_device_time_total / 1e3, e.count]
                   for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]]
    gathers = {name: sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
               for name in ("indexing_backward_kernel", "vectorized_gather_kernel")}
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us, "device_launches": n_launches,
            "kernels": ours, "top_kernels": top_kernels, "gather_kernels_ms": gathers}


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
# one training step (loss_and_grads), and a training run (its occupancy
# updates too)
STEP_KERNELS = ("umhs_hash_encode_bwd", "umhs_hash_encode_fwd", "umhs_mlp_fused_bwd",
                "umhs_mlp_fused_fwd") + K6_FORWARD + K6_BACKWARD + MARCH_KERNELS
TRAIN_KERNELS = STEP_KERNELS + OCC_KERNELS
PROPOSAL_TRAIN_KERNELS = ("umhs_hash_encode_bwd", "umhs_hash_encode_fwd", "umhs_mlp_fused_bwd",
                          "umhs_mlp_fused_fwd", "umhs_render_weights_fwd",
                          "umhs_render_weights_bwd")


def path_kernels(model_config, train: bool):
    """The kernels a training step (train) or a render of `model_config`
    launches: the occupancy grid's compact path runs K1-K6 (K5 the march),
    the proposal sampler K1-K4 and K6c."""
    if model_config.sampler == "proposal":
        return PROPOSAL_TRAIN_KERNELS if train else PROPOSAL_RENDER_KERNELS
    return STEP_KERNELS if train else RENDER_KERNELS


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
    state48 = {k: v.cpu() for k, v in trainer.state_tensors().items()}  # for phase 11a
    repeat = repeat_train(trainer, dev, dm, endmembers, losses)
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
        "repeat": repeat,
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
    return trainer, launches, summary, state48


def repeat_train(trainer, dev, dm, endmembers, losses):
    """train(TRAIN_STEPS) once more from seed 0, beside the main path (its
    launches uncounted): every loss and every state tensor must equal the
    first run's bit for bit (K4 sums in a fixed order)."""
    from umhs_torch.engine.trainer import Trainer, TrainerConfig

    with uncounted():
        again = Trainer(TrainerConfig(seed=0, mixed_precision=True, save_final=False),
                        flagship_model_config(), num_classes=6, device=dev, datamanager=dm)
        again.setup(endmembers)
        again.train(TRAIN_STEPS)
    losses_again = [r["metrics"]["loss/total"] for r in again.history]
    parted = next((i for i, (x, y) in enumerate(zip(losses, losses_again)) if x != y), None)
    a, b = trainer.state_tensors(), again.state_tensors()
    differ = sorted(k for k in a if not (
        torch.equal(bits(a[k]), bits(b[k])) if a[k].is_floating_point()
        else torch.equal(a[k].cpu(), b[k].cpu())))
    out = {"identical_losses": parted is None and len(losses) == len(losses_again),
           "first_step_apart": parted, "state_tensors_differing": differ}
    print(f"train({TRAIN_STEPS}) repeated from seed 0: " + json.dumps(out))
    check(out["identical_losses"], f"train({TRAIN_STEPS}) repeated from seed 0 parts at step "
                                   f"{parted}")
    check(not differ, f"train({TRAIN_STEPS}) repeated from seed 0 ends in other bits: {differ}")
    del again, a, b
    return out


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


# the kernel-vs-plain training step (phase 6): see phase_train_vs_plain.
# Tolerances by compute dtype: (gradients in norm, loss). In bf16 both paths
# round at the same points (x, W, every hidden activation to bf16; sums and
# biases in f32), so they part only where a sum taken in another order rounds
# an activation to the neighbouring bf16 value (2^-8 relative) or puts a
# pre-activation within rounding of 0 on the other side of the ReLU; spread
# over a step's ~10^5 samples that stays far below one bf16 ulp in norm.
VS_PLAIN_DRAWS = 3
VS_PLAIN_RTOL = {"float32": (1e-3, 1e-5), "bfloat16": (1e-2, 1e-3)}
SPREAD_FACTOR = 4.0
# no single draw may read more than this many times its tolerance: over 31
# draws at nerfacto's state (NVIDIA H100 80GB HBM3, 700 W) the largest was
# 30.1 (its interlevel loss; the rgb loss read 13.0 on that draw)
VS_PLAIN_DRAW_CAP = 100.0


def step_grads(trainer, dev, draws, impl, moved_seed=None, dtype="float32"):
    """Loss terms, gradients, stage count and final bins of one training
    step from `trainer`'s state at its current shapes, in `dtype` (the MLPs'
    compute dtype) with the deterministic hash gradient, from the parameters
    moved one ulp if `moved_seed` is given. The loss terms are floats by
    name, their sum under "total"; the final bins are the proposal
    sampler's final_edges (None for the occupancy grid's march). The kernel
    run must launch K1-K4 and the plain run none."""
    from umhs_torch.engine.trainer import Trainer, TrainerConfig, named_leaves

    cfg = dataclasses.replace(trainer.model.config, compute_dtype=dtype,
                              stochastic_hash_grad=False, impl=impl)
    t = Trainer(TrainerConfig(seed=0, mixed_precision=dtype == "bfloat16"), cfg,
                num_classes=trainer.model.num_classes, device=dev, datamanager=trainer.datamanager)
    state = trainer.state
    if moved_seed is not None:
        state = dict(state, params=moved_one_ulp(state["params"], moved_seed, dev))
    t.state, t.dyn = state, trainer.dyn
    before = launch_counts()
    total, loss_dict, outputs, _ = t.loss_and_grads(draws)
    torch.cuda.synchronize()
    ran = sorted(k for k, v in launch_counts().items() if v > before[k])
    want = sorted(path_kernels(cfg, train=True)) if impl == "auto" else []
    check(ran == want, f"{impl} training step launched {ran}, expected {want}")
    # a parameter that the config leaves out of the graph (mlp_directional
    # without the specular residual) has no gradient on either path
    grads = {n: p.grad.clone() for n, p in named_leaves(state["params"]) if p.grad is not None}
    for _, p in named_leaves(state["params"]):
        p.grad = None
    terms = {k: float(v.detach()) for k, v in loss_dict.items()}
    terms["total"] = float(total.detach())
    edges = outputs.get("final_edges")
    return (terms, grads, sum(1 for k in outputs if k.startswith("num_eval_s")),
            None if edges is None else edges.detach())


def phase_train_vs_plain(trainer, dev, label, dtype="float32"):
    """One training step from `trainer`'s state at its current shapes
    (rays, samples per ray, stage budgets), with the kernels and with the
    plain versions, in `dtype` (f32, or bf16 MLPs: the tensor-core K1 and
    K2) with the deterministic hash gradient, same draws.

    Two checks. (1) The kernel run, repeated, gives the same loss and the
    same bits in every gradient, the hash table's too (K4 sums in a fixed
    order): no kernel races. (2) On each of VS_PLAIN_DRAWS draws of the
    step, the plain step also runs from the parameters moved one ulp, and
    each gradient with the kernels must lie within VS_PLAIN_RTOL[dtype][0]
    of the plain one in norm, plus SPREAD_FACTOR times the norm of the moved
    plain run's change (each loss term and their sum: within
    VS_PLAIN_RTOL[dtype][1] plus SPREAD_FACTOR times its change). Each
    passes on its median over the draws, and no draw may read more than
    VS_PLAIN_DRAW_CAP times its tolerance.

    Why in norm and over draws: near convergence the gradients are sums of
    ~10^5 terms that nearly cancel, and now and then f32 rounding puts a
    ReLU on the other side for a sample with a large gradient. The plain
    path against itself, moved one ulp, crosses an elementwise rtol 1e-3
    (atol 1e-4 x max) on many draws (the endmembers), and such an event
    moves feature_mlp's gradient and every one upstream of it at once, on
    either side (PERF.md, section 6). With the proposal sampler the final
    bin edges also jump where a quantile falls on a flat stretch of the
    proposal CDF, in the kernel run and in the moved plain run alike, and
    every loss term moves with them. An event falls on one draw; a fault
    of the kernels or of their wiring shows on every draw. The elementwise
    readings of the kernels and of the moved plain run are printed beside,
    with each loss term's change in both runs and, for the proposal
    sampler, the largest shift of a final bin edge in both. Returns the
    readings."""
    gen_state = trainer._step_gen.get_state()
    draws = [trainer.draw_step() for _ in range(VS_PLAIN_DRAWS)]
    trainer._step_gen.set_state(gen_state)  # the trainer's own stream goes on unchanged
    rtol, loss_rtol = VS_PLAIN_RTOL[dtype]
    term_r, term_d, grad_r, elem_k, elem_m, shifts = [], [], [], [], [], []
    for i, d in enumerate(draws):
        la, ga, stages, ea = step_grads(trainer, dev, d, "auto", dtype=dtype)
        if i == 0:
            la2, ga2, _, _ = step_grads(trainer, dev, d, "auto", dtype=dtype)
            same = la2 == la and all(torch.equal(bits(ga2[n]), bits(g)) for n, g in ga.items())
            check(same, f"{label}: the kernel step, repeated, gave other bits")
            del ga2
        lp, gp, _, ep = step_grads(trainer, dev, d, "plain", dtype=dtype)
        lm, gm, _, em_ = step_grads(trainer, dev, d, "plain", moved_seed=i + 1, dtype=dtype)
        check(sorted(ga) == sorted(gp) == sorted(gm),
              f"{label}: the kernels' step reached other parameters than the plain one's: "
              f"{sorted(set(ga) ^ set(gp))}")
        check(np.isfinite(la["total"]), f"{label}: non-finite loss with kernels")
        term_r.append({k: abs(la[k] - lp[k]) / (loss_rtol * abs(lp[k])
                                                 + SPREAD_FACTOR * abs(lm[k] - lp[k]) + 1e-30)
                       for k in lp})
        term_d.append({k: [la[k] - lp[k], lm[k] - lp[k]] for k in lp})
        if ea is not None:
            shifts.append([float((ea - ep).abs().max()), float((em_ - ep).abs().max())])
        ratio, ek, em = {}, {}, {}
        for name, g in ga.items():
            ref, moved = gp[name], gm[name]
            ratio[name] = float((g - ref).norm()) / (
                rtol * float(ref.norm()) + SPREAD_FACTOR * float((moved - ref).norm()) + 1e-30)
            fixed = 1e-3 * ref.abs() + 1e-4 * float(ref.abs().max()) + 1e-30
            ek[name] = float(((g - ref).abs() / fixed).max())
            em[name] = float(((moved - ref).abs() / fixed).max())
        grad_r.append(ratio)
        elem_k.append(ek)
        elem_m.append(em)
        del ga, gp, gm, ea, ep, em_

    def worst(d):
        name = max(d, key=d.get)
        return [d[name], name]

    loss_med = {k: float(np.median([r[k] for r in term_r])) for k in term_r[0]}
    grad_med = {n: float(np.median([r[n] for r in grad_r])) for n in grad_r[0]}
    out = {
        "dtype": dtype,
        "shapes": {"rays": trainer.dyn.rays, "samples_per_ray": trainer.dyn.march.num_samples,
                   "budgets": list(trainer.dyn.budgets), "stages_reported": stages},
        "loss_over_tolerance": [r["total"] for r in term_r],
        "loss_terms_over_tolerance_per_draw": term_r,
        "loss_terms_kernels_and_moved_minus_plain_per_draw": term_d,
        "worst_over_tolerance_per_draw": [worst(r) for r in grad_r],
        "worst_median_over_tolerance": worst(grad_med),
        "elementwise_kernels_per_draw": [worst(r) for r in elem_k],
        "elementwise_plain_moved_per_draw": [worst(r) for r in elem_m],
    }
    if shifts:
        out["final_edge_shift_kernels_and_moved_per_draw"] = shifts
    print(f"train step kernels vs plain, {label} ({dtype}, deterministic hash gradient, "
          f"{len(draws)} draws): " + json.dumps(out))
    for name, r in [*loss_med.items(), *grad_med.items()]:
        check(r <= 1.0, f"{label}: {name} with kernels disagrees with the plain path "
                        f"({r} of its tolerance, median of the draws)")
    for i, (tr, gr) in enumerate(zip(term_r, grad_r)):
        for name, r in [*tr.items(), *gr.items()]:
            check(r <= VS_PLAIN_DRAW_CAP, f"{label}: {name} with kernels disagrees with the "
                                          f"plain path on draw {i} ({r} of its tolerance)")
    return out


def phase_p1(dev):
    """P1, the row gather: the probe twin's check, bit for bit against
    table[idx] on both tables at the probe's N and at the edge N; then the
    probe twin's measurement (its entry point, the kernel's only path) with
    the launch counts zeroed before and read after: the kernel and
    index_select, timed the same way and in turns, warm and cold, with the
    device kernels each arm launched listed by name; then the plain
    version's device time."""
    from umhs_torch.ops.row_gather import (
        ROW_GATHER, _blocks_per_sm, row_gather, row_gather_plain)
    from umhs_torch.probes import gather as probe

    T, FT, N = probe.PROBE_TABLE_ROWS, probe.FLAGSHIP_TABLE_ROWS, probe.PROBE_ROWS
    for line in probe.check(dev):  # raises on a mismatch
        print(f"P1 {line}")
    zero_launch_counts()
    results = {label: probe.measure(rows, N, dev)
               for label, rows in (("probe_table", T), ("flagship_table", FT))}
    launches = ROW_GATHER.launches
    check(launches > 0, "the probe twin did not launch P1")
    blocks_per_sm = _blocks_per_sm(dev)
    print(f"P1: {blocks_per_sm} blocks of row_gather_kernel resident per SM")
    arms = ["kernel", "library"]
    for label, r in results.items():
        print(f"P1 {label} ({r['table_rows']:,} x 2 f32, {N:,} rows): bound {r['bound_ms']:.4f} "
              f"ms, one sector per row {r['sector_bound_ms']:.4f} ms")
        for arm in arms:
            for l2 in ("warm", "cold"):
                p = arm if l2 == "warm" else f"{arm}_cold"
                events = (f", events {r[p + '_batch_ms']:.4f} ms per call" if l2 == "warm"
                          else "")
                if r[p + "_ms"] is None:
                    print(f"  {arm:<8} {l2}: device not measured (every profile lost "
                          f"events){events}")
                    continue
                print(f"  {arm:<8} {l2}: device {r[p + '_ms']:.4f} ms{events}; kernels "
                      + json.dumps({k: round(v, 4) for k, v in r[p + "_kernels"].items()}))
    table, idx = probe.make_case(T, N, dev)
    with uncounted():
        ms = device_ms(lambda: row_gather(table, idx))
        library_ms = device_ms(lambda: torch.index_select(table, 0, idx))
    plain_ms = device_ms(lambda: row_gather_plain(table, idx))
    main = results["probe_table"]
    return {
        "name": "row_gather",
        "route": "cuda",
        "source": "umhs_torch/csrc/row_gather.cu",
        "replaces": "scripts/probe_pallas_gather.py:39",
        "max_abs_err": 0.0,
        "ms": ms,
        "call_ms": main["kernel_batch_ms"],
        "probe_ms": main["kernel_ms"],
        "cold_ms": main["kernel_cold_ms"],
        "plain_ms": plain_ms,
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": library_ms,
        "probe_library_ms": main["library_ms"],
        "library_cold_ms": main["library_cold_ms"],
        "launches": launches,
        "launches_train": 0,
        "launches_render": 0,
        "ns_per_row": main["kernel_ns_per_row"],
        "sector_bound_ms": main["sector_bound_ms"],
        "blocks_per_sm": blocks_per_sm,
        "shape": f"table {T:,} x 2 f32 (96 MB), {N:,} int32 indices; launches = the probe "
                 "twin's run (its path); library = torch.index_select; ms and library_ms "
                 "by device_ms, probe_* and *cold_ms the probe twin's (torch.profiler)",
        "flagship_table": {k: v for k, v in results["flagship_table"].items()
                           if not k.endswith("_kernels")},
    }


# ------------------------------------------------------------------- K6
# phase 7's steady step (PERF.md section 5): 79,360 rays of 64 lanes in three
# stages with these budgets, and the heads the flagship accumulates per stage
K6_RAYS, K6_SAMPLES = 79_360, 64
K6_STAGES = ((0, 8), (8, 16), (16, 64))
K6_BUDGETS = (179_200, 103_936, 93_440)
K6_HEADS = {"spectral": 128, "spectral2": 128, "specular": 128, "abundances": 6}
K6_ALPHA_THRE, K6_EPS = 0.01, 1e-4  # the model's filters (its alpha_thre, early_stop_eps)
# K6c at nerfacto's shapes: its 8192 rays at the proposal levels' and the
# main field's samples per ray
K6C_PROPOSAL_SAMPLES = (256, 96, 48)
# the kernels' error against f64 may exceed the plain version's by at most:
# K6c's weights (in [0, 1]) 1e-6; its gradients and K6d's outputs and
# gradients 1e-5 and 1e-6 of the reference's largest entry (f32 rounding of
# sums the kernels take in another, shorter order)
K6_TOL = {"weights": 1e-6, "render_grad": 1e-5, "accumulate": 1e-6}
K6_ENTRIES = {  # name: (source, the XLA code on the TPU it replaces)
    "compact_stage": ("umhs_torch/csrc/compact.cu", "umhs_tpu/models/model.py:440"),
    "compact_gather": ("umhs_torch/csrc/compact.cu", "umhs_tpu/models/model.py:483"),
    "render_weights_fwd": ("umhs_torch/csrc/composite.cu", "umhs_tpu/ops/compositing.py:34"),
    "render_weights_bwd": ("umhs_torch/csrc/composite.cu", "umhs_tpu/ops/compositing.py:34"),
    "segment_accumulate_fwd": ("umhs_torch/csrc/composite.cu", "umhs_tpu/ops/compositing.py:84"),
    "segment_accumulate_bwd": ("umhs_torch/csrc/composite.cu", "umhs_tpu/ops/compositing.py:84"),
}


def k6_inputs(dev, seed=13):
    """Phase 7-like lanes: 30% of the rays hold a valid prefix of 1 to 64
    lanes (the others none), dt in [1, 5] mm from t = 0.2, densities
    exponential with mean 20; the rays alive after stage 1 (70%) and 2
    (40%). The budgets overflow in each stage, as adapts allow."""
    gen = torch.Generator().manual_seed(seed)
    R, S = K6_RAYS, K6_SAMPLES
    n = torch.randint(1, S + 1, (R,), generator=gen)
    n = torch.where(torch.rand(R, generator=gen) < 0.3, n, torch.zeros_like(n))
    dt = torch.rand((R, S), generator=gen) * 0.004 + 0.001
    te = 0.2 + torch.cumsum(dt, 1)
    alive = [None, torch.rand(R, generator=gen) < 0.7, torch.rand(R, generator=gen) < 0.4]
    return {"mask": (torch.arange(S)[None, :] < n[:, None]).to(dev), "ts": (te - dt).to(dev),
            "te": te.to(dev), "sigma": (-20.0 * torch.log1p(-torch.rand((R, S), generator=gen)))
            .to(dev), "alive": [a if a is None else a.to(dev) for a in alive]}


def k6_render_reference(ts, te, sg, m, thre, eps):
    """render_weights in f64 with the alpha and early-stop decisions of the
    plain version in f32 (a lane within rounding of a threshold falls
    either way in f32; the reference holds the arithmetic): the weights and
    the leaves (ts, te, sg) in f64 for autograd."""
    with torch.no_grad():
        delta = torch.clamp_min(te - ts, 0.0)
        x = torch.where(m, sg * delta, torch.zeros_like(sg))
        a = 1.0 - torch.exp(-x)
        use = not (isinstance(thre, float) and thre <= 0.0)
        keep = (m & (a >= thre)) if use else torch.ones_like(m)
        x = torch.where(keep, x, torch.zeros_like(x))
        alive = (torch.exp(-(torch.cumsum(x, -1) - x)) >= eps) if eps > 0 else torch.ones_like(m)
    leaves = [t.double().requires_grad_(True) for t in (ts, te, sg)]
    delta = torch.clamp_min(leaves[1] - leaves[0], 0.0)
    x = torch.where(m, leaves[2] * delta, torch.zeros_like(delta))
    a = torch.where(keep & alive, 1.0 - torch.exp(-x), torch.zeros_like(x))
    x = torch.where(keep, x, torch.zeros_like(x))
    return a * torch.exp(-(torch.cumsum(x, -1) - x)), leaves


def k6_plain_ms(fn) -> float:
    """A plain version's ms per call: its device time held behind a spin
    (held_ms), or, when a call waits for the device (the plain compaction's
    `nonzero`, the plain march's and update's copies of constants from the
    host), CUDA events around each call (median_ms), which then count that
    wait: the profiler's reading (device_ms) refuses the plain compaction,
    one of whose kernels runs in 9 calls of 10, and the plain positions."""
    ms = held_ms(fn, 10)
    return ms if ms is not None else median_ms(fn)


def k6_err(x, ref):
    return float((x.detach().double() - ref).abs().max())


def k6_render_case(label, ts, te, sg, m, thre, eps, need_t):
    """K6c forward and backward against the plain version and the f64
    reference on the card, bit for bit when run again; times."""
    from umhs_torch.ops.compositing import (
        render_weights, render_weights_bwd_cuda, render_weights_cuda, render_weights_plain)

    g = torch.randn(sg.shape, device=sg.device, generator=torch.Generator(sg.device).manual_seed(7))
    need = (True, need_t, need_t)
    w = render_weights_cuda(ts, te, sg, m, thre, eps)
    grads = render_weights_bwd_cuda(ts, te, sg, m, thre, eps, g, need)
    check(torch.equal(w, render_weights_cuda(ts, te, sg, m, thre, eps)),
          f"K6c {label}: a second forward gave other bits")
    check(all(a is None or torch.equal(a, b) for a, b in zip(
        grads, render_weights_bwd_cuda(ts, te, sg, m, thre, eps, g, need))),
        f"K6c {label}: a second backward gave other bits")
    leaves = [ts.clone().requires_grad_(need_t), te.clone().requires_grad_(need_t),
              sg.clone().requires_grad_(True)]
    wp = render_weights(*leaves, m, thre, eps, impl="plain")
    pgrads = torch.autograd.grad(wp, leaves[::-1][:1] + (leaves[:2] if need_t else []), g,
                                 retain_graph=True)
    ref, refs = k6_render_reference(ts, te, sg, m, thre, eps)
    rgrads = torch.autograd.grad(ref, refs[::-1][:1] + (refs[:2] if need_t else []), g.double())
    errs = {"weights": (k6_err(w, ref), k6_err(wp, ref))}
    for name, a, p, r in zip(("sigmas", "t_starts", "t_ends"), [x for x in grads if x is not None],
                             pgrads, rgrads):
        errs[name] = (k6_err(a, r), k6_err(p, r), float(r.abs().max()))
    check(errs["weights"][0] <= errs["weights"][1] + K6_TOL["weights"],
          f"K6c {label}: weights err {errs['weights']} against f64")
    for name, (e, pe, scale) in ((k, v) for k, v in errs.items() if k != "weights"):
        check(e <= pe + K6_TOL["render_grad"] * scale,
              f"K6c {label}: d{name} err {e} against f64, the plain version's {pe}")
    R, S = sg.shape
    nbytes_fwd = R * S * (3 * 4 + 1 + 4)
    nbytes_bwd = R * S * (3 * 4 + 1 + 4 + 4 * sum(need))
    times = {
        "fwd_ms": device_ms(lambda: render_weights_cuda(ts, te, sg, m, thre, eps)),
        "fwd_call_ms": median_ms(lambda: render_weights_cuda(ts, te, sg, m, thre, eps)),
        "bwd_ms": device_ms(lambda: render_weights_bwd_cuda(ts, te, sg, m, thre, eps, g, need)),
        "bwd_call_ms": median_ms(
            lambda: render_weights_bwd_cuda(ts, te, sg, m, thre, eps, g, need)),
        "plain_fwd_ms": k6_plain_ms(lambda: render_weights_plain(ts, te, sg, m, thre, eps)),
        "plain_bwd_ms": k6_plain_ms(lambda: torch.autograd.grad(
            wp, leaves[::-1][:1] + (leaves[:2] if need_t else []), g, retain_graph=True)),
        "fwd_bound_ms": nbytes_fwd / H100_BYTES_PER_S * 1e3,
        "bwd_bound_ms": nbytes_bwd / H100_BYTES_PER_S * 1e3,
    }
    del wp
    out = {"shape": [R, S], "errors_kernel_plain": errs, **times}
    print(f"K6c {label} ({R} x {S}): " + json.dumps(out))
    return out


def phase_k6(dev, ptxas):
    """K6a-K6d against their plain versions at phase 7's steady shapes (and
    K6c at nerfacto's), each repeated bit for bit, with device ms, ms per
    call, the plain version's device ms, one PyTorch call's where one
    exists, and the bound by bytes. K6a and K6b bit for bit against the
    plain versions; K6c and K6d held with the plain version to f64 (K6_TOL)."""
    from umhs_torch.ops.compact import (
        compact_stage, compact_stage_plain, gather_lanes_plain, lanes_from_rows_cuda,
        rows_from_lanes_cuda)
    from umhs_torch.ops.compositing import (
        compact_accumulate_cuda, compact_accumulate_stages_bwd_cuda,
        compact_accumulate_stages_cuda, compact_accumulate_stages_plain)

    k6_ptxas = {name: {k: v for k, v in ptxas.items() if k.split("<")[0] in kernels}
                for name, kernels in K6_DEVICE_KERNELS.items()}
    for name, usage in k6_ptxas.items():
        print(f"K6 {name} ptxas: " + json.dumps(usage))
    x = k6_inputs(dev)
    gen = torch.Generator(dev).manual_seed(8)
    R, S = K6_RAYS, K6_SAMPLES
    a = {k: 0.0 for k in ("ms", "call_ms", "plain_ms", "bound_bytes")}
    b = dict(a)
    d_fwd, d_bwd = dict(a), dict(a)
    d_fwd["library_ms"] = 0.0
    d_err = {"fwd": [], "bwd": []}
    stages, comps, totals = [], [], []
    for (lo, hi), Bs, alive in zip(K6_STAGES, K6_BUDGETS, x["alive"]):
        L = hi - lo
        m = x["mask"][:, lo:hi]
        c = compact_stage(m, alive, Bs)
        again = compact_stage(m, alive, Bs)
        ref = compact_stage_plain(m, alive, Bs)
        torch.cuda.synchronize()
        for k in ("slot", "mask", "src", "live", "counts", "starts"):
            check(torch.equal(getattr(c, k), getattr(ref, k)),
                  f"K6a stage {lo}-{hi}: {k} differs from the plain version")
            check(torch.equal(getattr(c, k), getattr(again, k)), f"K6a: {k} not repeated")
        total = int(c.total)
        check(total == ref.total, f"K6a stage {lo}-{hi}: total {total} against {ref.total}")
        totals.append(total)
        a["ms"] += device_ms(lambda: compact_stage(m, alive, Bs))
        a["call_ms"] += median_ms(lambda: compact_stage(m, alive, Bs))
        a["plain_ms"] += k6_plain_ms(lambda: compact_stage_plain(m, alive, Bs))
        a["bound_bytes"] += R * L * (1 + 4 + 1) + R + Bs * (8 + 4) + R * 16 + 4

        rows = torch.randn(Bs, device=dev, generator=gen).requires_grad_(True)
        gl = torch.randn((R, L), device=dev, generator=gen)
        lanes = lanes_from_rows_cuda(rows.detach(), c)
        plain = gather_lanes_plain(rows, c)
        check(torch.equal(lanes, plain), f"K6b stage {lo}-{hi}: lanes differ from the plain")
        back = rows_from_lanes_cuda(gl, c)
        (pback,) = torch.autograd.grad(plain, rows, gl, retain_graph=True)
        check(torch.equal(back, pback), f"K6b stage {lo}-{hi}: rows differ from the plain "
                                        "gather's gradient")
        check(torch.equal(back, rows_from_lanes_cuda(gl, c)), "K6b: rows not repeated")
        b["ms"] += device_ms(lambda: lanes_from_rows_cuda(rows.detach(), c))
        b["ms"] += device_ms(lambda: rows_from_lanes_cuda(gl, c))
        b["call_ms"] += median_ms(lambda: lanes_from_rows_cuda(rows.detach(), c))
        b["call_ms"] += median_ms(lambda: rows_from_lanes_cuda(gl, c))
        b["plain_ms"] += k6_plain_ms(lambda: gather_lanes_plain(rows.detach(), c))
        b["plain_ms"] += k6_plain_ms(lambda: torch.autograd.grad(plain, rows, gl,
                                                               retain_graph=True))
        b["bound_bytes"] += R * L * (4 + 1 + 4) + total * 4 + Bs * (8 + 4) + total * 4
        del plain

        comps.append(c)
        stages.append({"lanes": [lo, hi], "budget": Bs, "total": total,
                       "dropped": int(compact_stage_plain(m, alive, 1 << 30).total) - total})

    # K6d: a launch a head over the three stages (the model's accumulate_fn)
    w = torch.rand((R, S), device=dev, generator=gen)
    for head, C in K6_HEADS.items():
        hs = [torch.randn((c.src.shape[0], C), device=dev, generator=gen) for c in comps]
        g = torch.randn((R, C), device=dev, generator=gen)
        heads = [(lo, hi, h, c) for (lo, hi), h, c in zip(K6_STAGES, hs, comps)]
        out = compact_accumulate_stages_cuda(w, heads)
        check(torch.equal(out, compact_accumulate_stages_cuda(w, heads)),
              "K6d: forward not repeated")
        singles = [compact_accumulate_cuda(w[:, lo:hi], h, c) for lo, hi, h, c in heads]
        check(torch.equal(out, singles[0] + singles[1] + singles[2]),
              f"K6d {head}: the stages' launch is not the single-stage calls added in stage order")
        dw, dh = compact_accumulate_stages_bwd_cuda(w, heads, g)
        dw2, dh2 = compact_accumulate_stages_bwd_cuda(w, heads, g)
        check(torch.equal(dw, dw2) and all(torch.equal(a, b) for a, b in zip(dh, dh2)),
              "K6d: backward not repeated")
        wp = w.clone().requires_grad_(True)
        hp = [h.clone().requires_grad_(True) for h in hs]
        outp = compact_accumulate_stages_plain(
            wp, [(lo, hi, h, c) for (lo, hi), h, c in zip(K6_STAGES, hp, comps)])
        dwp, *dhp = torch.autograd.grad(outp, [wp] + hp, g, retain_graph=True)
        w64 = w.double().requires_grad_(True)
        h64 = [h.double().requires_grad_(True) for h in hs]
        ref = compact_accumulate_stages_plain(
            w64, [(lo, hi, h, dataclasses.replace(c, live=c.live.double()))
                  for (lo, hi), h, c in zip(K6_STAGES, h64, comps)])
        dw64, *dh64 = torch.autograd.grad(ref, [w64] + h64, g.double())
        for kind, triples in (("fwd", [(out, outp, ref)]),
                              ("bwd", list(zip(dh, dhp, dh64)) + [(dw, dwp, dw64)])):
            for k, p, r in triples:
                e, pe, scale = k6_err(k, r), k6_err(p, r), float(r.abs().max())
                d_err[kind].append((e, pe, scale))
                check(e <= pe + K6_TOL["accumulate"] * scale,
                      f"K6d {kind} {head}: err {e} against f64, the plain version's {pe} "
                      f"(largest entry {scale})")
        wvs = [((w[:, lo:hi].reshape(-1)[c.src] * c.live)[:t, None] * h[:t], c.counts)
               for (lo, hi), h, c, t in zip(K6_STAGES, hs, comps, totals)]
        d_fwd["ms"] += device_ms(lambda: compact_accumulate_stages_cuda(w, heads))
        d_fwd["call_ms"] += median_ms(lambda: compact_accumulate_stages_cuda(w, heads))
        d_fwd["plain_ms"] += k6_plain_ms(lambda: compact_accumulate_stages_plain(w, heads))
        d_fwd["library_ms"] += sum(k6_plain_ms(
            lambda: torch.segment_reduce(wv, "sum", lengths=n)) for wv, n in wvs)
        # each stage's rows (C values, src, the weight) and its starts and
        # counts read once, out written once
        d_fwd["bound_bytes"] += R * C * 4 + sum(t * (C * 4 + 12) + R * 16 for t in totals)
        d_bwd["ms"] += device_ms(lambda: compact_accumulate_stages_bwd_cuda(w, heads, g))
        d_bwd["call_ms"] += median_ms(lambda: compact_accumulate_stages_bwd_cuda(w, heads, g))
        d_bwd["plain_ms"] += k6_plain_ms(lambda: torch.autograd.grad(
            outp, [wp] + hp, g, retain_graph=True))
        d_bwd["bound_bytes"] += sum(t * (C * 4 + 4 + 8) + c.src.shape[0] * C * 4 + R * C * 4
                                    + R * (hi - lo) * 4
                                    for (lo, hi), c, t in zip(K6_STAGES, comps, totals))
        del outp, wvs, ref
    print("K6 stages at phase 7's steady shapes: " + json.dumps(stages))
    thre = torch.tensor(K6_ALPHA_THRE, device=dev)  # as the model passes min(0.01, mean occs)
    sigma_all = x["sigma"]
    render = {"flagship": k6_render_case("phase 7", x["ts"], x["te"], sigma_all, x["mask"],
                                         thre, K6_EPS, need_t=False)}
    for S_p in K6C_PROPOSAL_SAMPLES:
        R_p = NERFACTO_RAYS
        gp = torch.Generator().manual_seed(S_p)
        dt = torch.rand((R_p, S_p), generator=gp) * 0.01 + 1e-4
        te = (0.05 + torch.cumsum(dt, 1)).to(dev)
        ts = te - dt.to(dev)
        sg = (-5.0 * torch.log1p(-torch.rand((R_p, S_p), generator=gp))).to(dev)
        ones = torch.ones((R_p, S_p), dtype=torch.bool, device=dev)
        render[f"nerfacto_{S_p}"] = k6_render_case(f"nerfacto {S_p}", ts, te, sg, ones, 0.0, 0.0,
                                                   need_t=True)
    rf = render["flagship"]
    errs = rf["errors_kernel_plain"]

    def entry(name, t, err, shape, bound_bytes=None, bound_ms=None, **extra):
        source, replaces = K6_ENTRIES[name]
        b_ms = bound_ms if bound_ms is not None else bound_bytes / H100_BYTES_PER_S * 1e3
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "max_abs_err": err, "ms": t["ms"], "call_ms": t["call_ms"],
                "plain_ms": t["plain_ms"], "library_ms": t.get("library_ms"),
                "bound_ms": b_ms, "bound_by": "bytes", "shape": shape,
                "ptxas": k6_ptxas[name], **extra}

    stage_shape = ("phase 7's steady step: 79,360 rays x 64 lanes, stages 0-8, 8-16, 16-64 "
                   "with budgets 179,200 / 103,936 / 93,440, summed over the stages")
    entries = [
        entry("compact_stage", a, 0.0, stage_shape, a["bound_bytes"]),
        entry("compact_gather", b, 0.0, stage_shape + "; lanes from rows and rows from lanes",
              b["bound_bytes"]),
        entry("render_weights_fwd", {"ms": rf["fwd_ms"], "call_ms": rf["fwd_call_ms"],
                                     "plain_ms": rf["plain_fwd_ms"]},
              errs["weights"][0], "79,360 x 64 lanes, alpha_thre a tensor, eps 1e-4",
              bound_ms=rf["fwd_bound_ms"], plain_max_abs_err=errs["weights"][1],
              at_nerfacto_shapes={k: v for k, v in render.items() if k != "flagship"}),
        entry("render_weights_bwd", {"ms": rf["bwd_ms"], "call_ms": rf["bwd_call_ms"],
                                     "plain_ms": rf["plain_bwd_ms"]},
              errs["sigmas"][0], "as the forward; d sigmas only (the march's t take no "
              "gradient); plain = autograd of the plain forward", bound_ms=rf["bwd_bound_ms"],
              plain_max_abs_err=errs["sigmas"][1],
              at_nerfacto_shapes={k: {x: v[x] for x in ("bwd_ms", "bwd_bound_ms",
                                                        "plain_bwd_ms")}
                                  for k, v in render.items() if k != "flagship"}),
        entry("segment_accumulate_fwd", d_fwd, max(e for e, _, _ in d_err["fwd"]),
              stage_shape + ", heads spectral, spectral2, specular (128) and abundances (6), "
              "f32, a launch a head over the three stages, summed over the heads; library = "
              "torch.segment_reduce(sum, lengths=counts) on w * h precomputed, a call a stage "
              "and head", d_fwd["bound_bytes"],
              plain_max_abs_err=max(p for _, p, _ in d_err["fwd"])),
        entry("segment_accumulate_bwd", d_bwd, max(e for e, _, _ in d_err["bwd"]),
              "as the forward; dh and dw, a launch a stage into one zeroed (R, S) dw; plain = "
              "autograd of the plain forward",
              d_bwd["bound_bytes"], plain_max_abs_err=max(p for _, p, _ in d_err["bwd"])),
    ]
    for e in entries:
        print(f"K6 {e['name']}: " + json.dumps(e))
    return entries


# K5 and K7 at the flagship's shapes (phase_k5k7)
K5K7_ENTRIES = {  # name: (source, the XLA code on the TPU it replaces)
    "march_count": ("umhs_torch/csrc/march.cu", "umhs_tpu/ops/ray_marching.py:250"),
    "march_emit": ("umhs_torch/csrc/march.cu", "umhs_tpu/ops/ray_marching.py:168"),
    "occ_update": ("umhs_torch/csrc/occupancy.cu", "umhs_tpu/ops/occupancy.py:347"),
    "occ_pack": ("umhs_torch/csrc/occupancy.cu", "umhs_tpu/ops/occupancy.py:439"),
}
K5_BUDGET = sum(K6_BUDGETS)  # phase 7's steady stage budgets, 376,576 samples
# K5a's bound by operations: f32 operations a candidate the ray needs (the
# schedule: 2 mul, add, sub, exp, compare and 2 for dt; the midpoint: 8; the
# cell: 3 sub, 3 div, 3 abs, 2 max, the clamp, log2, ceil, 2 clamps, the
# compare; per axis mul, add, mul, mul, floor, 2 clamps; the bit: ~8 integer
# ops) and a ray's own (the slab test's 3 div, 6 sub, 6 mul, 8 min and max;
# t0, the schedule's set-up, the counts' scans)
K5A_OPS_CANDIDATE, K5A_OPS_RAY = 60, 48
K5_OD_MAX = 0.5  # the od culling's threshold in the K5 phase's od case
K5_OD_NEAR = 1e-5  # a candidate whose od lies this close (relative) to od_max may go either way


def bench_sphere_density(dev):
    """A density like the bench scene's trained field: ~200 inside its six
    spheres, falling to 0 over ~2 cm across their surfaces."""
    from umhs_torch.data.synthetic import BENCH_SCENE, make_spheres

    centers, radii, _ = make_spheres(BENCH_SCENE)
    c = torch.tensor(centers, dtype=torch.float32, device=dev)
    r = torch.tensor(radii, dtype=torch.float32, device=dev)

    def density(p):
        depth = torch.amin((p[:, None, :] - c).norm(dim=-1) - r, dim=-1)
        return 200.0 * torch.sigmoid(-depth / 0.01)

    return density


def k5_od_reference(state, cfg, march, o, d, jit, od_max):
    """The od culling in f64 over the plain march's own candidates: (each
    ray's occupied count, whether a candidate's od lies within K5_OD_NEAR of
    od_max, the count before the culling)."""
    from umhs_torch.ops.occupancy import query_grid_values
    from umhs_torch.ops.ray_marching import march_candidates_plain

    c = march_candidates_plain(state, cfg, march, o, d, jit)
    vals, _ = query_grid_values(state["occs_low"], c["positions"], cfg)
    occ = c["occupied"]
    contrib = torch.where(occ, vals, torch.zeros_like(vals)).double() * (
        c["dts"].double() / march.render_step_size)
    od = torch.cumsum(contrib, -1) - contrib
    near = (occ & ((od - od_max).abs() <= K5_OD_NEAR * od_max)).any(-1)
    return (occ & (od < od_max)).sum(-1), near, occ.sum(-1)


def k5a_candidates_needed(counted, cfg, march, o, d, jit):
    """The candidates K5a's pass needs on this data: each ray's pre-pass
    candidates that start before its t_max, and the cells of its kept
    supercells (min(the pre-pass count, supers) x pool), summed over the
    rays (the plain march's own schedule and slab test)."""
    from umhs_torch.ops.ray_marching import _super_config, _unit, candidate_ts, ray_aabb_intersect

    half = cfg.half_extent * cfg.max_scale
    t_enter, t_exit = ray_aabb_intersect(o, _unit(d), cfg.center - half, cfg.center + half)
    t_min = torch.clamp_min(t_enter, march.near_plane)
    t_max = torch.clamp_max(t_exit, march.far_plane)
    t0 = t_min if jit is None else t_min + jit * march.render_step_size
    ts, _ = candidate_ts(t0, _super_config(march))
    pre = int((ts < t_max[:, None]).sum())
    fine = int(torch.clamp_max(counted.state[:, 2], march.supers).sum()) * march.pool
    return pre, fine


def k5_case(label, state, cfg, march, o, d, jit, budget):
    """K5 against the plain march on the card, bit for bit, twice."""
    from umhs_torch.ops.ray_marching import march_rays_cuda, march_rays_plain

    args = (state, cfg, march, o, d, jit, budget)
    got, again, ref = march_rays_cuda(*args), march_rays_cuda(*args), march_rays_plain(*args)
    for k in ref:
        check(torch.equal(got[k], ref[k]), f"K5 {label}: {k} differs from the plain march")
        check(torch.equal(got[k], again[k]), f"K5 {label}: {k} not repeated")
    n = got["num_samples"]
    check(budget is None or int(n.sum()) <= budget, f"K5 {label}: over its budget")
    return {"samples": int(n.sum()), "occupied": int(got["num_occupied"].sum()),
            "strided_rays": int((got["num_occupied"] > n).sum())}


def grid_copy(state):
    """A copy of an occupancy state's tensors: a partial update on the card
    takes its grids over."""
    return {k: v.clone() for k, v in state.items()}


def k7_case(label, state, cfg, density, step, jitter, cells=None, draws=None):
    """K7 against the plain update on the card, bit for bit, twice, each run
    on a copy of `state` (which stays as it was); a partial one must write
    the copy's grids in place. Returns the kernels' update."""
    from umhs_torch.ops.occupancy import update_occ_state_cuda, update_occ_state_plain

    runs = []
    for _ in range(2):
        mine = grid_copy(state)
        runs.append(update_occ_state_cuda(mine, cfg, density, step, jitter, cells, draws=draws))
        if cells is not None or draws is not None:
            check(all(runs[-1][k].data_ptr() == mine[k].data_ptr() for k in ("occs", "occs_low")),
                  f"K7 {label}: the partial update did not write the state's grids in place")
    (got, again), ref = runs, update_occ_state_plain(state, cfg, density, step, jitter, cells,
                                                     draws=draws)
    check(sorted(got) == sorted(ref), f"K7 {label}: outputs {sorted(got)}")
    for k in ref:
        check(torch.equal(got[k], ref[k]), f"K7 {label}: {k} differs from the plain update")
        check(torch.equal(got[k], again[k]), f"K7 {label}: {k} not repeated")
    return got


# K7b alone: (res, levels, pool); res % 4 == 0 on the supercell path, 30 and
# 33 on the cell-a-thread path
K7B_GRIDS = ((128, 4, 4), (128, 4, 2), (64, 4, 4), (64, 2, 2), (32, 2, 4), (32, 2, 2),
             (30, 2, 2), (33, 1, 0))


def k7b_grid(dev, res, levels, scale, seed):
    """An occs grid of `levels` x res^3 in [0, scale): an eighth of the cells
    0, a thirteenth at min(mean, occ_thre). With scale 0.04 the threshold is
    occ_thre and those cells sit exactly on it (not above); with 0.01 it is
    the mean, which they move by a little."""
    from umhs_torch.ops.occupancy import OccGridConfig

    gen = torch.Generator(dev).manual_seed(seed)
    occs = scale * torch.rand(levels * res ** 3, device=dev, generator=gen)
    occs[::8] = 0.0
    occs[::13] = torch.clamp_max(torch.mean(occs), OccGridConfig.occ_thre)
    return occs


def k7b_cases(dev):
    """K7b (threshold_pack_cuda) alone against _threshold_pack_plain on the
    card, bit for bit and repeated, at each of K7B_GRIDS, with the threshold
    from occ_thre and from the mean (k7b_grid); a misaligned occs (a view 4
    bytes past an aligned one) refused before any launch on the supercell
    path, taken on the cell-a-thread path."""
    from umhs_torch.ops.occupancy import (
        OCC_PACK, OccGridConfig, _threshold_pack_plain, threshold_pack_cuda)

    out = []
    for res, levels, pool in K7B_GRIDS:
        cfg = OccGridConfig(resolution=res, levels=levels, pool=pool)
        for scale in (0.04, 0.01):
            occs = k7b_grid(dev, res, levels, scale, seed=res + pool)
            mean = torch.mean(occs)
            got, again = (threshold_pack_cuda(occs, mean, cfg) for _ in range(2))
            ref = _threshold_pack_plain(occs, mean, cfg)
            check(sorted(got) == sorted(ref), f"K7b {res} {pool}: outputs {sorted(got)}")
            for k in ref:
                check(torch.equal(got[k], ref[k]), f"K7b res {res} x {levels} pool {pool} "
                                                   f"scale {scale}: {k} not the plain bits")
                check(torch.equal(got[k], again[k]), f"K7b res {res} pool {pool}: {k} not repeated")
            out.append({"res": res, "levels": levels, "pool": pool, "scale": scale,
                        "occupied": float(got["binaries"].float().mean()), "outputs": sorted(got)})
        shifted = torch.zeros(levels * res ** 3 + 4, device=dev)[1:-3]
        shifted.copy_(occs)
        before = OCC_PACK.launches
        if res % 4 == 0:
            try:
                threshold_pack_cuda(shifted, torch.mean(shifted), cfg)
                fail(f"K7b res {res}: a misaligned occs was not refused")
            except ValueError:
                pass
            check(OCC_PACK.launches == before, f"K7b res {res}: launched on a misaligned occs")
        else:
            mean = torch.mean(shifted)
            got = threshold_pack_cuda(shifted, mean, cfg)
            ref = _threshold_pack_plain(shifted, mean, cfg)
            check(all(torch.equal(got[k], ref[k]) for k in ref),
                  f"K7b res {res}: the misaligned grid not the plain bits")
    print(f"K7b alone: the plain version's bits, repeated, at {len(out)} grids and thresholds "
          f"{json.dumps([(c['res'], c['levels'], c['pool'], c['scale']) for c in out])}; "
          "a misaligned occs refused before any launch where res % 4 == 0")
    return out


def phase_k5k7(dev, ptxas, dm):
    """K5 and K7 against their plain versions at the flagship's shapes, each
    repeated bit for bit, with device ms, ms per call, the plain version's
    device ms and the bound by bytes (no single PyTorch call computes
    either: library_ms null). The grid is the flagship's (128^3 x 4, pool
    4), updated by K7 from a density like the bench scene's trained field
    (full, then the flagship's partial update of ~918,000 probes); the
    march runs phase 7's steady batch (79,360 training rays of the bench
    scene with jitter, S 64, total budget 376,576), a 4,096-ray eval chunk,
    and the same batch on a dense and an empty grid. The od culling (off in
    every shipped configuration) is held with the plain version to f64."""
    from umhs_torch.engine.trainer import Trainer, TrainerConfig
    from umhs_torch.ops.occupancy import (
        _fold_plain, _level_world_positions, _probe_cells_plain, _threshold_pack_plain,
        draw_partial_cells, init_occ_state, mark_all_occupied, occ_fold_cuda, occ_probe_cuda,
        partial_cells, threshold_pack_cuda, update_occ_state_cuda, update_occ_state_plain)
    from umhs_torch.ops.ray_marching import (
        march_count_cuda, march_emit_cuda, march_rays_cuda, march_rays_plain)
    from umhs_torch.utils.device_time import device_ms_by_kernel

    usage = {name: {k: v for k, v in ptxas.items() if k.split("<")[0] in kernels}
             for name, kernels in K5K7_DEVICE_KERNELS.items()}
    for name, u in usage.items():
        print(f"K5/K7 {name} ptxas: " + json.dumps(u))
    trainer = Trainer(TrainerConfig(seed=0), flagship_model_config(), num_classes=6, device=dev,
                      datamanager=dm)
    model = trainer.model
    cfg, march, step = model.occ_config, model.march_config, model.render_step_size
    density = bench_sphere_density(dev)
    gen = torch.Generator(dev).manual_seed(14)
    n = cfg.levels * cfg.cells_per_level

    # K7: the full update from an empty grid, then a partial one from its
    # draws (the main path's) and at the cells partial_cells gives
    state0 = init_occ_state(cfg, dev)
    jitter = torch.rand((n, 3), device=dev, generator=gen)
    full = k7_case("full", state0, cfg, density, step, jitter, None)
    state = k7_case("full, again", full, cfg, density, step, jitter, None)
    draws = draw_partial_cells(cfg, gen, dev)
    cells = partial_cells(state, cfg, draws)
    m = cells[0].shape[0]
    pj = torch.rand((m, 3), device=dev, generator=gen)
    flat = cells[0] * cfg.cells_per_level + cells[1]
    unique = int(torch.unique(flat).numel())
    k7_case("partial, given cells", state, cfg, density, step, pj, cells)
    binaries = state["binaries"].clone()
    check(torch.equal(occ_probe_cuda(grid_copy(state), cfg, pj, draws=draws).flat.long(), flat),
          "K7a's cells differ from partial_cells'")
    check(torch.equal(state["binaries"], binaries), "K7a's cell choice changed the bitfield")
    level_counts = state["binaries"].reshape(cfg.levels, -1).sum(-1).tolist()
    partial = state
    state = k7_case("partial", state, cfg, density, step, pj, draws=draws)
    share = float(state["binaries"].float().mean())
    print(f"K7 at 4 x 128^3: full and partial ({m} probes, {m - unique} on a cell probed before; "
          f"the cells chosen on the card those of partial_cells) the plain version's bits; "
          f"occupied share {share:.4f}, pooled "
          f"{float(state['binaries_pooled'].float().mean()):.4f}")

    sigma_full = density(_level_world_positions(cfg, *_probe_cells_plain(cfg, dev, None), jitter))
    sigma_part = density(_level_world_positions(cfg, *cells, pj))
    mean = torch.mean(state["occs"])
    a, b = {}, {}
    # the partial update runs again and again on a copy of its grid, in place (the same work)
    for label, grid, jit, sig, kw in (("full", full, jitter, sigma_full, {}),
                                      ("partial", grid_copy(partial), pj, sigma_part,
                                       {"draws": draws})):
        probes = occ_probe_cuda(grid, cfg, jit, **kw)
        lv, cf = cells if kw else _probe_cells_plain(cfg, dev, None)
        occ = sig * step
        a[label] = {
            "ms": device_ms(lambda: occ_probe_cuda(grid, cfg, jit, **kw))
            + device_ms(lambda: occ_fold_cuda(probes, sig, step)),
            "call_ms": median_ms(lambda: occ_fold_cuda(occ_probe_cuda(grid, cfg, jit, **kw), sig,
                                                       step)),
            # the plain positions copy the grid's centre from the host and wait for it
            "plain_ms": k6_plain_ms(lambda: _level_world_positions(cfg, lv, cf, jit))
            + k6_plain_ms(lambda: _fold_plain(partial if kw else full, cfg, occ, lv, cf, not kw)),
            "update_ms": device_ms(lambda: update_occ_state_cuda(grid, cfg, density, step, jit,
                                                                 **kw)),
            "plain_update_ms": k6_plain_ms(
                lambda: update_occ_state_plain(partial if kw else full, cfg, density, step, jit,
                                               **kw)),
            "mode_0_by_kernel_ms": device_ms_by_kernel(lambda: occ_probe_cuda(grid, cfg, jit,
                                                                              **kw)),
        }
        if kw:  # the plain version's cell choice too
            a[label]["plain_ms"] += k6_plain_ms(lambda: partial_cells(partial, cfg, draws))
    # full: mode 0 reads the jitter and writes the positions; mode 1 reads the densities and
    # the grids and writes the grids. Partial, K7a's inputs and outputs: the bitfield, each
    # probe's draw (a uniform cell 8 B, an offset 4 B and, in a level with no occupied cell,
    # its fallback 8 B), jitter, density and position, and the grids read and written once
    # at each probed cell; its scratch (the probes' cells written and read, the bitmap
    # zeroed, the rows' and slices' counts written and read) apart
    a["full"]["bound_bytes"] = n * (12 + 12 + 4 + 4 * 4)
    uni = sum(d["uniform"].numel() for d in draws)
    fallback = sum(d["u"].numel() for d, c in zip(draws, level_counts) if c == 0)
    a["partial"]["bound_bytes"] = (n + uni * 8 + (m - uni) * 4 + fallback * 8
                                   + m * (12 + 4 + 12) + unique * 16)
    a["partial"]["scratch_bytes"] = (m * 4 * 2 + (n + 31) // 32 * 4
                                     + (cfg.levels * cfg.resolution ** 2
                                        + cfg.levels * cfg.resolution) * 4 * 2)
    b["ms"] = device_ms(lambda: threshold_pack_cuda(state["occs"], mean, cfg))
    b["call_ms"] = median_ms(lambda: threshold_pack_cuda(state["occs"], mean, cfg))
    b["plain_ms"] = k6_plain_ms(lambda: _threshold_pack_plain(state["occs"], mean, cfg))
    b["bound_bytes"] = n * 4 + 4 + n + n // 64 * (16 + 1)
    k7b = k7b_cases(dev)

    # K5 at phase 7's steady batch on that grid, a dense and an empty one
    R = K6_RAYS
    rays, _ = dm.sample(R, dm.draw(torch.Generator(dev).manual_seed(15), R))
    o, d = rays["origins"], rays["directions"]
    jit = torch.rand(R, device=dev, generator=gen)
    steady = dataclasses.replace(march, num_samples=K6_SAMPLES)
    cases = {
        "steady": k5_case("steady", state, cfg, steady, o, d, jit, K5_BUDGET),
        "dense": k5_case("dense", mark_all_occupied(state), cfg, steady, o, d, jit, K5_BUDGET),
        "empty": k5_case("empty", init_occ_state(cfg, dev), cfg, steady, o, d, jit, K5_BUDGET),
        "eval chunk": k5_case("eval chunk", state, cfg, steady, o[:4096], d[:4096], None,
                              model._compact_budget(4096, K6_SAMPLES)),
        "no budget": k5_case("no budget", state, cfg, steady, o, d, jit, None),
    }
    print("K5 cases (the plain march's bits, twice): " + json.dumps(cases))
    counted = march_count_cuda(state, cfg, steady, o, d, jit, K5_BUDGET)
    width = counted.state.shape[1]
    pre_needed, fine_needed = k5a_candidates_needed(counted, cfg, steady, o, d, jit)
    ops = R * K5A_OPS_RAY + (pre_needed + fine_needed) * K5A_OPS_CANDIDATE
    c5 = {
        "ms": device_ms(lambda: march_count_cuda(state, cfg, steady, o, d, jit, K5_BUDGET)),
        "call_ms": median_ms(lambda: march_count_cuda(state, cfg, steady, o, d, jit, K5_BUDGET)),
        # origins, directions, jitter; the 2 MB word table; the state rows and num_occupied
        "bound_bytes": R * (12 + 12 + 4) + state["packed_words"].numel() * 8
        + R * (width + 1) * 4,
        "ops": ops,
    }
    k5a_grids = {label: device_ms(lambda g=g: march_count_cuda(g, cfg, steady, o, d, jit,
                                                                 K5_BUDGET))
                 for label, g in (("dense", mark_all_occupied(state)),
                                  ("empty", init_occ_state(cfg, dev)))}
    k5a_grids["eval chunk"] = device_ms(lambda: march_count_cuda(
        state, cfg, steady, o[:4096], d[:4096], None, model._compact_budget(4096, K6_SAMPLES)))
    e5 = {
        "ms": device_ms(lambda: march_emit_cuda(counted)),
        "call_ms": median_ms(lambda: march_emit_cuda(counted)),
        "bound_bytes": R * width * 4 + 4 + R * K6_SAMPLES * (4 + 4 + 1) + R * 4,
    }
    # the plain march copies its constants from the host and waits for them
    plain_ms = k6_plain_ms(lambda: march_rays_plain(state, cfg, steady, o, d, jit, K5_BUDGET))
    march_ms = device_ms(lambda: march_rays_cuda(state, cfg, steady, o, d, jit, K5_BUDGET))
    others = {label: device_ms(lambda g=g: march_rays_cuda(g, cfg, steady, o, d, jit, K5_BUDGET))
              for label, g in (("dense", mark_all_occupied(state)),
                               ("empty", init_occ_state(cfg, dev)))}

    # the od culling: K5 and the plain version against f64, per ray
    od_march = dataclasses.replace(steady, early_stop_od=K5_OD_MAX)
    got = march_rays_cuda(state, cfg, od_march, o, d, jit, None)
    ref = march_rays_plain(state, cfg, od_march, o, d, jit, None)
    count64, near, unculled = k5_od_reference(state, cfg, od_march, o, d, jit, K5_OD_MAX)
    k = od_march.occ_subsamples
    off = ~near
    od = {"rays_near_od_max": int(near.sum()), "culled": int((unculled - count64).sum()),
          "kernel_rays_apart_from_f64": int((got["num_occupied"] // k != count64)[off].sum()),
          "plain_rays_apart_from_f64": int((ref["num_occupied"] // k != count64)[off].sum()),
          "rays_apart_kernel_plain": int((got["num_occupied"] != ref["num_occupied"]).sum())}
    check(od["kernel_rays_apart_from_f64"] == 0 and od["plain_rays_apart_from_f64"] == 0,
          f"K5 od culling: counts part from f64 off the threshold: {od}")
    for key in ref:
        check(torch.equal(got[key][off], ref[key][off]),
              f"K5 od culling: {key} differs from the plain march off the threshold")
    check(od["culled"] > 0, "K5 od culling culled nothing")
    print("K5 od culling against f64 (od_max 0.5, pool 4 on the bytes): " + json.dumps(od))

    grid_shape = (f"flagship grid 4 x 128^3, pool 4, from the bench scene's sphere density "
                  f"(occupied share {share:.4f})")
    march_shape = (f"phase 7's steady batch: {R} training rays of the bench scene with "
                   f"jitter, 1024 candidates, 4 a cell, pool 4, S 64, total budget {K5_BUDGET}; "
                   f"{grid_shape}")

    def entry(name, t, shape, **extra):
        source, replaces = K5K7_ENTRIES[name]
        by_bytes = t["bound_bytes"] / H100_BYTES_PER_S * 1e3
        by_ops = t.get("ops", 0) / H100_F32_FLOPS * 1e3
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "max_abs_err": 0.0, "ms": t["ms"], "call_ms": t["call_ms"],
                "plain_ms": t["plain_ms"], "library_ms": None,
                "bound_ms": max(by_bytes, by_ops),
                "bound_by": "operations" if by_ops > by_bytes else "bytes",
                "shape": shape, "ptxas": usage[name], **extra}

    entries = [
        entry("march_count", dict(c5, plain_ms=plain_ms), march_shape,
              plain_note="plain_ms: the whole plain march (K5a's and K5b's work)",
              bound_bytes_ms=c5["bound_bytes"] / H100_BYTES_PER_S * 1e3,
              bound_ops_ms=ops / H100_F32_FLOPS * 1e3,
              candidates_needed={"pre_pass": pre_needed, "fine": fine_needed},
              ms_dense=k5a_grids["dense"], ms_empty=k5a_grids["empty"],
              ms_eval_chunk=k5a_grids["eval chunk"],
              march_ms=march_ms, march_dense_ms=others["dense"],
              march_empty_ms=others["empty"], cases=cases, od_culling=od),
        entry("march_emit", dict(e5, plain_ms=plain_ms), march_shape,
              plain_note="plain_ms: the whole plain march (K5a's and K5b's work)"),
        entry("occ_update", {**a["full"]}, f"full update, {n} probes; {grid_shape}",
              update_ms=a["full"]["update_ms"], plain_update_ms=a["full"]["plain_update_ms"],
              partial={**a["partial"], "probes": m, "repeated_probes": m - unique,
                       "bound_ms": a["partial"]["bound_bytes"] / H100_BYTES_PER_S * 1e3}),
        entry("occ_pack", b, f"threshold, pool 4 and pack of {n} cells; {grid_shape}",
              cases=k7b),
    ]
    for e in entries:
        print(f"K5/K7 {e['name']}: " + json.dumps(e))
    return entries


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
    """bench.py's training schedule from a dataset on disk, at full width.
    Returns its launches, every step's loss and its adapt decisions (phase
    9 holds cli.train to them), and its resolved configs."""
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
        with uncounted():
            side["k5_k7_steady"] = k5k7_on_trained_state(trainer, dev)
            side["host_syncs"] = host_syncs(trainer.train_step)
        print("  the flagship step's host syncs by source line: " + json.dumps(side["host_syncs"]))
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
        "k5_k7_on_the_steady_state": side["k5_k7_steady"],
        "host_syncs_per_step": side["host_syncs"],
    }
    print("bench schedule: " + json.dumps(summary))
    configs = {"trainer": trainer.config, "model": trainer.model.config,
               "datamanager": trainer.datamanager.config}
    return launches, losses, adapt_records(trainer), configs, eval_all


def k5k7_on_trained_state(trainer, dev):
    """K5 and K7 against their plain versions on the schedule's own steady
    state: the march of one steady batch (its draws, its total budget), and
    a partial update from its draws with the field's density on a copy of
    the grid; then that update whole and in pieces (partial_update_split).
    Returns the grid's occupied share, the march's counts and the split."""
    from umhs_torch.models.field import density_fn
    from umhs_torch.ops.occupancy import draw_partial_cells

    model, occ = trainer.model, trainer.state["occ"]
    cfg = model.occ_config
    draws = trainer.draw_step()
    rays, _ = trainer.datamanager.sample(trainer.dyn.rays, draws["pixels"])
    B = trainer.dyn.compact_budget
    budget = sum(B) if isinstance(B, (tuple, list)) else B
    march = k5_case("phase 7's steady state", occ, cfg, trainer.dyn.march, rays["origins"],
                    rays["directions"], draws["t_jitter"], budget)
    gen = torch.Generator(dev).manual_seed(16)
    cell_draws = draw_partial_cells(cfg, gen, dev)
    m = sum(d["uniform"].numel() + d["u"].numel() for d in cell_draws)
    jitter = torch.rand((m, 3), device=dev, generator=gen)
    k7_case("phase 7's steady state, partial", occ, cfg,
            density_fn(trainer.state["params"], model.field_config), model.render_step_size,
            jitter, draws=cell_draws)
    out = {"occupied_share": float(occ["binaries"].float().mean()),
           "pooled_share": float(occ["binaries_pooled"].float().mean()), "rays": trainer.dyn.rays,
           "total_budget": budget, "march": march}
    print("  K5 and K7 on the steady state (the plain versions' bits): " + json.dumps(out))
    out["partial_update"] = partial_update_split(trainer, dev)
    return out


UPDATE_GROUPS = {  # partial_update_split's device kernels by piece
    "K7a": ("occ_cells_kernel", "occ_probe_kernel", "occ_ema_kernel", "occ_fold_kernel"),
    "K7b": ("occ_pack_kernel", "occ_threshold_kernel", "occ_pool_kernel"),
    "density (K3, K1)": ("hash_encode_fwd_kernel", "mlp_fused_fwd"),
}


def partial_update_split(trainer, dev) -> dict:
    """One partial update of the trained grid (the field's density, the
    flagship's ~918,000 probes) through whichever umhs_torch is on sys.path:
    its whole device time (device_ms) and launches (torch.profiler), its
    device time by kernel (device_ms_by_kernel, which may find no whole
    profile: then {}) summed into UPDATE_GROUPS, and its pieces each timed
    alone: the cell choice where partial_cells makes it, the grids' two
    clones where the update makes them, K7a's two launches (mode 0 by
    kernel), the density evaluation, torch.mean, K7b. It updates a copy of
    the grid again and again (on the card an update takes its grids over;
    the cells' work is the same every time)."""
    import inspect

    from umhs_torch.models.field import density_fn
    from umhs_torch.ops import occupancy as om
    from umhs_torch.utils.device_time import device_ms_by_kernel

    model = trainer.model
    cfg, step = model.occ_config, model.render_step_size
    density = density_fn(trainer.state["params"], model.field_config)
    gen = torch.Generator(dev).manual_seed(19)
    draws = om.draw_partial_cells(cfg, gen, dev)
    cells = om.partial_cells(trainer.state["occ"], cfg, draws)
    jitter = torch.rand((cells[0].shape[0], 3), device=dev, generator=gen)
    grid = grid_copy(trainer.state["occ"])
    chooses = "draws" in inspect.signature(om.update_occ_state).parameters
    if chooses:  # the cells chosen on the card from the draws
        def whole():
            return om.update_occ_state(grid, cfg, density, step, jitter, draws=draws)
    else:
        def whole():
            return om.update_occ_state(grid, cfg, density, step, jitter,
                                       cells=om.partial_cells(grid, cfg, draws))
    out = {"probes": int(cells[0].shape[0]), "cells_chosen_on_the_card": chooses,
           "device_ms": device_ms(whole)}
    prof = profile("partial update", whole)
    out.update(launches=prof["device_launches"], traced_busy_ms=prof["device_busy_ms"],
               traced_wall_ms=prof["wall_ms"])
    by_kernel = device_ms_by_kernel(whole) or {}
    out["by_kernel_ms"] = by_kernel
    for group, names in UPDATE_GROUPS.items():
        out[f"{group} ms"] = sum(ms for k, ms in by_kernel.items()
                                 if any(k.startswith(n) for n in names))
    out["other kernels ms"] = sum(by_kernel.values()) - sum(
        out[f"{g} ms"] for g in UPDATE_GROUPS)
    positions = om._level_world_positions(cfg, *cells, jitter)
    mean = torch.mean(grid["occs"])
    kw = {"draws": draws} if chooses else {"cells": cells}
    probes = om.occ_probe_cuda(grid, cfg, jitter, **kw)
    sigma = om._eval_occ(density, probes.positions)
    pieces = {"density": device_ms(lambda: om._eval_occ(density, positions)),
              "torch.mean": device_ms(lambda: torch.mean(grid["occs"])),
              # K7a's mode 0 by kernel (the grids' clones among them where it makes them)
              "K7a mode 0": device_ms_by_kernel(lambda: om.occ_probe_cuda(grid, cfg, jitter,
                                                                          **kw)),
              "K7a mode 1": device_ms(lambda: om.occ_fold_cuda(probes, sigma, step)),
              "K7b": device_ms(lambda: om.threshold_pack_cuda(grid["occs"], mean, cfg))}
    if not chooses:
        pieces["partial_cells"] = device_ms(lambda: om.partial_cells(grid, cfg, draws))
        pieces["two clones"] = device_ms(lambda: (grid["occs"].clone(),
                                                  grid["occs_low"].clone()))
    out["pieces_alone_ms"] = pieces
    # the cell choice: partial_cells, or K7a's count pass (its searches run inside the probe
    # kernel)
    out["cell choice ms"] = ((pieces["K7a mode 0"] or {}).get("occ_cells_kernel") if chooses
                             else pieces["partial_cells"])
    print("  partial update of the trained grid: " + json.dumps(out))
    return out


SITE_KERNELS = ("indexing_backward_kernel", "vectorized_gather_kernel")


def kernel_sites(fn) -> dict:
    """fn() once more under torch.profiler with stacks and shapes: for each
    device kernel in SITE_KERNELS, its calls by the op that made them, with
    device ms and count, largest first. A kernel launched by a backward is
    named by the forward op of its autograd node (the node's sequence
    number matched to the forward op's); one launched by a forward op by
    that op. An op is placed by its innermost two umhs_torch Python frames
    where the profiler records them (on an H100 it was seen to record
    none), else by its input shapes."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       with_stack=True, record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()

    def place(e):
        """e's op name with its umhs_torch frames (the profiler records each
        Python call as an event named file(line): fn), or its input shapes."""
        frames, node = [], e
        while node is not None and len(frames) < 2:
            if "umhs_torch/" in node.name and "): " in node.name:
                frames.append(node.name)
            node = node.cpu_parent
        return f"{e.name} at {' < '.join(frames) or f'shapes {e.input_shapes}'}"

    forward = {}  # sequence number -> {forward op: its place}
    for e in events:
        if e.sequence_nr >= 0 and e.name.startswith("aten::"):
            forward.setdefault(e.sequence_nr, {}).setdefault(e.name, place(e))

    def forward_site(node):
        """The place of the forward op of autograd node `node`
        (IndexBackward0 -> aten::index), or the node's name."""
        op = node.name.split(": ")[-1]
        ops = forward.get(node.sequence_nr, {})
        name = "aten::" + re.sub(r"(?<!^)(?=[A-Z])", "_", op.split("Backward")[0]).lower()
        return ops.get(name) or next(iter(ops.values()), op)

    sites = {k: {} for k in SITE_KERNELS}
    for e in events:
        for kernel in SITE_KERNELS:
            mine = [k for k in e.kernels if kernel in k.name]
            if not mine:
                continue
            chain, node = [], e
            while node is not None:
                chain.append(node)
                node = node.cpu_parent
            backward = next((n for n in chain if n.name.startswith("autograd::engine::")), None)
            op = next((n for n in chain if n.name.startswith("aten::")), e)
            name = forward_site(backward) if backward is not None else place(op)
            site = sites[kernel].setdefault(name, {"site": name, "ms": 0.0, "kernels": 0})
            site["ms"] += sum(k.duration for k in mine) / 1e3
            site["kernels"] += len(mine)
    return {k: sorted(v.values(), key=lambda v: -v["ms"]) for k, v in sites.items()}


def traced(prof: dict) -> dict:
    """The parts of a profile() reading that --baseline compares: with the
    device ms of PyTorch's indexing backward and forward gathers (a tree's
    profile() without that reading: from its top kernels)."""
    top = prof.get("top_kernels", [])
    gathers = prof.get("gather_kernels_ms") or {
        name: sum(ms for key, ms, _ in top if name in key)
        for name in ("indexing_backward_kernel", "vectorized_gather_kernel")}
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_busy_share",
                                 "device_launches")} | {
        "indexing_backward_ms": gathers["indexing_backward_kernel"],
        "vectorized_gather_ms": gathers["vectorized_gather_kernel"], "top_kernels": top[:8]}


def schedule_measurements() -> dict:
    """Phase 7's schedule through whichever umhs_torch is on sys.path (run by
    schedule_against_tree in a process of its own from a tree), then: its
    losses (hex) and adapts, steady ms per step, eval_all_images, one traced
    steady step, and one more with its indexing backward's and forward
    gathers' kernels by site (kernel_sites), one partial update of its grid
    whole and in pieces (partial_update_split); then phase 5's configuration
    (4096 rays, train(48)) with one traced step, and a traced 128^2 render
    of an eval view from that state."""
    from umhs_torch.data.cameras import generate_camera_rays
    from umhs_torch.engine.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    out = {}
    with bench_dataset() as (work, root, _):
        t = bench_trainer(root, dev)
        slices, losses = drive_schedule(t)
        out.update(losses=[float(v).hex() for v in losses], adapts=adapt_records(t),
                   **steady_rates(slices), eval_all_images=t.eval_all_images())
        out["steady_step"] = traced(profile("steady step", t.train_step))
        out["steady_step_sites"] = kernel_sites(t.train_step)
        out["host_syncs_step"] = host_syncs(t.train_step)
        out["partial_update"] = partial_update_split(t, dev)
        del t
    dm, endmembers, cam = bench_scene_in_memory(dev)
    t = Trainer(TrainerConfig(seed=0, mixed_precision=True, save_final=False),
                flagship_model_config(), num_classes=6, device=dev, datamanager=dm)
    t.setup(endmembers)
    t.train(TRAIN_STEPS)
    out["step_4096"] = traced(profile("4096-ray step", t.train_step))
    rays = generate_camera_rays(cam, 0, 128, 128)
    out["render_128"] = traced(profile("render", lambda: t.render_camera(rays, (128, 128),
                                                                          step=1000)))
    out["host_syncs_render"] = host_syncs(lambda: t.render_camera(rays, (128, 128), step=1000))
    return out


SCHEDULE_PSNR_MARGIN_DB = 1.0  # phase 8's margin, ~4x the seed stdev (PERF.md section 2)


def schedule_against_tree(tree: Path, losses, adapts, eval_all) -> dict:
    """Phase 7's schedule from another checkout (`tree`) against this one,
    each through its own umhs_torch (schedule_measurements), in a process
    of its own, in turns: tree, this, this, tree. This checkout's two runs
    must give phase 7's losses and adapts bit for bit, and the tree's two
    each other's. Printed: the first step at which the trees' losses part,
    both trees' adapts, eval_all_images, steady ms per step and the traced
    steps (phase 7's steady step, phase 5's, phase 3's render) with the
    indexing backward's share, and its calls and the forward gathers' by
    site (kernel_sites). The sums K6 takes in
    another order change the training bits, so the trees are held to each
    other on quality: this tree's eval_all_images PSNR at most
    SCHEDULE_PSNR_MARGIN_DB below the tree's."""
    here = Path(__file__).resolve()
    turns = []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for root in (tree, here.parent, here.parent, tree):
        turns.append(in_tree(root, "schedule_measurements"))
    ours = [float(v).hex() for v in losses]
    adapts = json.loads(json.dumps(adapts))
    for i in (1, 2):
        check(turns[i]["losses"] == ours and turns[i]["adapts"] == adapts,
              f"this checkout's schedule in a process of its own (turn {i}) is not phase 7's")
    check(turns[0]["losses"] == turns[3]["losses"], f"{tree}'s two schedules part")
    theirs = turns[0]
    first = next((i for i, (a, b) in enumerate(zip(ours, theirs["losses"])) if a != b), None)
    psnr, psnr_tree = eval_all["psnr"], theirs["eval_all_images"]["psnr"]
    result = {
        "losses_equal": first is None, "first_step_apart": first, "steps": len(ours),
        "adapts": adapts, "tree_adapts": theirs["adapts"],
        "adapts_equal": adapts == theirs["adapts"],
        "eval_all_images": eval_all, "tree_eval_all_images": theirs["eval_all_images"],
        "turns": [{k: v for k, v in r.items() if k not in ("losses", "adapts")} for r in turns],
        "seconds": time.perf_counter() - t0,
    }
    print(f"bench schedule against {tree}: " + json.dumps(result))
    for key in ("steady_ms_per_step", "steady_step", "step_4096", "render_128",
                "host_syncs_step", "host_syncs_render", "partial_update"):
        print(f"  {key} in turns (tree, this, this, tree): "
              + json.dumps([r[key] for r in turns]))
    for label, r in (("tree", turns[0]), ("this", turns[1])):
        print(f"  {label}: the steady step's {' and '.join(SITE_KERNELS)} by site: "
              + json.dumps(r["steady_step_sites"]))
    check(psnr >= psnr_tree - SCHEDULE_PSNR_MARGIN_DB,
          f"eval_all_images PSNR {psnr} is more than {SCHEDULE_PSNR_MARGIN_DB} dB below "
          f"{tree}'s {psnr_tree}")
    if (tree / "umhs_torch" / "csrc" / "march.cu").exists():
        # a tree with K5's and K7's kernels sums every step as this one does
        check(first is None and result["adapts_equal"],
              f"the schedule's losses part from {tree}'s at step {first}, or its adapts do")
    return result


TREE_CODE = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
print("TREE " + json.dumps(getattr(cs, sys.argv[2])(*sys.argv[3:])))
"""


def in_tree(root: Path, function: str, *args: str) -> dict:
    """This script's `function`(*args) in a process of its own with `root`'s
    umhs_torch (PYTHONPATH and cwd `root`, its kernels built there): its
    JSON result. Fails the run if the process fails."""
    proc = subprocess.run([sys.executable, "-c", TREE_CODE, str(Path(__file__).resolve()),
                           function, *args], cwd=root, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(root.resolve())))
    check(proc.returncode == 0, f"{function} from {root} failed:\n{proc.stdout[-3000:]}\n"
                                f"{proc.stderr[-3000:]}")
    return json.loads([ln for ln in proc.stdout.splitlines()
                       if ln.startswith("TREE ")][-1][len("TREE "):])


def tree_measurements(save_dir: str) -> dict:
    """The kernels at phase 2's and phase 10's shapes through whichever
    umhs_torch is on sys.path (run by baseline_against_tree in a process of
    its own from a tree, its kernels built there): per case the device ms
    (device_ms), the ms per call (median_ms, the wrapper's host time in) and
    the sha1 of the output's bits; the DINO chain's K1 and K2 outputs saved
    under save_dir. Inputs come from fixed seeds, the same in every tree."""
    import hashlib

    from umhs_torch.data.synthetic import ray_samples
    from umhs_torch.ops import _native
    from umhs_torch.ops.encodings import HashEncodingConfig, hash_encode_bwd, hash_encode_fwd
    from umhs_torch.ops.mlp import init_mlp
    from umhs_torch.ops.mlp_fused import mlp_fused_bwd, mlp_fused_fwd
    from umhs_torch.ops.row_gather import row_gather
    from umhs_torch.probes import gather as probe

    _native.build_all()
    dev = torch.device("cuda")
    out = {}

    def digest(y) -> str:
        h = hashlib.sha1()
        for part in (y if isinstance(y, (list, tuple)) else [y]):
            if isinstance(part, (list, tuple)):
                h.update(digest(part).encode())
            elif part is not None:
                h.update(bits(part.contiguous()).numpy().tobytes())
        return h.hexdigest()

    def case(name, fn, calls=True, held=False):
        y = fn()
        torch.cuda.synchronize()
        # the digest before the timed calls (a partial update writes its grids in place);
        # held: device time behind a spin, None where a call waits for the device (a tree's
        # plain compaction)
        out[name] = {"digest": digest(y)}
        out[name].update(ms=held_ms(fn, 10) if held else device_ms(fn),
                         call_ms=median_ms(fn) if calls else None)
        return y

    gen = torch.Generator().manual_seed(4)
    flag = HashEncodingConfig(num_levels=16, features_per_level=2, log2_hashmap_size=19,
                              interpolation="tetrahedral")
    pos = torch.rand((K2_ROWS, 3), generator=gen)
    pos[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.5, 1.0], [1.0, 0.0, 0.25]])
    g = torch.randn((K2_ROWS, flag.output_dim), generator=gen).to(dev)
    for kind, p in (("random", pos.to(dev)),
                    ("rays", torch.from_numpy(ray_samples(4096, 64, seed=4)).to(dev))):
        for mode, stochastic in (("stochastic", True), ("deterministic", False)):
            case(f"K4 flagship {kind} {mode}", lambda: hash_encode_bwd(p, g, flag, stochastic))
    for i, (n, max_res) in enumerate(zip(PROPOSAL_ROWS, (128, 256))):
        cfg = HashEncodingConfig(num_levels=5, max_resolution=max_res, log2_hashmap_size=17,
                                 base_resolution=16)
        p = torch.from_numpy(ray_samples(NERFACTO_RAYS, n // NERFACTO_RAYS, seed=20 + i)).to(dev)
        gp = torch.randn((n, cfg.output_dim), generator=gen).to(dev)
        case(f"K4 proposal_{i} deterministic", lambda: hash_encode_bwd(p, gp, cfg, False))
        del p, gp
    torch.cuda.empty_cache()

    n = 1 << 20
    pos = torch.rand((n, 3), generator=gen).to(dev)
    rays = torch.from_numpy(ray_samples(n // 64, 64, seed=2)).to(dev)
    for interp, kind, p in (("tetrahedral", "random", pos), ("tetrahedral", "rays", rays),
                            ("trilinear", "random", pos)):
        cfg = HashEncodingConfig(num_levels=16, features_per_level=2, log2_hashmap_size=19,
                                 interpolation=interp)
        table = ((torch.rand((cfg.table_size * 2,), generator=gen) * 2 - 1) * 1e-4).to(dev)
        case(f"K3 {interp} {kind}", lambda: hash_encode_fwd(table, p, cfg))

    dims = [15, 256, DINO_DIM]
    params = init_mlp(gen, dims[0], len(dims) - 1, dims[1], dims[-1], dev)
    x = torch.randn((K2_ROWS, dims[0]), generator=gen).to(dev)
    gy = torch.randn((K2_ROWS, dims[-1]), generator=gen).to(dev)
    y = case("K1 dino", lambda: mlp_fused_fwd(params, x, torch.bfloat16), calls=False)
    _, grads = case("K2 dino", lambda: mlp_fused_bwd(params, x, gy, torch.bfloat16, False),
                    calls=False)
    torch.save({"y": y.cpu(), "grads": [[t.cpu() for t in pair] for pair in grads]},
               Path(save_dir) / "dino.pt")
    for name, dims in K1_CHAINS.items():  # phase 2's chains: K2's calls, dx but for the last
        params = init_mlp(gen, dims[0], len(dims) - 1, dims[1], dims[-1], dev)
        x = torch.randn((K2_ROWS, dims[0]), generator=gen).to(dev)
        gy = torch.randn((K2_ROWS, dims[-1]), generator=gen).to(dev)
        need_dx = name != "mlp_directional"
        fn = lambda: mlp_fused_bwd(params, x, gy, torch.bfloat16, need_dx)  # noqa: E731
        out[f"K2 call {name}"] = {"call_ms": median_ms(fn, iters=50), "digest": digest(fn())}

    table, idx = probe.make_case(probe.PROBE_TABLE_ROWS, probe.PROBE_ROWS, dev)
    case("P1 probe table", lambda: row_gather(table, idx))
    del table, idx
    torch.cuda.empty_cache()
    k6_tree_cases(dev, case)
    k5k7_tree_cases(dev, case)
    return out


def k6_parent_code():
    """A tree without K6 (umhs_torch.ops.compact absent): the compact path's
    code as its models/model.py ran it (plain PyTorch: cumsum, nonzero, the
    gathers and their autograd, segment_accumulate of w[src] * live * h), as
    (stage, lanes, accumulate) with the K6 wrappers' signatures."""
    from types import SimpleNamespace

    from umhs_torch.ops.compositing import segment_accumulate

    def stage(m, alive, budget):
        R, L = m.shape
        if alive is not None:
            m = m & alive[:, None]
        flat_mask = m.reshape(-1)
        fm = flat_mask.int()
        slot = torch.cumsum(fm, dim=0, dtype=torch.int32) - fm
        flat_mask = flat_mask & (slot < budget)
        m = flat_mask.reshape(R, L)
        kept = torch.nonzero(flat_mask).squeeze(1)
        total = kept.shape[0]
        src = torch.zeros(budget, dtype=torch.int64, device=m.device)
        src[:total] = kept
        live = (torch.arange(budget, device=m.device) < total).float()
        counts = m.sum(dim=-1)
        return SimpleNamespace(slot=slot, mask=m, src=src, live=live, counts=counts,
                               starts=torch.cumsum(counts, dim=0) - counts, total=total)

    def lanes(rows, c):
        R, L = c.mask.shape
        back = rows[torch.clamp(c.slot.reshape(R, L).long(), 0, rows.shape[0] - 1)]
        return torch.where(c.mask, back, torch.zeros_like(back))

    def accumulate(w, h, c):
        wc = w.reshape(-1)[c.src] * c.live
        return segment_accumulate(wc[:, None] * h, c.starts, c.counts)

    return stage, lanes, accumulate


def k6_tree_cases(dev, case):
    """K6 at phase 7's steady shapes through the tree's own code: its
    kernels (compact_stage, gather_lanes, render_weights, compact_accumulate)
    or, in a tree without them, the plain PyTorch its model ran
    (k6_parent_code). Per stage for the three stages, and for the four
    heads: the compaction; the density gather with its gradient; the
    weights forward, and with their gradient; the heads' sums forward, and
    with their gradients."""
    import importlib.util

    from umhs_torch.ops.compositing import render_weights

    from umhs_torch.ops import compositing

    if importlib.util.find_spec("umhs_torch.ops.compact") is not None:
        from umhs_torch.ops.compact import compact_stage, gather_lanes

        stage, lanes, accumulate = compact_stage, gather_lanes, compositing.compact_accumulate
    else:
        stage, lanes, accumulate = k6_parent_code()
    # a head's sums over the stages as the tree's model takes them: one call
    # over every stage, or a call a stage added in stage order
    accumulate_stages = getattr(compositing, "compact_accumulate_stages", None)
    x = k6_inputs(dev)
    gen = torch.Generator().manual_seed(14)
    R = K6_RAYS
    splits = list(zip(K6_STAGES, K6_BUDGETS, x["alive"]))
    comps = [stage(x["mask"][:, lo:hi], alive, Bs) for (lo, hi), Bs, alive in splits]

    def compaction():
        cs_ = [stage(x["mask"][:, lo:hi], alive, Bs) for (lo, hi), Bs, alive in splits]
        return [[c.slot, c.mask, c.src, c.live, c.counts, c.starts] for c in cs_]

    case("K6 compact_stage", compaction, held=True)
    rows = [torch.randn(Bs, generator=gen).to(dev).requires_grad_(True) for Bs in K6_BUDGETS]
    g_lanes = [torch.randn((R, hi - lo), generator=gen).to(dev) for lo, hi in K6_STAGES]

    def gathers():
        outs = [lanes(r, c) for r, c in zip(rows, comps)]
        return outs + list(torch.autograd.grad(outs, rows, g_lanes))

    case("K6 compact_gather", gathers, held=True)
    thre = torch.tensor(K6_ALPHA_THRE, device=dev)
    sigma = x["sigma"].clone().requires_grad_(True)
    g_w = torch.randn((R, K6_SAMPLES), generator=gen).to(dev)
    case("K6 render_weights_fwd",
         lambda: render_weights(x["ts"], x["te"], sigma.detach(), x["mask"], thre, K6_EPS),
         held=True)
    case("K6 render_weights_fwd_bwd", lambda: torch.autograd.grad(
        render_weights(x["ts"], x["te"], sigma, x["mask"], thre, K6_EPS), sigma, g_w), held=True)
    weights = torch.rand((R, K6_SAMPLES), generator=gen).to(dev).requires_grad_(True)
    heads = [[torch.randn((Bs, C), generator=gen).to(dev).requires_grad_(True)
              for C in K6_HEADS.values()] for Bs in K6_BUDGETS]
    g_heads = [torch.randn((R, C), generator=gen).to(dev) for C in K6_HEADS.values()]

    def sums():
        if accumulate_stages is not None:
            return [accumulate_stages(weights, [(lo, hi, hs[j], c) for (lo, hi), hs, c
                                                in zip(K6_STAGES, heads, comps)])
                    for j in range(len(K6_HEADS))]
        return [sum(accumulate(weights[:, lo:hi], hs[j], c)
                    for (lo, hi), hs, c in zip(K6_STAGES, heads, comps))
                for j in range(len(K6_HEADS))]

    case("K6 segment_accumulate_fwd", lambda: [[t.detach() for t in sums()]], held=True)
    leaves = [weights] + [h for hs in heads for h in hs]
    case("K6 segment_accumulate_fwd_bwd",
         lambda: torch.autograd.grad(sums(), leaves, g_heads), held=True)
    bwd = getattr(compositing, "render_weights_bwd_cuda", None)
    if bwd is None:  # a tree without K6's kernels
        return
    # K6c's backward alone: phase 7's d sigmas, and nerfacto's shapes with the t gradients
    case("K6 render_weights_bwd", lambda: bwd(x["ts"], x["te"], x["sigma"], x["mask"], thre,
                                              K6_EPS, g_w, (True, False, False)))
    for S_p in K6C_PROPOSAL_SAMPLES:
        gp = torch.Generator().manual_seed(S_p)
        dt = torch.rand((NERFACTO_RAYS, S_p), generator=gp) * 0.01 + 1e-4
        te = (0.05 + torch.cumsum(dt, 1)).to(dev)
        ts = te - dt.to(dev)
        sg = (-5.0 * torch.log1p(-torch.rand((NERFACTO_RAYS, S_p), generator=gp))).to(dev)
        ones = torch.ones((NERFACTO_RAYS, S_p), dtype=torch.bool, device=dev)
        g_p = torch.randn((NERFACTO_RAYS, S_p), generator=gp).to(dev)
        case(f"K6 render_weights_bwd nerfacto {S_p}",
             lambda ts=ts, te=te, sg=sg, ones=ones, g_p=g_p: bwd(ts, te, sg, ones, 0.0, 0.0, g_p))


def k5k7_tree_cases(dev, case):
    """K7 and K5 at the flagship's shapes through the tree's own code (its
    kernels, or the plain PyTorch of a tree without them): the full update
    of the 128^3 x 4 grid from the bench scene's sphere density, a partial
    update of ~918,000 probes, the march of 79,360 rays with jitter at S 64
    and phase 7's steady total budget on that grid."""
    from umhs_torch.models.model import UMHSModel
    import inspect

    from umhs_torch.ops.occupancy import (
        draw_partial_cells, init_occ_state, mark_all_occupied, partial_cells, update_occ_state)
    from umhs_torch.ops import ray_marching
    from umhs_torch.ops.ray_marching import march_rays

    march_count_cuda = getattr(ray_marching, "march_count_cuda", None)
    model = UMHSModel(flagship_model_config(), [400.0 + 2.0 * i for i in range(128)], 6, 16,
                      device=dev)
    cfg, step = model.occ_config, model.render_step_size
    density = bench_sphere_density(dev)
    gen = torch.Generator().manual_seed(17)
    n = cfg.levels * cfg.cells_per_level
    jitter = torch.rand((n, 3), generator=gen).to(dev)
    empty = init_occ_state(cfg, dev)
    full = update_occ_state(empty, cfg, density, step, jitter)
    case("K7 full update", lambda: [v for _, v in sorted(
        update_occ_state(empty, cfg, density, step, jitter).items())], held=True)
    draws = draw_partial_cells(cfg, torch.Generator(dev).manual_seed(18), dev)
    cells = partial_cells(full, cfg, draws)
    pj = torch.rand((cells[0].shape[0], 3), generator=gen).to(dev)
    # the whole partial update, again and again on a copy of the grid: in a tree that chooses
    # the cells on the card from the draws and writes the grids in place, else partial_cells
    # and the update
    work = grid_copy(full)
    if "draws" in inspect.signature(update_occ_state).parameters:
        def partial():
            return update_occ_state(work, cfg, density, step, pj, draws=draws)
    else:
        def partial():
            return update_occ_state(work, cfg, density, step, pj,
                                    cells=partial_cells(work, cfg, draws))
    case("K7 partial update", lambda: [v for _, v in sorted(partial().items())], held=True)
    # K7b alone, through the tree's threshold_pack_cuda: the trained-like grid, then k7b_grid's
    from umhs_torch.ops import occupancy

    pack = getattr(occupancy, "threshold_pack_cuda", None)
    if pack is not None:
        mean = torch.mean(full["occs"])
        case("K7 occ_pack", lambda: [v for _, v in sorted(pack(full["occs"], mean,
                                                                    cfg).items())])
        for res, levels, pool in K7B_GRIDS[1:4]:
            g = occupancy.OccGridConfig(resolution=res, levels=levels, pool=pool)
            occs = k7b_grid(dev, res, levels, 0.04, seed=res + pool)
            m = torch.mean(occs)
            case(f"K7 occ_pack res {res} x {levels} pool {pool}",
                 lambda occs=occs, m=m, g=g: [v for _, v in sorted(pack(occs, m, g).items())])
    R = K6_RAYS
    o = torch.randn((R, 3), generator=gen)
    o = (3.0 * o / o.norm(dim=-1, keepdim=True)).to(dev)
    d = (torch.rand((R, 3), generator=gen) * 1.6 - 0.8).to(dev) - o
    jit = torch.rand(R, generator=gen).to(dev)
    steady = dataclasses.replace(model.march_config, num_samples=K6_SAMPLES)
    case("K5 march", lambda: [v for _, v in sorted(march_rays(
        full, cfg, steady, o, d, t_jitter=jit, total_budget=K5_BUDGET).items())], held=True)
    for label, grid, rays, jitter, budget in (
            ("dense", mark_all_occupied(full), R, jit, K5_BUDGET),
            ("empty", empty, R, jit, K5_BUDGET),
            ("eval chunk", full, 4096, None, model._compact_budget(4096, K6_SAMPLES))):
        case(f"K5 march {label}", lambda: [v for _, v in sorted(march_rays(
            grid, cfg, steady, o[:rays], d[:rays], t_jitter=jitter,
            total_budget=budget).items())], held=True)
    if march_count_cuda is None:  # a tree without K5's kernels
        return
    for label, grid, rays, jitter, budget in (
            ("", full, R, jit, K5_BUDGET), (" dense", mark_all_occupied(full), R, jit, K5_BUDGET),
            (" empty", empty, R, jit, K5_BUDGET),
            (" eval chunk", full, 4096, None, model._compact_budget(4096, K6_SAMPLES))):
        case(f"K5a march_count{label}", lambda: [(p.state, p.total, p.num_occupied) for p in [
            march_count_cuda(grid, cfg, steady, o[:rays], d[:rays], jitter, budget)]][0])
    counted = march_count_cuda(full, cfg, steady, o, d, jit, K5_BUDGET)
    case("K5b march_emit", lambda: [v for _, v in sorted(
        ray_marching.march_emit_cuda(counted).items())])


def baseline_against_tree(tree: Path) -> dict:
    """Every kernel against another checkout's (`tree`, e.g. the parent commit
    unpacked by git archive), each through its own tree's wrappers, in turns:
    tree_measurements in a process of its own from the tree, from this
    checkout, from this checkout, from the tree. K3, K4 and P1 must give the
    tree's bits at every case; K1 and K2 on the DINO chain within 2e-2 (of
    each tensor's largest entry for K2); every case's bits must repeat
    across this checkout's two processes. Returns {case: the four readings
    in turns, their means, and whether the bits are the tree's}."""
    here = Path(__file__).resolve()
    save = Path(tempfile.mkdtemp(prefix="umhs_baseline_"))
    turns = []
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for i, root in enumerate((tree, here.parent, here.parent, tree)):
        (save / str(i)).mkdir()
        turns.append(in_tree(root, "tree_measurements", str(save / str(i))))
    result = {}
    k6_tree = (tree / "umhs_torch" / "ops" / "compact.py").exists()
    k5_tree = (tree / "umhs_torch" / "csrc" / "march.cu").exists()
    for name in turns[0]:
        r = [t[name] for t in turns]
        check(r[1]["digest"] == r[2]["digest"], f"{name}: this checkout's bits do not repeat")
        entry = {"same_bits": r[0]["digest"] == r[1]["digest"] == r[3]["digest"]}
        for key in ("ms", "call_ms"):
            if any(v.get(key) is None for v in r):
                continue
            entry[f"turns_{key}"] = [v[key] for v in r]
            entry[f"baseline_{key}"] = (r[0][key] + r[3][key]) / 2
            entry[f"this_{key}"] = (r[1][key] + r[2][key]) / 2
        # K5: a tree before the budget scale's one-division repair rounds it
        # apart (rarely); K6c and K6d's forward give the bits of a tree with
        # K6's kernels, K6d's backward's weights sum in autograd's order
        held_k5 = name.startswith("K5") and k5_tree
        held_k6 = k6_tree and (name.startswith("K6 render") or name == "K6 segment_accumulate_fwd")
        if held_k5 or held_k6 or not name.startswith(("K1", "K2", "K5", "K6 render",
                                                      "K6 segment")):
            check(entry["same_bits"], f"{name}: not the bits of {tree}'s kernel")
        result[name] = entry
        print(f"against {tree}: {name}: " + json.dumps(entry))
    if k5_tree:  # K5a's and K5b's SASS in the tree's build beside this checkout's
        from umhs_torch.ops import _native

        built = sorted((tree / "umhs_torch" / "_build").glob("march-*.so"),
                       key=lambda f: f.stat().st_mtime)
        check(bool(built), f"K5 SASS: {tree} has no built march-*.so")
        # K5b: this checkout's instance for the flagship's k 4 and 16 slots a ray, or the
        # tree's one kernel
        for name, kernels in (("K5a", ("18march_count_kernel",)),
                              ("K5b", ("17march_emit_kernelILi4ELi16E", "17march_emit_kernel"))):
            result[f"{name} SASS"] = {
                label: next((r for r in (sass_loops(lib, k) for k in kernels)
                             if "error" not in r), {"error": f"no {kernels} in {lib.name}"})
                for label, lib in (("tree", built[-1]),
                                   ("this", _native.library_path("march.cu")))}
            print(f"against {tree}: {name} SASS: " + json.dumps(result[f"{name} SASS"]))
    theirs, ours = (torch.load(save / str(i) / "dino.pt") for i in (0, 1))
    check(torch.allclose(theirs["y"], ours["y"], rtol=2e-2, atol=2e-2),
          f"K1 dino: {tree}'s output differs by more than 2e-2")
    for a, b in ((a, b) for pa, pb in zip(theirs["grads"], ours["grads"]) for a, b in zip(pa, pb)):
        check(torch.allclose(a, b, rtol=2e-2, atol=2e-2 * float(b.abs().max())),
              f"K2 dino: {tree}'s gradients differ by more than 2e-2")
    shutil.rmtree(save, ignore_errors=True)
    print(f"kernels against {tree}: {time.perf_counter() - t0:.1f} s for four processes")
    return result


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
    shipped = results[REPEAT_SETTINGS[0][0]]
    check(shipped["identical_losses"] and shipped["adapts_equal"],
          f"two runs of the schedule with the kernels part at step {shipped['first_step_apart']}")
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


QUALITY_RUNS = {  # the quality twin's flags and its JAX target (docs/)
    "tetrahedral": ([], "tetra_2000_256.json"),
    "trilinear": (["--interp", "trilinear"], "trilinear_2000_256.json"),
    "bayspec141": (["--bands", "141", "--hs-dtype", "bfloat16", "--target-samples", "196608"],
                   "bayspec141_2000_256.json"),
}
QUALITY_PSNR_MARGIN_DB = 1.0  # ~4x the 0.26 dB seed stdev of docs/seed_variance.json
QUALITY_SAM_FACTOR = 1.25


def phase_quality(dev, runs, smi):
    """Phase 8: the quality twin (umhs_torch.scripts.quality_reference_scale)
    at 2,000 steps, 256^2, seed 42, at full width, for each configuration in
    `runs`, with the launch counts zeroed before each and read after; each
    must come within reach of its JAX target in docs/: PSNR and spectral
    PSNR at most QUALITY_PSNR_MARGIN_DB below, SAM at most QUALITY_SAM_FACTOR
    times. One eval image it wrote is read back through data/png.py."""
    from umhs_torch.data.png import read_png
    from umhs_torch.scripts import quality_reference_scale as quality

    docs = Path(__file__).resolve().parent / "docs"
    launches = {}
    for label in runs:
        flags, target_file = QUALITY_RUNS[label]
        target = json.loads((docs / target_file).read_text())["eval_all_images"]
        args = quality.parse_args(["--steps", "2000", "--image-size", "256", *flags])
        seen = {}

        def read_back(trainer):
            path = trainer.run_dir / "eval_images" / f"step-{trainer.step:09d}-0-img.png"
            seen["shape"] = read_png(path).shape

        zero_launch_counts()
        result = quality.run(args, inspect=read_back)
        launches[label] = launch_counts()
        for sym in TRAIN_KERNELS:
            check(launches[label][sym] > 0, f"quality {label}: kernel {sym} was not launched")
        got = result["eval_all_images"]
        steps_per_s = args.steps / result["train_wall_clock_s"]
        print(f"quality {label}: " + json.dumps(result))
        print(f"quality {label}: lpips_variant {result['lpips_variant']}, {steps_per_s:.1f} steps/s "
              f"over {args.steps} steps; {smi}; eval image {seen['shape']}")
        print(f"quality {label} against {target_file}: PSNR {got['psnr']} ({target['psnr']}), "
              f"spectral PSNR {got['psnr_spectral']} ({target['psnr_spectral']}), SAM "
              f"{got['sam_spectral']} ({target['sam_spectral']})")
        size = args.image_size
        check(seen["shape"] == (size, 2 * size, 3),
              f"quality {label}: eval image read back as {seen['shape']}")
        check(all(np.isfinite(v) for v in got.values()), f"quality {label}: non-finite metric")
        check(got["psnr"] >= target["psnr"] - QUALITY_PSNR_MARGIN_DB,
              f"quality {label}: PSNR {got['psnr']} below {target['psnr']} - "
              f"{QUALITY_PSNR_MARGIN_DB}")
        check(got["psnr_spectral"] >= target["psnr_spectral"] - QUALITY_PSNR_MARGIN_DB,
              f"quality {label}: spectral PSNR {got['psnr_spectral']} below "
              f"{target['psnr_spectral']} - {QUALITY_PSNR_MARGIN_DB}")
        check(got["sam_spectral"] <= QUALITY_SAM_FACTOR * target["sam_spectral"],
              f"quality {label}: SAM {got['sam_spectral']} above {QUALITY_SAM_FACTOR} x "
              f"{target['sam_spectral']}")
    return launches


SEED_VARIANCE_FLAGS = ["--seeds", "42", "43", "44", "--steps", "2000", "--image-size", "256"]


def seed_variance(smi):
    """--seed-variance: the seed-variance twin (umhs_torch.scripts.
    quality_seed_variance, each seed a process of its own) at 3 seeds, 2,000
    steps, 256^2, printed beside the JAX package's docs/seed_variance.json
    (3 seeds, 3,000 steps); every metric of every seed must be finite.
    Phase 8's gate does not read it."""
    from umhs_torch.scripts import quality_seed_variance as twin

    docs = Path(__file__).resolve().parent / "docs"
    t0 = time.perf_counter()
    result = twin.main([*SEED_VARIANCE_FLAGS, "--out",
                        str(Path("outputs") / "seed_variance_2000_256.json")])
    seconds = time.perf_counter() - t0
    jax = json.loads((docs / "seed_variance.json").read_text())
    print("seed variance: " + json.dumps(result))
    print(f"seed variance: {seconds:.1f} s for {len(result['per_seed'])} seeds; {smi}")
    print(f"seed variance of the JAX package (docs/seed_variance.json, "
          f"{json.dumps(jax['config'])}): " + json.dumps(jax["summary"]))
    for seed, metrics in result["per_seed"].items():
        check(all(np.isfinite(v) for v in metrics.values()), f"seed {seed}: non-finite metric")


# phase 9: the user's entry points, at full width
ENTRY_FRAMES = 8
ENTRY_OUTPUTS = ("rgb", "abundances_0", "wv_10", "seg_pred")  # the README's list
ENTRY_MIN_PSNR = 25.0  # phase 7 read 28.47 dB on the same scene and length (PERF.md)


def entry_train_argv(root):
    """A user's command line for cli.train: the README's flags, the flagship
    model's (flagship_model_config) as dotted flags, and bench.py's trainer
    settings (bench_trainer), run to step 672 with one checkpoint there."""
    schedule_end = BENCH_WARMUP_UNTIL + BENCH_STEADY_STEPS
    return [
        "umhsnerf", "--data", str(root),
        "--pipeline.num_classes", "6", "--pipeline.model.method", "rgb+spectral",
        "--pipeline.model.temperature", "0.4", "--pipeline.model.pred_specular", "True",
        "--pipeline.model.load_vca", "True",
        "--pipeline.datamanager.train-num-rays-per-batch", "4096",
        "--experiment-name", "entry-points", "--vis", "console", "--log-gradients", "True",
        "--pipeline.model.grid-resolution", "128", "--pipeline.model.grid-levels", "4",
        "--pipeline.model.num-candidates", "1024", "--pipeline.model.max-samples-per-ray", "64",
        "--pipeline.model.cone-angle", "0.004", "--pipeline.model.hash-num-levels", "16",
        "--pipeline.model.hash-features-per-level", "2",
        "--pipeline.model.log2-hashmap-size", "19",
        "--pipeline.model.hash-interpolation", "tetrahedral",
        "--pipeline.model.stage-boundaries", "8,16", "--pipeline.model.march-pool", "4",
        "--pipeline.model.occ-warmup-full-every", "2",
        "--trainer.adapt-steps", ",".join(str(s) for s in BENCH_ADAPT_STEPS),
        "--trainer.adapt-prefetch-steps", str(BENCH_PREFETCH), "--trainer.adapt-every", "0",
        "--optimizers.fields.optimizer.lr", "2e-2",
        "--optimizers.fields.scheduler.max-steps", "10000",
        "--mixed-precision", "True", "--machine.seed", "42",
        "--pipeline.datamanager.eval-num-rays-per-batch", "1024",
        "--max-num-iterations", str(schedule_end), "--steps-per-save", str(schedule_end),
    ]


def config_differences(a, b, prefix=""):
    """The dotted names of the fields in which two config dataclasses differ."""
    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x) and dataclasses.is_dataclass(y):
            out += config_differences(x, y, f"{prefix}{f.name}.")
        elif x != y:
            out.append(f"{prefix}{f.name}: {x!r} vs {y!r}")
    return out


def orbit_path_json(n, size, fov):
    """A camera path of `n` frames on an orbit of radius 1 (the dataparser's
    scaled space) around the origin."""
    from umhs_torch.data.synthetic import _look_at

    path = []
    for i in range(n):
        theta, phi = 2 * np.pi * i / n, 0.5
        eye = np.array([np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)])
        path.append({"camera_to_world": _look_at(eye, np.zeros(3)).reshape(-1).tolist(),
                     "fov": fov, "aspect": 1.0})
    return {"camera_path": path, "render_height": size, "render_width": size, "fps": 8,
            "seconds": 1}


def time_loader(root):
    """load_cubes on the scene's train cubes, native and plain in turns
    (native, plain, plain, native): the same bits, and each arm's seconds."""
    from umhs_torch.data.dataset import load_cubes
    from umhs_torch.native import read_npy_header

    paths = sorted((root / "train").glob("*.npy"))
    shape = read_npy_header(paths[0]).shape
    seconds, stacks = {"auto": [], "plain": []}, {}
    for impl in ("auto", "plain", "plain", "auto"):
        t0 = time.perf_counter()
        stacks[impl] = load_cubes(paths, shape, impl=impl)
        seconds[impl].append(time.perf_counter() - t0)
    check(np.array_equal(stacks["auto"].view(np.int32), stacks["plain"].view(np.int32)),
          "load_cubes: the native loader and the plain loop disagree")
    out = {"files": len(paths), "shape": list(shape), "dtype": str(stacks["auto"].dtype),
           "bytes": int(stacks["auto"].nbytes), "native_s": seconds["auto"],
           "plain_s": seconds["plain"]}
    print("loader: " + json.dumps(out))
    return out


def phase_entry_points(dev, bench_losses, bench_adapts, bench_configs):
    """Phase 9: the user's entry points on the bench scene, at full width."""
    import threading
    import urllib.error
    import urllib.request

    from umhs_torch.cli import render as cli_render
    from umhs_torch.cli import train as cli_train
    from umhs_torch.cli import viewer as cli_viewer
    from umhs_torch.data.png import read_png
    from umhs_torch.data.synthetic import BENCH_SCENE
    from umhs_torch.utils.profiler import trace

    summary = {}
    with bench_dataset() as (work, root, write_s):
        summary["write_dataset_s"] = write_s
        summary["loader"] = time_loader(root)

        # cli.train, as a user types it
        argv = entry_train_argv(root)
        print("cli.train: python -m umhs_torch.cli.train " + " ".join(argv))
        zero_launch_counts()
        t0 = time.perf_counter()
        result = cli_train.main(argv)
        torch.cuda.synchronize()
        summary["train_s"] = time.perf_counter() - t0
        launches_train = launch_counts()
        for sym in TRAIN_KERNELS:
            check(launches_train[sym] > 0, f"kernel {sym} was not launched by cli.train")
        trainer = result.trainer
        losses = [r["metrics"]["loss/total"] for r in trainer.history]
        adapts = adapt_records(trainer)
        parted = next((i for i, (x, y) in enumerate(zip(losses, bench_losses)) if x != y),
                      None if len(losses) == len(bench_losses) else min(len(losses),
                                                                        len(bench_losses)))
        diffs = []
        for name, ours in (("trainer", trainer.config), ("model", trainer.model.config),
                           ("datamanager", trainer.datamanager.config)):
            diffs += config_differences(bench_configs[name], ours, f"{name}.")
        print(f"  resolved config against phase 7's ({len(diffs)} fields differ): "
              + json.dumps(diffs))
        if parted is not None or adapts != bench_adapts:
            fail(f"cli.train parts from phase 7: first at step {parted} of {len(losses)} "
                 f"(phase 7: {len(bench_losses)} steps), adapts equal: "
                 f"{adapts == bench_adapts}; the resolved configs differ in {diffs}")
        print(f"  cli.train: {len(losses)} losses and {len(adapts)} adapts equal phase 7's "
              f"bit for bit")
        run_dir = trainer.run_dir
        for name in ("config.yml", "metrics.jsonl", "final_metrics.json"):
            check((run_dir / name).is_file(), f"cli.train wrote no {name}")
        records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
        check(any("grad_norm/total" in r for r in records), "metrics.jsonl has no grad_norm/total")
        final = json.loads((run_dir / "final_metrics.json").read_text())
        evals = final["eval"]
        check(evals["psnr"] >= ENTRY_MIN_PSNR,
              f"cli.train eval_all_images PSNR {evals['psnr']} below {ENTRY_MIN_PSNR}")
        summary.update(eval_all_images=evals, launches_train=launches_train,
                       metrics_records=len(records),
                       grad_norm_last={k: v for k, v in records[-1].items()
                                       if k.startswith("grad_norm/")})
        config_yml = run_dir / "config.yml"

        # cli.eval in a fresh process, on the card by default
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(Path(__file__).resolve().parent)] + [p for p in [env.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "umhs_torch.cli.eval", "--load-config", str(config_yml),
             "--output-path", str(work / "eval.json")],
            cwd=work, env=env, capture_output=True, text=True, timeout=900)
        summary["eval_subprocess_s"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"cli.eval exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                                    f"{proc.stderr[-4000:]}")
        got = json.loads((work / "eval.json").read_text())
        check(got["checkpoint_step"] == trainer.step,
              f"cli.eval loaded step {got['checkpoint_step']}, not {trainer.step}")
        check(sorted(got["results"]) == sorted(evals), "cli.eval reports other metrics")
        rel = {k: abs(got["results"][k] - v) / max(abs(v), 1e-30) for k, v in evals.items()}
        worst = max(rel, key=rel.get)
        print(f"  cli.eval (subprocess, {summary['eval_subprocess_s']:.1f} s wall): largest "
              f"relative difference to final_metrics.json {rel[worst]:.3g} ({worst})")
        check(rel[worst] <= 1e-6, f"cli.eval's {worst} differs from final_metrics.json by "
                                  f"{rel[worst]}")
        summary["eval_max_rel_diff"] = rel[worst]

        # cli.render camera-path
        size = BENCH_SCENE.image_size
        path_json = orbit_path_json(ENTRY_FRAMES, size, 50.0)
        (work / "orbit.json").write_text(json.dumps(path_json))
        zero_launch_counts()
        t0 = time.perf_counter()
        rendered = cli_render.main([
            "camera-path", "--load-config", str(config_yml),
            "--camera-path-filename", str(work / "orbit.json"),
            "--output-path", str(work / "renders" / "orbit.mp4"),
            "--rendered-output-names", *ENTRY_OUTPUTS])
        summary["render_s"] = time.perf_counter() - t0
        launches_render = launch_counts()
        for sym in RENDER_KERNELS:
            check(launches_render[sym] > 0, f"kernel {sym} was not launched by cli.render")
        for sym in set(TRAIN_KERNELS) - set(RENDER_KERNELS):
            check(launches_render[sym] == 0, f"cli.render launched {sym}")
        frames = sorted(rendered.written.glob("frame_*.png"))
        check(len(frames) == ENTRY_FRAMES, f"cli.render wrote {len(frames)} frames")
        tiles = len(ENTRY_OUTPUTS)
        for fr in frames:
            check(read_png(fr).shape == (size, size * tiles, 3),
                  f"{fr.name} reads back as {read_png(fr).shape}")
        cam0 = path_json["camera_path"][0]
        c2w = np.asarray(cam0["camera_to_world"], np.float32).reshape(4, 4)[:3]
        focal = 0.5 * size / np.tan(0.5 * np.deg2rad(cam0["fov"]))
        with uncounted():
            ref = cli_render.render_outputs(
                trainer, cli_render.camera_dict(c2w, focal, size, size, dev), size, size)
        ref_rgb = (np.clip(ref["rgb"], 0, 1) * 255).astype(np.uint8)
        check(np.array_equal(read_png(frames[0])[:, :size], ref_rgb),
              "frame 0's rgb tile differs from Trainer.render_camera on the same rays")
        frame_ms = [1e3 * s for s in rendered.frame_s]
        print(f"  cli.render: {len(frames)} frames of {size}x{size * tiles} "
              f"({', '.join(ENTRY_OUTPUTS)}), {np.mean(frame_ms[1:]):.1f} ms per frame past the "
              f"first ({frame_ms[0]:.1f}); frame 0's rgb equals render_camera bit for bit")
        summary.update(render_ms_per_frame=frame_ms, launches_render=launches_render)

        # the viewer on a free port, one request one render
        zero_launch_counts()
        server = cli_viewer.make_server(["--load-config", str(config_yml), "--port", "0",
                                         "--resolution", str(size)])
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        view = "theta=0.8&phi=0.5&radius=1.0&fov=50"
        request_ms = {}
        try:
            check(b"umhs" in urllib.request.urlopen(base + "/", timeout=60).read(),
                  "viewer: / is not the page")
            names = json.loads(urllib.request.urlopen(base + "/outputs", timeout=60).read())
            check("rgb" in names and "abundances_0" in names, f"viewer outputs {names}")
            for out in ("rgb", "depth", "abundances_0"):
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    png = urllib.request.urlopen(f"{base}/render?{view}&output={out}",
                                                 timeout=120).read()
                    times.append(1e3 * (time.perf_counter() - t0))
                (work / f"view_{out}.png").write_bytes(png)
                shape = read_png(work / f"view_{out}.png").shape
                check(shape == (size, size, 3), f"viewer /render {out}: PNG of shape {shape}")
                request_ms[out] = times
            try:
                urllib.request.urlopen(f"{base}/render?{view}&output=no_such_output", timeout=60)
                fail("viewer: an unknown output did not fail")
            except urllib.error.HTTPError as e:
                check(e.code == 500, f"viewer: an unknown output returned {e.code}, not 500")
            with trace(work / "profiles") as trace_path:
                urllib.request.urlopen(f"{base}/render?{view}&output=rgb", timeout=120).read()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        check(not thread.is_alive(), "the viewer's server thread did not stop")
        launches_viewer = launch_counts()
        for sym in RENDER_KERNELS:
            check(launches_viewer[sym] > 0, f"kernel {sym} was not launched by the viewer")
        for sym in set(TRAIN_KERNELS) - set(RENDER_KERNELS):
            check(launches_viewer[sym] == 0, f"the viewer launched {sym}")
        check(trace_path.is_file(), "profiler.trace wrote no Chrome trace")
        text = trace_path.read_text()
        named = {sym: [k for k in KERNEL_NAMES[sym] if k in text]
                 for sym in ("umhs_mlp_fused_fwd", "umhs_hash_encode_fwd")}
        device_kernels = sorted({e.get("name", "")[:80] for e in json.loads(text)["traceEvents"]
                                 if e.get("cat") == "kernel"})
        check(all(named.values()), f"the trace of one /render names {named}; its device "
                                   f"kernels: {device_kernels}")
        print(f"  viewer: ms per /render request {json.dumps(request_ms)}; unknown output "
              f"500; trace {trace_path.name} ({len(text)} bytes, {len(device_kernels)} device "
              f"kernel names) names {named}")
        summary.update(viewer_ms_per_request=request_ms, launches_viewer=launches_viewer)
        del trainer, result
    print("entry points: " + json.dumps(summary))
    return summary


def trained_run_files(run_dir: Path) -> dict:
    """What cli.train wrote into `run_dir`: final_metrics.json, the
    checkpoints' names and the last one's applied shapes."""
    checkpoints = sorted(p.name for p in (run_dir / "umhs_models").glob("step-*"))
    shapes = run_dir / "umhs_models" / checkpoints[-1] / "dynamic_batch.json"
    return {"final": json.loads((run_dir / "final_metrics.json").read_text()),
            "checkpoints": checkpoints, "shapes": json.loads(shapes.read_text()),
            "config_yml": (run_dir / "config.yml").is_file()}


def mesh_cards(smi):
    """--mesh-cards: phase 9's cli.train command line as a user types it,
    `python -m umhs_torch.cli.train ...`, in a process of its own over
    every visible card (cli.train launches one rank per card on NCCL), then
    with --trainer.use-mesh False on one card in this process. Checked: the
    command exits 0 having launched one rank per card, and its launcher
    found every rank's final state equal bit for bit; each run wrote
    config.yml, final_metrics.json and one checkpoint; K1-K4 launched in the
    one-card run; both runs' eval_all_images PSNR at least ENTRY_MIN_PSNR.
    Printed side by side: both runs' final metrics, evals and applied
    shapes."""
    from umhs_torch.cli import train as cli_train

    cards = torch.cuda.device_count()
    check(cards > 1, f"--mesh-cards needs more than one visible card, not {cards}")
    with bench_dataset() as (work, root, _):
        argv = entry_train_argv(root)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(Path(__file__).resolve().parent)] + [p for p in [env.get("PYTHONPATH")] if p])
        cmd = [sys.executable, "-m", "umhs_torch.cli.train", *argv, "--experiment-name", "cards"]
        print("--mesh-cards: python -m umhs_torch.cli.train " + " ".join(cmd[3:]))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True,
                              timeout=900)
        cards_s = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        print("\n".join(f"  | {line}" for line in lines if line.startswith("[umhs-train]")))
        check(proc.returncode == 0, f"--mesh-cards: cli.train over {cards} cards exited "
              f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-4000:]}")
        check(f"[umhs-train] data parallel: {cards} ranks, one per card, nccl" in lines,
              f"--mesh-cards: cli.train did not launch {cards} ranks")
        check(any(line.startswith(f"[umhs-train] {cards} ranks end with the same state bits")
                  for line in lines), "--mesh-cards: cli.train's launcher printed no agreement")
        run_dir = next(line.split("run_dir=", 1)[1] for line in lines
                       if line.startswith("[umhs-train] method=") and "run_dir=" in line)
        runs = {"cards": trained_run_files(work / run_dir)}

        zero_launch_counts()
        t0 = time.perf_counter()
        result = cli_train.main([*argv, "--trainer.use-mesh", "False", "--experiment-name", "one"])
        one_s = time.perf_counter() - t0
        launches_one = launch_counts()
        runs["one"] = trained_run_files(result.trainer.run_dir)
        del result
    for sym in TRAIN_KERNELS:
        check(launches_one[sym] > 0, f"--mesh-cards: kernel {sym} not launched on one card")
    summary = {"cards": cards, "backend": "nccl", "seconds": {"cards": cards_s, "one": one_s},
               "launches_one": launches_one, **{label: run for label, run in runs.items()}}
    print(f"--mesh-cards ({smi}): " + json.dumps(summary))
    for label, run in runs.items():
        check(run["config_yml"], f"--mesh-cards {label}: no config.yml")
        check(len(run["checkpoints"]) == 1, f"--mesh-cards {label}: checkpoints "
                                             f"{run['checkpoints']}, not one")
        psnr = run["final"]["eval"]["psnr"]
        check(psnr >= ENTRY_MIN_PSNR,
              f"--mesh-cards {label}: eval_all_images PSNR {psnr} below {ENTRY_MIN_PSNR}")


# phase 10: the proposal sampler (scripts/nerfacto.sh) and the DINO head
NERFACTO_STEPS = 500  # of the reference's 30,000
NERFACTO_RAYS = 8192  # scripts/nerfacto.sh
NERFACTO_FRAMES = 2
DINO_STEPS = 96
DINO_DIM = 128
# the rows each proposal level's chain and grid take at 8192 rays: 256 and 96
# samples per ray; the main field's 48 (proposals (256, 96) -> 48)
PROPOSAL_ROWS = (NERFACTO_RAYS * 256, NERFACTO_RAYS * 96)
# 10a before K4's runs route (PERF.md section 5, NVIDIA H100 80GB HBM3, 700 W):
# K4's device ms in the traced step, ms per step, the step's busy share
NERFACTO_BEFORE_RUNS = {"k4_traced_ms": 14.69, "ms_per_step": 38.28, "busy_share": 0.601}


def phase_slice_kernels(dev, ptxas):
    """K1-K4 at phase 10's shapes against their plain versions, timed: the
    proposal nets' 10 -> 16 -> 1 chain at 2,097,152 and 786,432 rows (bf16,
    the tensor cores; K2 with dx, which reaches the proposal grids), the DINO
    head's 15 -> 256 -> 128 at 262,144 rows (bf16, K1's and K2's wide
    tensor-core kernels; K2 without dx), and the proposal grids (L5 F2 2^17,
    trilinear, to resolution 128 and 256) on as many ray-ordered positions,
    K4 in the deterministic mode the proposal nets use. K1 within 2e-2 and
    K2 as k2_against_plain; K3 within atol 1e-6; K4 repeated bit for bit, at
    786,432 rows bit for bit against the plain version on the CPU, at
    2,097,152 within 1e-5 of the largest entry of the plain version on the
    card (which adds with float atomics). Each chain's K1 and K2 route is
    printed with its ptxas registers and spills, and each grid's K4 route
    per level with its entries per run (k4_route_report)."""
    from umhs_torch.data.synthetic import ray_samples
    from umhs_torch.ops.encodings import (
        HashEncodingConfig, hash_encode_bwd, hash_encode_bwd_plain, hash_encode_fwd,
        hash_encode_plain)
    from umhs_torch.ops.mlp import init_mlp
    from umhs_torch.ops.mlp_fused import (
        mlp_fused_bwd_route, mlp_fused_fwd, mlp_fused_fwd_route, mlp_plain)

    gen = torch.Generator().manual_seed(10)
    out = {"mlp_fused_fwd": {}, "mlp_fused_bwd": {}, "hash_encode_fwd": {},
           "hash_encode_bwd": {}}
    chains = {f"proposal_{i}": ([10, 16, 1], n, True) for i, n in enumerate(PROPOSAL_ROWS)}
    chains["dino"] = ([15, 256, DINO_DIM], K2_ROWS, False)
    for label, (dims, n, need_dx) in chains.items():
        params = init_mlp(gen, dims[0], len(dims) - 1, dims[1], dims[-1], dev)
        x = torch.randn((n, dims[0]), generator=gen).to(dev)
        g = torch.randn((n, dims[-1]), generator=gen).to(dev)
        y, ref = mlp_fused_fwd(params, x, torch.bfloat16), mlp_plain(params, x, torch.bfloat16)
        err = float((y - ref).abs().max())
        check(torch.allclose(y, ref, rtol=2e-2, atol=2e-2),
              f"K1 {label} {dims} N={n} bf16 disagrees with its plain version ({err})")
        del y, ref
        err2, _ = k2_against_plain(label, params, x, g, torch.bfloat16)
        base = {"dims": dims, "rows": n}
        routes = (mlp_fused_fwd_route(dims, torch.bfloat16),
                  mlp_fused_bwd_route(dims, torch.bfloat16))
        for k, route in zip(("K1", "K2"), routes):
            print(f"{k} {label} {dims} bf16 runs {route}: ptxas {json.dumps(ptxas.get(route))}")
        out["mlp_fused_fwd"][label] = {**base, "max_abs_err": err, "route": routes[0],
                                       "ptxas": ptxas.get(routes[0]), **k1_times(params, x, dims)}
        out["mlp_fused_bwd"][label] = {**base, "dx": need_dx, "max_abs_err": err2,
                                       "route": routes[1], "ptxas": ptxas.get(routes[1]),
                                       **k2_times(params, x, g, dims, need_dx)}
        print(f"K1 {label} {dims} N={n}: " + json.dumps(out["mlp_fused_fwd"][label]))
        print(f"K2 {label} {dims} N={n}: " + json.dumps(out["mlp_fused_bwd"][label]))
        del params, x, g
    for i, (n, max_res) in enumerate(zip(PROPOSAL_ROWS, (128, 256))):
        label = f"proposal_{i}"
        cfg = HashEncodingConfig(num_levels=5, max_resolution=max_res, log2_hashmap_size=17,
                                 base_resolution=16)
        pos = torch.from_numpy(ray_samples(NERFACTO_RAYS, n // NERFACTO_RAYS, seed=20 + i)).to(dev)
        table = ((torch.rand((cfg.table_size * 2,), generator=gen) * 2 - 1) * 1e-1).to(dev)
        err = float((hash_encode_fwd(table, pos, cfg) - hash_encode_plain(table, pos, cfg))
                    .abs().max())
        check(err <= 1e-6, f"K3 {label} disagrees with its plain version ({err})")
        g = torch.randn((n, cfg.output_dim), generator=gen).to(dev)
        got = hash_encode_bwd(pos, g, cfg, False)
        again = hash_encode_bwd(pos, g, cfg, False)
        check(torch.equal(bits(got), bits(again)), f"K4 {label}: a second run gave other bits")
        if n == min(PROPOSAL_ROWS):
            ref = hash_encode_bwd_plain(pos.cpu(), g.cpu(), cfg, False)
            check(torch.equal(bits(got), bits(ref)),
                  f"K4 {label}: not the plain version's bits on the CPU")
        else:
            ref = hash_encode_bwd_plain(pos, g, cfg, False)
            check(float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()),
                  f"K4 {label} disagrees with its plain version on the card")
        err4 = float((got.cpu() - ref.cpu()).abs().max())
        del got, again, ref
        pairs = n * cfg.num_levels * cfg.verts_per_cell
        base = {"rows": n, "max_resolution": max_res, "table_rows": cfg.table_size}
        out["hash_encode_fwd"][label] = {**base, "max_abs_err": err, **k3_times(table, pos, cfg)}
        out["hash_encode_bwd"][label] = {**base, "pairs": pairs, "max_abs_err": err4,
                                         **k4_times(pos, g, cfg, False),
                                         "routes": k4_route_report(label, pos, g, cfg)}
        print(f"K3 {label} L5 2^17 to {max_res}, N={n}: "
              + json.dumps(out["hash_encode_fwd"][label]))
        print(f"K4 {label} deterministic, {pairs:,} (row, entry) pairs: "
              + json.dumps(out["hash_encode_bwd"][label]))
        del pos, table, g
    return out


def nerfacto_argv(root):
    """scripts/nerfacto.sh's command line on the dataset at `root`, cut to
    NERFACTO_STEPS steps: the rgb method with the proposal sampler at 8192
    rays, seed 42, the method's defaults otherwise."""
    return [
        "umhsnerf", "--machine.seed", "42", "--pipeline.model.method", "rgb",
        "--pipeline.model.sampler", "proposal",
        "--pipeline.datamanager.train-num-rays-per-batch", str(NERFACTO_RAYS),
        "--data", str(root), "--experiment-name", "nerfacto-baseline", "--vis", "console",
        "--max-num-iterations", str(NERFACTO_STEPS), "--output-dir", str(root.parent / "outputs"),
    ]


def train_views_psnr(trainer):
    """eval_image's PSNR (RGB over black, through render_camera) on each
    training view: beside eval_all_images it tells a gap on novel views from
    a fault of the eval forward."""
    from umhs_torch.data.cameras import generate_camera_rays
    from umhs_torch.utils.metrics import psnr

    dm = trainer.datamanager
    n, h, w = dm.data["image"].shape[:3]
    out = []
    for i in range(n):
        rays = generate_camera_rays(dm.cam, i, h, w, camera_type=dm.camera_type)
        pred = trainer.render_camera(rays, (h, w))["rgb"].cpu().numpy()
        out.append(psnr(pred, trainer.model.blend_background(dm.data["image"][i]).cpu().numpy()))
    return out


def step_busy(trainer):
    """The device's busy share of a training step, without the profiler:
    the device time of one step's forward, backward and optimizer step
    (loss_and_grads and apply_gradients, no readback) enqueued behind a spin
    (held_ms), the median of five, against the median wall time of ten
    train_step() calls, each ending in its readback. One step at a time: the
    spin never held two nerfacto steps (~960 launches each), and always held
    one. The device time counts the gaps between kernels (~1-2 us each).
    None where no spin holds a step. The trainer goes on by those steps."""
    busy = [held_ms(lambda: (trainer.loss_and_grads(trainer.draw_step()),
                             trainer.apply_gradients()), iters=1) for _ in range(5)]
    busy = None if None in busy else float(np.median(busy))
    wall = []
    for _ in range(10):
        t0 = time.perf_counter()
        trainer.train_step()
        wall.append(time.perf_counter() - t0)
    wall_ms = 1e3 * float(np.median(wall))
    return {"device_ms": busy, "wall_ms": wall_ms,
            "busy_share": None if busy is None else busy / wall_ms}


def host_syncs(fn):
    """The calls in fn() (a training step, a render) that make the host wait
    for the device, by source line: fn runs once under
    torch.cuda.set_sync_debug_mode("warn"), which warns at each. A step with
    such a wait cannot be held behind a spin (device_ms), and the device
    idles while the host catches up after each."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = (f"{Path(w.filename).parent.name}/{Path(w.filename).name}:{w.lineno} "
                    f"{str(w.message)[:80]}")
            sites[site] = sites.get(site, 0) + 1
    return sites


def repeat_bit_for_bit(make_trainer, steps, label):
    """Two Trainers from make_trainer() run train(steps) beside the main path
    (their launches uncounted): every loss equal bit for bit."""
    runs = []
    with uncounted():
        for _ in range(2):
            t = make_trainer()
            t.train(steps)
            runs.append([r["metrics"]["loss/total"] for r in t.history])
            del t
    parted = next((i for i, (x, y) in enumerate(zip(*runs)) if x != y), None)
    out = {"identical_losses": parted is None and len(runs[0]) == len(runs[1]) == steps,
           "first_step_apart": parted}
    print(f"{label}: train({steps}) twice from seed 0: " + json.dumps(out))
    check(out["identical_losses"], f"{label}: train({steps}) repeated parts at step {parted}")
    return out


def phase_nerfacto(dev):
    """Phase 10a: scripts/nerfacto.sh through cli.train on the bench scene,
    its render, a repeat and the kernel-vs-plain step at its shapes."""
    from umhs_torch.cli import render as cli_render
    from umhs_torch.cli import train as cli_train
    from umhs_torch.configs import load_config
    from umhs_torch.data.png import read_png
    from umhs_torch.data.synthetic import BENCH_SCENE
    from umhs_torch.engine.trainer import Trainer

    summary = {}
    with bench_dataset() as (work, root, write_s):
        argv = nerfacto_argv(root)
        print("cli.train (scripts/nerfacto.sh): python -m umhs_torch.cli.train " + " ".join(argv))
        zero_launch_counts()
        t0 = time.perf_counter()
        result = cli_train.main(argv)
        torch.cuda.synchronize()
        summary["train_s"] = time.perf_counter() - t0
        launches_train = launch_counts()
        for sym in PROPOSAL_TRAIN_KERNELS:
            check(launches_train[sym] > 0, f"nerfacto: kernel {sym} was not launched by cli.train")
        for sym in MARCH_KERNELS + OCC_KERNELS:  # no occupancy grid
            check(launches_train[sym] == 0, f"nerfacto: cli.train launched {sym}")
        trainer = result.trainer
        cfg = trainer.model.config
        check(cfg.sampler == "proposal" and cfg.num_proposal_samples == (256, 96)
              and cfg.num_nerf_samples == 48 and trainer.dyn.rays == NERFACTO_RAYS
              and cfg.compute_dtype == "bfloat16", f"nerfacto: resolved to {cfg}")
        losses = [r["metrics"]["loss/total"] for r in trainer.history]
        check(len(losses) == NERFACTO_STEPS and all(np.isfinite(losses)),
              "nerfacto: non-finite losses or a short run")
        check(all(r["occ_update"] is None for r in trainer.history) and not trainer.adapt_log,
              "nerfacto: an occupancy update or an adapt ran")
        config_yml = trainer.run_dir / "config.yml"
        config = load_config(config_yml)

        def from_config(seed):
            tc = dataclasses.replace(config.trainer, seed=seed, save_final=False)
            return Trainer(tc, config.pipeline.model, config.pipeline.datamanager,
                           num_classes=config.pipeline.num_classes, device=dev).setup()

        with uncounted():  # the step-0 eval batch of the same run (seed 42); the train views
            fresh = from_config(config.trainer.seed)
            psnr0 = fresh.eval_batch()["psnr"]
            del fresh
            train_views = train_views_psnr(trainer)
        evals = result.evals
        print(f"  nerfacto: {NERFACTO_STEPS} steps of {NERFACTO_RAYS} rays in "
              f"{summary['train_s']:.1f} s (cli.train, with its eval_all_images); eval_batch PSNR "
              f"{psnr0:.2f} dB at step 0, eval_all_images PSNR {evals['psnr']:.2f} dB at step "
              f"{trainer.step}, the training views' {np.mean(train_views):.2f} dB (the same "
              f"render and metric; last batch {trainer.history[-1]['metrics']['psnr']:.2f}); "
              f"launches {json.dumps(launches_train)}")
        check(all(np.isfinite(v) for v in evals.values()), "nerfacto: non-finite eval metric")
        check(evals["psnr"] >= psnr0 + 5.0,
              f"nerfacto: eval_all_images PSNR {evals['psnr']} not 5 dB above step 0's {psnr0}")
        steps_s = [r["step_s"] for r in trainer.history[16:]]
        summary.update(eval_batch_psnr_step0=psnr0, eval_all_images=evals,
                       train_views_psnr=train_views,
                       loss_first16=float(np.mean(losses[:16])),
                       loss_last16=float(np.mean(losses[-16:])),
                       ms_per_step=1e3 * float(np.mean(steps_s)),
                       rays_per_s=NERFACTO_RAYS / float(np.mean(steps_s)),
                       last_metrics=trainer.history[-1]["metrics"], launches_train=launches_train)

        size = BENCH_SCENE.image_size
        (work / "orbit.json").write_text(json.dumps(orbit_path_json(NERFACTO_FRAMES, size, 50.0)))
        zero_launch_counts()
        rendered = cli_render.main([
            "camera-path", "--load-config", str(config_yml),
            "--camera-path-filename", str(work / "orbit.json"),
            "--output-path", str(work / "renders" / "orbit.mp4"),
            "--rendered-output-names", "rgb", "depth"])
        launches_render = launch_counts()
        for sym in PROPOSAL_RENDER_KERNELS:
            check(launches_render[sym] > 0, f"nerfacto: cli.render did not launch {sym}")
        for sym in set(TRAIN_KERNELS) - set(PROPOSAL_RENDER_KERNELS):
            check(launches_render[sym] == 0, f"nerfacto: cli.render launched {sym}")
        frames = sorted(rendered.written.glob("frame_*.png"))
        check(len(frames) == NERFACTO_FRAMES and all(
            read_png(f).shape == (size, 2 * size, 3) for f in frames),
            f"nerfacto: cli.render wrote {len(frames)} frames")
        frame_ms = [1e3 * t for t in rendered.frame_s]
        print(f"  nerfacto cli.render: {len(frames)} frames of {size}x{2 * size} (rgb, depth), "
              f"ms per frame {frame_ms}; launches {json.dumps(launches_render)}")
        summary.update(render_ms_per_frame=frame_ms, launches_render=launches_render)

        before = launch_counts()
        prof = profile("nerfacto step", trainer.train_step)
        per_step = {k: v - before[k] for k, v in launch_counts().items()}
        for sym in PROPOSAL_TRAIN_KERNELS:
            k = prof["kernels"][sym]
            print(f"  {sym} in the traced nerfacto step: {k['ms']:.3f} ms of device time, "
                  f"{per_step[sym]} launches ({k['device_kernels']} device kernels)")
        summary["profiled_step"] = {**prof, "kernel_launches_by_wrapper": per_step}

        t0 = time.perf_counter()
        summary["repeat"] = repeat_bit_for_bit(lambda: from_config(0), TRAIN_STEPS, "nerfacto")
        summary["repeat_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with uncounted():
            summary["vs_plain"] = phase_train_vs_plain(
                trainer, dev, f"nerfacto at step {trainer.step}, {NERFACTO_RAYS} rays")
            summary["vs_plain_s"] = time.perf_counter() - t0
            summary["host_syncs"] = host_syncs(trainer.train_step)
            summary["busy"] = step_busy(trainer)
        print("  nerfacto step: host syncs by source line "
              + json.dumps(summary["host_syncs"]) + "; without the profiler "
              + json.dumps(summary["busy"]))
        now = {"k4_traced_ms": prof["kernels"]["umhs_hash_encode_bwd"]["ms"],
               "ms_per_step": summary["ms_per_step"], "busy_share": summary["busy"]["busy_share"]}
        print("  nerfacto against the step before K4's runs route: "
              + json.dumps({k: {"now": now[k], "before": v}
                            for k, v in NERFACTO_BEFORE_RUNS.items()}))
        del trainer, result
    print("nerfacto: " + json.dumps(summary))
    return summary


def dino_step_checks(trainer, dev):
    """The DINO head on the trained flagship at step 3001 (the cluster loss
    in the sum): the kernel-vs-plain step over every leaf, and the hash
    table's gradient the same bits with the DINO terms and without them."""
    from umhs_torch.engine.trainer import named_leaves

    saved = trainer.state
    trainer.state = dict(saved, step=3001)
    try:
        vs_plain = phase_train_vs_plain(trainer, dev, "flagship with pred_dino at step 3001")
        gen_state = trainer._step_gen.get_state()
        draws = trainer.draw_step()
        trainer._step_gen.set_state(gen_state)
        rays, batch = trainer.datamanager.sample(trainer.dyn.rays, draws["pixels"])
        params = trainer.state["params"]
        out = trainer.model.forward(params, trainer.state["occ"], rays,
                                    compact_budget=trainer.dyn.compact_budget, step=3001,
                                    train=True, t_jitter=draws["t_jitter"],
                                    march_config=trainer.dyn.march)
        loss = trainer.model.loss(out, batch, draws["background"], step=3001)
        check(float(loss["cluster_loss"].detach()) != 0.0,
              "pred_dino: no cluster loss at step 3001")
        dino = loss["dino_mse"] + loss["cluster_loss"]
        rest = sum(v for k, v in loss.items() if k not in ("dino_mse", "cluster_loss"))
        table = params["hash_table"]
        g_rest = torch.autograd.grad(rest, table, retain_graph=True)[0]
        g_all = torch.autograd.grad(rest + dino, table, retain_graph=True)[0]
        names, leaves = zip(*named_leaves(params))
        g_dino = torch.autograd.grad(dino, leaves, allow_unused=True)
        reached = [n for n, g in zip(names, g_dino) if g is not None and bool(g.any())]
        same = torch.equal(bits(g_rest), bits(g_all))
        print(f"  pred_dino: the hash table's gradient with the DINO terms and without: "
              f"{'the same bits' if same else 'DIFFERENT'}; the DINO terms reach {reached}")
        check(same, "pred_dino: the DINO terms change the hash table's gradient")
        check(sorted(reached) == ["dino_clusters", "dino_mlp.layers.0.b", "dino_mlp.layers.0.w",
                                  "dino_mlp.layers.1.b", "dino_mlp.layers.1.w"],
              f"pred_dino: the DINO terms reach {reached}")
    finally:
        trainer.state = saved
    return {"vs_plain": vs_plain, "hash_table_gradient_unchanged": same, "dino_reaches": reached}


def phase_dino(dev):
    """Phase 10b: phase 7's flagship with pred_dino on the bench scene with
    DINO sidecars: train(96), the DINO chain's routes, the step checks and a
    render of one eval view."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from umhs_torch.data.synthetic import write_dino_sidecars
    from umhs_torch.ops.mlp_fused import mlp_fused_bwd_route, mlp_fused_fwd_route

    summary = {}
    with bench_dataset() as (work, root, write_s):
        write_dino_sidecars(root, DINO_DIM, seed=0)
        t0 = time.perf_counter()
        trainer = bench_trainer(root, dev, pred_dino=True)
        check("dino_feat" in trainer.datamanager.data, "pred_dino: no DINO features staged")
        zero_launch_counts()
        t1 = time.perf_counter()
        trainer.train(DINO_STEPS)
        torch.cuda.synchronize()
        summary["train_s"] = time.perf_counter() - t1
        summary["setup_s"] = t1 - t0
        launches = launch_counts()
        for sym in TRAIN_KERNELS:
            check(launches[sym] > 0, f"pred_dino: kernel {sym} was not launched in training")
        check(trainer.dyn.rays == 4096, f"pred_dino: trained at {trainer.dyn.rays} rays")
        mse = [r["metrics"]["loss/dino_mse"] for r in trainer.history]
        first, last = float(np.mean(mse[:8])), float(np.mean(mse[-8:]))
        print(f"  pred_dino: train({DINO_STEPS}) at 4096 rays in {summary['train_s']:.1f} s; "
              f"dino_mse {first:.5f} (first 8 steps) -> {last:.5f} (last 8); "
              f"launches {json.dumps(launches)}")
        check(all(np.isfinite(mse)) and last < first, f"pred_dino: dino_mse {first} -> {last}")

        dims = [15, 256, DINO_DIM]
        routes = [mlp_fused_fwd_route(dims, torch.bfloat16),
                  mlp_fused_bwd_route(dims, torch.bfloat16)]
        before = launch_counts()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.train_step()
            torch.cuda.synchronize()
        per_step = {k: v - before[k] for k, v in launch_counts().items()}
        events = [e for e in prof.key_averages() if "CUDA" in str(e.device_type)]
        wide = {name: {"device_kernels": sum(e.count for e in events if name in e.key),
                       "ms": sum(e.self_device_time_total for e in events if name in e.key) / 1e3}
                for name in routes}
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        print(f"  pred_dino: the DINO chain {dims} runs K1's {routes[0]} and K2's {routes[1]} "
              f"(bf16); in a traced step, of {busy_ms:.1f} ms of device time: {json.dumps(wide)}")
        check(routes == ["mlp_fused_fwd_wide_kernel", "mlp_fused_bwd_wide_kernel"],
              f"pred_dino: the DINO chain takes {routes}, not the wide tensor-core kernels")
        check(all(v["device_kernels"] > 0 for v in wide.values()),
              f"pred_dino: the wide kernels did not run in the step: {wide}")
        summary.update(dino_mse_first8=first, dino_mse_last8=last, launches_train=launches,
                       dino_chain_routes=routes, dino_kernels_in_step=wide,
                       launches_per_step=per_step, traced_step_device_ms=busy_ms)
        with uncounted():
            summary.update(dino_step_checks(trainer, dev))
            rays, _, hw = trainer.datamanager.eval_image(0)
            out = trainer.render_camera(rays, hw)
        dino = out["dino"]
        check(tuple(dino.shape) == (*hw, DINO_DIM) and bool(torch.isfinite(dino).all()),
              f"pred_dino: render_camera gave dino of shape {tuple(dino.shape)}")
        summary["render_dino_abs_max"] = float(dino.abs().max())
        del trainer, out, dino
    print("pred_dino: " + json.dumps(summary))
    return summary


def phase_10(dev, ptxas):
    """Phase 10, each part timed: the kernels at its shapes, 10a, 10b."""
    seconds, results = {}, []
    for label, fn in (("kernels", lambda d: phase_slice_kernels(d, ptxas)),
                      ("10a nerfacto", phase_nerfacto), ("10b pred_dino", phase_dino)):
        t0 = time.perf_counter()
        results.append(fn(dev))
        seconds[label] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print("phase 10 seconds: " + json.dumps(seconds))
    return results


# ---------------------------------------------------------------------------
# phase 11: data-parallel training (umhs_torch/parallel/mesh.py)
# ---------------------------------------------------------------------------

MESH_RANKS = 2  # 11b: two ranks on the one card, on gloo
MESH_STEPS = 32  # 11b's train() on every rank


def digest(tensors) -> dict:
    """sha1 of each tensor's bytes, by name: equal digests, equal bits."""
    import hashlib

    return {k: hashlib.sha1(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                            .numpy().tobytes()).hexdigest() for k, v in tensors.items()}


def phase_11(dev, dm, endmembers, phase5_losses, state48):
    """11a, then 11b and 11c; returns each kernel's launches in 11a's
    train(48) and, per rank, in 11b's train(32)."""
    t0 = time.perf_counter()
    launches_a = phase_mesh_one_rank(dev, dm, endmembers, phase5_losses, state48)
    t1 = time.perf_counter()
    launches_b = phase_mesh_two_ranks(endmembers)
    print(f"phase 11 seconds: " + json.dumps({"11a": t1 - t0, "11b": time.perf_counter() - t1}))
    return launches_a, launches_b


def phase_mesh_one_rank(dev, dm, endmembers, phase5_losses, state48):
    """11a: phase 5's train(48) through a mesh of one card in a real NCCL
    group (its one all_reduce a step, the broadcasts of setup): every loss
    and every state tensor must equal phase 5's bit for bit, since a sum
    over one rank divided by one changes no bit."""
    from umhs_torch.engine.trainer import Trainer, TrainerConfig
    from umhs_torch.parallel.mesh import close_mesh, free_port, init_mesh

    mesh = init_mesh(0, 1, "nccl", dev, f"tcp://127.0.0.1:{free_port()}")
    try:
        check((mesh.size, mesh.backend) == (1, "nccl"), f"11a: a mesh of {mesh}")
        trainer = Trainer(TrainerConfig(seed=0, mixed_precision=True, save_final=False),
                          flagship_model_config(), num_classes=6, datamanager=dm, mesh=mesh)
        trainer.setup(endmembers)
        zero_launch_counts()
        trainer.train(TRAIN_STEPS)
        launches = launch_counts()
        state = trainer.state_tensors()
    finally:
        close_mesh(mesh)
    for sym in TRAIN_KERNELS:
        check(launches[sym] > 0, f"11a: kernel {sym} was not launched through the mesh")
    losses = [r["metrics"]["loss/total"] for r in trainer.history]
    parted = next((i for i, (x, y) in enumerate(zip(phase5_losses, losses)) if x != y), None)
    differ = sorted(k for k, v in state48.items() if not (
        torch.equal(bits(v), bits(state[k])) if v.is_floating_point()
        else torch.equal(v, state[k].cpu())))
    out = {"identical_losses": parted is None and len(losses) == len(phase5_losses),
           "first_step_apart": parted, "state_tensors_differing": differ,
           "launches": launches}
    print(f"11a, mesh of one card (nccl), train({TRAIN_STEPS}) against phase 5: "
          + json.dumps(out))
    check(out["identical_losses"], f"11a: losses part from phase 5's at step {parted}")
    check(not differ, f"11a: state tensors differ from phase 5's: {differ}")
    return launches


def mesh_values_and_grads(trainer, draws):
    """trainer.reduced_step(draws): its values as floats (one readback) and
    every gradient the step reached (cloned, then cleared)."""
    from umhs_torch.engine.trainer import named_leaves

    out = trainer.reduced_step(draws)
    values = dict(zip(out, torch.stack([torch.as_tensor(v, dtype=torch.float32, device=v.device)
                                        for v in out.values()]).tolist()))
    grads = {}
    for n, p in named_leaves(trainer.state["params"]):
        if p.grad is not None:
            grads[n] = p.grad.clone()
        p.grad = None
    return values, grads


def mesh_vs_one_process(t, mesh, make_trainer):
    """11b's step check: on VS_PLAIN_DRAWS global draws at t's state and
    shapes, the ranks' reduced step (bf16, deterministic hash gradient)
    against one process's step on the same draws, under phase 6's gate: each
    gradient in norm and each loss term within VS_PLAIN_RTOL["bfloat16"] of
    the one-process value plus SPREAD_FACTOR times the change of the one-
    process step from the parameters moved one ulp. Rank 0 computes the
    readings; every rank takes part in the reduced steps."""
    cfg = dataclasses.replace(t.model.config, stochastic_hash_grad=False)
    ranks, solo = make_trainer(cfg, mesh), make_trainer(cfg, None)
    gen_state = t._step_gen.get_state()
    draws = [t.draw_step() for _ in range(VS_PLAIN_DRAWS)]
    t._step_gen.set_state(gen_state)
    rtol, loss_rtol = VS_PLAIN_RTOL["bfloat16"]
    readings, flat = [], None
    for i, d in enumerate(draws):
        ranks.state, ranks.dyn = t.state, t.dyn
        v2, g2 = mesh_values_and_grads(ranks, d)
        flat = sum(g.numel() for g in g2.values()) + len(v2)
        if mesh.rank != 0:
            continue
        solo.state, solo.dyn = t.state, t.dyn
        v1, g1 = mesh_values_and_grads(solo, d)
        solo.state = dict(t.state, params=moved_one_ulp(t.state["params"], i + 1, mesh.device))
        vm, gm = mesh_values_and_grads(solo, d)
        terms = [k for k in v1 if k.startswith("loss/")]
        counts = [k for k in v1 if k.endswith("_per_batch")]
        readings.append({
            "loss": {k: abs(v2[k] - v1[k]) / (loss_rtol * abs(v1[k])
                                              + SPREAD_FACTOR * abs(vm[k] - v1[k]) + 1e-30)
                     for k in terms},
            "grad": {n: float((g2[n] - g).norm()) / (
                rtol * float(g.norm()) + SPREAD_FACTOR * float((gm[n] - g).norm()) + 1e-30)
                for n, g in g1.items()},
            "grads_reached": [sorted(g2) == sorted(g1)],
            "counts": {k: [v2[k], v1[k]] for k in counts},
        })
        del g1, gm
    return readings, flat


def mesh_rank(mesh, endmembers):
    """11b on one rank (run by umhs_torch.parallel.mesh.launch, as cli.train runs
    its ranks): the bench scene, phase 5's configuration over the mesh,
    train(MESH_STEPS) with the launch counts zeroed before and read after;
    then, uncounted: a partial occupancy update, the step against one
    process, one eval view rendered ray-sharded (and, on rank 0, in one
    process), the all_reduce of the step's flat buffer timed, and
    train(MESH_STEPS) again from seed 0. Returns what the parent checks."""
    import torch.distributed as dist

    from umhs_torch.data.cameras import generate_camera_rays
    from umhs_torch.data.datamanager import DataManagerConfig, InMemoryDataManager
    from umhs_torch.data.synthetic import BENCH_SCENE, render_views, scene_cameras
    from umhs_torch.engine.trainer import Trainer, TrainerConfig
    from umhs_torch.ops import row_gather  # noqa: F401  (registers P1's count, read below)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    scene = BENCH_SCENE
    poses, cubes, rgba = render_views(scene, scene.num_views_train, 0.0)
    dm = InMemoryDataManager(rgba, scene_cameras(scene, poses), hs_images=cubes,
                             config=DataManagerConfig(train_num_rays_per_batch=4096),
                             wavelengths=scene.wavelengths, device=dev)

    def make_trainer(cfg=None, on=mesh):
        return Trainer(TrainerConfig(seed=0, mixed_precision=True, save_final=False),
                       cfg or flagship_model_config(), num_classes=6, device=dev,
                       datamanager=dm, mesh=on)

    t = make_trainer().setup(endmembers)
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.train(MESH_STEPS)
    torch.cuda.synchronize()
    out = {"train_s": time.perf_counter() - t0, "launches": launch_counts(),
           "metrics": [r["metrics"] for r in t.history],
           "step_ms": [1e3 * r["step_s"] for r in t.history if r["occ_update"] is None],
           "state": digest(t.state_tensors())}
    with uncounted():
        t.update_occupancy(full=False)
        out["occ_after_update"] = digest(t.state["occ"])
        out["vs_one_process"], flat = mesh_vs_one_process(t, mesh, make_trainer)
        poses_eval, _, _ = render_views(scene, scene.num_views_eval, 0.13)
        cam = scene_cameras(scene, poses_eval).to_device_dict(dev)
        size = scene.image_size
        rays = generate_camera_rays(cam, 0, size, size)
        view = t.render_camera(rays, (size, size), step=1000)
        out["render_digest"] = digest(view)
        if mesh.rank == 0:
            solo = make_trainer(on=None)
            solo.state = t.state
            alone = solo.render_camera(rays, (size, size), step=1000)
            # phase 4's outputs; depth is clipped to the range of the samples
            # of the rays rendered together (render_depth_expected), which a
            # shard narrows, as each shard's does in the JAX package
            out["render_vs_one_process"] = {
                k: float((view[k].float() - alone[k].float()).abs().max())
                for k in ("rgb", "spectral", "accumulation")}
        buf = torch.zeros(flat, device=dev)
        times = []
        for _ in range(6):
            dist.barrier()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dist.all_reduce(buf)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        out["all_reduce"] = {"bytes": 4 * flat, "s": times[1:]}
        again = make_trainer().setup(endmembers)
        again.train(MESH_STEPS)
        out["repeat_metrics"] = [r["metrics"] for r in again.history]
        out["repeat_state"] = digest(again.state_tensors())
    return out


def phase_mesh_two_ranks(endmembers):
    """11b: two ranks on the one card (gloo by name: NCCL refuses two ranks
    on one device) through umhs_torch.parallel.mesh.launch, the launcher of
    cli.train, at the flagship's width in bf16, 4096 global rays (2048 a
    rank) and the initial stage budget, which drops nothing. Checked: K1-K4
    launch on every rank; both ranks read the same metrics and end with the
    same state bits, and the same occupancy bits after a partial update; on
    three draws, each loss term and gradient of the ranks' step against one
    process's under phase 6's gate (median of the draws) with the
    *_per_batch counts equal; the ray-sharded render's rgb, spectral and
    accumulation within atol 1e-3 of one process's (phase 4's check) and the
    same bits on both ranks; a
    repeat of train(MESH_STEPS) bit for bit. 11c: the wall ms per step and
    the all_reduce's seconds for the flat buffer's bytes."""
    from umhs_torch.parallel.mesh import launch

    t0 = time.perf_counter()
    results = launch(mesh_rank, MESH_RANKS, "gloo", ["cuda:0"] * MESH_RANKS, args=(endmembers,))
    wall_s = time.perf_counter() - t0
    r0 = results[0]
    for rank, r in enumerate(results):
        for sym in TRAIN_KERNELS:
            check(r["launches"][sym] > 0, f"11b: kernel {sym} was not launched on rank {rank}")
        check(json.dumps(r["metrics"]) == json.dumps(r0["metrics"]),
              f"11b: rank {rank} read other metrics than rank 0")
        check(r["state"] == r0["state"], f"11b: rank {rank} ends train({MESH_STEPS}) with other "
              f"bits: {sorted(k for k in r0['state'] if r['state'][k] != r0['state'][k])}")
        check(r["occ_after_update"] == r0["occ_after_update"],
              f"11b: rank {rank}'s occupancy update gave other bits")
        check(r["render_digest"] == r0["render_digest"], f"11b: rank {rank} rendered other bits")
        check(json.dumps(r["repeat_metrics"]) == json.dumps(r["metrics"]),
              f"11b: train({MESH_STEPS}) repeated on rank {rank} read other metrics")
        check(r["repeat_state"] == r["state"],
              f"11b: train({MESH_STEPS}) repeated on rank {rank} ends in other bits")
    losses = [m["loss/total"] for m in r0["metrics"]]
    check(all(np.isfinite(losses)), "11b: non-finite training loss")
    readings = r0["vs_one_process"]
    loss_med = {k: float(np.median([r["loss"][k] for r in readings])) for k in readings[0]["loss"]}
    grad_med = {n: float(np.median([r["grad"][n] for r in readings])) for n in readings[0]["grad"]}
    worst = max([*loss_med.items(), *grad_med.items()], key=lambda kv: kv[1])
    steady = r0["step_ms"][2:]
    ar = r0["all_reduce"]
    summary = {
        "ranks": MESH_RANKS, "backend": "gloo", "rays_per_step": 4096, "rays_per_rank": 2048,
        "launches_per_rank": [r["launches"] for r in results],
        "loss_first4": float(np.mean(losses[:4])), "loss_last4": float(np.mean(losses[-4:])),
        "vs_one_process_worst_median": list(worst),
        "vs_one_process_worst_per_draw": [
            max([*r["loss"].items(), *r["grad"].items()], key=lambda kv: kv[1])
            for r in readings],
        "counts_per_draw": [r["counts"] for r in readings],
        "render_vs_one_process_max_abs": r0["render_vs_one_process"],
        "train_s": r0["train_s"], "launch_wall_s": wall_s,
    }
    print(f"11b, {MESH_RANKS} ranks on one card (gloo), train({MESH_STEPS}) at 4096 rays: "
          + json.dumps(summary))
    print("11c (two ranks share one card and its host: this measures correctness, not "
          "scaling): " + json.dumps({
              "ms_per_step_median": float(np.median(steady)), "ms_per_step": steady,
              "all_reduce_bytes": ar["bytes"], "all_reduce_s": ar["s"],
              "all_reduce_s_median": float(np.median(ar["s"]))}))
    for r in readings:
        check(r["grads_reached"] == [True], "11b: the ranks' step reached other parameters")
        for k, (a, b) in r["counts"].items():
            check(a == b, f"11b: {k} of the ranks' step {a} != one process's {b}")
    for name, ratio in [*loss_med.items(), *grad_med.items()]:
        check(ratio <= 1.0, f"11b: {name} of the ranks' step disagrees with one process's "
                            f"({ratio} of its tolerance, median of the draws)")
    for i, r in enumerate(readings):
        for name, ratio in [*r["loss"].items(), *r["grad"].items()]:
            check(ratio <= VS_PLAIN_DRAW_CAP, f"11b: {name} on draw {i}: {ratio} of its tolerance")
    for k, err in r0["render_vs_one_process"].items():
        check(err <= 1e-3, f"11b: the ray-sharded render's {k} is {err} from one process's")
    return {sym: [r["launches"][sym] for r in results] for sym in r0["launches"]}


# phase 12: the experiment scripts' twins (umhs_torch/scripts/sh/) on the card
SCRIPT_TWINS = Path(__file__).resolve().parent / "umhs_torch" / "scripts" / "sh"
# every training twin but nerfacto.sh, which phase 10a runs
SCRIPT_TRAINING = ("hotdog.sh", "ajar.sh", "rgb+spectral.sh", "rgb.sh", "spectral.sh",
                   "instantngp.sh", "cbox_dragon.sh", "cbox_sphere.sh", "anacampseros.sh",
                   "caladium.sh", "pinecone.sh")
SCRIPT_BAYSPEC = ("anacampseros.sh", "caladium.sh", "pinecone.sh")  # 141-band captures
SCRIPT_STEPS = 256  # of the scripts' 30,000
SCRIPT_LOSS_WINDOW = 16  # gate (a): the last 16 steps' mean loss below the first 16's
SCRIPT_MS_WINDOW = 64  # ms a step over the last 64 steps
SCRIPT_FRAMES = 2  # render.sh's frames


def replace_flag(argv, flag, value):
    """argv with `flag`'s value replaced (the flag appended where absent)."""
    argv = list(argv)
    if flag in argv:
        argv[argv.index(flag) + 1] = value
        return argv
    return argv + [flag, value]


def script_train_argv(name, root, work):
    """The training twin's own argv (script_argv) with only the data, the
    output directory (the temporary one) and the length changed."""
    from umhs_torch.scripts.shell_argv import script_argv

    module, argv = script_argv(SCRIPT_TWINS / name)
    check(module == "umhs_torch.cli.train", f"{name}: runs {module}")
    for flag, value in (("--data", str(root)), ("--output-dir", str(work / "outputs")),
                        ("--max-num-iterations", str(SCRIPT_STEPS)),
                        ("--steps-per-save", str(SCRIPT_STEPS))):
        argv = replace_flag(argv, flag, value)
    return argv


def script_run(name, argv, dev, smi):
    """One training twin through cli.train in this process, with gates (a)-(d):
    the loss falls, eval_all_images PSNR above the step-0 eval batch's (a
    fresh Trainer from the run's config.yml), every kernel of the path
    launched (K7 by the occupancy updates too), and phase 6's kernel-vs-plain
    step at the run's final state and config. With gradient accumulation,
    Adam stepped on every k-th step only. Returns the run's record."""
    from umhs_torch.cli import train as cli_train
    from umhs_torch.configs import load_config
    from umhs_torch.engine.trainer import Trainer

    print(f"phase 12, {name}: python -m umhs_torch.cli.train " + " ".join(argv))
    zero_launch_counts()
    t0 = time.perf_counter()
    result = cli_train.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    trainer = result.trainer
    cfg = trainer.model.config
    want = path_kernels(cfg, train=True) + (OCC_KERNELS if cfg.sampler == "occgrid" else ())
    missing = [sym for sym in want if launches[sym] == 0]
    losses = [r["metrics"]["loss/total"] for r in trainer.history]
    first = float(np.mean(losses[:SCRIPT_LOSS_WINDOW]))
    last = float(np.mean(losses[-SCRIPT_LOSS_WINDOW:]))
    config_yml = trainer.run_dir / "config.yml"
    config = load_config(config_yml)
    with uncounted():
        fresh = Trainer(dataclasses.replace(config.trainer, save_final=False),
                        config.pipeline.model, config.pipeline.datamanager,
                        num_classes=config.pipeline.num_classes, device=dev).setup()
        psnr0 = fresh.eval_batch()["psnr"]
        del fresh
        vs = phase_train_vs_plain(trainer, dev, f"{name} at step {trainer.step}")
    k = trainer.config.gradient_accumulation_steps
    adam_steps = trainer.optimizer.updates
    ms = 1e3 * float(np.mean([r["step_s"] for r in trainer.history[-SCRIPT_MS_WINDOW:]]))
    record = {
        "script": name, "steps": trainer.step, "train_s": train_s,
        "method": cfg.method, "background": cfg.background_color,
        "pred_specular": cfg.pred_specular, "classes": trainer.model.num_classes,
        "bands": len(trainer.model.wavelengths), "rays": trainer.dyn.rays,
        "samples_per_ray": trainer.dyn.march.num_samples, "compute_dtype": cfg.compute_dtype,
        "hs_dtype": config.pipeline.datamanager.hs_dtype, "accumulation": k,
        "adam_steps": adam_steps, "ms_per_step_last64": ms, "card": smi,
        "loss_first16": first, "loss_last16": last, "psnr_step0": psnr0,
        "eval_all_images": result.evals,
        "vs_plain_worst_median": vs["worst_median_over_tolerance"],
        "launches": {s: launches[s] for s in want},
    }
    print(f"phase 12, {name}: {json.dumps(record)}")
    check(not missing, f"{name}: kernels {missing} were not launched")
    check(len(losses) == SCRIPT_STEPS and all(np.isfinite(losses)),
          f"{name}: {len(losses)} steps, finite: {all(np.isfinite(losses))}")
    check(last < first, f"{name}: the loss did not fall: {first} -> {last}")
    check(all(np.isfinite(v) for v in result.evals.values()), f"{name}: non-finite eval metric")
    check(result.evals["psnr"] > psnr0, f"{name}: eval_all_images PSNR "
                                        f"{result.evals['psnr']} not above step 0's {psnr0}")
    check(adam_steps == SCRIPT_STEPS // k and trainer.optimizer.mini_step == SCRIPT_STEPS % k,
          f"{name}: {adam_steps} Adam steps in {SCRIPT_STEPS} with accumulation {k}")
    del trainer, result
    torch.cuda.empty_cache()
    return record, config_yml


def phase_scripts(dev, smi):
    """Phase 12: the experiment scripts' twins on the card (SCRIPT_TRAINING
    through script_run on the bench scene written to disk, 128 bands, and
    the Bayspec scripts on the same scene at 141 bands), then the serving
    twins on their runs: render.sh (2 frames of an orbit), visualize/
    hotdog.sh (cli.eval in a process of its own) and visualize/ajar.sh (the
    viewer on port 0, one /render of the ajar run's seventh class)."""
    import threading
    import urllib.request

    from umhs_torch.cli import render as cli_render
    from umhs_torch.cli import viewer as cli_viewer
    from umhs_torch.data.png import read_png
    from umhs_torch.data.synthetic import BENCH_SCENE, write_dataset
    from umhs_torch.scripts.shell_argv import script_argv

    t_phase = time.perf_counter()
    records, configs = [], {}
    launches = {}
    with bench_dataset() as (work, root, _):
        root141 = write_dataset(work / "scene141", dataclasses.replace(
            BENCH_SCENE, num_bands=141, wavelength_start=400.0, wavelength_step=600.0 / 140))
        for name in SCRIPT_TRAINING:
            argv = script_train_argv(name, root141 if name in SCRIPT_BAYSPEC else root, work)
            record, configs[name] = script_run(name, argv, dev, smi)
            records.append(record)
            for sym, n in record["launches"].items():
                launches[sym] = launches.get(sym, 0) + n
        hotdog = records[SCRIPT_TRAINING.index("hotdog.sh")]

        # render.sh: its argv, the camera path a 2-frame orbit of the bench scene's size
        module, argv = script_argv(SCRIPT_TWINS / "render.sh")
        check(module == "umhs_torch.cli.render", f"render.sh runs {module}")
        check((work / argv[argv.index("--load-config") + 1]).resolve()
              == configs["hotdog.sh"].resolve(), "render.sh loads another run than hotdog.sh's")
        size = BENCH_SCENE.image_size
        (work / "orbit.json").write_text(json.dumps(orbit_path_json(SCRIPT_FRAMES, size, 50.0)))
        argv = replace_flag(argv, "--camera-path-filename", str(work / "orbit.json"))
        at = argv.index("--rendered-output-names") + 1
        names = argv[at:next((i for i in range(at, len(argv)) if argv[i].startswith("--")),
                             len(argv))]
        print("phase 12, render.sh: python -m umhs_torch.cli.render " + " ".join(argv))
        zero_launch_counts()
        rendered = cli_render.main(argv)
        got = launch_counts()
        for sym in RENDER_KERNELS:
            check(got[sym] > 0, f"render.sh did not launch {sym}")
        for sym in set(TRAIN_KERNELS) - set(RENDER_KERNELS):
            check(got[sym] == 0, f"render.sh launched {sym}")
        frames = sorted(rendered.written.glob("frame_*.png"))
        check(len(frames) == SCRIPT_FRAMES and all(
            read_png(f).shape == (size, size * len(names), 3) for f in frames),
            f"render.sh wrote {len(frames)} frames")
        serving = {"render_outputs": names, "render_ms_per_frame":
                   [1e3 * s for s in rendered.frame_s]}

        # visualize/hotdog.sh: cli.eval in a process of its own, its own argv
        module, argv = script_argv(SCRIPT_TWINS / "visualize" / "hotdog.sh")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(Path(__file__).resolve().parent)] + [p for p in [env.get("PYTHONPATH")] if p])
        print(f"phase 12, visualize/hotdog.sh: python -m {module} " + " ".join(argv))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=work, env=env,
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"visualize/hotdog.sh exited {proc.returncode}:\n"
                                    f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        got = json.loads((work / argv[argv.index("--output-path") + 1]).read_text())
        rel = {k: abs(got["results"][k] - v) / max(abs(v), 1e-30)
               for k, v in hotdog["eval_all_images"].items()}
        check(got["checkpoint_step"] == SCRIPT_STEPS and max(rel.values()) <= 1e-6,
              f"visualize/hotdog.sh: step {got['checkpoint_step']}, differences {rel}")
        serving.update(eval_s=time.perf_counter() - t0, eval_max_rel_diff=max(rel.values()))

        # visualize/ajar.sh: the viewer of the ajar run, on port 0, one /render
        module, argv = script_argv(SCRIPT_TWINS / "visualize" / "ajar.sh")
        check(module == "umhs_torch.cli.viewer", f"visualize/ajar.sh runs {module}")
        argv = replace_flag(argv, "--load-config", str(configs["ajar.sh"]))  # its run's name
        argv = replace_flag(replace_flag(argv, "--port", "0"), "--resolution", str(size))
        print("phase 12, visualize/ajar.sh: python -m umhs_torch.cli.viewer " + " ".join(argv))
        zero_launch_counts()
        server = cli_viewer.make_server(argv)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        classes = records[SCRIPT_TRAINING.index("ajar.sh")]["classes"]
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            outputs = json.loads(urllib.request.urlopen(base + "/outputs", timeout=60).read())
            check(f"abundances_{classes - 1}" in outputs, f"the ajar viewer outputs {outputs}")
            t0 = time.perf_counter()
            png = urllib.request.urlopen(f"{base}/render?theta=0.8&phi=0.5&radius=1.0&fov=50"
                                         f"&output=abundances_{classes - 1}", timeout=120).read()
            serving["viewer_ms"] = 1e3 * (time.perf_counter() - t0)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        (work / "ajar_view.png").write_bytes(png)
        check(read_png(work / "ajar_view.png").shape == (size, size, 3),
              "visualize/ajar.sh: /render is not a PNG of the view")
        got = launch_counts()
        for sym in RENDER_KERNELS:
            check(got[sym] > 0, f"visualize/ajar.sh's viewer did not launch {sym}")
    seconds = time.perf_counter() - t_phase
    print(f"phase 12: {len(records)} training twins at {SCRIPT_STEPS} steps and the serving "
          f"twins in {seconds:.1f} s; {smi}; serving " + json.dumps(serving))
    for r in records:
        print(f"  {r['script']}: {r['ms_per_step_last64']:.2f} ms a step (last 64), PSNR "
              f"{r['psnr_step0']:.2f} -> {r['eval_all_images']['psnr']:.2f} dB, loss "
              f"{r['loss_first16']:.5f} -> {r['loss_last16']:.5f}, vs plain "
              f"{json.dumps(r['vs_plain_worst_median'])}")
    return {"seconds": seconds, "runs": records, "serving": serving, "launches": launches}


SASS_INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
SASS_COUNTED = ("LDG", "SHFL", "MUFU", "VOTE", "POPC", "BAR")  # opcode stems counted per loop


def sass_loops(library: Path, kernel: str) -> dict:
    """The static SASS of the one device function of a built library whose
    mangled name holds `kernel` (cuobjdump -sass, beside nvcc): its
    instructions, and the span of every backward branch (from its target
    to the branch: a loop's body, or blocks the compiler laid out between,
    so spans may overlap) with its instructions and, among them, the loads
    (LDG), shuffles (SHFL), special-function ops (MUFU), votes, popcounts
    and barriers, and whether it holds no other span ("inner"). A static
    count: each path through a span's branches counts once."""
    from umhs_torch.ops import _native

    tool = Path(_native._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    found = [f for f in re.split(r"\n\s*Function : ", text)[1:] if kernel in f.split()[0]]
    if len(found) != 1:
        return {"error": f"{len(found)} functions named like {kernel} in {library.name}"}
    insts, labels = [], {}
    for line in found[0].splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            labels[label.group(1)] = len(insts)
            continue
        m = SASS_INSTRUCTION.search(line)
        if m:
            insts.append((int(m.group(1), 16), m.group(2), m.group(3)))
    at = {addr: i for i, (addr, _, _) in enumerate(insts)}
    loops = []
    for i, (addr, op, rest) in enumerate(insts):
        if op.split(".")[0] != "BRA":
            continue
        target = re.search(r"0x([0-9a-f]+)\s*$", rest.strip())
        label = re.search(r"\((\.L_x_\d+)\)", rest)
        first = (at.get(int(target.group(1), 16)) if target
                 else labels.get(label.group(1)) if label else None)
        if first is None or first >= i:  # forward, or the branch to itself after EXIT
            continue
        ops = [o.split(".")[0] for _, o, _ in insts[first:i + 1]]
        loops.append({"first": hex(insts[first][0]), "last": hex(addr),
                      "instructions": i + 1 - first,
                      **{k.lower(): ops.count(k) for k in SASS_COUNTED}})
    span = [(int(lp["first"], 16), int(lp["last"], 16)) for lp in loops]
    for lp, (a, b) in zip(loops, span):  # innermost: holds no other span
        lp["inner"] = not any(a <= c and d <= b and (c, d) != (a, b) for c, d in span)
    return {"function": found[0].split()[0], "instructions": len(insts),
            "loops": sorted(loops, key=lambda lp: int(lp["first"], 16))}


def ptxas_usage(log: str) -> dict:
    """{kernel<template args>: registers and spill bytes} from nvcc -Xptxas=-v."""
    usage, kernel = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\S*?([a-z_]+_kernel)(\S*)'", line)
        if entry:  # template arguments: the literals (Li8E, Lb1E) after the name
            args = re.findall(r"L[a-z](\d+)E", entry.group(2))
            if not args:  # or a value type: float (IfE) or bf16 (I13__nv_bfloat16E)
                args = {"IfE": ["float"], "I13__nv_bfloat16E": ["bf16"]}.get(
                    re.match(r"(I(?:f|13__nv_bfloat16)E)?", entry.group(2)).group(1), [])
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
    ap.add_argument("--baseline", type=Path, metavar="TREE", default=None,
                    help="also time every kernel against another checkout's tree (each through "
                         "its own wrappers, a process each, in turns), hold their bits to it, "
                         "and run phase 7's schedule from it, bit for bit")
    ap.add_argument("--seed-variance", action="store_true",
                    help="only the seed-variance twin: 3 seeds, 2,000 steps, 256^2")
    ap.add_argument("--mesh-cards", action="store_true",
                    help="only phase 9's cli.train over every visible card (NCCL) and on one")
    ap.add_argument("--quality", choices=["tetrahedral", "all"], default="tetrahedral",
                    help="phase 8's quality runs: the tetrahedral one, or also the trilinear "
                         "and the 141-band bf16 ones")
    args = ap.parse_args()
    if args.repeat_schedule:  # cuBLAS reads this at its first call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    from umhs_torch import native
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
    spills, ptxas = [], {}
    for src, log in reports.items():
        for kernel, usage in ptxas_usage(log).items():
            print(f"  ptxas {src} {kernel}: " + json.dumps(usage))
            ptxas[kernel] = usage
            if usage["spill_stores"] or usage["spill_loads"]:
                spills.append(kernel)
    check(not spills, f"ptxas spilled registers in {spills}")
    t0 = time.perf_counter()
    built = native.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for the native cube loader "
          f"({'g++' if built else 'cached'}, {native.library_path().name})")

    only = (args.repeat_schedule or args.sweep_vs_plain is not None or args.seed_variance
            or args.mesh_cards)
    if args.repeat_schedule:
        repeat_schedule(dev)
    elif args.seed_variance:
        seed_variance(smi)
    elif args.mesh_cards:
        mesh_cards(smi)
    elif args.sweep_vs_plain is not None:
        sweep_vs_plain(dev, args.sweep_vs_plain)
    else:
        k1 = phase_k1(dev, ptxas)
        k3 = phase_k3(dev)
        k2 = phase_k2(dev, ptxas)
        k4 = phase_k4(dev)
        p1 = phase_p1(dev)
        k6 = phase_k6(dev, ptxas)
        if args.baseline:
            against = baseline_against_tree(args.baseline)
            for entry, prefix in ((k1, "K1 "), (k2, "K2 "), (k3, "K3 "), (k4, "K4 "), (p1, "P1 ")):
                entry["against_tree"] = {k: v for k, v in against.items() if k.startswith(prefix)}
            for entry in k6:  # render_weights_bwd: the tree's forward and backward too
                kernel = entry["name"]
                stem = kernel.replace("_bwd", "_fwd_bwd")
                entry["against_tree"] = {k: v for k, v in against.items()
                                         if k in (f"K6 {stem}", f"K6 {kernel}")
                                         or k.startswith(f"K6 {kernel} ")}
        dm, endmembers, cam = bench_scene_in_memory(dev)
        k5k7 = phase_k5k7(dev, ptxas, dm)
        if args.baseline:
            for entry in k5k7:
                prefix = "K5" if entry["name"].startswith("march") else "K7 "
                entry["against_tree"] = {k: v for k, v in against.items() if k.startswith(prefix)}
        trainer, render_launches = phase_render(dev, dm, endmembers, cam)
        phase_kernels_vs_plain(trainer, cam, dev)
        del trainer
        trainer, train_launches, train_summary, state48 = phase_train(dev, dm, endmembers)
        phase_train_vs_plain(trainer, dev, f"after train({TRAIN_STEPS})")
        phase_train_vs_plain(trainer, dev, f"after train({TRAIN_STEPS})", "bfloat16")
        del trainer
        (bench_launches, bench_losses, bench_adapts, bench_configs,
         bench_eval_all) = phase_bench_schedule(dev)
        if args.baseline:
            schedule_against_tree(args.baseline, bench_losses, bench_adapts, bench_eval_all)
        quality_runs = list(QUALITY_RUNS) if args.quality == "all" else ["tetrahedral"]
        quality_launches = phase_quality(dev, quality_runs, smi)
        entry_points = phase_entry_points(dev, bench_losses, bench_adapts, bench_configs)
        slice_kernels, nerfacto, dino = phase_10(dev, ptxas)
        mesh1, mesh2 = phase_11(dev, dm, endmembers, train_summary["loss_per_step"], state48)
        del dm, state48
        scripts = phase_scripts(dev, smi)

        for entry in (k1, k2, k3, k4, *k6, *k5k7):
            sym = "umhs_" + entry["name"]
            entry["launches_nerfacto_train"] = nerfacto["launches_train"][sym]
            entry["launches_nerfacto_render"] = nerfacto["launches_render"][sym]
            entry["launches_dino_train"] = dino["launches_train"][sym]
            if entry["name"] in slice_kernels:
                entry["at_phase10_shapes"] = slice_kernels[entry["name"]]
            entry["launches"] = bench_launches[sym]  # the bench schedule's run
            entry["launches_train"] = train_launches[sym]
            entry["launches_render"] = render_launches[sym]
            entry["launches_quality"] = quality_launches["tetrahedral"][sym]
            for path in ("train", "render", "viewer"):  # phase 9's entry points
                entry[f"launches_cli_{path}"] = entry_points[f"launches_{path}"][sym]
            entry["launches_mesh_1_rank"] = mesh1[sym]  # phase 11a's train(48)
            entry["launches_mesh_2_ranks"] = mesh2[sym]  # phase 11b's train(32), per rank
            entry["launches_scripts"] = scripts["launches"].get(sym, 0)  # phase 12's twins
        p1["launches_quality"] = quality_launches["tetrahedral"].get("umhs_row_gather", 0)
        p1["launches_mesh_1_rank"] = mesh1["umhs_row_gather"]
        p1["launches_mesh_2_ranks"] = mesh2["umhs_row_gather"]
    print(smi)
    if not only:
        print(json.dumps({"kernels": [k1, k2, k3, k4, p1, *k6, *k5k7]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
