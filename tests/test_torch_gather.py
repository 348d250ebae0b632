"""P1, the row gather of umhs_torch, against scripts/probe_pallas_gather.py's
Pallas kernel (interpret mode on the CPU) and numpy, and the probe twin's
CPU check. The kernel itself runs on the card (tests/test_torch_cuda.py)."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umhs_torch.ops.row_gather import (
    ROW_GATHER, ROWS, SLICE_BYTES, THREADS, WAVE, row_gather, row_gather_grid, row_gather_plain,
    row_gather_slices)
from umhs_torch.probes import gather as probe

ROOT = Path(__file__).resolve().parent.parent
BLOCKS_PER_SM = 10  # umhs_row_gather_blocks_per_sm on an H100 (PERF.md, P1)


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "probe_pallas_gather", ROOT / "scripts" / "probe_pallas_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plain_row_gather_matches_the_pallas_kernel_bit_for_bit():
    """4096 x 2 table, 2 x 2048 rows, with rows 0 and T - 1 among them."""
    jp = _jax_probe()
    table = np.random.default_rng(0).normal(size=(4096, 2)).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, 4096, size=2 * jp.BLOCK).astype(np.int32)
    idx[:2] = [0, 4095]
    want = np.asarray(jp._pallas_gather(jnp.asarray(table), jnp.asarray(idx), interpret=True))
    got = row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (2 * jp.BLOCK, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 2049])
def test_row_gather_takes_any_n(n):
    """N need not be a multiple of the Pallas kernel's 2048-row block."""
    rng = np.random.default_rng(n)
    table = rng.normal(size=(300, 2)).astype(np.float32)
    idx = rng.integers(0, 300, size=n).astype(np.int32)
    before = ROW_GATHER.launches
    for impl in ("auto", "plain"):
        got = row_gather(torch.from_numpy(table), torch.from_numpy(idx), impl=impl)
        assert got.shape == (n, 2)
        np.testing.assert_array_equal(got.numpy(), np.take(table, idx, axis=0))
    assert ROW_GATHER.launches == before  # CPU tensors never reach the kernel
    with pytest.raises(ValueError):
        row_gather(torch.from_numpy(table), torch.from_numpy(idx), impl="fast")


# N: empty, under a warp, the JAX kernel's block edges, 8k +- 1, a wave's
# edges, and enough waves that blocks stride over several
PARTITION_N = [0, 1, 3, 4, 5, 2047, 2049, 8 * 127 - 1, 8 * 127 + 1, WAVE - 1, WAVE, WAVE + 1,
               8 * WAVE - 1, 8 * WAVE + 1, 37 * WAVE + 5]


def _kernel_partition(table, idx, sms):
    """csrc/row_gather.cu's loops over blocks, waves, slices and rows, run
    with the plain gather: each thread t of a block owns rows w0 + k *
    THREADS + t of each wave w0 it strides to, reads their indices (-1 past
    N), and gathers in each slice, in alternate directions on alternate
    waves, the rows whose index lies in [lo, lo + slice_rows) by the
    kernel's unsigned compare. Returns the output and how often each row
    was written."""
    n, t = idx.shape[0], table.shape[0]
    slices = row_gather_slices(t)
    slice_rows = -(-t // slices)
    blocks = row_gather_grid(n, sms, BLOCKS_PER_SM) if n else 0
    out = torch.full((n, 2), float("nan"))
    writes = np.zeros(n, np.int64)
    lanes = np.arange(ROWS)[:, None] * THREADS + np.arange(THREADS)[None]  # (ROWS, THREADS)
    for b in range(blocks):
        for wave, w0 in enumerate(range(b * WAVE, n, blocks * WAVE)):
            rows = w0 + lanes
            live = rows < n
            r = np.where(live, idx.numpy()[np.minimum(rows, n - 1)], -1).astype(np.int64)
            staged = torch.zeros(rows.shape + (2,))
            order = range(slices) if wave % 2 == 0 else reversed(range(slices))
            for s in order:
                take = (r - s * slice_rows) % 2**32 < slice_rows
                staged[torch.from_numpy(take)] = row_gather_plain(
                    table, torch.from_numpy(r[take].astype(np.int32)))
            out[torch.from_numpy(rows[live])] = staged[torch.from_numpy(live)]
            np.add.at(writes, rows[live], 1)
    return out, writes


@pytest.mark.parametrize("n", PARTITION_N)
def test_row_gather_partition_covers_every_row_once(n):
    """The kernel's partition of the rows, on its plain version: every row
    written once, with table[idx] bit for bit, on a one-slice table and on
    one of four slices, with rows 0 and T - 1 among the indices, on a card
    of one SM (so that blocks stride over waves) and of 132, with 10 blocks
    resident on each (the kernel's occupancy on an H100, PERF.md)."""
    rng = np.random.default_rng(n)
    for t in (300, 3 * SLICE_BYTES // 8 + 5):
        table = torch.from_numpy(rng.normal(size=(t, 2)).astype(np.float32))
        idx = torch.from_numpy(rng.integers(0, t, size=n).astype(np.int32))
        if n:
            idx[0], idx[-1] = t - 1, 0
        assert row_gather_slices(t) == (1 if t == 300 else 4)
        for sms in (1, 132):
            out, writes = _kernel_partition(table, idx, sms)
            assert (writes == 1).all()
            assert torch.equal(out, row_gather_plain(table, idx))


def test_row_gather_slices_and_grid():
    assert row_gather_slices(1) == 1 and row_gather_slices(SLICE_BYTES // 8) == 1
    assert row_gather_slices(SLICE_BYTES // 8 + 1) == 2
    assert row_gather_slices(probe.FLAGSHIP_TABLE_ROWS) == 6  # 48.8 MB
    assert row_gather_slices(probe.PROBE_TABLE_ROWS) == 6  # 96 MB
    assert row_gather_slices(2**31 - 1) == 6
    assert row_gather_grid(1, 132, BLOCKS_PER_SM) == 1
    assert row_gather_grid(WAVE + 1, 132, BLOCKS_PER_SM) == 2
    assert row_gather_grid(probe.PROBE_ROWS, 132, BLOCKS_PER_SM) == 132 * BLOCKS_PER_SM


def test_plain_row_gather_is_table_indexing():
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    idx = torch.tensor([5, 0, 3, 3], dtype=torch.int32)
    assert torch.equal(row_gather_plain(table, idx), table[[5, 0, 3, 3]])


def test_probe_check_runs_on_the_cpu(capsys):
    assert probe.main(["--check", "--device", "cpu"]) == []
    out = capsys.readouterr().out
    assert out.count("bit for bit") == 3 and "plain/numpy" in out


def test_probe_refuses_to_measure_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe.main([])


def test_probe_check_needs_the_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    """--check runs where --device says (cuda by default): without a card it
    raises instead of falling back to the CPU; measuring refuses the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe.main(["--check"])
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit, match="needs the card"):
        probe.main(["--device", "cpu"])
    assert probe.main(["--check", "--device", "cpu"]) == []


def test_probe_shapes_and_bounds():
    assert probe.PROBE_ROWS == 16_318_464 and probe.PROBE_ROWS % 2048 == 0
    assert probe.PROBE_TABLE_ROWS * 2 * 4 == 96_000_000  # 96 MB of f32 rows
    idx = torch.tensor([0, 1, 4, 4, 8], dtype=torch.int32)  # rows 0-3 share a 32-B sector
    b = probe.bounds_ms(idx)
    assert b["unique_sectors"] == 3
    assert b["bound_ms"] == pytest.approx((5 * 12 + 3 * 32) / 3.35e12 * 1e3)
    assert b["sector_bound_ms"] == pytest.approx(5 * 44 / 3.35e12 * 1e3)
    full = probe.PROBE_ROWS * 44 / 3.35e12 * 1e3
    assert full == pytest.approx(0.2143, abs=1e-4)
