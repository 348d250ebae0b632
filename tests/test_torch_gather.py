"""P1, the row gather of umhs_torch, against scripts/probe_pallas_gather.py's
Pallas kernel (interpret mode on the CPU) and numpy, and the probe twin's
CPU check. The kernel itself runs on the card (tests/test_torch_cuda.py)."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umhs_torch.ops.row_gather import ROW_GATHER, row_gather, row_gather_plain
from umhs_torch.probes import gather as probe

ROOT = Path(__file__).resolve().parent.parent


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


def test_plain_row_gather_is_table_indexing():
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    idx = torch.tensor([5, 0, 3, 3], dtype=torch.int32)
    assert torch.equal(row_gather_plain(table, idx), table[[5, 0, 3, 3]])


def test_probe_check_runs_on_the_cpu(capsys):
    assert probe.main(["--check"]) == []
    out = capsys.readouterr().out
    assert out.count("bit for bit") == 3 and "plain/numpy" in out


def test_probe_refuses_to_measure_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe.main([])


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
