"""umhs_torch and chip_smoke.py stand alone: they import neither JAX nor
umhs_tpu, and their entry points refuse CUDA when there is none."""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import umhs_torch
from umhs_torch.data.datamanager import DataManagerConfig, InMemoryDataManager
from umhs_torch.engine.trainer import Trainer, TrainerConfig
from umhs_torch.models.model import ModelConfig, UMHSModel

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "umhs_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "umhs_tpu")
IMPORT_TEXT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|umhs_tpu)\b")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_umhs_tpu_imports(path):
    text = path.read_text()
    banned = [m for m in _imported_roots(ast.parse(text)) if m in BANNED]
    assert not banned, f"{path.name} imports {banned}"
    lines = [ln for ln in text.splitlines() if IMPORT_TEXT.match(ln)]
    assert not lines, f"{path.name}: {lines}"


def test_the_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"umhs_torch/ops/mlp_fused.py", "umhs_torch/ops/encodings.py",
            "umhs_torch/ops/activations.py", "umhs_torch/ops/occupancy.py",
            "umhs_torch/data/datamanager.py", "umhs_torch/models/model.py",
            "umhs_torch/engine/trainer.py", "chip_smoke.py"} <= names


def test_cuda_is_refused_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        umhs_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Trainer(TrainerConfig(), ModelConfig(), DataManagerConfig(), num_classes=3)
    with pytest.raises(RuntimeError):  # the model's own default is the card too
        UMHSModel(ModelConfig(), [], num_classes=3, num_images=1)
    with pytest.raises(RuntimeError):
        InMemoryDataManager(np.zeros((1, 2, 2, 3), np.float32), None)
    assert umhs_torch.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("probe", ["f32_products", "k4_any_parts"])
def test_card_probes_refuse_without_a_card(monkeypatch, probe):
    """The probes that time kernel variants on the card raise before building
    anything when there is no card."""
    import importlib

    module = importlib.import_module(f"umhs_torch.probes.{probe}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs the card"):
        module.main()


def test_kernel_sources_are_in_the_package():
    from umhs_torch.ops import _native
    from umhs_torch.ops.compact import COMPACT_GATHER, COMPACT_STAGE
    from umhs_torch.ops.compositing import (
        RENDER_WEIGHTS_BWD, RENDER_WEIGHTS_FWD, SEGMENT_ACCUMULATE_BWD, SEGMENT_ACCUMULATE_FWD)
    from umhs_torch.ops.encodings import HASH_ENCODE_BWD, HASH_ENCODE_FWD
    from umhs_torch.ops.mlp_fused import MLP_FUSED_BWD, MLP_FUSED_FWD
    from umhs_torch.ops.occupancy import OCC_PACK, OCC_UPDATE
    from umhs_torch.ops.ray_marching import MARCH_COUNT, MARCH_EMIT
    from umhs_torch.ops.row_gather import ROW_GATHER

    kernels = (MLP_FUSED_FWD, MLP_FUSED_BWD, HASH_ENCODE_FWD, HASH_ENCODE_BWD, ROW_GATHER,
               COMPACT_STAGE, COMPACT_GATHER, RENDER_WEIGHTS_FWD, RENDER_WEIGHTS_BWD,
               SEGMENT_ACCUMULATE_FWD, SEGMENT_ACCUMULATE_BWD, MARCH_COUNT, MARCH_EMIT,
               OCC_UPDATE, OCC_PACK)
    assert sorted(_native.KERNELS) == sorted(k.symbol for k in kernels)
    for k in kernels:
        assert (_native.CSRC_DIR / k.source).is_file()
        assert _native.KERNELS[k.symbol] is k
        text = (_native.CSRC_DIR / k.source).read_text()
        assert f'extern "C" int {k.symbol}(' in text
        assert "torch/extension.h" not in text
    # the build key changes with the source
    assert _native.library_path("mlp_fused_fwd.cu") != _native.library_path("hash_encode_fwd.cu")
    assert _native.library_path("mlp_fused_fwd.cu").parent == _native.BUILD_DIR
