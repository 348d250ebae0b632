"""State conversion between umhs_tpu (as numpy arrays) and umhs_torch.

Parameters keep the JAX package's tree and layouts: the flat hash table
(T * F,), every MLP as {"layers": [{"w": (in, out), "b": (out,)}]} (no
transpose), "endmembers" (K, B) and the optional "appearance_embedding";
with the proposal sampler "proposal_0" and "proposal_1" ({"hash_table",
"mlp"} each), with pred_dino "dino_mlp" and "dino_clusters" (K, 128). The
conversions map over the whole tree, so these travel as the others do.

The occupancy state keeps "occs", "occs_low", "binaries" and
"binaries_pooled" as they are. The uint32 "packed_words" travel as int64
holding the same values. The TPU's row tables "occ_rows" and "pooled_rows"
are left out on the way in (the port queries the bitfields) and rebuilt
from the bitfields on the way out, so a round trip is bitwise.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_ROW_TABLES = ("occ_rows", "pooled_rows")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_to_torch(params, device="cpu") -> Dict[str, Any]:
    """JAX parameter tree (arrays convertible by np.asarray) -> tensors."""
    return _map(params, lambda a: torch.as_tensor(np.array(a), device=device))


def params_to_numpy(params) -> Dict[str, Any]:
    """The port's parameter tree -> numpy arrays."""
    return _map(params, lambda t: t.detach().cpu().numpy())


def occ_state_to_torch(occ, device="cpu") -> Dict[str, torch.Tensor]:
    """JAX occupancy state -> the port's (see the module docstring)."""
    out = {}
    for k, v in occ.items():
        if k in _ROW_TABLES:
            continue
        a = np.array(v)
        if k == "packed_words":
            a = a.astype(np.int64)
        out[k] = torch.as_tensor(a, device=device)
    return out


def occ_state_to_numpy(occ) -> Dict[str, np.ndarray]:
    """The port's occupancy state -> the JAX layout, row tables rebuilt."""
    out = {k: v.detach().cpu().numpy() for k, v in occ.items()}
    if "packed_words" in out:
        out["packed_words"] = out["packed_words"].astype(np.uint32)
    out["occ_rows"] = np.stack(
        [out["binaries"].astype(np.float32), out["occs_low"]], axis=-1).reshape(-1)
    if "binaries_pooled" in out:
        pf = out["binaries_pooled"].astype(np.float32)
        out["pooled_rows"] = np.stack([pf, pf], axis=-1).reshape(-1)
    return out
