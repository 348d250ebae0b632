"""umhs_torch: the PyTorch/CUDA port of umhs_tpu for one NVIDIA H100.

The package mirrors umhs_tpu's layout (ops/, models/, data/, engine/,
utils/) and adds csrc/ for the hand-written Hopper kernels. It imports torch
and numpy only. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; on a CUDA tensor the hand-written kernels are
the only path, and on a CPU tensor their plain PyTorch versions run.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for `device`; raises when CUDA is asked for and absent
    (entry points never carry on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
