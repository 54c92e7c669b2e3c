"""PyTorch/CUDA port of motion324: mesh + video -> per-vertex trajectories.

The port runs on an NVIDIA H100. Attention on the hot path goes through two
CUDA kernels written for ``sm_90a`` (``csrc/flash_fwd.cu``,
``csrc/folded_fwd.cu``); everything else is plain PyTorch. Entry points run on
the card unless the caller passes ``device="cpu"``, where every kernel wrapper
uses its plain PyTorch version.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises.

    There is no silent fallback to the CPU: a caller that wants the CPU asks
    for it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "motion324_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    return dev
