"""Grouped GEMM: one matrix product per group of consecutive rows, every
group in one launch.

``grouped_mm(x, w, offs)`` multiplies the rows ``offs[g-1]:offs[g]`` of
``x`` (N, K) by ``w[g]`` (K, M), for every group g (``offs`` (G,) int32
end offsets on x's device, ``offs[-1] == N``; a group may be empty). It is
the mixture-of-experts layer's expert product
(:mod:`motion324_tpu_torch.hy3dgen.moe`): the rows are the tokens sorted by
expert, and the offsets stay on the device, so a step never waits for the
host.

On a CUDA tensor in bf16 it is one launch of PyTorch's grouped GEMM
(``torch._grouped_mm``: CUTLASS's grouped kernel, the problem sizes read
from ``offs`` on the device), counted in ``grouped_mm.launches``. ``w`` is
read through its strides: the expert banks pass (G, M, K) weights
transposed, as the kernel takes them without a copy. A CUDA tensor in
another dtype is refused (TypeError): the plain version reads the group
ends on the host, which a DiT step must not wait for. On a CPU tensor it
computes the plain version, one product per group.
"""

from __future__ import annotations

import torch

__all__ = ["grouped_mm", "grouped_mm_reference"]


def grouped_mm_reference(x: torch.Tensor, w: torch.Tensor,
                         offs: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`grouped_mm`: a product per group, in
    x's dtype."""
    out = x.new_zeros(x.shape[0], w.shape[-1])
    start = 0
    for g, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[g].to(x.dtype)
        start = end
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """``(N, M)``: row group g of ``x`` (N, K) times ``w[g]`` (K, M)."""
    if x.is_cuda:
        if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
            raise TypeError(f"the grouped GEMM takes bfloat16 x and w on "
                            f"CUDA, got {x.dtype}, {w.dtype}")
        out = torch._grouped_mm(x, w, offs=offs)
        grouped_mm.launches += 1
        return out
    return grouped_mm_reference(x, w, offs)


grouped_mm.launches = 0
