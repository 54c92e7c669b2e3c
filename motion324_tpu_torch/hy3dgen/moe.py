"""The mixture-of-experts feed-forward of the Hunyuan3D-2.1 shape DiT: a
softmax router over ``num_experts`` expert MLPs, each token sent to its
top ``MoE.TOP_K`` (2, the release's router), plus one shared expert that
every token takes.

For tokens x (T, D):

- ``p = softmax(x W_g)`` in f32 (W_g (E, D), no bias);
- each token's ``TOP_K`` experts by p, ties to the lower index (an argmax
  per pick, the picked experts masked out), weighted by their p as they
  are (not renormalised);
- ``y = sum_i p_i FFN_i(x) + FFN_shared(x)``, every FFN
  ``fc2(GELU(fc1(x)))`` with exact GELU, D -> F -> D, with biases.

The experts' weights are banks, one tensor per projection for the E
routed experts and, last, the shared one (``experts.fc1.weight``
((E + 1) F, D), ``.bias`` ((E + 1) F), ``experts.fc2.weight``
((E + 1) D, F), ``.bias`` ((E + 1) D)): expert e's fc1 is rows
``e F:(e + 1) F``, the shared expert's e = E. Each token gives TOP_K + 1
(token, expert) rows, its picks and the shared expert; the rows are sorted
by expert (a stable sort, so rows of one expert keep token order),
gathered, and each projection of all E + 1 experts is one grouped GEMM over
them (:func:`~motion324_tpu_torch.ops.grouped_gemm.grouped_mm`) with the
group ends computed on the device (a search of the sorted expert ids). The
rows go back to token order by a scatter of unique indices, and each token
adds its routed rows weighted, in pick order, then its shared row, in f32,
with no atomics: the layer repeats bit for bit. On the CUDA path nothing
reads a tensor on the host (no ``.item()``, ``.cpu()`` or ``.tolist()``);
on a CPU tensor the grouped GEMM's plain version reads the group ends.

The layer opens the span ``shape.dit.moe`` and adds its rows per routed
expert to the device counter ``shape.dit.moe.rows``
(:mod:`motion324_tpu_torch.utils.profiling`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from motion324_tpu_torch.models.transformer import Linear
from motion324_tpu_torch.ops.grouped_gemm import grouped_mm
from motion324_tpu_torch.utils.profiling import count, span

__all__ = ["MLP", "MoE", "route"]


class MLP(nn.Module):
    """``fc2(GELU(fc1(x)))``, exact GELU, in x's dtype."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _Bank(nn.Module):
    """One projection of every expert: ``weight`` (E out, in), ``bias``
    (E out)."""

    def __init__(self, experts: int, dim_in: int, dim_out: int):
        super().__init__()
        self.experts, self.dim_in, self.dim_out = experts, dim_in, dim_out
        self.weight = nn.Parameter(torch.empty(experts * dim_out, dim_in))
        self.bias = nn.Parameter(torch.empty(experts * dim_out))

    def matrices(self, dtype) -> torch.Tensor:
        """(E, in, out): expert e's matrix, a transposed view of its rows."""
        w = self.weight.to(dtype).view(self.experts, self.dim_out, self.dim_in)
        return w.transpose(1, 2)

    def biases(self, dtype) -> torch.Tensor:
        return self.bias.to(dtype).view(self.experts, self.dim_out)


class _Experts(nn.Module):
    """The two projections of ``experts`` MLPs, D -> F -> D."""

    def __init__(self, experts: int, dim: int, hidden: int):
        super().__init__()
        self.fc1 = _Bank(experts, dim, hidden)
        self.fc2 = _Bank(experts, hidden, dim)


def route(logits: torch.Tensor, top_k: int):
    """``(experts (T, top_k) int64, weights (T, top_k) f32)`` of f32 router
    logits (T, E): the softmax's top_k in order, ties to the lower index
    (``argmax`` takes the first maximum), the weights the softmax's own."""
    p = torch.softmax(logits.float(), dim=-1)
    left, picks = p, []
    for _ in range(top_k):
        i = left.argmax(dim=-1)
        picks.append(i)
        left = left.scatter(-1, i[:, None], -1.0)
    experts = torch.stack(picks, dim=1)
    return experts, p.gather(-1, experts)


class MoE(nn.Module):
    """x (..., D) -> (..., D) in x's dtype (see the module docstring)."""

    TOP_K = 2

    def __init__(self, dim: int, hidden: int, num_experts: int = 8):
        super().__init__()
        self.num_experts = num_experts
        self.gate = Linear(dim, num_experts, bias=False)
        self.experts = _Experts(num_experts + 1, dim, hidden)   # shared last

    def forward(self, x):
        with span("shape.dit.moe"):
            shape = x.shape
            x = x.reshape(-1, shape[-1])
            t, k, e = x.shape[0], self.TOP_K, self.num_experts
            experts, weights = route(
                F.linear(x.float(), self.gate.weight.float()), k)
            shared = torch.full((t, 1), e, dtype=experts.dtype,
                                device=x.device)
            # row r is token r // (k + 1)
            flat = torch.cat([experts, shared], 1).reshape(-1)
            order = torch.argsort(flat, stable=True)
            ids = flat[order]
            ends = torch.searchsorted(ids, torch.arange(e + 1, device=x.device),
                                      right=True).to(torch.int32)
            count("shape.dit.moe.rows",
                  torch.diff(ends[:e], prepend=ends.new_zeros(1)))
            bank1, bank2 = self.experts.fc1, self.experts.fc2
            h = grouped_mm(x[order // (k + 1)], bank1.matrices(x.dtype), ends)
            h = F.gelu(h.add_(bank1.biases(x.dtype)[ids]))
            y = grouped_mm(h, bank2.matrices(x.dtype), ends)
            y.add_(bank2.biases(x.dtype)[ids])
            rows = torch.empty_like(y).index_copy_(0, order, y).view(
                t, k + 1, -1)
            out = weights[:, 0:1] * rows[:, 0].float()
            for i in range(1, k):
                out = out + weights[:, i:i + 1] * rows[:, i].float()
            out = out + rows[:, k].float()
            return out.to(x.dtype).reshape(shape)
