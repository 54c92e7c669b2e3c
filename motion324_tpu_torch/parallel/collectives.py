"""The collectives the models and the train step call, aware of autograd.

Megatron's pair for tensor parallelism: :func:`copy_to_tp` (*f*) before a
column-parallel layer, identity forward and all-reduce of the gradient;
:func:`reduce_from_tp` (*g*) after a row-parallel layer, all-reduce of the
partial sums and identity backward. :func:`all_gather_seq` gathers the
sequence shards of K/V in rank order, as ``all_gather(..., tiled=True)``
does in the JAX package's sequence-parallel attention. :func:`mean_over`
averages the data-parallel gradients in one flat buffer, as ``lax.pmean``,
and :func:`sum_over` sums the pipeline stages' gradients, as ``lax.psum``.
:func:`broadcast_first` hands the ranks of a group the tensors of its
first rank (the batch of a tensor-parallel replica).

Each takes a :class:`~motion324_tpu_torch.parallel.mesh.Group`; with
``group=None`` (one process, no process group) each is the identity. The
tensors stay on their device: gloo reduces CUDA tensors itself.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from motion324_tpu_torch.parallel.mesh import Group

__all__ = ["copy_to_tp", "reduce_from_tp", "all_gather_seq", "mean_over",
           "sum_over", "all_reduce_sum", "broadcast_first"]


def _active(group: Group | None) -> bool:
    return group is not None and group.group is not None


def all_reduce_sum(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    """A new tensor: the sum of ``x`` over ``group`` (``x`` without one)."""
    if not _active(group):
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group.group)
    return out


def broadcast_first(tensors: list[torch.Tensor],
                    group: Group | None) -> list[torch.Tensor]:
    """Overwrite ``tensors`` (contiguous, the same shapes on every rank) in
    place with those of ``group``'s rank 0; returns them."""
    if _active(group):
        for t in tensors:
            dist.broadcast(t, group=group.group, group_src=0)
    return tensors


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(group.size)]
        dist.all_gather(parts, x, group=group.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g, ctx.group)
        return g.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n), None, None


def copy_to_tp(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    """*f*: ``x`` forward; the gradient summed over ``group`` backward."""
    return _CopyToTP.apply(x, group) if _active(group) else x


def reduce_from_tp(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    """*g*: the sum of the partial results ``x`` over ``group``; the
    gradient passes unchanged."""
    return _ReduceFromTP.apply(x, group) if _active(group) else x


def all_gather_seq(x: torch.Tensor, dim: int,
                   group: Group | None) -> torch.Tensor:
    """The shards of ``x`` along ``dim``, concatenated in rank order; the
    gradient of this rank's shard backward."""
    return _AllGatherSeq.apply(x, dim, group) if _active(group) else x


def sum_over(group: Group | None,
             tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of each tensor over ``group`` through one all-reduce of a
    flat buffer, as ``lax.psum`` (the tensors themselves without one)."""
    if not tensors or not _active(group):
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group.group)
    return [part.view(t.shape) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def mean_over(group: Group | None, tensors: list[torch.Tensor],
              wire_dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    """The mean of each tensor over ``group``, through one all-reduce of a
    flat buffer in ``wire_dtype`` (default: the tensors' dtype). The sum
    and the division are taken in the wire dtype, as ``lax.pmean`` of
    tensors cast to it; each result comes back in its tensor's dtype.
    Without a group the tensors only make the round trip through the wire
    dtype."""
    if not tensors:
        return []
    wire = wire_dtype or tensors[0].dtype
    if not _active(group):
        return [t if t.dtype == wire else t.to(wire).to(t.dtype)
                for t in tensors]
    flat = torch.cat([t.reshape(-1).to(wire) for t in tensors])
    dist.all_reduce(flat, group=group.group)
    flat = flat.div_(group.size)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out
