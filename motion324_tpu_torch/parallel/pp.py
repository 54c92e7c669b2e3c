"""Pipeline parallelism (GPipe) over the alternating stack's pairs
(counterpart of ``motion324_tpu/parallel/pp.py``).

The motion model's 8 (global, local) pairs split into ``pp`` contiguous
stages, one per rank of the pipeline group (the mesh's ``mp`` axis, as in
the JAX package). Stage ``d`` holds pairs ``[d k, (d + 1) k)``,
``k = n_pairs / pp``, under the whole model's state-dict names renumbered
from 0 (``global_transformer_blocks.{j}``, ``local_transformer_blocks.{j}``),
so that one whole state dict splits by key (:func:`split_state_dict`) and
gathers back (:func:`gather_stages`). Everything outside the stack (the
encoders, DINOv2, the decoder) is replicated compute on every stage.
For any model (a stage, a tensor-parallel shard or a whole one),
:func:`model_part`, :func:`model_whole` and :func:`splits_over_mp` say
which part of the whole it holds, how that part gathers back and which of
its entries differ across ``mp``.

Two autograd Functions carry the schedule:

- :func:`rotate` sends a stage's output to stage ``d + 1`` and returns what
  stage ``d - 1`` sent (zeros on stage 0); its backward sends the gradient
  of what was received back to ``d - 1`` and returns the gradient that
  ``d + 1`` sends, the transpose ``lax.ppermute`` gets from autodiff. Gloo
  cannot send a CUDA tensor (its TCP pair writes the device pointer as host
  memory: ``writev ... Bad address`` on an H100), so under gloo a CUDA
  tensor travels through the host inside the Function; NCCL sends it as it
  is.
- :func:`broadcast_last` hands every stage the last stage's output: the sum
  over the stages of that output and zeros elsewhere (JAX's ``psum``); its
  backward sums the gradients over the stages (``psum``'s transpose) and
  keeps them on the last stage.

The train step counts the loss on the last stage only, so each replicated
path's gradient appears on exactly one stage and one sum over the stages
recombines them; the stack's gradients stay on their stage.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist

from motion324_tpu_torch.parallel.mesh import Group
from motion324_tpu_torch.parallel.tp import (gather_over, shard_state_dict,
                                             tp_rule)

__all__ = ["STACK_SCOPE", "is_stack_path", "stage_pairs", "split_state_dict",
           "gather_stages", "whole_name", "whole_names", "model_part",
           "model_whole", "splits_over_mp", "rotate", "broadcast_last"]

# the state-dict prefixes of the pipelined stack inside MotionLatentModel
STACK_SCOPE = ("global_transformer_blocks", "local_transformer_blocks")
_STACK_KEY = re.compile(r"^(%s)\.(\d+)\.(.*)$" % "|".join(STACK_SCOPE))


def is_stack_path(key: str) -> bool:
    """True if state-dict (or parameter) name ``key`` addresses the stack."""
    return _STACK_KEY.match(key) is not None


def stage_pairs(n_pairs: int, pp_size: int) -> int:
    """Pairs per stage; raises when ``n_pairs`` does not divide."""
    if n_pairs % pp_size:
        raise ValueError(f"{n_pairs} alternating pairs not divisible "
                         f"by pp_size={pp_size}")
    return n_pairs // pp_size


def _renumber(key: str, offset: int) -> str:
    m = _STACK_KEY.match(key)
    return f"{m.group(1)}.{int(m.group(2)) + offset}.{m.group(3)}"


def split_state_dict(sd: dict, stage: int, pp_size: int, n_pairs: int) -> dict:
    """Stage ``stage``'s part (of ``pp_size``) of a whole state dict: every
    entry outside the stack, and its pairs renumbered from 0."""
    k = stage_pairs(n_pairs, pp_size)
    out = {}
    for key, v in sd.items():
        m = _STACK_KEY.match(key)
        if m is None:
            out[key] = v
        elif stage * k <= int(m.group(2)) < (stage + 1) * k:
            out[_renumber(key, -stage * k)] = v
    return out


def gather_stages(sd: dict, group: Group | None, local_pairs: int) -> dict:
    """The whole state dict from this stage's ``sd`` (a collective over the
    pipeline ``group``: every stage calls it with the same keys). Stack
    entries of stage ``r`` take their whole names back; the rest is this
    stage's, the same on every stage."""
    if group is None or group.group is None or group.size == 1:
        return dict(sd)
    out = {}
    for key, v in sd.items():
        if not is_stack_path(key):
            out[key] = v
            continue
        parts = [torch.empty_like(v) for _ in range(group.size)]
        dist.all_gather(parts, v.contiguous(), group=group.group)
        for r, part in enumerate(parts):
            out[whole_name(key, r, local_pairs)] = part
    return out


def whole_name(name: str, stage: int, local_pairs: int) -> str:
    """The whole model's name of stage ``stage``'s ``name``."""
    return _renumber(name, stage * local_pairs) if is_stack_path(name) else name


def whole_names(names: list[str], pp_size: int, local_pairs: int) -> list[str]:
    """The whole model's names, in order, for a stage's ``names`` (in its
    order): each run of one stack prefix is repeated once per stage,
    renumbered, as the whole model lists its pairs."""
    out, i = [], 0
    while i < len(names):
        m = _STACK_KEY.match(names[i])
        if m is None:
            out.append(names[i])
            i += 1
            continue
        j = i
        while j < len(names) and names[j].startswith(m.group(1) + "."):
            j += 1
        out += [whole_name(n, r, local_pairs) for r in range(pp_size)
                for n in names[i:j]]
        i = j
    return out


def model_part(model, whole: dict) -> dict:
    """The part of a whole state dict that ``model`` holds: its pipeline
    stage's pairs (``model.pp``), its tensor-parallel shard (``model.tp``)
    or all of it."""
    pp, tp = getattr(model, "pp", None), getattr(model, "tp", None)
    if pp is not None:
        return split_state_dict(whole, pp.rank, pp.size,
                                model.cfg.n_alternating_layers // 2)
    if tp is not None:
        return shard_state_dict(whole, tp.rank, tp.size)
    return whole


def model_whole(model, sd: dict) -> dict:
    """The whole state dict from ``sd``, the part of it that ``model``
    holds (the inverse of :func:`model_part`; a collective over the
    model's pipeline or tensor-parallel group)."""
    pp = getattr(model, "pp", None)
    if pp is not None:
        return gather_stages(sd, pp, len(model.global_transformer_blocks))
    return gather_over(sd, getattr(model, "tp", None))


def splits_over_mp(model, name: str) -> bool:
    """Whether ``model``'s state-dict entry (or parameter) ``name`` differs
    across its ``mp`` group: a pipeline stage's pair or a tensor-parallel
    shard."""
    if getattr(model, "pp", None) is not None:
        return is_stack_path(name)
    tp = getattr(model, "tp", None)
    return tp is not None and tp.size > 1 and tp_rule(name) is not None


def _through_host(t: torch.Tensor, group: Group) -> bool:
    return t.is_cuda and dist.get_backend(group.group) == "gloo"


def _exchange(send: torch.Tensor | None, dst: int | None, recv_like: torch.Tensor,
              src: int | None, group: Group) -> torch.Tensor:
    """Send ``send`` to group rank ``dst`` and receive a tensor shaped like
    ``recv_like`` from group rank ``src`` (either may be None); returns the
    received tensor on ``recv_like``'s device, zeros when nothing comes."""
    host = _through_host(recv_like, group)
    works, buf = [], None
    if send is not None:
        out = send.detach().contiguous()
        works.append(dist.isend(out.cpu() if host else out,
                                group=group.group, group_dst=dst))
    if src is not None:
        buf = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                          device="cpu" if host else recv_like.device)
        works.append(dist.irecv(buf, group=group.group, group_src=src))
    for work in works:
        work.wait()
    if buf is None:
        return torch.zeros_like(recv_like)
    return buf.to(recv_like.device) if host else buf


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, send, recv):
        d, p = group.rank, group.size
        ctx.group = group
        ctx.to_next = d + 1 if send and d + 1 < p else None
        ctx.from_prev = d - 1 if recv and d > 0 else None
        return _exchange(y if ctx.to_next is not None else None, ctx.to_next,
                         y, ctx.from_prev, group)

    @staticmethod
    def backward(ctx, g):
        # the transpose: the gradient of what came from d - 1 goes back to
        # it, and d + 1 returns the gradient of what went to it
        return (_exchange(g if ctx.from_prev is not None else None,
                          ctx.from_prev, g, ctx.to_next, ctx.group),
                None, None, None)


class _BroadcastLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        ctx.last = group.rank == group.size - 1
        out = (y if ctx.last else torch.zeros_like(y)).contiguous().clone()
        dist.all_reduce(out, group=group.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group.group)
        return (g if ctx.last else torch.zeros_like(g)), None


def rotate(y: torch.Tensor, group: Group, send: bool = True,
           recv: bool = True) -> torch.Tensor:
    """``lax.ppermute`` over pairs ``(d, d + 1)``: this stage's ``y`` goes
    to the next stage (when ``send``), and the previous stage's comes back
    (when ``recv``; zeros on stage 0 or without it). Both sides of one hand
    -off must agree on it; a stage without a partner skips it."""
    return _Rotate.apply(y, group, send, recv)


def broadcast_last(y: torch.Tensor, group: Group) -> torch.Tensor:
    """The last stage's ``y`` on every stage (``psum`` of ``y`` there and
    zeros elsewhere)."""
    return _BroadcastLast.apply(y, group)
