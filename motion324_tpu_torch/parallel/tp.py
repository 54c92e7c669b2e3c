"""Tensor-parallel sharding of the transformer weights over ``mp``
(counterpart of ``motion324_tpu/parallel/tp.py``), Megatron style:

- column-parallel (output rows split): fused ``to_qkv`` and DINOv2's
  ``qkv``, ``to_q`` / ``to_k`` / ``to_v``, the motion blocks' first MLP
  layer; their biases split with them;
- row-parallel (input columns split): the attention output ``fc`` and
  DINOv2's ``proj``, the motion blocks' second MLP layer; their biases stay
  whole and are added once, after the reduce;
- everything else (norms, embeddings, tokens, heads, DINOv2's MLP and patch
  embedding) replicated.

The rule goes by the name of the layer that holds the weight, with the JAX
rule's ``_COL`` / ``_ROW`` sets applied to the flax module's name:
``_ALIASES`` maps the port's module paths whose names differ (the motion
blocks' ``mlp.mlp.0`` is flax's ``fc1``; DINOv2's ``mlp.fc1`` is flax's
``mlp_fc1``, which no set holds).
A fused QKV weight is split by head inside each of q, k and v: rank ``r``
holds heads ``[r H / mp, (r + 1) H / mp)`` of each, so its slice is a
self-contained attention over its heads (a contiguous slice of the fused
``3 dim`` rows would hand a rank the q of some heads and the k of others).

Checkpoints hold the whole state: :func:`shard_state_dict` cuts a rank's
shard out of it and :func:`gather_state_dict` puts the shards back
together.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["tp_rule", "shard_state_dict", "gather_state_dict",
           "shard_tensor", "gather_tensor", "gather_over"]

_COL = {"to_qkv", "to_q", "to_k", "to_v", "fc1", "c_qkv", "c_q", "c_kv",
        "c_fc", "qkv", "linear1", "mlp_w12"}
_ROW = {"fc", "fc2", "c_proj", "c_proj_mlp", "proj", "linear2", "mlp_w3"}
_FUSED_QKV = {"to_qkv", "qkv", "c_qkv"}
# port module path (suffix) -> the flax module's name
_ALIASES = {"mlp.mlp.0": "fc1", "mlp.mlp.2": "fc2", "mlp.fc1": "mlp_fc1",
            "mlp.fc2": "mlp_fc2", "patch_embed.proj": "patch_embed"}


def tp_rule(key: str) -> str | None:
    """How state-dict entry ``key`` is split: ``"qkv"`` (fused QKV, by head
    inside q, k and v), ``"col"`` (dim 0), ``"row"`` (dim 1 of a weight) or
    None (replicated; a row-parallel layer's bias too)."""
    module, _, leaf = key.rpartition(".")
    if leaf not in ("weight", "bias"):
        return None
    name = module.rpartition(".")[2]
    for path, alias in _ALIASES.items():
        if module == path or module.endswith("." + path):
            name = alias
    if name in _FUSED_QKV:
        return "qkv"
    if name in _COL:
        return "col"
    if name in _ROW and leaf == "weight":
        return "row"
    return None


def _split(dim_size: int, mp: int, key: str) -> int:
    if dim_size % mp:
        raise ValueError(f"{key}: dimension {dim_size} not divisible by "
                         f"mp={mp}")
    return dim_size // mp


def shard_tensor(x: torch.Tensor, rule: str | None, rank: int, mp: int,
                 key: str = "") -> torch.Tensor:
    """Rank ``rank``'s shard of the whole tensor ``x`` under ``rule``."""
    if rule is None or mp == 1:
        return x
    if rule == "qkv":
        n = _split(x.shape[0], 3 * mp, key)
        return x.reshape(3, mp, n, *x.shape[1:])[:, rank].reshape(
            3 * n, *x.shape[1:]).clone()
    dim = 0 if rule == "col" else 1
    n = _split(x.shape[dim], mp, key)
    return x.narrow(dim, rank * n, n).clone()


def gather_tensor(shards: list[torch.Tensor], rule: str | None) -> torch.Tensor:
    """The whole tensor from its shards in rank order."""
    if rule is None or len(shards) == 1:
        return shards[0]
    if rule == "qkv":
        parts = [s.reshape(3, -1, *s.shape[1:]) for s in shards]
        whole = torch.stack(parts, dim=1)             # (3, mp, n, ...)
        return whole.reshape(-1, *whole.shape[3:])
    return torch.cat(shards, dim=0 if rule == "col" else 1)


def shard_state_dict(sd: dict, rank: int, mp: int) -> dict:
    """Rank ``rank``'s shard (of ``mp``) of a whole state dict."""
    return {k: shard_tensor(v, tp_rule(k), rank, mp, k) for k, v in sd.items()}


def gather_state_dict(shards: list[dict]) -> dict:
    """The whole state dict from the ``mp`` ranks' shards, in rank order."""
    return {k: gather_tensor([s[k] for s in shards], tp_rule(k))
            for k in shards[0]}


def gather_over(sd: dict, group) -> dict:
    """The whole state dict from this rank's shard ``sd``: every sharded
    entry all-gathered over the tensor-parallel ``group`` (a collective:
    every rank of the group calls it)."""
    if group is None or group.group is None or group.size == 1:
        return dict(sd)
    out = {}
    for k, v in sd.items():
        rule = tp_rule(k)
        if rule is None:
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(group.size)]
        dist.all_gather(parts, v.contiguous(), group=group.group)
        out[k] = gather_tensor(parts, rule)
    return out
