"""Weight conversion into the port's state-dict layout.

- :func:`params_from_jax`: the JAX package's flax param tree (as numpy
  arrays) -> the port's state dict. Dense ``kernel (in, out)`` becomes
  ``weight (out, in)``; Conv ``(kh, kw, in, out)`` becomes
  ``(out, in, kh, kw)``; the leading layer axis of a scanned block stack is
  split per layer; the alternating stack splits into global and local
  blocks; the point decoder head maps to ``shared_mlp_output.{0,1,3}``.
- :func:`load_reference_state_dict`: a reference ``.pt`` checkpoint (or its
  state dict) into a :class:`MotionLatentModel`, which keeps the reference
  names, after dropping the keys that the port computes or does not use.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "load_reference_state_dict"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _norm(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(p["scale"] if "scale" in p else p["weight"])
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _attn(out: dict, name: str, p: dict) -> None:
    for sub in ("to_qkv", "to_q", "to_k", "to_v", "fc"):
        if sub in p:
            _dense(out, f"{name}.{sub}", p[sub])
    for sub in ("q_norm", "k_norm"):
        if sub in p:
            _norm(out, f"{name}.{sub}", p[sub])


def _block(out: dict, name: str, p: dict) -> None:
    """Self- or cross-attention block (norm1/norm_q/norm_kv, attn, norm2, mlp)."""
    for sub in ("norm1", "norm_q", "norm_kv", "norm2"):
        if sub in p:
            _norm(out, f"{name}.{sub}", p[sub])
    _attn(out, f"{name}.attn", p["attn"])
    _dense(out, f"{name}.mlp.mlp.0", p["mlp"]["fc1"])
    _dense(out, f"{name}.mlp.mlp.2", p["mlp"]["fc2"])


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _layers(stacked: dict) -> list:
    tree = stacked["layers"]["block"]
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [_unstack(tree, i) for i in range(np.asarray(leaf).shape[0])]


def _dino(out: dict, prefix: str, p: dict) -> None:
    kern = np.asarray(p["patch_embed"]["kernel"])
    out[f"{prefix}.patch_embed.proj.weight"] = _t(kern.transpose(3, 2, 0, 1))
    out[f"{prefix}.patch_embed.proj.bias"] = _t(p["patch_embed"]["bias"])
    out[f"{prefix}.cls_token"] = _t(p["cls_token"])
    out[f"{prefix}.pos_embed"] = _t(p["pos_embed"])
    _norm(out, f"{prefix}.norm", p["norm"])
    for i, blk in enumerate(_layers(p["blocks"])):
        b = f"{prefix}.blocks.{i}"
        _norm(out, f"{b}.norm1", blk["norm1"])
        _dense(out, f"{b}.attn.qkv", blk["attn"]["qkv"])
        _dense(out, f"{b}.attn.proj", blk["attn"]["proj"])
        out[f"{b}.ls1.gamma"] = _t(blk["ls1_gamma"])
        _norm(out, f"{b}.norm2", blk["norm2"])
        _dense(out, f"{b}.mlp.fc1", blk["mlp_fc1"])
        _dense(out, f"{b}.mlp.fc2", blk["mlp_fc2"])
        out[f"{b}.ls2.gamma"] = _t(blk["ls2_gamma"])


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """JAX ``MotionLatentModel`` params (``{'params': ...}`` or the inner
    dict, leaves as numpy arrays) -> the port's state dict (float32)."""
    p = tree.get("params", tree)
    out: dict[str, torch.Tensor] = {}
    for name in ("learnable_tokens", "special_token_0", "special_token_rest"):
        out[name] = _t(p[name])
    _dense(out, "point_embed.mlp", p["point_embed_mlp"])
    _dense(out, "point_normal_rgb_proj", p["point_normal_rgb_proj"])
    _block(out, "encoder_cross_attn", p["encoder_cross_attn"])
    _norm(out, "transformer_input_layernorm", p["input_layernorm"])
    dec = p["point_decoder"]
    _block(out, "decoder_cross_attn", dec["cross"])
    _norm(out, "shared_mlp_output.0", dec["head_norm"])
    _dense(out, "shared_mlp_output.1", dec["head_fc1"])
    _dense(out, "shared_mlp_output.3", dec["head_fc2"])
    for i, blk in enumerate(_layers(p["pcd_blocks"])):
        _block(out, f"points_transformer_blocks.{i}", blk)
    for i, pair in enumerate(_layers(p["alternating_blocks"])):
        _block(out, f"global_transformer_blocks.{i}", pair["global"])
        _block(out, f"local_transformer_blocks.{i}", pair["local"])
    if "image_encoder" in p:
        _dino(out, "image_encoder.model", p["image_encoder"])
    return out


# keys of a reference checkpoint that the port does not hold: the video
# position table (computed here) and DINOv2's unused mask token
_DROPPED = ("pos_embed", "image_encoder.model.mask_token")


def load_reference_state_dict(model: torch.nn.Module, sd) -> None:
    """Load a reference checkpoint into ``model`` (strict).

    ``sd`` is a path to a ``.pt`` file, or a state dict of tensors or numpy
    arrays; a ``model`` entry and ``module.`` prefixes are unwrapped.
    """
    if isinstance(sd, str):
        obj = torch.load(sd, map_location="cpu", weights_only=False)
        sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    clean = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")
        if k in _DROPPED:
            continue
        clean[k] = v if isinstance(v, torch.Tensor) else _t(v)
    model.load_state_dict(clean)
