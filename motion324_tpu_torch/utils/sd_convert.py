"""diffusers-layout checkpoint -> the JAX package's flax-layout param trees.

The port's own copy of the UNet, VAE and ControlNet converters of
``motion324_tpu/utils/sd_convert.py`` (numpy only). The released
HunyuanPaint ``UNet2p5DConditionModel`` wraps a diffusers
``UNet2DConditionModel`` (keys with a ``unet.`` prefix and the extra
per-block ``attn_refview`` / ``attn_multiview`` attentions, reference
hunyuanpaint/unet/modules.py:404-599); its image VAE is a diffusers
``AutoencoderKL``. The converters are strict: they fail on any unconsumed
or missing key. Their output, flax names with ``kernel (in, out)`` Dense and
``(kh, kw, in, out)`` Conv weights, goes through
:func:`motion324_tpu_torch.utils.convert.flax_to_state_dict` into the port's
modules, whose names are the flax names.
"""

from __future__ import annotations

import numpy as np

__all__ = ["convert_sd_unet", "convert_sd_vae", "convert_controlnet"]


class _SD:
    """State-dict view that records consumed keys and strips a prefix."""

    def __init__(self, sd: dict, prefix: str = ""):
        self.sd = {k.removeprefix(prefix): np.asarray(v)
                   for k, v in sd.items()}
        self.used: set[str] = set()

    def __contains__(self, k):
        return k in self.sd

    def take(self, k):
        self.used.add(k)
        return self.sd[k]

    def assert_consumed(self):
        left = sorted(set(self.sd) - self.used)
        if left:
            raise KeyError(f"{len(left)} unconsumed checkpoint keys, e.g. "
                           f"{left[:8]}")


def _conv(sd: _SD, name):
    p = {"kernel": sd.take(f"{name}.weight").transpose(2, 3, 1, 0)
         .astype(np.float32)}
    if f"{name}.bias" in sd:
        p["bias"] = sd.take(f"{name}.bias").astype(np.float32)
    return p


def _dense(sd: _SD, name):
    w = sd.take(f"{name}.weight")
    if w.ndim == 4:  # 1x1 conv used as a linear projection (SD1.5 proj_in/out)
        w = w[:, :, 0, 0]
    p = {"kernel": w.T.astype(np.float32)}
    if f"{name}.bias" in sd:
        p["bias"] = sd.take(f"{name}.bias").astype(np.float32)
    return p


def _norm(sd: _SD, name):
    return {"scale": sd.take(f"{name}.weight").astype(np.float32),
            "bias": sd.take(f"{name}.bias").astype(np.float32)}


def _resnet(sd: _SD, name):
    p = {"norm1": _norm(sd, f"{name}.norm1"),
         "conv1": _conv(sd, f"{name}.conv1"),
         "time_emb_proj": _dense(sd, f"{name}.time_emb_proj"),
         "norm2": _norm(sd, f"{name}.norm2"),
         "conv2": _conv(sd, f"{name}.conv2")}
    if f"{name}.conv_shortcut.weight" in sd:
        p["shortcut"] = _conv(sd, f"{name}.conv_shortcut")
    return p


def _vae_resnet(sd: _SD, name):
    p = {"norm1": _norm(sd, f"{name}.norm1"),
         "conv1": _conv(sd, f"{name}.conv1"),
         "norm2": _norm(sd, f"{name}.norm2"),
         "conv2": _conv(sd, f"{name}.conv2")}
    if f"{name}.conv_shortcut.weight" in sd:
        p["shortcut"] = _conv(sd, f"{name}.conv_shortcut")
    return p


def _attn(sd: _SD, name):
    p = {"to_q": _dense(sd, f"{name}.to_q"),
         "to_k": _dense(sd, f"{name}.to_k"),
         "to_v": _dense(sd, f"{name}.to_v"),
         "to_out": _dense(sd, f"{name}.to_out.0")}
    # IP-Adapter's decoupled projections, where diffusers' IP-Adapter
    # processor holds them (a ModuleList of one per image prompt)
    for ip in ("to_k_ip", "to_v_ip"):
        if f"{name}.processor.{ip}.0.weight" in sd:
            p[ip] = _dense(sd, f"{name}.processor.{ip}.0")
    return p


def _tf_block(sd: _SD, name):
    """BasicTransformerBlock (+ optional 2.5D refview/multiview attention)."""
    p = {"norm1": _norm(sd, f"{name}.norm1"),
         "attn1": _attn(sd, f"{name}.attn1"),
         "norm2": _norm(sd, f"{name}.norm2"),
         "attn2": _attn(sd, f"{name}.attn2"),
         "norm3": _norm(sd, f"{name}.norm3"),
         "ff": {"proj_in": _dense(sd, f"{name}.ff.net.0.proj"),
                "proj_out": _dense(sd, f"{name}.ff.net.2")}}
    # HunyuanPaint 2.5D extensions (modules.py:46-299) live inside the block
    for extra in ("attn_refview", "attn_multiview"):
        if f"{name}.{extra}.to_q.weight" in sd:
            p[extra] = _attn(sd, f"{name}.{extra}")
    return p


def _transformer2d(sd: _SD, name, depth: int):
    p = {"norm": _norm(sd, f"{name}.norm"),
         "proj_in": _dense(sd, f"{name}.proj_in"),
         "proj_out": _dense(sd, f"{name}.proj_out")}
    for d in range(depth):
        p[f"block_{d}"] = _tf_block(sd, f"{name}.transformer_blocks.{d}")
    return p


def _probe(sd: _SD, fmt: str) -> int:
    """Count consecutive indices i for which fmt.format(i) names a key."""
    i = 0
    while fmt.format(i) in sd:
        i += 1
    return i


def _unet_structure(sd: _SD):
    """Infer (n_blocks, layers_per_block, tf_depth) from the key layout."""
    n_blocks = _probe(sd, "down_blocks.{}.resnets.0.norm1.weight")
    layers = _probe(sd, "down_blocks.0.resnets.{}.norm1.weight")
    tf_depth = max(1, _probe(
        sd, "mid_block.attentions.0.transformer_blocks.{}.norm1.weight"))
    return n_blocks, layers, tf_depth


def _unet_down_mid(sd: _SD, out: dict, n_blocks: int, layers_per_block: int,
                   tf_depth: int):
    """Shared down-path + mid mapping (UNet and ControlNet bodies match)."""
    out["conv_in"] = _conv(sd, "conv_in")
    out["time_fc1"] = _dense(sd, "time_embedding.linear_1")
    out["time_fc2"] = _dense(sd, "time_embedding.linear_2")
    for bi in range(n_blocks):
        attn = bi < n_blocks - 1
        for li in range(layers_per_block):
            out[f"down_{bi}_res_{li}"] = _resnet(
                sd, f"down_blocks.{bi}.resnets.{li}")
            if attn:
                out[f"down_{bi}_tf_{li}"] = _transformer2d(
                    sd, f"down_blocks.{bi}.attentions.{li}", tf_depth)
        if bi < n_blocks - 1:
            out[f"down_{bi}_downsample"] = _conv(
                sd, f"down_blocks.{bi}.downsamplers.0.conv")
    out["mid_res_0"] = _resnet(sd, "mid_block.resnets.0")
    out["mid_tf"] = _transformer2d(sd, "mid_block.attentions.0", tf_depth)
    out["mid_res_1"] = _resnet(sd, "mid_block.resnets.1")


def convert_sd_unet(state_dict: dict, *, strict: bool = True) -> dict:
    """diffusers ``UNet2DConditionModel`` (optionally wrapped by the
    HunyuanPaint ``UNet2p5DConditionModel``, whose keys carry a ``unet.``
    prefix and extra per-block attentions) -> ``UNet2p5D`` flax params.
    Block/layer/depth structure is inferred from the key layout."""
    prefix = "unet." if any(k.startswith("unet.") for k in state_dict) else ""
    sd = _SD(state_dict, prefix)
    n_blocks, layers_per_block, tf_depth = _unet_structure(sd)
    out: dict = {}
    _unet_down_mid(sd, out, n_blocks, layers_per_block, tf_depth)
    if "class_embedding.weight" in sd:  # x4 upscaler noise-level table
        out["camera_embedding"] = {
            "embedding": sd.take("class_embedding.weight").astype(np.float32)}
    if "camera_embedding.weight" in sd:  # HunyuanPaint camera ids
        out["camera_embedding"] = {
            "embedding": sd.take("camera_embedding.weight")
            .astype(np.float32)}
    for bi in range(n_blocks):
        attn = bi < n_blocks - 1
        # diffusers up_blocks run largest-channel first: up index u <-> our bi
        u = n_blocks - 1 - bi
        for li in range(layers_per_block + 1):
            out[f"up_{bi}_res_{li}"] = _resnet(
                sd, f"up_blocks.{u}.resnets.{li}")
            if attn:
                out[f"up_{bi}_tf_{li}"] = _transformer2d(
                    sd, f"up_blocks.{u}.attentions.{li}", tf_depth)
        if bi > 0:
            out[f"up_{bi}_upsample"] = _conv(
                sd, f"up_blocks.{u}.upsamplers.0.conv")
    out["norm_out"] = _norm(sd, "conv_norm_out")
    out["conv_out"] = _conv(sd, "conv_out")
    if strict:
        sd.assert_consumed()
    return {"params": out}


def convert_controlnet(state_dict: dict, *, strict: bool = True) -> dict:
    """diffusers ``ControlNetModel`` -> :class:`ControlNet` flax params."""
    sd = _SD(state_dict)
    n_blocks, layers_per_block, tf_depth = _unet_structure(sd)
    out: dict = {}
    _unet_down_mid(sd, out, n_blocks, layers_per_block, tf_depth)
    hint = {"conv_in": _conv(sd, "controlnet_cond_embedding.conv_in"),
            "conv_out": _conv(sd, "controlnet_cond_embedding.conv_out")}
    # diffusers blocks 0..5 pair up as (a, b) per resolution step
    n_hint = sum(1 for k in sd.sd
                 if k.startswith("controlnet_cond_embedding.blocks.")
                 and k.endswith(".weight"))
    for i in range(n_hint // 2):
        hint[f"block_{i}_a"] = _conv(
            sd, f"controlnet_cond_embedding.blocks.{2 * i}")
        hint[f"block_{i}_b"] = _conv(
            sd, f"controlnet_cond_embedding.blocks.{2 * i + 1}")
    out["hint_encoder"] = hint
    n_zero = sum(1 for k in sd.sd if k.startswith("controlnet_down_blocks.")
                 and k.endswith(".weight"))
    for i in range(n_zero):
        out[f"zero_conv_{i}"] = _conv(sd, f"controlnet_down_blocks.{i}")
    out["zero_conv_mid"] = _conv(sd, "controlnet_mid_block")
    if strict:
        sd.assert_consumed()
    return {"params": out}


def convert_sd_vae(state_dict: dict, *, strict: bool = True) -> dict:
    """diffusers ``AutoencoderKL`` -> flax ``AutoencoderKL`` params.
    Block/layer structure is inferred from the key layout."""
    sd = _SD(state_dict)
    n_blocks = _probe(sd, "encoder.down_blocks.{}.resnets.0.norm1.weight")
    layers_per_block = _probe(sd, "encoder.down_blocks.0.resnets.{}.norm1.weight")
    out: dict = {}
    out["enc_conv_in"] = _conv(sd, "encoder.conv_in")
    for bi in range(n_blocks):
        for li in range(layers_per_block):
            out[f"enc_{bi}_res_{li}"] = _vae_resnet(
                sd, f"encoder.down_blocks.{bi}.resnets.{li}")
        if bi < n_blocks - 1:
            out[f"enc_{bi}_down"] = _conv(
                sd, f"encoder.down_blocks.{bi}.downsamplers.0.conv")
    out["enc_mid_res0"] = _vae_resnet(sd, "encoder.mid_block.resnets.0")
    out["enc_mid_attn"] = dict(
        _attn(sd, "encoder.mid_block.attentions.0"),
        norm=_norm(sd, "encoder.mid_block.attentions.0.group_norm"))
    out["enc_mid_res1"] = _vae_resnet(sd, "encoder.mid_block.resnets.1")
    out["enc_norm_out"] = _norm(sd, "encoder.conv_norm_out")
    out["enc_conv_out"] = _conv(sd, "encoder.conv_out")
    out["quant_conv"] = _conv(sd, "quant_conv")
    out["post_quant_conv"] = _conv(sd, "post_quant_conv")
    out["dec_conv_in"] = _conv(sd, "decoder.conv_in")
    out["dec_mid_res0"] = _vae_resnet(sd, "decoder.mid_block.resnets.0")
    out["dec_mid_attn"] = dict(
        _attn(sd, "decoder.mid_block.attentions.0"),
        norm=_norm(sd, "decoder.mid_block.attentions.0.group_norm"))
    out["dec_mid_res1"] = _vae_resnet(sd, "decoder.mid_block.resnets.1")
    for i in range(n_blocks):
        for li in range(layers_per_block + 1):
            out[f"dec_{i}_res_{li}"] = _vae_resnet(
                sd, f"decoder.up_blocks.{i}.resnets.{li}")
        if i < n_blocks - 1:
            out[f"dec_{i}_up"] = _conv(
                sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")
    out["dec_norm_out"] = _norm(sd, "decoder.conv_norm_out")
    out["dec_conv_out"] = _conv(sd, "decoder.conv_out")
    if strict:
        sd.assert_consumed()
    return {"params": out}
