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
- :func:`shape_params_from_jax`: the JAX ``ShapeGenPipeline.params``
  (``dit``, ``vae``, ``conditioner``) -> the port's three state dicts.
- :func:`hunyuan_ckpt_state_dicts`: the released single-file shape
  checkpoint (``{'model', 'vae', 'conditioner'}``) -> the port's three state
  dicts and the dims they imply. The DiT and VAE modules keep the reference
  names, so ``model`` and the decoder part of ``vae`` load as they are; the
  conditioner's HF DINOv2 names (separate q/k/v) map through
  :func:`dinov2_hf_state_dict`.
- :func:`paint_params_from_jax`: the JAX ``MultiviewDiffusion.params``
  (``unet``, ``vae``) -> the state dicts of the port's ``UNet2p5D`` and
  ``AutoencoderKL``, whose module names are the flax names
  (:func:`flax_to_state_dict`).
- :func:`diffusion_params_from_jax`: the params of the JAX package's
  texture extras (the UNet with IP-Adapter projections, ControlNet,
  Resampler; the IP2P delighter; the x4 upscaler; HunyuanDiT2D) -> the
  port's state dicts, through :func:`flax_to_state_dict`, which also maps
  a CLIP text tower's tree; :func:`text2image_params_from_jax` the
  text-to-image pipeline's, its DiT through the shape DiT's mapping;
- :func:`u2net_params_from_jax`, :func:`isnet_params_from_jax`: the JAX
  package's U2Net / ISNet variables (``{"params", "batch_stats"}``) -> the
  public ``u2net.pth`` / ``isnet-general-use`` state dict that the port's
  networks load as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from motion324_tpu_torch.parallel.pp import model_part

__all__ = ["params_from_jax", "load_reference_state_dict",
           "shape_params_from_jax", "dinov2_hf_state_dict",
           "hunyuan_ckpt_state_dicts", "flax_to_state_dict",
           "paint_params_from_jax", "u2net_params_from_jax",
           "isnet_params_from_jax", "diffusion_params_from_jax",
           "text2image_params_from_jax"]


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
    """A DINOv2 ViT's params under ``prefix`` (empty for none); the MLP or
    the SwiGLU (``mlp_w12`` / ``mlp_w3``) feed-forward."""
    prefix = f"{prefix}." if prefix else ""
    kern = np.asarray(p["patch_embed"]["kernel"])
    out[f"{prefix}patch_embed.proj.weight"] = _t(kern.transpose(3, 2, 0, 1))
    out[f"{prefix}patch_embed.proj.bias"] = _t(p["patch_embed"]["bias"])
    out[f"{prefix}cls_token"] = _t(p["cls_token"])
    out[f"{prefix}pos_embed"] = _t(p["pos_embed"])
    _norm(out, f"{prefix}norm", p["norm"])
    for i, blk in enumerate(_layers(p["blocks"])):
        b = f"{prefix}blocks.{i}"
        _norm(out, f"{b}.norm1", blk["norm1"])
        _dense(out, f"{b}.attn.qkv", blk["attn"]["qkv"])
        _dense(out, f"{b}.attn.proj", blk["attn"]["proj"])
        out[f"{b}.ls1.gamma"] = _t(blk["ls1_gamma"])
        _norm(out, f"{b}.norm2", blk["norm2"])
        if "mlp_w12" in blk:
            _dense(out, f"{b}.mlp.w12", blk["mlp_w12"])
            _dense(out, f"{b}.mlp.w3", blk["mlp_w3"])
        else:
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
    """Load a reference checkpoint into ``model`` (strict); a
    tensor-parallel model (``model.tp``) takes its shard, a pipeline stage
    (``model.pp``) its pairs.

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
    model.load_state_dict(model_part(model, clean))


# --------------------------------------------------------------------------- #
# shape generation: Hunyuan3D-2 DiT, ShapeVAE, DINOv2-giant conditioner
# --------------------------------------------------------------------------- #
def _dit_from_jax(p: dict) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    _dense(out, "latent_in", p["latent_in"])
    _dense(out, "cond_in", p["cond_in"])
    _dense(out, "time_in.in_layer", p["time_in"]["in_layer"])
    _dense(out, "time_in.out_layer", p["time_in"]["out_layer"])
    doubles = p["double_blocks"]["block"]
    for i in range(len(np.asarray(doubles["img_proj"]["kernel"]))):
        blk = _unstack(doubles, i)
        b = f"double_blocks.{i}"
        for s in ("img", "txt"):
            _dense(out, f"{b}.{s}_mod.lin", blk[f"{s}_mod"]["lin"])
            attn = blk[f"{s}_attn"]
            _dense(out, f"{b}.{s}_attn.qkv", attn["qkv"])
            out[f"{b}.{s}_attn.norm.query_norm.scale"] = _t(attn["q_norm"]["scale"])
            out[f"{b}.{s}_attn.norm.key_norm.scale"] = _t(attn["k_norm"]["scale"])
            _dense(out, f"{b}.{s}_attn.proj", blk[f"{s}_proj"])
            _dense(out, f"{b}.{s}_mlp.0", blk[f"{s}_mlp_fc1"])
            _dense(out, f"{b}.{s}_mlp.2", blk[f"{s}_mlp_fc2"])
    singles = p["single_blocks"]["block"]
    for i in range(len(np.asarray(singles["linear1"]["kernel"]))):
        blk = _unstack(singles, i)
        b = f"single_blocks.{i}"
        _dense(out, f"{b}.modulation.lin", blk["modulation"]["lin"])
        _dense(out, f"{b}.linear1", blk["linear1"])
        _dense(out, f"{b}.linear2", blk["linear2"])
        out[f"{b}.norm.query_norm.scale"] = _t(blk["q_norm"]["scale"])
        out[f"{b}.norm.key_norm.scale"] = _t(blk["k_norm"]["scale"])
    _dense(out, "final_layer.adaLN_modulation.1", p["final_mod"])
    _dense(out, "final_layer.linear", p["final_linear"])
    return out


def _vae_from_jax(p: dict) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    _dense(out, "post_kl", p["post_kl"])
    for i, blk in enumerate(_layers(p["blocks"])):
        b = f"transformer.resblocks.{i}"
        _norm(out, f"{b}.ln_1", blk["ln_1"])
        _dense(out, f"{b}.attn.c_qkv", blk["c_qkv"])
        _dense(out, f"{b}.attn.c_proj", blk["c_proj"])
        _norm(out, f"{b}.ln_2", blk["ln_2"])
        _dense(out, f"{b}.mlp.c_fc", blk["c_fc"])
        _dense(out, f"{b}.mlp.c_proj", blk["c_proj_mlp"])
    g, x = "geo_decoder", "geo_decoder.cross_attn_decoder"
    geo = p["geo_decoder"]
    _dense(out, f"{g}.query_proj", p["query_proj"])
    for name in ("ln_1", "ln_2", "ln_3"):
        _norm(out, f"{x}.{name}", geo[name])
    for ours, theirs in (("attn.c_q", "c_q"), ("attn.c_kv", "c_kv"),
                         ("attn.c_proj", "c_proj"), ("mlp.c_fc", "c_fc"),
                         ("mlp.c_proj", "c_proj_mlp")):
        _dense(out, f"{x}.{ours}", geo[theirs])
    _norm(out, f"{g}.ln_post", p["ln_post"])
    _dense(out, f"{g}.output_proj", p["output_proj"])
    return out


def shape_params_from_jax(tree: dict) -> dict[str, dict[str, torch.Tensor]]:
    """JAX ``ShapeGenPipeline.params`` (leaves as numpy arrays) -> the
    port's ``{'dit', 'vae', 'conditioner'}`` state dicts (float32). A
    multiview conditioner's ViT lands under ``dino.``."""
    unwrap = lambda t: t.get("params", t)
    cond = unwrap(tree["conditioner"])
    out: dict[str, torch.Tensor] = {}
    if "dino" in cond:
        _dino(out, "dino", cond["dino"])
    else:
        _dino(out, "", cond)
    return {"dit": _dit_from_jax(unwrap(tree["dit"])),
            "vae": _vae_from_jax(unwrap(tree["vae"])),
            "conditioner": out}


def dinov2_hf_state_dict(sd: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """An HF ``Dinov2Model`` state dict (separate q/k/v, ``layer_scale1``,
    ``mlp.weights_in`` for SwiGLU) -> the port's DinoViT names under
    ``prefix``; the fused qkv stacks q, k and v along the output axis."""
    t = lambda k: _t(sd[k].float().numpy() if isinstance(sd[k], torch.Tensor)
                     else sd[k])
    out = {f"{prefix}patch_embed.proj.weight":
               t("embeddings.patch_embeddings.projection.weight"),
           f"{prefix}patch_embed.proj.bias":
               t("embeddings.patch_embeddings.projection.bias"),
           f"{prefix}cls_token": t("embeddings.cls_token"),
           f"{prefix}pos_embed": t("embeddings.position_embeddings"),
           f"{prefix}norm.weight": t("layernorm.weight"),
           f"{prefix}norm.bias": t("layernorm.bias")}
    i = 0
    while f"encoder.layer.{i}.norm1.weight" in sd:
        h, b = f"encoder.layer.{i}", f"{prefix}blocks.{i}"
        a = f"{h}.attention.attention"
        for kind in ("weight", "bias"):
            out[f"{b}.attn.qkv.{kind}"] = torch.cat(
                [t(f"{a}.{n}.{kind}") for n in ("query", "key", "value")])
            out[f"{b}.attn.proj.{kind}"] = t(f"{h}.attention.output.dense.{kind}")
            for n in ("norm1", "norm2"):
                out[f"{b}.{n}.{kind}"] = t(f"{h}.{n}.{kind}")
            if f"{h}.mlp.weights_in.weight" in sd:
                out[f"{b}.mlp.w12.{kind}"] = t(f"{h}.mlp.weights_in.{kind}")
                out[f"{b}.mlp.w3.{kind}"] = t(f"{h}.mlp.weights_out.{kind}")
            else:
                out[f"{b}.mlp.fc1.{kind}"] = t(f"{h}.mlp.fc1.{kind}")
                out[f"{b}.mlp.fc2.{kind}"] = t(f"{h}.mlp.fc2.{kind}")
        out[f"{b}.ls1.gamma"] = t(f"{h}.layer_scale1.lambda1")
        out[f"{b}.ls2.gamma"] = t(f"{h}.layer_scale2.lambda1")
        i += 1
    return out


def _count(sd: dict, fmt: str) -> int:
    i = 0
    while any(k.startswith(fmt.format(i)) for k in sd):
        i += 1
    return i


def hunyuan_ckpt_state_dicts(ckpt: dict, mv: bool = False):
    """The released checkpoint's ``{'model', 'vae', 'conditioner'}``
    sub-dicts -> ``(state_dicts, dims)``: the port's ``dit``, ``vae`` (its
    decoder keys) and, where present, ``conditioner`` state dicts (float32),
    and the :class:`ShapeGenPipeline` dims they imply (depths, widths,
    latent and condition dims, SwiGLU or MLP feed-forward, position grid).
    With ``mv`` the conditioner's ViT lands under ``dino.``."""
    f32 = lambda sd: {k: v.float() for k, v in sd.items()}
    dit, vae = f32(ckpt["model"]), f32(ckpt["vae"])
    dims = {
        "dit_depth": _count(dit, "double_blocks.{}."),
        "dit_single": _count(dit, "single_blocks.{}."),
        "dit_hidden": dit["latent_in.weight"].shape[0],
        "latent_dim": dit["latent_in.weight"].shape[1],
        "cond_dim": dit["cond_in.weight"].shape[1],
        "vae_layers": _count(vae, "transformer.resblocks.{}."),
        "vae_width": vae["post_kl.weight"].shape[0],
    }
    # head count from the per-head QK-RMSNorm scale width
    head_dim = dit["double_blocks.0.img_attn.norm.query_norm.scale"].shape[0]
    dims["dit_heads"] = dims["dit_hidden"] // head_dim
    out = {"dit": dit, "vae": vae}
    if "conditioner" in ckpt:
        cond = ckpt["conditioner"]
        prefix = "main_image_encoder.model."
        dino = {k[len(prefix):]: v for k, v in cond.items()
                if k.startswith(prefix)} or dict(cond)
        dims["cond_depth"] = _count(dino, "encoder.layer.{}.")
        dims["cond_mlp_type"] = ("swiglu" if any("weights_in" in k for k in dino)
                                 else "mlp")
        n_pos = dino["embeddings.position_embeddings"].shape[1]
        dims["cond_native_grid"] = int(round((n_pos - 1) ** 0.5))
        out["conditioner"] = dinov2_hf_state_dict(dino, "dino." if mv else "")
    return out, dims


# params that are raw arrays, not a layer's kernel / scale / embedding
_RAW_LEAVES = ("latents", "token_embedding", "position_embedding",
               "positional_embedding", "text_embedding_padding")


def flax_to_state_dict(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """A flax param tree whose module names are the port's -> its state
    dict: Dense ``kernel (in, out)`` -> ``weight (out, in)``; Conv ``kernel
    (kh, kw, in, out)`` -> ``weight (out, in, kh, kw)``; norm ``scale`` ->
    ``weight``; Embed ``embedding`` -> ``weight``; ``bias`` and the raw
    parameters (the resampler's latents, the CLIP and HunyuanDiT tables) as
    they are."""
    out: dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flax_to_state_dict(val, name + "."))
            continue
        a = np.asarray(val, np.float32)
        if key == "kernel":
            a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
            out[f"{prefix}weight"] = _t(a)
        elif key in ("scale", "embedding"):
            out[f"{prefix}weight"] = _t(a)
        elif key == "bias" or key in _RAW_LEAVES:
            out[name] = _t(a)
        else:
            raise KeyError(f"unexpected flax leaf {name}")
    return out


def _inner(tree: dict) -> dict:
    return tree.get("params", tree)


def paint_params_from_jax(params: dict):
    """The JAX ``MultiviewDiffusion.params`` (``{"unet": {"params": ...},
    "vae": {"params": ...}, ...}``) -> ``(unet_sd, vae_sd)`` for the port's
    ``UNet2p5D`` and ``AutoencoderKL``."""
    return (flax_to_state_dict(params["unet"]["params"]),
            flax_to_state_dict(params["vae"]["params"]))


def diffusion_params_from_jax(params: dict) -> dict:
    """The params of a JAX diffusion pipeline whose modules carry the
    port's names (``Img2ImgControlPipeline``: unet with ``to_k_ip`` /
    ``to_v_ip``, controlnet, vae, resampler; ``DelightDiffusion``;
    ``Upscaler``; ``HunyuanDiTImagePipeline``: transformer, vae) -> the
    port's: each param tree a state dict, each array (a prompt
    embedding) f32."""
    return {k: (flax_to_state_dict(_inner(v)) if isinstance(v, dict)
                else np.asarray(v, np.float32)) for k, v in params.items()}


def text2image_params_from_jax(params: dict) -> dict:
    """The JAX ``TextToImagePipeline.params`` (``text``, ``dit``, ``vae``)
    -> the port's three state dicts; the DiT's scanned block stacks split
    per block as the shape DiT's are."""
    return {"text": flax_to_state_dict(_inner(params["text"])),
            "dit": _dit_from_jax(_inner(params["dit"])),
            "vae": flax_to_state_dict(_inner(params["vae"]))}


_U2NET_HEIGHTS = {"stage1": 7, "stage2": 6, "stage3": 5, "stage4": 4,
                  "stage1d": 7, "stage2d": 6, "stage3d": 5, "stage4d": 4}


def _conv(out: dict, name: str, p: dict) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    out[f"{name}.bias"] = _t(p["bias"])


def _conv_bn(out: dict, name: str, p: dict, stats: dict,
             conv: str = "conv_s1", bn: str = "bn_s1") -> None:
    """The JAX ``_ConvBNReLU`` {conv, bn} (+ its batch stats) -> a public
    REBNCONV ``{conv_s1, bn_s1}`` (or the stem's ``{conv, bn}``)."""
    _conv(out, f"{name}.{conv}", p["conv"])
    out[f"{name}.{bn}.weight"] = _t(p["bn"]["scale"])
    out[f"{name}.{bn}.bias"] = _t(p["bn"]["bias"])
    out[f"{name}.{bn}.running_mean"] = _t(stats["bn"]["mean"])
    out[f"{name}.{bn}.running_var"] = _t(stats["bn"]["var"])
    out[f"{name}.{bn}.num_batches_tracked"] = torch.tensor(0)


def _u2net_stages(out: dict, params: dict, stats: dict) -> None:
    """The RSU stages: ``conv_in``/``enc_i``/``bottom``/``dec_i`` ->
    ``rebnconvin``/``rebnconv{i+1}``/``rebnconv{h}``/``rebnconv{i+1}d``;
    RSU4F's ``e1..e4``/``d3..d1`` -> ``rebnconv1..4``/``rebnconv3d..1d``."""
    for st, h in _U2NET_HEIGHTS.items():
        names = {"conv_in": "rebnconvin", "bottom": f"rebnconv{h}"}
        for i in range(h - 1):
            names[f"enc_{i}"] = f"rebnconv{i + 1}"
            names[f"dec_{i}"] = f"rebnconv{i + 1}d"
        for ours, theirs in names.items():
            _conv_bn(out, f"{st}.{theirs}", params[st][ours], stats[st][ours])
    for st in ("stage5", "stage6", "stage5d"):
        names = {"conv_in": "rebnconvin",
                 **{f"e{i}": f"rebnconv{i}" for i in range(1, 5)},
                 **{f"d{i}": f"rebnconv{i}d" for i in (3, 2, 1)}}
        for ours, theirs in names.items():
            _conv_bn(out, f"{st}.{theirs}", params[st][ours], stats[st][ours])


def u2net_params_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX package's U2Net variables (numpy, ``{"params",
    "batch_stats"}``) -> the public ``u2net.pth`` state dict, which the
    port's :class:`~motion324_tpu_torch.inference.segmentation.U2Net`
    loads as it is (the inverse of the JAX ``convert_u2net``)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}
    _u2net_stages(out, params, stats)
    for i in range(1, 7):
        _conv(out, f"side{i}", params[f"side{i}"])
    _conv(out, "outconv", params["outconv"])
    return out


def isnet_params_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX package's ISNet variables (numpy, ``{"params",
    "batch_stats"}``) -> the DIS ``isnet-general-use`` state dict the port's
    ``ISNet`` loads (the stem ``conv_in.{conv,bn}``, the RSU stages,
    ``side1``)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}
    _conv_bn(out, "conv_in", params["conv_in"], stats["conv_in"],
             conv="conv", bn="bn")
    _u2net_stages(out, params, stats)
    _conv(out, "side1", params["side1"])
    return out
