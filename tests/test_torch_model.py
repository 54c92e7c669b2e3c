"""The port's embeddings, blocks, DINOv2 and MotionLatentModel against the JAX
package, in f32 on the CPU, with the same weights on both sides: either a
JAX ``model.init`` converted by ``params_from_jax``, or one reference-named
state dict loaded by the port directly and by JAX through
``convert_motion_checkpoint``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.config import load_config
from motion324_tpu.models.dinov2 import DinoViT as JaxDino
from motion324_tpu.models.motion_model import ModelConfig as JaxConfig
from motion324_tpu.models.motion_model import MotionLatentModel as JaxModel
from motion324_tpu.models.transformer import (
    CrossAttentionBlock as JaxCrossBlock, TransformerBlock as JaxBlock)
from motion324_tpu.ops import embeddings as jax_emb
from motion324_tpu.utils.torch_convert import convert_motion_checkpoint
from motion324_tpu_torch.config import ModelConfig, load_model_config
from motion324_tpu_torch.models.dinov2 import DinoViT
from motion324_tpu_torch.models.motion_model import MotionLatentModel
from motion324_tpu_torch.models.transformer import (CrossAttentionBlock,
                                                    TransformerBlock)
from motion324_tpu_torch.ops import embeddings as emb
from motion324_tpu_torch.utils import convert
from motion324_tpu_torch.utils.convert import (load_reference_state_dict,
                                               params_from_jax)
from test_torch_convert import DIM, HEAD, N_PAIRS, PCD_LAYERS, _rand_sd

# f32 throughout; a block agrees to ~1e-6, the whole model (24 matmuls deep,
# values up to ~3) to ~2e-6 in practice: 1e-4 leaves room for BLAS order
BLOCK_TOL = 2e-5
MODEL_TOL = 1e-4

SMALL = dict(feat_dim=DIM, tokens=4, pcd_layers=PCD_LAYERS,
             n_alternating_layers=2 * N_PAIRS, head_dim=HEAD, frames=2,
             image_size=28, patch_size=14, drop_rate=0.0, dino_depth=1,
             dino_heads=3)


def _perturbed(params, seed):
    """Init params plus noise, so that norm scales, LayerScale and zero
    biases all take part in the comparison."""
    r = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * r.randn(*np.shape(a)).astype(np.float32),
        jax.device_get(params))


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------- embeddings
def test_point_basis_and_features_match():
    np.testing.assert_array_equal(emb.point_embed_basis(48),
                                  jax_emb.point_embed_basis(48))
    pts = np.random.RandomState(0).randn(5, 7, 3).astype(np.float32)
    basis = emb.point_embed_basis(48)
    want = np.asarray(jax_emb.apply_point_basis(jnp.asarray(pts),
                                                jnp.asarray(basis)))
    got = emb.apply_point_basis(torch.from_numpy(pts),
                                torch.from_numpy(basis)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_video_pos_embed_matches():
    np.testing.assert_array_equal(emb.video_pos_embed(3, 4, 5, 36),
                                  jax_emb.video_pos_embed(3, 4, 5, 36))


@pytest.mark.parametrize("target", [(32, 4, 4), (5, 4, 4), (12, 3, 6)])
def test_resize_pos_embed_matches(target):
    """Trilinear, align_corners=False: up and down in T, and in H/W."""
    pos = emb.video_pos_embed(12, 4, 4, 36)
    want = np.asarray(jax_emb.resize_pos_embed(jnp.asarray(pos), (12, 4, 4),
                                               target))
    got = emb.resize_pos_embed(torch.from_numpy(pos), (12, 4, 4), target).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- blocks
def test_transformer_block_matches():
    x = np.random.RandomState(1).randn(2, 10, DIM).astype(np.float32)
    jb = JaxBlock(dim=DIM, head_dim=HEAD, use_qk_norm=True)
    params = _perturbed(jb.init(jax.random.PRNGKey(0), x), 2)["params"]
    want = np.asarray(jb.apply({"params": params}, x))
    sd = {}
    convert._block(sd, "b", params)
    block = TransformerBlock(DIM, HEAD)
    block.load_state_dict(_sub(sd, "b."))
    got = block(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=BLOCK_TOL, rtol=BLOCK_TOL)


def test_cross_attention_block_matches():
    r = np.random.RandomState(3)
    xq = r.randn(2, 9, DIM).astype(np.float32)
    xkv = r.randn(2, 13, DIM).astype(np.float32)
    jb = JaxCrossBlock(dim=DIM, head_dim=HEAD, use_qk_norm=True)
    params = _perturbed(jb.init(jax.random.PRNGKey(0), xq, xkv, xkv), 4)["params"]
    want = np.asarray(jb.apply({"params": params}, xq, xkv, xkv))
    sd = {}
    convert._block(sd, "b", params)
    block = CrossAttentionBlock(DIM, HEAD)
    block.load_state_dict(_sub(sd, "b."))
    got = block(*(torch.from_numpy(a) for a in (xq, xkv, xkv))).detach().numpy()
    np.testing.assert_allclose(got, want, atol=BLOCK_TOL, rtol=BLOCK_TOL)


@pytest.mark.parametrize("size", [28, 42])
def test_dinov2_depth1_matches(size):
    """Pos-table resize from the 37 grid (bicubic, antialiased) to 2x2 / 3x3."""
    imgs = np.random.RandomState(5).rand(2, size, size, 3).astype(np.float32)
    jd = JaxDino(embed_dim=DIM, depth=1, num_heads=3)
    params = _perturbed(jd.init(jax.random.PRNGKey(0), imgs), 6)["params"]
    want = np.asarray(jd.apply({"params": params}, imgs))
    sd = {}
    convert._dino(sd, "m", params)
    dino = DinoViT(embed_dim=DIM, depth=1, num_heads=3)
    dino.load_state_dict(_sub(sd, "m."))
    got = dino(torch.from_numpy(imgs)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=BLOCK_TOL, rtol=BLOCK_TOL)


# ---------------------------------------------------------------- the model
def _sample(seed, t=2, hw=28, s=40, n=24):
    r = np.random.RandomState(seed)
    out = {k: r.randn(1, s if k.startswith("ref_shape") else n, 3).astype(np.float32)
           for k in ("ref_shape_pcd", "ref_shape_normals", "ref_shape_rgbs",
                     "ref_pcd", "ref_normal", "ref_rgb")}
    out["rgb_video"] = r.rand(1, t, hw, hw, 3).astype(np.float32)
    return out


def _port_forward(model, sample):
    with torch.no_grad():
        return model({k: torch.from_numpy(v) for k, v in sample.items()}).numpy()


@pytest.mark.parametrize("t,hw,chunk", [(2, 28, 1), (3, 42, 3), (4, 28, 2)])
def test_motion_model_matches_jax_init(t, hw, chunk):
    """JAX model.init -> device_get -> params_from_jax -> load_state_dict.
    Covers the in-model frame resize (42 -> 28), the pos-table resize
    (T != 2) and decoder frame folding."""
    sample = _sample(7, t=t, hw=hw)
    jm = JaxModel(JaxConfig(**SMALL, decode_frames_chunk=chunk))
    params = _perturbed(jm.init(jax.random.PRNGKey(0), sample), 8)
    want = np.asarray(jm.apply(params, sample))
    model = MotionLatentModel(ModelConfig(**SMALL, decode_frames_chunk=chunk),
                              seed=None).eval()
    model.load_state_dict(params_from_jax(params))
    got = _port_forward(model, sample)
    assert got.shape == want.shape == (1, t, 24, 3)
    np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL)


def _dino_sd(r, prefix="image_encoder.model."):
    """torch-hub-named DINOv2 weights at the small width, depth 1."""
    f = lambda *s: r.randn(*s).astype(np.float32) * 0.05
    b = prefix + "blocks.0."
    sd = {prefix + "patch_embed.proj.weight": f(DIM, 3, 14, 14),
          prefix + "patch_embed.proj.bias": f(DIM),
          prefix + "cls_token": f(1, 1, DIM),
          prefix + "pos_embed": f(1, 1 + 37 * 37, DIM),
          prefix + "mask_token": f(1, DIM),
          prefix + "norm.weight": 1 + f(DIM), prefix + "norm.bias": f(DIM)}
    for n in ("norm1", "norm2"):
        sd[b + n + ".weight"] = 1 + f(DIM)
        sd[b + n + ".bias"] = f(DIM)
    for n, din, dout in (("attn.qkv", DIM, 3 * DIM), ("attn.proj", DIM, DIM),
                         ("mlp.fc1", DIM, 4 * DIM), ("mlp.fc2", 4 * DIM, DIM)):
        sd[b + n + ".weight"] = f(dout, din)
        sd[b + n + ".bias"] = f(dout)
    sd[b + "ls1.gamma"] = 0.5 + f(DIM)
    sd[b + "ls2.gamma"] = 0.5 + f(DIM)
    return sd


def test_reference_state_dict_loads_on_both_sides():
    """One reference-named state dict (with the reference's computed
    ``pos_embed`` buffer and DINOv2's mask token, which the port drops):
    the port loads it strictly, JAX through convert_motion_checkpoint."""
    r = np.random.RandomState(9)
    sd = _rand_sd(r)
    sd.update(_dino_sd(r))
    sd["pos_embed"] = r.randn(1, 2 * 4, DIM).astype(np.float32)
    sample = _sample(10)
    jm = JaxModel(JaxConfig(**SMALL))
    want = np.asarray(jm.apply(convert_motion_checkpoint(
        sd, n_pairs=N_PAIRS, pcd_layers=PCD_LAYERS), sample))
    model = MotionLatentModel(ModelConfig(**SMALL), seed=None).eval()
    load_reference_state_dict(model, {f"module.{k}": v for k, v in sd.items()})
    got = _port_forward(model, sample)
    np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL)


def test_state_dict_names_are_the_reference_ones():
    """Every port parameter has a reference name (`_rand_sd` + DINOv2), and
    the video position table is not saved."""
    r = np.random.RandomState(11)
    names = set(_rand_sd(r)) | set(_dino_sd(r)) - {"image_encoder.model.mask_token"}
    model = MotionLatentModel(ModelConfig(**SMALL), seed=None)
    assert set(model.state_dict()) == names
    assert "video_pos_embed" not in model.state_dict()


def test_seeded_init_is_deterministic():
    a = MotionLatentModel(ModelConfig(**SMALL), seed=3).state_dict()
    b = MotionLatentModel(ModelConfig(**SMALL), seed=3).state_dict()
    c = MotionLatentModel(ModelConfig(**SMALL), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["learnable_tokens"], c["learnable_tokens"])


def test_model_config_from_yaml_matches_jax():
    """configs/dyscene.yaml read by the port and by ModelConfig.from_config
    give the same single-device fields; the port's defaults are that
    release model."""
    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "dyscene.yaml")
    want = JaxConfig.from_config(load_config(path))
    got = load_model_config(path)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "dtype":
            assert str(a).split(".")[-1] == np.dtype(b).name == "bfloat16"
        else:
            assert a == b, f.name
    assert got == dataclasses.replace(
        ModelConfig(), dtype=torch.bfloat16,
        decode_frames_chunk=want.decode_frames_chunk)
