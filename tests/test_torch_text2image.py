"""Text-to-image in the port against the JAX package, on the CPU in f32 at
tiny widths: the CLIP text tower and ``convert_clip_text``,
``TextToImagePipeline`` (its DiT on patchified
latents and a whole sampler, the JAX loop fed the port's noise),
``HunyuanDiT2D`` against the JAX module and against the torch oracle of
diffusers' layout (tests/hunyuan_dit_oracle.py) through
``convert_hunyuan_dit_image``, the released dims, and the HunyuanDiT
pipeline's CFG and PAG steps and sampler.

The JAX side runs eagerly under ``jax.disable_jit()``. Tolerances: modules
1e-4 of max |JAX|, whole samplers 1e-3 absolute on the [0, 1] images, the
oracle 2e-4 of its max (it sums in another order through other kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hunyuan_dit_oracle
from motion324_tpu.hy3dgen.hunyuan_dit_image import (
    HunyuanDiT2D as JaxHDiT, HunyuanDiTImagePipeline as JaxHPipe)
from motion324_tpu.hy3dgen.sd_vae import AutoencoderKL as JaxVAE
from motion324_tpu.hy3dgen.text2image import (
    CLIPTextCfg as JaxCfg, CLIPTextTower as JaxTower,
    TextToImagePipeline as JaxT2I, convert_clip_text as jax_convert_clip)
from motion324_tpu_torch.hy3dgen.hunyuan_dit_image import (
    HunyuanDiT2D, HunyuanDiTImagePipeline, convert_hunyuan_dit_image)
from motion324_tpu_torch.hy3dgen.diffusion_common import random_fill
from motion324_tpu_torch.hy3dgen.scheduler import flow_match_sigmas
from motion324_tpu_torch.hy3dgen.sd_vae import AutoencoderKL
from motion324_tpu_torch.hy3dgen.text2image import (CLIPTextCfg, CLIPTextTower,
                                                    TextToImagePipeline,
                                                    convert_clip_text)
from motion324_tpu_torch.models.motion_model import init_weights
from motion324_tpu_torch.utils.convert import (diffusion_params_from_jax,
                                               flax_to_state_dict,
                                               text2image_params_from_jax)
from torch_flax import close, nchw, nhwc, to_flax

MODULE_REL = 1e-4
IMAGE_ATOL = 1e-3
ORACLE_REL = 2e-4
TINY = dict(vocab=100, hidden=64, intermediate=128, layers=2, heads=4,
            max_len=16, eos_token=99)
VAE = dict(block_channels=(4, 4, 4, 4), layers_per_block=1)


def _tokens(seed, b=2):
    tokens = np.random.RandomState(seed).randint(0, 98, (b, 16))
    tokens[0, 9] = tokens[-1, -1] = 99       # EOS mid-sequence and last
    return tokens


def _hf_clip_state(seed):
    """A random state dict in HF ``CLIPTextModel``'s names."""
    rng = np.random.RandomState(seed)
    h, f = TINY["hidden"], TINY["intermediate"]
    r = lambda *s: (rng.randn(*s) * s[-1] ** -0.5).astype(np.float32)
    sd = {"text_model.embeddings.token_embedding.weight": r(100, h),
          "text_model.embeddings.position_embedding.weight": r(16, h),
          "text_model.final_layer_norm.weight": 1 + r(h) * 0.1,
          "text_model.final_layer_norm.bias": r(h) * 0.1}
    for i in range(TINY["layers"]):
        b = f"text_model.encoder.layers.{i}"
        for n, (o, c) in {"self_attn.q_proj": (h, h), "self_attn.k_proj": (h, h),
                          "self_attn.v_proj": (h, h), "self_attn.out_proj": (h, h),
                          "mlp.fc1": (f, h), "mlp.fc2": (h, f)}.items():
            sd[f"{b}.{n}.weight"], sd[f"{b}.{n}.bias"] = r(o, c), r(o) * 0.1
        for n in ("layer_norm1", "layer_norm2"):
            sd[f"{b}.{n}.weight"], sd[f"{b}.{n}.bias"] = 1 + r(h) * 0.1, r(h) * 0.1
    return sd


def test_clip_tower_and_converter_match_jax():
    """The same HF-layout weights through each package's converter; the
    port's tower also round-trips through ``flax_to_state_dict``."""
    hf = _hf_clip_state(0)
    tower = CLIPTextTower(CLIPTextCfg(**TINY))
    tower.load_state_dict(convert_clip_text(hf, CLIPTextCfg(**TINY)))
    jt = JaxTower(JaxCfg(**TINY), params=jax_convert_clip(hf, JaxCfg(**TINY)))
    tokens = _tokens(1)
    with jax.disable_jit():
        want_states, want_pooled = jt(tokens)
    with torch.no_grad():
        states, pooled = tower(tokens)
    close(states, want_states, MODULE_REL)
    close(pooled, want_pooled, MODULE_REL)
    back = flax_to_state_dict(to_flax(tower))
    for k, v in tower.state_dict().items():
        assert torch.equal(back[k], v), k


# --------------------------------------------------------------------------- #
# TextToImagePipeline
# --------------------------------------------------------------------------- #
T2I = dict(image_size=64, dit_hidden=64, dit_heads=4, dit_depth=1, dit_single=1)


def dit_to_flax(dit) -> dict:
    """The port's ``Hunyuan3DDiT`` as the JAX package's flax tree: each
    block stack's leaves stacked along a leading layer axis."""
    sd = {k: v.detach().numpy() for k, v in dit.state_dict().items()}
    dense = lambda n: {"kernel": sd[f"{n}.weight"].T, "bias": sd[f"{n}.bias"]}
    stack = lambda trees: jax.tree_util.tree_map(lambda *a: np.stack(a), *trees)
    doubles = []
    for i in range(len(dit.double_blocks)):
        b, blk = f"double_blocks.{i}", {}
        for s in ("img", "txt"):
            blk[f"{s}_mod"] = {"lin": dense(f"{b}.{s}_mod.lin")}
            blk[f"{s}_attn"] = {
                "qkv": dense(f"{b}.{s}_attn.qkv"),
                "q_norm": {"scale": sd[f"{b}.{s}_attn.norm.query_norm.scale"]},
                "k_norm": {"scale": sd[f"{b}.{s}_attn.norm.key_norm.scale"]}}
            blk[f"{s}_proj"] = dense(f"{b}.{s}_attn.proj")
            blk[f"{s}_mlp_fc1"] = dense(f"{b}.{s}_mlp.0")
            blk[f"{s}_mlp_fc2"] = dense(f"{b}.{s}_mlp.2")
        doubles.append(blk)
    singles = [{"modulation": {"lin": dense(f"single_blocks.{i}.modulation.lin")},
                "linear1": dense(f"single_blocks.{i}.linear1"),
                "linear2": dense(f"single_blocks.{i}.linear2"),
                "q_norm": {"scale": sd[f"single_blocks.{i}.norm.query_norm.scale"]},
                "k_norm": {"scale": sd[f"single_blocks.{i}.norm.key_norm.scale"]}}
               for i in range(len(dit.single_blocks))]
    return {"params": {
        "latent_in": dense("latent_in"), "cond_in": dense("cond_in"),
        "time_in": {"in_layer": dense("time_in.in_layer"),
                    "out_layer": dense("time_in.out_layer")},
        "double_blocks": {"block": stack(doubles)},
        "single_blocks": {"block": stack(singles)},
        "final_mod": dense("final_layer.adaLN_modulation.1"),
        "final_linear": dense("final_layer.linear")}}


@pytest.fixture(scope="module")
def t2i():
    """(port pipeline, JAX pipeline) on the same tiny weights, drawn on the
    port's side; the port's come back through ``text2image_params_from_jax``."""
    tp = TextToImagePipeline.init_random(
        torch.Generator().manual_seed(3), text_cfg=CLIPTextCfg(**TINY),
        vae_kwargs=VAE, dtype=torch.float32, device="cpu", **T2I)
    flax = {"text": {"params": to_flax(tp.text)}, "dit": dit_to_flax(tp.dit),
            "vae": {"params": to_flax(tp.vae)}}
    back = text2image_params_from_jax(flax)
    for mod, key in zip(tp.modules, ("text", "dit", "vae")):
        for name, t in mod.state_dict().items():
            assert torch.equal(back[key][name], t), name
    jp = JaxT2I(flax, text_cfg=JaxCfg(**TINY), dtype=jnp.float32, **T2I)
    jp.vae = JaxVAE(**VAE)
    return tp, jp


def test_text_dit_matches(t2i):
    tp, jp = t2i
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, 16).astype(np.float32)
    t = np.array([0.3, 0.9], np.float32)
    ctx = rng.randn(2, 16, 64).astype(np.float32)
    with jax.disable_jit():
        want = jp.dit.apply(jp.params["dit"], jnp.asarray(x), jnp.asarray(t),
                            jnp.asarray(ctx))
    with torch.no_grad():
        got = tp.dit(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    close(got, want, MODULE_REL)


def test_text_to_image_matches_the_jax_loop_fed_its_noise(t2i):
    """A whole text-to-image call (2 flow-matching steps, CFG 5): the JAX
    side's text states, ``_denoise`` and decode with the port's initial
    latents (a CPU generator seeded with ``seed``)."""
    tp, jp = t2i
    tokens = _tokens(5, b=1)[0]
    got = tp(tokens, num_steps=2, seed=4)
    x = torch.randn((1, 16, 16), generator=torch.Generator().manual_seed(4))
    with jax.disable_jit():
        states, _ = jp.text(tokens[None])
        ctx = jnp.asarray(np.concatenate([states, np.zeros_like(states)]))
        out = jp._denoise(jp.params["dit"], jnp.asarray(x.numpy()), ctx,
                          jnp.asarray(flow_match_sigmas(2))[::-1], 5.0)
        z = np.asarray(out).reshape(1, 4, 4, 2, 2, 4).transpose(0, 1, 3, 2, 4, 5)
        img = jp._decode(jp.params["vae"], jnp.asarray(z.reshape(1, 8, 8, 4)))
    want = np.clip((np.asarray(img)[0] + 1) / 2, 0, 1)
    assert got.shape == (64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMAGE_ATOL)


def test_text_to_image_prompt_reaches_the_image(t2i):
    tp, _ = t2i
    a = tp(_tokens(6, b=1)[0], num_steps=2)
    b = tp(_tokens(7, b=1)[0], num_steps=2)
    assert a.shape == (64, 64, 3) and torch.isfinite(a).all()
    assert not torch.equal(a, b)


# --------------------------------------------------------------------------- #
# HunyuanDiT2D
# --------------------------------------------------------------------------- #
CFG = dict(hidden=32, heads=4, num_layers=6, patch=2, in_channels=4,
           ctx_dim=16, t5_dim=24, text_len=5, text_len_t5=7)


def _dit_inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 8, 8, 4).astype(np.float32),
            np.array([3.0, 250.0], np.float32),
            rng.randn(2, 5, 16).astype(np.float32),
            rng.randn(2, 7, 24).astype(np.float32),
            np.array([[1, 1, 1, 0, 0], [1] * 5], np.int32),
            np.array([[1] * 7, [1, 1, 1, 1, 0, 0, 0]], np.int32),
            np.tile(np.array([[64, 64, 64, 64, 0, 0]], np.float32), (2, 1)),
            np.zeros((2,), np.int64))


def _port_dit(seed, **kw):
    model = HunyuanDiT2D(**CFG, **kw)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if p.dim() == 1:       # norms and biases off their initial values
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return model.eval()


def _port_call(model, inp, **kw):
    x, t, clip, t5, cm, tm, meta, style = (torch.from_numpy(a) for a in inp)
    with torch.no_grad():
        return model(x.permute(0, 3, 1, 2), t, clip, t5, cm, tm, meta, style, **kw)


@pytest.mark.parametrize("use_style", [True, False])
def test_hunyuan_dit_matches_jax(use_style):
    model = _port_dit(0, use_style=use_style)
    tree = to_flax(model)
    back = flax_to_state_dict(tree)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    inp = _dit_inputs(1)
    with jax.disable_jit():
        want = JaxHDiT(**CFG, use_style=use_style).apply(
            {"params": tree}, *(jnp.asarray(a) for a in inp))
    close(nhwc(_port_call(model, inp)), want, MODULE_REL)


def test_hunyuan_dit_matches_the_oracle_through_the_converter():
    torch.manual_seed(0)
    ref = hunyuan_dit_oracle.HunyuanDiT2DModel(**CFG)
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(torch.randn_like(p) * 0.05)
    sd = ref.eval().state_dict()
    model = HunyuanDiT2D(**CFG)
    model.load_state_dict(convert_hunyuan_dit_image(sd, num_layers=6))
    inp = _dit_inputs(2)
    x, t, clip, t5, cm, tm, meta, style = (torch.from_numpy(a) for a in inp)
    with torch.no_grad():
        want = ref(x.permute(0, 3, 1, 2), t, clip, t5, cm, tm, meta, style)
    close(_port_call(model, inp), want, ORACLE_REL)
    sd = dict(sd, **{"blocks.0.unknown.weight": torch.zeros(2, 2)})
    with pytest.raises(KeyError):
        convert_hunyuan_dit_image(sd, num_layers=6)


def test_hunyuan_dit_released_dims_match_jax():
    """At release width (1 408 wide, 40 blocks) the port's parameter shapes
    are the flax tree's, read from ``jax.eval_shape`` and mapped through
    the converter's rules, without allocating either."""
    with torch.device("meta"):
        model = HunyuanDiT2D()
    shapes = jax.eval_shape(lambda: JaxHDiT().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, 1024)), jnp.zeros((1, 256, 2048))))["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [k.key for k in path]
        shape, last = tuple(leaf.shape), names[-1]
        if last == "kernel":      # Dense (in, out) -> (out, in); Conv -> OIHW
            shape = shape[::-1] if len(shape) == 2 else (
                shape[3], shape[2], shape[0], shape[1])
        if last in ("kernel", "scale", "embedding"):
            last = "weight"
        want[".".join(names[:-1] + [last])] = shape
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert sum(np.prod(s) for s in got.values()) > 1.45e9


@pytest.fixture(scope="module")
def hpipes():
    model = _port_dit(3)
    vae = AutoencoderKL(block_channels=(8, 16), layers_per_block=1)
    random_fill(vae, torch.Generator().manual_seed(4))
    flax = {"transformer": {"params": to_flax(model)},
            "vae": {"params": to_flax(vae)}}
    tp = HunyuanDiTImagePipeline(
        diffusion_params_from_jax(flax),
        model=HunyuanDiT2D(**CFG), vae=AutoencoderKL(block_channels=(8, 16),
                                                      layers_per_block=1),
        image_size=64, pag_applied_layers=(2, 3), dtype=torch.float32,
        device="cpu")
    jp = JaxHPipe(flax, model=JaxHDiT(**CFG),
                  vae=JaxVAE(block_channels=(8, 16), layers_per_block=1),
                  image_size=64, pag_applied_layers=(2, 3))
    return tp, jp


def _text(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, 5, 16).astype(np.float32),
            rng.randn(1, 7, 24).astype(np.float32))


@pytest.mark.parametrize("pag", [False, True])
def test_hunyuan_pipeline_step_matches(hpipes, pag):
    tp, jp = hpipes
    clip, t5 = _text(5)
    x = np.random.RandomState(6).randn(1, 8, 8, 4).astype(np.float32)
    cm, tm = np.ones((1, 5), np.int32), np.ones((1, 7), np.int32)
    a = jp._alphas
    args = (500.0, float(a[500]), float(a[250]))
    zeros = lambda z: np.zeros_like(z)
    with jax.disable_jit():
        jargs = (jp.params["transformer"], jnp.asarray(x), *args, clip,
                 zeros(clip), t5, zeros(t5), cm, tm, 6.0)
        want = jp._step_pag(*jargs, 1.3) if pag else jp._step(*jargs)
    t = lambda z: torch.from_numpy(z)
    got = tp.step(nchw(x), *args, t(clip), t(zeros(clip)), t(t5), t(zeros(t5)),
                  t(cm), t(tm), 6.0, 1.3 if pag else None)
    close(nhwc(got), want, MODULE_REL)


def test_hunyuan_pipeline_matches_the_jax_loop_fed_its_noise(hpipes):
    """A whole call (2 DDIM steps, CFG and PAG): the JAX steps with the
    port's initial latents; PAG at scale 0 is plain CFG; PAG only in blocks
    that exist."""
    tp, jp = hpipes
    clip, t5 = _text(7)
    got = tp(clip, t5, num_steps=2, enable_pag=True, seed=8)
    x = jnp.asarray(nhwc(torch.randn((1, 4, 8, 8),
                                     generator=torch.Generator().manual_seed(8)))
                    .numpy())
    ones = (np.ones((1, 5), np.int32), np.ones((1, 7), np.int32))
    ts = np.linspace(999, 0, 2).round().astype(np.int64)
    with jax.disable_jit():
        for i, t in enumerate(ts):
            a_prev = jp._alphas[int(ts[i + 1])] if i + 1 < 2 else jnp.float32(1)
            x = jp._step_pag(jp.params["transformer"], x, float(t),
                             jp._alphas[int(t)], a_prev, clip, np.zeros_like(clip),
                             t5, np.zeros_like(t5), *ones, 6.0, 1.3)
        want = np.clip((np.asarray(jp._decode(jp.params["vae"], x)) + 1) / 2, 0, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMAGE_ATOL)
    plain = tp(torch.from_numpy(clip), torch.from_numpy(t5), num_steps=2, seed=8)
    pag0 = tp(clip, t5, num_steps=2, seed=8, enable_pag=True, pag_scale=0.0)
    torch.testing.assert_close(pag0, plain, rtol=0, atol=1e-6)
    assert not torch.allclose(got, plain, atol=1e-4)
    assert HunyuanDiTImagePipeline(
        {}, model=HunyuanDiT2D(**CFG), vae=AutoencoderKL(block_channels=(8,),
                                                          layers_per_block=1),
        device="cpu").pag_applied_layers == ()


def test_pag_identity_attention():
    """PAG's perturbed self-attention is ``to_out(to_v(x))``."""
    model = _port_dit(9)
    attn = model.block_2.attn1
    x = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = attn(x, perturb=True)
        base = attn(x)
    torch.testing.assert_close(got, attn.to_out(attn.to_v(x)))
    assert not torch.allclose(base, got, atol=1e-3)
