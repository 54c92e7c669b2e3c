"""ControlNet img2img with IP-Adapter in the port against the JAX package,
on the CPU in f32 at tiny widths: the UNet's ``control_residuals`` and
``ip_tokens``, ControlNet, the Resampler, ``convert_controlnet``, one
Euler-Ancestral step and whole samplers (pure generation with an image
prompt, and the ``strength`` < 1 img2img mode), the JAX loop fed the port's
noise stream, and the released-weight loader.

Weights are drawn on the port's side from a fixed seed and handed to the
flax modules as a param tree; the port loads them back through
``diffusion_params_from_jax``. The JAX side runs eagerly under
``jax.disable_jit()``. Tolerances: modules 1e-4 of max |JAX|, whole
samplers 1e-3 absolute on the [0, 1] images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.hy3dgen.img2img import (ControlNet as JaxControlNet,
                                           Img2ImgControlPipeline as JaxPipe,
                                           Resampler as JaxResampler)
from motion324_tpu.hy3dgen.sd_unet import UNet2p5D as JaxUNet
from motion324_tpu.hy3dgen.sd_vae import AutoencoderKL as JaxVAE
from motion324_tpu.utils.sd_convert import convert_controlnet as jax_convert_cn
from motion324_tpu_torch.hy3dgen.img2img import (ControlNet,
                                                 Img2ImgControlPipeline,
                                                 Resampler)
from motion324_tpu_torch.hy3dgen.diffusion_common import random_fill
from motion324_tpu_torch.hy3dgen.paint_diffusion import sd_sigmas
from motion324_tpu_torch.hy3dgen.sd_unet import UNet2p5D
from motion324_tpu_torch.hy3dgen.sd_vae import AutoencoderKL
from motion324_tpu_torch.utils.convert import diffusion_params_from_jax
from motion324_tpu_torch.utils.sd_convert import convert_controlnet
from torch_flax import close, nchw, nhwc, to_flax

MODULE_REL = 1e-4
IMAGE_ATOL = 1e-3
UNET = dict(in_channels=4, block_channels=(8, 8, 8), layers_per_block=1,
            head_dim=4, context_dim=16)
CN = dict(block_channels=(8, 8, 8), layers_per_block=1, head_dim=4,
          context_dim=16)
VAE = dict(block_channels=(4, 4, 4, 4), layers_per_block=1)
RES = dict(dim=8, depth=1, heads=2, num_queries=4, output_dim=16)
FEAT = 8


def port_modules():
    return (UNet2p5D(**UNET, num_camera_embeds=0, multiview=False,
                     ip_adapter=True),
            ControlNet(**CN), AutoencoderKL(**VAE),
            Resampler(**RES, feature_dim=FEAT))


@pytest.fixture(scope="module")
def pipes():
    """(port pipeline, JAX pipeline) with the same tiny f32 weights; the
    ControlNet's zero convs moved off zero so its residuals reach the
    UNet."""
    gen = torch.Generator().manual_seed(0)
    mods = port_modules()
    for m in mods:
        random_fill(m, gen)
    with torch.no_grad():
        for m in mods[1].zero_modules():
            m.weight.normal_(0.0, 0.3, generator=gen)
            m.bias.normal_(0.0, 0.05, generator=gen)
    rng = np.random.RandomState(1)
    flax = {k: {"params": to_flax(m)}
            for k, m in zip(("unet", "controlnet", "vae", "resampler"), mods)}
    flax["text_cond"] = rng.randn(1, 4, 16).astype(np.float32)
    flax["text_uncond"] = rng.randn(1, 4, 16).astype(np.float32) * 0.1
    params = diffusion_params_from_jax(flax)
    for m, key in zip(mods, ("unet", "controlnet", "vae", "resampler")):
        sd = m.state_dict()
        assert sd.keys() == params[key].keys(), key
        for name, t in sd.items():
            assert torch.equal(params[key][name], t), name
    tp = Img2ImgControlPipeline(params, unet=port_modules()[0],
                                controlnet=ControlNet(**CN),
                                vae=AutoencoderKL(**VAE),
                                resampler=Resampler(**RES, feature_dim=FEAT),
                                context_dim=16, text_len=4, dtype=torch.float32,
                                device="cpu")
    jp = JaxPipe(flax, unet=JaxUNet(**UNET), controlnet=JaxControlNet(**CN),
                 vae=JaxVAE(**VAE), resampler=JaxResampler(**RES),
                 context_dim=16, text_len=4, dtype=jnp.float32)
    return tp, jp


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, 8, 8, 4).astype(np.float32),
            rng.rand(1, 64, 64, 3).astype(np.float32),
            rng.randn(1, 4, 16).astype(np.float32),
            rng.randn(1, 4, 16).astype(np.float32))


def test_controlnet_matches(pipes):
    tp, jp = pipes
    lat, hint, ctx, _ = _inputs(2)
    t = np.array([321.0], np.float32)
    with jax.disable_jit():
        jd, jm = jp.controlnet.apply(jp.params["controlnet"], jnp.asarray(lat),
                                     jnp.asarray(t), jnp.asarray(ctx),
                                     jnp.asarray(hint), conditioning_scale=0.7)
    with torch.no_grad():
        td, tm = tp.controlnet(nchw(lat), torch.from_numpy(t),
                               torch.from_numpy(ctx), nchw(hint),
                               conditioning_scale=0.7)
    assert len(td) == len(jd) == 6   # conv_in, 3 stages x 1, 2 downsamples
    for a, b in zip(td, jd):
        close(nhwc(a), b, MODULE_REL)
    close(nhwc(tm), jm, MODULE_REL)


@pytest.mark.parametrize("control,ip", [(True, True), (True, False),
                                        (False, True)])
def test_unet_with_residuals_and_ip_tokens_matches(pipes, control, ip):
    """The UNet with ControlNet residuals added to each skip and after the
    mid block, and IP-Adapter tokens through ``to_k_ip`` / ``to_v_ip``."""
    tp, jp = pipes
    lat, hint, ctx, ip_tok = _inputs(3)
    t = np.array([500.0], np.float32)
    with jax.disable_jit():
        res = (jp.controlnet.apply(jp.params["controlnet"], jnp.asarray(lat),
                                   jnp.asarray(t), jnp.asarray(ctx),
                                   jnp.asarray(hint)) if control else None)
        want = jp.unet.apply(jp.params["unet"], jnp.asarray(lat), jnp.asarray(t),
                             jnp.asarray(ctx), control_residuals=res,
                             ip_tokens=jnp.asarray(ip_tok) if ip else None,
                             ip_scale=0.7)
    tres = None
    if control:
        tres = ([nchw(r) for r in res[0]], nchw(res[1]))
    with torch.no_grad():
        got = tp.unet(nchw(lat), torch.from_numpy(t), torch.from_numpy(ctx),
                      control_residuals=tres,
                      ip_tokens=torch.from_numpy(ip_tok) if ip else None,
                      ip_scale=0.7)
    close(nhwc(got), want, MODULE_REL)


def test_ip_scale_zero_and_no_ip_adapter_leave_the_unet_alone(pipes):
    """``ip_scale`` 0 gives the output without image tokens; a UNet built
    without ``ip_adapter`` has no IP projections and the paint UNet's keys."""
    tp, _ = pipes
    lat, _, ctx, ip_tok = _inputs(4)
    t = torch.tensor([10.0])
    with torch.no_grad():
        plain = tp.unet(nchw(lat), t, torch.from_numpy(ctx))
        zero = tp.unet(nchw(lat), t, torch.from_numpy(ctx),
                       ip_tokens=torch.from_numpy(ip_tok), ip_scale=0.0)
        one = tp.unet(nchw(lat), t, torch.from_numpy(ctx),
                      ip_tokens=torch.from_numpy(ip_tok), ip_scale=1.0)
    torch.testing.assert_close(zero, plain, rtol=0, atol=1e-6)
    assert (one - plain).abs().max() > 1e-4
    keys = set(UNet2p5D(**UNET).state_dict())
    assert not any("_ip" in k for k in keys)
    assert any("attn_refview" in k for k in keys)
    assert "camera_embedding.weight" in keys
    bare = set(UNet2p5D(**UNET, num_camera_embeds=0, multiview=False).state_dict())
    assert bare == {k for k in keys if "attn_refview" not in k
                    and "attn_multiview" not in k and "camera" not in k}


def test_resampler_matches(pipes):
    tp, jp = pipes
    feats = np.random.RandomState(5).randn(2, 10, FEAT).astype(np.float32)
    with jax.disable_jit():
        want = jp.resampler.apply(jp.params["resampler"], jnp.asarray(feats))
    with torch.no_grad():
        got = tp.resampler(torch.from_numpy(feats))
    close(got, want, MODULE_REL)


def test_convert_controlnet_matches_the_jax_converter(pipes):
    import test_sd_convert as sd
    _, jp = pipes
    state = sd.synth_controlnet_sd(jp.params["controlnet"], n_blocks=3,
                                   layers=1)
    want = jax_convert_cn(state)
    got = convert_controlnet(state)
    sd._trees_equal(got, want)
    state["controlnet_mid_block.extra"] = np.zeros(2, np.float32)
    with pytest.raises(KeyError):
        convert_controlnet(state)


def _step_args(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, 8, 8, 4).astype(np.float32) * 3,
            rng.rand(1, 64, 64, 3).astype(np.float32),
            rng.randn(1, 4, 16).astype(np.float32),
            rng.randn(1, 4, 16).astype(np.float32),
            rng.randn(1, 8, 8, 4).astype(np.float32))


def test_euler_ancestral_step_matches(pipes):
    tp, jp = pipes
    x, hint, ip_c, ip_u, noise = _step_args(6)
    ctx_c, ctx_u = jp.params["text_cond"], jp.params["text_uncond"]
    args = (500.0, 2.5, 1.9, None, 8.0, 0.8, 0.7)
    with jax.disable_jit():
        want = jp._step(jp.params["unet"], jp.params["controlnet"],
                        jnp.asarray(x), jnp.asarray(hint), jnp.asarray(ctx_c),
                        jnp.asarray(ctx_u), jnp.asarray(ip_c), jnp.asarray(ip_u),
                        *args[:3], jnp.asarray(noise), *args[4:])
    got = tp.step(nchw(x), nchw(hint), tp.text_cond, tp.text_uncond,
                  torch.from_numpy(ip_c), torch.from_numpy(ip_u), *args[:3],
                  nchw(noise), *args[4:])
    close(nhwc(got), want, MODULE_REL)


@pytest.mark.parametrize("mode", ["image_prompt", "strength"])
def test_sampler_matches_the_jax_steps_fed_its_noise(pipes, mode):
    """A whole sampler (2 steps; the img2img mode at strength 0.5 starts at
    step 1) against the JAX step functions in the same loop
    with the port's noise: one CPU generator seeded with ``seed``, the
    initial latents first, then one draw per step."""
    tp, jp = pipes
    rng = np.random.RandomState(7)
    control = rng.rand(64, 64, 3).astype(np.float32)
    feats = rng.randn(1, 6, FEAT).astype(np.float32)
    init = rng.rand(64, 64, 3).astype(np.float32)
    kw = (dict(image_features=feats, num_steps=2) if mode == "image_prompt"
          else dict(init_image=init, strength=0.5, num_steps=2))
    got = tp(control, seed=9, **kw)

    steps = kw["num_steps"]
    gen = torch.Generator().manual_seed(9)
    randn = lambda: jnp.asarray(nhwc(torch.randn((1, 4, 8, 8),
                                                 generator=gen)).numpy())
    timesteps, sigmas = sd_sigmas(steps)
    with jax.disable_jit():
        p = jp.params
        if mode == "image_prompt":
            ip_c = jp._resample(p["resampler"], jnp.asarray(feats))
            ip_u = jp._resample(p["resampler"], jnp.zeros_like(jnp.asarray(feats)))
            start, x = 0, randn() * sigmas[0]
        else:
            ip_c = ip_u = jnp.zeros((1, 4, 16))
            start = 1
            x = jp._encode(p["vae"], jnp.asarray(init)[None] * 2 - 1) \
                + randn() * sigmas[start]
        for i in range(start, steps):
            x = jp._step(p["unet"], p["controlnet"], x,
                         jnp.asarray(control)[None], jnp.asarray(p["text_cond"]),
                         jnp.asarray(p["text_uncond"]), ip_c, ip_u,
                         float(timesteps[i]), float(sigmas[i]),
                         float(sigmas[i + 1]), randn(), 8.0, 1.0, 0.7)
        want = np.clip((np.asarray(jp._decode(p["vae"], x))[0] + 1) / 2, 0, 1)
    assert got.shape == (64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMAGE_ATOL)


def test_from_diffusers_loads_the_same_weights(pipes):
    """The released layouts (a diffusers SD UNet with IP-Adapter's
    ``processor.to_k_ip.0`` / ``to_v_ip.0`` under each ``attn2``, the depth
    ControlNet, the AutoencoderKL, the resampler's state dict) load to the
    same weights; the JAX package's loader cannot take the UNet."""
    import test_sd_convert as sd
    tp, jp = pipes
    p = jp.params
    unet_sd = sd.synth_unet_sd({"params": p["unet"]["params"]},
                               n_blocks=3, layers=1)
    for name, sub in p["unet"]["params"].items():
        if "_tf_" not in name and name != "mid_tf":
            continue
        # the diffusers name of this attn2, found by its to_q
        prefix = next(k for k in unet_sd if k.endswith(".attn2.to_q.weight")
                      and np.array_equal(unet_sd[k].T,
                                         sub["block_0"]["attn2"]["to_q"]["kernel"]))
        base = prefix[:-len(".to_q.weight")]
        for ip in ("to_k_ip", "to_v_ip"):
            unet_sd[f"{base}.processor.{ip}.0.weight"] = np.asarray(
                sub["block_0"]["attn2"][ip]["kernel"]).T
    # the JAX package's converter refuses them (ROADMAP.md, Queue 3): its
    # strict key check finds IP-Adapter's keys unconsumed
    from motion324_tpu.utils.sd_convert import convert_sd_unet as jax_convert
    with pytest.raises(KeyError, match="unconsumed"):
        jax_convert(unet_sd)
    loaded = Img2ImgControlPipeline.from_diffusers(
        unet_sd, sd.synth_controlnet_sd(p["controlnet"], n_blocks=3, layers=1),
        sd.synth_vae_sd(p["vae"], layers=1), tp.resampler.state_dict(),
        p["text_cond"], p["text_uncond"], head_dim=4, dtype=torch.float32,
        device="cpu")
    for a, b in zip(loaded.modules, tp.modules):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
