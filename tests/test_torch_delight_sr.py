"""The IP2P delighter, the x4 upscaler and their cv2-free image ops in the
port against the JAX package (and cv2), on the CPU in f32 at tiny widths:
``DelightDiffusion`` (a step, and a whole call on an odd-sized image, INTER_AREA
in and INTER_CUBIC out, the JAX loop fed the port's noise), ``Upscaler`` with
epsilon- and v-prediction (a step, a whole call), the weight-free
``upscale_x4`` and the bicubic, Lanczos-4 and Gaussian blur against cv2, and
``PaintPipeline(super_resolution=True)`` against the JAX pipeline.

Weights are drawn on the port's side from a fixed seed and handed to the
flax modules as param trees; the port loads them back through
``diffusion_params_from_jax``. The JAX side runs
eagerly under ``jax.disable_jit()``. Tolerances: modules 1e-4 of max |JAX|,
whole samplers 1e-3 absolute on the [0, 1] images, cv2 counterparts 1e-4
absolute.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.hy3dgen.delight import DelightDiffusion as JaxDelight
from motion324_tpu.hy3dgen.paint_pipeline import PaintPipeline as JaxPaint
from motion324_tpu.hy3dgen.sd_unet import UNet2p5D as JaxUNet
from motion324_tpu.hy3dgen.sd_vae import AutoencoderKL as JaxVAE
from motion324_tpu.hy3dgen.super_resolution import (Upscaler as JaxUpscaler,
                                                    upscale_x4 as jax_upscale_x4)
from motion324_tpu.io.mesh import TriMesh as JaxMesh
from motion324_tpu_torch.hy3dgen.delight import DelightDiffusion, delight_image
from motion324_tpu_torch.hy3dgen.diffusion_common import random_fill
from motion324_tpu_torch.hy3dgen.paint_diffusion import sd_sigmas
from motion324_tpu_torch.hy3dgen.paint_pipeline import PaintPipeline
from motion324_tpu_torch.hy3dgen.sd_unet import UNet2p5D
from motion324_tpu_torch.hy3dgen.sd_vae import AutoencoderKL
from motion324_tpu_torch.hy3dgen.super_resolution import (Upscaler,
                                                          ddpm_alphas_cumprod,
                                                          upscale_x4)
from motion324_tpu_torch.io.mesh import TriMesh
from motion324_tpu_torch.utils.convert import diffusion_params_from_jax
from motion324_tpu_torch.utils.image import (gaussian_blur, resize_area,
                                             resize_cubic, resize_lanczos4)
from torch_flax import close, nchw, nhwc, to_flax

MODULE_REL = 1e-4
IMAGE_ATOL = 1e-3
CV2_ATOL = 1e-4
SIZES = [((13, 7), (52, 28)), ((37, 23), (11, 45)), ((64, 48), (17, 33)),
         ((1, 1), (4, 4)), ((5, 9), (5, 9))]


# --------------------------------------------------------------------------- #
# the cv2-free image ops
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("src,dst", SIZES)
def test_bicubic_and_lanczos_match_cv2(src, dst):
    img = np.random.RandomState(sum(src)).rand(*src, 3).astype(np.float32)
    for ours, flag in ((resize_cubic, cv2.INTER_CUBIC),
                       (resize_lanczos4, cv2.INTER_LANCZOS4)):
        want = cv2.resize(img, dst[::-1], interpolation=flag)
        np.testing.assert_allclose(ours(img, dst[::-1]).numpy(), want, rtol=0,
                                   atol=CV2_ATOL)


@pytest.mark.parametrize("src,dst", [((70, 50), (64, 64)), ((50, 70), (64, 64)),
                                     ((64, 64), (37, 51)), ((13, 40), (20, 17))])
def test_resize_area_matches_cv2_where_one_axis_grows(src, dst):
    """OpenCV averages areas only where the image shrinks along both axes;
    where one axis grows it takes its area-mode linear weights along both
    (the delighter's 64^2 input from a 70 x 50 image)."""
    img = np.random.RandomState(sum(src)).rand(*src, 3).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(resize_area(img, dst[::-1]).numpy(), want,
                               rtol=0, atol=CV2_ATOL)


@pytest.mark.parametrize("shape", [(52, 28), (3, 2), (1, 7), (33, 33)])
def test_gaussian_blur_matches_cv2(shape):
    img = np.random.RandomState(shape[0]).rand(*shape, 3).astype(np.float32)
    want = cv2.GaussianBlur(img, (0, 0), 1.5)
    np.testing.assert_allclose(gaussian_blur(img, 1.5).numpy(), want, rtol=0,
                               atol=CV2_ATOL)


@pytest.mark.parametrize("shape", [(12, 10), (7, 5), (1, 1)])
def test_upscale_x4_matches_the_jax_one(shape):
    img = np.random.RandomState(3).rand(*shape, 3).astype(np.float32)
    got = upscale_x4(img)
    assert got.shape == (4 * shape[0], 4 * shape[1], 3)
    np.testing.assert_allclose(got.numpy(), jax_upscale_x4(img), rtol=0,
                               atol=CV2_ATOL)
    np.testing.assert_allclose(Upscaler(None, device="cpu")(img).numpy(),
                               JaxUpscaler(None)(img), rtol=0, atol=CV2_ATOL)


# --------------------------------------------------------------------------- #
# DelightDiffusion
# --------------------------------------------------------------------------- #
D_UNET = dict(in_channels=8, block_channels=(8, 8), layers_per_block=1,
              head_dim=4, context_dim=16)
VAE = dict(block_channels=(4, 4, 4, 4), layers_per_block=1)


def _pair(unet_kw, vae_kw, extra: dict, seed: int, **port_unet):
    """Port modules with seeded weights and their flax trees, round-tripped
    through the port's converter."""
    gen = torch.Generator().manual_seed(seed)
    unet = UNet2p5D(**unet_kw, multiview=False, **port_unet)
    vae = AutoencoderKL(**vae_kw)
    random_fill(unet, gen)
    random_fill(vae, gen)
    flax = {"unet": {"params": to_flax(unet)}, "vae": {"params": to_flax(vae)},
            **extra}
    params = diffusion_params_from_jax(flax)
    for m, key in ((unet, "unet"), (vae, "vae")):
        for name, t in m.state_dict().items():
            assert torch.equal(params[key][name], t), name
    return params, flax


@pytest.fixture(scope="module")
def delighters():
    text = np.random.RandomState(4).randn(1, 4, 16).astype(np.float32)
    params, flax = _pair(D_UNET, VAE, {"text": text}, 0,
                         num_camera_embeds=0)
    tp = DelightDiffusion(params, image_size=64, text_len=4, context_dim=16,
                          dtype=torch.float32, device="cpu",
                          unet=UNet2p5D(**D_UNET, num_camera_embeds=0,
                                        multiview=False),
                          vae=AutoencoderKL(**VAE))
    jp = JaxDelight(flax, image_size=64, text_len=4, context_dim=16,
                    dtype=jnp.float32, unet=JaxUNet(**D_UNET), vae=JaxVAE(**VAE))
    return tp, jp


def test_delight_step_matches(delighters):
    tp, jp = delighters
    rng = np.random.RandomState(5)
    noisy, img_lat, noise = (rng.randn(1, 8, 8, 4).astype(np.float32)
                             for _ in range(3))
    args = (400.0, 3.0, 2.2)
    with jax.disable_jit():
        want = jp._step(jp.params["unet"], jnp.asarray(noisy), jnp.asarray(img_lat),
                        jnp.asarray(jp.params["text"]), *args, jnp.asarray(noise),
                        1.5, 1.0)
    got = tp.step(nchw(noisy), nchw(img_lat), tp.text, *args, nchw(noise), 1.5,
                  1.0)
    close(nhwc(got), want, MODULE_REL)


def test_delight_call_matches_the_jax_loop_fed_its_noise(delighters):
    """A whole delight (2 steps) of a 70 x 50 image: INTER_AREA to 64^2, the
    steps, INTER_CUBIC back; the JAX side the same loop with cv2's resizes
    and the port's noise (one CPU generator: the initial latents, then one
    draw per step)."""
    tp, jp = delighters
    image = np.random.RandomState(6).rand(70, 50, 3).astype(np.float32)
    got = tp(image, num_steps=2, seed=3)
    gen = torch.Generator().manual_seed(3)
    randn = lambda: jnp.asarray(nhwc(torch.randn((1, 4, 8, 8),
                                                 generator=gen)).numpy())
    ts, sigmas = sd_sigmas(2)
    with jax.disable_jit():
        img = cv2.resize(image, (64, 64), interpolation=cv2.INTER_AREA)
        img_lat = jp._encode(jp.params["vae"], jnp.asarray(img)[None] * 2 - 1)
        x = randn() * sigmas[0]
        for i in range(2):
            x = jp._step(jp.params["unet"], x, img_lat,
                         jnp.asarray(jp.params["text"]), float(ts[i]),
                         float(sigmas[i]), float(sigmas[i + 1]), randn(), 1.5, 1.0)
        out = np.clip((np.asarray(jp._decode(jp.params["vae"], x))[0] + 1) / 2,
                      0, 1)
    want = cv2.resize(out, (50, 70), interpolation=cv2.INTER_CUBIC)
    assert got.shape == (70, 50, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL)
    # as delight_image's editor: the recorrected image of the edit
    fixed = delight_image(image, editor=lambda im: got)
    assert fixed.shape == image.shape and np.isfinite(fixed).all()


# --------------------------------------------------------------------------- #
# Upscaler
# --------------------------------------------------------------------------- #
S_UNET = dict(in_channels=7, out_channels=4, block_channels=(8, 8),
              layers_per_block=1, head_dim=4, context_dim=16,
              num_camera_embeds=1000)
S_VAE = dict(block_channels=(4, 4, 4), layers_per_block=1)


@pytest.fixture(scope="module")
def upscalers():
    """{prediction type: (port Upscaler, JAX Upscaler)} on the same
    weights."""
    rng = np.random.RandomState(7)
    text = {"text_cond": rng.randn(1, 4, 16).astype(np.float32),
            "text_uncond": rng.randn(1, 4, 16).astype(np.float32) * 0.1}
    params, flax = _pair(S_UNET, S_VAE, text, 1)
    out = {}
    for pred in ("v", "epsilon"):
        tp = Upscaler(params, unet=UNet2p5D(**S_UNET, multiview=False),
                      vae=AutoencoderKL(**S_VAE), context_dim=16, text_len=4,
                      prediction_type=pred, dtype=torch.float32, device="cpu")
        jp = JaxUpscaler(flax, unet=JaxUNet(**S_UNET), vae=JaxVAE(**S_VAE),
                         context_dim=16, text_len=4, prediction_type=pred,
                         dtype=jnp.float32)
        out[pred] = tp, jp
    return out


@pytest.mark.parametrize("pred", ["v", "epsilon"])
def test_upscaler_step_matches(upscalers, pred):
    tp, jp = upscalers[pred]
    rng = np.random.RandomState(8)
    x = rng.randn(1, 8, 8, 4).astype(np.float32)
    low = rng.randn(1, 8, 8, 3).astype(np.float32)
    a = ddpm_alphas_cumprod().astype(np.float32)
    with jax.disable_jit():
        want = jp._step(jp.params["unet"], jnp.asarray(x), jnp.asarray(low),
                        jp.params["text_cond"], jp.params["text_uncond"], 20,
                        499.0, float(a[499]), float(a[249]), 9.0)
    got = tp.step(nchw(x), nchw(low), 20, 499.0, float(a[499]), float(a[249]),
                  9.0)
    close(nhwc(got), want, MODULE_REL)


def test_upscaler_call_matches_the_jax_loop_fed_its_noise(upscalers):
    """A whole 4x upscale (2 DDIM steps) of an 8 x 8 image; the JAX side
    the same loop with the port's noise: one CPU generator, the
    augmentation noise first, then the initial latents (v-prediction)."""
    tp, jp = upscalers["v"]
    image = np.random.RandomState(9).rand(8, 8, 3).astype(np.float32)
    got = tp(image, num_steps=2, seed=5)
    gen = torch.Generator().manual_seed(5)
    aug = nhwc(torch.randn((1, 3, 8, 8), generator=gen)).numpy()
    x = jnp.asarray(nhwc(torch.randn((1, 4, 8, 8), generator=gen)).numpy())
    alphas = ddpm_alphas_cumprod().astype(np.float32)
    a_nl = alphas[20]
    low = np.sqrt(a_nl) * (image[None] * 2 - 1) + np.sqrt(1 - a_nl) * aug
    ts = np.linspace(999, 0, 2).round().astype(np.int64)
    with jax.disable_jit():
        for i, t in enumerate(ts):
            a_prev = float(alphas[ts[i + 1]]) if i + 1 < 2 else 1.0
            x = jp._step(jp.params["unet"], x, jnp.asarray(low, jnp.float32),
                         jp.params["text_cond"], jp.params["text_uncond"], 20,
                         float(t), float(alphas[t]), a_prev, 9.0)
        want = np.clip((np.asarray(jp._decode(jp.params["vae"], x))[0] + 1) / 2,
                       0, 1)
    assert got.shape == (32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMAGE_ATOL)


def test_paint_pipeline_with_super_resolution_matches_jax():
    """``PaintPipeline(super_resolution=True)`` without upscaler weights
    (the Lanczos fallback on every view before baking) against the JAX
    pipeline, as tests/test_torch_paint_render.py holds the plain one."""
    from test_torch_paint_render import _image, sphere
    verts, faces = sphere(8)
    image = _image(5, 70, 70).astype(np.float32) / 255
    tp = PaintPipeline(resolution=24, texture_size=64, super_resolution=True,
                       device="cpu")
    got = tp(TriMesh(vertices=verts, faces=faces), image)
    jp = JaxPaint(resolution=24, texture_size=64, super_resolution=True,
                  interpret=True)
    with jax.disable_jit():
        want = jp(JaxMesh(vertices=verts, faces=faces), image)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.texture, want.texture, rtol=0,
                               atol=1.0 / 255 + 1e-6)
    assert "super_resolution" in tp.last_run["seconds"]
    assert isinstance(tp.upscaler, Upscaler) and tp.upscaler.unet is None
