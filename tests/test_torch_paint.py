"""The texture-diffusion models of the port against the JAX package, on the
CPU in f32 at tiny widths: ``AutoencoderKL``, ``UNet2p5D`` (the ``w`` pass's
reference bank, the ``r`` pass at ref_scale 0 and 1, multiview attention
with dense and with implicit voxel masks), the Euler and LCM steps, a whole
``generate`` re-driven through the JAX step functions with the port's
noise, the released-weight loader, ``PaintPipeline`` with tiny diffusion
weights, and the ``--texture`` CLI.

Weights are drawn on the port's side from a fixed seed and handed to the
flax modules as a param tree in the JAX package's layout; the port's
modules load them back through ``paint_params_from_jax``. The JAX side runs
under ``jax.disable_jit()`` (compiling the tiny UNet takes minutes; eager it
takes seconds). Unless a test says otherwise both sides compute the same
f32 function with sums in another order: 1e-5 of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.hy3dgen.paint_diffusion import MultiviewDiffusion as JaxMV
from motion324_tpu.hy3dgen.sd_unet import UNet2p5D as JaxUNet
from motion324_tpu.hy3dgen.sd_vae import AutoencoderKL as JaxVAE
from motion324_tpu.hy3dgen.voxel_attention import (
    multi_resolution_mask as jax_dense_masks,
    multi_resolution_positions as jax_implicit_masks)
from motion324_tpu_torch.hy3dgen.diffusion_common import random_fill
from motion324_tpu_torch.hy3dgen.paint_diffusion import (
    MultiviewDiffusion, lcm_schedule, sd_sigmas)
from motion324_tpu_torch.hy3dgen.sd_unet import UNet2p5D
from motion324_tpu_torch.hy3dgen.sd_vae import AutoencoderKL
from motion324_tpu_torch.hy3dgen.voxel_attention import (
    multi_resolution_mask, multi_resolution_positions)
from motion324_tpu_torch.utils.convert import paint_params_from_jax

UNET = dict(block_channels=(8, 8, 8, 8), context_dim=32, head_dim=8)
VAE = dict(block_channels=(4, 4, 4, 4))
REL = 1e-5
N_VIEWS = 2


def close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def to_flax(module: torch.nn.Module) -> dict:
    """The port's weights as a flax param tree in the JAX package's layout
    (Dense ``(in, out)``, Conv ``(kh, kw, in, out)``, norm ``scale``)."""
    tree: dict = {}
    for name, mod in module.named_modules():
        params = dict(mod.named_parameters(recurse=False))
        if not params:
            continue
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        w = params["weight"].detach().numpy()
        if isinstance(mod, torch.nn.Embedding):
            node["embedding"] = w
        elif w.ndim == 1:
            node["scale"] = w
        else:
            node["kernel"] = w.T if w.ndim == 2 else w.transpose(2, 3, 1, 0)
        if "bias" in params:
            node["bias"] = params["bias"].detach().numpy()
    return tree


def nhwc(x):
    return x.permute(0, 2, 3, 1)


@pytest.fixture(scope="module")
def models():
    """(port MultiviewDiffusion, JAX MultiviewDiffusion) with the same tiny
    f32 weights; the port's come back through paint_params_from_jax."""
    gen = torch.Generator().manual_seed(0)
    unet, vae = UNet2p5D(**UNET), AutoencoderKL(**VAE)
    random_fill(unet, gen)
    random_fill(vae, gen)
    flax = {"unet": {"params": to_flax(unet)}, "vae": {"params": to_flax(vae)}}
    text = [np.random.RandomState(s).randn(1, 77, 32).astype(np.float32) * 0.02
            for s in (1, 2)]
    usd, vsd = paint_params_from_jax(flax)
    for name, t in unet.state_dict().items():
        assert torch.equal(usd[name], t), name
    params = {"unet": usd, "vae": vsd, "text_gen": text[0], "text_ref": text[1]}
    tmv = MultiviewDiffusion(params, unet=UNet2p5D(**UNET),
                             vae=AutoencoderKL(**VAE), context_dim=32,
                             dtype=torch.float32, device="cpu")
    jmv = JaxMV({**flax, "text_gen": text[0], "text_ref": text[1]},
                unet=JaxUNet(**UNET), vae=JaxVAE(**VAE), context_dim=32,
                dtype=jnp.float32)
    return tmv, jmv


def _latents(seed, n, c=12, s=8):
    return np.random.RandomState(seed).randn(n, s, s, c).astype(np.float32)


def test_vae_encode_decode_match(models):
    tmv, jmv = models
    img = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    with jax.disable_jit():
        jm, jl = jmv.vae.apply(jmv.params["vae"], jnp.asarray(img),
                               method=JaxVAE.encode)
        z = _latents(4, 2, c=4)
        jd = jmv.vae.apply(jmv.params["vae"], jnp.asarray(z),
                           method=JaxVAE.decode)
    with torch.no_grad():
        tm, tl = tmv.vae.encode(torch.from_numpy(img).permute(0, 3, 1, 2))
        td = tmv.vae.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    close(nhwc(tm), jm)
    close(nhwc(tl), jl)
    close(nhwc(td), jd)


def _jax_bank(jmv, ref_in, ctx):
    _, v = jmv.unet.apply(jmv.params["unet"], jnp.asarray(ref_in), jnp.zeros((1,)),
                          jnp.asarray(ctx), jnp.zeros((1,), jnp.int32), 1, "w",
                          mutable=["ref_bank"])
    return v["ref_bank"]


@pytest.fixture(scope="module")
def banks(models):
    """The ``w`` pass on both sides: (port bank, JAX bank, JAX output)."""
    tmv, jmv = models
    ref_in = _latents(5, 1)
    ctx = np.random.RandomState(6).randn(1, 77, 32).astype(np.float32)
    with jax.disable_jit():
        jbank = _jax_bank(jmv, ref_in, ctx)
    with torch.no_grad():
        _, tbank = tmv.unet(torch.from_numpy(ref_in).permute(0, 3, 1, 2),
                            torch.zeros(1), torch.from_numpy(ctx),
                            torch.zeros(1, dtype=torch.int64), 1, "w")
    return tbank, jbank


def test_w_pass_bank_matches(banks):
    tbank, jbank = banks
    assert len(tbank) == 16         # 2 x 3 down, the mid, 3 x 3 up
    for key, val in tbank.items():
        mod, block = key.split(".")
        (want,) = jbank[mod][block]["kv"]
        close(val, want)


def _r_pass(models, banks, ref_scale, masks=None, jmasks=None):
    tmv, jmv = models
    tbank, jbank = banks
    x = _latents(7, N_VIEWS)
    ctx = np.random.RandomState(8).randn(N_VIEWS, 77, 32).astype(np.float32)
    t = np.full((N_VIEWS,), 421.0, np.float32)
    cam = np.arange(N_VIEWS) + 5
    with jax.disable_jit():
        want = jmv.unet.apply(jmv.params["unet"], jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(ctx), jnp.asarray(cam), N_VIEWS, "r",
                              jbank, ref_scale=ref_scale, mva_masks=jmasks)
    with torch.no_grad():
        got = tmv.unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(t), torch.from_numpy(ctx),
                       torch.from_numpy(cam), N_VIEWS, "r", tbank,
                       ref_scale=ref_scale, mva_masks=masks)
    assert got.dtype == torch.float32
    return nhwc(got), want


@pytest.mark.parametrize("ref_scale", [1.0, 0.0])
def test_r_pass_matches(models, banks, ref_scale):
    close(*_r_pass(models, banks, ref_scale))


def _position_maps():
    """(1, N, 64, 64, 3) view position maps with background exactly 1.0: the
    grids (8, 4, 2) give masks at the 8^2, 4^2 and 2^2 latent levels."""
    rng = np.random.RandomState(9)
    pm = (rng.randint(0, 3, (1, N_VIEWS, 8, 8, 3)) / 3 + 0.1).repeat(8, 2).repeat(8, 3)
    pm = pm + rng.uniform(0, 0.05, pm.shape)
    pm[:, :, :16] = 1.0
    return pm.astype(np.float32)


@pytest.mark.parametrize("implicit", [False, True], ids=["dense", "implicit_k7"])
def test_multiview_with_voxel_masks_matches(models, banks, implicit):
    """Turbo multiview attention: the dense boolean masks, and the implicit
    (positions, radius) form, which the JAX side runs through the Pallas
    kernel in interpret mode and the port through K7's plain version."""
    pm = _position_maps()
    grids = (8, 4, 2)
    if implicit:
        masks = multi_resolution_positions(torch.from_numpy(pm), grids)
        jmasks = jax_implicit_masks(jnp.asarray(pm), grids)
    else:
        masks = multi_resolution_mask(torch.from_numpy(pm), grids)
        jmasks = jax_dense_masks(jnp.asarray(pm), grids)
    assert sorted(masks) == [8, 32, 128]
    got, want = _r_pass(models, banks, 1.0, masks, jmasks)
    close(got, want)
    unmasked, _ = _r_pass(models, banks, 1.0)
    assert not np.allclose(got.numpy(), unmasked.numpy(), atol=1e-3)


def _step_inputs(seed):
    rng = np.random.RandomState(seed)
    noisy = rng.randn(N_VIEWS, 8, 8, 4).astype(np.float32)
    ctrl = rng.randn(N_VIEWS, 8, 8, 8).astype(np.float32)
    ref = rng.randn(1, 8, 8, 4).astype(np.float32)
    noise = rng.randn(N_VIEWS, 8, 8, 4).astype(np.float32)
    return noisy, ctrl, ref, noise


def _port_args(tmv, noisy, ctrl, ref):
    c = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    return (c(noisy), c(ctrl), c(ref), tmv.text_gen.expand(N_VIEWS, -1, -1),
            tmv.text_ref, torch.arange(N_VIEWS) + 5)


def _jax_args(jmv, noisy, ctrl, ref):
    return (jmv.params["unet"], jnp.asarray(noisy), jnp.asarray(ctrl),
            jnp.asarray(ref), jnp.repeat(jnp.asarray(jmv.params["text_gen"]),
                                         N_VIEWS, 0),
            jnp.asarray(jmv.params["text_ref"]),
            jnp.arange(N_VIEWS, dtype=jnp.int32) + 5)


def test_euler_step_matches(models):
    tmv, jmv = models
    noisy, ctrl, ref, noise = _step_inputs(10)
    ts, sigmas = sd_sigmas(30)
    with jax.disable_jit():
        want = jmv._step(*_jax_args(jmv, noisy, ctrl, ref), float(ts[3]),
                         float(sigmas[3]), float(sigmas[4]), jnp.asarray(noise),
                         3.0)
    got = tmv.euler_step(*_port_args(tmv, noisy, ctrl, ref), float(ts[3]),
                         float(sigmas[3]), float(sigmas[4]),
                         torch.from_numpy(noise).permute(0, 3, 1, 2), 3.0)
    close(nhwc(got), want)


def test_lcm_step_matches(models):
    tmv, jmv = models
    noisy, ctrl, ref, noise = _step_inputs(11)
    ts, ac, ac_prev = lcm_schedule(8)
    with jax.disable_jit():
        wd, wx = jmv._lcm_step_fn(*_jax_args(jmv, noisy, ctrl, ref),
                                  float(ts[2]), float(ac[2]), float(ac_prev[2]),
                                  jnp.asarray(noise))
    gd, gx = tmv.lcm_step(*_port_args(tmv, noisy, ctrl, ref), float(ts[2]),
                          float(ac[2]), float(ac_prev[2]),
                          torch.from_numpy(noise).permute(0, 3, 1, 2))
    close(nhwc(gd), wd)
    close(nhwc(gx), wx)


def _renders(seed=12, res=64):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(N_VIEWS):
        mask = np.zeros((res, res), bool)
        mask[8:56, 10:50] = True
        nrm = rng.randn(res, res, 3).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
        pos = rng.uniform(-0.45, 0.45, (res, res, 3)).astype(np.float32)
        out.append({"mask": torch.from_numpy(mask),
                    "normal": torch.from_numpy(nrm * mask[..., None]),
                    "position": torch.from_numpy(pos * mask[..., None])})
    return out


@pytest.mark.parametrize("sampler", ["euler", "lcm"])
def test_generate_matches_the_jax_steps_fed_its_noise(models, sampler):
    """A whole ``generate`` (2 steps) against the JAX step functions driven
    in the same loop with the port's noise stream: one CPU generator seeded
    with ``seed``, the initial latents first, then one draw per step."""
    tmv, jmv = models
    renders = _renders()
    control = np.stack([np.concatenate([(r["normal"].numpy() + 1) / 2,
                                        r["position"].numpy() + 0.5], -1)
                        for r in renders])
    ref = np.random.RandomState(13).rand(64, 64, 3).astype(np.float32)
    got = tmv.generate(ref, control, num_steps=2, seed=7, sampler=sampler)

    gen = torch.Generator().manual_seed(7)
    randn = lambda: jnp.asarray(nhwc(torch.randn((N_VIEWS, 4, 8, 8),
                                                 generator=gen)).numpy())
    with jax.disable_jit():
        enc = lambda x: jmv._encode(jmv.params["vae"], jnp.asarray(x) * 2 - 1)
        ref_lat = enc(ref[None])
        ctrl = jnp.concatenate([enc(control[..., :3]), enc(control[..., 3:6])], -1)
        args = (jmv.params["unet"], None, ctrl, ref_lat,
                jnp.repeat(jnp.asarray(jmv.params["text_gen"]), N_VIEWS, 0),
                jnp.asarray(jmv.params["text_ref"]),
                jnp.arange(N_VIEWS, dtype=jnp.int32) + 5)
        step = lambda x: (args[0], x) + args[2:]
        if sampler == "lcm":
            ts, ac, ac_prev = lcm_schedule(2)
            x = randn()
            for i in range(2):
                d, x = jmv._lcm_step_fn(*step(x), float(ts[i]), float(ac[i]),
                                        float(ac_prev[i]), randn())
            x = d
        else:
            ts, sigmas = sd_sigmas(2)
            x = randn() * sigmas[0]
            for i in range(2):
                x = jmv._step(*step(x), float(ts[i]), float(sigmas[i]),
                              float(sigmas[i + 1]), randn(), 3.0)
        want = np.clip((np.asarray(jmv._decode(jmv.params["vae"], x)) + 1) / 2,
                       0, 1)
    close(got, want, rel=1e-4)


def test_jax_init_random_reads_a_stale_reference_bank():
    """A fault of the JAX package (ROADMAP.md, Queue 3): ``init_random``
    keeps the ``ref_bank`` collection that ``init`` sowed, so every later
    ``w`` pass appends to it and the ``r`` pass reads entry 0, the bank of
    the zero-input init trace at the init resolution, not the reference
    image's. The port's ``w`` pass returns the current bank only."""
    jmv = JaxMV.init_random(jax.random.PRNGKey(0), image_size=16,
                            context_dim=32, dtype=jnp.float32,
                            unet=JaxUNet(block_channels=(8, 8), context_dim=32,
                                         head_dim=8),
                            vae=JaxVAE(block_channels=(4, 4)))
    assert "ref_bank" in jmv.params["unet"]
    ref_in = _latents(14, 1, s=4)
    with jax.disable_jit():
        kv = _jax_bank(jmv, ref_in, np.zeros((1, 77, 32), np.float32))[
            "down_0_tf_0"]["block_0"]["kv"]
    assert len(kv) == 2 and kv[0].shape != kv[1].shape


def test_from_diffusers_matches_paint_params(models, tmp_path):
    """The released layout (``unet.``-prefixed, with the learned text
    embeddings inside the UNet state dict) loads to the same weights."""
    import test_sd_convert as sd
    tmv, jmv = models
    unet_sd = sd.synth_unet_sd({"params": jmv.params["unet"]["params"]},
                               prefix="unet.")
    unet_sd["unet.learned_text_clip_gen"] = np.asarray(jmv.params["text_gen"])[0]
    unet_sd["unet.learned_text_clip_ref"] = np.asarray(jmv.params["text_ref"])[0]
    vae_sd = sd.synth_vae_sd({"params": jmv.params["vae"]["params"]})
    t16 = lambda d: {k: torch.tensor(np.asarray(v, np.float32))
                     for k, v in d.items()}
    loaded = MultiviewDiffusion.from_diffusers(t16(unet_sd), t16(vae_sd),
                                               head_dim=8, dtype=torch.float32,
                                               device="cpu")
    for a, b in ((loaded.unet, tmv.unet), (loaded.vae, tmv.vae)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert torch.equal(loaded.text_gen, tmv.text_gen)
    assert torch.equal(loaded.text_ref, tmv.text_ref)


def test_paint_pipeline_with_tiny_diffusion_weights(models):
    """The port's PaintPipeline with the tiny model as its synthesizer, Euler
    and turbo: a finite texture, the atlas of the weight-free run and the
    same baked coverage (it depends on the geometry only)."""
    from test_torch_paint_render import sphere
    from motion324_tpu_torch.hy3dgen.paint_pipeline import PaintPipeline
    from motion324_tpu_torch.io.mesh import TriMesh
    tmv, _ = models
    verts, faces = sphere(10)
    image = np.random.RandomState(15).rand(70, 70, 3).astype(np.float32)
    mesh = TriMesh(vertices=verts, faces=faces)
    base = PaintPipeline(resolution=64, texture_size=64, device="cpu")
    want = base(mesh, image)
    runs = {"euler": lambda i, v, r: tmv(i, v, r),
            "turbo": lambda i, v, r: tmv(i, v, r, turbo=True, turbo_steps=2)}
    tmv_generate = tmv.generate
    calls = []
    tmv.generate = lambda *a, **k: calls.append(k) or tmv_generate(
        *a, **{**k, "num_steps": min(k.get("num_steps", 30), 2)})
    try:
        for name, synth in runs.items():
            p = PaintPipeline(multiview_model=synth, resolution=64,
                              texture_size=64, device="cpu")
            out = p(mesh, image)
            assert np.isfinite(out.texture).all() and out.texture.shape == (64, 64, 3)
            np.testing.assert_array_equal(out.uv, want.uv)
            assert p.last_run["baked"] == base.last_run["baked"]
    finally:
        tmv.generate = tmv_generate
    assert [c.get("sampler", "euler") for c in calls] == ["euler", "lcm"]
    assert sorted(calls[1]["mva_masks"]) == [384, 1536, 6144]


def test_generate_assets_texture_cli_on_the_cpu(tmp_path):
    """``--texture`` on one .npy image: the weight-free painter at tiny
    render and texture sizes, on a stand-in shape model's mesh; the GLB
    carries UVs and the texture (a PNG, written without PIL)."""
    from test_torch_paint_render import sphere
    from motion324_tpu_torch import generate_assets
    from motion324_tpu_torch.hy3dgen.paint_pipeline import PaintPipeline
    from motion324_tpu_torch.io.mesh import TriMesh
    verts, faces = sphere(10)
    shape = lambda image, **kw: TriMesh(vertices=verts, faces=faces)
    clip = tmp_path / "in" / "fox_processed" / "masked_rgb"
    clip.mkdir(parents=True)
    np.save(clip / "0000.npy",
            (np.random.RandomState(16).rand(40, 40, 3) * 255).astype(np.uint8))
    out = tmp_path / "out"
    rc = generate_assets.main(["--input-root", str(tmp_path / "in"), "--output",
                               str(out), "--texture", "--device", "cpu"],
                              pipeline=shape,
                              painter=PaintPipeline(resolution=48,
                                                    texture_size=64,
                                                    device="cpu"))
    assert rc == 0
    from motion324_tpu_torch.io.glb import load_glb
    got = load_glb(str(out / "fox.glb"))
    assert got["texture"].shape == (64, 64, 3) and got["uv"].shape[1] == 2
    assert len(got["faces"]) == len(faces)
