"""The Hunyuan3D-2.0 DiT's fused norm, modulation, gate and GELU + concat
passes (``ops/dit_fused.py``, ``csrc/dit_fused.cu``).

On the CPU, at tiny widths: each wrapper computes its plain version, which
equals the expression the DiT computed before bit for bit (written out
here as it was), on the layouts the DiT hands over (q and k as views of a
qkv output, the (B, 1, C) modulation rows as chunks of their linear's
output, the MLP half as a view of ``linear1``'s output), in f32 and bf16; a
tiny ``Hunyuan3DDiT`` forward equals the former forward bit for bit, and
no launch is counted. On the card (``-m cuda``): each kernel against its
plain version at the release DiT's sites, bf16 and f32 (the gate and the
GELU + concat bit for bit, the two norms within one ulp of bf16, with the
share off by one printed and bounded); one release-width DiT forward
counts 128 / 97 / 96 / 32 launches; and the perfbench fault that ignores
the QK-norm scale (a patch of ``_RMSNorm.forward``) changes the card's
output.

This file imports no JAX. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_dit_fused.py -s
"""

import pytest
import torch
import torch.nn.functional as F

from motion324_tpu_torch.hy3dgen import dit
from motion324_tpu_torch.hy3dgen.dit import Hunyuan3DDiT, timestep_embedding
from motion324_tpu_torch.ops import dit_fused
from motion324_tpu_torch.ops.dit_fused import (dit_gate, dit_gelu_cat,
                                               dit_modulate, dit_rmsnorm)
from dit_sites import (SITES, bf16_ulps, family, norm_and_factor,
                       past_one_ulp, site_inputs, without_factor)

WRAPPERS = (dit_rmsnorm, dit_modulate, dit_gate, dit_gelu_cat)
DTYPES = [torch.float32, torch.bfloat16]


# ------------------------------------------ the former expressions ----- #
def former_rmsnorm(x, scale):
    xf = x.float()
    out = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
    return out.to(x.dtype) * scale.to(x.dtype)


def former_norm(x):
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def former_modulate(x, shift, scale):
    return (1 + scale) * former_norm(x) + shift


def former_gelu_cat(attn, mlp):
    return torch.cat([attn, F.gelu(mlp, approximate="tanh")], dim=-1)


def former_qkv_heads(attn, x):
    b, l, c = x.shape
    q, k, v = (t.reshape(b, l, attn.num_heads, c // attn.num_heads)
               for t in attn.qkv(x).chunk(3, dim=-1))
    return (former_rmsnorm(q, attn.norm.query_norm.scale),
            former_rmsnorm(k, attn.norm.key_norm.scale), v)


def former_double(blk, img, txt, vec):
    (im1_shift, im1_scale, im1_gate), (im2_shift, im2_scale, im2_gate) = \
        blk.img_mod(vec)
    (tx1_shift, tx1_scale, tx1_gate), (tx2_shift, tx2_scale, tx2_gate) = \
        blk.txt_mod(vec)
    iq, ik, iv = former_qkv_heads(blk.img_attn,
                                  former_modulate(img, im1_shift, im1_scale))
    tq, tk, tv = former_qkv_heads(blk.txt_attn,
                                  former_modulate(txt, tx1_shift, tx1_scale))
    attn = dit.multi_head_attention(torch.cat([tq, iq], 1),
                                    torch.cat([tk, ik], 1),
                                    torch.cat([tv, iv], 1),
                                    backend=blk.attn_backend)
    attn = attn.reshape(*attn.shape[:2], -1)
    lt = txt.shape[1]
    txt_attn, img_attn = attn[:, :lt], attn[:, lt:]
    img = img + im1_gate * blk.img_attn.proj(img_attn)
    img = img + im2_gate * blk.img_mlp(former_modulate(img, im2_shift,
                                                       im2_scale))
    txt = txt + tx1_gate * blk.txt_attn.proj(txt_attn)
    txt = txt + tx2_gate * blk.txt_mlp(former_modulate(txt, tx2_shift,
                                                       tx2_scale))
    return img, txt


def former_single(blk, x, vec):
    b, l, _ = x.shape
    hd = blk.dim // blk.num_heads
    (shift, scale, gate), _ = blk.modulation(vec)
    qkv, mlp = blk.linear1(former_modulate(x, shift, scale)).split(
        [3 * blk.dim, blk.mlp_dim], dim=-1)
    q, k, v = (t.reshape(b, l, blk.num_heads, hd) for t in qkv.chunk(3, dim=-1))
    attn = dit.multi_head_attention(
        former_rmsnorm(q, blk.norm.query_norm.scale),
        former_rmsnorm(k, blk.norm.key_norm.scale), v,
        backend=blk.attn_backend)
    out = blk.linear2(former_gelu_cat(attn.reshape(b, l, blk.dim), mlp))
    return x + gate * out


def former_forward(model, x, t, cond):
    dtype = model.dtype
    latent = model.latent_in(x.to(dtype))
    vec = model.time_in(timestep_embedding(
        t, 256, max_period=model.time_factor, time_factor=1000.0).to(dtype))
    cond = model.cond_in(cond.to(dtype))
    for blk in model.double_blocks:
        latent, cond = former_double(blk, latent, cond, vec)
    merged = torch.cat([cond, latent], dim=1)
    for blk in model.single_blocks:
        merged = former_single(blk, merged, vec)
    latent = merged[:, cond.shape[1]:]
    shift, scale = model.final_layer.adaLN_modulation(vec)[:, None, :].chunk(
        2, dim=-1)
    return model.final_layer.linear(former_modulate(latent, shift, scale)).float()


FORMER = {"rmsnorm": former_rmsnorm, "modulate": former_modulate,
          "gate": lambda x, g, y: x + g * y, "gelu_cat": former_gelu_cat}
WRAPPER = {"rmsnorm": dit_rmsnorm, "modulate": dit_modulate,
           "gate": dit_gate, "gelu_cat": dit_gelu_cat}
KINDS = ["rmsnorm", "rmsnorm_single", "modulate", "modulate_last", "gate",
         "gelu_cat"]


def launches() -> tuple:
    return tuple(w.launches for w in WRAPPERS)


# ------------------------------------------------------------- CPU ---- #
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_equal_the_former_expressions(kind, dtype):
    """On a CPU tensor each wrapper is its plain version, which equals the
    former expression bit for bit on the DiT's own layouts; no launch is
    counted."""
    args = site_inputs(kind, 2, 5, 32, 4, 48, dtype, "cpu", seed=len(kind))
    before = launches()
    fam = family(kind)
    got = WRAPPER[fam](*args)
    want = FORMER[fam](*args)
    plain = getattr(dit_fused, f"dit_{fam}_reference")(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want) and torch.equal(plain, want)
    assert launches() == before


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_tiny_dit_forward_equals_the_former_forward(dtype):
    """A tiny ``Hunyuan3DDiT`` (2 double and 2 single blocks, width 32, 4
    heads, norm scales drawn away from 1) computes the former forward bit
    for bit on the CPU, and counts no launch."""
    torch.manual_seed(0)
    model = Hunyuan3DDiT(in_channels=8, context_in_dim=24, hidden_size=32,
                         num_heads=4, depth=2, depth_single_blocks=2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.uniform_(0.5, 1.5)
    model.to(dtype).eval()
    x, cond = torch.randn(2, 16, 8), torch.randn(2, 6, 24)
    t = torch.tensor([0.3, 0.7])
    before = launches()
    with torch.inference_mode():
        got = model(x, t, cond)
        want = former_forward(model, x, t, cond)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.equal(got, want)
    assert launches() == before


# ------------------------------------------------------------ card ---- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the two norms sum their statistics in another order than PyTorch: in bf16
# the norm may differ by one ulp, or where LayerNorm's centering cancels by
# the f32 mean's rounding (2^-16 of a unit-variance value), on at most this
# share of the elements; in f32 by 2^-20 of max |plain| (8 ulps of the
# largest value)
OFF_BY_ONE_SHARE = 1e-3
F32_NORM_TOL = 2.0 ** -20


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,site,l", SITES,
                         ids=[f"{k}_{n}" for k, _, n in SITES])
def test_cuda_kernel_matches_its_plain_version(cuda, kind, site, l, dtype):
    """The gate and the GELU + concat bit for bit. The norms in bf16: the
    norm alone within one ulp (:func:`past_one_ulp`), on at most
    ``OFF_BY_ONE_SHARE`` of the elements; at the site that ulp carried
    through the scale and the roundings after it (near the shift's
    cancellation it is many ulps of the output). In f32 within
    ``F32_NORM_TOL`` of max |plain|."""
    args = site_inputs(kind, 2, l, 1024, 16, 4096, dtype, cuda, seed=l)
    fam = family(kind)
    wrapper = WRAPPER[fam]
    before = wrapper.launches
    with torch.inference_mode():
        got = wrapper(*args)
        want = FORMER[fam](*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
    if fam in ("gate", "gelu_cat"):
        assert torch.equal(got, want)
    elif dtype == torch.bfloat16:
        with torch.inference_mode():
            alone = without_factor(fam, args)
            n_got, n_want = wrapper(*alone), FORMER[fam](*alone)
            norm, factor = norm_and_factor(fam, args)
        share = (n_got != n_want).float().mean().item()
        alone_over = past_one_ulp(n_got, n_want)
        over = past_one_ulp(got, want, factor, norm)
        print(f"{kind} L={l}: the norm differs on {share:.3e} of the elements "
              f"(max {bf16_ulps(n_got, n_want).max().item()} ulps, {alone_over} "
              f"past one); at the site {(got != want).float().mean().item():.3e} "
              f"differ, {over} past one carried ulp")
        assert alone_over == 0 and share <= OFF_BY_ONE_SHARE and over == 0
    else:
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        print(f"{kind} L={l} f32: max |d| {err:.3e} = {err / top:.3e} of max |plain|")
        assert err <= F32_NORM_TOL * top


@pytest.mark.cuda
def test_cuda_tiny_rows_match(cuda):
    """Rows shorter than a warp of vectors (head dim 16, widths 40 and 24,
    an MLP half of 40), whose groups leave lanes idle, against the plain
    versions: the norms alone within one bf16 ulp, the gate and the concat
    bit for bit."""
    with torch.inference_mode():
        for dtype in DTYPES:
            args = without_factor("rmsnorm", site_inputs(
                "rmsnorm", 2, 33, 48, 3, 0, dtype, cuda))
            assert past_one_ulp(dit_rmsnorm(*args).bfloat16(),
                                former_rmsnorm(*args).bfloat16()) == 0
            args = without_factor("modulate", site_inputs(
                "modulate_last", 2, 33, 40, 5, 0, dtype, cuda))
            assert past_one_ulp(dit_modulate(*args).bfloat16(),
                                former_modulate(*args).bfloat16()) == 0
            x, g, y = site_inputs("gate", 2, 9, 24, 3, 0, dtype, cuda)
            assert torch.equal(dit_gate(x, g, y), x + g * y)
            a, mlp = site_inputs("gelu_cat", 2, 9, 16, 2, 40, dtype, cuda)
            assert torch.equal(dit_gelu_cat(a, mlp), former_gelu_cat(a, mlp))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_they_lack(cuda):
    x = torch.randn(2, 8, 64, device=cuda)
    row = torch.randn(2, 1, 64, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dit_gate(x.half(), row.half(), x.half())
    with pytest.raises(TypeError, match="one dtype"):
        dit_gate(x, row.bfloat16(), x)
    with pytest.raises(ValueError, match="unit last stride"):
        dit_modulate(x.transpose(1, 2), row, row)
    with pytest.raises(RuntimeError, match="no backward"):
        dit_gate(x.requires_grad_(), row, x)
    with pytest.raises(RuntimeError, match="launch failed"):
        # a head dim past what a group of lanes holds in registers
        dit_rmsnorm(torch.randn(1, 2, 1, 4096, device=cuda),
                    torch.ones(4096, device=cuda))
    # what 16-byte vectors do not fit: a misaligned base, a head dim of 12
    # bf16, an f32 width of 42, a row stride of 66 bf16
    x = torch.randn(2, 8, 65, device=cuda)[..., 1:]
    with pytest.raises(ValueError, match="16-byte vectors"):
        dit_modulate(x, row, row)
    with pytest.raises(ValueError, match="16-byte vectors"):
        dit_rmsnorm(torch.randn(2, 8, 4, 12, device=cuda).bfloat16(),
                    torch.ones(12, device=cuda).bfloat16())
    x, row = torch.randn(2, 8, 42, device=cuda), torch.randn(2, 1, 42, device=cuda)
    with pytest.raises(ValueError, match="16-byte vectors"):
        dit_gate(x, row, x)
    a = torch.randn(2, 8, 66, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="16-byte vectors"):
        dit_gelu_cat(a[..., :32], a[..., 32:64])


def release_dit(device) -> Hunyuan3DDiT:
    """The release DiT (width 1 024, 16 heads, 16 + 32 blocks) in bf16,
    its weights drawn as the benchmark draws them (lecun-normal matrices,
    biases N(0, 0.1), norm scales U(0.5, 1.5))."""
    from perfbench.lib import weights
    with torch.device(device):
        model = Hunyuan3DDiT().to(torch.bfloat16)
    model.load_state_dict(weights.draw(Hunyuan3DDiT, 0, device))
    return model.eval()


@pytest.mark.cuda
def test_cuda_release_dit_forward_counts_and_faults(cuda):
    """One forward of the release-width DiT at batch 2 counts 128 / 97 / 96
    / 32 launches. Against the former forward in f32 (the same weights, the
    fused passes nowhere), the fused bf16 forward is as close as the former
    bf16 forward, within 25%: the one-ulp norms leave bf16's own rounding
    noise as it was. The perfbench fault that ignores the QK-norm scale, a
    patch of ``_RMSNorm.forward``, reaches the card's path and moves the
    output more than twice that noise."""
    import copy
    model = release_dit(cuda)
    gen = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(2, 512, 64, generator=gen, device=cuda)
    cond = torch.randn(2, 160, 1536, generator=gen, device=cuda)
    t = torch.tensor([0.4, 0.4], device=cuda)
    with torch.inference_mode():
        ref = former_forward(copy.deepcopy(model).float(), x, t, cond)
        before = launches()
        out = model(x, t, cond)
        counted = tuple(a - b for a, b in zip(launches(), before))
        former = former_forward(model, x, t, cond)
        real = dit._RMSNorm.forward

        def no_qk_scale(self, h):
            hf = h.float()
            return (hf * torch.rsqrt(hf.pow(2).mean(-1, keepdim=True)
                                     + 1e-6)).to(h.dtype)
        dit._RMSNorm.forward = no_qk_scale
        try:
            faulty = model(x, t, cond)
        finally:
            dit._RMSNorm.forward = real
    assert counted == (128, 97, 96, 32)
    rel = lambda a: ((a - ref).norm() / ref.norm()).item()
    print(f"release DiT forward against the former forward in f32: fused "
          f"{rel(out):.3e}, former bf16 {rel(former):.3e}, with the QK-norm "
          f"scale ignored {rel(faulty):.3e}")
    assert torch.isfinite(out).all()
    assert rel(out) <= 1.25 * rel(former)
    assert rel(faulty) > 2 * rel(former)
