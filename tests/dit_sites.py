"""The Hunyuan3D-2.0 DiT's call sites of the fused passes
(``ops/dit_fused.py``), their inputs as the DiT lays them out, and the
one-ulp bounds the two norms are held to. Shared by
``tests/test_torch_dit_fused.py`` and ``chip_smoke.py``.

Imports torch and nothing of the repo's packages."""

import torch
import torch.nn.functional as F

# the release DiT's sites at batch 2 (CFG) over the shape cell's 3 072
# latents and 1 369 condition tokens: (kind, site, L); width 1 024, 16
# heads of 64, MLP 4 096
RELEASE = dict(b=2, c=1024, heads=16, m=4096)
SITES = [("rmsnorm", "double img", 3072), ("rmsnorm", "double txt", 1369),
         ("rmsnorm_single", "single", 4441),
         ("modulate", "double img", 3072), ("modulate", "double txt", 1369),
         ("modulate", "single", 4441), ("modulate_last", "last layer", 3072),
         ("gate", "double img", 3072), ("gate", "double txt", 1369),
         ("gate", "single", 4441), ("gelu_cat", "single", 4441)]


def family(kind: str) -> str:
    """The wrapper of a site's kind: ``dit_<family>``."""
    return kind.split("_")[0] if kind != "gelu_cat" else kind


def site_inputs(kind: str, b: int, l: int, c: int, heads: int, m: int,
                dtype, device, seed: int = 0) -> tuple:
    """The inputs of one call as the DiT lays them out: q as a view of a
    (B, L, 3C) qkv output (``"rmsnorm"``) or of linear1's (B, L, 3C + M)
    output (``"rmsnorm_single"``); x and the (B, 1, C) shift and scale,
    chunks of a (B, 6C) modulation (``"modulate"``; ``"modulate_last"``: x
    the latent slice of a merged stream, the rows chunks of a (B, 2C)
    output); x, the gate row and y (``"gate"``); the attention output and
    linear1's MLP half (``"gelu_cat"``)."""
    gen = torch.Generator(device).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, device=device)
    if kind.startswith("rmsnorm"):
        width = 3 * c + (m if kind == "rmsnorm_single" else 0)
        out = (randn(b, l, width) * 1.5 + 0.2).to(dtype)
        q = out[..., :c].reshape(b, l, heads, c // heads)
        scale = (torch.rand(c // heads, generator=gen, device=device)
                 + 0.5).to(dtype)
        return q, scale
    if kind.startswith("modulate"):
        if kind == "modulate_last":
            x = (randn(b, 77 + l, c) * 2 + 0.5).to(dtype)[:, 77:]
            mod = randn(b, 2 * c).to(dtype)[:, None, :].chunk(2, dim=-1)
        else:
            x = (randn(b, l, c) * 2 + 0.5).to(dtype)
            mod = randn(b, 6 * c).to(dtype)[:, None, :].chunk(6, dim=-1)
        return x, mod[0], mod[1]
    if kind == "gate":
        gate = randn(b, 6 * c).to(dtype)[:, None, :].chunk(6, dim=-1)[2]
        return randn(b, l, c).to(dtype), gate, randn(b, l, c).to(dtype)
    lin1 = (randn(b, l, 3 * c + m) * 2).to(dtype)
    return randn(b, l, c).to(dtype), lin1[..., 3 * c:]


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The distance in bf16 ulps between two bf16 tensors, elementwise (+0
    and -0 one value)."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def past_one_ulp(got, want, factor=None, norm=None) -> int:
    """The elements of bf16 ``got`` farther from ``want`` than one ulp of
    the norm (or 2^-16) carried through ``factor`` and the roundings after
    it: 2^-6 |factor * norm| + 2^-16 |factor| + 2^-7 |want| (2^-7 |want| +
    2^-16 for the norm alone)."""
    w = want.float()
    if factor is None:
        bound = 2.0 ** -7 * w.abs() + 2.0 ** -16
    else:
        f = factor.float()
        bound = (2.0 ** -6 * (f * norm.float()).abs() + 2.0 ** -16 * f.abs()
                 + 2.0 ** -7 * w.abs())
    return int(((got.float() - w).abs() > bound).sum().item())


def norm_and_factor(fam: str, args) -> tuple:
    """The plain route's norm, rounded as it stores it, and the factor that
    multiplies it: the scale (RMSNorm), 1 + scale (modulation)."""
    if fam == "rmsnorm":
        x, scale = args
        xf = x.float()
        norm = (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)
                ).to(x.dtype)
        return norm, scale.to(x.dtype)
    x, _, scale = args
    return F.layer_norm(x, x.shape[-1:], eps=1e-6), 1 + scale


def without_factor(fam: str, args) -> tuple:
    """The call's inputs with a unit scale or no modulation, so that its
    output is the norm itself."""
    if fam == "rmsnorm":
        return args[0], torch.ones_like(args[1])
    return args[0], torch.zeros_like(args[1]), torch.zeros_like(args[2])
