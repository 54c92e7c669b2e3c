"""The port's CUDA kernels (K1 flash and K2 head-folded forwards, with and
without the LSE output; K3 / K4 flash and K5 head-folded backwards) against
their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. This file imports
no JAX, so it also runs on a machine that has only PyTorch; there, skip the
JAX test configuration with ``--noconftest``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from motion324_tpu_torch.ops.attention import (mha_reference,
                                               multi_head_attention,
                                               select_route)
from motion324_tpu_torch.ops.flash_attention import (
    FlashAttentionFn, flash_attention, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_reference)
from motion324_tpu_torch.ops.folded_attention import (
    FoldedAttentionFn, folded_attention, folded_attention_bwd,
    folded_attention_bwd_reference, folded_attention_reference)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "and run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# max |kernel - plain| allowed, as a share of max |plain|. With randn q/k/v
# and scale 1/8 each output is a softmax average of about Sk/e values of v:
# mean |out| about 0.03-0.08 and max |out| 0.2-1 at these shapes. bf16: both
# versions round the output to bf16 and P to bf16 against another max
# (running against final), so they differ by an ulp or two of the largest
# outputs (2^-8 to 2^-7.5 of max |plain| on the H100); a kernel that drops
# or mis-weights KV tiles errs by about mean |out|. f32: the same math
# summed in another order (at most 2^-17 of max |plain| on the H100).
REL_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -14}


def assert_matches_plain(out, want, rel=None):
    err = (out.float() - want.float()).abs().max().item()
    tol = (rel or REL_TOL[want.dtype]) * want.float().abs().max().item()
    assert err <= tol, f"max |kernel - plain| {err:.3e} > {tol:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk", [(200, 300), (64, 2000), (324, 324)])
def test_cuda_flash_matches_plain(cuda, dtype, sq, sk):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 3, sq, 64, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, 3, sk, 64, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, 3, sk, 64, generator=g, device=cuda).to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert_matches_plain(out, flash_attention_reference(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk", [(257, 257), (324, 324), (200, 1000)])
def test_cuda_folded_matches_plain(cuda, dtype, sq, sk):
    """q/k/v are strided views of one fused projection, as the model
    hands them over; KV above 384 keys runs in resident segments."""
    g = torch.Generator(device=cuda).manual_seed(1)
    h = 4
    qkv = torch.randn(3, max(sq, sk), 3 * h * 64, generator=g,
                      device=cuda).to(dtype)
    q = qkv[:, :sq, :h * 64]
    k = qkv[:, :sk, h * 64:2 * h * 64]
    v = qkv[:, :sk, 2 * h * 64:]
    before = folded_attention.launches
    out = folded_attention(q, k, v, heads=h)
    torch.cuda.synchronize()
    assert folded_attention.launches == before + 1
    assert_matches_plain(out, folded_attention_reference(q, k, v, heads=h))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(324, 324), (972, 972), (64, 1500)])
def test_cuda_dispatcher_routes_to_the_kernels(cuda, sq, sk):
    """(B, S, H, D) through multi_head_attention: K2 for a frame, K1 for a
    3-frame window (the JAX package's K6 route) and for long KV."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(2, sq, 3, 64, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(2, sk, 3, 64, generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn(2, sk, 3, 64, generator=g, device=cuda).to(torch.bfloat16)
    counts = (flash_attention.launches, folded_attention.launches)
    out = multi_head_attention(q, k, v)
    torch.cuda.synchronize()
    flash_n = flash_attention.launches - counts[0]
    folded_n = folded_attention.launches - counts[1]
    want_route = select_route(sq, sk)
    assert (flash_n, folded_n) == ((1, 0) if want_route == "flash" else (0, 1))
    assert_matches_plain(out, mha_reference(q, k, v))


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 16, 32, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)            # head dim 32
    q = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)            # fp16
    x = torch.zeros(1, 16, 128, device=cuda)
    with pytest.raises(ValueError):         # rows not 16-byte aligned
        folded_attention(x[:, :, 1:65], x[:, :, :64], x[:, :, :64], heads=1)


# The backward kernels are held to the same shares of max |plain|. dq of K3
# and K5 is summed with f32 atomics, in an order that changes from run to
# run: in f32 that moves it by a few ulps of the sum, far inside 2^-14.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk", [(200, 300), (64, 4096), (300, 4200)],
                         ids=["k3_ragged", "k3_max_kv", "k4_ragged"])
def test_cuda_flash_bwd_matches_plain(cuda, dtype, sq, sk):
    g = torch.Generator(device=cuda).manual_seed(3)
    rnd = lambda *s, f=1.0: (torch.randn(*s, generator=g, device=cuda) * f).to(dtype)
    q, k, v = rnd(2, 3, sq, 64, f=0.125), rnd(2, 3, sk, 64), rnd(2, 3, sk, 64)
    o, lse = flash_attention_reference(q, k, v, scale=1.0, with_lse=True)
    do = rnd(2, 3, sq, 64)
    counts = (flash_attention_bwd.fused_launches,
              flash_attention_bwd.two_pass_launches)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    fused = sk <= 4096
    assert (flash_attention_bwd.fused_launches - counts[0],
            flash_attention_bwd.two_pass_launches - counts[1]) == \
        ((1, 0) if fused else (0, 1))
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, scale=1.0)
    for a, b in zip(got, want):
        assert_matches_plain(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_lse_forwards_match_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(2, 3, n, 64, generator=g, device=cuda).to(dtype)
               for n in (200, 1100, 1100))
    from motion324_tpu_torch.ops import flash_attention as fa
    from motion324_tpu_torch.ops import folded_attention as fo
    out, lse = fa._forward(q, k, v, 0.125, with_lse=True)
    want, wlse = flash_attention_reference(q, k, v, with_lse=True)
    assert_matches_plain(out, want)
    assert_matches_plain(lse, wlse, rel=REL_TOL[torch.float32])
    f = lambda x: x.transpose(1, 2).flatten(2)
    out, lse = fo._forward(f(q), f(k)[:, :300], f(v)[:, :300], 3, 0.125,
                           with_lse=True)
    want, wlse = folded_attention_reference(f(q), f(k)[:, :300], f(v)[:, :300],
                                            heads=3, with_lse=True)
    assert lse.shape == (2, 200, 3)
    assert_matches_plain(out, want)
    assert_matches_plain(lse, wlse, rel=REL_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_folded_bwd_matches_plain(cuda, dtype):
    """q/k/v as strided views of one fused projection; dq/dk/dv contiguous."""
    g = torch.Generator(device=cuda).manual_seed(5)
    h = 4
    qkv = torch.randn(3, 324, 3 * h * 64, generator=g, device=cuda).to(dtype)
    q = (qkv[:, :, :h * 64] * 0.125).to(dtype)
    k, v = qkv[:, :, h * 64:2 * h * 64], qkv[:, :, 2 * h * 64:]
    o, lse = folded_attention_reference(q, k, v, heads=h, scale=1.0,
                                        with_lse=True)
    do = torch.randn(o.shape, generator=g, device=cuda).to(dtype)
    before = folded_attention_bwd.launches
    got = folded_attention_bwd(q, k, v, o, lse, do, heads=h)
    torch.cuda.synchronize()
    assert folded_attention_bwd.launches == before + 1
    want = folded_attention_bwd_reference(q, k, v, o, lse, do, heads=h, scale=1.0)
    for a, b in zip(got, want):
        assert a.is_contiguous()
        assert_matches_plain(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(150, 1100), (324, 324)])
def test_cuda_attention_carries_gradients(cuda, sq, sk):
    """On CUDA, attention that needs grad returns an output with a grad_fn
    (K1 / K2 with the LSE, then K3 / K5), and the gradients reaching q, k
    and v match those of the plain path."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(2, n, 3, 64, generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_() for n in (sq, sk, sk))
    out = multi_head_attention(q, k, v)
    fn = FlashAttentionFn if select_route(sq, sk) == "flash" else FoldedAttentionFn
    assert isinstance(out.grad_fn, fn._backward_cls), type(out.grad_fn)
    do = torch.randn(out.shape, generator=g, device=cuda).to(torch.bfloat16)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(multi_head_attention(q, k, v, backend="plain"),
                               (q, k, v), do)
    for a, b in zip(got, want):
        assert_matches_plain(a, b)
