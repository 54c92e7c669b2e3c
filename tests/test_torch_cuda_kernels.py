"""The port's CUDA kernels (K1 flash, K6 single-KV and K2 head-folded
forwards, with and without the LSE output; K3 / K4 flash and K5 head-folded
backwards; K7 voxel-masked flash attention; K8 the rasterizer; K9 short
attention forward and backward) against their plain PyTorch versions, on
the card; the video-only path (``video_only.run``) launching K1, K2, K6
and K8; K1 at the sequence-parallel shape (a rank's half of the queries
over all the keys) and a data-parallel step on a one-rank NCCL group.

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
    _forward, flash_attention_bwd_reference, flash_attention_reference,
    single_kv_route)
from motion324_tpu_torch.ops.folded_attention import (
    FoldedAttentionFn, folded_attention, folded_attention_bwd,
    folded_attention_bwd_reference, folded_attention_reference)
from motion324_tpu_torch.ops.masked_attention import (
    masked_attention_reference, masked_flash_attention)
from motion324_tpu_torch.ops.rasterizer import (
    bin_faces, raster_kernel, raster_reference, rasterize)
from motion324_tpu_torch.ops import short_attention as sa
from raster_meshes import sliver_mesh


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


def _bhsd(g, cuda, dtype, b, h, s, strided, scale=1.0):
    """(B, H, S, 64) randn: contiguous, or the transposed view of a
    (B, S, H, 64) tensor, as the dispatcher hands K1 and K9 their inputs."""
    if strided:
        x = torch.randn(b, s, h, 64, generator=g, device=cuda) * scale
        return x.to(dtype).transpose(1, 2)
    return (torch.randn(b, h, s, 64, generator=g, device=cuda) * scale).to(dtype)


# K1 at a KV length of the 257-384 band that K6 leaves to it, a split call
# (64 queries x 16 384 keys: 16 splits), and the ragged 1 000 x 1 296 row;
# each with contiguous and with (B, S, H, 64)-strided inputs
@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True], ids=["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk", [(200, 300), (64, 2000), (324, 324),
                                   (300, 300), (64, 16384), (1000, 1296)])
def test_cuda_flash_matches_plain(cuda, dtype, sq, sk, strided):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = _bhsd(g, cuda, dtype, 2, 3, sq, strided)
    k = _bhsd(g, cuda, dtype, 2, 3, sk, strided)
    v = _bhsd(g, cuda, dtype, 2, 3, sk, strided)
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
    hands them over."""
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
    """(B, S, H, D) through multi_head_attention: K2 for a frame, K6 for a
    3-frame window (its KV fits one block) and K1 for long KV."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(2, sq, 3, 64, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(2, sk, 3, 64, generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn(2, sk, 3, 64, generator=g, device=cuda).to(torch.bfloat16)
    counts = (flash_attention.launches, flash_attention.single_kv_launches,
              folded_attention.launches)
    out = multi_head_attention(q, k, v)
    torch.cuda.synchronize()
    got = (flash_attention.launches - counts[0],
           flash_attention.single_kv_launches - counts[1],
           folded_attention.launches - counts[2])
    want = {"folded": (0, 0, 1), "plain": (0, 0, 0)}.get(
        select_route(sq, sk), (0, 1, 0) if single_kv_route(sk) else (1, 0, 0))
    assert got == want
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
# (bulk reduce-adds in bf16, atomics in f32) is summed in an order that
# changes from run to run: in f32 that moves it by a few ulps of the sum,
# far inside 2^-14. The rows cover K3 and K4 at the edges of
# their 64- and 128-row tiles and K4's split dq pass.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk", [
    (200, 300), (64, 4096), (300, 4200),
    (64, 127), (65, 128), (1000, 129), (65, 4096), (1000, 4096),
    (64, 4097), (65, 4097), (1000, 4097), (64, 16384)],
    ids=["k3_ragged", "k3_max_kv", "k4_ragged",
         "k3_64x127", "k3_65x128", "k3_1000x129", "k3_65x4096",
         "k3_1000x4096", "k4_64x4097", "k4_65x4097", "k4_1000x4097",
         "k4_split_64x16384"])
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


# K4 adds no atomics: its dq pass writes f32 partials per key range (split
# by split_count(Sq, Sk), never by the batch) and the tile's last block adds
# them in split order, so a call repeats bit for bit and slice 0 of a B = 4
# call has the bits of the same slice alone, split and unsplit.
@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(64, 16384), (1000, 4200)],
                         ids=["split", "unsplit"])
def test_cuda_k4_repeats_bit_for_bit(cuda, sq, sk):
    from motion324_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(9)
    rnd = lambda *s, f=1.0: (torch.randn(*s, generator=g, device=cuda) * f).to(
        torch.bfloat16)
    q, k, v = rnd(4, 3, sq, 64, f=0.125), rnd(4, 3, sk, 64), rnd(4, 3, sk, 64)
    o, lse = flash_attention_reference(q, k, v, scale=1.0, with_lse=True)
    do = rnd(4, 3, sq, 64)
    four = flash_attention_bwd(q, k, v, o, lse, do)
    again = flash_attention_bwd(q, k, v, o, lse, do)
    one = flash_attention_bwd(q[:1].clone(), k[:1].clone(), v[:1].clone(),
                              o[:1].clone(), lse[:3].clone(), do[:1].clone())
    torch.cuda.synchronize()
    assert (fa.split_count(sq, sk) > 1) == (sq == 64)
    for a, a2, b in zip(four, again, one):
        assert torch.equal(a, a2)
        assert torch.equal(a[:1], b)
    assert not any(t.any().item() for t in fa._TICKETS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True], ids=["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk", [(200, 1100), (64, 4096), (1000, 1296)])
def test_cuda_lse_forwards_match_plain(cuda, dtype, sq, sk, strided):
    """K1 with the LSE (64 x 4 096, the training shape encoder, is split
    in bf16: its LSE comes from the combine), then K2 with the LSE."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (_bhsd(g, cuda, dtype, 2, 3, n, strided) for n in (sq, sk, sk))
    from motion324_tpu_torch.ops import flash_attention as fa
    from motion324_tpu_torch.ops import folded_attention as fo
    out, lse = fa._forward(q, k, v, 0.125, with_lse=True)
    want, wlse = flash_attention_reference(q, k, v, with_lse=True)
    assert_matches_plain(out, want)
    assert_matches_plain(lse, wlse, rel=REL_TOL[torch.float32])
    q, k, v = (_bhsd(g, cuda, dtype, 2, 3, n, strided) for n in (200, 300, 300))
    f = lambda x: x.transpose(1, 2).flatten(2)
    out, lse = fo._forward(f(q), f(k), f(v), 3, 0.125, with_lse=True)
    want, wlse = folded_attention_reference(f(q), f(k), f(v), heads=3,
                                            with_lse=True)
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
@pytest.mark.parametrize("sq,sk", [(150, 1100), (324, 324), (64, 4200)])
def test_cuda_attention_carries_gradients(cuda, sq, sk):
    """On CUDA, attention that needs grad returns an output with a grad_fn
    (K1 / K2 with the LSE, then K3 / K4 / K5), and the gradients reaching q,
    k and v match those of the plain path. K1's LSE at 150 x 1 100 and
    64 x 4 200 comes from its split path and feeds K3 and K4."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(2, n, 3, 64, generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_() for n in (sq, sk, sk))
    out = multi_head_attention(q, k, v)
    fn = FlashAttentionFn if select_route(sq, sk) == "flash" else FoldedAttentionFn
    # the dispatcher reshapes or transposes the Function's output: search
    # the graph below the output for the Function's node
    nodes, seen = [out.grad_fn], []
    while nodes:
        node = nodes.pop()
        seen.append(type(node))
        nodes += [n for n, _ in node.next_functions if n is not None]
    assert fn._backward_cls in seen, seen
    do = torch.randn(out.shape, generator=g, device=cuda).to(torch.bfloat16)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(multi_head_attention(q, k, v, backend="plain"),
                               (q, k, v), do)
    for a, b in zip(got, want):
        assert_matches_plain(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k1_split", "k1_split_lse", "k1_global",
                                  "k1_global_lse", "k2_324", "k2_257"])
def test_cuda_slices_do_not_depend_on_the_batch(cuda, case):
    """Slice 0 of a B = 4 call has the bits of the same slice alone, and a
    call repeats bit for bit: K1 (split at 64 x 16 384 and 64 x 4 096 with
    the LSE, unsplit at 1 000 x 1 300) and K2 (324 and 257 tokens), through
    the dispatcher's (B, S, H, 64) layout; the LSE forward on (B, H, S, 64)."""
    from motion324_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(8)
    sq, sk, b1 = {"k1_split": (64, 16384, 1), "k1_split_lse": (64, 4096, 1),
                  "k1_global": (1000, 1300, 1), "k1_global_lse": (1000, 1300, 1),
                  "k2_324": (324, 324, 3), "k2_257": (257, 257, 3)}[case]
    q, k, v = (torch.randn(4 * b1, n, 3, 64, generator=g, device=cuda)
               .to(torch.bfloat16) for n in (sq, sk, sk))
    if case.endswith("_lse"):
        def run(x, y, z):
            hf = lambda t: t.transpose(1, 2).contiguous()
            return fa._forward(hf(x) * 0.125, hf(y), hf(z), 1.0, with_lse=True)
    else:
        run = lambda x, y, z: (multi_head_attention(x, y, z),)
    four, again = run(q, k, v), run(q, k, v)
    one = run(q[:b1].clone(), k[:b1].clone(), v[:b1].clone())
    torch.cuda.synchronize()
    for a, a2, o in zip(four, again, one):
        assert torch.equal(a, a2)
        assert torch.equal(a[: o.shape[0]], o)
    # a split call leaves its tickets zeroed for the next call
    assert not any(t.any().item() for t in fa._TICKETS.values())


# K2 at its call sites (local frames, DINOv2, the ShapeVAE, the UNet's 16^2
# level and mid block), a ragged row and one query tile over 4 096 keys,
# whose bf16 keys are split (short_split_count; the partial results
# combined into the heads-last output and LSE), with and without the LSE,
# on fused-QKV views; the LSE (B, Sq, H) as K5 reads it
@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True], ids=["out", "lse"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,sq,sk", [(12, 12, 324, 324), (12, 12, 257, 257),
                                       (1, 16, 512, 512), (6, 20, 256, 256),
                                       (1, 20, 384, 384), (2, 12, 200, 1000),
                                       (2, 12, 64, 4096)],
                         ids=["local", "dino", "vae", "unet_16", "unet_mv_384",
                              "ragged", "split"])
def test_cuda_folded_at_its_sites(cuda, dtype, with_lse, b, h, sq, sk):
    from motion324_tpu_torch.ops import folded_attention as fo
    from motion324_tpu_torch.ops.short_attention import short_split_count
    if sk == 4096:
        assert short_split_count(sq, sk) > 1
    g = torch.Generator(device=cuda).manual_seed(17)
    q, k, v = _fused_qkv(g, cuda, dtype, b, h, sq, sk)
    counter = "lse_launches" if with_lse else "launches"
    before = getattr(folded_attention, counter)
    out, lse = fo._forward(q, k, v, h, 1.0, with_lse=with_lse)
    torch.cuda.synchronize()
    assert getattr(folded_attention, counter) == before + 1
    assert out.shape == q.shape and out.is_contiguous()
    want = folded_attention_reference(q, k, v, heads=h, scale=1.0,
                                      with_lse=True)
    assert_matches_plain(out, want[0])
    if with_lse:
        assert lse.shape == (b, sq, h) and lse.is_contiguous()
        assert_matches_plain(lse, want[1])


# K2 with the LSE: slice 0 of a B = 4 call has the bits of the same image
# alone, and a call repeats bit for bit (the local rows are never split)
@pytest.mark.cuda
@pytest.mark.parametrize("sq", [324, 257])
def test_cuda_folded_lse_slices_do_not_depend_on_the_batch(cuda, sq):
    from motion324_tpu_torch.ops import folded_attention as fo
    g = torch.Generator(device=cuda).manual_seed(18)
    h = 12
    q, k, v = _fused_qkv(g, cuda, torch.bfloat16, 4, h, sq, sq)
    four = fo._forward(q, k, v, h, 1.0, with_lse=True)
    again = fo._forward(q, k, v, h, 1.0, with_lse=True)
    one = fo._forward(q[:1], k[:1], v[:1], h, 1.0, with_lse=True)
    torch.cuda.synchronize()
    for a, a2, o in zip(four, again, one):
        assert torch.equal(a, a2)
        assert torch.equal(a[:1], o)


# K6 computes exactly the plain version's function (one max over all keys,
# P rounded against it), so only the order of its f32 sums differs: it is
# held to the same shares of max |plain| as K1, and lands further inside.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk", [(200, 200), (1000, 385), (130, 512),
                                   (64, 1000), (70, 1024)])
def test_cuda_single_kv_matches_plain(cuda, dtype, sq, sk):
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(2, 3, sq, 64, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, 3, sk, 64, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, 3, sk, 64, generator=g, device=cuda).to(dtype)
    assert single_kv_route(sk)
    before = (flash_attention.launches, flash_attention.single_kv_launches,
              flash_attention.single_kv_lse_launches)
    out = flash_attention(q, k, v)
    qs = q * 0.125
    out_lse, lse = _forward(qs, k, v, 1.0, with_lse=True)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.single_kv_launches,
            flash_attention.single_kv_lse_launches) == (
                before[0], before[1] + 1, before[2] + 1)
    want, want_lse = flash_attention_reference(qs, k, v, scale=1.0,
                                               with_lse=True)
    assert_matches_plain(out, flash_attention_reference(q, k, v))
    assert_matches_plain(out_lse, want)
    assert_matches_plain(lse, want_lse, rel=2.0 ** -14)


# K6 on the dispatcher's (B, S, H, 64) views, at KV lengths across its route
# (one 128-key tile, ragged tails, V resident up to 512 keys and streamed
# above), two consumers (300 queries) and one (50), with and without the LSE
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq", [300, 50])
@pytest.mark.parametrize("sk", [1, 64, 200, 256, 385, 512, 777, 1000, 1024])
def test_cuda_single_kv_on_the_dispatchers_views(cuda, dtype, sq, sk):
    from motion324_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=cuda).manual_seed(sk)
    q, k, v = (_bhsd(g, cuda, dtype, 2, 3, n, True) for n in (sq, sk, sk))
    assert single_kv_route(sk)
    before = (flash_attention.single_kv_launches,
              flash_attention.single_kv_lse_launches)
    out, none = fa._forward(q, k, v, 0.125, with_lse=False)
    out_lse, lse = fa._forward(q, k, v, 0.125, with_lse=True)
    torch.cuda.synchronize()
    assert none is None
    assert (flash_attention.single_kv_launches,
            flash_attention.single_kv_lse_launches) == (before[0] + 1,
                                                         before[1] + 1)
    want, want_lse = flash_attention_reference(q, k, v, scale=0.125,
                                               with_lse=True)
    for o in (out, out_lse):
        assert o.shape == (2, 3, sq, 64) and o.transpose(1, 2).is_contiguous()
        assert_matches_plain(o, want)
    assert lse.shape == (6, sq)
    assert_matches_plain(lse, want_lse, rel=REL_TOL[torch.float32])


# The volume query's route: the dispatcher hands K6 transposed views and
# transposes its heads-last output back, so the call launches K6 and nothing
# else (no copy of q, k, v or the output)
@pytest.mark.cuda
def test_cuda_single_kv_launches_no_copy(cuda):
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = (torch.randn(1, n, 4, 64, generator=g, device=cuda)
               .to(torch.bfloat16) for n in (2048, 512, 512))
    assert select_route(2048, 512) == "flash" and single_kv_route(512)
    multi_head_attention(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = multi_head_attention(q, k, v)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.self_device_time_total > 0]
    assert len(names) == 1 and "single_kv" in names[0], names
    assert out.shape == (1, 2048, 4, 64) and out.is_contiguous()
    assert_matches_plain(out, mha_reference(q, k, v))


def _fused_qkv(g, cuda, dtype, b, h, sq, sk):
    """q (pre-scaled by 1/8), k and v as strided views of one fused
    (B, S, 3 H 64) projection, as the model hands them to K2 and K5."""
    qkv = torch.randn(b, max(sq, sk), 3 * h * 64, generator=g,
                      device=cuda).to(dtype)
    q = (qkv[:, :sq, :h * 64] * 0.125).to(dtype)
    return q, qkv[:, :sk, h * 64:2 * h * 64], qkv[:, :sk, 2 * h * 64:]


# K5 at the training's local layers (24 images x 12 heads x 324^2) and a
# ragged row, on fused-QKV views, dq/dk/dv written contiguous
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,sq,sk", [(24, 12, 324, 324), (2, 12, 200, 300)],
                         ids=["local", "ragged"])
def test_cuda_folded_bwd_on_fused_qkv_views(cuda, dtype, b, h, sq, sk):
    g = torch.Generator(device=cuda).manual_seed(14)
    q, k, v = _fused_qkv(g, cuda, dtype, b, h, sq, sk)
    o, lse = folded_attention_reference(q, k, v, heads=h, scale=1.0,
                                        with_lse=True)
    do = torch.randn(o.shape, generator=g, device=cuda).to(dtype)
    before = folded_attention_bwd.launches
    got = folded_attention_bwd(q, k, v, o, lse, do, heads=h)
    torch.cuda.synchronize()
    assert folded_attention_bwd.launches == before + 1
    want = folded_attention_bwd_reference(q, k, v, o, lse, do, heads=h,
                                          scale=1.0)
    for a, w in zip(got, want):
        assert a.is_contiguous() and a.shape == w.shape
        assert_matches_plain(a, w)


# K5 adds no atomics: a call repeats bit for bit, and image 0 of a B = 4
# call has the bits of the same image alone
@pytest.mark.cuda
def test_cuda_folded_bwd_repeats_bit_for_bit(cuda):
    g = torch.Generator(device=cuda).manual_seed(15)
    h = 12
    q, k, v = _fused_qkv(g, cuda, torch.bfloat16, 4, h, 324, 324)
    o, lse = folded_attention_reference(q, k, v, heads=h, scale=1.0,
                                        with_lse=True)
    do = torch.randn(o.shape, generator=g, device=cuda).to(torch.bfloat16)
    four = folded_attention_bwd(q, k, v, o, lse, do, heads=h)
    again = folded_attention_bwd(q, k, v, o, lse, do, heads=h)
    one = folded_attention_bwd(q[:1], k[:1], v[:1], o[:1], lse[:1].clone(),
                               do[:1], heads=h)
    torch.cuda.synchronize()
    for a, a2, b1 in zip(four, again, one):
        assert torch.equal(a, a2)
        assert torch.equal(a[:1], b1)


# K7 against its plain version: the mask bits are computed in the same f32
# order on both sides, so only the softmax sums differ, as for K1.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,s,g", [(1, 10, 6144, 32), (2, 3, 300, 4),
                                     (1, 20, 384, 8)])
def test_cuda_masked_flash_matches_plain(cuda, dtype, b, h, s, g):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(b, h, s, 64, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    # cell positions on a coarse lattice, so that many pairs sit within the
    # radius; a run of empty cells at 0
    pos = torch.randint(0, g, (b, s, 3), generator=gen, device=cuda).float() / g
    pos[:, : s // 10] = 0.0
    radius = 1.73 / g
    before = masked_flash_attention.launches
    out = masked_flash_attention(q, k, v, pos, radius=radius)
    torch.cuda.synchronize()
    assert masked_flash_attention.launches == before + 1
    want = masked_attention_reference(q, k, v, pos, radius=radius)
    assert_matches_plain(out, want)
    # a kernel that loses the radius test would be far off (0.7 r drops the
    # lattice's face diagonals, sqrt(2) / g)
    miss = masked_attention_reference(q, k, v, pos, radius=radius * 0.7)
    assert (miss.float() - want.float()).abs().max() > \
        REL_TOL[dtype] * want.float().abs().max()


def _surface_positions(gen, cuda, b, s):
    """Cell positions in random order on a sphere inside the unit box, an
    eighth at the origin (chip_smoke.py's surface_positions)."""
    p = torch.randn(b, s, 3, generator=gen, device=cuda)
    p = 0.5 + 0.45 * p / p.norm(dim=-1, keepdim=True)
    p[:, : s // 8] = 0.0
    return p


def _raster_positions(cuda, n_views, hw, g):
    """Cell positions in the paint path's order (voxel_positions: view by
    view, raster order over the g x g cells) from synthetic position maps:
    view 0 a wavy sheet that fills it, the others disks above it on a
    background (cells at the origin)."""
    from motion324_tpu_torch.hy3dgen.voxel_attention import voxel_positions
    c = (torch.arange(hw, device=cuda) + 0.5) / hw
    w, u = torch.meshgrid(c, c, indexing="ij")
    maps = []
    for i in range(n_views):
        z = 0.3 + 0.4 * (i > 0) + 0.1 * torch.sin(3 * u + i) * torch.cos(2 * w)
        m = torch.stack([u, w, z], -1)
        if i > 0:
            m[(u - 0.5) ** 2 + (w - 0.5) ** 2 > 0.35 ** 2] = 1.0
        maps.append(m)
    return voxel_positions(torch.stack(maps)[None], g)


def _masked_positions(gen, cuda, order, b, s, g):
    if order == "surface":
        return _surface_positions(gen, cuda, b, s), 1.73 / g
    views = s // (g * g)
    pos, r = _raster_positions(cuda, views, 8 * g, g)
    return pos.expand(b, -1, -1).contiguous(), r


# K7 on both position orders at the turbo shapes (6 views of 32^2, 16^2 and
# 8^2 cells) and a ragged one, q/k/v as the UNet's (B, S, H, 64) views: the
# output within REL_TOL of the plain version, laid out heads-last, and
# the pre-pass's bits and tile flags bit for bit those of
# masked_tile_list_reference
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("order", ["surface", "raster"])
@pytest.mark.parametrize("b,h,s,g", [(1, 10, 6144, 32), (1, 20, 1536, 16),
                                     (1, 20, 384, 8), (2, 3, 320, 8)])
def test_cuda_masked_flash_on_both_orders(cuda, dtype, order, b, h, s, g):
    from motion324_tpu_torch.ops import masked_attention as ma
    gen = torch.Generator(device=cuda).manual_seed(16)
    pos, radius = _masked_positions(gen, cuda, order, b, s, g)
    q, k, v = (torch.randn(b, s, h, 64, generator=gen, device=cuda)
               .to(dtype).transpose(1, 2) for _ in range(3))
    before = masked_flash_attention.launches
    out = masked_flash_attention(q, k, v, pos, radius=radius)
    torch.cuda.synchronize()
    assert masked_flash_attention.launches == before + 1
    assert out.transpose(1, 2).is_contiguous()
    want = masked_attention_reference(q, k, v, pos, radius=radius)
    assert_matches_plain(out, want)
    if dtype == torch.bfloat16:
        bits, tiles = ma.masked_tile_list(pos, radius)
        want_bits, want_tiles = ma.masked_tile_list_reference(pos, radius)
        torch.cuda.synchronize()
        assert torch.equal(bits, want_bits)
        assert torch.equal(tiles, want_tiles)


# K7's list of key tiles is sized at launch: a call past 256 tiles (32 768
# tokens) runs and matches the plain version
@pytest.mark.cuda
def test_cuda_masked_flash_past_256_tiles(cuda):
    gen = torch.Generator(device=cuda).manual_seed(19)
    s = 258 * 128 - 40
    pos = _surface_positions(gen, cuda, 1, s)
    q, k, v = (torch.randn(1, 1, s, 64, generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    out = masked_flash_attention(q, k, v, pos, radius=1.73 / 64)
    want = masked_attention_reference(q, k, v, pos, radius=1.73 / 64)
    torch.cuda.synchronize()
    assert_matches_plain(out, want)


def _mesh(seed: int, n_faces: int, n_verts: int):
    gen = torch.Generator().manual_seed(seed)
    pos = torch.cat([torch.rand(n_verts, 2, generator=gen) * 2.2 - 1.1,
                     torch.rand(n_verts, 1, generator=gen) * 1.8 - 0.9,
                     torch.rand(n_verts, 1, generator=gen) * 0.4 + 0.8], 1)
    faces = torch.randint(0, n_verts, (n_faces, 3), generator=gen)
    return pos, faces


# K8 is held to its plain version bit for bit: the same binned inputs, the
# same f32 rounding of the inside test and the depth, the same tie-break.
# The sliver mesh (tests/raster_meshes.py) has faces whose rounded
# test passes outside their bbox, invalid faces, signed-zero coefficients,
# w < 0 and faces off screen; 333 x 97 wraps K8's runs and groups over rows,
# 1 100 x 3 has tiles shorter than a row.
@pytest.mark.cuda
@pytest.mark.parametrize("w,h,n_faces,mesh", [
    (48, 48, 300, "random"), (512, 512, 5000, "random"),
    (2048, 40, 3000, "random"), (333, 97, 700, "random"),
    (1100, 3, 300, "random"), (48, 48, 600, "sliver"),
    (512, 512, 3000, "sliver"), (333, 97, 3000, "sliver"),
    (1100, 3, 3000, "sliver")],
    ids=["48-48-300", "512-512-5000", "2048-40-3000", "333-97-700",
         "1100-3-300", "sliver-48-48", "sliver-512-512", "sliver-333-97",
         "sliver-1100-3"])
def test_cuda_rasterize_matches_plain_bit_for_bit(cuda, w, h, n_faces, mesh):
    if mesh == "sliver":
        pos, faces = sliver_mesh(w + h, n_faces)
    else:
        pos, faces = _mesh(w + n_faces, n_faces, n_faces // 2)
    pos, faces = pos.to(cuda), faces.to(cuda)
    before = rasterize.launches
    find, bary = rasterize(pos, faces, w, h)
    torch.cuda.synchronize()
    assert rasterize.launches == before + 1
    coeffs, bbox = bin_faces(pos, faces, w, h)
    want = raster_reference(coeffs, bbox, w, h).reshape(h, w)
    assert find.dtype == torch.int32 and find.shape == (h, w)
    assert torch.equal(find, want)
    assert (find > 0).float().mean().item() > 0.1


# K8 has two launches, picked by the image's count of 128-pixel groups: a
# group of 4 warps a block below 4 096 groups, 4 groups of one warp a block
# from there on. Both give the plain version's findices on the sliver mesh,
# with groups inside rows (512 wide) and wrapping rows (333 and 1 100 wide).
@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(512, 512), (333, 97), (1024, 512),
                                 (1100, 477)],
                         ids=["2048-groups", "wrapping-256-groups",
                              "4096-groups", "wrapping-4104-groups"])
def test_cuda_rasterize_launches_match_plain(cuda, w, h):
    for seed in range(3):
        pos, faces = sliver_mesh(seed, 3000)
        coeffs, bbox = bin_faces(pos.to(cuda), faces.to(cuda), w, h)
        got = raster_kernel(coeffs, bbox, w, h)
        torch.cuda.synchronize()
        assert torch.equal(got, raster_reference(coeffs, bbox, w, h))


# K9 forward: the same softmax as its plain version with P rounded against
# a running max (as K1 and K2), held to the same shares of max |plain|. The
# inputs are (B, S, H, 64) projections seen as (B, H, S, 64), as the legacy
# route hands them over; the kernel reads them through their strides.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk", [(3, 37, 200), (1, 324, 324),
                                     (1, 64, 2000), (3, 162, 64)])
def test_cuda_short_matches_plain(cuda, dtype, b, sq, sk):
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(b, n, 3, 64, generator=g, device=cuda).to(dtype)
               .transpose(1, 2) for n in (sq, sk, sk))
    before = sa.short_attention.launches
    out = sa.short_attention(q, k, v, scale=0.31)
    torch.cuda.synchronize()
    assert sa.short_attention.launches == before + 1
    assert out.shape == (b, 3, sq, 64)
    assert_matches_plain(out, sa.short_attention_reference(q, k, v, scale=0.31))


# K9 backward: two passes with no atomics on the data, so it is repeatable
# bit for bit; the forward with the compact LSE beside it. 64 x 4 096 splits
# the forward's and the dq pass's keys 16 ways, 4 100 x 64 the dk/dv pass's
# query tiles 2 ways; contiguous and (B, S, H, 64)-strided inputs.
@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True], ids=["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,sk", [(324, 324), (64, 1500), (162, 64),
                                   (64, 4096), (4100, 64)])
def test_cuda_short_lse_and_bwd_match_plain(cuda, dtype, sq, sk, strided):
    g = torch.Generator(device=cuda).manual_seed(9)
    q = _bhsd(g, cuda, dtype, 2, 3, sq, strided, scale=0.125)
    k, v = (_bhsd(g, cuda, dtype, 2, 3, sk, strided) for _ in range(2))
    before = (sa.short_attention.lse_launches, sa.short_attention_bwd.launches)
    out, lse = sa._forward(q, k, v, 1.0, with_lse=True)
    want, wlse = sa.short_attention_reference(q, k, v, scale=1.0, with_lse=True)
    assert lse.shape == (6, sq) and lse.dtype == torch.float32
    assert_matches_plain(out, want)
    assert_matches_plain(lse, wlse, rel=REL_TOL[torch.float32])
    do = _bhsd(g, cuda, dtype, 2, 3, sq, strided)
    got = sa.short_attention_bwd(q, k, v, want, wlse, do)
    again = sa.short_attention_bwd(q, k, v, want, wlse, do)
    torch.cuda.synchronize()
    assert (sa.short_attention.lse_launches, sa.short_attention_bwd.launches) \
        == (before[0] + 1, before[1] + 2)
    ref = sa.short_attention_bwd_reference(q, k, v, want, wlse, do)
    for a, a2, w in zip(got, again, ref):
        assert a.is_contiguous() and torch.equal(a, a2)
        assert_matches_plain(a, w)


# K9's splits depend on (Sq, Sk) alone: slice 0 of a B = 4 call has the bits
# of a B = 1 call, and a call the same bits twice, at the shapes that take
# each split (the forward with the LSE at 64 x 4 096, the backward there and
# at 4 100 x 64)
@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(64, 4096), (4100, 64)])
def test_cuda_short_splits_do_not_depend_on_the_batch(cuda, sq, sk):
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, do = (_bhsd(g, cuda, torch.bfloat16, 4, 3, n, True, scale=f)
                   for n, f in ((sq, 0.125), (sk, 1.0), (sk, 1.0), (sq, 1.0)))
    one = lambda x: x[:1].clone()

    def run(q_, k_, v_, do_):
        out, lse = sa._forward(q_, k_, v_, 1.0, with_lse=True)
        return (out, lse, *sa.short_attention_bwd(q_, k_, v_, out, lse, do_))
    four, twice = run(q, k, v, do), run(q, k, v, do)
    alone = run(one(q), one(k), one(v), one(do))
    torch.cuda.synchronize()
    for name, a, a2, b1 in zip(("out", "lse", "dq", "dk", "dv"), four, twice,
                               alone):
        assert torch.equal(a, a2), name
        assert torch.equal(a[: b1.shape[0]], b1), name


@pytest.mark.cuda
def test_cuda_legacy_route_carries_gradients(cuda):
    """multi_head_attention(backend="short_legacy") on CUDA returns an
    output with a grad_fn through ShortAttentionFn: one K9 forward with the
    LSE, one K9 backward, gradients as the plain path's."""
    g = torch.Generator(device=cuda).manual_seed(10)
    q, k, v = (torch.randn(2, n, 3, 64, generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_() for n in (162, 64, 64))
    before = (sa.short_attention.lse_launches, sa.short_attention_bwd.launches)
    out = multi_head_attention(q, k, v, backend="short_legacy")
    nodes, seen = [out.grad_fn], []
    while nodes:
        node = nodes.pop()
        seen.append(type(node))
        nodes += [n for n, _ in node.next_functions if n is not None]
    assert sa.ShortAttentionFn._backward_cls in seen, seen
    do = torch.randn(out.shape, generator=g, device=cuda).to(torch.bfloat16)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (sa.short_attention.lse_launches, sa.short_attention_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(multi_head_attention(q, k, v, backend="plain"),
                               (q, k, v), do)
    for a, b in zip(got, want):
        assert_matches_plain(a, b)


@pytest.mark.cuda
def test_cuda_short_raises_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 16, 32, device=cuda)
    with pytest.raises(ValueError):
        sa.short_attention(q, q, q)          # head dim 32
    q = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        sa.short_attention(q, q, q)          # fp16


# The video-only product path (video_only.run) at tiny shape widths with
# heads 64 wide, so that the shape models take the kernel routes: the
# conditioner's 257 tokens, the DiT's 385 and the ShapeVAE's 128 latents on
# K2, the volume query (8 192 points over 128 latents) on K6; the
# release-width motion model on K1 and K2; the weight-free painter on K8.
# The ShapeVAE's output bias is moved so that the coarse grid's median logit
# of frame 0's crop is 0: random weights need not cross 0 anywhere.
@pytest.mark.cuda
def test_cuda_video_only_launches_the_paths_kernels(cuda, tmp_path):
    import numpy as np

    from motion324_tpu_torch import video_only
    from motion324_tpu_torch.config import ModelConfig
    from motion324_tpu_torch.hy3dgen.paint_pipeline import PaintPipeline
    from motion324_tpu_torch.hy3dgen.scheduler import flow_match_sigmas
    from motion324_tpu_torch.hy3dgen.shape_pipeline import ShapeGenPipeline
    from motion324_tpu_torch.hy3dgen.volume import decode_volume
    from motion324_tpu_torch.inference.pipeline import MotionPipeline, load_video
    from motion324_tpu_torch.inference.preprocess import preprocess_video_frames
    from motion324_tpu_torch.io.fbx import load_fbx
    from motion324_tpu_torch.io.glb import load_animated_glb

    size, frames = 96, 13
    yy, xx = np.mgrid[:size, :size]
    clip = np.full((frames, size, size, 3), 20, np.uint8)
    for t in range(frames):
        disc = (yy - 48 - 8 * np.sin(t)) ** 2 + (xx - 48 - 8 * np.cos(t)) ** 2
        clip[t][disc < 400] = [200, 120 + 5 * t, 60]
    np.save(tmp_path / "clip.npy", clip)
    steps = 2
    pipe = ShapeGenPipeline.init_random(
        torch.Generator(cuda).manual_seed(0), num_latents=128, latent_dim=8,
        cond_dim=128, cond_depth=1, cond_heads=2, dit_hidden=128, dit_heads=2,
        dit_depth=1, dit_single=1, vae_width=128, vae_heads=2, vae_layers=1,
        image_size=224, device=cuda)
    crops, _, _ = preprocess_video_frames(load_video(str(tmp_path / "clip.npy")),
                                          size=512)
    cond = pipe.encode_cond(pipe.prepare_image(crops[0]))
    noise = torch.randn(1, 128, 8, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    lat = pipe.denoise(noise, torch.cat([cond, torch.zeros_like(cond)]),
                       flow_match_sigmas(steps), 5.0)
    grid, _ = decode_volume(pipe.vae.query, pipe.vae_decode(lat), 32)
    with torch.no_grad():
        pipe.vae.geo_decoder.output_proj.bias -= float(np.median(grid))
    models = {"shape": pipe,
              "painter": PaintPipeline(resolution=128, texture_size=256,
                                       device=cuda),
              "motion": MotionPipeline(ModelConfig(dtype=torch.bfloat16,
                                                   decode_frames_chunk=12),
                                       window=12)}
    del pipe
    fa, fo = flash_attention, folded_attention
    counters = {"K1": (fa, "launches"), "K6": (fa, "single_kv_launches"),
                "K2": (fo, "launches"), "K8": (rasterize, "launches")}
    before = {k: getattr(f, a) for k, (f, a) in counters.items()}
    out = tmp_path / "out"
    rc = video_only.run(str(tmp_path / "clip.npy"), str(out), models,
                        steps=steps, octree_resolution=64, max_faces=2000,
                        recenter=False, device=cuda)
    torch.cuda.synchronize()
    assert rc == 0
    moved = {k: getattr(f, a) - before[k] for k, (f, a) in counters.items()}
    assert all(n > 0 for n in moved.values()), moved
    assert moved["K8"] == 7        # 6 views and the atlas
    _, faces, traj, _ = load_animated_glb(str(out / "output_animation.glb"))
    assert traj.shape[0] == frames and np.isfinite(traj).all()
    assert len(load_fbx(str(out / "output_animation.fbx"))["shapes"]) == frames


# K1 at the shape a rank sees under sequence parallelism over 2 ranks: its
# 6 of the 12 frames' queries (1 944) over all 3 888 keys
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_at_the_sequence_parallel_shape(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = _bhsd(g, cuda, dtype, 1, 12, 1944, False)
    k = _bhsd(g, cuda, dtype, 1, 12, 3888, False)
    v = _bhsd(g, cuda, dtype, 1, 12, 3888, False)
    before = flash_attention.launches
    out = flash_attention(q, k, v, scale=0.125)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert_matches_plain(out, flash_attention_reference(q, k, v, scale=0.125))


@pytest.mark.cuda
def test_cuda_world_one_nccl_dp_step_is_the_one_process_step(cuda, tmp_path):
    """The release width at two blocks and one DINOv2 layer, bf16 compute,
    one clip of 16 frames and 8 192 shape samples (every backward on K4
    or K5, whose sums run in a fixed order; K3 adds dq in a varying one): a
    data-parallel step on a one-rank NCCL group gives the parameters of
    the step with no group, bit for bit."""
    import torch.distributed as dist

    from motion324_tpu_torch.config import ModelConfig, TrainConfig
    from motion324_tpu_torch.models.motion_model import MotionLatentModel
    from motion324_tpu_torch.parallel.mesh import make_mesh
    from motion324_tpu_torch.training.train_step import (create_train_state,
                                                         train_step)
    cfg = ModelConfig(n_alternating_layers=2, pcd_layers=1, dino_depth=1,
                      dtype=torch.bfloat16, decode_frames_chunk=16)
    tcfg = TrainConfig(grad_accum_steps=1, warmup=0, remat=False,
                       allowed_gradnorm_factor=1e9, bf16_grad_allreduce=True)
    g = torch.Generator(device=cuda).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda)
    batch = {k: rnd(1, 8192, 3) for k in ("ref_shape_pcd", "ref_shape_normals",
                                          "ref_shape_rgbs", "ref_pcd",
                                          "ref_normal", "ref_rgb")}
    batch["rgb_video"] = torch.rand(1, 16, 224, 224, 3, generator=g, device=cuda)
    batch["point_clouds"] = rnd(1, 16, 8192, 3) * 0.1

    def step(mesh):
        state = create_train_state(MotionLatentModel(cfg, seed=0).to(cuda),
                                   tcfg, mesh)
        metrics = train_step(state, [batch], tcfg)
        return state.model.state_dict(), metrics

    alone, m_alone = step(None)
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1, device_id=dev)
    try:
        grouped, m_grouped = step(make_mesh())
    finally:
        dist.destroy_process_group()
    assert m_alone == m_grouped and m_alone["skipped"] == 0.0
    for k, v in alone.items():
        assert torch.equal(v, grouped[k]), k


# K8 at the evaluation's render site (render_video.render_animated_mesh):
# every frame's findices bit for bit against the plain version on the same
# clip positions, one launch per frame, and the frames within 1e-5 of the
# render on the CPU (the same shading in f32 on another device).
@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["texture", "vertex_colors", "shaded"])
def test_cuda_render_video_runs_k8_bit_for_bit(cuda, mode, monkeypatch):
    import os

    import numpy as np

    from motion324_tpu_torch.evaluation import render_video as rv
    from motion324_tpu_torch.io.glb import load_glb
    blob = load_glb(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "synthetic", "blob.glb"))
    frames = np.stack([blob["vertices"] * (1 + 0.1 * np.sin(i + np.arange(3)))
                       for i in range(4)]).astype(np.float32)
    r = np.random.RandomState(0)
    kw = {"texture": dict(uv=blob["uv"], texture=r.rand(32, 32, 3).astype(np.float32)),
          "vertex_colors": dict(vertex_colors=blob["vertex_colors"]),
          "shaded": {}}[mode]
    seen = []
    real = rv.rasterize

    def spy(pos, faces, w, h):
        out = real(pos, faces, w, h)
        seen.append((pos, faces, out[0]))
        return out
    monkeypatch.setattr(rv, "rasterize", spy)
    before = rasterize.launches
    got = rv.render_animated_mesh(frames, blob["faces"], resolution=256,
                                  device="cuda", **kw)
    assert rasterize.launches == before + len(frames)
    for pos, faces, find in seen:
        coeffs, bbox = bin_faces(pos, faces, 256, 256)
        assert torch.equal(find, raster_reference(coeffs, bbox, 256, 256)
                           .reshape(256, 256))
    seen.clear()
    want = rv.render_animated_mesh(frames, blob["faces"], resolution=256,
                                   device="cpu", **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
