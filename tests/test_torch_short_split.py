"""The K9 kernels' splits and the plan of a K9 backward, on the CPU.

The K9 forward (and its backward's dq pass) cuts the keys of a bf16 call of
one query tile into contiguous ranges (``short_split_count(Sq, Sk)``), and
the backward's dk/dv pass cuts the query tiles of a call with many query
tiles over few key tiles (``short_dkv_split_count(Sq, Sk)``); each range is
a block of its own, and the tile's last block adds the f32 partials in
split order. Here: the plain versions of that arithmetic
(``short_attention_split_reference``,
``short_attention_bwd_split_reference``) against the JAX package's
``short_attention`` run in interpret mode and ``jax.vjp`` of it, and
against the unsplit plain versions; the rules; and ``short_bwd_plan``,
which sizes the workspace and the tickets from the lengths alone. The
kernels themselves are held to the same arithmetic on the card
(test_torch_cuda_kernels.py, chip_smoke.py).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.ops.short_attention import short_attention as jax_short
from motion324_tpu_torch.ops import flash_attention as fa
from motion324_tpu_torch.ops import short_attention as sa

# f32 on both sides, the same math summed in another order (here in key or
# query ranges): each output within 1e-5 of its own max |JAX|.
REL = 1e-5
SCALE = 0.125     # 1/sqrt(64), exact in every dtype

# (Sq, Sk) of the legacy route's calls (inference and training): global,
# local, shape encoder, point blocks, decoder
GLOBAL, LOCAL = (3888, 3888), (324, 324)
SHAPE_ENC, SHAPE_ENC_TRAIN = (64, 16384), (64, 4096)
POINTS, DECODER, DECODER_TRAIN = (64, 64), (162, 64), (4096, 64)


def _arrays(seed, *shapes):
    r = np.random.RandomState(seed)
    return [r.randn(*s).astype(np.float32) for s in shapes]


def _assert_close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    top = np.abs(want).max()
    assert err <= rel * top, f"{what}: max |d| {err:.3e} > {rel} x {top:.3e}"


def _jax_vjp(q, k, v, do):
    """out and (dq, dk, dv) of the JAX package's short attention in
    interpret mode (dq with respect to the unscaled q)."""
    f = lambda q_, k_, v_: jax_short(q_, k_, v_, scale=SCALE, interpret=True)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return out, vjp(jnp.asarray(do))


@pytest.mark.parametrize("sq,sk,pass_", [(64, 4200, "dq"), (4100, 64, "dkv")],
                         ids=["64x4200", "4100x64"])
def test_split_references_match_pallas(sq, sk, pass_):
    """64 queries over 4 200 keys (a ragged key tail) split the forward and
    the dq pass; 4 100 queries (a ragged query tail) over 64 keys split the
    dk/dv pass. Output, LSE and gradients against the Pallas kernels in
    interpret mode and ``jax.vjp`` of them."""
    n_split = sa.short_split_count(sq, sk)
    dkv_split = sa.short_dkv_split_count(sq, sk)
    assert (n_split > 1) == (pass_ == "dq") and (dkv_split > 1) == (pass_ == "dkv")
    q, k, v, do = _arrays(sq + sk, (1, 1, sq, 64), (1, 1, sk, 64),
                          (1, 1, sk, 64), (1, 1, sq, 64))
    want_out, want_grads = _jax_vjp(q, k, v, do)

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = sa.short_attention_split_reference(tq, tk, tv, n_split,
                                                  scale=SCALE)
    _assert_close(out.numpy(), want_out, "out")
    _, want_lse = sa.short_attention_reference(tq, tk, tv, scale=SCALE,
                                               with_lse=True)
    assert lse.shape == (1, sq)
    _assert_close(lse.numpy(), want_lse.numpy(), "lse")
    qs = tq * SCALE
    dq, dk, dv = sa.short_attention_bwd_split_reference(
        qs, tk, tv, out, lse, tdo, n_split, dkv_split)
    for name, g, w in zip(("dq", "dk", "dv"), (dq * SCALE, dk, dv), want_grads):
        _assert_close(g.numpy(), w, name)


@pytest.mark.parametrize("n_split", [1, 3, 16])
def test_forward_and_dq_split_match_the_unsplit_plain_version(n_split):
    """At one split the same arithmetic as the unsplit plain versions, bit
    for bit for dk and dv; at 3 and 16 the same sums in key ranges. 65
    queries over 16 347 keys (a ragged last range). In f32, and in bf16,
    where the output and dq are rounded once, after the last range: within
    one bf16 step of the unsplit ones."""
    sq, sk = 65, 16384 - 37
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        6, (1, 2, sq, 64), (1, 2, sk, 64), (1, 2, sk, 64), (1, 2, sq, 64)))
    for dtype in (torch.float32, torch.bfloat16):
        q_, k_, v_, do_ = (t.to(dtype) for t in (q * SCALE, k, v, do))
        out, lse = sa.short_attention_split_reference(q_, k_, v_, n_split,
                                                      scale=1.0)
        want, want_lse = sa.short_attention_reference(q_, k_, v_, scale=1.0,
                                                      with_lse=True)
        assert out.dtype == dtype and lse.dtype == torch.float32
        rel = REL if dtype == torch.float32 else 2.0 ** -7
        _assert_close(out.float().numpy(), want.float().numpy(), f"{dtype} out", rel)
        _assert_close(lse.numpy(), want_lse.numpy(), f"{dtype} lse")
        got = sa.short_attention_bwd_split_reference(q_, k_, v_, want,
                                                     want_lse, do_, n_split, 1)
        ref = sa.short_attention_bwd_reference(q_, k_, v_, want, want_lse, do_)
        for name, g, w in zip(("dq", "dk", "dv"), got, ref):
            if n_split == 1 or name != "dq":
                assert torch.equal(g, w), (dtype, name)
            else:
                _assert_close(g.float().numpy(), w.float().numpy(),
                              f"{dtype} {name}", rel)


@pytest.mark.parametrize("dkv_split", [1, 2, 6, 16])
def test_dkv_split_matches_the_unsplit_plain_version(dkv_split):
    """The dk/dv pass's query ranges: at one split the unsplit dk and dv
    (within f32 rounding), at 2, 6 and 16 the same sums in query ranges of
    whole 64-row tiles. 1 000 queries (a ragged last tile) over 64 keys, in
    f32 and in bf16 (dk and dv rounded once, after the last range: within
    one bf16 step); dq is the unsplit one, bit for bit."""
    sq, sk = 1000, 64
    ranges = sa.dkv_ranges(sq, dkv_split)
    assert len(ranges) == dkv_split and ranges[0][0] == 0
    assert ranges[-1][1] == sq and all(b > a for a, b in ranges)
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        7, (1, 3, sq, 64), (1, 3, sk, 64), (1, 3, sk, 64), (1, 3, sq, 64)))
    for dtype in (torch.float32, torch.bfloat16):
        q_, k_, v_, do_ = (t.to(dtype) for t in (q * SCALE, k, v, do))
        o, lse = sa.short_attention_reference(q_, k_, v_, scale=1.0,
                                              with_lse=True)
        got = sa.short_attention_bwd_split_reference(q_, k_, v_, o, lse, do_,
                                                     1, dkv_split)
        ref = sa.short_attention_bwd_reference(q_, k_, v_, o, lse, do_)
        assert torch.equal(got[0], ref[0]), dtype
        rel = REL if dtype == torch.float32 else 2.0 ** -7
        for name, g, w in zip(("dk", "dv"), got[1:], ref[1:]):
            assert g.dtype == dtype
            _assert_close(g.float().numpy(), w.float().numpy(),
                          f"{dtype} {name}", rel)


# a spread of lengths: the legacy route's calls, ragged ones, and the
# lengths of the card tests
LENGTHS = ([GLOBAL, LOCAL, SHAPE_ENC, SHAPE_ENC_TRAIN, POINTS, DECODER,
            DECODER_TRAIN, (5184, 5184), (4100, 64), (1000, 64), (64, 2000),
            (37, 200), (1000, 1300), (2048, 200), (130, 65)]
           + [(sq, sk) for sq in (1, 64, 65, 128, 129, 700, 1023, 8192)
              for sk in (1, 64, 65, 300, 1100, 4097)])


def test_split_rules_depend_on_the_lengths_only():
    """Both rules take (Sq, Sk) and nothing else; every range is whole tiles
    and none is empty, at most 16 of them; the global, local and point-block
    rows run unsplit in both passes, the shape encoder splits its keys 16
    ways (192 / 384 forward blocks at 12 / 24 slices) and the training
    decoder its query tiles 2 ways (576 dk/dv blocks at 288 slices)."""
    for rule in (sa.short_split_count, sa.short_dkv_split_count):
        assert list(inspect.signature(rule).parameters) == ["sq", "sk"]
    for sq, sk in LENGTHS:
        n, m = sa.short_split_count(sq, sk), sa.short_dkv_split_count(sq, sk)
        assert 1 <= n <= 16 and 1 <= m <= 16, (sq, sk, n, m)
        keys = fa.split_ranges(sk, n)
        rows = sa.dkv_ranges(sq, m)
        assert len(keys) == n and len(rows) == m
        assert keys[-1][1] == sk and rows[-1][1] == sq
        assert all(b > a for a, b in keys + rows), (sq, sk, keys, rows)
        assert all((b - a) % 128 == 0 for a, b in keys[:-1])
        assert all((b - a) % 64 == 0 for a, b in rows[:-1])
    for sq, sk in (GLOBAL, LOCAL, POINTS, DECODER, (5184, 5184)):
        assert (sa.short_split_count(sq, sk),
                sa.short_dkv_split_count(sq, sk)) == (1, 1), (sq, sk)
    for sq, sk in (SHAPE_ENC, SHAPE_ENC_TRAIN):
        assert sa.short_split_count(sq, sk) == 16
        assert sa.short_dkv_split_count(sq, sk) == 1
    assert sa.short_split_count(*DECODER_TRAIN) == 1
    assert sa.short_dkv_split_count(*DECODER_TRAIN) == 2
    assert sa.dkv_ranges(4096, 2) == [(0, 2048), (2048, 4096)]


@pytest.mark.parametrize("sq,sk", LENGTHS[:12])
def test_bwd_plan_covers_what_the_kernels_write(sq, sk):
    """The workspace: lse * log2(e) and delta in rows padded to 128; the dq
    split's f32 partials (one dq per split, in query tiles of 128 rows, 64
    when Sq <= 64); the dk/dv split's (one dk and one dv per split, over the
    keys padded to the dk/dv blocks of 64 keys per consumer). The tickets:
    one per (slice, tile) of each split pass. The splits do not depend on
    the number of slices; f32 is never split and needs neither."""
    plans = {bh: sa.short_bwd_plan(bh, sq, sk, torch.bfloat16)
             for bh in (1, 12, 24, 288)}
    assert len({p[:2] for p in plans.values()}) == 1
    for bh, (n, m, floats, tickets) in plans.items():
        assert (n, m) == (sa.short_split_count(sq, sk),
                          sa.short_dkv_split_count(sq, sk))
        pad = -(-sq // 128) * 128
        need, need_tickets = 2 * bh * pad, 0
        if n > 1:
            tile = 64 if sq <= 64 else 128
            need += n * bh * max(pad, -(-sq // tile) * tile) * 64
            need_tickets = bh * -(-sq // tile)
        if m > 1:
            keys = 64 if sq <= 64 or sk <= 64 else 128
            need += m * bh * -(-sk // keys) * keys * 2 * 64
            need_tickets = max(need_tickets, bh * -(-sk // keys))
        assert floats >= need and tickets >= need_tickets, (bh, floats, need)
        assert sa.short_bwd_plan(bh, sq, sk, torch.float32) == (1, 1, 0, 0)
