"""K4's split dq pass and the plan of a K3 / K4 call, on the CPU.

K4's dq pass cuts the keys of a bf16 call with few query tiles into
contiguous ranges by K1's rule (``split_count(Sq, Sk)``), one block each;
each writes an f32 partial dq and the tile's last block adds them in split
order. Here: the plain version of that arithmetic
(``flash_attention_bwd_split_reference``) against ``jax.vjp`` of the JAX
package's flash attention run in interpret mode, and against the unsplit
plain backward; and ``bwd_plan``, which picks the kernel, the split and the
workspace from the lengths alone. The kernel itself is held to the same
arithmetic on the card (test_torch_cuda_kernels.py, chip_smoke.py).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.ops import flash_attention as jax_fa
from motion324_tpu_torch.ops import flash_attention as fa

# f32 on both sides, the same math summed in another order (here in key
# ranges): each gradient within 1e-5 of its own max |JAX|.
REL = 1e-5


def _arrays(seed, *shapes):
    r = np.random.RandomState(seed)
    return [r.randn(*s).astype(np.float32) for s in shapes]


def _assert_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    top = np.abs(want).max()
    assert err <= REL * top, f"{what}: max |d| {err:.3e} > {REL} x {top:.3e}"


@pytest.mark.parametrize("sq,sk", [(64, 4200), (64, 16384 - 37), (64, 16384)],
                         ids=["4200", "16347", "16384"])
def test_split_reference_matches_pallas_vjp(sq, sk):
    """Each length takes JAX's two-pass backward (K4's TPU kernels), the
    first two with a ragged key tail, and K4 splits each."""
    n_split = fa.split_count(sq, sk)
    assert n_split > 1 and sk > fa.FUSED_BWD_MAX_KV
    q, k, v, do = _arrays(4, (1, 1, sq, 64), (1, 1, sk, 64), (1, 1, sk, 64),
                          (1, 1, sq, 64))

    def f(q_, k_, v_):
        return jax_fa.flash_attention(q_, k_, v_, block_q=128, block_kv=128,
                                      interpret=True)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_reference(tq, tk, tv, with_lse=True)
    got = fa.flash_attention_bwd_split_reference(tq, tk, tv, o, lse, tdo, n_split)
    for name, g, w in zip("qkv", got, want):
        _assert_close(g.numpy(), w, f"d{name}")


@pytest.mark.parametrize("n_split", [1, 3, 16])
def test_split_reference_matches_the_plain_backward(n_split):
    """At one split the same arithmetic as the unsplit plain backward, bit
    for bit; at 3 and 16 the same sums in key ranges. 65 queries (a ragged
    query tile) over 16 347 keys (a ragged last range). In f32, and in bf16,
    where dq is rounded once, after the last range: within one bf16 step of
    the unsplit dq."""
    sq, sk = 65, 16384 - 37
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(
        5, (1, 2, sq, 64), (1, 2, sk, 64), (1, 2, sk, 64), (1, 2, sq, 64)))
    q = q * 0.125
    ranges = fa.split_ranges(sk, n_split)
    assert len(ranges) == n_split and all(b > a for a, b in ranges)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
        o, lse = fa.flash_attention_reference(q, k, v, scale=1.0, with_lse=True)
        got = fa.flash_attention_bwd_split_reference(q, k, v, o, lse, do,
                                                     n_split, scale=1.0)
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, scale=1.0)
        assert got[0].dtype == dtype
        for name, g, w in zip("qkv", got, want):
            what = f"{dtype} d{name}"
            if n_split == 1 or name != "q":
                assert torch.equal(g, w), what
            elif dtype == torch.float32:
                _assert_close(g.numpy(), w.numpy(), what)
            else:
                err = (g.float() - w.float()).abs().max().item()
                assert err <= 2.0 ** -7 * w.float().abs().max().item(), what


def test_k4_split_depends_on_the_lengths_only():
    """bwd_plan takes the split from split_count(Sq, Sk): the same for every
    number of (batch, head) slices, 1 for K3, for f32 and for the long
    query rows; the shape encoder's 64 x 16 384 call gets 16 splits of 1 024
    keys, 384 blocks at 24 slices."""
    assert list(inspect.signature(fa.split_count).parameters) == ["sq", "sk"]
    for sq, sk in [(64, 16384), (64, 4097), (300, 4200), (1000, 4200),
                   (5184, 5184), (65, 8000)]:
        splits = {fa.bwd_plan(bh, sq, sk, torch.bfloat16)[1]
                  for bh in (1, 3, 12, 24, 48)}
        assert splits == {fa.split_count(sq, sk)}, (sq, sk, splits)
        assert fa.bwd_plan(24, sq, sk, torch.float32)[:2] == (False, 1)
    assert fa.bwd_plan(24, 5184, 5184, torch.bfloat16)[1] == 1
    assert fa.bwd_plan(24, 64, 16384, torch.bfloat16)[:2] == (False, 16)
    assert fa.split_ranges(16384, 16) == [(i * 1024, (i + 1) * 1024)
                                          for i in range(16)]
    for sk in (127, 4096):
        assert fa.bwd_plan(24, 64, sk, torch.bfloat16)[:2] == (True, 1)


@pytest.mark.parametrize("sq,sk", [(64, 4096), (3888, 3888), (65, 4097),
                                   (64, 16384), (5184, 5184)])
def test_bwd_workspace_holds_what_the_kernels_write(sq, sk):
    """The workspace: lse * log2(e) and delta in rows padded to 128; K3's
    f32 dq tiles of 64 rows; K4's split partials (one f32 dq per split,
    in query tiles of 128 rows, 64 when Sq <= 64). f32 keeps delta."""
    bh = 24
    pad = -(-sq // 128) * 128
    fused, n_split, floats = fa.bwd_plan(bh, sq, sk, torch.bfloat16)
    need = 2 * bh * pad
    if fused:
        need += bh * pad * 64
    elif n_split > 1:
        tile = 64 if sq <= 64 else 128
        need += n_split * bh * (-(-sq // tile) * tile) * 64
    assert floats >= need
    assert fa.bwd_plan(bh, sq, sk, torch.float32)[2] == bh * sq
