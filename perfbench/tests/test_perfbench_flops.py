"""The FLOP counters and the attention bounds against hand counts at both
cells' shapes."""

import json
from pathlib import Path

import pytest
import torch

from perfbench.lib import flops
from perfbench.lib.peaks import PEAK_BYTES, PEAK_FLOPS, bound_s
from perfbench.reference import nets

ROOT = Path(__file__).resolve().parents[1]


def cfg(name):
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def test_clip_flops_match_a_hand_count():
    c = cfg("motion324-dyscene")
    d, dh, t, g, k = 768, 3072, 256, 16, 64
    s, n, ft, p = c["num_shape_samples"], 20164, 324, g * g
    lin = lambda rows, i, o: 2 * rows * i * o
    attn = lambda q, kv, width: 4 * q * kv * width
    block = lambda rows: lin(rows, d, 3 * d) + lin(rows, d, d) + 2 * lin(rows, d, dh)
    # the Fourier basis product (3 -> 24), the embedding and the projection
    feats = lambda rows: lin(rows, 3, 24) + lin(rows, 51, d) + lin(rows, d + 6, d)
    shape = (feats(s) + lin(k, d, d) + 2 * lin(s, d, d) + attn(k, s, d)
             + lin(k, d, d) + 2 * lin(k, d, dh) + 4 * (block(k) + attn(k, k, d)))
    dino = t * (2 * p * 3 * 14 * 14 * d + 12 * (block(257) + attn(257, 257, d)))
    glob = 8 * (block(t * ft) + attn(t * ft, t * ft, d))
    local = 8 * (block(t * ft) + t * attn(ft, ft, d))
    rows = t * n
    decode = (feats(n) + lin(rows, d, d) + 2 * lin(t * k, d, d) + attn(rows, k, d)
              + lin(rows, d, d) + 2 * lin(rows, d, dh) + lin(rows, d, d) + lin(rows, d, 3))
    got = flops.clip_flops(c, t, 224, n)
    assert got["motion"] == shape + dino + glob + local + decode
    # the U2Net by a walk over its convolutions' outputs
    total = []
    with torch.device("meta"):
        net = nets.U2Net()
        hooks = [m.register_forward_hook(
            lambda m, i, o: total.append(2 * o.numel() * m.in_channels
                                         * m.kernel_size[0] * m.kernel_size[1]))
                 for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
        net(torch.empty(t, 224, 224, 3))
    assert got["u2net"] == sum(total)
    assert 2.7e14 < got["u2net"] + got["motion"] < 3.2e14


def test_shape_flops_match_a_hand_count():
    c = cfg("hunyuan3d2-shape")
    H, L, Lc, ld, cd = 1024, 3072, 1369, 64, 1536
    lin = lambda rows, i, o: 2 * rows * i * o
    h = nets.swiglu_hidden(cd)
    assert h == 4096
    cond = lin(Lc, 3 * 14 * 14, cd) + 40 * (
        lin(1370, cd, 3 * cd) + lin(1370, cd, cd) + lin(1370, cd, 2 * h)
        + lin(1370, h, cd) + 4 * 1370 * 1370 * cd)
    B, M = 2, L + Lc
    dbl = (2 * lin(B, H, 6 * H) + lin(B * L, H, 3 * H) + lin(B * Lc, H, 3 * H)
           + 4 * B * M * M * H + lin(B * L, H, H) + lin(B * Lc, H, H)
           + lin(B * L, H, 4 * H) + lin(B * L, 4 * H, H)
           + lin(B * Lc, H, 4 * H) + lin(B * Lc, 4 * H, H))
    sgl = lin(B, H, 3 * H) + lin(B * M, H, 7 * H) + 4 * B * M * M * H + lin(B * M, 5 * H, H)
    fwd = (lin(B * L, ld, H) + lin(B, 256, H) + lin(B, H, H) + lin(B * Lc, cd, H)
           + 16 * dbl + 32 * sgl + lin(B, H, 2 * H) + lin(B * L, H, ld))
    W = 1024
    vae = lin(L, ld, W) + 16 * (lin(L, W, 3 * W) + 4 * L * L * W + lin(L, W, W)
                                + lin(L, W, 4 * W) + lin(L, 4 * W, W))
    got = flops.shape_flops(c)
    assert got == {"conditioner": cond, "denoise": 50 * fwd, "vae_decode": vae}


@pytest.mark.parametrize("calls,want", [
    (lambda: flops.clip_k1_calls(cfg("motion324-dyscene"), 256),
     [(8, 1, 12, 82944, 82944, 64), (1, 1, 12, 64, 16384, 64)]),
    (lambda: flops.shape_k1_calls(cfg("hunyuan3d2-shape")),
     [(40, 1, 24, 1370, 1370, 64), (2400, 2, 16, 4441, 4441, 64),
      (16, 1, 16, 3072, 3072, 64)]),
])
def test_k1_calls_and_their_bound(calls, want):
    got = calls()
    assert got == want
    # the global layer is bound by its operations: 4 * 12 * 82 944^2 * 64 at
    # 989 TFLOP/s; the shape encoder by its bytes
    assert bound_s(1, 12, 82944, 82944) == pytest.approx(
        4 * 12 * 82944 ** 2 * 64 / PEAK_FLOPS["bfloat16"])
    assert bound_s(1, 12, 64, 16384) == pytest.approx(
        2 * 12 * 64 * (2 * 64 + 2 * 16384) / PEAK_BYTES)
    total = sum(c * bound_s(*call[1:]) for c, *call in [(w[0], *w[1:]) for w in got])
    assert total > 0
