"""The port's U2Net, ISNet, segmentation and preprocessing against the JAX
package, on the CPU in f32.

The same weights on both sides: a state dict in the public U-2-Net / DIS
layout goes through the JAX package's ``convert_u2net`` / ``convert_isnet``,
and the port loads it directly. Image sizes are odd, so that the SAME max
pooling rounds up (40 -> 20 -> 10 -> 5 -> 3 -> 2, 27 -> 14 -> 7 -> 4 -> 2
-> 1) and the upsampling goes back through sizes that are not powers of
two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.inference import preprocess as jax_pre
from motion324_tpu.inference import segmentation as jax_seg
from motion324_tpu.utils.torch_convert import convert_isnet, convert_u2net
from motion324_tpu_torch.inference import preprocess
from motion324_tpu_torch.inference.segmentation import (
    ISNet, U2Net, segment_frames, threshold_segment)
from motion324_tpu_torch.utils.convert import (isnet_params_from_jax,
                                               u2net_params_from_jax)

# f32 on both sides through 100-odd convolutions; the probabilities agree
# to ~1e-6, and a mask pixel flips only within that distance of the
# threshold (none does on these inputs)
PROB_TOL = 1e-5
# the area resize: the port's weights against cv2's
# (tests/test_torch_paint_render.py reads 1.8e-7)
RESIZE_TOL = 1e-6

TINY_ISNET = dict(mids=(4, 4, 6, 6, 8, 8), outs=(8, 8, 12, 12, 16, 16),
                  dec_mids=(4, 4, 6, 6, 8), dec_outs=(8, 8, 12, 12, 16), stem=8)


def _rebn(sd, rng, name, cin, cout, conv="conv_s1", bn="bn_s1"):
    """A conv + BatchNorm in the public layout, with running statistics and
    affine parameters away from the identity."""
    sd[f"{name}.{conv}.weight"] = rng.randn(cout, cin, 3, 3).astype("f") * 0.05
    sd[f"{name}.{conv}.bias"] = rng.randn(cout).astype("f") * 0.05
    sd[f"{name}.{bn}.weight"] = (1 + 0.2 * rng.randn(cout)).astype("f")
    sd[f"{name}.{bn}.bias"] = (0.1 * rng.randn(cout)).astype("f")
    sd[f"{name}.{bn}.running_mean"] = (0.1 * rng.randn(cout)).astype("f")
    sd[f"{name}.{bn}.running_var"] = (0.5 + rng.rand(cout)).astype("f")


def _u2net_torch_sd(rng):
    """State dict with the exact public U-2-Net naming/shapes (full size).
    The fixture of tests/test_torch_convert.py, with BatchNorm statistics
    drawn at random."""
    sd = {}

    def rebn(name, cin, cout):
        _rebn(sd, rng, name, cin, cout)

    def rsu(name, height, cin, mid, cout):
        rebn(f"{name}.rebnconvin", cin, cout)
        rebn(f"{name}.rebnconv1", cout, mid)
        for i in range(2, height):
            rebn(f"{name}.rebnconv{i}", mid, mid)
        rebn(f"{name}.rebnconv{height}", mid, mid)
        rebn(f"{name}.rebnconv{height - 1}d", mid * 2, mid)
        for i in range(height - 2, 1, -1):
            rebn(f"{name}.rebnconv{i}d", mid * 2, mid)
        rebn(f"{name}.rebnconv1d", mid * 2, cout)

    def rsu4f(name, cin, mid, cout):
        rebn(f"{name}.rebnconvin", cin, cout)
        rebn(f"{name}.rebnconv1", cout, mid)
        for i in (2, 3, 4):
            rebn(f"{name}.rebnconv{i}", mid, mid)
        rebn(f"{name}.rebnconv3d", mid * 2, mid)
        rebn(f"{name}.rebnconv2d", mid * 2, mid)
        rebn(f"{name}.rebnconv1d", mid * 2, cout)

    rsu("stage1", 7, 3, 32, 64)
    rsu("stage2", 6, 64, 32, 128)
    rsu("stage3", 5, 128, 64, 256)
    rsu("stage4", 4, 256, 128, 512)
    rsu4f("stage5", 512, 256, 512)
    rsu4f("stage6", 512, 256, 512)
    rsu4f("stage5d", 1024, 256, 512)
    rsu("stage4d", 4, 1024, 128, 256)
    rsu("stage3d", 5, 512, 64, 128)
    rsu("stage2d", 6, 256, 32, 64)
    rsu("stage1d", 7, 128, 16, 64)
    for i, c in zip(range(1, 7), (64, 64, 128, 256, 512, 512)):
        sd[f"side{i}.weight"] = rng.randn(1, c, 3, 3).astype("f") * 0.05
        sd[f"side{i}.bias"] = np.zeros(1, "f")
    sd["outconv.weight"] = rng.randn(1, 6, 1, 1).astype("f") * 0.2
    sd["outconv.bias"] = np.zeros(1, "f")
    return sd


def _isnet_torch_sd(rng, mids, outs, dec_mids, dec_outs, stem):
    """A DIS ISNetDIS state dict (stem ``conv_in.{conv,bn}``, the U2Net
    stages, ``side1``) at the given channels."""
    sd = {}
    _rebn(sd, rng, "conv_in", 3, stem, conv="conv", bn="bn")
    heights = (7, 6, 5, 4)
    cin = stem
    for i, h in enumerate(heights):
        _rsu(sd, rng, f"stage{i + 1}", h, cin, mids[i], outs[i])
        cin = outs[i]
    _rsu4f(sd, rng, "stage5", outs[3], mids[4], outs[4])
    _rsu4f(sd, rng, "stage6", outs[4], mids[5], outs[5])
    _rsu4f(sd, rng, "stage5d", outs[5] + outs[4], dec_mids[4], dec_outs[4])
    for i, h in ((3, 4), (2, 5), (1, 6), (0, 7)):
        _rsu(sd, rng, f"stage{i + 1}d", h, dec_outs[i + 1] + outs[i],
             dec_mids[i], dec_outs[i])
    sd["side1.weight"] = rng.randn(1, dec_outs[0], 3, 3).astype("f") * 0.3
    sd["side1.bias"] = np.zeros(1, "f")
    return sd


def _rsu(sd, rng, name, height, cin, mid, cout):
    _rebn(sd, rng, f"{name}.rebnconvin", cin, cout)
    _rebn(sd, rng, f"{name}.rebnconv1", cout, mid)
    for i in range(2, height + 1):
        _rebn(sd, rng, f"{name}.rebnconv{i}", mid, mid)
    for i in range(height - 1, 1, -1):
        _rebn(sd, rng, f"{name}.rebnconv{i}d", mid * 2, mid)
    _rebn(sd, rng, f"{name}.rebnconv1d", mid * 2, cout)


def _rsu4f(sd, rng, name, cin, mid, cout):
    _rebn(sd, rng, f"{name}.rebnconvin", cin, cout)
    _rebn(sd, rng, f"{name}.rebnconv1", cout, mid)
    for i in (2, 3, 4):
        _rebn(sd, rng, f"{name}.rebnconv{i}", mid, mid)
    for i in (3, 2):
        _rebn(sd, rng, f"{name}.rebnconv{i}d", mid * 2, mid)
    _rebn(sd, rng, f"{name}.rebnconv1d", mid * 2, cout)


def _torch_sd(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _load(model, sd):
    """Load a public-layout numpy state dict; every key must be used."""
    missing, unexpected = model.load_state_dict(_torch_sd(sd), strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked")
                                  for k in missing), (missing, unexpected)
    return model.eval()


@pytest.fixture(scope="module")
def u2net_sd():
    return _u2net_torch_sd(np.random.RandomState(0))


@pytest.fixture(scope="module")
def isnet_sd():
    return _isnet_torch_sd(np.random.RandomState(1), **TINY_ISNET)


def _frames(seed, t=2, h=40, w=27):
    return np.random.RandomState(seed).rand(t, h, w, 3).astype(np.float32)


def test_u2net_full_width_matches_jax(u2net_sd):
    x = _frames(2)
    want = np.asarray(jax.jit(jax_seg.U2Net().apply)(convert_u2net(u2net_sd),
                                                     jnp.asarray(x)))
    with torch.no_grad():
        got = _load(U2Net(), u2net_sd)(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 40, 27) and got.dtype == torch.float32
    assert 0.02 < want.std()   # the probabilities vary across the image
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_TOL, rtol=0)


@pytest.mark.parametrize("h,w", [(40, 27), (33, 64)])
def test_isnet_matches_jax(isnet_sd, h, w):
    x = _frames(3, h=h, w=w)
    want = np.asarray(jax.jit(jax_seg.ISNet(**TINY_ISNET).apply)(
        convert_isnet(isnet_sd), jnp.asarray(x)))
    with torch.no_grad():
        got = _load(ISNet(**TINY_ISNET), isnet_sd)(torch.from_numpy(x))
    assert got.shape == want.shape == (2, h, w)
    np.testing.assert_allclose(got.numpy(), want, atol=PROB_TOL, rtol=0)


def test_batchnorm_stays_in_inference_mode(isnet_sd):
    """A network left in training mode still normalises with the running
    statistics, as the JAX modules do (use_running_average=True)."""
    x = torch.from_numpy(_frames(4))
    net = _load(ISNet(**TINY_ISNET), isnet_sd)
    with torch.no_grad():
        want = net(x)
        got = net.train()(x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("which", ["u2net", "isnet"])
def test_params_from_jax_round_trip(u2net_sd, isnet_sd, which):
    """public layout -> JAX convert -> *_params_from_jax gives back every
    tensor exactly, and the port's network loads the result strictly."""
    sd, convert, back, net = {
        "u2net": (u2net_sd, convert_u2net, u2net_params_from_jax, U2Net()),
        "isnet": (isnet_sd, convert_isnet, isnet_params_from_jax,
                  ISNet(**TINY_ISNET))}[which]
    got = back(jax.tree.map(np.asarray, convert(sd)))
    assert set(got) - set(sd) == {k for k in got if k.endswith("num_batches_tracked")}
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    net.load_state_dict(got)   # strict


def test_threshold_segment_matches_jax():
    x = 0.1 + 0.02 * _frames(5, t=3, h=32, w=30)
    x[:, 10:20, 8:25] += 0.8
    got = threshold_segment(x)
    want = jax_seg.threshold_segment(x)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_segment_frames_matches_jax(isnet_sd):
    """With weights (5 frames in batches of 2) and without."""
    x = _frames(6, t=5, h=33, w=40)
    want = jax_seg.segment_frames(x, params=convert_isnet(isnet_sd),
                                  model=jax_seg.ISNet(**TINY_ISNET), batch=2,
                                  threshold=0.5)
    got = segment_frames(x, params=_torch_sd(isnet_sd),
                         model=ISNet(**TINY_ISNET), batch=2, threshold=0.5,
                         device="cpu")
    assert got.shape == (5, 33, 40) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1
    np.testing.assert_array_equal(segment_frames(x), jax_seg.segment_frames(x))


def test_global_bbox_and_crop_match_jax():
    masks = np.zeros((3, 50, 41), np.float32)
    masks[0, 10:20, 5:9] = 1
    masks[2, 30:44, 20:38] = 1
    bbox = preprocess.global_bbox(masks)
    assert bbox == jax_pre.global_bbox(masks)
    assert preprocess.global_bbox(masks * 0) == (0, 50, 0, 41)
    frame = np.random.RandomState(7).rand(50, 41, 3).astype(np.float32)
    for size in (48, 64):
        got = preprocess.crop_and_center(frame, bbox, size)
        want = jax_pre.crop_and_center(frame, bbox, size)
        np.testing.assert_allclose(got, want, atol=RESIZE_TOL)
    u8 = (frame * 255).astype(np.uint8)
    got = preprocess.crop_and_center(u8, bbox, 32)
    want = jax_pre.crop_and_center(u8, bbox, 32)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("weights", [False, True], ids=["border", "isnet"])
def test_preprocess_video_frames_matches_jax(isnet_sd, weights):
    x = _frames(8, t=3, h=44, w=36) * 0.2
    x[:, 12:30, 10:22] = 0.9
    kw = {}
    if weights:
        jkw = dict(params=convert_isnet(isnet_sd),
                   model=jax_seg.ISNet(**TINY_ISNET), alpha_threshold=0.5)
        kw = dict(params=_torch_sd(isnet_sd), model=ISNet(**TINY_ISNET),
                  alpha_threshold=0.5, device="cpu")
    else:
        jkw = {}
    want = jax_pre.preprocess_video_frames(x, size=64, **jkw)
    got = preprocess.preprocess_video_frames(x, size=64, **kw)
    assert got[2] == want[2]
    assert got[0].shape == (3, 64, 64, 3) and got[1].shape == (3, 64, 64)
    np.testing.assert_allclose(got[0], want[0], atol=RESIZE_TOL)
    np.testing.assert_allclose(got[1], want[1], atol=RESIZE_TOL)
