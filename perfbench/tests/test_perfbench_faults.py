"""``correct`` comes out false where it must: the control (the plain
reference in float8 put in the program's place) fails a limit, and a run
whose timed path is broken underneath fails it, once for each fault a cell
can have. On the CPU at tiny widths, with the harness's look for a card
skipped; the same control at the cells' own size runs on the card through
``perfbench/calibrate.py``."""

import contextlib

import pytest
import torch

from perfbench.lib import bench

TINY_MOTION = dict(feat_dim=48, tokens=4, pcd_layers=1, n_alternating_layers=2,
                   head_dim=12, image_size=28, dino_depth=1, dino_heads=3,
                   frames=4, decode_frames_chunk=4, num_shape_samples=256)
MOTION_TRAFFIC = dict(frames=4, mesh_faces=200, texture_size=64,
                      calibration_frames=2)
TINY_SHAPE = dict(image_size=28, cond_dim=48, cond_depth=1, cond_heads=3,
                  cond_native_grid=2, dit_hidden=48, dit_heads=3, dit_depth=1,
                  dit_single=1, latent_dim=8, num_latents=16, vae_width=48,
                  vae_heads=3, vae_layers=1, steps=3)


def run(cell, **kw):
    if cell == "motion-clip256":
        kw.update(config_override=TINY_MOTION, params_override=MOTION_TRAFFIC)
    else:
        kw.update(config_override=TINY_SHAPE)
    return bench.run_cell(cell, 2 ** 31 + 17, 0.0, False, 0.0, device="cpu", **kw)


def over(result):
    """The compared numbers that are over their limits."""
    return [k for k, v in result["compared"].items() if not v["value"] <= v["limit"]]


@pytest.mark.parametrize("cell", ["motion-clip256", "shape-latents50"])
def test_the_control_is_not_correct(cell):
    r = run(cell, control=True)
    limits = {k: v["limit"] for k, v in r["compared"].items()}
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]


def no_bias(real):
    def forward(self, x):
        return torch.nn.functional.linear(x, self.weight.to(x.dtype))
    return forward


def affine_faults():
    """Faults of a fused epilogue or norm: the linears' biases dropped, a
    norm's scale ignored."""
    from motion324_tpu_torch.models import transformer

    def no_scale(real):
        def forward(self, x):
            return torch.nn.functional.layer_norm(
                x, self.normalized_shape, None,
                None if self.bias is None else self.bias.to(x.dtype), self.eps)
        return forward
    return {"the linears' biases dropped": (transformer.Linear, "forward", no_bias),
            "the LayerNorms' scales ignored": (transformer.LayerNorm, "forward",
                                               no_scale)}


@contextlib.contextmanager
def patched(obj, name, make):
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


def motion_faults():
    import motion324_tpu_torch.inference.pipeline as pipeline
    from motion324_tpu_torch.models.motion_model import MotionLatentModel as M

    def answer_altered(real):
        def export(path, vertices, faces, trajectories, **kw):
            trajectories = trajectories.copy()
            trajectories[-1, 0] += 0.5        # one vertex of the last frame
            return real(path, vertices, faces, trajectories, **kw)
        return export

    def half_the_frames(real):
        def encode(self, video, mesh_feat, *a, **kw):
            half = real(self, video[:, : video.shape[1] // 2], mesh_feat, *a, **kw)
            return torch.cat([half, half], dim=1)
        return encode
    return {
        **affine_faults(),
        "answer altered where it is written": (pipeline, "export_animated_glb",
                                               answer_altered),
        "half the frames left out, the rest repeated": (M, "encode_video",
                                                        half_the_frames),
        "the block stack returns its input unchanged": (
            M, "_stack", lambda real: lambda self, x, t, sp=None: x),
    }


def shape_faults():
    from motion324_tpu_torch.hy3dgen import dit
    from motion324_tpu_torch.hy3dgen.dit import Hunyuan3DDiT
    from motion324_tpu_torch.hy3dgen.shape_pipeline import ShapeGenPipeline

    def half_the_batch(real):
        def forward(self, x, t, cond):
            v = real(self, x[:1], t[:1], cond[:1])
            return torch.cat([v, v])          # the unconditional half left out
        return forward

    def token_altered(real):
        def encode(self, images, view_idxs=None):
            out = real(self, images, view_idxs).clone()
            out[:, 0] = torch.randn_like(out[:, 0]) * out.float().std()
            return out
        return encode

    def no_qk_scale(real):
        def forward(self, x):
            xf = x.float()
            return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-6)).to(x.dtype)
        return forward
    return {
        **affine_faults(),
        "the DiT's QK-norm scale ignored": (dit._RMSNorm, "forward", no_qk_scale),
        "every step returns its state unchanged": (
            Hunyuan3DDiT, "forward",
            lambda real: lambda self, x, t, cond: torch.zeros_like(x, dtype=torch.float32)),
        "half the CFG batch left out": (Hunyuan3DDiT, "forward", half_the_batch),
        "a condition token altered where it is made": (ShapeGenPipeline, "encode_cond",
                                                       token_altered),
    }


@pytest.mark.parametrize("cell,faults", [("motion-clip256", motion_faults),
                                         ("shape-latents50", shape_faults)])
def test_a_broken_timed_path_is_not_correct(cell, faults):
    for name, (obj, attr, make) in faults().items():
        with patched(obj, attr, make):
            r = run(cell)
        assert r["correct"] is False and over(r), (name, r["compared"])
