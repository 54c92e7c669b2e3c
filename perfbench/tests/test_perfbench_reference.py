"""The plain reference against the port at tiny widths on the CPU, in
float32, on one set of seeded weights: model by model, and the host
stages exactly."""

import numpy as np
import pytest
import torch

from perfbench.lib import inputs, weights
from perfbench.reference import mesh as M
from perfbench.reference import nets, pipelines

TINY = dict(feat_dim=48, tokens=4, pcd_layers=1, n_alternating_layers=2,
            head_dim=12, image_size=28, patch_size=14, dino_depth=1,
            dino_heads=3, point_hidden=48, frames=3, num_shape_samples=64)


@pytest.fixture(autouse=True)
def exact_gelu():
    nets.PRECISION.update(mode="f32", gelu="none")
    yield
    nets.PRECISION.update(mode="f32", gelu="tanh")


def close(a, b, tol=2e-5):
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    assert ((a - b).abs().max() / b.abs().max()).item() < tol


def test_motion_model_matches_the_port():
    from motion324_tpu_torch.config import ModelConfig
    from motion324_tpu_torch.models.motion_model import MotionLatentModel
    sd = weights.draw(lambda: nets.MotionModel(TINY), 3, "cpu", torch.float32)
    port = MotionLatentModel(ModelConfig(**{k: v for k, v in TINY.items()
                                            if k != "num_shape_samples"}), seed=None)
    port.load_state_dict(sd)
    ref = nets.MotionModel(TINY)
    ref.load_state_dict(sd)
    g = torch.Generator().manual_seed(0)
    pts = [torch.rand(1, 64, 3, generator=g) - 0.5 for _ in range(3)]
    verts = [torch.rand(1, 10, 3, generator=g) - 0.5 for _ in range(3)]
    video = torch.rand(1, 3, 28, 28, 3, generator=g)
    with torch.no_grad():
        f_port = port.encode_shape(*pts)
        f_ref = ref.encode_shape(*pts)
        close(f_port, f_ref)
        tok_port = port.encode_video(video, f_port)
        tok_ref = ref.encode_video(video[0], f_ref, 3)
        close(tok_port[0], tok_ref)
        close(port.decode_points(tok_port, *verts)[0],
              ref.decode_points(tok_ref, *verts, frames_per_call=2))


def test_u2net_matches_the_port():
    from motion324_tpu_torch.inference.segmentation import U2Net
    frames = torch.rand(2, 37, 41, 3, generator=torch.Generator().manual_seed(1))
    sd = weights.u2net(5, "cpu", frames, torch.float32)
    port = U2Net().eval()
    port.load_state_dict(sd)
    ref = nets.U2Net()
    ref.load_state_dict(sd)
    with torch.no_grad():
        logit = ref(frames)
        close(port(frames), torch.sigmoid(logit))
    assert abs(logit.median().item()) < 1e-3 and abs(logit.std().item() - 4) < 1e-3


def test_shape_models_match_the_port():
    from motion324_tpu_torch.hy3dgen.dit import Hunyuan3DDiT
    from motion324_tpu_torch.hy3dgen.vae import ShapeVAE
    from motion324_tpu_torch.models.dinov2 import DinoViT
    g = torch.Generator().manual_seed(2)
    cases = [
        (lambda: DinoViT(embed_dim=48, depth=2, num_heads=3, native_grid=2,
                         mlp_type="swiglu"),
         lambda: nets.DinoViT(48, 2, 3, 14, 2, "swiglu"),
         lambda m: m(torch.rand(1, 28, 28, 3, generator=g))),
        (lambda: Hunyuan3DDiT(in_channels=8, context_in_dim=48, hidden_size=48,
                              num_heads=3, depth=2, depth_single_blocks=2),
         lambda: nets.DiT(8, 48, 48, 3, 2, 2),
         lambda m: m(torch.randn(2, 16, 8, generator=g), torch.rand(2, generator=g),
                     torch.randn(2, 5, 48, generator=g))),
        (lambda: ShapeVAE(num_latents=16, embed_dim=8, width=48, heads=3,
                          num_decoder_layers=2),
         lambda: nets.ShapeVAE(8, 48, 3, 2),
         lambda m: m.decode(torch.randn(1, 16, 8, generator=g))),
    ]
    for make_port, make_ref, call in cases:
        sd = weights.draw(make_ref, 4, "cpu", torch.float32)
        port, ref = make_port(), make_ref()
        port.load_state_dict(sd)
        ref.load_state_dict(sd)
        state = g.get_state()
        with torch.no_grad():
            a = call(port)
            g.set_state(state)
            b = call(ref)
        close(a, b)


def test_mesh_inputs_match_the_port_exactly(tmp_path):
    from motion324_tpu_torch.inference.pipeline import prepare_mesh_inputs
    from motion324_tpu_torch.io.mesh import load_mesh
    v, f, uv = inputs.uv_sphere(800, 9)
    tex = inputs.texture(9, 64)
    path = str(tmp_path / "m.glb")
    inputs.write_textured_glb(path, v, f, uv, tex)
    mesh = load_mesh(path)
    assert np.array_equal(mesh.vertices, v) and np.array_equal(mesh.faces, f)
    assert np.array_equal(mesh.uv, uv)
    assert np.array_equal(mesh.texture, tex.astype(np.float32) / 255.0)
    port, _, norm = prepare_mesh_inputs(mesh, 300)
    base, ref = pipelines.mesh_inputs(v, f, uv, tex, 300, "cpu")
    assert np.array_equal(norm.vertices, base)
    for key, got in zip(("ref_shape_pcd", "ref_shape_normals", "ref_shape_rgbs"),
                        ref["shape"]):
        assert np.array_equal(port[key], got.numpy()), key
    for key, got in zip(("ref_pcd", "ref_normal", "ref_rgb"), ref["verts"]):
        assert np.array_equal(port[key], got.numpy()), key


def test_smoothing_remap_and_glb_reading_match_the_port(tmp_path):
    from motion324_tpu_torch.inference.pipeline import to_blender_coords
    from motion324_tpu_torch.inference.smoothing import smooth_trajectories
    from motion324_tpu_torch.io.glb import export_animated_glb, load_animated_glb
    rng = np.random.default_rng(0)
    trajs = np.cumsum(rng.normal(0, 0.003, (12, 30, 3)), 0).astype(np.float32)
    want = smooth_trajectories(trajs[None], "combined", motion_threshold=0.002,
                               sigma=1.0)[0]
    assert np.array_equal(M.smooth(trajs), want)
    assert np.array_equal(M.to_blender(trajs), to_blender_coords(trajs))
    v, f, _ = inputs.uv_sphere(100, 1)
    v = v[:30]
    f = f[(f < 30).all(1)]
    path = str(tmp_path / "a.glb")
    export_animated_glb(path, v, f, trajs)
    base, faces, frames = M.read_morph_glb(path)
    b2, f2, fr2, _ = load_animated_glb(path)
    assert np.array_equal(base, b2) and np.array_equal(faces, f2)
    assert np.array_equal(frames, fr2)
