"""The port's evaluation stack against the JAX package's, on the CPU.

Each module is held to its JAX counterpart on seeded numpy inputs: the
geometry metrics exactly (the same numpy and scipy code, the same surface
samples); the protocol's resize (the port's INTER_AREA against cv2's) to
5e-7 and PSNR / SSIM / the Fréchet distance to 1e-6 relative; the LPIPS,
I3D, CLIP, DINO and DreamSim towers at small widths, their weights
converted from one source state dict into both, to 1e-4 relative; the
render of an animated mesh at 64^2 in its three modes against JAX's
interpret-mode render: the rasterizer's face ids equal and the colours
within 1e-5. The evaluate CLI and ``golden_eval --mode smoke`` run end to
end on the CPU, their fixed video protocol cut to 32^2 through the library
defaults they call (``small_protocol``).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.evaluation import clip_sim as jcs
from motion324_tpu.evaluation import geometry as jgeo
from motion324_tpu.evaluation import i3d as ji3d
from motion324_tpu.evaluation import render_video as jrv
from motion324_tpu.evaluation import video_metrics as jvm
from motion324_tpu.ops.rasterizer import rasterize as jax_rasterize
from motion324_tpu.utils.torch_convert import convert_lpips
from motion324_tpu_torch import evaluate, golden_eval
from motion324_tpu_torch.evaluation import clip_sim as cs
from motion324_tpu_torch.evaluation import geometry as geo
from motion324_tpu_torch.evaluation import i3d
from motion324_tpu_torch.evaluation import render_video as rv
from motion324_tpu_torch.evaluation import video_metrics as vm
from motion324_tpu_torch.io.glb import export_animated_glb, load_glb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOWER_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's default of one thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want, rel=TOWER_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12), \
        (np.abs(got - want).max(), np.abs(want).max())


@pytest.fixture(scope="module")
def blob():
    return load_glb(os.path.join(ROOT, "examples", "synthetic", "blob.glb"))


def _animate(verts, t, seed):
    r = np.random.RandomState(seed)
    phase = r.rand(3) * 6
    return np.stack([verts * (1 + 0.15 * np.sin(i + phase))
                     + 0.05 * i * r.randn(3) for i in range(t)]).astype(np.float32)


def _video(seed, t=6, hw=40):
    return np.random.RandomState(seed).rand(t, hw, hw, 3).astype(np.float32)


# --------------------------------------------------------------------------- #
# geometry
# --------------------------------------------------------------------------- #
def test_geometry_matches_jax_exactly(blob):
    v, f = blob["vertices"], blob["faces"]
    gt, pred = _animate(v, 3, 0), _animate(v * 1.02, 3, 1)
    a, b = gt[0], pred[1]
    for fn in ("chamfer_distance", "fscore"):
        assert getattr(geo, fn)(a, b) == getattr(jgeo, fn)(a, b)
    assert geo.voxel_iou(a, b, 64) == jgeo.voxel_iou(a, b, 64)
    assert (geo.voxel_iou(a, b, 64, faces1=f, faces2=f)
            == jgeo.voxel_iou(a, b, 64, faces1=f, faces2=f))
    for x, y in zip(geo.icp_align(b, a), jgeo.icp_align(b, a)):
        np.testing.assert_array_equal(x, y)
    got = geo.evaluate_sequence(gt, f, pred, f, num_points=2000)
    want = jgeo.evaluate_sequence(gt, f, pred, f, num_points=2000)
    assert got == want


# --------------------------------------------------------------------------- #
# video metrics
# --------------------------------------------------------------------------- #
def test_protocol_and_pixel_metrics_match_jax():
    frames = _video(2, t=5, hw=48)
    got = vm.prepare_video(frames, size=32, min_frames=12)
    want = jvm.prepare_video(frames, size=32, min_frames=12)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    for a, b in zip(vm.split_subvideos(want, 8), jvm.split_subvideos(want, 8)):
        np.testing.assert_array_equal(a, b)
    x, y = want[0], want[3]
    for fn in ("psnr", "ssim"):
        np.testing.assert_allclose(getattr(vm, fn)(x, y),
                                   getattr(jvm, fn)(x, y), rtol=1e-6)
    r = np.random.RandomState(3)
    f1, f2 = r.randn(12, 6), r.randn(12, 6) + 0.3
    np.testing.assert_allclose(vm.frechet_distance(f1, f2),
                               jvm.frechet_distance(f1, f2), rtol=1e-6)


def _vgg_source(seed=4):
    """A torchvision ``vgg16.features`` state dict and ``lpips`` heads."""
    r = np.random.RandomState(seed)
    sd, c_in, idx = {}, 3, 0
    for spec in vm.LPIPSVGG.VGG_CFG:
        if spec == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = (r.randn(spec, c_in, 3, 3) * np.sqrt(
            2.0 / (9 * c_in))).astype(np.float32)
        sd[f"features.{idx}.bias"] = (0.1 * r.randn(spec)).astype(np.float32)
        c_in, idx = spec, idx + 2
    lins = {f"lin{i}.model.1.weight": r.randn(1, c, 1, 1).astype(np.float32)
            for i, c in enumerate((64, 128, 256, 512, 512))}
    return sd, lins


def test_lpips_matches_jax():
    vgg, lins = _vgg_source()
    want_model = jvm.LPIPSVGG(params=convert_lpips(lins, vgg))
    model = vm.LPIPSVGG(vgg, [lins[f"lin{i}.model.1.weight"] for i in range(5)])
    a, b = _video(5, t=2, hw=32), _video(6, t=2, hw=32)
    _rel(vm.lpips_distance(a, b, model), jvm.lpips_distance(a, b, want_model))
    assert vm.lpips_distance(a, a, model) == pytest.approx(0.0, abs=1e-6)


def _i3d_flax(sd: dict) -> dict:
    """The JAX I3D's variables from the port's state dict."""
    params, stats = {}, {}
    leaf = {"weight": "kernel", "bias": "bias"}
    for key, v in sd.items():
        *path, name = key.split(".")
        v = v.numpy()
        if path[-1] == "bn":
            if name == "num_batches_tracked":
                continue
            tree, name = ((stats, {"running_mean": "mean",
                                   "running_var": "var"}[name])
                          if name.startswith("running") else
                          (params, {"weight": "scale", "bias": "bias"}[name]))
        else:
            tree, name = params, leaf[name]
            if name == "kernel":
                v = v.transpose(2, 3, 4, 1, 0)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = v
    return {"params": params, "batch_stats": stats}


def test_i3d_features_and_fvd_match_jax():
    model = i3d.I3D(seed=0)
    r = np.random.RandomState(7)
    with torch.no_grad():   # non-trivial inference-mode batch norms
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                n = m.num_features
                for t, v in ((m.weight, 0.5 + r.rand(n)), (m.bias, 0.1 * r.randn(n)),
                             (m.running_mean, 0.1 * r.randn(n)),
                             (m.running_var, 0.5 + r.rand(n))):
                    t.copy_(torch.from_numpy(v))
    fn = i3d.i3d_feature_fn(model=model, size=32, device="cpu")
    want_fn = ji3d.i3d_feature_fn(params=_i3d_flax(model.state_dict()), size=32)
    videos = [_video(10 + i, t=8) for i in range(3)]
    feats = [fn(v) for v in videos]
    for got, v in zip(feats, videos):
        _rel(got, want_fn(v))
    other = [v * 0.9 for v in videos]
    np.testing.assert_allclose(
        vm.compute_fvd(videos, other, fn),
        jvm.compute_fvd(videos, other, fn),
        rtol=1e-6)


SMALL_CLIP = dict(hidden=64, intermediate=128, layers=2, heads=4,
                  image_size=32, patch=8, proj_dim=48)
SMALL_DINO = dict(hidden=64, intermediate=128, layers=2, heads=4,
                  image_size=32, patch=16)


def _hf_clip(quick_gelu: bool, seed: int) -> dict:
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection
    torch.manual_seed(seed)
    c = SMALL_CLIP
    model = CLIPVisionModelWithProjection(CLIPVisionConfig(
        hidden_size=c["hidden"], intermediate_size=c["intermediate"],
        num_hidden_layers=c["layers"], num_attention_heads=c["heads"],
        image_size=c["image_size"], patch_size=c["patch"],
        projection_dim=c["proj_dim"],
        hidden_act="quick_gelu" if quick_gelu else "gelu"))
    return model.state_dict()


def _dino_source(seed: int) -> dict:
    c, r = SMALL_DINO, np.random.RandomState(seed)
    h, n = c["hidden"], (c["image_size"] // c["patch"]) ** 2 + 1
    w = lambda *s: (r.randn(*s) / np.sqrt(s[-1])).astype(np.float32)
    b = lambda n_: (0.1 * r.randn(n_)).astype(np.float32)
    sd = {"cls_token": w(1, 1, h), "pos_embed": w(1, n, h),
          "patch_embed.proj.weight": w(h, 3, c["patch"], c["patch"]),
          "patch_embed.proj.bias": b(h), "norm.weight": 1 + b(h),
          "norm.bias": b(h)}
    for i in range(c["layers"]):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": 1 + b(h), f"{p}.norm1.bias": b(h),
                   f"{p}.attn.qkv.weight": w(3 * h, h),
                   f"{p}.attn.qkv.bias": b(3 * h),
                   f"{p}.attn.proj.weight": w(h, h), f"{p}.attn.proj.bias": b(h),
                   f"{p}.norm2.weight": 1 + b(h), f"{p}.norm2.bias": b(h),
                   f"{p}.mlp.fc1.weight": w(c["intermediate"], h),
                   f"{p}.mlp.fc1.bias": b(c["intermediate"]),
                   f"{p}.mlp.fc2.weight": w(h, c["intermediate"]),
                   f"{p}.mlp.fc2.bias": b(h)})
    return sd


def _clip_pair(quick_gelu: bool, seed: int, projection: bool = True):
    sd = _hf_clip(quick_gelu, seed)
    if not projection:
        sd.pop("visual_projection.weight")
    jcfg = jcs.CLIPVisionCfg(**SMALL_CLIP, quick_gelu=quick_gelu)
    cfg = cs.CLIPVisionCfg(**SMALL_CLIP, quick_gelu=quick_gelu)
    return (cs.CLIPVisionTower(cfg, state_dict=sd),
            jcs.CLIPVisionTower(jcfg, params=jcs.convert_clip_vision(sd, jcfg)))


def _dino_pair(seed: int):
    sd = _dino_source(seed)
    return (cs.DINOTower(cs.DINOCfg(**SMALL_DINO), state_dict=sd),
            jcs.DINOTower(jcs.DINOCfg(**SMALL_DINO),
                          params=jcs.convert_dino_vit(sd, jcs.DINOCfg(**SMALL_DINO))))


@pytest.mark.parametrize("tower", ["clip_quick_gelu", "clip_gelu", "dino"])
def test_towers_match_jax(tower):
    port, jax_tower = (_dino_pair(8) if tower == "dino"
                       else _clip_pair(tower == "clip_quick_gelu", 9))
    images = _video(11, t=2, hw=32)
    _rel(port.embed(images), jax_tower(images))


def test_clip_similarity_and_dreamsim_match_jax():
    clip, jclip = _clip_pair(True, 12)
    a, b = _video(13, t=3), _video(14, t=3)
    np.testing.assert_allclose(cs.clip_similarity(a, b, tower=clip),
                               jcs.clip_similarity(a, b, tower=jclip),
                               rtol=TOWER_REL)
    pairs = [_dino_pair(15), _clip_pair(True, 16, projection=False),
             _clip_pair(False, 17, projection=False)]
    port = cs.DreamSim([p for p, _ in pairs])
    want = jcs.DreamSim([j for _, j in pairs])
    np.testing.assert_allclose(port(a, b), want(a, b), rtol=TOWER_REL)
    assert port(a, a) == pytest.approx(0.0, abs=1e-6)


def test_dreamsim_real_ensemble_is_the_released_architecture():
    """The three full-width towers hold the parameters of the JAX ones,
    shape for shape (JAX's traced with ``eval_shape``)."""
    towers = cs.DreamSim.real_ensemble().towers
    jax_cfgs = [jcs.DINOCfg(), jcs.DreamSim.CLIP_B32, jcs.DreamSim.OPEN_CLIP_B32]
    for port, cfg in zip(towers, jax_cfgs):
        cls = jcs.DINOTower if isinstance(cfg, jcs.DINOCfg) else jcs.CLIPVisionTower
        net = cls(cfg, params={})._net
        shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 224, 224, 3)))
        want = sorted(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
        got = sorted(p.numel() for p in port.parameters())
        assert got == want


# --------------------------------------------------------------------------- #
# render
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["texture", "vertex_colors", "shaded"])
def test_render_matches_jax_interpret(blob, mode, monkeypatch):
    frames = _animate(blob["vertices"], 3, 20)
    r = np.random.RandomState(21)
    kw = {"texture": dict(uv=blob["uv"], texture=r.rand(16, 16, 3).astype(np.float32)),
          "vertex_colors": dict(vertex_colors=blob["vertex_colors"]),
          "shaded": {}}[mode]
    calls = []
    real = rv.rasterize

    def spy(pos, faces, w, h):
        out = real(pos, faces, w, h)
        calls.append((pos.numpy(), out[0].numpy()))
        return out
    monkeypatch.setattr(rv, "rasterize", spy)
    got = rv.render_animated_mesh(frames, blob["faces"], resolution=64,
                                  device="cpu", **kw)
    want = jrv.render_animated_mesh(frames, blob["faces"], resolution=64,
                                    interpret=True, **kw)
    assert got.shape == want.shape == (3, 64, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for pos, find in calls if mode == "texture" else calls[:1]:
        jfind, _ = jax_rasterize(pos, blob["faces"].astype(np.int32), 64, 64,
                                 interpret=True)
        np.testing.assert_array_equal(find, np.asarray(jfind))
        assert 0.05 < (find > 0).mean() < 0.95


# --------------------------------------------------------------------------- #
# CLIs
# --------------------------------------------------------------------------- #
@pytest.fixture
def small_protocol(monkeypatch):
    """The CLIs' fixed video protocol (512^2 frames reflect-padded to 32,
    I3D at 224^2) cut to 32^2, 8 frames and I3D at 32^2 through the library
    defaults the CLIs call: at full size the towers cost minutes a pair on
    one CPU thread."""
    monkeypatch.setattr(vm, "prepare_video", functools.partial(
        vm.prepare_video, size=32, min_frames=8))
    monkeypatch.setattr(i3d, "i3d_feature_fn", functools.partial(
        i3d.i3d_feature_fn, size=32))


def test_evaluate_cli_geometry_and_video(blob, tmp_path, small_protocol):
    v, f = blob["vertices"], blob["faces"]
    gt, pred = _animate(v, 3, 30), _animate(v, 3, 31)
    paths = {}
    for name, frames in (("gt", gt), ("pred", pred)):
        paths[name] = str(tmp_path / f"{name}.glb")
        export_animated_glb(paths[name], v, f, frames)
    out = tmp_path / "geo"
    assert evaluate.main(["--mode", "geometry", "--gt-paths", paths["gt"],
                          "--result-paths", paths["pred"], "--output", str(out),
                          "--num-points", "2000"]) == 0
    from motion324_tpu_torch.io.glb import load_animated_glb
    _, gf, gfr, _ = load_animated_glb(paths["gt"])
    _, pf, pfr, _ = load_animated_glb(paths["pred"])
    want = jgeo.evaluate_sequence(gfr, gf, pfr, pf, num_points=2000)
    summary = json.loads((out / "summary.json").read_text())
    assert summary["mean"] == {k: want[k] for k in ("chamfer", "fscore", "iou")}

    vids = {}
    for i, seed in enumerate((40, 41, 42, 43)):
        vids[i] = str(tmp_path / f"clip{i}.npy")
        np.save(vids[i], (_video(seed) * 255).astype(np.uint8))
    out = tmp_path / "video"
    assert evaluate.main(["--mode", "video", "--gt-paths", vids[0], vids[1],
                          "--result-paths", vids[2], vids[1], "--output",
                          str(out), "--device", "cpu"]) == 0
    from motion324_tpu_torch.inference.pipeline import load_video
    recs = [json.loads((out / f"clip{i}.json").read_text()) for i in (2, 1)]
    for rec, (g, p) in zip(recs, ((vids[0], vids[2]), (vids[1], vids[1]))):
        gv = vm.prepare_video(load_video(g), size=32, min_frames=8)
        pv = vm.prepare_video(load_video(p), size=32, min_frames=8)
        np.testing.assert_allclose(
            rec["ssim"], np.mean([jvm.ssim(x, y) for x, y in zip(gv, pv)]),
            rtol=1e-6)
        assert rec["untrained_tower"] == ["clip_sim", "dreamsim", "lpips"]
    summary = json.loads((out / "summary.json").read_text())
    assert summary["untrained_tower"] == ["clip_sim", "dreamsim", "lpips", "fvd"]
    assert np.isfinite(summary["mean"]["fvd"]) and summary["pairs"] == 2
    assert recs[1]["psnr"] == float("inf") and recs[1]["lpips"] == 0.0
    assert recs[0]["lpips"] > 0 and recs[0]["dreamsim"] > 0


def test_golden_eval_smoke_on_the_cpu(tmp_path, small_protocol):
    assert golden_eval.main(["--mode", "smoke", "--output", str(tmp_path),
                             "--device", "cpu"]) == 0
    report = json.loads((tmp_path / "golden_eval.json").read_text())
    assert report["mode"] == "smoke" and report["weights_root"] is None
    assert list(report["configs"]) == ["chili", "wolf", "tiger", "long", "train"]
    for name in ("chili", "wolf", "tiger", "long"):
        cfg = report["configs"][name]
        assert cfg["status"] == "ok", cfg
        assert cfg["weights"] == "random"
        assert os.path.exists(cfg["result_glb"]) and os.path.exists(cfg["render"])
        assert np.load(cfg["render"]).shape[1:] == (64, 64, 3)
        assert set(cfg["metrics"]["mean"]) == {"psnr", "ssim", "lpips",
                                               "clip_sim", "dreamsim"}
    train = report["configs"]["train"]
    assert train["status"] == "ok" and train["samples_per_s"] > 0
