"""The port's shape generation against the JAX package, on the CPU in f32 at
tiny widths: the DINOv2 SwiGLU conditioner, the DiT, the ShapeVAE, the
volume decoders, the native helpers, postprocessing, the pipeline's stages
(single view and multiview), the released-checkpoint loader and the CLI.

Weights come from the JAX package's own initialisers (LayerScale redrawn
from U(0.1, 1) so that the DINOv2 blocks count) and are carried over by
``shape_params_from_jax``; inputs are drawn with numpy from fixed seeds.
Unless a test says otherwise the two sides do the same f32 arithmetic in
another order: 1e-5 of the largest value.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.hy3dgen import volume as jvol
from motion324_tpu.hy3dgen.scheduler import flow_match_sigmas
from motion324_tpu.hy3dgen.shape_pipeline import ShapeGenPipeline as JaxPipe
from motion324_tpu_torch.hy3dgen import volume as tvol
from motion324_tpu_torch.hy3dgen.shape_pipeline import ShapeGenPipeline
from motion324_tpu_torch.io.mesh import TriMesh
from motion324_tpu_torch.utils.convert import shape_params_from_jax

DIMS = dict(num_latents=16, latent_dim=8, cond_dim=36, cond_depth=2,
            cond_heads=3, dit_hidden=36, dit_heads=3, dit_depth=2,
            dit_single=2, vae_width=32, vae_heads=4, vae_layers=2,
            image_size=28, cond_mlp_type="swiglu")
REL = 1e-5


def close(got, want, rel=REL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _redraw_layer_scale(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "ls1_gamma" in name or "ls2_gamma" in name:
            return rng.uniform(0.1, 1.0, np.shape(x)).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(conditioner_type):
    jp = JaxPipe.init_random(jax.random.PRNGKey(3), dtype=jnp.float32,
                             conditioner_type=conditioner_type, **DIMS)
    jp.params = _redraw_layer_scale(jp.params, 4)
    tp = ShapeGenPipeline(shape_params_from_jax(jp.params), device="cpu",
                          dtype=torch.float32,
                          conditioner_type=conditioner_type, **DIMS)
    return jp, tp


@pytest.fixture(scope="module")
def pipes():
    return _pair("single")


@pytest.fixture(scope="module")
def pipes_mv():
    return _pair("mv")


def _cond(jp, rng):
    c = rng.standard_normal((1, 5, DIMS["cond_dim"])).astype(np.float32)
    return np.concatenate([c, np.zeros_like(c)])


# --------------------------------------------------------------------------- #
def test_frequency_embed_matches_jax():
    from motion324_tpu.ops.embeddings import frequency_embed as jfe
    from motion324_tpu_torch.ops.embeddings import frequency_embed
    x = np.random.default_rng(0).uniform(-1.01, 1.01, (5, 7, 3)).astype(np.float32)
    for kw in (dict(num_freqs=8), dict(num_freqs=4, logspace=False,
                                        include_input=False, include_pi=False)):
        close(frequency_embed(torch.from_numpy(x), **kw),
              jfe(jnp.asarray(x), **kw))


def test_scheduler_matches_jax():
    from motion324_tpu.hy3dgen import scheduler as js
    from motion324_tpu_torch.hy3dgen import scheduler as ts
    np.testing.assert_array_equal(ts.flow_match_sigmas(50),
                                  js.flow_match_sigmas(50))
    np.testing.assert_array_equal(ts.flow_match_sigmas(7, shift=3.0),
                                  js.flow_match_sigmas(7, shift=3.0))
    np.testing.assert_array_equal(ts.consistency_flow_match_sigmas(5),
                                  js.consistency_flow_match_sigmas(5))


def test_dinov2_swiglu_keep_cls_matches_jax():
    from motion324_tpu.models.dinov2 import DinoViT as JDino
    from motion324_tpu_torch.models.dinov2 import DinoViT
    from motion324_tpu_torch.utils.convert import _dino
    jd = JDino(embed_dim=24, depth=2, num_heads=2, native_grid=3,
               mlp_type="swiglu", keep_cls=True)
    img = np.random.default_rng(1).random((2, 28, 42, 3)).astype(np.float32)
    params = _redraw_layer_scale(jd.init(jax.random.PRNGKey(0), img), 2)
    sd = {}
    _dino(sd, "", params["params"])
    td = DinoViT(embed_dim=24, depth=2, num_heads=2, native_grid=3,
                 mlp_type="swiglu", keep_cls=True)
    td.load_state_dict(sd)
    assert td.blocks[0].mlp.w3.in_features == 64   # ((int(24*4*2/3)+7)//8)*8
    with torch.no_grad():
        out = td(torch.from_numpy(img))
    want = jd.apply(params, img)
    assert out.shape == (2, 1 + 2 * 3, 24)
    # the 3x3 position table resized bicubically to 2x3 in both: the two
    # resizers differ at the 1e-6 level of the table
    close(out, want, rel=1e-4)


def test_dit_matches_jax(pipes):
    jp, tp = pipes
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 8)).astype(np.float32)
    cond = _cond(jp, rng)
    for t in (np.array([0.0, 0.3], np.float32), np.array([0.7, 1.0], np.float32)):
        want = jp.dit.apply(jp.params["dit"], x, t, cond)
        with torch.no_grad():
            got = tp.dit(torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(cond))
        assert got.dtype == torch.float32
        close(got, want)


def test_vae_decode_query_and_topk_match_jax(pipes):
    from motion324_tpu.hy3dgen.vae import ShapeVAE as JVae
    jp, tp = pipes
    rng = np.random.default_rng(6)
    lat = rng.standard_normal((1, 16, 8)).astype(np.float32)
    pts = rng.uniform(-1, 1, (1, 300, 3)).astype(np.float32)
    jproc = jp.vae.apply(jp.params["vae"], lat, method=JVae.decode)
    proc = tp.vae_decode(lat)
    close(proc, jproc)
    close(tp.vae_query(pts, proc), jp.vae.apply(jp.params["vae"], pts, jproc,
                                                method=JVae.query))
    for topk, stride in ((16, 7), (6, 50)):
        want = jp.vae.apply(jp.params["vae"], pts, jproc, topk, stride,
                            method=JVae.query_topk)
        with torch.no_grad():
            got = tp.vae.query_topk(torch.from_numpy(pts), proc, topk, stride)
        close(got, want)


def _sphere(pts, _latents):
    return 0.5 - pts.norm(dim=-1)


def _jsphere(_params, pts, _latents):
    return 0.5 - jnp.linalg.norm(pts, axis=-1)


# the JAX package reads its grids back in f16 (the port keeps f32): values
# of magnitude <= 2 agree to an f16 half-ulp, 2^-10
F16 = 2.0 ** -10


def test_decode_volume_on_a_sphere_matches_jax():
    got, chunks = tvol.decode_volume(_sphere, None, resolution=24, box_v=1.0,
                                     chunk=128)
    want = jvol.decode_volume(_jsphere, None, None, resolution=24, box_v=1.0,
                              chunk=128)
    assert chunks == -(-25 ** 3 // 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=F16)
    np.testing.assert_allclose(got.reshape(-1), 0.5 - np.linalg.norm(
        tvol.make_grid(24, 1.0), axis=-1), atol=1e-6)


def test_hierarchical_on_a_sphere_matches_jax_and_dense():
    dense, _ = tvol.decode_volume(_sphere, None, resolution=32, box_v=1.0,
                                  chunk=128)
    hier, chunks = tvol.decode_volume_hierarchical(
        _sphere, None, resolution=32, box_v=1.0, chunk=128, coarse_factor=4,
        band=0.5)
    jhier = jvol.decode_volume_hierarchical(
        _jsphere, None, None, resolution=32, box_v=1.0, chunk=128,
        coarse_factor=4, band=0.5)
    near = np.abs(dense) < 0.05
    np.testing.assert_allclose(hier[near], dense[near], atol=1e-6)
    np.testing.assert_allclose(hier[near], jhier[near], atol=F16)
    from motion324_tpu_torch import native
    fine = native.trilinear_upsample(tvol.decode_volume(
        _sphere, None, resolution=16, box_v=1.0, chunk=128)[0], 2)
    shell = native.shell_indices(fine, 0.5, 2, 1)
    assert chunks == -(-17 ** 3 // 128) + tvol.refine_chunk_count(len(shell), 128)


@pytest.mark.parametrize("n,want", [(1, 1), (8193, 2), (3 * 8192 + 1, 4),
                                    (64 * 8192, 64), (64 * 8192 + 1, 128),
                                    (6967 * 8192, 6976)])
def test_refinement_chunks_bucket_as_in_jax(n, want):
    assert tvol.refine_chunk_count(n, 8192) == want


def test_volume_decoders_on_a_tiny_vae_match_jax(pipes):
    from motion324_tpu.hy3dgen.vae import ShapeVAE as JVae
    jp, tp = pipes
    lat = np.random.default_rng(7).standard_normal((1, 16, 8)).astype(np.float32)
    jproc = jp.vae.apply(jp.params["vae"], lat, method=JVae.decode)
    proc = tp.vae_decode(lat)

    def jq(params, pts, latents):
        return jp.vae.apply(params, pts, latents, method=JVae.query)

    with torch.no_grad():
        dense, _ = tvol.decode_volume(tp.vae.query, proc, resolution=16,
                                      box_v=1.01, chunk=512)
        scale = np.abs(dense).max()
        np.testing.assert_allclose(
            dense, jvol.decode_volume(jq, jp.params["vae"], jproc, 16, 1.01,
                                      512), rtol=0, atol=F16 * scale)
        band = 0.3 * scale
        hier, _ = tvol.decode_volume_hierarchical(tp.vae.query, proc, 24,
                                                  chunk=512, band=band)
        jhier = jvol.decode_volume_hierarchical(jq, jp.params["vae"], jproc,
                                                24, chunk=512, band=band)
        near = np.abs(hier) < 0.1 * scale
        np.testing.assert_allclose(hier[near], jhier[near], rtol=0,
                                   atol=F16 * scale)
        for topk in (16, 12):
            vdm, _ = tvol.decode_volume_flashvdm(tp.vae, proc, 24, chunk=512,
                                                 band=band, topk=topk)
            jvdm = jvol.decode_volume_flashvdm(jp.vae, jp.params["vae"], jproc,
                                               24, chunk=512, band=band,
                                               topk=topk)
            near = np.abs(vdm) < 0.1 * scale
            np.testing.assert_allclose(vdm[near], jvdm[near], rtol=0,
                                       atol=F16 * scale)
        full, _ = tvol.decode_volume_flashvdm(tp.vae, proc, 24, chunk=512,
                                              band=band, topk=16)
        np.testing.assert_allclose(full, hier, atol=1e-5 * scale)


# --------------------------------------------------------------------------- #
def _sphere_grid(n=40, r=0.6):
    ax = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return r - np.sqrt(x * x + y * y + z * z) + 0.05 * np.sin(7 * x) * np.cos(5 * y)


def test_native_marching_cubes_matches_jax():
    """The JAX package's library is built with -march=native, which may
    fuse multiply-adds: the same faces, vertices within 1e-5."""
    from motion324_tpu import native as jn
    from motion324_tpu_torch import native as tn
    grid = _sphere_grid()
    bounds = ((-1.01,) * 3, (1.01,) * 3)
    v, f = tn.marching_cubes(grid, 0.0, bounds)
    jv, jf = jn.marching_cubes(grid, 0.0, bounds)
    assert len(f) > 1000
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, atol=1e-5)


def test_native_qem_matches_jax(tmp_path):
    """Edge collapse is greedy: a multiply-add fused under the JAX
    package's -march=native build reorders collapses. So the port's copy is
    held exactly against the JAX package's source built with the port's
    flags, and against the JAX package's own library by what decimation
    keeps: the face count and the surface (mean radius within 0.5%)."""
    import ctypes
    import subprocess
    from motion324_tpu import native as jn
    from motion324_tpu_torch import native as tn
    v, f = tn.marching_cubes(_sphere_grid(32))
    a = tn.qem_simplify(v, f, 500)
    assert 0 < len(a[1]) <= 500
    so = tmp_path / "libqem.so"
    subprocess.run(["g++", *tn._FLAGS, "-o", str(so),
                    "motion324_tpu/native/qem_simplify.cpp"], check=True)
    lib = ctypes.CDLL(str(so))
    p = lambda x: x.ctypes.data_as(ctypes.c_void_p)
    vv, ff = np.ascontiguousarray(v), np.ascontiguousarray(f, np.int32)
    ov, of = np.empty_like(vv), np.empty_like(ff)
    nv, nf = ctypes.c_int(0), ctypes.c_int(0)
    assert lib.qem_simplify(p(vv), len(vv), p(ff), len(ff), 500,
                            ctypes.c_float(7.0), p(ov), ctypes.byref(nv),
                            p(of), ctypes.byref(nf)) == 0
    np.testing.assert_array_equal(a[1], of[:nf.value])
    np.testing.assert_allclose(a[0], ov[:nv.value], atol=1e-5)
    b = jn.qem_simplify(v, f, 500)
    assert len(b[1]) == len(a[1])
    radius = lambda x: np.linalg.norm(x - x.mean(0), axis=1).mean()
    assert abs(radius(a[0]) - radius(b[0])) < 5e-3 * radius(b[0])


def test_native_trilinear_and_shell_match_jax_and_numpy():
    from motion324_tpu import native as jn
    from motion324_tpu_torch import native as tn
    coarse = np.random.default_rng(8).standard_normal((9, 9, 9)).astype(np.float32)
    up = tn.trilinear_upsample(coarse, 4)
    np.testing.assert_allclose(up, jn.trilinear_upsample(coarse, 4), atol=1e-5)
    np.testing.assert_allclose(up, tvol._trilinear_numpy(coarse, 4), atol=1e-5)
    np.testing.assert_array_equal(up[::4, ::4, ::4], coarse)
    for sort_grid in (1, 4):
        got = tn.shell_indices(up, 0.3, 2, sort_grid)
        np.testing.assert_array_equal(got, jn.shell_indices(up, 0.3, 2, sort_grid))
        np.testing.assert_array_equal(
            got, tvol._shell_indices_numpy(up, 0.3, 2, sort_grid))


def test_native_build_is_keyed_by_source_and_reused():
    from motion324_tpu_torch import native as tn
    path = tn.build()
    assert path.exists() and path.parent.name == "build"
    assert tn.build() == path


# --------------------------------------------------------------------------- #
CUBE_V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                   [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
CUBE_F = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                   [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                   [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int64)


def test_postprocess_matches_jax():
    from motion324_tpu.hy3dgen import postprocess as jpp
    from motion324_tpu.io.mesh import TriMesh as JMesh
    from motion324_tpu_torch.hy3dgen import postprocess as tpp
    from motion324_tpu_torch import native as tn
    v, f = tn.marching_cubes(_sphere_grid(36))
    v = np.concatenate([v, CUBE_V * 0.05 + 3.0])
    f = np.concatenate([f.astype(np.int64), CUBE_F + len(v) - 8,
                        [[0, 0, 1]]])
    t_mesh, j_mesh = TriMesh(vertices=v, faces=f), JMesh(vertices=v, faces=f)
    for name in ("remove_floaters", "remove_degenerate"):
        a, b = getattr(tpp, name)(t_mesh), getattr(jpp, name)(j_mesh)
        np.testing.assert_array_equal(a.faces, b.faces)
        np.testing.assert_array_equal(a.vertices, b.vertices)
    clean = tpp.remove_degenerate(tpp.remove_floaters(t_mesh))
    assert len(clean.faces) == len(f) - 13
    for method in ("qem", "cluster"):
        a = tpp.reduce_faces(clean, 800, method=method)
        b = jpp.reduce_faces(JMesh(vertices=clean.vertices, faces=clean.faces),
                             800, method=method)
        assert 0 < len(a.faces) <= 800
        np.testing.assert_array_equal(a.faces, b.faces)
        np.testing.assert_allclose(a.vertices, b.vertices, atol=1e-5)


def test_remesh_mesh_roundtrip(tmp_path):
    from motion324_tpu_torch.hy3dgen.postprocess import remesh_mesh
    from motion324_tpu_torch.io.glb import export_glb
    from motion324_tpu_torch.io.mesh import load_mesh
    src, dst = str(tmp_path / "in.glb"), str(tmp_path / "out.glb")
    export_glb(src, CUBE_V, CUBE_F)
    assert len(remesh_mesh(src, dst).faces) == 12
    assert len(load_mesh(dst).faces) == 12
    assert 0 < len(remesh_mesh(src, dst, face_threshold=4,
                               target_faces=8).faces) <= 8


def test_recenter_image_matches_jax():
    from motion324_tpu.hy3dgen import preprocess_image as jpi
    from motion324_tpu_torch.hy3dgen import preprocess_image as tpi
    img = np.zeros((100, 80, 4), np.float32)
    img[20:60, 10:30, 0] = 1.0
    img[20:60, 10:30, 3] = 1.0
    for a, b in zip(tpi.prepare_condition_image(img, 64),
                    jpi.prepare_condition_image(img, 64)):
        np.testing.assert_array_equal(a, b)
    views = {"back": img, "front": img[:, ::-1]}
    for a, b in zip(tpi.prepare_condition_images_mv(views, 28),
                    jpi.prepare_condition_images_mv(views, 28)):
        np.testing.assert_array_equal(a, b)


def test_conditioner_and_wrappers_match_jax():
    """DinoConditioner ([CLS | patches], SwiGLU) and the Single/Dual
    wrappers, whose unconditional embedding is zeros of the conditional
    shape."""
    from motion324_tpu.hy3dgen import conditioner as jc
    from motion324_tpu_torch.hy3dgen import conditioner as tc
    from motion324_tpu_torch.utils.convert import _dino
    kw = dict(embed_dim=24, depth=1, num_heads=2, native_grid=2)
    img = np.random.default_rng(13).random((2, 28, 28, 3)).astype(np.float32)
    jmod = jc.DinoConditioner(**kw)
    params = _redraw_layer_scale(jmod.init(jax.random.PRNGKey(1), img), 5)
    sd = {}
    _dino(sd, "dino", params["params"]["dino"])
    tmod = tc.DinoConditioner(**kw)
    tmod.load_state_dict(sd)
    want = jmod.apply(params, img)
    with torch.no_grad():
        got = tc.SingleImageEncoder(tmod)(torch.from_numpy(img))
        dual = tc.DualImageEncoder(tmod, tmod)(torch.from_numpy(img))
    close(got["main"], want)
    assert got["main"].shape == (2, 5, 24)
    close(dual["additional"], want)
    for cond, un in ((got, tc.SingleImageEncoder.unconditional(got)),
                     (dual, tc.DualImageEncoder.unconditional(dual))):
        assert set(un) == set(cond)
        assert all(torch.count_nonzero(v) == 0 and v.shape == cond[k].shape
                   for k, v in un.items())


def test_view_table_matches_jax():
    from motion324_tpu.hy3dgen.conditioner import (VIEW_SLOTS,
                                                   get_1d_sincos_pos_embed)
    from motion324_tpu_torch.hy3dgen import conditioner as tc
    pos = np.arange(4, dtype=np.float32)
    np.testing.assert_array_equal(tc.get_1d_sincos_pos_embed(36, pos),
                                  get_1d_sincos_pos_embed(36, pos))
    assert tc.VIEW_SLOTS == VIEW_SLOTS


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mv", [False, True], ids=["single", "mv"])
def test_pipeline_stages_match_jax(request, mv):
    jp, tp = request.getfixturevalue("pipes_mv" if mv else "pipes")
    rng = np.random.default_rng(9)
    if mv:
        img = rng.random((1, 3, 28, 28, 3)).astype(np.float32)
        idx = np.array([[0, 2, 3]], np.int32)
        want = jp._encode_cond(jp.params["conditioner"], img, idx)
        got = tp.encode_cond(img, idx)
        assert got.shape == (1, 3 * 5, 36)
    else:
        img = rng.random((1, 28, 28, 3)).astype(np.float32)
        want = jp._encode_cond(jp.params["conditioner"], img)
        got = tp.encode_cond(img)
        assert got.shape == (1, 4, 36)
    close(got, want)
    cond_pair = np.concatenate([np.asarray(want), np.zeros_like(want)])
    lat = rng.standard_normal((1, 16, 8)).astype(np.float32)
    sig = flow_match_sigmas(5)
    want_lat = jp._denoise(jp.params["dit"], lat, cond_pair, sig, 5.0)
    got_lat = tp.denoise(lat, cond_pair, sig, 5.0)
    close(got_lat, want_lat)
    want_proc = jp._vae_decode(jp.params["vae"], np.asarray(want_lat))
    got_proc = tp.vae_decode(np.asarray(want_lat))
    close(got_proc, want_proc)
    pts = rng.uniform(-1, 1, (1, 200, 3)).astype(np.float32)
    close(tp.vae_query(pts, got_proc),
          jp._vae_query(jp.params["vae"], pts, want_proc))


def test_pipeline_call_gives_a_mesh_and_counts_chunks(pipes):
    _, tp = pipes
    img = np.random.default_rng(10).random((40, 30, 4)).astype(np.float32)
    mesh = tp(img, num_inference_steps=3, octree_resolution=20, num_chunks=512,
              recenter=False)
    assert mesh.vertices.ndim == 2 and mesh.faces.dtype == np.int64
    assert np.isfinite(mesh.vertices).all()
    run = tp.last_run
    assert set(run["seconds"]) == {"conditioner", "denoise", "vae_decode",
                                   "volume_decode", "marching_cubes"}
    assert run["query_chunks"] >= -(-17 ** 3 // 512)
    flat = tp(img, num_inference_steps=3, octree_resolution=16,
              num_chunks=512, recenter=False, hierarchical=False)
    assert tp.last_run["query_chunks"] == -(-17 ** 3 // 512)
    assert np.isfinite(flat.vertices).all()


def test_stages_record_their_span_tree(pipes, monkeypatch):
    """With spans on, ``denoise`` is one root with a ``shape.denoise.step``
    child a step; ``__call__``'s five stages are roots whose host seconds
    are ``last_run["seconds"]``, the stage methods' spans inside them."""
    from motion324_tpu_torch.utils import profiling
    _, tp = pipes
    monkeypatch.setattr(profiling, "_ENABLED", True)
    profiling.reset()
    rng = np.random.default_rng(11)
    lat = rng.standard_normal((1, DIMS["num_latents"], DIMS["latent_dim"]))
    tp.denoise(lat.astype(np.float32), _cond(None, rng), flow_match_sigmas(4),
               5.0)
    recs = profiling.spans()
    root, = [r for r in recs if r.parent is None]
    assert root.name == "shape.denoise"
    assert [(r.name, r.parent, r.root) for r in recs if r is not root] == \
        [("shape.denoise.step", root.id, root.id)] * 4
    assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
               for r in recs)
    profiling.reset()
    img = rng.random((40, 30, 4)).astype(np.float32)
    tp(img, num_inference_steps=3, octree_resolution=16, num_chunks=512,
       recenter=False)
    recs = profiling.spans()
    roots = sorted((r for r in recs if r.parent is None), key=lambda r: r.id)
    stages = ["conditioner", "denoise", "vae_decode", "volume_decode",
              "marching_cubes"]
    assert [r.name for r in roots] == [f"shape.call.{k}" for k in stages]
    assert tp.last_run["seconds"] == {k: r.host_s for k, r in zip(stages, roots)}
    kids = {r.name: r.parent for r in recs if r.parent is not None}
    assert kids["shape.encode_cond"] == roots[0].id
    assert kids["shape.denoise"] == roots[1].id
    assert kids["shape.vae_decode"] == roots[2].id
    assert sum(r.name == "shape.denoise.step" for r in recs) == 3


def test_pipeline_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShapeGenPipeline(None, **DIMS)


# --------------------------------------------------------------------------- #
def _hf_dino(rng, c=24, depth=2, grid=2):
    hidden = ((int(c * 4 * 2 / 3) + 7) // 8) * 8
    shapes = {"embeddings.cls_token": (1, 1, c), "embeddings.mask_token": (1, c),
              "embeddings.position_embeddings": (1, 1 + grid * grid, c),
              "embeddings.patch_embeddings.projection.weight": (c, 3, 14, 14),
              "embeddings.patch_embeddings.projection.bias": (c,),
              "layernorm.weight": (c,), "layernorm.bias": (c,)}
    for i in range(depth):
        b = f"encoder.layer.{i}"
        for n in ("norm1", "norm2"):
            shapes[f"{b}.{n}.weight"] = shapes[f"{b}.{n}.bias"] = (c,)
        for n in ("query", "key", "value"):
            shapes[f"{b}.attention.attention.{n}.weight"] = (c, c)
            shapes[f"{b}.attention.attention.{n}.bias"] = (c,)
        shapes[f"{b}.attention.output.dense.weight"] = (c, c)
        shapes[f"{b}.attention.output.dense.bias"] = (c,)
        shapes[f"{b}.layer_scale1.lambda1"] = (c,)
        shapes[f"{b}.layer_scale2.lambda1"] = (c,)
        shapes[f"{b}.mlp.weights_in.weight"] = (2 * hidden, c)
        shapes[f"{b}.mlp.weights_in.bias"] = (2 * hidden,)
        shapes[f"{b}.mlp.weights_out.weight"] = (c, hidden)
        shapes[f"{b}.mlp.weights_out.bias"] = (c,)
    return {f"main_image_encoder.model.{k}":
            torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.2).half()
            for k, s in shapes.items()}


def test_from_hunyuan_ckpt_matches_jax(tmp_path):
    """A tiny checkpoint in the released layout, written with torch.save from
    random arrays: fp16 sub-dicts, the DiT and ShapeVAE under the reference
    names (which the port's modules carry), the VAE with encoder keys that
    the decoder does not use, and an HF DINOv2 SwiGLU conditioner. Both
    packages infer the same dims and compute the same stages."""
    from motion324_tpu.hy3dgen.vae import ShapeVAE as JVae
    from motion324_tpu_torch.hy3dgen.dit import Hunyuan3DDiT
    from motion324_tpu_torch.hy3dgen.vae import ShapeVAE
    rng = np.random.default_rng(11)
    rand = lambda sd: {k: torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.3).half()
        for k, v in sd.items()}
    dit = Hunyuan3DDiT(in_channels=8, context_in_dim=24, hidden_size=32,
                       num_heads=4, depth=2, depth_single_blocks=3)
    vae = ShapeVAE(num_latents=16, embed_dim=8, width=32, heads=4,
                   num_decoder_layers=2)
    vae_sd = rand(vae.state_dict())
    vae_sd["encoder.cross_attn.c_q.weight"] = torch.zeros(32, 32).half()
    path = str(tmp_path / "model.fp16.ckpt")
    torch.save({"model": rand(dit.state_dict()), "vae": vae_sd,
                "conditioner": _hf_dino(rng)}, path)
    kw = dict(num_latents=16, vae_heads=4, cond_heads=3, image_size=28)
    tp = ShapeGenPipeline.from_hunyuan_ckpt(path, device="cpu",
                                            dtype=torch.float32, **kw)
    jp = JaxPipe.from_hunyuan_ckpt(path, dtype=jnp.float32, **kw)
    assert (tp.latent_dim, len(tp.dit.double_blocks),
            len(tp.dit.single_blocks), len(tp.vae.transformer.resblocks),
            len(tp.conditioner.blocks)) == (8, 2, 3, 2, 2)
    img = rng.random((1, 28, 28, 3)).astype(np.float32)
    cond = tp.encode_cond(img)
    close(cond, jp._encode_cond(jp.params["conditioner"], img), rel=1e-4)
    cond_pair = np.concatenate([cond.numpy(), np.zeros_like(cond.numpy())])
    lat = rng.standard_normal((1, 16, 8)).astype(np.float32)
    sig = flow_match_sigmas(3)
    close(tp.denoise(lat, cond_pair, sig, 5.0),
          jp._denoise(jp.params["dit"], lat, cond_pair, sig, 5.0), rel=1e-4)
    pts = rng.uniform(-1, 1, (1, 64, 3)).astype(np.float32)
    jproc = jp.vae.apply(jp.params["vae"], lat, method=JVae.decode)
    close(tp.vae_query(pts, tp.vae_decode(lat)),
          jp._vae_query(jp.params["vae"], pts, jproc), rel=1e-4)


# --------------------------------------------------------------------------- #
def test_generate_assets_cli_writes_a_glb_on_the_cpu(tmp_path, pipes):
    from motion324_tpu_torch import generate_assets
    from motion324_tpu_torch.io.mesh import load_mesh
    _, tp = pipes
    clip = tmp_path / "in" / "wolf_processed" / "masked_rgb"
    clip.mkdir(parents=True)
    rng = np.random.default_rng(12)
    np.save(clip / "0000.npy", (rng.random((28, 28, 3)) * 255).astype(np.uint8))
    out = tmp_path / "out"
    rc = generate_assets.main(["--input-root", str(tmp_path / "in"),
                               "--output", str(out), "--steps", "2",
                               "--octree-resolution", "24", "--no-recenter",
                               "--max-faces", "500", "--device", "cpu"],
                              pipeline=tp)
    assert rc == 0
    glbs = os.listdir(out)
    if glbs:   # a random field may hold no surface at all
        assert glbs == ["wolf.glb"]
        assert 0 < len(load_mesh(str(out / "wolf.glb")).faces) <= 500
    # --texture hands each cleaned mesh and its image to the painter
    # (tests/test_torch_paint.py drives the real one)
    painted = []
    rc = generate_assets.main(["--input-root", str(tmp_path / "in"),
                               "--output", str(out), "--steps", "2",
                               "--octree-resolution", "24", "--no-recenter",
                               "--max-faces", "500", "--device", "cpu",
                               "--texture"], pipeline=tp,
                              painter=lambda m, img: painted.append(img.shape) or m)
    assert rc == 0
    assert painted == [(28, 28, 3)] * len(glbs)


def test_generate_assets_scan_and_shards_match_the_script(tmp_path):
    import sys
    sys.path.insert(0, "scripts")
    import generate_assets as script
    from motion324_tpu_torch import generate_assets as port
    for name, n in (("a", 5), ("b", 12), ("c", 1)):
        d = tmp_path / f"{name}_processed" / "masked_rgb"
        d.mkdir(parents=True)
        for i in range(n):
            (d / f"frame_{i}.png").write_bytes(b"")
    assert port.scan_jobs(str(tmp_path), 2) == script.scan_jobs(str(tmp_path), 2)
    jobs = port.scan_jobs(str(tmp_path), 1)
    assert port.greedy_shards(jobs, 2) == script.greedy_shards(jobs, 2)
