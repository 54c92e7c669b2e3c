"""The texture path's geometry and image stages in the port, on the CPU:

- the cv2-free image ops (area resize, erode, dilate, Canny) and the native
  Navier-Stokes hole fill against cv2 itself;
- the native vertex inpaint against its plain numpy version;
- the delight fallback and the UV unwrap against the JAX package;
- ``MeshRenderer`` against the JAX ``MeshRenderer(interpret=True)`` (64^2
  views, 64^2 texture): views, reliability mask, back-projection, bake;
- the weight-free ``PaintPipeline`` against the JAX pipeline.

The JAX renderer runs under ``jax.disable_jit()``, as the rasterizer tests
run its kernel (see tests/test_torch_rasterizer.py). Tolerances are stated
where they are used.
"""

import cv2
import jax
import numpy as np
import pytest
import torch

from motion324_tpu.hy3dgen import delight as jdelight
from motion324_tpu.hy3dgen import uv_unwrap as juv
from motion324_tpu.hy3dgen.camera import DEFAULT_VIEWS
from motion324_tpu.hy3dgen.mesh_render import MeshRenderer as JaxRenderer
from motion324_tpu.hy3dgen.paint_pipeline import PaintPipeline as JaxPaint
from motion324_tpu.io.mesh import TriMesh as JaxMesh
from motion324_tpu.native import vertex_inpaint_numpy as jax_vertex_inpaint_numpy
from motion324_tpu_torch import native
from motion324_tpu_torch.hy3dgen import delight as tdelight
from motion324_tpu_torch.hy3dgen import uv_unwrap as tuv
from motion324_tpu_torch.hy3dgen.mesh_render import MeshRenderer
from motion324_tpu_torch.hy3dgen.paint_pipeline import PaintPipeline
from motion324_tpu_torch.io.mesh import TriMesh
from motion324_tpu_torch.utils import image as im


def sphere(n: int = 14, jitter: float = 0.15):
    """A deformed UV sphere (the paint benchmark's test mesh, smaller)."""
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, n), np.linspace(0.1, np.pi - 0.1, n))
    verts = np.stack([np.sin(v) * np.cos(u), np.sin(v) * np.sin(u), np.cos(v)],
                     -1).reshape(-1, 3).astype(np.float32)
    verts *= (1 + jitter * np.sin(3 * verts[:, :1]))
    faces = []
    for r in range(n - 1):
        for c in range(n - 1):
            a = r * n + c
            faces += [[a, a + n, a + 1], [a + 1, a + n, a + n + 1]]
    return verts, np.asarray(faces, np.int64)


def _image(seed, h, w, smooth=True):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(xx / (5.0 + c) + c) * np.cos(yy / 6.0)
                    for c in range(3)], -1) + rng.randint(0, 20, (h, w, 3))
    return np.clip(img if smooth else rng.randint(0, 256, (h, w, 3)), 0,
                   255).astype(np.uint8)


# --------------------------------------------------------------------------- #
# image ops against cv2
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("src,dst", [((518, 518), (512, 512)), ((64, 80), (48, 60)),
                                     ((100, 64), (64, 64)), ((48, 48), (64, 80)),
                                     ((37, 50), (37, 50)),
                                     ((210, 210), (512, 512)),
                                     ((246, 186), (512, 512))])
def test_resize_area_matches_cv2(src, dst):
    """Within float rounding: OpenCV sums the same weights in another order
    (measured at most 1.8e-7). Growing 210 or 246 or 186 pixels to 512
    takes OpenCV's scale 1 / (512 / n), not n / 512: at column 256 the two
    floor to different source pixels."""
    img = np.random.RandomState(sum(src)).rand(*src, 3).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = im.resize_area(img, dst[::-1]).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


@pytest.mark.parametrize("k", [3, 5, 9])
def test_erode_dilate_match_cv2(k):
    rng = np.random.RandomState(k)
    m = (rng.rand(40, 56) > 0.3).astype(np.uint8)
    m[:, :3] = 1                     # a filled border: never eroded
    kernel = np.ones((k, k), np.uint8)
    np.testing.assert_array_equal(im.erode(torch.from_numpy(m), k).numpy(),
                                  cv2.erode(m, kernel))
    e = (rng.rand(40, 56) > 0.97).astype(np.uint8) * 255
    np.testing.assert_array_equal(im.dilate(torch.from_numpy(e), k).numpy(),
                                  cv2.dilate(e, kernel))


@pytest.mark.parametrize("seed", range(6))
def test_canny_matches_cv2(seed):
    """Identical edges, on noise and on depth-like images (smooth fields
    cut by a silhouette)."""
    h, w = 64 + 7 * seed, 80
    yy, xx = np.mgrid[:h, :w]
    if seed % 2:
        d = (np.sin(xx / (3 + seed)) * np.cos(yy / 4.0) * 0.5 + 0.5) \
            * ((xx - 40) ** 2 + (yy - 30) ** 2 < 900)
        img = (d * 255).astype(np.uint8)
    else:
        img = np.random.RandomState(seed).randint(0, 256, (h, w)).astype(np.uint8)
    want = cv2.Canny(img, 30, 80)
    assert want.any()
    np.testing.assert_array_equal(im.canny(torch.from_numpy(img), 30, 80).numpy(),
                                  want)


@pytest.mark.parametrize("seed", range(5))
def test_inpaint_ns_matches_cv2(seed):
    """cv2.inpaint(..., 3, INPAINT_NS): identical on every texel, holes
    touching the image border included (measured: no texel differs on these
    images, so the tolerance is 0)."""
    h, w = 40 + 11 * seed, 48
    img = _image(seed, h, w, smooth=seed % 2 == 0)
    yy, xx = np.mgrid[:h, :w]
    rng = np.random.RandomState(seed + 10)
    mask = np.zeros((h, w), np.uint8)
    for _ in range(5):
        cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.randint(2, 8)
        mask[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 255
    mask[:4, :3] = 255
    want = cv2.inpaint(img, mask, 3, cv2.INPAINT_NS)
    got = native.inpaint_ns(img, mask, 3)
    np.testing.assert_array_equal(got[mask == 0], img[mask == 0])
    np.testing.assert_array_equal(got, want)


def test_vertex_inpaint_matches_its_plain_version():
    verts, faces = sphere(8)
    mesh, _ = tuv.unwrap_uv(TriMesh(vertices=verts, faces=faces), 32)
    rng = np.random.RandomState(0)
    tex = rng.rand(32, 32, 3).astype(np.float32)
    mask = ((rng.rand(32, 32) > 0.6) * 255).astype(np.uint8)
    args = (tex, mask, mesh.vertices, mesh.uv, mesh.faces.astype(np.int32),
            mesh.faces.astype(np.int32))
    got_t, got_m = native.vertex_inpaint(*args)
    want_t, want_m = native.vertex_inpaint_numpy(*args)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_allclose(got_t, want_t, rtol=0, atol=1e-6)
    jt, jm = jax_vertex_inpaint_numpy(*args)
    np.testing.assert_array_equal(want_m, jm)
    np.testing.assert_array_equal(want_t, jt)
    assert (got_m > mask).any()


def test_delight_matches():
    img = _image(3, 60, 52).astype(np.float32) / 255
    mask = (np.random.RandomState(1).rand(60, 52) > 0.2).astype(np.float32)
    for m in (None, mask):
        np.testing.assert_allclose(tdelight.delight_image(img, m),
                                   jdelight.delight_image(img, m), rtol=0,
                                   atol=1e-6)


def test_unwrap_matches():
    verts, faces = sphere(12)
    got, gmap = tuv.unwrap_uv(TriMesh(vertices=verts, faces=faces), 256)
    want, wmap = juv.unwrap_uv(JaxMesh(vertices=verts, faces=faces), 256)
    np.testing.assert_array_equal(gmap, wmap)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_allclose(got.uv, want.uv, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------- #
# the renderer against the JAX renderer
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def renderers():
    verts, faces = sphere(14)
    mesh, _ = tuv.unwrap_uv(TriMesh(vertices=verts, faces=faces), 64)
    mesh = mesh.with_vertices(mesh.vertices * 0.45)
    mesh.uv = mesh.uv
    jmesh = JaxMesh(vertices=mesh.vertices, faces=mesh.faces, uv=mesh.uv)
    return (MeshRenderer(mesh, resolution=64, texture_size=64, device="cpu"),
            JaxRenderer(jmesh, resolution=64, texture_size=64, interpret=True))


def test_render_view_matches(renderers):
    tr, jr = renderers
    for azim, elev, _ in DEFAULT_VIEWS:
        got = tr.render_view(elev, azim)
        with jax.disable_jit():
            want = jr.render_view(elev, azim)
        np.testing.assert_array_equal(got["findices"].numpy(), want["findices"])
        np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
        for k in ("normal", "position", "depth", "bary"):
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                       atol=1e-6, err_msg=k)
        assert 0.1 < want["mask"].mean() < 0.9
    assert tr.raster_calls == jr.raster_calls == len(DEFAULT_VIEWS)


def test_reliability_back_projection_and_bake_match(renderers):
    """The views are the same bits (above), so the reliability masks agree
    exactly; back-projected colours and weights within 1e-5 (matmul and pow
    round differently); the bake's texture within 1e-5 and its coverage
    mask identical."""
    tr, jr = renderers
    rng = np.random.RandomState(0)
    images = [rng.rand(64, 64, 3).astype(np.float32) for _ in DEFAULT_VIEWS]
    with jax.disable_jit():
        jtex, jcov = jr.bake(images, DEFAULT_VIEWS)
        azim, elev, _ = DEFAULT_VIEWS[0]
        jc, jw = jr.back_project(images[0], elev, azim)
        jrel = jr.reliability_mask(jr.render_view(elev, azim))
    ttex, tcov = tr.bake(images, DEFAULT_VIEWS)
    tc, tw = tr.back_project(images[0], elev, azim)
    trel = tr.reliability_mask(tr.render_view(elev, azim))
    np.testing.assert_array_equal(trel.numpy(), jrel)
    assert 0.05 < jrel.mean() < 0.9
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tcov, jcov)
    assert 0.1 < jcov.mean() < 1.0
    np.testing.assert_allclose(ttex, jtex, rtol=0, atol=1e-5)
    assert tr.raster_calls == jr.raster_calls == len(DEFAULT_VIEWS) + 1


# --------------------------------------------------------------------------- #
# the weight-free pipeline
# --------------------------------------------------------------------------- #
def test_weight_free_pipeline_matches():
    """The whole texture path with the reprojection synthesizer: the same
    atlas and mapping, the same baked coverage; the textures (uint8 after
    the hole fill) within 1 level on every texel."""
    verts, faces = sphere(12)
    verts = verts * 0.8 + 0.1                      # off the render box
    image = _image(5, 70, 70).astype(np.float32) / 255
    tp = PaintPipeline(resolution=48, texture_size=64, device="cpu")
    got = tp(TriMesh(vertices=verts, faces=faces), image)
    jp = JaxPaint(resolution=48, texture_size=64, interpret=True)
    with jax.disable_jit():
        want = jp(JaxMesh(vertices=verts, faces=faces), image)
    np.testing.assert_array_equal(got.vmapping, want.vmapping)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    assert got.texture.shape == want.texture.shape == (64, 64, 3)
    np.testing.assert_allclose(got.texture, want.texture, rtol=0,
                               atol=1.0 / 255 + 1e-6)
    assert set(tp.last_run["seconds"]) == {"delight", "unwrap", "render",
                                           "diffusion", "bake",
                                           "vertex_inpaint", "hole_fill"}
    assert tp.last_run["raster_calls"] == 7
    assert 0.1 < tp.last_run["baked"] <= tp.last_run["coverage"] <= 1.0
