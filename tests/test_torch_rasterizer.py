"""K8's plain version, the rasterizer's binning and its interpolation in the
port, against the JAX package on the CPU: the Pallas kernel in interpret
mode and the numpy f64 oracle of the reference semantics; and the camera
copy.

The port computes the inside test and the depth in uncontracted f32, as
the CUDA kernel does. XLA:CPU contracts some of the interpreted Pallas
kernel's multiply-adds into FMAs, and more of them inside the jitted entry
``rasterize`` (there 5 pixels of a 48^2 random mesh moved, where two
coplanar faces sat one depth quantum apart), so the tests run the kernel
through ``_rasterize_impl`` outside ``jax.jit`` and keep pixel centres off
the edges, except the one test that shows the difference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motion324_tpu.hy3dgen import camera as jcam
from motion324_tpu.ops import rasterizer as jr
from motion324_tpu_torch.hy3dgen import camera as tcam
from motion324_tpu_torch.ops import rasterizer as tr


def _random_mesh(seed, n_verts, n_faces, w_range=(0.8, 1.2)):
    rng = np.random.RandomState(seed)
    pos = np.concatenate([rng.uniform(-1.1, 1.1, (n_verts, 2)),
                          rng.uniform(-0.9, 0.9, (n_verts, 1)),
                          rng.uniform(*w_range, (n_verts, 1))], 1)
    return (pos.astype(np.float32),
            rng.randint(0, n_verts, (n_faces, 3)).astype(np.int32))


def _port(pos, faces, w, h):
    find, bary = tr.rasterize(torch.from_numpy(pos), torch.from_numpy(faces),
                              w, h)
    return find.numpy(), bary.numpy()


def _pallas(pos, faces, w, h):
    find, bary = jr._rasterize_impl(jnp.asarray(pos), jnp.asarray(faces), w, h,
                                    interpret=True)
    return np.asarray(find), np.asarray(bary)


def test_camera_copy_matches():
    for elev, azim in [(0, 0), (15, 90), (90, 180), (-90, 270)]:
        np.testing.assert_array_equal(tcam.view_matrix(elev, azim),
                                      jcam.view_matrix(elev, azim))
    np.testing.assert_array_equal(tcam.orthographic(-0.6, 0.6, -0.6, 0.6, 0.1, 100),
                                  jcam.orthographic(-0.6, 0.6, -0.6, 0.6, 0.1, 100))
    np.testing.assert_array_equal(tcam.perspective(40.0), jcam.perspective(40.0))
    pts = np.random.RandomState(0).randn(7, 3).astype(np.float32)
    m = jcam.orthographic() @ jcam.view_matrix(10, 30)
    np.testing.assert_array_equal(tcam.transform_points(m, pts),
                                  jcam.transform_points(m, pts))
    assert tcam.DEFAULT_VIEWS == jcam.DEFAULT_VIEWS


def test_screen_coefficients_match():
    pos, faces = _random_mesh(0, 40, 60)
    want = jr.screen_coefficients(jnp.asarray(pos), jnp.asarray(faces), 48, 40)
    got = tr.screen_coefficients(torch.from_numpy(pos),
                                 torch.from_numpy(faces).long(), 48, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_single_triangle():
    pos = np.array([[-0.8, -0.7, 0.1, 1], [0.9, -0.5, 0.2, 1],
                    [0.0, 0.85, -0.3, 1]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    find, bary = _port(pos, faces, 32, 32)
    jf, jb = _pallas(pos, faces, 32, 32)
    np.testing.assert_array_equal(find, jf)
    np.testing.assert_array_equal(find, tr.rasterize_reference(pos, faces, 32, 32))
    assert 0.2 < (find == 1).mean() < 0.7 and set(np.unique(find)) == {0, 1}
    np.testing.assert_allclose(bary, jb, rtol=0, atol=1e-6)
    np.testing.assert_allclose(bary[find > 0].sum(-1), 1.0, atol=1e-5)


def _stacked_triangles(tri):
    """Face 0 far, face 1 near, faces 2 and 3 the same near triangle again."""
    verts = []
    for z in (0.5, -0.5, -0.5, -0.5):
        verts += [[x, y, z, 1.0] for x, y in tri]
    return (np.asarray(verts, np.float32),
            np.arange(12, dtype=np.int32).reshape(4, 3))


def test_depth_order_and_face_id_ties():
    pos, faces = _stacked_triangles([[-0.9, -0.85], [0.93, -0.9], [0.88, 0.91]])
    find, _ = _port(pos, faces, 24, 24)
    np.testing.assert_array_equal(find, _pallas(pos, faces, 24, 24)[0])
    # the near face wins, and of the three equally near ones the lowest id
    assert set(np.unique(find)) == {0, 2}
    # the tie-break follows the ORIGINAL id whatever the chunk order
    find_rev, _ = _port(pos, faces[::-1].copy(), 24, 24)
    assert set(np.unique(find_rev)) == {0, 1}


def test_pixels_exactly_on_an_edge_follow_uncontracted_f32():
    """A hypotenuse through 8 pixel centres: there the port's f32 beta is
    exactly 0 (inside, as in the f64 oracle), while XLA:CPU, which contracts
    ``bx*px + by*py`` into an FMA in the interpreted Pallas kernel, gets
    -1.5e-8 (outside). Those 8 pixels are the only difference."""
    pos, faces = _stacked_triangles([[-0.9, -0.9], [0.9, -0.9], [0.9, 0.9]])
    find, _ = _port(pos, faces, 24, 24)
    diff = np.argwhere(find != _pallas(pos, faces, 24, 24)[0])
    assert len(diff) == 8 and (diff[:, 0] == diff[:, 1]).all()
    np.testing.assert_array_equal(find,
                                  tr.rasterize_reference(pos, faces, 24, 24))
    assert (find[diff[:, 0], diff[:, 1]] == 2).all()


@pytest.mark.parametrize("w,h,n_faces", [(48, 48, 80), (40, 56, 600),
                                         (1100, 3, 300)],
                         ids=["48sq", "multi_chunk", "tile_shorter_than_row"])
def test_random_mesh_matches_pallas_and_oracle(w, h, n_faces):
    pos, faces = _random_mesh(w + n_faces, n_faces // 2 + 10, n_faces)
    find, bary = _port(pos, faces, w, h)
    jf, jb = _pallas(pos, faces, w, h)
    np.testing.assert_array_equal(find, jf)
    np.testing.assert_allclose(bary, jb, rtol=0, atol=1e-6)
    assert 0.3 < (find > 0).mean() < 1.0
    # against the f64 oracle: no pixel differs at these three inputs (as
    # measured); the check allows a pixel within 1e-5 of an edge of one of
    # the two faces, or where their depths differ by at most one quantum
    # (f32 against f64 rounding), up to 0.2% of the pixels
    ref = tr.rasterize_reference(pos, faces, w, h)
    diff = np.argwhere(ref != find)
    assert len(diff) <= 0.002 * w * h + 2, len(diff)
    p64 = pos.astype(np.float64)
    x = (p64[:, 0] / p64[:, 3] * 0.5 + 0.5) * (w - 1) + 0.5
    y = (0.5 + 0.5 * p64[:, 1] / p64[:, 3]) * (h - 1) + 0.5
    z = p64[:, 2] / p64[:, 3] * 0.49999 + 0.5
    for py, px in diff:
        near_edge, depths = False, []
        for f in (find[py, px], ref[py, px]):
            if f == 0:
                near_edge = True
                continue
            a, b, c = faces[f - 1]
            area = (x[c] - x[a]) * (y[b] - y[a]) - (x[b] - x[a]) * (y[c] - y[a])
            beta = ((x[c] - x[a]) * (py + 0.5 - y[a])
                    - (px + 0.5 - x[a]) * (y[c] - y[a])) / area
            gamma = ((px + 0.5 - x[a]) * (y[b] - y[a])
                     - (x[b] - x[a]) * (py + 0.5 - y[a])) / area
            bc = np.array([1 - beta - gamma, beta, gamma])
            near_edge |= bool(np.abs(bc).min() < 1e-5 or np.abs(bc - 1).min() < 1e-5)
            depths.append(bc @ z[[a, b, c]] * 2 ** 18)
        assert near_edge or abs(depths[0] - depths[1]) <= 1.0, (py, px)


def _uv_mesh():
    from motion324_tpu_torch.hy3dgen.uv_unwrap import unwrap_uv
    from motion324_tpu_torch.io.mesh import TriMesh
    n = 9
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, n), np.linspace(0.2, 2.9, n))
    verts = np.stack([np.sin(v) * np.cos(u), np.sin(v) * np.sin(u), np.cos(v)],
                     -1).reshape(-1, 3).astype(np.float32)
    faces = []
    for r in range(n - 1):
        for c in range(n - 1):
            a = r * n + c
            faces += [[a, a + n, a + 1], [a + 1, a + n, a + n + 1]]
    return unwrap_uv(TriMesh(vertices=verts, faces=np.asarray(faces)), 64)[0]


def test_uv_raster_and_interpolate_match():
    mesh = _uv_mesh()
    uv = mesh.uv
    pos = np.zeros((len(uv), 4), np.float32)
    pos[:, 0] = uv[:, 0] * 2 - 1
    pos[:, 1] = 1 - 2 * uv[:, 1]
    pos[:, 3] = 1.0
    faces = mesh.faces.astype(np.int32)
    find, bary = _port(pos, faces, 64, 64)
    jf, jb = _pallas(pos, faces, 64, 64)
    np.testing.assert_array_equal(find, jf)
    assert 0.2 < (find > 0).mean() < 0.95
    attrs = mesh.vertices.astype(np.float32)
    got = tr.interpolate(torch.from_numpy(attrs), torch.from_numpy(find),
                         torch.from_numpy(bary), torch.from_numpy(faces).long())
    want = jr.interpolate(jnp.asarray(attrs), jnp.asarray(jf), jnp.asarray(jb),
                          jnp.asarray(faces))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_cpu_wrapper_runs_the_plain_version():
    pos, faces = _random_mesh(3, 30, 40)
    before = tr.rasterize.launches
    find, _ = _port(pos, faces, 20, 20)
    assert tr.rasterize.launches == before
    coeffs, bbox = tr.bin_faces(torch.from_numpy(pos),
                                torch.from_numpy(faces).long(), 20, 20)
    assert coeffs.shape == (11, 256) and bbox.shape == (1, 4)
    np.testing.assert_array_equal(
        tr.raster_reference(coeffs, bbox, 20, 20).numpy().reshape(20, 20), find)
    assert tr.binned_pairs(bbox, 20, 20) == 1024 * 256
