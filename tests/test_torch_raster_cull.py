"""K8's face cull, held sound on the CPU through its plain mirror
``face_cull_reference``, and the pair counts of K8's bound.

K8 culls, for each group of 128 flat pixels and then for each of its runs
of 32, the faces whose rounded inside test fails at every pixel centre of
the group's or the run's rectangle, inside the binned (tile, chunk) relation that the plain
version tests. The cull is exact: a pair whose rounded test passes is never
dropped, so a raster over the kept pairs alone is ``raster_reference`` bit
for bit. These tests hold that on random meshes and on adversarial ones
(near-collinear slivers, coincident vertices, coefficients as an infinite
1/area gives them, signed zeros, w < 0, faces off screen, a hypotenuse
through pixel centres) at 48^2, 333 x 97 (runs and groups wrap rows) and
1 100 x 3 (a tile shorter than a row).
"""

import numpy as np
import pytest
import torch

from motion324_tpu_torch.ops import rasterizer as ra
from raster_meshes import sliver_mesh

SHAPES = [(48, 48), (333, 97), (1100, 3)]
SHAPE_IDS = ["48sq", "333x97", "1100x3"]


def _random_mesh(seed, n_faces):
    rng = np.random.RandomState(seed)
    n_verts = n_faces // 2 + 10
    pos = np.concatenate([rng.uniform(-1.1, 1.1, (n_verts, 2)),
                          rng.uniform(-0.9, 0.9, (n_verts, 1)),
                          rng.uniform(0.8, 1.2, (n_verts, 1))], 1)
    return (torch.from_numpy(pos.astype(np.float32)),
            torch.from_numpy(rng.randint(0, n_verts, (n_faces, 3))))


def _edge_mesh():
    """tests/test_torch_rasterizer.py's stacked right triangles: a hypotenuse
    through pixel centres, where beta is exactly 0 in uncontracted f32."""
    tri = [[-0.9, -0.9], [0.9, -0.9], [0.9, 0.9]]
    verts = [[x, y, z, 1.0] for z in (0.5, -0.5, -0.5, -0.5) for x, y in tri]
    return (torch.tensor(verts, dtype=torch.float32),
            torch.arange(12).reshape(4, 3))


def _binned(mesh, w, h):
    """Binned inputs of a named mesh. "sliver_inf": the sliver mesh with a
    third of its valid faces' coefficients as 1/area = +-inf gives them
    (+-inf, NaN where 0 * inf), another third scaled by 1e30 (finite, but
    their products overflow at some pixels) and every tenth b0 NaN."""
    if mesh == "random":
        pos, faces = _random_mesh(w + h, 700)
    elif mesh == "edge":
        pos, faces = _edge_mesh()
    else:
        pos, faces = sliver_mesh(w * h, 600)
    coeffs, bbox = ra.bin_faces(pos, faces, w, h)
    if mesh == "sliver_inf":
        cols = (coeffs[9] > 0.5).nonzero()[:, 0]
        coeffs[:6, cols[0::3]] *= float("inf")
        coeffs[:6, cols[1::3]] *= 1e30
        coeffs[2, cols[0::10]] = float("nan")
    return coeffs, bbox


def _passing(coeffs, bbox, w, h, run_px):
    """(runs, F_pad) bool: some pixel of the run passes the face's rounded
    inside test, in raster_reference's arithmetic, inside the binned
    relation; and that relation itself per (run, face)."""
    n_tiles = -(-w * h // ra.BLOCK_PX)
    per_tile = ra.BLOCK_PX // run_px
    overlap = ra._tile_overlap(bbox, w, n_tiles)
    passing = torch.zeros(n_tiles * per_tile, coeffs.shape[1], dtype=torch.bool)
    related = torch.zeros_like(passing)
    lanes = torch.arange(ra.BLOCK_PX)
    for c in range(bbox.shape[0]):
        tiles = overlap[:, c].nonzero()[:, 0]
        cols = slice(c * ra.BLOCK_F, (c + 1) * ra.BLOCK_F)
        cc = coeffs[:, cols]
        pix = (tiles[:, None] * ra.BLOCK_PX + lanes).reshape(-1)
        px = ((pix % w).float() + 0.5)[:, None]
        py = ((pix // w).float() + 0.5)[:, None]
        beta = cc[0] * px + cc[1] * py + cc[2]
        gamma = cc[3] * px + cc[4] * py + cc[5]
        alpha = 1.0 - beta - gamma
        inside = ((cc[9] > 0.5) & (alpha >= 0) & (alpha <= 1) & (beta >= 0)
                  & (beta <= 1) & (gamma >= 0) & (gamma <= 1))
        runs = (tiles[:, None] * per_tile + torch.arange(per_tile)).reshape(-1)
        passing[runs, cols] = inside.reshape(-1, run_px, ra.BLOCK_F).any(1)
        related[runs, cols] = True
    return passing, related


def _raster_kept(coeffs, kept, w, h, run_px):
    """A plain raster that tests only the kept (run, face) pairs, with
    raster_reference's arithmetic and packed (depth, face id) key."""
    n_pix = w * h
    pix = kept[:, :1] * run_px + torch.arange(run_px)              # (K, run)
    cc = coeffs[:, kept[:, 1]][:, :, None]                         # (11, K, 1)
    px = (pix % w).float() + 0.5
    py = (pix // w).float() + 0.5
    beta = cc[0] * px + cc[1] * py + cc[2]
    gamma = cc[3] * px + cc[4] * py + cc[5]
    alpha = 1.0 - beta - gamma
    inside = ((alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1)
              & (gamma >= 0) & (gamma <= 1) & (pix < n_pix))
    depth = alpha * cc[6] + beta * cc[7] + gamma * cc[8]
    zq = (depth * float(2 << 17)).to(torch.int32).long()
    key = (zq << 31) + cc[10].long()
    big = (ra.BIG_Z << 31) + ra.BIG_Z
    out = torch.full((n_pix + 1,), big, dtype=torch.int64)
    out.scatter_reduce_(0, torch.where(inside, pix, n_pix).reshape(-1),
                        torch.where(inside, key, big).reshape(-1), "amin")
    out = out[:n_pix]
    return torch.where(out >> 31 < ra.BIG_Z, (out & ((1 << 31) - 1)) + 1,
                       0).to(torch.int32)


MESHES = ["random", "sliver", "sliver_inf", "edge"]
RUNS = [ra.RUN_PX, ra.GROUP_PX]


@pytest.mark.parametrize("run_px", RUNS, ids=["run32", "group128"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("mesh", MESHES)
def test_cull_keeps_every_passing_pair(mesh, shape, run_px):
    w, h = shape
    coeffs, bbox = _binned(mesh, w, h)
    kept = ra.face_cull_reference(coeffs, bbox, w, h, run_px)
    passing, related = _passing(coeffs, bbox, w, h, run_px)
    dense = torch.zeros_like(passing)
    dense[kept[:, 0], kept[:, 1]] = True
    assert len(kept) == int(dense.sum())          # no pair twice
    assert not (dense & ~related).any()           # only binned pairs
    missed = (passing & ~dense).nonzero()
    assert len(missed) == 0, f"cull drops passing pairs {missed[:5].tolist()}"
    assert passing.any() and len(kept) < int(related.sum())


@pytest.mark.parametrize("run_px", RUNS, ids=["run32", "group128"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("mesh", MESHES)
def test_raster_of_kept_pairs_is_the_plain_raster(mesh, shape, run_px):
    w, h = shape
    coeffs, bbox = _binned(mesh, w, h)
    kept = ra.face_cull_reference(coeffs, bbox, w, h, run_px)
    want = ra.raster_reference(coeffs, bbox, w, h)
    assert torch.equal(_raster_kept(coeffs, kept, w, h, run_px), want)
    assert (want > 0).any()


def test_sliver_mesh_is_adversarial():
    """The sliver mesh holds what the cull must survive: valid faces with
    signed-zero and huge coefficients, faces behind the camera and off
    screen, and pixels outside a face's screen bbox where its rounded test
    passes (so a geometric bbox cull would change the result)."""
    w = h = 48
    pos, faces = sliver_mesh(w * h, 600)
    coeffs, bbox = ra.bin_faces(pos, faces, w, h)
    valid = coeffs[9] > 0.5
    c = coeffs[:6, valid]
    assert ((c == 0) & torch.signbit(c)).any() and (c.abs() > 1e8).any()
    assert (pos[:, 3] < 0).any() and (pos[:, :2].abs() > 2 * pos[:, 3:].abs()).any()
    assert int(valid.sum()) < len(faces)
    passing, _ = _passing(coeffs, bbox, w, h, ra.RUN_PX)
    x, y, _, _ = ra._screen_transform(pos, w, h)
    fx, fy = x[faces], y[faces]
    order = coeffs[10].long()
    outside = 0
    for run, col in passing.nonzero().tolist():
        f = int(order[col])
        pix = torch.arange(run * ra.RUN_PX, (run + 1) * ra.RUN_PX)
        pix = pix[pix < w * h]
        px, py = (pix % w).float() + 0.5, (pix // w).float() + 0.5
        cc = coeffs[:, col]
        beta = cc[0] * px + cc[1] * py + cc[2]
        gamma = cc[3] * px + cc[4] * py + cc[5]
        alpha = 1.0 - beta - gamma
        inside = ((alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1)
                  & (gamma >= 0) & (gamma <= 1))
        off = ((px < fx[f].min()) | (px > fx[f].max()) | (py < fy[f].min())
               | (py > fy[f].max()))
        outside += int((inside & off).sum())
    assert outside > 0


def _uv_like_mesh(n_faces):
    """A UV atlas as the paint path rasterizes it: a sphere unwrapped by the
    port's unwrap_uv, its UVs as clip xy at w = 1."""
    from motion324_tpu_torch.hy3dgen.uv_unwrap import unwrap_uv
    from motion324_tpu_torch.io.mesh import TriMesh
    n = int(np.sqrt(n_faces / 2)) + 1
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, n), np.linspace(0.1, 3.0, n))
    verts = np.stack([np.sin(v) * np.cos(u), np.sin(v) * np.sin(u), np.cos(v)],
                     -1).reshape(-1, 3).astype(np.float32)
    a = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None]).reshape(-1)
    tri = np.stack([np.stack([a, a + n, a + 1], 1),
                    np.stack([a + 1, a + n, a + n + 1], 1)], 1).reshape(-1, 3)
    mesh = unwrap_uv(TriMesh(vertices=verts, faces=tri), 1024)[0]
    uv = torch.from_numpy(mesh.uv.astype(np.float32))
    pos = torch.stack([uv[:, 0] * 2 - 1, 1 - 2 * uv[:, 1],
                       torch.zeros_like(uv[:, 0]), torch.ones_like(uv[:, 0])], 1)
    return pos, torch.from_numpy(mesh.faces).long()


@pytest.mark.parametrize("run_px", RUNS, ids=["run32", "group128"])
def test_cull_drops_most_binned_pairs_on_a_uv_mesh(run_px):
    """A 1 024^2 atlas of about 2 000 faces, the paint atlas's texel density
    (2 048^2 and 39 762 faces): more than 90% of the binned pairs go."""
    pos, faces = _uv_like_mesh(2000)
    w = h = 1024
    coeffs, bbox = ra.bin_faces(pos, faces, w, h)
    kept = ra.face_cull_reference(coeffs, bbox, w, h, run_px)
    binned = ra.binned_pairs(bbox, w, h)
    assert len(kept) * run_px < 0.1 * binned, (len(kept), binned)
    assert torch.equal(_raster_kept(coeffs, kept, w, h, run_px),
                       ra.raster_reference(coeffs, bbox, w, h))


@pytest.mark.parametrize("mesh", ["random", "sliver"])
def test_bbox_pairs_counts_pixel_centres_in_valid_bboxes(mesh):
    w, h = 333, 97
    pos, faces = (_random_mesh(5, 300) if mesh == "random"
                  else sliver_mesh(5, 300))
    valid = ra.screen_coefficients(pos, faces, w, h)[9] > 0.5
    x, y, _, _ = ra._screen_transform(pos, w, h)
    cx = torch.arange(w).float() + 0.5
    cy = torch.arange(h).float() + 0.5
    want = 0
    for f in valid.nonzero()[:, 0].tolist():
        fx, fy = x[faces[f]], y[faces[f]]
        want += int(((cx >= fx.min()) & (cx <= fx.max())).sum()
                    * ((cy >= fy.min()) & (cy <= fy.max())).sum())
    assert ra.bbox_pairs(pos, faces, w, h) == want > 0


@pytest.mark.parametrize("run_px", RUNS, ids=["run32", "group128"])
def test_run_rectangles_cover_their_pixels(run_px):
    """Each run's rectangle is the hull of its pixels' centres: its row span,
    and its columns when it stays in one row, else the full width."""
    for w in (48, 128, 333, 512, 1100):
        n_runs = 40
        x_lo, x_hi, y_lo, y_hi = ra._run_rects(w, n_runs, run_px, "cpu")
        pix = torch.arange(n_runs)[:, None] * run_px + torch.arange(run_px)
        px, py = (pix % w).float() + 0.5, (pix // w).float() + 0.5
        one_row = py.amin(1) == py.amax(1)
        assert torch.equal(x_lo, torch.where(one_row, px.amin(1), 0.5))
        assert torch.equal(x_hi, torch.where(one_row, px.amax(1), w - 0.5))
        assert torch.equal(y_lo, py.amin(1)) and torch.equal(y_hi, py.amax(1))
