"""Adversarial meshes for K8, the triangle rasterizer: test data for
tests/test_torch_raster_cull.py, tests/test_torch_cuda_kernels.py and
chip_smoke.py's K8 phase (which loads this file by its path)."""

import numpy as np
import torch


def sliver_mesh(seed: int, n_faces: int = 600):
    """Adversarial clip-space faces for K8's tests: ``(pos
    (V, 4) f32, faces (F, 3) int64)`` on the CPU, from a numpy seed. A sixth
    each of: random faces (a third of them behind the camera, w < 0);
    near-collinear slivers (the third vertex 1e-7 to 1e-3 off the line
    through the first two, in clip units); the same along the clip lines
    x or y in {-1, -0.5, 0, 0.5, 1}, which run through pixel centres at
    many sizes, so that the slivers' huge coefficients let the rounded test
    pass at centres outside the face's bbox; faces collinear in clip space,
    with coincident vertices (zero area, invalid) or one ulp apart; axis-
    aligned right triangles (signed-zero coefficients, edges through pixel
    centres); faces partly or wholly off screen."""
    rng = np.random.RandomState(seed)
    n = n_faces // 6
    tri = []
    # random, a third behind the camera
    xy = rng.uniform(-1.1, 1.1, (n, 1, 2)) + rng.uniform(-0.3, 0.3, (n, 3, 2))
    w = np.where(rng.uniform(size=(n, 1, 1)) < 1 / 3, -1.0, 1.0) * rng.uniform(
        0.8, 1.2, (n, 3, 1))
    tri.append(np.concatenate([xy * np.abs(w), rng.uniform(-0.9, 0.9, (n, 3, 1)),
                               w], -1))
    # near-collinear slivers, off any line and along pixel-centre lines
    for on_line in (False, True):
        a, b = rng.uniform(-1, 1, (n, 2)), rng.uniform(-1, 1, (n, 2))
        if on_line:
            axis = rng.randint(0, 2, n)
            line = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], n)
            a[np.arange(n), axis] = b[np.arange(n), axis] = line
        d = b - a
        perp = np.stack([-d[:, 1], d[:, 0]], 1) / np.linalg.norm(
            d, axis=1, keepdims=True)
        c = (a + rng.uniform(0.1, 0.9, (n, 1)) * d
             + perp * 10.0 ** rng.uniform(-7, -3, (n, 1)))
        tri.append(np.stack([a, b, c], 1))
    # collinear in clip space; coincident or one ulp apart
    k = n // 2
    a, b = rng.uniform(-1, 1, (k, 2)), rng.uniform(-1, 1, (k, 2))
    tri.append(np.stack([a, b, (a + b) / 2], 1))
    a = rng.uniform(-1, 1, (n - k, 2)).astype(np.float32)
    b = np.where(rng.uniform(size=(n - k, 1)) < 0.5, a,
                 np.nextafter(a, np.float32(2)))
    tri.append(np.stack([a, b, rng.uniform(-1, 1, (n - k, 2))], 1))
    # axis-aligned right triangles, both orientations
    o, e = rng.uniform(-0.9, 0.5, (n, 2)), rng.uniform(0.05, 0.4, (n, 2))
    sx = np.where(rng.uniform(size=(n, 1)) < 0.5, 1.0, -1.0)
    tri.append(np.stack([o, o + e * [1, 0] * sx, o + e * [0, 1]], 1))
    # off screen: shifted past an edge of the view
    m = n_faces - 5 * n
    shift = rng.choice([-1.0, 1.0], (m, 1, 2)) * rng.uniform(0.8, 2.5, (m, 1, 2))
    tri.append(rng.uniform(-0.5, 0.5, (m, 3, 2)) + shift)
    pos = []
    for t in tri:
        if t.shape[-1] == 2:
            t = np.concatenate([t, rng.uniform(-0.9, 0.9, t.shape[:2] + (1,)),
                                np.ones(t.shape[:2] + (1,))], -1)
        pos.append(t.reshape(-1, 4))
    pos = np.concatenate(pos).astype(np.float32)
    faces = np.arange(len(pos)).reshape(-1, 3)
    return torch.from_numpy(pos), torch.from_numpy(faces)
