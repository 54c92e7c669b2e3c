"""K8: the triangle rasterizer, ``csrc/rasterize.cu``, and its plain version.

Replaces the TPU kernel ``_raster_kernel`` in
``motion324_tpu/ops/rasterizer.py`` (reached through ``_rasterize_impl`` and
``rasterize``) with the same visibility semantics:

- screen mapping ``x = (x/w * 0.5 + 0.5) * (W-1) + 0.5`` (same for y),
  ``z = z/w * 0.49999 + 0.5``; pixel centres at ``(px+0.5, py+0.5)``;
- inside test on the f32 affine coefficients of :func:`screen_coefficients`:
  ``beta = bx*px + by*py + b0``, the same for gamma, ``alpha = 1 - beta -
  gamma``, all three in [0, 1]; degenerate faces are invalid;
- the nearest face wins by ``(int(depth * 2^18), original face id)``,
  smallest first; coverage is ``z < 2^30``; ``findices`` is face id + 1, 0
  for background.

The binning of the JAX package is kept as it is: faces sorted (stably) by the
bottom of their screen bbox, chunks of ``BLOCK_F`` faces with a bbox each,
and flat pixel tiles of ``BLOCK_PX`` pixels that skip the chunks whose bbox
misses them (:func:`bin_faces`). The tiles and chunks decide which (pixel,
face) pairs are tested at all, so both versions use the same ones: the
result is the kernel's function bit for bit, sliver faces included. Inside
that relation the kernel also culls, per run of ``RUN_PX`` pixels, the
faces whose rounded test fails at every pixel of the run; the cull is
exact, so the result does not change. :func:`face_cull_reference` is that
cull in torch, for the tests and the smoke.

:func:`rasterize` launches K8 on a CUDA tensor (counted in
``rasterize.launches``) and computes :func:`raster_reference` on a CPU
tensor. :func:`rasterize_reference` is the numpy f64 oracle of the reference
semantics, without binning.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from motion324_tpu_torch.ops import _build

__all__ = ["rasterize", "rasterize_reference", "raster_reference",
           "screen_coefficients", "bin_faces", "barycentrics", "interpolate",
           "binned_pairs", "bbox_pairs", "face_cull_reference",
           "BLOCK_PX", "BLOCK_F", "GROUP_PX", "RUN_PX"]

BIG_Z = 2 ** 30
BLOCK_PX = 1024   # pixels per tile (flat, row-major)
BLOCK_F = 256     # faces per chunk
GROUP_PX = 128    # pixels per group of K8: one warp, 4 pixels a lane
RUN_PX = 32       # pixels per run: K8 culls per run (lane pixel i, run i)
_ZSCALE = float(2 << 17)
_lib: ctypes.CDLL | None = None


def _screen_transform(pos, width: int, height: int):
    """Clip-space (V, 4) -> per-vertex screen x, y, z and 1/w."""
    w = pos[..., 3]
    x = (pos[..., 0] / w * 0.5 + 0.5) * (width - 1) + 0.5
    y = (0.5 + 0.5 * pos[..., 1] / w) * (height - 1) + 0.5
    z = pos[..., 2] / w * 0.49999 + 0.5
    return x, y, z, 1.0 / w


def screen_coefficients(pos: torch.Tensor, faces: torch.Tensor, width: int,
                        height: int) -> torch.Tensor:
    """``(10, F)`` f32 per-face rows ``[bx, by, b0, gx, gy, g0, z0, z1, z2,
    valid]``: ``beta(px, py) = bx*px + by*py + b0`` (already divided by the
    doubled signed area), the same for gamma, and the vertex depths."""
    x, y, z, _ = _screen_transform(pos, width, height)
    ax, ay = x[faces[:, 0]], y[faces[:, 0]]
    bx_, by_ = x[faces[:, 1]], y[faces[:, 1]]
    cx, cy = x[faces[:, 2]], y[faces[:, 2]]
    area = (cx - ax) * (by_ - ay) - (bx_ - ax) * (cy - ay)
    valid = area.abs() > 0
    inv = torch.where(valid, 1.0 / torch.where(valid, area, torch.ones_like(area)),
                      torch.zeros_like(area))
    bx = -(cy - ay) * inv
    by = (cx - ax) * inv
    b0 = ((cy - ay) * ax - (cx - ax) * ay) * inv
    gx = (by_ - ay) * inv
    gy = -(bx_ - ax) * inv
    g0 = (-(by_ - ay) * ax + (bx_ - ax) * ay) * inv
    return torch.stack([bx, by, b0, gx, gy, g0, z[faces[:, 0]], z[faces[:, 1]],
                        z[faces[:, 2]], valid.float()]).float()


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def bin_faces(pos: torch.Tensor, faces: torch.Tensor, width: int, height: int):
    """The binning of the JAX package: ``(coeffs (11, F_pad), chunk_bbox
    (n_chunks, 4))``. Faces are sorted stably by ``fy_min``; row 10 holds the
    original face ids (as f32, for the tie-break); padded columns are zero
    (invalid). Each chunk's bbox ``[x_min, x_max, y_min, y_max]`` spans its
    valid faces (``1e30 / -1e30`` when it has none)."""
    num_faces = faces.shape[0]
    coeffs = screen_coefficients(pos, faces, width, height)
    x, y, _, _ = _screen_transform(pos, width, height)
    fx, fy = x[faces], y[faces]
    order = torch.argsort(fy.amin(1), stable=True)
    coeffs = torch.cat([coeffs[:, order], order[None].float()], 0)
    f_pad = _ceil_to(max(num_faces, BLOCK_F), BLOCK_F)
    pad = f_pad - num_faces
    coeffs = torch.nn.functional.pad(coeffs, (0, pad))
    n_chunks = f_pad // BLOCK_F
    valid = coeffs[9] > 0.5
    big = torch.tensor(1e30, dtype=torch.float32, device=pos.device)

    def reduce(v, fill, op):
        v = torch.nn.functional.pad(v[order], (0, pad), value=float(fill))
        return getattr(torch.where(valid, v, fill).reshape(n_chunks, BLOCK_F),
                       op)(1)
    bbox = torch.stack([reduce(fx.amin(1), big, "amin"),
                        reduce(fx.amax(1), -big, "amax"),
                        reduce(fy.amin(1), big, "amin"),
                        reduce(fy.amax(1), -big, "amax")], 1)
    return coeffs.contiguous(), bbox.contiguous()


def _tile_overlap(bbox: torch.Tensor, width: int, n_tiles: int) -> torch.Tensor:
    """``(n_tiles, n_chunks)`` bool: the JAX kernel's cull test of each flat
    pixel tile against each chunk's bbox."""
    start = torch.arange(n_tiles, device=bbox.device) * BLOCK_PX
    ty0 = (start // width).float()
    ty1 = ((start + BLOCK_PX - 1) // width).float() + 1.0
    if BLOCK_PX < width:
        tx0 = (start % width).float()
        tx1 = tx0 + float(BLOCK_PX)
    else:
        tx0 = torch.zeros_like(ty0)
        tx1 = torch.full_like(ty0, float(width))
    b = bbox[None]
    return ((b[..., 1] >= tx0[:, None]) & (b[..., 0] <= tx1[:, None])
            & (b[..., 3] >= ty0[:, None]) & (b[..., 2] <= ty1[:, None]))


def binned_pairs(bbox: torch.Tensor, width: int, height: int) -> int:
    """The (pixel, face) pairs the binned kernel tests: overlapping
    (tile, chunk) pairs x BLOCK_PX x BLOCK_F."""
    n_tiles = -(-width * height // BLOCK_PX)
    return int(_tile_overlap(bbox, width, n_tiles).sum()) * BLOCK_PX * BLOCK_F


def bbox_pairs(pos: torch.Tensor, faces: torch.Tensor, width: int,
               height: int) -> int:
    """The (pixel, face) pairs the function needs tested: for each valid face
    (nonzero f32 area, as :func:`screen_coefficients` decides), the pixel
    centres inside its screen bbox, clipped to the image. This is the work of
    the reference's own per-face loop, whoever implements it."""
    pos = torch.as_tensor(pos, dtype=torch.float32)
    faces = torch.as_tensor(faces, device=pos.device).long()
    valid = screen_coefficients(pos, faces, width, height)[9] > 0.5
    x, y, _, _ = _screen_transform(pos, width, height)
    fx, fy = x[faces], y[faces]

    def centres(lo, hi, n):
        # integer c in [0, n) with lo <= c + 0.5 <= hi; NaN counts none
        first = torch.ceil(lo - 0.5).clamp(min=0)
        last = torch.floor(hi - 0.5).clamp(max=n - 1)
        return torch.nan_to_num((last - first + 1).clamp(min=0), nan=0.0)
    count = (centres(fx.amin(1), fx.amax(1), width).double()
             * centres(fy.amin(1), fy.amax(1), height).double())
    return int(count[valid].sum())


def _run_rects(width: int, n_runs: int, run_px: int, device) -> tuple:
    """K8's rectangle of pixel centres per run of ``run_px`` flat pixels:
    ``(x_lo, x_hi, y_lo, y_hi)`` f32, the run's columns in its row, or the
    full width where the run wraps a row."""
    first = torch.arange(n_runs, device=device) * run_px
    last = first + run_px - 1
    r0, r1 = first // width, last // width
    one_row = r0 == r1
    x_lo = torch.where(one_row, first % width, torch.zeros_like(first))
    x_hi = torch.where(one_row, last % width, torch.full_like(last, width - 1))
    return (x_lo.float() + 0.5, x_hi.float() + 0.5, r0.float() + 0.5,
            r1.float() + 0.5)


def face_cull_reference(coeffs: torch.Tensor, bbox: torch.Tensor, width: int,
                        height: int, run_px: int = RUN_PX) -> torch.Tensor:
    """The plain version of K8's cull: ``(K, 2)`` int64 rows ``(run,
    column)``, the faces (columns of ``coeffs``) that K8 keeps for each run
    of ``run_px`` flat pixels (``RUN_PX``, what K8 tests; ``GROUP_PX``,
    the first stage of its cull, per group), among the chunks whose bbox meets the run's tile. With
    the kernel's rounding: beta and gamma at the two opposite corners of the
    run's rectangle that the signs of their coefficients pick, alpha's
    bounds from them, and a face dropped only when it is invalid or a bound
    lies outside [0, 1] by an ordered comparison (false on NaN). Rows sorted
    by run, then column."""
    n_tiles = -(-width * height // BLOCK_PX)
    per_tile = BLOCK_PX // run_px
    overlap = _tile_overlap(bbox, width, n_tiles)
    x_lo, x_hi, y_lo, y_hi = (r[:, None] for r in _run_rects(
        width, n_tiles * per_tile, run_px, coeffs.device))
    sub = torch.arange(per_tile, device=coeffs.device)
    kept = []
    for c in range(bbox.shape[0]):
        tiles = overlap[:, c].nonzero()[:, 0]
        if tiles.numel() == 0:
            continue
        runs = (tiles[:, None] * per_tile + sub).reshape(-1)
        cc = coeffs[:, c * BLOCK_F:(c + 1) * BLOCK_F]
        xl, xh, yl, yh = x_lo[runs], x_hi[runs], y_lo[runs], y_hi[runs]

        def corners(a, b, c0):
            xa, xb = torch.where(a >= 0, xh, xl), torch.where(a >= 0, xl, xh)
            ya, yb = torch.where(b >= 0, yh, yl), torch.where(b >= 0, yl, yh)
            return (a * xa + b * ya) + c0, (a * xb + b * yb) + c0
        b_hi, b_lo = corners(cc[0], cc[1], cc[2])
        g_hi, g_lo = corners(cc[3], cc[4], cc[5])
        a_lo = (1.0 - b_hi) - g_hi
        a_hi = (1.0 - b_lo) - g_lo
        drop = ((b_hi < 0) | (b_lo > 1) | (g_hi < 0) | (g_lo > 1) | (a_hi < 0)
                | (a_lo > 1))
        keep = (cc[9] > 0.5) & ~drop
        r, f = keep.nonzero(as_tuple=True)
        kept.append(torch.stack([runs[r], f + c * BLOCK_F], 1))
    if not kept:
        return torch.zeros((0, 2), dtype=torch.int64, device=coeffs.device)
    out = torch.cat(kept)
    return out[torch.argsort(out[:, 0] * coeffs.shape[1] + out[:, 1])]


def raster_reference(coeffs: torch.Tensor, bbox: torch.Tensor, width: int,
                     height: int, tiles_per_pass: int = 64) -> torch.Tensor:
    """The plain version of K8: ``findices`` ``(H*W,)`` int32 from the binned
    inputs of :func:`bin_faces`, as a running minimum of the packed key
    ``zq * 2^31 + face id`` (the lexicographic (depth, face) order; the id is
    below 2^31, so negative depths order correctly) over the face chunks,
    each evaluated on the tiles that its bbox overlaps, ``tiles_per_pass``
    tiles at a time."""
    dev = coeffs.device
    n_pix = width * height
    n_tiles = -(-n_pix // BLOCK_PX)
    overlap = _tile_overlap(bbox, width, n_tiles)
    key = torch.full((n_tiles * BLOCK_PX,), (BIG_Z << 31) + BIG_Z,
                     dtype=torch.int64, device=dev)
    lanes = torch.arange(BLOCK_PX, device=dev)
    for c in range(bbox.shape[0]):
        tiles = overlap[:, c].nonzero()[:, 0]
        if tiles.numel() == 0:
            continue
        cc = coeffs[:, c * BLOCK_F:(c + 1) * BLOCK_F]
        valid = cc[9] > 0.5
        fid = cc[10].long()
        for t0 in range(0, tiles.numel(), tiles_per_pass):
            pix = (tiles[t0:t0 + tiles_per_pass, None] * BLOCK_PX
                   + lanes).reshape(-1)
            px = ((pix % width).float() + 0.5)[:, None]
            py = ((pix // width).float() + 0.5)[:, None]
            beta = cc[0] * px + cc[1] * py + cc[2]
            gamma = cc[3] * px + cc[4] * py + cc[5]
            alpha = 1.0 - beta - gamma
            inside = (valid & (alpha >= 0) & (alpha <= 1) & (beta >= 0)
                      & (beta <= 1) & (gamma >= 0) & (gamma <= 1))
            depth = alpha * cc[6] + beta * cc[7] + gamma * cc[8]
            zq = torch.where(inside, (depth * _ZSCALE).to(torch.int32),
                             BIG_Z).long()
            best = ((zq << 31) + fid).amin(1)
            key[pix] = torch.minimum(key[pix], best)
    z = key >> 31
    f = key & ((1 << 31) - 1)
    out = torch.where(z < BIG_Z, f + 1, torch.zeros_like(f))
    return out[:n_pix].to(torch.int32)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("rasterize")
        lib.m324_rasterize.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.m324_rasterize.restype = ctypes.c_int
        _lib = lib
    return _lib


def raster_kernel(coeffs: torch.Tensor, bbox: torch.Tensor, width: int,
                  height: int) -> torch.Tensor:
    """K8 on CUDA tensors: ``findices`` ``(H*W,)`` int32 from the binned
    inputs of :func:`bin_faces`."""
    if coeffs.device.type != "cuda" or bbox.device != coeffs.device:
        raise ValueError("the K8 kernel takes CUDA tensors on one device")
    if coeffs.dtype != torch.float32 or bbox.dtype != torch.float32:
        raise TypeError("the K8 kernel takes float32 coefficients and bboxes")
    n_chunks = bbox.shape[0]
    if (coeffs.shape != (11, n_chunks * BLOCK_F) or bbox.shape != (n_chunks, 4)
            or not coeffs.is_contiguous() or not bbox.is_contiguous()
            or bbox.data_ptr() % 16):
        raise ValueError(f"K8 takes contiguous coeffs (11, chunks*{BLOCK_F}) "
                         f"and 16-byte aligned bboxes (chunks, 4), got "
                         f"{tuple(coeffs.shape)}, {tuple(bbox.shape)}")
    n_pix = width * height
    out = torch.empty(n_pix, dtype=torch.int32, device=coeffs.device)
    with torch.cuda.device(coeffs.device):
        rc = _load().m324_rasterize(
            coeffs.data_ptr(), bbox.data_ptr(), out.data_ptr(), width, n_pix,
            n_chunks, n_chunks * BLOCK_F, torch.cuda.current_stream(coeffs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rasterize launch failed: CUDA error {rc}")
    rasterize.launches += 1
    return out


def barycentrics(pos, faces, findices, width: int, height: int):
    """Perspective-corrected barycentrics ``(H, W, 3)`` for the winning
    faces, 0 on background."""
    x, y, _, inv_w = _screen_transform(pos, width, height)
    tri = faces[(findices - 1).clamp(min=0).long()]
    ax, ay = x[tri[..., 0]], y[tri[..., 0]]
    bx_, by_ = x[tri[..., 1]], y[tri[..., 1]]
    cx, cy = x[tri[..., 2]], y[tri[..., 2]]
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=pos.device) + 0.5,
        torch.arange(width, dtype=torch.float32, device=pos.device) + 0.5,
        indexing="ij")
    area = (cx - ax) * (by_ - ay) - (bx_ - ax) * (cy - ay)
    inv = torch.where(area.abs() > 0,
                      1.0 / torch.where(area == 0, torch.ones_like(area), area),
                      torch.zeros_like(area))
    beta = ((cx - ax) * (py - ay) - (px - ax) * (cy - ay)) * inv
    gamma = ((px - ax) * (by_ - ay) - (bx_ - ax) * (py - ay)) * inv
    alpha = 1.0 - beta - gamma
    bary = torch.stack([alpha, beta, gamma], -1)
    bw = bary * torch.stack([inv_w[tri[..., 0]], inv_w[tri[..., 1]],
                             inv_w[tri[..., 2]]], -1)
    bary_pc = bw / bw.sum(-1, keepdim=True)
    covered = (findices > 0)[..., None]
    return torch.where(covered, bary_pc, torch.zeros_like(bary_pc)).float()


def interpolate(attrs, findices, bary, faces):
    """Gather and blend per-vertex attributes ``(V, C)`` onto the image
    ``(H, W, C)`` with the barycentrics; 0 on background."""
    tri = faces[(findices - 1).clamp(min=0).long()]
    vals = attrs[tri]                                   # (H, W, 3, C)
    out = ((bary[..., 0:1] * vals[..., 0, :] + bary[..., 1:2] * vals[..., 1, :])
           + bary[..., 2:3] * vals[..., 2, :])
    return torch.where((findices > 0)[..., None], out, torch.zeros_like(out))


def rasterize(pos, faces, width: int, height: int):
    """Rasterize clip-space triangles: ``pos`` ``(V, 4)``, ``faces`` ``(F,
    3)``. Returns ``(findices (H, W) int32, bary (H, W, 3) f32)`` on pos's
    device: face id + 1 (0 = background) and perspective-corrected
    barycentrics. CUDA: K8; CPU: :func:`raster_reference`."""
    pos = torch.as_tensor(pos, dtype=torch.float32)
    faces = torch.as_tensor(faces, device=pos.device).long()
    coeffs, bbox = bin_faces(pos, faces, width, height)
    if pos.device.type == "cuda":
        find = raster_kernel(coeffs, bbox, width, height)
    elif pos.device.type == "cpu":
        find = raster_reference(coeffs, bbox, width, height)
    else:
        raise ValueError(f"rasterize runs on cuda or cpu, not {pos.device}")
    find = find.reshape(height, width)
    return find, barycentrics(pos, faces, find, width, height)


rasterize.launches = 0


def rasterize_reference(pos: np.ndarray, faces: np.ndarray, width: int,
                        height: int) -> np.ndarray:
    """The numpy f64 oracle of the reference rasterizer's CPU semantics:
    every face over its bbox, the packed ``zq * MAXINT + face + 1`` token,
    no binning. Returns ``findices`` ``(H, W)`` int32."""
    pos = np.asarray(pos, np.float64)
    x, y, z, _ = _screen_transform(pos, width, height)
    zbuffer = np.full(width * height, (2 ** 62), np.int64)
    maxint = 2147483647
    for f, (i0, i1, i2) in enumerate(np.asarray(faces)):
        v0 = np.array([x[i0], y[i0], z[i0]])
        v1 = np.array([x[i1], y[i1], z[i1]])
        v2 = np.array([x[i2], y[i2], z[i2]])
        x_min = int(np.floor(min(v0[0], v1[0], v2[0])))
        x_max = int(np.floor(max(v0[0], v1[0], v2[0]) + 1))
        y_min = int(np.floor(min(v0[1], v1[1], v2[1])))
        y_max = int(np.floor(max(v0[1], v1[1], v2[1]) + 1))
        area = (v2[0] - v0[0]) * (v1[1] - v0[1]) - (v1[0] - v0[0]) * (v2[1] - v0[1])
        if area == 0:
            continue
        for pxi in range(max(x_min, 0), min(x_max + 1, width)):
            for pyi in range(max(y_min, 0), min(y_max + 1, height)):
                p = (pxi + 0.5, pyi + 0.5)
                beta = ((v2[0] - v0[0]) * (p[1] - v0[1])
                        - (p[0] - v0[0]) * (v2[1] - v0[1])) / area
                gamma = ((p[0] - v0[0]) * (v1[1] - v0[1])
                         - (v1[0] - v0[0]) * (p[1] - v0[1])) / area
                alpha = 1.0 - beta - gamma
                if not (0 <= alpha <= 1 and 0 <= beta <= 1 and 0 <= gamma <= 1):
                    continue
                depth = alpha * v0[2] + beta * v1[2] + gamma * v2[2]
                zq = int(depth * (2 << 17))
                token = zq * maxint + (f + 1)
                pix = pyi * width + pxi
                zbuffer[pix] = min(zbuffer[pix], token)
    find = (zbuffer % maxint).astype(np.int64)
    find[zbuffer >= 2 ** 62] = 0
    return find.reshape(height, width).astype(np.int32)
