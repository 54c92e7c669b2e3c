"""Host C++ helpers of shape generation, built with g++ and loaded with ctypes.

- :func:`marching_cubes`: iso-surface extraction (marching tetrahedra);
- :func:`qem_simplify`: quadric-error-metric edge-collapse decimation;
- :func:`trilinear_upsample`: edge-aligned integer-factor upsample of a
  cubic node grid (the hierarchical volume decode's coarse -> fine step);
- :func:`shell_indices`: flat indices of the dilated ``|v| < band`` shell,
  optionally ordered by spatial cell (the refinement point set);
- :func:`vertex_inpaint`: UV-seam vertex colour diffusion of a baked
  texture (texture generation), held against :func:`vertex_inpaint_numpy`;
- :func:`inpaint_ns`: the Navier-Stokes hole fill of an RGB uint8 image by
  fast marching, the semantics of ``cv2.inpaint(..., cv2.INPAINT_NS)``.

The sources here are the port's own copies. They are compiled at first use
with ``g++ -O3 -shared -fPIC`` into ``motion324_tpu_torch/build/``, keyed by
a hash of the sources and flags; the library is written to a temporary file
and moved into place with ``os.replace``, so that processes building at once
do not see a half-written file. A failed build raises: there is no silent
fallback. The numpy versions of the upsample and the shell
(:mod:`motion324_tpu_torch.hy3dgen.volume`) are the plain versions the tests
hold these against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["marching_cubes", "qem_simplify", "trilinear_upsample",
           "shell_indices", "vertex_inpaint", "vertex_inpaint_numpy",
           "inpaint_ns", "build"]

_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _DIR.parent / "build"
_SOURCES = ("marching_cubes.cpp", "qem_simplify.cpp", "trilinear.cpp",
            "shell.cpp", "mesh_processor.cpp", "inpaint.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC"]
_lib: ctypes.CDLL | None = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SOURCES:
        h.update((_DIR / s).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if no build of these sources exists; returns its
    path. Raises with g++'s output if the build fails."""
    so = _BUILD_DIR / f"libnative_{_digest()}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), *(str(_DIR / s) for s in _SOURCES)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the native helpers:\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


def _get() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.marching_tetrahedra.argtypes = [p, i, i, i, f, p, i, p, p, i, p]
        lib.qem_simplify.argtypes = [p, i, p, i, i, f, p, p, p, p]
        lib.trilinear_upsample.argtypes = [p, ctypes.c_int32, ctypes.c_int32, p]
        lib.shell_indices.argtypes = [p, ctypes.c_int32, f, ctypes.c_int32,
                                      ctypes.c_int32, p, ctypes.c_int64, p]
        lib.vertex_inpaint.argtypes = [p, p, i, i, i, p, i, p, i, p, p, i, p, p]
        lib.inpaint_ns.argtypes = [p, p, i, i, i, p]
        for fn in (lib.marching_tetrahedra, lib.qem_simplify,
                   lib.trilinear_upsample, lib.shell_indices,
                   lib.vertex_inpaint, lib.inpaint_ns):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def marching_cubes(grid: np.ndarray, iso: float = 0.0,
                   bounds: tuple | None = None):
    """Iso-surface of an ``(nx, ny, nz)`` scalar field by marching
    tetrahedra, vertices welded on shared edges. With ``bounds`` =
    ``((xmin, ymin, zmin), (xmax, ymax, zmax))`` the vertices are mapped from
    grid-index space into that box. Returns ``(vertices (V, 3) float32,
    faces (F, 3) int32)``."""
    lib = _get()
    grid = np.ascontiguousarray(grid, np.float32)
    nx, ny, nz = grid.shape
    cap_v, cap_t = 1 << 18, 1 << 19
    for _ in range(8):
        verts = np.empty((cap_v, 3), np.float32)
        tris = np.empty((cap_t, 3), np.int32)
        nv, nt = ctypes.c_int(0), ctypes.c_int(0)
        ret = lib.marching_tetrahedra(_ptr(grid), nx, ny, nz, iso, _ptr(verts),
                                      cap_v, ctypes.byref(nv), _ptr(tris),
                                      cap_t, ctypes.byref(nt))
        if ret == 0:
            v = verts[:nv.value].copy()
            f = tris[:nt.value].copy()
            if bounds is not None:
                lo = np.asarray(bounds[0], np.float32)
                hi = np.asarray(bounds[1], np.float32)
                span = np.array([nx - 1, ny - 1, nz - 1], np.float32)
                v = lo + v / span * (hi - lo)
            return v, f
        cap_v = max(cap_v * 2, nv.value + 1)
        cap_t = max(cap_t * 2, nt.value + 1)
    raise RuntimeError("marching_tetrahedra: capacity negotiation failed")


def qem_simplify(vertices: np.ndarray, faces: np.ndarray, target_faces: int,
                 aggressiveness: float = 7.0):
    """Garland-Heckbert edge collapse (boundary locking, flip rejection) to
    at most ``target_faces`` faces where reachable. Returns ``(vertices
    float32, faces int32)``."""
    lib = _get()
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    out_v = np.empty_like(vertices)
    out_f = np.empty_like(faces)
    onv, onf = ctypes.c_int(0), ctypes.c_int(0)
    ret = lib.qem_simplify(_ptr(vertices), len(vertices), _ptr(faces),
                           len(faces), int(target_faces), aggressiveness,
                           _ptr(out_v), ctypes.byref(onv), _ptr(out_f),
                           ctypes.byref(onf))
    if ret != 0:
        raise RuntimeError(f"qem_simplify failed with code {ret}")
    return out_v[:onv.value].copy(), out_f[:onf.value].copy()


def trilinear_upsample(coarse: np.ndarray, factor: int) -> np.ndarray:
    """``(c, c, c)`` node grid -> ``((c-1)*factor + 1,)**3`` by edge-aligned
    trilinear interpolation (float32)."""
    lib = _get()
    coarse = np.ascontiguousarray(coarse, np.float32)
    c = coarse.shape[0]
    if coarse.shape != (c, c, c) or factor < 1:
        raise ValueError(f"need a cubic grid and factor >= 1, got "
                         f"{coarse.shape}, {factor}")
    r = (c - 1) * factor + 1
    out = np.empty((r, r, r), np.float32)
    rc = lib.trilinear_upsample(_ptr(coarse), c, factor, _ptr(out))
    if rc != 0:
        raise RuntimeError(f"trilinear_upsample failed with code {rc}")
    return out


def shell_indices(volume: np.ndarray, band: float, iters: int,
                  sort_grid: int) -> np.ndarray:
    """int32 flat indices of the voxels with ``|volume| < band`` after
    ``iters`` cross dilations, ordered by ``sort_grid``^3 spatial cell
    (stable within a cell; ``sort_grid=1`` keeps lexicographic order)."""
    lib = _get()
    volume = np.ascontiguousarray(volume, np.float32)
    r = volume.shape[0]
    if volume.shape != (r, r, r):
        raise ValueError(f"volume must be cubic, got {volume.shape}")
    cap = max(r * r * 8, 1 << 16)
    for _ in range(2):
        out = np.empty(cap, np.int32)
        n = ctypes.c_int64(0)
        rc = lib.shell_indices(_ptr(volume), r, band, iters, sort_grid,
                               _ptr(out), cap, ctypes.byref(n))
        if rc == 0:
            return out[:n.value].copy()
        if rc != 3:
            break
        cap = n.value
    raise RuntimeError(f"shell_indices failed with code {rc}")


def vertex_inpaint(texture: np.ndarray, mask: np.ndarray, vtx_pos: np.ndarray,
                   vtx_uv: np.ndarray, pos_idx: np.ndarray,
                   uv_idx: np.ndarray):
    """UV-seam vertex colour diffusion (``mesh_processor.cpp``).

    ``texture`` (H, W, C) f32, ``mask`` (H, W) uint8 (> 0 = coloured),
    ``vtx_pos`` (V, 3), ``vtx_uv`` (U, 2), ``pos_idx`` / ``uv_idx`` (F, 3).
    Returns ``(texture (H, W, C) f32, mask (H, W) uint8)``."""
    lib = _get()
    texture = np.ascontiguousarray(texture, np.float32)
    mask = np.ascontiguousarray(mask, np.uint8)
    vtx_pos = np.ascontiguousarray(vtx_pos, np.float32)
    vtx_uv = np.ascontiguousarray(vtx_uv, np.float32)
    pos_idx = np.ascontiguousarray(pos_idx, np.int32)
    uv_idx = np.ascontiguousarray(uv_idx, np.int32)
    h, w, c = texture.shape
    out_tex = np.empty_like(texture)
    out_mask = np.empty_like(mask)
    rc = lib.vertex_inpaint(_ptr(texture), _ptr(mask), h, w, c, _ptr(vtx_pos),
                            len(vtx_pos), _ptr(vtx_uv), len(vtx_uv),
                            _ptr(pos_idx), _ptr(uv_idx), len(pos_idx),
                            _ptr(out_tex), _ptr(out_mask))
    if rc != 0:
        raise RuntimeError(f"vertex_inpaint failed with code {rc}")
    return out_tex, out_mask


def vertex_inpaint_numpy(texture, mask, vtx_pos, vtx_uv, pos_idx, uv_idx):
    """The plain numpy version of :func:`vertex_inpaint`, the same contract
    step by step (slow: for tests at small sizes)."""
    texture = np.asarray(texture, np.float32)
    mask = np.asarray(mask)
    h, w, c = texture.shape
    n_vtx = len(vtx_pos)
    vtx_mask = np.zeros(n_vtx, bool)
    vtx_color = np.zeros((n_vtx, c), np.float32)
    uncolored: list[int] = []
    adj: list[list[int]] = [[] for _ in range(n_vtx)]

    def texel(uvi):
        col = int(round(float(vtx_uv[uvi, 0]) * (w - 1)))
        row = int(round((1.0 - float(vtx_uv[uvi, 1])) * (h - 1)))
        return min(max(row, 0), h - 1), min(max(col, 0), w - 1)

    for f in range(len(pos_idx)):
        for k in range(3):
            vi = int(pos_idx[f, k])
            row, col = texel(int(uv_idx[f, k]))
            if mask[row, col] > 0:
                vtx_mask[vi] = True
                vtx_color[vi] = texture[row, col]
            else:
                uncolored.append(vi)
            adj[vi].append(int(pos_idx[f, (k + 1) % 3]))

    stall, last_remaining = 2, 0
    while stall > 0:
        remaining = 0
        for vi in uncolored:
            total, acc = 0.0, np.zeros(c, np.float32)
            for nb in adj[vi]:
                if not vtx_mask[nb]:
                    continue
                dist = float(np.sqrt(np.sum((vtx_pos[vi] - vtx_pos[nb]) ** 2)))
                wgt = (1.0 / max(dist, 1e-4)) ** 2
                acc += vtx_color[nb] * wgt
                total += wgt
            if total > 0:
                vtx_color[vi] = acc / total
                vtx_mask[vi] = True
            else:
                remaining += 1
        stall = stall - 1 if remaining == last_remaining else stall + 1
        last_remaining = remaining

    out_tex = texture.copy()
    out_mask = mask.copy()
    for f in range(len(pos_idx)):
        for k in range(3):
            vi = int(pos_idx[f, k])
            if vtx_mask[vi]:
                row, col = texel(int(uv_idx[f, k]))
                out_tex[row, col] = vtx_color[vi]
                out_mask[row, col] = 255
    return out_tex, out_mask


def inpaint_ns(image: np.ndarray, mask: np.ndarray, radius: int = 3) -> np.ndarray:
    """Fill the pixels of an (H, W, 3) uint8 image where ``mask`` (H, W) is
    non-zero, by Navier-Stokes fast marching within ``radius`` pixels
    (``inpaint.cpp``); the other pixels are returned as they are."""
    lib = _get()
    image = np.ascontiguousarray(image, np.uint8)
    mask = np.ascontiguousarray(mask, np.uint8)
    if image.ndim != 3 or image.shape[2] != 3 or mask.shape != image.shape[:2]:
        raise ValueError(f"inpaint_ns takes an (H, W, 3) image and an (H, W) "
                         f"mask, got {image.shape}, {mask.shape}")
    out = np.empty_like(image)
    rc = lib.inpaint_ns(_ptr(image), _ptr(mask), image.shape[0],
                        image.shape[1], int(radius), _ptr(out))
    if rc != 0:
        raise RuntimeError(f"inpaint_ns failed with code {rc}")
    return out
