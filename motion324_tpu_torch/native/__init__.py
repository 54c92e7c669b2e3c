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
  fast marching, the semantics of ``cv2.inpaint(..., cv2.INPAINT_NS)``;
- :func:`build_hierarchy`: the sparse voxel hierarchy (neighbour tables,
  parent maps, corner flags) of three layered orthographic position maps,
  the voxel backbone of FlashVDM texgen turbo attention; no path of the
  port calls it;
- :func:`murmur3_x64_128` and :func:`spooky_hash128`: the 128-bit hashes
  of the Alembic writer (:mod:`motion324_tpu_torch.io.abc`), held against
  the numpy versions :func:`murmur3_x64_128_numpy` and
  :func:`spooky_hash128_numpy`.

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
import struct
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["marching_cubes", "qem_simplify", "trilinear_upsample",
           "shell_indices", "vertex_inpaint", "vertex_inpaint_numpy",
           "inpaint_ns", "murmur3_x64_128", "murmur3_x64_128_numpy",
           "spooky_hash128", "spooky_hash128_numpy", "build_hierarchy",
           "build"]

_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _DIR.parent / "build"
_SOURCES = ("marching_cubes.cpp", "qem_simplify.cpp", "trilinear.cpp",
            "shell.cpp", "mesh_processor.cpp", "inpaint.cpp", "hashes.cpp",
            "grid_hierarchy.cpp")
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
        u64 = ctypes.c_uint64
        lib.murmur3_x64_128.argtypes = [p, u64, ctypes.c_uint32, p]
        lib.spooky_hash128.argtypes = [p, u64, u64, u64, p]
        lib.build_hierarchy.argtypes = ([p, i, p] * 3 + [i, i, i, i]
                                        + [p, i, p, p, p, i, p, p, i, p, p])
        for fn in (lib.marching_tetrahedra, lib.qem_simplify,
                   lib.trilinear_upsample, lib.shell_indices,
                   lib.vertex_inpaint, lib.inpaint_ns, lib.murmur3_x64_128,
                   lib.spooky_hash128, lib.build_hierarchy):
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


# --------------------------------------------------------------------------- #
# 128-bit hashes for Alembic sample keys / object hash trailers (io/abc.py)
# --------------------------------------------------------------------------- #
def _rotl64(x: int, r: int) -> int:
    x &= 0xFFFFFFFFFFFFFFFF
    return ((x << r) | (x >> (64 - r))) & 0xFFFFFFFFFFFFFFFF


def murmur3_x64_128_numpy(data: bytes, seed: int = 0) -> bytes:
    """Pure-Python MurmurHash3_x64_128 (Appleby, public domain), the plain
    version of :func:`murmur3_x64_128`."""
    M = 0xFFFFFFFFFFFFFFFF
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F
    h1 = h2 = seed & 0xFFFFFFFF
    length = len(data)
    nblocks = length // 16
    if nblocks:
        blocks = np.frombuffer(data[:nblocks * 16], "<u8").reshape(-1, 2)
        for k1, k2 in blocks.tolist():
            k1 = _rotl64(k1 * c1 & M, 31) * c2 & M
            h1 = (_rotl64(h1 ^ k1, 27) + h2) & M
            h1 = (h1 * 5 + 0x52DCE729) & M
            k2 = _rotl64(k2 * c2 & M, 33) * c1 & M
            h2 = (_rotl64(h2 ^ k2, 31) + h1) & M
            h2 = (h2 * 5 + 0x38495AB5) & M
    tail = data[nblocks * 16:]
    k1 = k2 = 0
    for i in range(min(len(tail), 16) - 1, 7, -1):
        k2 |= tail[i] << (8 * (i - 8))
    for i in range(min(len(tail), 8) - 1, -1, -1):
        k1 |= tail[i] << (8 * i)
    if len(tail) > 8:
        h2 ^= _rotl64(k2 * c2 & M, 33) * c1 & M
    if len(tail) > 0:
        h1 ^= _rotl64(k1 * c1 & M, 31) * c2 & M
    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M

    def fmix(k):
        k ^= k >> 33
        k = k * 0xFF51AFD7ED558CCD & M
        k ^= k >> 33
        k = k * 0xC4CEB9FE1A85EC53 & M
        return k ^ (k >> 33)

    h1, h2 = fmix(h1), fmix(h2)
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M
    return struct.pack("<QQ", h1, h2)


def murmur3_x64_128(data: bytes, seed: int = 0) -> bytes:
    """16-byte MurmurHash3_x64_128 digest (``hashes.cpp``): the hash
    Alembic >= 1.5 computes for array/scalar sample keys (seed = the POD
    byte size); :func:`murmur3_x64_128_numpy` is its plain version."""
    return _hash128(_get().murmur3_x64_128, data, ctypes.c_uint32(seed))


def _hash128(fn, data: bytes, *seeds) -> bytes:
    buf = np.frombuffer(bytes(data), np.uint8)
    out = np.empty(2, np.uint64)
    rc = fn(_ptr(buf) if len(buf) else None, len(buf), *seeds, _ptr(out))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed with code {rc}")
    return out.tobytes()


def spooky_hash128_numpy(data: bytes, seed1: int = 0, seed2: int = 0) -> bytes:
    """Pure-Python SpookyHash V2 (Jenkins, public domain), 128-bit one-shot.

    The plain version of :func:`spooky_hash128`, transcribed from the
    published algorithm independently of ``hashes.cpp``.
    """
    M = 0xFFFFFFFFFFFFFFFF
    SC = 0xDEADBEEFDEADBEEF
    length = len(data)

    if length < 192:
        remainder = length % 32
        a, b, c, d = seed1 & M, seed2 & M, SC, SC

        def short_mix(h):
            h[2] = (_rotl64(h[2], 50) + h[3]) & M; h[0] ^= h[2]
            h[3] = (_rotl64(h[3], 52) + h[0]) & M; h[1] ^= h[3]
            h[0] = (_rotl64(h[0], 30) + h[1]) & M; h[2] ^= h[0]
            h[1] = (_rotl64(h[1], 41) + h[2]) & M; h[3] ^= h[1]
            h[2] = (_rotl64(h[2], 54) + h[3]) & M; h[0] ^= h[2]
            h[3] = (_rotl64(h[3], 48) + h[0]) & M; h[1] ^= h[3]
            h[0] = (_rotl64(h[0], 38) + h[1]) & M; h[2] ^= h[0]
            h[1] = (_rotl64(h[1], 37) + h[2]) & M; h[3] ^= h[1]
            h[2] = (_rotl64(h[2], 62) + h[3]) & M; h[0] ^= h[2]
            h[3] = (_rotl64(h[3], 34) + h[0]) & M; h[1] ^= h[3]
            h[0] = (_rotl64(h[0], 5) + h[1]) & M; h[2] ^= h[0]
            h[1] = (_rotl64(h[1], 36) + h[2]) & M; h[3] ^= h[1]

        pos = 0
        if length > 15:
            h = [a, b, c, d]
            for pos in range(0, (length // 32) * 32, 32):
                w = struct.unpack_from("<4Q", data, pos)
                h[2] = (h[2] + w[0]) & M
                h[3] = (h[3] + w[1]) & M
                short_mix(h)
                h[0] = (h[0] + w[2]) & M
                h[1] = (h[1] + w[3]) & M
            pos = (length // 32) * 32
            if remainder >= 16:
                w = struct.unpack_from("<2Q", data, pos)
                h[2] = (h[2] + w[0]) & M
                h[3] = (h[3] + w[1]) & M
                short_mix(h)
                pos += 16
                remainder -= 16
            a, b, c, d = h
        d = (d + ((length << 56) & M)) & M
        rb = data[pos:pos + remainder] + b"\x00" * (16 - remainder)
        if remainder == 0:
            c = (c + SC) & M
            d = (d + SC) & M
        elif remainder <= 3:
            c = (c + int.from_bytes(rb[:remainder], "little")) & M
        elif remainder <= 7:
            c = (c + int.from_bytes(rb[:max(4, remainder)][:remainder],
                                    "little")) & M
        elif remainder == 8:
            c = (c + struct.unpack("<Q", rb[:8])[0]) & M
        elif remainder <= 11:
            d = (d + int.from_bytes(rb[8:remainder], "little")) & M
            c = (c + struct.unpack("<Q", rb[:8])[0]) & M
        elif remainder == 12:
            d = (d + struct.unpack("<I", rb[8:12])[0]) & M
            c = (c + struct.unpack("<Q", rb[:8])[0]) & M
        else:  # 13..15
            d = (d + int.from_bytes(rb[8:remainder], "little")) & M
            c = (c + struct.unpack("<Q", rb[:8])[0]) & M
        h = [a, b, c, d]
        # short_end
        h[3] ^= h[2]; h[2] = _rotl64(h[2], 15); h[3] = (h[3] + h[2]) & M
        h[0] ^= h[3]; h[3] = _rotl64(h[3], 52); h[0] = (h[0] + h[3]) & M
        h[1] ^= h[0]; h[0] = _rotl64(h[0], 26); h[1] = (h[1] + h[0]) & M
        h[2] ^= h[1]; h[1] = _rotl64(h[1], 51); h[2] = (h[2] + h[1]) & M
        h[3] ^= h[2]; h[2] = _rotl64(h[2], 28); h[3] = (h[3] + h[2]) & M
        h[0] ^= h[3]; h[3] = _rotl64(h[3], 9); h[0] = (h[0] + h[3]) & M
        h[1] ^= h[0]; h[0] = _rotl64(h[0], 47); h[1] = (h[1] + h[0]) & M
        h[2] ^= h[1]; h[1] = _rotl64(h[1], 54); h[2] = (h[2] + h[1]) & M
        h[3] ^= h[2]; h[2] = _rotl64(h[2], 32); h[3] = (h[3] + h[2]) & M
        h[0] ^= h[3]; h[3] = _rotl64(h[3], 25); h[0] = (h[0] + h[3]) & M
        h[1] ^= h[0]; h[0] = _rotl64(h[0], 63); h[1] = (h[1] + h[0]) & M
        return struct.pack("<QQ", h[0], h[1])

    # long-message path
    s = [0] * 12
    s[0] = s[3] = s[6] = s[9] = seed1 & M
    s[1] = s[4] = s[7] = s[10] = seed2 & M
    s[2] = s[5] = s[8] = s[11] = SC

    rot = (11, 32, 43, 31, 17, 28, 39, 57, 55, 54, 22, 46)

    def mix(w):
        for i in range(12):
            s[i] = (s[i] + w[i]) & M
            s[(i + 2) % 12] ^= s[(i + 10) % 12]
            s[(i + 11) % 12] ^= s[i]
            s[i] = _rotl64(s[i], rot[i])
            s[(i + 11) % 12] = (s[(i + 11) % 12] + s[(i + 1) % 12]) & M

    nblocks = length // 96
    for i in range(nblocks):
        mix(struct.unpack_from("<12Q", data, i * 96))
    remainder = length - nblocks * 96
    tail = bytearray(96)
    tail[:remainder] = data[nblocks * 96:]
    tail[95] = remainder
    w = struct.unpack("<12Q", bytes(tail))

    def end_partial(h):
        h[11] = (h[11] + h[1]) & M; h[2] ^= h[11]; h[1] = _rotl64(h[1], 44)
        h[0] = (h[0] + h[2]) & M; h[3] ^= h[0]; h[2] = _rotl64(h[2], 15)
        h[1] = (h[1] + h[3]) & M; h[4] ^= h[1]; h[3] = _rotl64(h[3], 34)
        h[2] = (h[2] + h[4]) & M; h[5] ^= h[2]; h[4] = _rotl64(h[4], 21)
        h[3] = (h[3] + h[5]) & M; h[6] ^= h[3]; h[5] = _rotl64(h[5], 38)
        h[4] = (h[4] + h[6]) & M; h[7] ^= h[4]; h[6] = _rotl64(h[6], 33)
        h[5] = (h[5] + h[7]) & M; h[8] ^= h[5]; h[7] = _rotl64(h[7], 10)
        h[6] = (h[6] + h[8]) & M; h[9] ^= h[6]; h[8] = _rotl64(h[8], 13)
        h[7] = (h[7] + h[9]) & M; h[10] ^= h[7]; h[9] = _rotl64(h[9], 38)
        h[8] = (h[8] + h[10]) & M; h[11] ^= h[8]; h[10] = _rotl64(h[10], 53)
        h[9] = (h[9] + h[11]) & M; h[0] ^= h[9]; h[11] = _rotl64(h[11], 42)
        h[10] = (h[10] + h[0]) & M; h[1] ^= h[10]; h[0] = _rotl64(h[0], 54)

    for i in range(12):
        s[i] = (s[i] + w[i]) & M
    end_partial(s)
    end_partial(s)
    end_partial(s)
    return struct.pack("<QQ", s[0], s[1])


def spooky_hash128(data: bytes, seed1: int = 0, seed2: int = 0) -> bytes:
    """16-byte SpookyHash V2 digest (``hashes.cpp``), the AbcCoreOgawa
    per-object [properties | children] hash trailer;
    :func:`spooky_hash128_numpy` is its plain version."""
    return _hash128(_get().spooky_hash128, data, ctypes.c_uint64(seed1),
                    ctypes.c_uint64(seed2))


def build_hierarchy(view_positions, view_normals, num_level: int = 3,
                    resolution: int = 256) -> dict:
    """Sparse voxel hierarchy from three orthographic layered position maps
    (reference: .../custom_rasterizer_kernel/grid_neighbor.cpp:311-433).

    ``view_positions``: three ``(L, H, W, 4)`` float32 arrays, xyz and a
    validity flag (0 = empty pixel); ``view_normals``: three ``(L, H, W,
    3)``. Returns ``positions`` (N0, 3) level-0 voxel centres (seen and
    padded), ``origin_mask`` (N0,) (1 = seen), and per level ``neighbors``
    (Nl, 9) int64 (-1 absent), ``downsample`` (Nl,) parent indices (all
    levels but the last), ``even_corners`` / ``odd_corners`` (Nl,) flags,
    and ``level_sizes``."""
    lib = _get()
    vp = [np.ascontiguousarray(a, np.float32) for a in view_positions]
    vn = [np.ascontiguousarray(a, np.float32) for a in view_normals]
    if len(vp) != 3 or len(vn) != 3:
        raise ValueError("exactly 3 views required")
    h, w = vp[0].shape[1], vp[0].shape[2]
    cap_pos = 1 << 18
    for _ in range(8):
        cap_nb = cap_pos * 2 * 9
        positions = np.empty((cap_pos, 3), np.float32)
        origin = np.empty(cap_pos, np.float32)
        neighbors = np.empty(cap_nb, np.int64)
        level_sizes = np.zeros(num_level, np.int32)
        downsample = np.empty(cap_pos * 2, np.int64)
        even = np.empty(cap_nb // 9, np.int64)
        odd = np.empty(cap_nb // 9, np.int64)
        n_pos = ctypes.c_int(0)
        views = []
        for a, n in zip(vp, vn):
            views += [_ptr(a), a.shape[0], _ptr(n)]
        ret = lib.build_hierarchy(
            *views, h, w, num_level, resolution, _ptr(positions), cap_pos,
            ctypes.byref(n_pos), _ptr(origin), _ptr(neighbors), cap_nb,
            _ptr(level_sizes), _ptr(downsample), cap_pos * 2, _ptr(even),
            _ptr(odd))
        if ret in (3, 4, 5):      # an output buffer too small: grow them all
            cap_pos *= 2
            continue
        if ret != 0:
            raise RuntimeError(f"build_hierarchy failed with code {ret}")
        sizes = level_sizes.tolist()
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        return {"positions": positions[:n_pos.value].copy(),
                "origin_mask": origin[:n_pos.value].copy(),
                "neighbors": [neighbors[a * 9:b * 9].reshape(-1, 9).copy()
                              for a, b in zip(offsets[:-1], offsets[1:])],
                "downsample": [downsample[a:b].copy() for a, b in
                               zip(offsets[:-2], offsets[1:-1])],
                "even_corners": [even[a:b].copy()
                                 for a, b in zip(offsets[:-1], offsets[1:])],
                "odd_corners": [odd[a:b].copy()
                                for a, b in zip(offsets[:-1], offsets[1:])],
                "level_sizes": sizes}
    raise RuntimeError("build_hierarchy: capacity negotiation failed")
