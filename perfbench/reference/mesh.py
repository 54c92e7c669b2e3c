"""The host stages of the clip path in plain numpy: unit-cube
normalisation, area-weighted surface sampling with texture colours, vertex
normals, nearest-sample colour transfer, trajectory smoothing, the
(x, y, z) -> (x, -z, y) remap for Blender, and a reader of an animated
GLB's morph targets. Frozen copies of the published behaviour (Motion324's
``utils/mesh_processing.py`` and ``utils/inference_utils.py``), written
apart from the system under test."""

from __future__ import annotations

import json
import struct

import numpy as np


def normalize_unit_cube(v):
    """Centre on the bbox midpoint; the largest half-extent becomes 0.5."""
    v = v.astype(np.float32)
    center = (v.max(axis=0) + v.min(axis=0)) / 2
    v = v - center
    return v / (2 * (np.abs(v).max() + 1e-8))


def face_normals(v, f):
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    return (n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)).astype(np.float32)


def vertex_normals(v, f):
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v, dtype=np.float64)
    for i in range(3):
        np.add.at(vn, f[:, i], fn)
    return (vn / (np.linalg.norm(vn, axis=-1, keepdims=True) + 1e-12)).astype(np.float32)


def sample_with_texture(v, f, uv, texture, n, seed=0):
    """Area-weighted surface samples: points, face normals and the nearest
    texel's colour (V flipped) at each sample's barycentric UV."""
    rng = np.random.RandomState(seed)
    tri = v[f]
    areas = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                          tri[:, 2] - tri[:, 0]), axis=-1)
    face = rng.choice(len(areas), size=n, p=areas / areas.sum())
    r1 = np.sqrt(rng.rand(n).astype(np.float32))
    r2 = rng.rand(n).astype(np.float32)
    bary = np.stack([1 - r1, r1 * (1 - r2), r1 * r2], -1).astype(np.float32)
    pts = np.einsum("nk,nkd->nd", bary, tri[face]).astype(np.float32)
    suv = np.einsum("nk,nkd->nd", bary, uv[f[face]]) % 1.0
    h, w = texture.shape[:2]
    col = texture[np.clip(((1.0 - suv[:, 1]) * h).astype(np.int64), 0, h - 1),
                  np.clip((suv[:, 0] * w).astype(np.int64), 0, w - 1), :3]
    return pts, face_normals(v, f)[face], col.astype(np.float32)


def nearest_colors(pts, colors, query):
    from scipy.spatial import cKDTree
    return colors[cKDTree(pts).query(query, k=1)[1]]


def smooth(trajs, motion_threshold=0.002, sigma=1.0):
    """The shipped ``combined`` smoothing of (T, N, 3): freeze a point
    whose raw frame-to-frame step is below the threshold, then a Gaussian
    over time (mode 'nearest')."""
    from scipy.ndimage import gaussian_filter1d
    trajs = np.asarray(trajs, np.float32)
    out = trajs.copy()
    for t in range(1, len(trajs)):
        still = np.linalg.norm(trajs[t] - trajs[t - 1], axis=-1) < motion_threshold
        out[t] = np.where(still[:, None], out[t - 1], out[t])
    return gaussian_filter1d(out, sigma=sigma, axis=0, mode="nearest").astype(np.float32)


def to_blender(x):
    out = x.copy()
    out[..., 1] = -x[..., 2]
    out[..., 2] = x[..., 1]
    return out


_TYPES = {5126: np.float32, 5125: np.uint32}
_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3}


def read_morph_glb(path):
    """(base (V, 3), faces (F, 3), frames (T, V, 3)) of an animated GLB
    whose frame t switches morph target t on, as glTF 2.0 defines it."""
    with open(path, "rb") as fh:
        data = fh.read()
    n_json = struct.unpack_from("<I", data, 12)[0]
    gltf = json.loads(data[20:20 + n_json])
    binary = data[28 + n_json:]

    def acc(i):
        a = gltf["accessors"][i]
        view = gltf["bufferViews"][a["bufferView"]]
        k = _COUNTS[a["type"]]
        arr = np.frombuffer(binary, _TYPES[a["componentType"]], a["count"] * k,
                            view.get("byteOffset", 0) + a.get("byteOffset", 0))
        return arr.reshape(a["count"], k) if k > 1 else arr

    prim = gltf["meshes"][0]["primitives"][0]
    base = acc(prim["attributes"]["POSITION"]).astype(np.float32)
    faces = acc(prim["indices"]).reshape(-1, 3).astype(np.int64)
    sampler = gltf["animations"][0]["samplers"][0]
    t = len(acc(sampler["input"]))
    w = acc(sampler["output"]).reshape(t, -1)
    disp = np.stack([acc(tg["POSITION"]) for tg in prim["targets"]])
    frames = base[None] + (w @ disp.reshape(len(disp), -1)).reshape(t, *base.shape)
    return base, faces, frames.astype(np.float32)
