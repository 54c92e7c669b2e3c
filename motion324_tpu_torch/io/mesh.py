"""Triangle-mesh container, OBJ/GLB loading, normalisation and surface sampling.

Host-side numpy replacements for the reference's trimesh usage:
- unit-cube normalisation (reference: utils/mesh_processing.py:194-218 and
  scripts/inference_with_video_mesh.py:89-104 — center to bbox midpoint, scale
  by ``2 * max_abs_extent``);
- area-weighted surface sampling with barycentric interpolation of normals and
  texture/vertex colors (reference: utils/mesh_processing.py:130-191
  ``sample_pointcloud_with_albedo`` — vectorised here instead of a per-point
  Python loop);
- vertex normals (area-weighted face-normal accumulation, trimesh semantics).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

__all__ = ["TriMesh", "load_mesh", "normalize_unit_cube", "sample_surface",
           "sample_with_albedo", "vertex_normals", "face_normals",
           "nearest_colors"]


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray                 # (V, 3) float32
    faces: np.ndarray                    # (F, 3) int64
    uv: np.ndarray | None = None         # (V, 2) float32
    vertex_colors: np.ndarray | None = None  # (V, 3) float32 in [0,1]
    texture: np.ndarray | None = None    # (H, W, 3) float32 in [0,1]
    normals: np.ndarray | None = None    # (V, 3) float32

    def with_vertices(self, v: np.ndarray) -> "TriMesh":
        return dataclasses.replace(self, vertices=v.astype(np.float32),
                                   normals=None)


def face_normals(vertices: np.ndarray, faces: np.ndarray,
                 normalize: bool = True) -> np.ndarray:
    tri = vertices[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    if normalize:
        n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
    return n.astype(np.float32)


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (unnormalised cross products accumulate)."""
    fn = np.cross(vertices[faces[:, 1]] - vertices[faces[:, 0]],
                  vertices[faces[:, 2]] - vertices[faces[:, 0]])
    vn = np.zeros_like(vertices, dtype=np.float64)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    vn = vn / (np.linalg.norm(vn, axis=-1, keepdims=True) + 1e-12)
    return vn.astype(np.float32)


def normalize_unit_cube(vertices: np.ndarray):
    """Center to bbox midpoint, scale so the largest half-extent becomes 0.5.

    Returns ``(vertices, center, scale)`` with ``out = (in - center) / scale``
    (reference scripts/inference_with_video_mesh.py:94-97).
    """
    v = vertices.astype(np.float32)
    center = (v.max(axis=0) + v.min(axis=0)) / 2
    v = v - center
    scale = 2 * (np.abs(v).max() + 1e-8)
    return v / scale, center, float(scale)


def sample_surface(mesh: TriMesh, n: int, seed: int = 0):
    """Area-weighted uniform surface sampling.

    Returns ``(points (n,3), face_idx (n,), bary (n,3))``.
    """
    rng = np.random.RandomState(seed)
    tri = mesh.vertices[mesh.faces]
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    total = areas.sum()
    if total <= 0:
        raise ValueError("mesh has zero surface area")
    face_idx = rng.choice(len(areas), size=n, p=areas / total)
    # uniform barycentric via sqrt trick
    r1 = np.sqrt(rng.rand(n).astype(np.float32))
    r2 = rng.rand(n).astype(np.float32)
    bary = np.stack([1 - r1, r1 * (1 - r2), r1 * r2], axis=-1)
    pts = np.einsum("nk,nkd->nd", bary, tri[face_idx]).astype(np.float32)
    return pts, face_idx, bary.astype(np.float32)


def _sample_texture(texture: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Nearest-texel lookup with V-flip, matching the reference's indexing
    (utils/mesh_processing.py:176-181: u*W clipped, (1-v)*H clipped)."""
    h, w = texture.shape[:2]
    uv = uv % 1.0
    u = np.clip((uv[:, 0] * w).astype(np.int64), 0, w - 1)
    v = np.clip(((1.0 - uv[:, 1]) * h).astype(np.int64), 0, h - 1)
    return texture[v, u, :3].astype(np.float32)


def sample_with_albedo(mesh: TriMesh, n: int, seed: int = 0):
    """Sample surface points with face normals and colors.

    Color source priority mirrors the reference: per-vertex colors (mean of the
    face's three vertices) -> texture via barycentric UV -> constant 0.5.
    Returns ``(points, normals, colors)`` each ``(n, 3) float32``.
    """
    pts, face_idx, bary = sample_surface(mesh, n, seed)
    normals = face_normals(mesh.vertices, mesh.faces)[face_idx]

    colors = None
    if mesh.vertex_colors is not None and len(mesh.vertex_colors) == len(mesh.vertices):
        tri_cols = mesh.vertex_colors[mesh.faces[face_idx]]
        colors = tri_cols.mean(axis=1).astype(np.float32)
    elif mesh.texture is not None and mesh.uv is not None:
        tri_uv = mesh.uv[mesh.faces[face_idx]]  # (n, 3, 2)
        uv = np.einsum("nk,nkd->nd", bary, tri_uv)
        colors = _sample_texture(mesh.texture, uv)
    if colors is None:
        colors = np.full((n, 3), 0.5, dtype=np.float32)
    return pts, normals.astype(np.float32), colors


def nearest_colors(sample_pts: np.ndarray, sample_colors: np.ndarray,
                   query_pts: np.ndarray) -> np.ndarray:
    """Nearest-neighbour color transfer (reference
    scripts/inference_with_video_mesh.py:114-116 cKDTree query)."""
    from scipy.spatial import cKDTree
    tree = cKDTree(sample_pts)
    _, idx = tree.query(query_pts, k=1)
    return sample_colors[idx]


# --------------------------------------------------------------------------- #
# Loading
# --------------------------------------------------------------------------- #
def _load_obj(path: str) -> TriMesh:
    """OBJ loader: v / vt / f with independent UV indices re-welded per corner."""
    vs, vts, fv, fvt = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                vs.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                vts.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                corners = line.split()[1:]
                idxs = []
                for c in corners:
                    parts = c.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    idxs.append((vi, ti))
                for i in range(1, len(idxs) - 1):  # fan-triangulate
                    tri = [idxs[0], idxs[i], idxs[i + 1]]
                    fv.append([t[0] for t in tri])
                    fvt.append([t[1] for t in tri])
    vertices = np.asarray(vs, np.float32)
    faces = np.asarray(fv, np.int64)
    faces = np.where(faces > 0, faces - 1, faces + len(vertices))
    mesh = TriMesh(vertices=vertices, faces=faces)
    if vts:
        vt = np.asarray(vts, np.float32)
        ft = np.asarray(fvt, np.int64)
        ft = np.where(ft > 0, ft - 1, ft + len(vt))
        uv = np.zeros((len(vertices), 2), np.float32)
        uv[faces.reshape(-1)] = vt[ft.reshape(-1)]
        mesh.uv = uv
    # material texture (first map_Kd in the .mtl next to the obj)
    mtl_tex = _obj_texture(path)
    if mtl_tex is not None:
        mesh.texture = mtl_tex
    return mesh


def _obj_texture(obj_path: str):
    base = os.path.dirname(obj_path)
    mtl_path = None
    with open(obj_path) as f:
        for line in f:
            if line.startswith("mtllib"):
                mtl_path = os.path.join(base, line.split(None, 1)[1].strip())
                break
    if not mtl_path or not os.path.exists(mtl_path):
        return None
    with open(mtl_path) as f:
        for line in f:
            if line.strip().startswith("map_Kd"):
                tex_path = os.path.join(base, line.split(None, 1)[1].strip())
                if os.path.exists(tex_path):
                    from PIL import Image
                    img = Image.open(tex_path).convert("RGB")
                    return np.asarray(img).astype(np.float32) / 255.0
    return None


def load_mesh(path: str) -> TriMesh:
    """Load .glb/.gltf/.obj/.fbx into a :class:`TriMesh` (world-space,
    merged)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".glb", ".gltf"):
        from motion324_tpu_torch.io.glb import load_glb
        data = load_glb(path)
        return TriMesh(vertices=data["vertices"].astype(np.float32),
                       faces=data["faces"].astype(np.int64),
                       uv=data.get("uv"),
                       vertex_colors=data.get("vertex_colors"),
                       texture=data.get("texture"),
                       normals=data.get("normals"))
    if ext == ".obj":
        return _load_obj(path)
    if ext == ".fbx":
        # reference loads generated meshes from FBX
        # (inference_with_video_only.py:56-180, via bpy; ours is native)
        from motion324_tpu_torch.io.fbx import load_fbx
        data = load_fbx(path)
        return TriMesh(vertices=np.asarray(data["vertices"], np.float32),
                       faces=np.asarray(data["faces"], np.int64),
                       uv=None if data["uv"] is None
                       else np.asarray(data["uv"], np.float32))
    raise ValueError(f"unsupported mesh format: {ext}")
