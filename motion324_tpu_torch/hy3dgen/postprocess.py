"""Mesh cleanup: floater removal, degenerate-face removal, face reduction.

- :func:`remove_floaters`: keep the largest connected component;
- :func:`remove_degenerate`: drop zero-area and repeated-index faces;
- :func:`reduce_faces`: decimate to a face budget by quadric-error-metric
  edge collapse (C++, :mod:`motion324_tpu_torch.native`), or by uniform-grid
  vertex clustering where the collapse cannot reach the budget;
- :func:`remesh_mesh`: the same decimation from file to file.
"""

from __future__ import annotations

import os

import numpy as np

from motion324_tpu_torch.io.mesh import TriMesh

__all__ = ["remove_floaters", "remove_degenerate", "reduce_faces",
           "remesh_mesh"]


def _compact(vertices, faces):
    used = np.unique(faces)
    remap = np.full(len(vertices), -1, np.int64)
    remap[used] = np.arange(len(used))
    return vertices[used], remap[faces]


def remove_floaters(mesh: TriMesh) -> TriMesh:
    """Keep only the largest face-connected component (union-find on edges)."""
    n = len(mesh.vertices)
    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for f in mesh.faces:
        a, b, c = int(f[0]), int(f[1]), int(f[2])
        ra, rb, rc = find(a), find(b), find(c)
        parent[rb] = ra
        parent[find(rc)] = find(ra)

    roots = np.array([find(v) for v in range(n)])
    face_root = roots[mesh.faces[:, 0]]
    vals, counts = np.unique(face_root, return_counts=True)
    keep_root = vals[np.argmax(counts)]
    faces = mesh.faces[face_root == keep_root]
    v, f = _compact(mesh.vertices, faces)
    return TriMesh(vertices=v, faces=f)


def remove_degenerate(mesh: TriMesh, eps: float = 0.0) -> TriMesh:
    """Drop faces with repeated vertices or (near-)zero area."""
    f = mesh.faces
    distinct = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    tri = mesh.vertices[f]
    area2 = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                    tri[:, 2] - tri[:, 0]), axis=-1)
    keep = distinct & (area2 > eps)
    v, fc = _compact(mesh.vertices, f[keep])
    return TriMesh(vertices=v, faces=fc)


def reduce_faces(mesh: TriMesh, max_facenum: int = 40000,
                 method: str = "qem") -> TriMesh:
    """Simplify to <= ``max_facenum`` faces.

    ``method='qem'`` (default) runs quadric-error-metric edge collapse in
    C++, silhouette-preserving; where it ends above the budget (or empty),
    and with ``method='cluster'``, uniform-grid vertex clustering with a
    bisected cell size. A failed build of the native library raises.
    """
    if len(mesh.faces) <= max_facenum:
        return mesh
    if method == "qem":
        from motion324_tpu_torch import native
        v, f = native.qem_simplify(mesh.vertices, mesh.faces, max_facenum)
        if 0 < len(f) <= max_facenum:
            v2, f2 = _compact(v, f)
            return TriMesh(vertices=v2, faces=f2.astype(np.int64))
    v = mesh.vertices
    lo, hi = v.min(0), v.max(0)
    span = float(np.max(hi - lo)) + 1e-9

    def cluster(cells: int):
        key = np.floor((v - lo) / span * cells).astype(np.int64)
        key = np.minimum(key, cells - 1)
        packed = (key[:, 0] * cells + key[:, 1]) * cells + key[:, 2]
        uniq, inv = np.unique(packed, return_inverse=True)
        # representative = centroid of each cell
        reps = np.zeros((len(uniq), 3), np.float64)
        cnt = np.zeros(len(uniq), np.int64)
        np.add.at(reps, inv, v)
        np.add.at(cnt, inv, 1)
        reps = (reps / cnt[:, None]).astype(np.float32)
        faces = inv[mesh.faces]
        ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
            & (faces[:, 0] != faces[:, 2])
        faces = faces[ok]
        if len(faces) > 20_000_000:
            # row-unique on 1e8+ faces is minutes of structured sort; a
            # monster mesh here is a decimation PRE-pass (noise-output
            # guard) and duplicates collapse in the later QEM anyway
            return reps, faces
        # dedupe faces regardless of rotation
        sorted_f = np.sort(faces, axis=1)
        _, first = np.unique(sorted_f, axis=0, return_index=True)
        return reps, faces[np.sort(first)]

    lo_c, hi_c = 4, 512
    best = None
    while lo_c <= hi_c:
        mid = (lo_c + hi_c) // 2
        reps, faces = cluster(mid)
        if len(faces) <= max_facenum:
            best = (reps, faces)
            lo_c = mid + 1
        else:
            hi_c = mid - 1
    if best is None:
        best = cluster(4)
    reps, faces = best
    v2, f2 = _compact(reps, faces)
    return TriMesh(vertices=v2, faces=f2)


def remesh_mesh(mesh_path: str, remesh_path: str, *,
                face_threshold: int = 100_000,
                target_faces: int = 40_000) -> TriMesh:
    """Load ``mesh_path``; if it has more than ``face_threshold`` faces,
    quadric-decimate to ``target_faces``; write the result to
    ``remesh_path`` (GLB or OBJ). Returns the (possibly simplified) mesh."""
    from motion324_tpu_torch.io.glb import export_glb
    from motion324_tpu_torch.io.mesh import load_mesh

    mesh = load_mesh(mesh_path)
    if len(mesh.faces) > face_threshold:
        mesh = reduce_faces(mesh, max_facenum=target_faces)
    ext = os.path.splitext(remesh_path)[1].lower()
    if ext in (".glb", ".gltf"):
        export_glb(remesh_path, mesh.vertices, mesh.faces)
    elif ext == ".obj":
        with open(remesh_path, "w") as fh:
            for v in mesh.vertices:
                fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for f in mesh.faces:
                fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
    else:
        raise ValueError(f"unsupported remesh output format: {remesh_path}")
    return mesh
