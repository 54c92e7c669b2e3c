"""UV atlas generation: LSCM-parameterised charts with shelf packing.

The port's own copy of ``motion324_tpu/hy3dgen/uv_unwrap.py`` (numpy and
scipy on the host).

Fills the role of the reference's xatlas unwrap (reference:
scripts/hy3dgen/texgen/utils/uv_warp_utils.py:20-36 ``mesh_uv_wrap``): give
every face a UV coordinate so textures can be baked and exported.

Pipeline (xatlas-style): faces are clustered into charts by dominant normal
(six axis buckets, split into connected components), then each chart is
parameterised with a LEAST-SQUARES CONFORMAL MAP (Levy et al. 2002 — the same
family of parameterisation xatlas uses) solved as a sparse linear least-squares
problem with two pinned vertices; charts where LSCM degenerates fall back to
orthographic box projection. Islands are shelf-packed into [0, 1]^2 with a
texel margin. Like xatlas (which returns a ``vmapping``), vertices shared
between charts are duplicated and a vertex remap is returned.
"""

from __future__ import annotations

import numpy as np

from motion324_tpu_torch.io.mesh import TriMesh, face_normals

__all__ = ["unwrap_uv", "lscm_parameterize", "stretch_metric"]

_AXES = np.array([
    [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
], np.float32)
# projection basis (u_axis, v_axis) per direction
_BASIS = [
    ((0, 1, 0), (0, 0, 1)), ((0, 1, 0), (0, 0, 1)),
    ((1, 0, 0), (0, 0, 1)), ((1, 0, 0), (0, 0, 1)),
    ((1, 0, 0), (0, 1, 0)), ((1, 0, 0), (0, 1, 0)),
]


def _connected_components(faces_subset: np.ndarray) -> np.ndarray:
    """Label faces by vertex-connected component within a chart."""
    idx_map: dict[int, int] = {}
    parent: list[int] = []

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    def vid(v):
        if v not in idx_map:
            idx_map[v] = len(parent)
            parent.append(len(parent))
        return idx_map[v]

    for f in faces_subset:
        a, b, c = (vid(int(x)) for x in f)
        union(a, b)
        union(a, c)
    labels = np.empty(len(faces_subset), np.int64)
    for i, f in enumerate(faces_subset):
        labels[i] = find(idx_map[int(f[0])])
    _, labels = np.unique(labels, return_inverse=True)
    return labels


def lscm_parameterize(vertices: np.ndarray, faces: np.ndarray):
    """Least-squares conformal map of ONE chart (Levy et al. 2002).

    Args:
      vertices: (V, 3) chart vertex positions (locally indexed).
      faces: (F, 3) int indices into ``vertices``.

    Returns (V, 2) float32 UVs (unnormalised), or ``None`` when the system is
    degenerate (zero-area chart, singular solve).
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.linalg import lsqr

    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    nv, nf = len(v), len(f)
    if nv < 3 or nf < 1:
        return None

    # local orthonormal 2D frame per triangle
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    n = np.cross(e1, e2)
    a2 = np.linalg.norm(n, axis=1)  # doubled area
    good = a2 > 1e-18
    if not good.any():
        return None
    x_ax = e1 / np.maximum(np.linalg.norm(e1, axis=1, keepdims=True), 1e-18)
    nrm = n / np.maximum(a2[:, None], 1e-18)
    y_ax = np.cross(nrm, x_ax)
    # local coords: w0=(0,0), w1=(|e1|,0), w2=(e2.x_ax, e2.y_ax)
    x1 = np.einsum("ij,ij->i", e1, x_ax)
    x2 = np.einsum("ij,ij->i", e2, x_ax)
    y2 = np.einsum("ij,ij->i", e2, y_ax)
    s = 1.0 / np.sqrt(np.maximum(a2, 1e-18))
    # complex coefficients W_k = (w_{k+2} - w_{k+1}) / sqrt(2A) per vertex slot
    wr = np.stack([(x2 - x1), (0.0 - x2), (x1 - 0.0)], axis=1) * s[:, None]
    wi = np.stack([(y2 - 0.0), (0.0 - y2), np.zeros(nf)], axis=1) * s[:, None]
    wr[~good] = 0
    wi[~good] = 0

    # pin the two extremal vertices along the chart's widest axis
    ext = v.max(0) - v.min(0)
    ax = int(np.argmax(ext))
    pin_a = int(np.argmin(v[:, ax]))
    pin_b = int(np.argmax(v[:, ax]))
    if pin_a == pin_b:
        return None
    pins = {pin_a: (0.0, 0.0), pin_b: (float(ext[ax]), 0.0)}

    # unknown layout: free vertices x (u, v) interleaved [u_0, v_0, u_1, ...]
    free = np.array([i for i in range(nv) if i not in pins], np.int64)
    col_of = -np.ones(nv, np.int64)
    col_of[free] = np.arange(len(free))

    rows, cols, vals = [], [], []
    rhs = np.zeros(2 * nf)
    for k in range(3):
        vid = f[:, k]
        iscol = col_of[vid]
        freemask = iscol >= 0
        tri = np.arange(nf)
        # real rows (2t): Re += wr*u - wi*v ; imag rows (2t+1): wi*u + wr*v
        for (row_off, cu, cv) in ((0, wr[:, k], -wi[:, k]),
                                  (1, wi[:, k], wr[:, k])):
            r = 2 * tri[freemask] + row_off
            rows.extend(r)
            cols.extend(2 * iscol[freemask])
            vals.extend(cu[freemask])
            rows.extend(r)
            cols.extend(2 * iscol[freemask] + 1)
            vals.extend(cv[freemask])
        # pinned contributions move to the RHS
        pinmask = ~freemask
        if pinmask.any():
            for t in tri[pinmask]:
                pu, pv = pins[int(f[t, k])]
                rhs[2 * t] -= wr[t, k] * pu - wi[t, k] * pv
                rhs[2 * t + 1] -= wi[t, k] * pu + wr[t, k] * pv

    if len(free) == 0:
        uv = np.zeros((nv, 2), np.float32)
        for i, (pu, pv) in pins.items():
            uv[i] = (pu, pv)
        return uv

    A = coo_matrix((vals, (rows, cols)), shape=(2 * nf, 2 * len(free))).tocsr()
    sol = lsqr(A, rhs, atol=1e-10, btol=1e-10, iter_lim=4000)[0]
    if not np.isfinite(sol).all():
        return None
    uv = np.zeros((nv, 2), np.float64)
    uv[free, 0] = sol[0::2]
    uv[free, 1] = sol[1::2]
    for i, (pu, pv) in pins.items():
        uv[i] = (pu, pv)
    # reject collapsed solutions
    span = uv.max(0) - uv.min(0)
    if span.max() < 1e-12:
        return None
    return uv.astype(np.float32)


def _lscm_areas_ok(tri_world: np.ndarray, tri_uv: np.ndarray,
                   collapse_ratio: float = 1e-3,
                   max_bad_frac: float = 1e-3) -> bool:
    """Accept an LSCM chart only if (almost) no face collapses or folds.

    ``tri_world`` (F, 3, 3), ``tri_uv`` (F, 3, 2). Scale-invariant: per-face
    UV area is compared against world area x the chart's global area ratio.
    Folds (negative signed area vs the chart majority) count as bad too —
    folded faces overlap neighbours in the atlas and bake garbage.
    """
    e1w = tri_world[:, 1] - tri_world[:, 0]
    e2w = tri_world[:, 2] - tri_world[:, 0]
    aw = 0.5 * np.linalg.norm(np.cross(e1w, e2w), axis=1)
    d = ((tri_uv[:, 1, 0] - tri_uv[:, 0, 0])
         * (tri_uv[:, 2, 1] - tri_uv[:, 0, 1])
         - (tri_uv[:, 2, 0] - tri_uv[:, 0, 0])
         * (tri_uv[:, 1, 1] - tri_uv[:, 0, 1]))
    auv = 0.5 * d  # signed
    solid = aw > 1e-14
    if not solid.any():
        return True
    total_uv = np.abs(auv[solid]).sum()
    total_w = aw[solid].sum()
    if total_uv <= 0:
        return False
    ratio = total_uv / total_w
    sign = 1.0 if (auv[solid] > 0).mean() >= 0.5 else -1.0
    good = sign * auv[solid] > collapse_ratio * ratio * aw[solid]
    return (~good).mean() <= max_bad_frac


def stretch_metric(vertices: np.ndarray, faces: np.ndarray,
                   uv: np.ndarray) -> float:
    """Mean L2 geometric-stretch (Sander et al.): 1.0 = isometric, higher =
    more distortion. Used to compare parameterisations in tests."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    t = np.asarray(uv, np.float64)
    q0, q1, q2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    s0, s1, s2 = t[f[:, 0]], t[f[:, 1]], t[f[:, 2]]
    d = ((s1[:, 0] - s0[:, 0]) * (s2[:, 1] - s0[:, 1])
         - (s2[:, 0] - s0[:, 0]) * (s1[:, 1] - s0[:, 1]))
    ok = np.abs(d) > 1e-18
    d = np.where(ok, d, 1.0)
    ss = (q0 * (s1[:, 1] - s2[:, 1])[:, None]
          + q1 * (s2[:, 1] - s0[:, 1])[:, None]
          + q2 * (s0[:, 1] - s1[:, 1])[:, None]) / d[:, None]
    st = (q0 * (s2[:, 0] - s1[:, 0])[:, None]
          + q1 * (s0[:, 0] - s2[:, 0])[:, None]
          + q2 * (s1[:, 0] - s0[:, 0])[:, None]) / d[:, None]
    a = np.einsum("ij,ij->i", ss, ss)
    c = np.einsum("ij,ij->i", st, st)
    l2 = np.sqrt((a + c) / 2)
    area = 0.5 * np.linalg.norm(np.cross(q1 - q0, q2 - q0), axis=1)
    w = np.where(ok, area, 0.0)
    if w.sum() <= 0:
        return float("inf")
    # normalise out global scale (stretch is scale-invariant at optimum 1)
    uv_area = np.abs(d[ok]).sum() * 0.5
    scale = np.sqrt(uv_area / max(w.sum(), 1e-18))
    return float((l2[ok] * w[ok]).sum() / w[ok].sum() * scale)


def unwrap_uv(mesh: TriMesh, texture_size: int = 1024, margin_px: int = 4,
              method: str = "lscm"):
    """Unwrap a mesh into a packed UV atlas.

    Returns a new :class:`TriMesh` with per-corner-duplicated vertices, filled
    ``uv``, plus ``vmapping`` (new-vertex -> original-vertex indices), the
    analogue of xatlas' vmapping used by the reference to remap baked results
    back onto the watertight mesh (utils/convert_fbx.py:252-340).
    """
    v = mesh.vertices
    fn = face_normals(v, mesh.faces)
    chart_of_face = np.argmax(fn @ _AXES.T, axis=1)

    islands = []  # (face_indices, uv_per_corner (F,3,2))
    for chart in range(6):
        fsel = np.where(chart_of_face == chart)[0]
        if len(fsel) == 0:
            continue
        faces_c = mesh.faces[fsel]
        labels = _connected_components(faces_c)
        u_ax = np.asarray(_BASIS[chart][0], np.float32)
        v_ax = np.asarray(_BASIS[chart][1], np.float32)
        for comp in range(labels.max() + 1):
            fc = fsel[labels == comp]
            uv = None
            if method == "lscm" and len(fc) >= 2:
                # locally index the component and solve a conformal map
                fl = mesh.faces[fc]
                used = np.unique(fl)
                remap = np.zeros(used.max() + 1, np.int64)
                remap[used] = np.arange(len(used))
                uv_vert = lscm_parameterize(v[used], remap[fl])
                if uv_vert is not None:
                    uv = uv_vert[remap[fl]]  # (F, 3, 2) per corner
                    # guard against pathological solves: worse than ~3x the
                    # box projection's bounded distortion -> fall back
                    if stretch_metric(v[used], remap[fl], uv_vert) > 5.0:
                        uv = None
                    # LSCM assumes disk topology; the normal-clustered
                    # components of generated (marching-cubes) meshes are
                    # often cylinders/annuli, where the conformal solve
                    # folds or collapses interior faces — and stretch_metric
                    # EXCLUDES degenerate-UV faces, so it cannot see that
                    # failure. Check collapse/fold directly (scale-invariant)
                    # and fall back to the bounded box projection.
                    elif not _lscm_areas_ok(v[fl], uv):
                        uv = None
            if uv is None:  # box projection (bounded sqrt(3) stretch)
                tri = v[mesh.faces[fc]]  # (F, 3, 3)
                uu = tri @ u_ax
                vv = tri @ v_ax
                if chart % 2 == 1:  # mirror odd directions (winding)
                    uu = -uu
                uv = np.stack([uu, vv], axis=-1)  # (F, 3, 2)
            uv = uv - uv.reshape(-1, 2).min(axis=0)
            islands.append((fc, uv))

    # shelf packing by island height
    sizes = [isl[1].reshape(-1, 2).max(axis=0) + 1e-8 for isl in islands]
    order = np.argsort([-s[1] for s in sizes])
    total_area = float(sum(s[0] * s[1] for s in sizes))
    scale = 0.9 / np.sqrt(total_area)  # initial guess; shrink until it fits
    margin = margin_px / texture_size

    for _ in range(20):
        placements, ok = _shelf_pack([sizes[i] * scale for i in order], margin)
        if ok:
            break
        scale *= 0.92
    else:
        raise RuntimeError("uv packing failed")

    new_faces = []
    new_uv = []
    new_vmap = []
    cursor = 0
    for rank, isl_idx in enumerate(order):
        fc, uv = islands[isl_idx]
        off = placements[rank]
        uv_scaled = uv * scale + off
        n_f = len(fc)
        corner_ids = cursor + np.arange(n_f * 3).reshape(n_f, 3)
        new_faces.append(corner_ids)
        new_uv.append(uv_scaled.reshape(-1, 2))
        new_vmap.append(mesh.faces[fc].reshape(-1))
        cursor += n_f * 3

    vmapping = np.concatenate(new_vmap)
    out = TriMesh(
        vertices=v[vmapping],
        faces=np.concatenate(new_faces),
        uv=np.clip(np.concatenate(new_uv), 0.0, 1.0).astype(np.float32),
        vertex_colors=None if mesh.vertex_colors is None
        else mesh.vertex_colors[vmapping],
        texture=mesh.texture,
    )
    return out, vmapping


def _shelf_pack(sizes, margin):
    """Simple shelf packer in [0,1]^2; returns (offsets, fits)."""
    placements = []
    x = margin
    y = margin
    shelf_h = 0.0
    for w, h in sizes:
        if x + w + margin > 1.0:
            y += shelf_h + margin
            x = margin
            shelf_h = 0.0
        if y + h + margin > 1.0 or w + 2 * margin > 1.0:
            return placements, False
        placements.append(np.array([x, y], np.float32))
        x += w + margin
        shelf_h = max(shelf_h, h)
    return placements, True
