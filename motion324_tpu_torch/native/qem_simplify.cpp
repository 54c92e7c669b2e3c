// Quadric-error-metric (QEM) mesh decimation.
//
// TPU-era replacement for the reference's pymeshlab
// `meshing_decimation_quadric_edge_collapse` FaceReducer (reference:
// scripts/hy3dgen/shapegen/postprocessors.py:120-131) — the shipped shape
// pipeline decimates generated meshes to <=10k faces (hunyuan_Gen.py:99), and
// grid clustering destroys silhouettes at that budget. Classic
// Garland-Heckbert vertex-pair contraction with:
//   - per-vertex 4x4 plane quadrics (area-weighted),
//   - boundary edges locked by large perpendicular penalty quadrics,
//   - optimal collapse position (Cramer solve, midpoint/endpoint fallback),
//   - triangle-flip rejection,
//   - threshold-scheduled iterative passes (no heap: cache-friendly sweeps
//     with a growing error threshold, converges in a handful of passes).
//
// Exported C ABI (ctypes): qem_simplify(...) -> 0 on success.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct SymMat {
  // symmetric 4x4, 10 coefficients: m[0..9] =
  // [xx xy xz xw yy yz yw zz zw ww]
  double m[10];
  SymMat() { std::memset(m, 0, sizeof(m)); }
  SymMat(double a, double b, double c, double d) {
    // plane quadric for plane ax+by+cz+d=0
    m[0] = a * a; m[1] = a * b; m[2] = a * c; m[3] = a * d;
    m[4] = b * b; m[5] = b * c; m[6] = b * d;
    m[7] = c * c; m[8] = c * d;
    m[9] = d * d;
  }
  SymMat operator+(const SymMat& o) const {
    SymMat r;
    for (int i = 0; i < 10; ++i) r.m[i] = m[i] + o.m[i];
    return r;
  }
  SymMat& operator+=(const SymMat& o) {
    for (int i = 0; i < 10; ++i) m[i] += o.m[i];
    return *this;
  }
  SymMat scaled(double s) const {
    SymMat r;
    for (int i = 0; i < 10; ++i) r.m[i] = m[i] * s;
    return r;
  }
  double error(double x, double y, double z) const {
    // v^T Q v with v = (x, y, z, 1)
    return m[0] * x * x + 2 * m[1] * x * y + 2 * m[2] * x * z + 2 * m[3] * x +
           m[4] * y * y + 2 * m[5] * y * z + 2 * m[6] * y +
           m[7] * z * z + 2 * m[8] * z + m[9];
  }
  // determinant of the 3x3 upper-left block
  double det3() const {
    return m[0] * (m[4] * m[7] - m[5] * m[5]) -
           m[1] * (m[1] * m[7] - m[5] * m[2]) +
           m[2] * (m[1] * m[5] - m[4] * m[2]);
  }
  // solve [A | -b] for optimal point: A v = -b where b = (m[3], m[6], m[8])
  bool optimal(double* out) const {
    double d = det3();
    if (std::fabs(d) < 1e-12) return false;
    double inv = 1.0 / d;
    double bx = -m[3], by = -m[6], bz = -m[8];
    // Cramer's rule on the symmetric 3x3
    out[0] = inv * (bx * (m[4] * m[7] - m[5] * m[5]) -
                    m[1] * (by * m[7] - m[5] * bz) +
                    m[2] * (by * m[5] - m[4] * bz));
    out[1] = inv * (m[0] * (by * m[7] - m[5] * bz) -
                    bx * (m[1] * m[7] - m[2] * m[5]) +
                    m[2] * (m[1] * bz - by * m[2]));
    out[2] = inv * (m[0] * (m[4] * bz - by * m[5]) -
                    m[1] * (m[1] * bz - by * m[2]) +
                    bx * (m[1] * m[5] - m[4] * m[2]));
    return std::isfinite(out[0]) && std::isfinite(out[1]) &&
           std::isfinite(out[2]);
  }
};

struct Vec3 {
  double x, y, z;
};

inline Vec3 sub(const Vec3& a, const Vec3& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline double dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline double norm(const Vec3& a) { return std::sqrt(dot(a, a)); }

struct Tri {
  int v[3];
  bool deleted = false;
  bool dirty = false;
  Vec3 n{0, 0, 0};
  double err[4] = {0, 0, 0, 0};  // per-edge collapse error + min
};

struct VRef {
  int tid;
  int corner;
};

struct Vertex {
  Vec3 p;
  SymMat q;
  int tstart = 0, tcount = 0;
  bool border = false;
};

class Simplifier {
 public:
  std::vector<Vertex> verts;
  std::vector<Tri> tris;
  std::vector<VRef> refs;

  void triangle_normal_quadrics() {
    for (auto& t : tris) {
      if (t.deleted) continue;
      const Vec3 &p0 = verts[t.v[0]].p, &p1 = verts[t.v[1]].p,
                 &p2 = verts[t.v[2]].p;
      Vec3 nrm = cross(sub(p1, p0), sub(p2, p0));
      double area2 = norm(nrm);
      if (area2 < 1e-20) {
        t.n = {0, 0, 0};
        continue;
      }
      t.n = {nrm.x / area2, nrm.y / area2, nrm.z / area2};
      double d = -dot(t.n, p0);
      // area-weighted plane quadric
      SymMat q(t.n.x, t.n.y, t.n.z, d);
      q = q.scaled(area2 * 0.5);
      for (int j = 0; j < 3; ++j) verts[t.v[j]].q += q;
    }
  }

  void mark_borders_and_penalise() {
    // count undirected edge occurrences; edges seen once are boundary
    struct Edge {
      int64_t key;
      int t, a, b;
    };
    std::vector<Edge> edges;
    edges.reserve(tris.size() * 3);
    int64_t nv = (int64_t)verts.size();
    for (int ti = 0; ti < (int)tris.size(); ++ti) {
      if (tris[ti].deleted) continue;
      for (int j = 0; j < 3; ++j) {
        int a = tris[ti].v[j], b = tris[ti].v[(j + 1) % 3];
        int lo = a < b ? a : b, hi = a < b ? b : a;
        edges.push_back({lo * nv + hi, ti, a, b});
      }
    }
    std::sort(edges.begin(), edges.end(),
              [](const Edge& l, const Edge& r) { return l.key < r.key; });
    for (size_t i = 0; i < edges.size();) {
      size_t j = i;
      while (j < edges.size() && edges[j].key == edges[i].key) ++j;
      if (j - i == 1) {  // boundary edge: lock with a perpendicular plane
        int a = edges[i].a, b = edges[i].b;
        verts[a].border = verts[b].border = true;
        const Vec3 &pa = verts[a].p, &pb = verts[b].p;
        Vec3 e = sub(pb, pa);
        Vec3 fn = tris[edges[i].t].n;
        Vec3 perp = cross(e, fn);
        double ln = norm(perp);
        if (ln > 1e-20) {
          perp = {perp.x / ln, perp.y / ln, perp.z / ln};
          double d = -dot(perp, pa);
          SymMat q(perp.x, perp.y, perp.z, d);
          q = q.scaled(norm(e) * norm(e) * 1e3);  // strong boundary penalty
          verts[a].q += q;
          verts[b].q += q;
        }
      }
      i = j;
    }
  }

  double vertex_error(const SymMat& q, const Vec3& p) {
    return q.error(p.x, p.y, p.z);
  }

  double collapse_error(int id_v1, int id_v2, Vec3& out) {
    SymMat q = verts[id_v1].q + verts[id_v2].q;
    bool border = verts[id_v1].border && verts[id_v2].border;
    double sol[3];
    if (!border && q.optimal(sol)) {
      out = {sol[0], sol[1], sol[2]};
      return vertex_error(q, out);
    }
    const Vec3 &p1 = verts[id_v1].p, &p2 = verts[id_v2].p;
    Vec3 mid = {(p1.x + p2.x) / 2, (p1.y + p2.y) / 2, (p1.z + p2.z) / 2};
    double e1 = vertex_error(q, p1), e2 = vertex_error(q, p2),
           e3 = vertex_error(q, mid);
    if (e1 <= e2 && e1 <= e3) { out = p1; return e1; }
    if (e2 <= e3) { out = p2; return e2; }
    out = mid;
    return e3;
  }

  void update_refs() {
    for (auto& v : verts) v.tcount = 0;
    for (auto& t : tris)
      if (!t.deleted)
        for (int j = 0; j < 3; ++j) ++verts[t.v[j]].tcount;
    int start = 0;
    for (auto& v : verts) {
      v.tstart = start;
      start += v.tcount;
      v.tcount = 0;
    }
    refs.resize(start);
    for (int ti = 0; ti < (int)tris.size(); ++ti) {
      if (tris[ti].deleted) continue;
      for (int j = 0; j < 3; ++j) {
        Vertex& v = verts[tris[ti].v[j]];
        refs[v.tstart + v.tcount] = {ti, j};
        ++v.tcount;
      }
    }
  }

  void update_edge_errors() {
    for (auto& t : tris) {
      if (t.deleted) continue;
      t.dirty = false;
      double mn = 1e300;
      for (int j = 0; j < 3; ++j) {
        Vec3 dummy;
        t.err[j] = collapse_error(t.v[j], t.v[(j + 1) % 3], dummy);
        if (t.err[j] < mn) mn = t.err[j];
      }
      t.err[3] = mn;
    }
  }

  // would collapsing v_keep's position to `p` flip any face around vid
  // (excluding faces that contain the other endpoint, which die)?
  bool flipped(const Vec3& p, int vid, int other) {
    const Vertex& v = verts[vid];
    for (int k = 0; k < v.tcount; ++k) {
      const Tri& t = tris[refs[v.tstart + k].tid];
      if (t.deleted) continue;
      int c = refs[v.tstart + k].corner;
      int id1 = t.v[(c + 1) % 3], id2 = t.v[(c + 2) % 3];
      if (id1 == other || id2 == other) continue;  // face will be removed
      Vec3 d1 = sub(verts[id1].p, p);
      Vec3 d2 = sub(verts[id2].p, p);
      double l1 = norm(d1), l2 = norm(d2);
      if (l1 < 1e-20 || l2 < 1e-20) return true;
      d1 = {d1.x / l1, d1.y / l1, d1.z / l1};
      d2 = {d2.x / l2, d2.y / l2, d2.z / l2};
      if (std::fabs(dot(d1, d2)) > 0.999) return true;  // degenerate sliver
      Vec3 nn = cross(d1, d2);
      double ln = norm(nn);
      if (ln < 1e-20) return true;
      nn = {nn.x / ln, nn.y / ln, nn.z / ln};
      if (dot(nn, t.n) < 0.2) return true;  // normal flips/turns too far
    }
    return false;
  }

  void refresh_normals() {
    for (auto& t : tris) {
      if (t.deleted) continue;
      const Vec3 &p0 = verts[t.v[0]].p, &p1 = verts[t.v[1]].p,
                 &p2 = verts[t.v[2]].p;
      Vec3 nrm = cross(sub(p1, p0), sub(p2, p0));
      double l = norm(nrm);
      t.n = l > 1e-20 ? Vec3{nrm.x / l, nrm.y / l, nrm.z / l} : Vec3{0, 0, 0};
    }
  }

  void simplify(int target_faces, double aggressiveness) {
    // Quadrics accumulate from the ORIGINAL surface (computed once; merged on
    // collapse) — recomputing them per pass would lose the memory of the
    // input geometry and shrink the mesh.
    triangle_normal_quadrics();
    mark_borders_and_penalise();

    (void)aggressiveness;  // schedule is adaptive; knob kept for ABI
    int stalls = 0;        // consecutive zero-progress passes
    for (int iteration = 0; iteration < 60; ++iteration) {
      compact();
      if ((int)tris.size() <= target_faces) break;
      refresh_normals();
      update_refs();
      update_edge_errors();

      int face_count = (int)tris.size();
      int deleted = 0;
      // Adaptive threshold: aim to collapse enough edges this pass to remove
      // ~half the remaining surplus (each collapse kills ~2 faces). Scale-free
      // (a fixed schedule is glacial on small meshes, reckless on large ones).
      std::vector<double> errs;
      errs.reserve(tris.size());
      for (auto& t : tris)
        if (!t.deleted) errs.push_back(t.err[3]);
      // escalate aggressively when flip-rejection stalls progress
      long surplus = face_count - target_faces;
      long base = std::max(surplus / 4, (long)1) << (2 * stalls);
      size_t want = std::min(errs.size() - 1, (size_t)base);
      std::nth_element(errs.begin(), errs.begin() + want, errs.end());
      double threshold = errs[want];
      for (int ti = 0; ti < (int)tris.size(); ++ti) {
        Tri& t = tris[ti];
        if (t.deleted || t.dirty || t.err[3] > threshold) continue;
        for (int j = 0; j < 3; ++j) {
          if (t.err[j] > threshold) continue;
          int v0 = t.v[j], v1 = t.v[(j + 1) % 3];
          if (verts[v0].border != verts[v1].border) continue;
          Vec3 p;
          collapse_error(v0, v1, p);
          if (flipped(p, v0, v1) || flipped(p, v1, v0)) continue;

          // move v0 to p, merge quadrics; faces shared with v1 die, v1's
          // remaining faces are redirected to v0 and marked dirty (skipped
          // for the rest of this pass; refs rebuild next pass)
          verts[v0].p = p;
          verts[v0].q += verts[v1].q;
          const Vertex& a = verts[v0];
          for (int k = 0; k < a.tcount; ++k) {
            Tri& tt = tris[refs[a.tstart + k].tid];
            if (tt.deleted) continue;
            int c = refs[a.tstart + k].corner;
            if (tt.v[(c + 1) % 3] == v1 || tt.v[(c + 2) % 3] == v1) {
              tt.deleted = true;
              ++deleted;
            } else {
              tt.dirty = true;
            }
          }
          const Vertex& w = verts[v1];
          for (int k = 0; k < w.tcount; ++k) {
            Tri& tt = tris[refs[w.tstart + k].tid];
            if (tt.deleted) continue;
            int c = refs[w.tstart + k].corner;
            tt.v[c] = v0;
            tt.dirty = true;
          }
          break;
        }
        if (face_count - deleted <= target_faces) break;
      }
      stalls = (deleted == 0) ? stalls + 1 : 0;
      if (stalls >= 6) break;  // stuck: every candidate is flip-blocked
    }
    compact();
  }

  void compact() {
    // drop deleted faces + unreferenced vertices, remap indices
    std::vector<int> vmap(verts.size(), -1);
    std::vector<Tri> nt;
    nt.reserve(tris.size());
    for (auto& t : tris) {
      if (t.deleted) continue;
      if (t.v[0] == t.v[1] || t.v[1] == t.v[2] || t.v[0] == t.v[2]) continue;
      nt.push_back(t);
    }
    std::vector<Vertex> nv;
    for (auto& t : nt) {
      for (int j = 0; j < 3; ++j) {
        int old = t.v[j];
        if (vmap[old] < 0) {
          vmap[old] = (int)nv.size();
          nv.push_back(verts[old]);
        }
        t.v[j] = vmap[old];
      }
      t.deleted = false;
      t.dirty = false;
    }
    verts.swap(nv);
    tris.swap(nt);
  }
};

}  // namespace

extern "C" int qem_simplify(const float* in_verts, int nv, const int* in_faces,
                            int nf, int target_faces, float aggressiveness,
                            float* out_verts, int* out_nv, int* out_faces,
                            int* out_nf) {
  if (nv <= 0 || nf <= 0 || target_faces <= 0) return 1;
  Simplifier s;
  s.verts.resize(nv);
  for (int i = 0; i < nv; ++i)
    s.verts[i].p = {in_verts[3 * i], in_verts[3 * i + 1], in_verts[3 * i + 2]};
  s.tris.resize(nf);
  for (int i = 0; i < nf; ++i) {
    for (int j = 0; j < 3; ++j) {
      int idx = in_faces[3 * i + j];
      if (idx < 0 || idx >= nv) return 2;
      s.tris[i].v[j] = idx;
    }
  }
  s.simplify(target_faces, aggressiveness > 0 ? aggressiveness : 7.0);

  // outputs are never larger than inputs
  if ((int)s.verts.size() > nv || (int)s.tris.size() > nf) return 3;
  *out_nv = (int)s.verts.size();
  *out_nf = (int)s.tris.size();
  for (int i = 0; i < *out_nv; ++i) {
    out_verts[3 * i] = (float)s.verts[i].p.x;
    out_verts[3 * i + 1] = (float)s.verts[i].p.y;
    out_verts[3 * i + 2] = (float)s.verts[i].p.z;
  }
  for (int i = 0; i < *out_nf; ++i)
    for (int j = 0; j < 3; ++j) out_faces[3 * i + j] = s.tris[i].v[j];
  return 0;
}
