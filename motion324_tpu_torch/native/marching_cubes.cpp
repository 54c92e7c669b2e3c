// Iso-surface extraction via marching tetrahedra (native host kernel).
//
// Fills the role of the reference's surface extractors (reference:
// scripts/hy3dgen/shapegen/models/autoencoders/surface_extractors.py:67-94 —
// skimage marching_cubes / diso DiffDMC): scalar grid -> triangle mesh at an
// iso level. Marching tetrahedra (each cube split into 6 tets) is used instead
// of tabulated marching cubes: it needs no 256-case tables, has no ambiguous
// configurations, and downstream decimation absorbs the slightly higher
// triangle count. Vertices on shared edges are welded through a hash map so
// the output is a connected mesh.
//
// C ABI for ctypes. Coordinates are emitted in grid-index space; the Python
// wrapper applies the bbox rescale the reference performs after extraction.

#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct MeshBuf {
  std::vector<float> verts;
  std::vector<int> tris;
  std::unordered_map<uint64_t, int> edge_cache;
};

// the 6-tetrahedra decomposition of a cube (corner indices 0..7)
const int kTets[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

// cube corner offsets (x, y, z)
const int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

inline uint64_t corner_id(int x, int y, int z, int ny, int nz, int c) {
  return (static_cast<uint64_t>((x + kCorner[c][0])) * ny +
          (y + kCorner[c][1])) * nz + (z + kCorner[c][2]);
}

inline int edge_vertex(MeshBuf* buf, uint64_t ia, uint64_t ib,
                       const float* pa, const float* pb, float va, float vb,
                       float iso) {
  if (ia > ib) {
    std::swap(ia, ib);
    std::swap(pa, pb);
    std::swap(va, vb);
  }
  uint64_t key = ia * 0x100000000ULL ^ ib;
  auto it = buf->edge_cache.find(key);
  if (it != buf->edge_cache.end()) return it->second;
  float denom = vb - va;
  float t = (std::fabs(denom) > 1e-12f) ? (iso - va) / denom : 0.5f;
  if (t < 0.f) t = 0.f;
  if (t > 1.f) t = 1.f;
  int idx = static_cast<int>(buf->verts.size() / 3);
  for (int d = 0; d < 3; ++d)
    buf->verts.push_back(pa[d] + t * (pb[d] - pa[d]));
  buf->edge_cache.emplace(key, idx);
  return idx;
}

inline void emit_tri(MeshBuf* buf, int a, int b, int c) {
  if (a == b || b == c || a == c) return;
  buf->tris.push_back(a);
  buf->tris.push_back(b);
  buf->tris.push_back(c);
}

void do_tet(MeshBuf* buf, const uint64_t id[4], const float pos[4][3],
            const float val[4], float iso) {
  int mask = 0;
  for (int i = 0; i < 4; ++i)
    if (val[i] >= iso) mask |= 1 << i;
  if (mask == 0 || mask == 15) return;

  auto ev = [&](int i, int j) {
    return edge_vertex(buf, id[i], id[j], pos[i], pos[j], val[i], val[j], iso);
  };

  // enumerate the 14 non-trivial sign configurations
  switch (mask) {
    case 1:  emit_tri(buf, ev(0, 1), ev(0, 2), ev(0, 3)); break;
    case 14: emit_tri(buf, ev(0, 1), ev(0, 3), ev(0, 2)); break;
    case 2:  emit_tri(buf, ev(1, 0), ev(1, 3), ev(1, 2)); break;
    case 13: emit_tri(buf, ev(1, 0), ev(1, 2), ev(1, 3)); break;
    case 4:  emit_tri(buf, ev(2, 0), ev(2, 1), ev(2, 3)); break;
    case 11: emit_tri(buf, ev(2, 0), ev(2, 3), ev(2, 1)); break;
    case 8:  emit_tri(buf, ev(3, 0), ev(3, 2), ev(3, 1)); break;
    case 7:  emit_tri(buf, ev(3, 0), ev(3, 1), ev(3, 2)); break;
    case 3: {  // 0,1 inside
      int a = ev(0, 2), b = ev(0, 3), c = ev(1, 3), d = ev(1, 2);
      emit_tri(buf, a, b, c);
      emit_tri(buf, a, c, d);
      break;
    }
    case 12: {
      int a = ev(0, 2), b = ev(0, 3), c = ev(1, 3), d = ev(1, 2);
      emit_tri(buf, a, c, b);
      emit_tri(buf, a, d, c);
      break;
    }
    case 5: {  // 0,2 inside
      int a = ev(0, 1), b = ev(0, 3), c = ev(2, 3), d = ev(2, 1);
      emit_tri(buf, a, c, b);
      emit_tri(buf, a, d, c);
      break;
    }
    case 10: {
      int a = ev(0, 1), b = ev(0, 3), c = ev(2, 3), d = ev(2, 1);
      emit_tri(buf, a, b, c);
      emit_tri(buf, a, c, d);
      break;
    }
    case 6: {  // 1,2 inside
      int a = ev(1, 0), b = ev(1, 3), c = ev(2, 3), d = ev(2, 0);
      emit_tri(buf, a, b, c);
      emit_tri(buf, a, c, d);
      break;
    }
    case 9: {
      int a = ev(1, 0), b = ev(1, 3), c = ev(2, 3), d = ev(2, 0);
      emit_tri(buf, a, c, b);
      emit_tri(buf, a, d, c);
      break;
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 if capacity exceeded. Vertex coordinates are in
// grid-index units.
int marching_tetrahedra(const float* grid, int nx, int ny, int nz, float iso,
                        float* out_verts, int max_verts, int* out_nverts,
                        int* out_tris, int max_tris, int* out_ntris) {
  MeshBuf buf;
  buf.verts.reserve(1 << 16);
  buf.tris.reserve(1 << 16);

  auto sample = [&](int x, int y, int z) {
    return grid[(static_cast<size_t>(x) * ny + y) * nz + z];
  };

  for (int x = 0; x < nx - 1; ++x) {
    for (int y = 0; y < ny - 1; ++y) {
      for (int z = 0; z < nz - 1; ++z) {
        float cv[8];
        float cp[8][3];
        uint64_t cid[8];
        bool lo = false, hi = false;
        for (int c = 0; c < 8; ++c) {
          cv[c] = sample(x + kCorner[c][0], y + kCorner[c][1],
                         z + kCorner[c][2]);
          cp[c][0] = static_cast<float>(x + kCorner[c][0]);
          cp[c][1] = static_cast<float>(y + kCorner[c][1]);
          cp[c][2] = static_cast<float>(z + kCorner[c][2]);
          cid[c] = corner_id(x, y, z, ny, nz, c);
          (cv[c] >= iso ? hi : lo) = true;
        }
        if (!lo || !hi) continue;  // cube not crossed
        for (const auto& tet : kTets) {
          uint64_t id[4];
          float pos[4][3];
          float val[4];
          for (int i = 0; i < 4; ++i) {
            id[i] = cid[tet[i]];
            val[i] = cv[tet[i]];
            for (int d = 0; d < 3; ++d) pos[i][d] = cp[tet[i]][d];
          }
          do_tet(&buf, id, pos, val, iso);
        }
      }
    }
  }

  int nv = static_cast<int>(buf.verts.size() / 3);
  int nt = static_cast<int>(buf.tris.size() / 3);
  *out_nverts = nv;
  *out_ntris = nt;
  if (nv > max_verts || nt > max_tris) return 1;
  std::copy(buf.verts.begin(), buf.verts.end(), out_verts);
  std::copy(buf.tris.begin(), buf.tris.end(), out_tris);
  return 0;
}

}  // extern "C"
