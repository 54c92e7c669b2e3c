// Sparse voxel hierarchy from multi-view layered position maps
// (motion324_tpu_torch/native/__init__.py build_hierarchy), the port's copy
// of the JAX package's motion324_tpu/native/grid_hierarchy.cpp.
//
// Capability equivalent of the reference's `build_hierarchy` torch extension
// (reference: scripts/hy3dgen/texgen/custom_rasterizer/lib/
// custom_rasterizer_kernel/grid_neighbor.cpp:311-433): three orthographic
// views of layered surface-position maps are voxelised at `resolution`, the
// voxel set is downsampled `num_level` times, each voxel gets a 3x3 in-plane
// neighbour table (the plane is chosen perpendicular to the voxel's dominant
// normal axis), and coarse levels are padded so every coarse voxel has its
// diagonal child corners present in the finer level (flagged even/odd).
//
// Output contract (matching the reference's tensor tuple):
//   positions  (N0, 3) float  — level-0 voxel centres, original + padded
//   origin     (N0,)   float  — 1 for voxels seen in the input views, 0 padded
//   neighbors  per level (Nl, 9) int64, -1 where absent
//   downsample per level l<L-1: (Nl,) int64 parent index in level l+1
//   even/odd corner flags per level (Nl,) int64
//
// The implementation is original: voxels are stored in open-addressing hash
// maps keyed by Morton-free linear keys; neighbour lookups scan the dominant
// axis for the nearest occupied voxel instead of re-sampling the view images.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Level {
  int resolution;
  std::vector<int64_t> keys;          // seq -> voxel key
  std::vector<float> pos;             // seq -> xyz (3 floats) voxel centre
  std::vector<int> axis;              // seq -> neighbour-plane axis (0/1/2)
  std::vector<int8_t> origin;         // seq -> came from input views?
  std::vector<int8_t> even_corner;    // seq -> covers parent's even corner
  std::vector<int8_t> odd_corner;     // seq -> covers parent's odd corner
  std::vector<int64_t> parent;        // seq -> parent seq in next level (-1)
  std::vector<int64_t> neighbors;     // seq*9 + j
  std::unordered_map<int64_t, int> key2seq;

  int64_t key_of(int x, int y, int z) const {
    return (int64_t(x) * resolution + y) * resolution + z;
  }
  void key_to_cell(int64_t k, int* c) const {
    c[0] = int(k / resolution / resolution);
    c[1] = int(k / resolution % resolution);
    c[2] = int(k % resolution);
  }
  void cell_centre(const int* c, float* p) const {
    for (int d = 0; d < 3; ++d)
      p[d] = ((c[d] + 0.5f) / resolution - 0.5f) * 2.0f;
  }
  int find(int x, int y, int z) const {
    if (x < 0 || y < 0 || z < 0 || x >= resolution || y >= resolution ||
        z >= resolution)
      return -1;
    auto it = key2seq.find(key_of(x, y, z));
    return it == key2seq.end() ? -1 : it->second;
  }
  int add(int x, int y, int z, int ax, bool orig) {
    int64_t k = key_of(x, y, z);
    auto it = key2seq.find(k);
    if (it != key2seq.end()) return it->second;
    int seq = (int)keys.size();
    key2seq.emplace(k, seq);
    keys.push_back(k);
    int c[3] = {x, y, z};
    float p[3];
    cell_centre(c, p);
    pos.insert(pos.end(), p, p + 3);
    axis.push_back(ax);
    origin.push_back(orig ? 1 : 0);
    even_corner.push_back(0);
    odd_corner.push_back(0);
    parent.push_back(-1);
    return seq;
  }
};

inline int quantise(float v, int resolution) {
  int c = int((v * 0.5f + 0.5f) * resolution);
  if (c < 0) c = 0;
  if (c >= resolution) c = resolution - 1;
  return c;
}

// nearest occupied voxel scanning +-depth_range along `axis` from (x,y,z)
int nearest_along_axis(const Level& lv, int x, int y, int z, int ax,
                       int depth_range) {
  int c[3] = {x, y, z};
  int s = lv.find(c[0], c[1], c[2]);
  if (s >= 0) return s;
  for (int d = 1; d <= depth_range; ++d) {
    for (int sgn = -1; sgn <= 1; sgn += 2) {
      int cc[3] = {x, y, z};
      cc[ax] += sgn * d;
      s = lv.find(cc[0], cc[1], cc[2]);
      if (s >= 0) return s;
    }
  }
  return -1;
}

void build_neighbors(Level& lv, int depth_range) {
  size_t n = lv.keys.size();
  lv.neighbors.assign(n * 9, -1);
  for (size_t i = 0; i < n; ++i) {
    int c[3];
    lv.key_to_cell(lv.keys[i], c);
    int ax = lv.axis[i];           // scan axis (perpendicular to the plane)
    int u = (ax + 1) % 3, w = (ax + 2) % 3;
    int top = 0;
    for (int du = 1; du >= -1; --du) {
      for (int dw = -1; dw <= 1; ++dw) {
        int cc[3] = {c[0], c[1], c[2]};
        cc[u] += du;
        cc[w] += dw;
        lv.neighbors[i * 9 + top] =
            (du == 0 && dw == 0)
                ? (int64_t)i
                : (int64_t)nearest_along_axis(lv, cc[0], cc[1], cc[2], ax,
                                              depth_range);
        ++top;
      }
    }
  }
}

}  // namespace

extern "C" int build_hierarchy(
    const float* pos0, int l0, const float* nrm0, const float* pos1, int l1,
    const float* nrm1, const float* pos2, int l2, const float* nrm2, int h,
    int w, int num_level, int resolution,
    // outputs
    float* out_positions, int cap_pos, int* n_pos, float* out_origin,
    long long* out_neighbors, int cap_nb, int* level_sizes,
    long long* out_downsample, int cap_ds, long long* out_even,
    long long* out_odd) {
  if (num_level < 1 || resolution < 2) return 1;
  std::vector<Level> levels(num_level);
  levels[0].resolution = resolution;

  // ---- level 0 from the three views --------------------------------------
  const float* view_pos[3] = {pos0, pos1, pos2};
  const float* view_nrm[3] = {nrm0, nrm1, nrm2};
  const int view_layers[3] = {l0, l1, l2};
  for (int v = 0; v < 3; ++v) {
    for (int l = 0; l < view_layers[v]; ++l) {
      const float* pd = view_pos[v] + (size_t)l * h * w * 4;
      const float* nd = view_nrm[v] + (size_t)l * h * w * 3;
      for (int i = 0; i < h * w; ++i) {
        const float* p = pd + i * 4;
        if (p[3] == 0) continue;
        const float* nn = nd + i * 3;
        int dominant = 0;
        for (int d = 1; d < 3; ++d)
          if (std::fabs(nn[d]) > std::fabs(nn[dominant])) dominant = d;
        levels[0].add(quantise(p[0], resolution), quantise(p[1], resolution),
                      quantise(p[2], resolution), dominant, true);
      }
    }
  }

  // ---- downsample ----------------------------------------------------------
  for (int li = 0; li + 1 < num_level; ++li) {
    Level& fine = levels[li];
    Level& coarse = levels[li + 1];
    coarse.resolution = fine.resolution / 2;
    if (coarse.resolution < 1) return 2;
    for (size_t i = 0; i < fine.keys.size(); ++i) {
      int c[3];
      fine.key_to_cell(fine.keys[i], c);
      int pidx = coarse.add(c[0] / 2, c[1] / 2, c[2] / 2, fine.axis[i],
                            fine.origin[i] != 0);
      fine.parent[i] = pidx;
      // corner flags: does this fine voxel sit on the parent's even
      // (low-low-low) or odd (high-high-high) diagonal corner?
      bool lo = (c[0] % 2 == 0) && (c[1] % 2 == 0) && (c[2] % 2 == 0);
      bool hi = (c[0] % 2 == 1) && (c[1] % 2 == 1) && (c[2] % 2 == 1);
      if (lo) fine.even_corner[i] = 1;
      if (hi) fine.odd_corner[i] = 1;
    }
  }

  // ---- pad: every coarse voxel must have fine children on both diagonal
  // corners (the reference's PadGrid contract, grid_neighbor.cpp:264-309) ----
  for (int li = num_level - 2; li >= 0; --li) {
    Level& fine = levels[li];
    Level& coarse = levels[li + 1];
    // which parents already have their corners covered?
    std::vector<int8_t> has_even(coarse.keys.size(), 0),
        has_odd(coarse.keys.size(), 0);
    for (size_t i = 0; i < fine.keys.size(); ++i) {
      if (fine.parent[i] < 0) continue;
      if (fine.even_corner[i]) has_even[fine.parent[i]] = 1;
      if (fine.odd_corner[i]) has_odd[fine.parent[i]] = 1;
    }
    for (size_t pi = 0; pi < coarse.keys.size(); ++pi) {
      int c[3];
      coarse.key_to_cell(coarse.keys[pi], c);
      if (!has_even[pi]) {
        int s = fine.add(c[0] * 2, c[1] * 2, c[2] * 2, coarse.axis[pi], false);
        fine.even_corner[s] = 1;
        if (fine.parent[s] < 0) fine.parent[s] = (int64_t)pi;
      }
      if (!has_odd[pi]) {
        int s = fine.add(c[0] * 2 + 1, c[1] * 2 + 1, c[2] * 2 + 1,
                         coarse.axis[pi], false);
        fine.odd_corner[s] = 1;
        if (fine.parent[s] < 0) fine.parent[s] = (int64_t)pi;
      }
    }
  }

  // ---- neighbours ----------------------------------------------------------
  for (int li = 0; li < num_level; ++li)
    build_neighbors(levels[li], /*depth_range=*/2);

  // ---- emit ----------------------------------------------------------------
  int n0 = (int)levels[0].keys.size();
  if (n0 > cap_pos) {
    *n_pos = n0;
    return 3;  // caller re-allocates
  }
  *n_pos = n0;
  std::memcpy(out_positions, levels[0].pos.data(), sizeof(float) * 3 * n0);
  for (int i = 0; i < n0; ++i) out_origin[i] = (float)levels[0].origin[i];

  size_t nb_off = 0, ds_off = 0;
  for (int li = 0; li < num_level; ++li) {
    size_t n = levels[li].keys.size();
    level_sizes[li] = (int)n;
    if (nb_off + n * 9 > (size_t)cap_nb) return 4;
    for (size_t i = 0; i < n * 9; ++i)
      out_neighbors[nb_off + i] = levels[li].neighbors[i];
    for (size_t i = 0; i < n; ++i) {
      out_even[nb_off / 9 + i] = levels[li].even_corner[i];
      out_odd[nb_off / 9 + i] = levels[li].odd_corner[i];
    }
    nb_off += n * 9;
    if (li + 1 < num_level) {
      if (ds_off + n > (size_t)cap_ds) return 5;
      for (size_t i = 0; i < n; ++i)
        out_downsample[ds_off + i] = levels[li].parent[i];
      ds_off += n;
    }
  }
  return 0;
}
