// UV-seam vertex color inpainting (native host kernel).
//
// The port's own copy of motion324_tpu/native/mesh_processor.cpp; the
// equivalent of the reference's pybind11 mesh_processor extension
// (reference: scripts/hy3dgen/texgen/differentiable_renderer/mesh_processor.cpp:12-161):
// map texture texels to mesh vertices through UVs, then iteratively diffuse
// colors from colored to uncolored vertices across the directed edge graph
// with inverse-squared-distance weights, and write the resulting vertex colors
// back into the atlas. Exposed through a plain C ABI for ctypes (no pybind11
// in this toolchain).
//
// Behavioural contract (held against vertex_inpaint_numpy, the plain version
// in motion324_tpu_torch/native/__init__.py):
//  - texel lookup: col = round(u * (W-1)), row = round((1-v) * (H-1));
//  - a vertex is seeded if its texel mask is > 0 (later faces overwrite);
//  - diffusion is sequential within a sweep (vertices colored earlier in the
//    sweep can feed later ones) with weight 1 / max(dist, 1e-4)^2;
//  - sweeps continue while progress is made; a stall budget of 2 no-progress
//    sweeps ends the loop.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

int vertex_inpaint(const float* texture, const uint8_t* mask,
                   int height, int width, int channels,
                   const float* vtx_pos, int n_vtx,
                   const float* vtx_uv, int n_uv,
                   const int* pos_idx, const int* uv_idx, int n_face,
                   float* out_texture, uint8_t* out_mask) {
  (void)n_uv;
  std::vector<float> vtx_color(static_cast<size_t>(n_vtx) * channels, 0.f);
  std::vector<uint8_t> vtx_mask(n_vtx, 0);
  std::vector<int> uncolored;
  uncolored.reserve(n_vtx);

  // adjacency: directed edge corner -> next corner within each face
  std::vector<int> adj_head(n_vtx, -1);
  std::vector<int> adj_next;
  std::vector<int> adj_to;
  adj_next.reserve(static_cast<size_t>(n_face) * 3);
  adj_to.reserve(static_cast<size_t>(n_face) * 3);

  auto texel = [&](int uvi, int* row, int* col) {
    float u = vtx_uv[uvi * 2 + 0];
    float v = vtx_uv[uvi * 2 + 1];
    *col = static_cast<int>(std::lround(u * (width - 1)));
    *row = static_cast<int>(std::lround((1.0f - v) * (height - 1)));
    if (*col < 0) *col = 0;
    if (*col >= width) *col = width - 1;
    if (*row < 0) *row = 0;
    if (*row >= height) *row = height - 1;
  };

  for (int f = 0; f < n_face; ++f) {
    for (int k = 0; k < 3; ++k) {
      int vi = pos_idx[f * 3 + k];
      int uvi = uv_idx[f * 3 + k];
      int row, col;
      texel(uvi, &row, &col);
      if (mask[row * width + col] > 0) {
        vtx_mask[vi] = 1;
        std::memcpy(&vtx_color[static_cast<size_t>(vi) * channels],
                    &texture[(static_cast<size_t>(row) * width + col) * channels],
                    sizeof(float) * channels);
      } else {
        uncolored.push_back(vi);
      }
      int to = pos_idx[f * 3 + (k + 1) % 3];
      adj_to.push_back(to);
      adj_next.push_back(adj_head[vi]);
      adj_head[vi] = static_cast<int>(adj_to.size()) - 1;
    }
  }

  // Sweeps match the reference exactly: the worklist keeps duplicates and
  // already-colored entries are RE-relaxed each sweep (Gauss-Seidel style);
  // only entries with no colored neighbour count as remaining.
  int stall_budget = 2;
  int last_remaining = 0;
  std::vector<float> sum_color(channels);
  while (stall_budget > 0) {
    int remaining = 0;
    for (int vi : uncolored) {
      std::fill(sum_color.begin(), sum_color.end(), 0.f);
      float total_w = 0.f;
      const float* p0 = &vtx_pos[static_cast<size_t>(vi) * 3];
      for (int e = adj_head[vi]; e != -1; e = adj_next[e]) {
        int nb = adj_to[e];
        if (!vtx_mask[nb]) continue;
        const float* p1 = &vtx_pos[static_cast<size_t>(nb) * 3];
        float dx = p0[0] - p1[0], dy = p0[1] - p1[1], dz = p0[2] - p1[2];
        float dist = std::sqrt(dx * dx + dy * dy + dz * dz);
        float w = 1.0f / (dist > 1e-4f ? dist : 1e-4f);
        w *= w;
        for (int c = 0; c < channels; ++c)
          sum_color[c] += vtx_color[static_cast<size_t>(nb) * channels + c] * w;
        total_w += w;
      }
      if (total_w > 0.f) {
        for (int c = 0; c < channels; ++c)
          vtx_color[static_cast<size_t>(vi) * channels + c] =
              sum_color[c] / total_w;
        vtx_mask[vi] = 1;
      } else {
        ++remaining;
      }
    }
    if (remaining == last_remaining) {
      --stall_budget;
    } else {
      ++stall_budget;
    }
    last_remaining = remaining;
  }

  std::memcpy(out_texture, texture,
              sizeof(float) * static_cast<size_t>(height) * width * channels);
  std::memcpy(out_mask, mask, static_cast<size_t>(height) * width);
  for (int f = 0; f < n_face; ++f) {
    for (int k = 0; k < 3; ++k) {
      int vi = pos_idx[f * 3 + k];
      if (!vtx_mask[vi]) continue;
      int row, col;
      texel(uv_idx[f * 3 + k], &row, &col);
      std::memcpy(&out_texture[(static_cast<size_t>(row) * width + col) * channels],
                  &vtx_color[static_cast<size_t>(vi) * channels],
                  sizeof(float) * channels);
      out_mask[row * width + col] = 255;
    }
  }
  return 0;
}

}  // extern "C"
