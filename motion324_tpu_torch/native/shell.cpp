// Near-surface shell extraction for the FlashVDM volume decode: one pass
// over the (r, r, r) float32 volume replaces the numpy chain
//   mask = |v| < band; cross-dilate(iters); argwhere; sort by spatial cell
// whose large temporaries (57 MB mask + 4 copies at 385^3) made its wall
// time swing 2.5-6 s with host allocator pressure. Output is the flat
// voxel indices ((i*r + j)*r + k) of the shell, ordered exactly like
// numpy's stable argsort of the cell key over argwhere's lexicographic
// rows (counting sort with a lexicographic scan is that order by
// construction). Fallback/oracle: volume._shell_indices_numpy (tests
// assert exact agreement).
//
// Returns 0 on success, 3 when the caller's index capacity is too small
// (needed count is in *out_n either way), -1 on bad arguments.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" int shell_indices(const float* vol, int32_t r, float band,
                             int32_t iters, int32_t g,
                             int32_t* out_flat, int64_t cap, int64_t* out_n) {
    if (r < 1 || g < 1 || iters < 0) return -1;
    const int64_t rr = (int64_t)r * r;
    const int64_t n3 = rr * r;

    std::vector<uint8_t> m(n3);
    for (int64_t i = 0; i < n3; ++i) m[i] = std::fabs(vol[i]) < band;

    // cross-structured (6-neighbour) binary dilation, matching the shifted-OR
    // numpy `_dilate`: out = m | shift(m, +-1) along each axis per iteration
    if (iters > 0) {
        std::vector<uint8_t> t(n3);
        for (int32_t it = 0; it < iters; ++it) {
            std::memcpy(t.data(), m.data(), n3);
            // axis 0: whole-plane shifts never cross a boundary
            for (int64_t i = 0; i < n3 - rr; ++i) t[i] |= m[i + rr];
            for (int64_t i = rr; i < n3; ++i) t[i] |= m[i - rr];
            // axis 1: row shifts within each axis-0 slab
            for (int64_t i0 = 0; i0 < r; ++i0) {
                uint8_t* ts = t.data() + i0 * rr;
                const uint8_t* ms = m.data() + i0 * rr;
                for (int64_t i = 0; i < rr - r; ++i) ts[i] |= ms[i + r];
                for (int64_t i = r; i < rr; ++i) ts[i] |= ms[i - r];
            }
            // axis 2: element shifts within each row
            for (int64_t row = 0; row < rr; ++row) {
                uint8_t* tr = t.data() + row * r;
                const uint8_t* mr = m.data() + row * r;
                for (int64_t k = 0; k < r - 1; ++k) tr[k] |= mr[k + 1];
                for (int64_t k = 1; k < r; ++k) tr[k] |= mr[k - 1];
            }
            m.swap(t);
        }
    }

    // cell of coordinate i along one axis: i * g / r (floor), as in numpy
    std::vector<int32_t> cellof(r);
    for (int32_t i = 0; i < r; ++i)
        cellof[i] = (int32_t)(((int64_t)i * g) / r);

    const int64_t ncells = (int64_t)g * g * g;
    std::vector<int64_t> off(ncells + 1, 0);
    int64_t n = 0;
    for (int64_t i = 0, idx = 0; i < r; ++i) {
        const int64_t ci = (int64_t)cellof[i] * g;
        for (int64_t j = 0; j < r; ++j) {
            const int64_t cij = (ci + cellof[j]) * g;
            for (int64_t k = 0; k < r; ++k, ++idx) {
                if (m[idx]) { ++off[cij + cellof[k] + 1]; ++n; }
            }
        }
    }
    *out_n = n;
    if (n > cap) return 3;
    for (int64_t c = 0; c < ncells; ++c) off[c + 1] += off[c];
    for (int64_t i = 0, idx = 0; i < r; ++i) {
        const int64_t ci = (int64_t)cellof[i] * g;
        for (int64_t j = 0; j < r; ++j) {
            const int64_t cij = (ci + cellof[j]) * g;
            for (int64_t k = 0; k < r; ++k, ++idx) {
                if (m[idx]) out_flat[off[cij + cellof[k]]++] = (int32_t)idx;
            }
        }
    }
    return 0;
}
