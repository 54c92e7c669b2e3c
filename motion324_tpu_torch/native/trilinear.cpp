// Edge-aligned integer-factor trilinear upsample for the volume decoder:
// (c, c, c) float32 -> (r, r, r) with r = (c-1)*f + 1 (node grids over the
// same box; fine node i maps to coarse coordinate i/f exactly).
//
// The numpy axis-wise lerp allocates ~3x 230 MB of temporaries at 385^3 and
// its wall time swings 0.8-8 s with process memory pressure; this loop
// writes the output once with cache-friendly reads and no temporaries
// (~0.3 s single-threaded). Fallback/oracle: volume._host_trilinear's
// numpy path (tests assert exact agreement).

#include <cstdint>

extern "C" int trilinear_upsample(const float* coarse, int32_t c, int32_t f,
                                  float* out) {
    if (c < 2 || f < 1) return -1;
    const int64_t r = (int64_t)(c - 1) * f + 1;

    for (int64_t z = 0; z < r; ++z) {
        int64_t z0 = z / f;
        float wz = (float)(z % f) / f;
        if (z0 >= c - 1) { z0 = c - 2; wz = 1.0f; }
        for (int64_t y = 0; y < r; ++y) {
            int64_t y0 = y / f;
            float wy = (float)(y % f) / f;
            if (y0 >= c - 1) { y0 = c - 2; wy = 1.0f; }
            const float* c00 = coarse + (z0 * c + y0) * c;
            const float* c01 = c00 + c;            // y0+1 at z0
            const float* c10 = c00 + (int64_t)c * c;  // y0 at z0+1
            const float* c11 = c10 + c;
            const float wz0 = 1.0f - wz, wy0 = 1.0f - wy;
            // bilinear blend in (z, y) collapses to one row pair
            float* o = out + (z * r + y) * r;
            for (int64_t x = 0; x < r; ++x) {
                int64_t x0 = x / f;
                float wx = (float)(x % f) / f;
                if (x0 >= c - 1) { x0 = c - 2; wx = 1.0f; }
                const float wx0 = 1.0f - wx;
                const float v00 = c00[x0] * wx0 + c00[x0 + 1] * wx;
                const float v01 = c01[x0] * wx0 + c01[x0 + 1] * wx;
                const float v10 = c10[x0] * wx0 + c10[x0 + 1] * wx;
                const float v11 = c11[x0] * wx0 + c11[x0 + 1] * wx;
                const float vz0 = v00 * wy0 + v01 * wy;
                const float vz1 = v10 * wy0 + v11 * wy;
                o[x] = vz0 * wz0 + vz1 * wz;
            }
        }
    }
    return 0;
}
