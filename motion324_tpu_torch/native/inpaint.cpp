// Navier-Stokes-based image inpainting by fast marching, for uint8 RGB.
//
// The hole fill of the texture pipeline: the semantics of OpenCV's
// cv::inpaint(src, mask, dst, radius, cv::INPAINT_NS) (Bertalmio, Bertozzi
// and Sapiro 2001, marched as in OpenCV's inpaint.cpp), so that the port
// needs no cv2. Exposed through a plain C ABI for ctypes.
//
// Contract:
//  - the image is framed by a one-pixel border; pixels with a non-zero
//    inpaint mask are INSIDE, their 4-neighbours outside the mask form the
//    initial narrow BAND (arrival time 0), everything else is KNOWN;
//  - band pixels leave a priority queue in order of arrival time, ties in
//    order of insertion; each INSIDE 4-neighbour of a popped pixel gets the
//    arrival time of the fast-marching solve over its two axis pairs, is
//    filled from the known pixels within `range` (weight 1/(|r|^4 + 1) times
//    the alignment of r with the isophote: the image gradient turned by 90
//    degrees; at the image's first and last rows and columns the gradient
//    is read one pixel further in, as OpenCV reads it), and joins the band;
//  - pixels outside the mask are never written.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <queue>
#include <vector>

namespace {

constexpr uint8_t kKnown = 0;
constexpr uint8_t kInside = 2;

struct Elem {
  float t;
  long long seq;
  int i, j;
  bool operator>(const Elem& o) const {
    return t > o.t || (t == o.t && seq > o.seq);
  }
};

// min-queue by (arrival time, insertion order)
struct Band {
  std::priority_queue<Elem, std::vector<Elem>, std::greater<Elem>> q;
  long long n = 0;
  void push(int i, int j, float t) { q.push({t, n++, i, j}); }
  bool pop(int* i, int* j) {
    if (q.empty()) return false;
    *i = q.top().i;
    *j = q.top().j;
    q.pop();
    return true;
  }
};

struct Grid {
  int rows, cols;   // the framed size
  std::vector<uint8_t> f;
  std::vector<float> t;
  uint8_t& flag(int i, int j) { return f[static_cast<size_t>(i) * cols + j]; }
  float& time(int i, int j) { return t[static_cast<size_t>(i) * cols + j]; }
};

float solve(Grid& g, int i1, int j1, int i2, int j2) {
  const double a11 = g.time(i1, j1), a22 = g.time(i2, j2);
  const double m12 = a11 < a22 ? a11 : a22;
  double sol;
  if (g.flag(i1, j1) != kInside) {
    if (g.flag(i2, j2) != kInside) {
      if (std::fabs(a11 - a22) >= 1.0)
        sol = 1 + m12;
      else
        sol = (a11 + a22 + std::sqrt(2 - (a11 - a22) * (a11 - a22))) * 0.5;
    } else {
      sol = 1 + a11;
    }
  } else if (g.flag(i2, j2) != kInside) {
    sol = 1 + a22;
  } else {
    sol = 1 + m12;
  }
  return static_cast<float>(sol);
}

inline float min4(float a, float b, float c, float d) {
  return std::fmin(std::fmin(a, b), std::fmin(c, d));
}

}  // namespace

extern "C" {

// img, out: (rows, cols, 3) uint8; mask: (rows, cols) uint8, non-zero where
// the image is to be filled; range: the neighbourhood radius in pixels.
int inpaint_ns(const uint8_t* img, const uint8_t* mask, int rows, int cols,
               int range, uint8_t* out) {
  if (rows < 1 || cols < 1) return 1;
  range = range < 1 ? 1 : (range > 100 ? 100 : range);
  const size_t n = static_cast<size_t>(rows) * cols * 3;
  for (size_t x = 0; x < n; ++x) out[x] = img[x];

  Grid g{rows + 2, cols + 2, {}, {}};
  g.f.assign(static_cast<size_t>(g.rows) * g.cols, kKnown);
  g.t.assign(static_cast<size_t>(g.rows) * g.cols, 1.0e6f);
  for (int i = 0; i < rows; ++i)
    for (int j = 0; j < cols; ++j)
      if (mask[static_cast<size_t>(i) * cols + j]) g.flag(i + 1, j + 1) = kInside;

  // the initial band: outside the mask, 4-adjacent to it, off the frame
  Band band;
  for (int i = 1; i < g.rows - 1; ++i) {
    for (int j = 1; j < g.cols - 1; ++j) {
      if (g.flag(i, j) == kInside) continue;
      if (g.flag(i - 1, j) == kInside || g.flag(i + 1, j) == kInside ||
          g.flag(i, j - 1) == kInside || g.flag(i, j + 1) == kInside) {
        band.push(i, j, 0.0f);
        g.time(i, j) = 0.0f;
      }
    }
  }

  auto px = [&](int r, int c, int ch) -> int {
    return out[(static_cast<size_t>(r) * cols + c) * 3 + ch];
  };
  int ii, jj;
  while (band.pop(&ii, &jj)) {
    g.flag(ii, jj) = kKnown;
    for (int q = 0; q < 4; ++q) {
      int i, j;
      if (q == 0) { i = ii - 1; j = jj; }
      else if (q == 1) { i = ii; j = jj - 1; }
      else if (q == 2) { i = ii + 1; j = jj; }
      else { i = ii; j = jj + 1; }
      if (i <= 0 || j <= 0 || i > g.rows - 1 || j > g.cols - 1) continue;
      if (g.flag(i, j) != kInside) continue;
      const float dist = min4(solve(g, i - 1, j, i, j - 1), solve(g, i + 1, j, i, j - 1),
                              solve(g, i - 1, j, i, j + 1), solve(g, i + 1, j, i, j + 1));
      g.time(i, j) = dist;

      float ia[3] = {0.f, 0.f, 0.f};
      float s[3] = {1.0e-20f, 1.0e-20f, 1.0e-20f};
      for (int k = i - range; k <= i + range; ++k) {
        const int km = k - 1 + (k == 1), kp = k - 1 - (k == g.rows - 2);
        for (int l = j - range; l <= j + range; ++l) {
          const int lm = l - 1 + (l == 1), lp = l - 1 - (l == g.cols - 2);
          if (!(k > 0 && l > 0 && k < g.rows - 1 && l < g.cols - 1)) continue;
          if (g.flag(k, l) == kInside ||
              (l - j) * (l - j) + (k - i) * (k - i) > range * range)
            continue;
          const float ry = static_cast<float>(k - i), rx = static_cast<float>(l - j);
          const float len_r = rx * rx + ry * ry;
          const float dst = 1.0f / (len_r * len_r + 1.0f);
          const bool up_in = g.flag(k - 1, l) == kInside;
          const bool down_in = g.flag(k + 1, l) == kInside;
          const bool left_in = g.flag(k, l - 1) == kInside;
          const bool right_in = g.flag(k, l + 1) == kInside;
          for (int c = 0; c < 3; ++c) {
            float gx, gy;
            if (!down_in) {
              gx = !up_in ? static_cast<float>(std::abs(px(kp + 1, lm, c) - px(kp, lm, c)) +
                                               std::abs(px(kp, lm, c) - px(km - 1, lm, c)))
                          : static_cast<float>(std::abs(px(kp + 1, lm, c) - px(kp, lm, c))) * 2.0f;
            } else {
              gx = !up_in ? static_cast<float>(std::abs(px(kp, lm, c) - px(km - 1, lm, c))) * 2.0f
                          : 0.0f;
            }
            if (!right_in) {
              gy = !left_in ? static_cast<float>(std::abs(px(km, lp + 1, c) - px(km, lm, c)) +
                                                 std::abs(px(km, lm, c) - px(km, lm - 1, c)))
                            : static_cast<float>(std::abs(px(km, lp + 1, c) - px(km, lm, c))) * 2.0f;
            } else {
              gy = !left_in ? static_cast<float>(std::abs(px(km, lm, c) - px(km, lm - 1, c))) * 2.0f
                            : 0.0f;
            }
            gx = -gx;
            float dir = rx * gx + ry * gy;
            if (std::fabs(dir) <= 0.01f) {
              dir = 0.000001f;
            } else {
              dir = std::fabs(dir / std::sqrt(len_r * (gx * gx + gy * gy)));
            }
            const float w = dst * dir;
            ia[c] += w * static_cast<float>(px(k - 1, l - 1, c));
            s[c] += w;
          }
        }
      }
      for (int c = 0; c < 3; ++c) {
        long v = std::lrint(static_cast<double>(ia[c]) / s[c]);
        out[(static_cast<size_t>(i - 1) * cols + (j - 1)) * 3 + c] =
            static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
      g.flag(i, j) = 1;   // band
      band.push(i, j, dist);
    }
  }
  return 0;
}

}  // extern "C"
