// Host-side geometry kernels for the data pipeline and evaluators.
//
// The port's own copy of findnpropagate_tpu/native/geometry.cc, unchanged
// but for this comment: host-side geometry for the data pipeline (the
// gt-database collision checks, pseudo-label dedup and merge), not device
// code.
//
// Exact rotated-rectangle intersection via Sutherland–Hodgman clipping in
// double precision (same algorithm family as the reference's
// iou3d_cpu.cpp box_overlap; independent implementation).
//
// Built by findnpropagate_torch/native/__init__.py with
//   g++ -O3 -shared -fPIC -std=c++14 geometry.cc
// into build/native/ and bound via ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct Pt {
  double x, y;
};

// Corners of a BEV rectangle (cx, cy, dx, dy, yaw); local +x extent = dx.
inline void box_corners(const float* b, Pt* c) {
  const double cx = b[0], cy = b[1];
  const double hx = 0.5 * b[2], hy = 0.5 * b[3];
  const double co = std::cos((double)b[4]), si = std::sin((double)b[4]);
  const double lx[4] = {hx, -hx, -hx, hx};
  const double ly[4] = {hy, hy, -hy, -hy};
  for (int i = 0; i < 4; ++i) {
    c[i].x = cx + lx[i] * co - ly[i] * si;
    c[i].y = cy + lx[i] * si + ly[i] * co;
  }
}

inline double shoelace(const Pt* p, int n) {
  double a = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % n];
    a += u.x * v.y - v.x * u.y;
  }
  return 0.5 * a;  // signed; CCW positive
}

// Clip convex polygon `in` (n verts) by the half-plane left of edge a->b.
// Writes to `out`, returns new count. Max output n+1.
inline int clip_halfplane(const Pt* in, int n, Pt a, Pt b, Pt* out) {
  int m = 0;
  const double ex = b.x - a.x, ey = b.y - a.y;
  for (int i = 0; i < n; ++i) {
    const Pt& cur = in[i];
    const Pt& nxt = in[(i + 1) % n];
    const double dc = ex * (cur.y - a.y) - ey * (cur.x - a.x);
    const double dn = ex * (nxt.y - a.y) - ey * (nxt.x - a.x);
    if (dc >= 0) out[m++] = cur;
    if ((dc >= 0) != (dn >= 0)) {
      const double t = dc / (dc - dn);
      out[m].x = cur.x + t * (nxt.x - cur.x);
      out[m].y = cur.y + t * (nxt.y - cur.y);
      ++m;
    }
  }
  return m;
}

// Exact intersection area of two BEV rectangles (5-float descriptors).
double rect_inter_area(const float* ba, const float* bb) {
  Pt ca[4], cb[4];
  box_corners(ba, ca);
  box_corners(bb, cb);
  // ensure clip rectangle is CCW so "left of edge" = inside
  if (shoelace(cb, 4) < 0) std::swap(cb[1], cb[3]);
  Pt buf0[16], buf1[16];
  std::memcpy(buf0, ca, sizeof(ca));
  int n = 4;
  Pt* src = buf0;
  Pt* dst = buf1;
  for (int e = 0; e < 4 && n > 0; ++e) {
    n = clip_halfplane(src, n, cb[e], cb[(e + 1) % 4], dst);
    std::swap(src, dst);
  }
  if (n < 3) return 0.0;
  return std::fabs(shoelace(src, n));
}

}  // namespace

extern "C" {

// boxes: (cx, cy, dx, dy, yaw) row stride 5; out (n, m) row-major.
void rotated_iou_bev(const float* a, int64_t n, const float* b, int64_t m,
                     float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float* ba = a + 5 * i;
    const double area_a = (double)ba[2] * (double)ba[3];
    for (int64_t j = 0; j < m; ++j) {
      const float* bb = b + 5 * j;
      const double area_b = (double)bb[2] * (double)bb[3];
      const double inter = rect_inter_area(ba, bb);
      const double uni = area_a + area_b - inter;
      out[i * m + j] = (float)(uni > 1e-8 ? inter / uni : 0.0);
    }
  }
}

// 7-float boxes (x, y, z, dx, dy, dz, yaw); IoU over the 3D volumes.
void iou3d(const float* a, int64_t n, const float* b, int64_t m, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float* ba = a + 7 * i;
    const float bev_a[5] = {ba[0], ba[1], ba[3], ba[4], ba[6]};
    const double vol_a = (double)ba[3] * ba[4] * ba[5];
    const double za0 = ba[2] - 0.5 * ba[5], za1 = ba[2] + 0.5 * ba[5];
    for (int64_t j = 0; j < m; ++j) {
      const float* bb = b + 7 * j;
      const float bev_b[5] = {bb[0], bb[1], bb[3], bb[4], bb[6]};
      const double vol_b = (double)bb[3] * bb[4] * bb[5];
      const double zb0 = bb[2] - 0.5 * bb[5], zb1 = bb[2] + 0.5 * bb[5];
      const double dz = std::min(za1, zb1) - std::max(za0, zb0);
      double iou = 0.0;
      if (dz > 0) {
        const double inter = rect_inter_area(bev_a, bev_b) * dz;
        const double uni = vol_a + vol_b - inter;
        if (uni > 1e-8) iou = inter / uni;
      }
      out[i * m + j] = (float)iou;
    }
  }
}

// BEV (height-agnostic) IoU over 7-float boxes — the reference's
// boxes_bev_iou_cpu contract.
void iou_bev7(const float* a, int64_t n, const float* b, int64_t m,
              float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float* ba = a + 7 * i;
    const float bev_a[5] = {ba[0], ba[1], ba[3], ba[4], ba[6]};
    const double area_a = (double)ba[3] * (double)ba[4];
    for (int64_t j = 0; j < m; ++j) {
      const float* bb = b + 7 * j;
      const float bev_b[5] = {bb[0], bb[1], bb[3], bb[4], bb[6]};
      const double area_b = (double)bb[3] * (double)bb[4];
      const double inter = rect_inter_area(bev_a, bev_b);
      const double uni = area_a + area_b - inter;
      out[i * m + j] = (float)(uni > 1e-8 ? inter / uni : 0.0);
    }
  }
}

// points (p, 3) row-major; boxes (n, 7). out[k] = first box containing point
// k else -1 (roipoint_pool3d host semantics).
void points_in_boxes(const float* pts, int64_t p, const float* boxes,
                     int64_t n, int32_t* out) {
  for (int64_t k = 0; k < p; ++k) {
    const double px = pts[3 * k], py = pts[3 * k + 1], pz = pts[3 * k + 2];
    int32_t hit = -1;
    for (int64_t i = 0; i < n; ++i) {
      const float* b = boxes + 7 * i;
      const double dz = pz - b[2];
      if (std::fabs(dz) > 0.5 * b[5]) continue;
      const double co = std::cos((double)-b[6]), si = std::sin((double)-b[6]);
      const double sx = px - b[0], sy = py - b[1];
      const double lx = sx * co - sy * si;
      const double ly = sx * si + sy * co;
      if (std::fabs(lx) <= 0.5 * b[3] && std::fabs(ly) <= 0.5 * b[4]) {
        hit = (int32_t)i;
        break;
      }
    }
    out[k] = hit;
  }
}

// Greedy rotated-BEV NMS over 7-float boxes. `order` must hold indices
// sorted by descending score. Returns number kept; keep[] gets indices.
int64_t nms_bev7(const float* boxes, const int64_t* order, int64_t n,
                 float thresh, int64_t* keep) {
  int64_t kept = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    const float* bi = boxes + 7 * i;
    const float bev_i[5] = {bi[0], bi[1], bi[3], bi[4], bi[6]};
    const double area_i = (double)bi[3] * (double)bi[4];
    bool suppressed = false;
    for (int64_t kj = 0; kj < kept; ++kj) {
      const float* bj = boxes + 7 * keep[kj];
      const float bev_j[5] = {bj[0], bj[1], bj[3], bj[4], bj[6]};
      const double area_j = (double)bj[3] * (double)bj[4];
      const double inter = rect_inter_area(bev_i, bev_j);
      const double uni = area_i + area_j - inter;
      if (uni > 1e-8 && inter / uni > thresh) {
        suppressed = true;
        break;
      }
    }
    if (!suppressed) keep[kept++] = i;
  }
  return kept;
}

}  // extern "C"
