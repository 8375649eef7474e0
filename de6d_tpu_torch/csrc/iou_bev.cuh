// Rotated BEV IoU of two boxes given as corner quads: the device function
// shared by the NMS kernels (nms_fused.cu, nms_mask.cu), so that both
// compile the same arithmetic.
//
// It repeats ops/iou3d.py operation by operation (two Green's-theorem
// passes of 4 edges x 4 Liang-Barsky clips, 547 fp32 operations per IoU,
// counted in ops/kernels/nms_fused.py:FLOPS_PER_IOU). The library is built
// with -fmad=false so no product and sum fuse into an FMA, and the IoU
// rounds exactly like the plain PyTorch version.

#pragma once

#include <cuda_runtime.h>

namespace de6d {

struct Quad {
  float x[4];
  float y[4];
};

// Edges of polygon p clipped inside polygon q (ops/iou3d.py:_green_pass).
__device__ __forceinline__ float green_pass(const Quad& p, const Quad& q,
                                            float eps_b) {
  const float eps = (float)1e-8;
  float total = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float p0x = p.x[e], p0y = p.y[e];
    const float dx = p.x[(e + 1) % 4] - p0x;
    const float dy = p.y[(e + 1) % 4] - p0y;
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float a0x = q.x[c], a0y = q.y[c];
      const float ex = q.x[(c + 1) % 4] - a0x;
      const float ey = q.y[(c + 1) % 4] - a0y;
      const float f0 = -(ex * (p0y - a0y) - ey * (p0x - a0x)) - eps_b;
      const float fd = -(ex * dy - ey * dx);
      const bool small = fabsf(fd) < eps;
      const float denom = small ? (fd >= 0.f ? eps : -eps) : fd;
      const float t_cross = -f0 / denom;
      float lo = fd > 0.f ? t_cross : 0.f;
      float hi = fd < 0.f ? t_cross : 1.f;
      if (small && f0 < -eps) {
        lo = 1.f;
        hi = 0.f;
      }
      t0 = (c == 0) ? lo : fmaxf(t0, lo);
      t1 = (c == 0) ? hi : fminf(t1, hi);
    }
    t0 = fminf(fmaxf(t0, 0.f), 1.f);
    t1 = fmaxf(t0, fminf(fmaxf(t1, 0.f), 1.f));
    const float q0x = p0x + t0 * dx;
    const float q0y = p0y + t0 * dy;
    const float q1x = p0x + t1 * dx;
    const float q1y = p0y + t1 * dy;
    const float contrib = 0.5f * (q0x * q1y - q0y * q1x);
    total = (e == 0) ? contrib : total + contrib;
  }
  return total;
}

// IoU of (row box r, column box c) -- the order of the passes matters.
__device__ __forceinline__ float iou_pair(const Quad& r, float area_r,
                                          const Quad& c, float area_c) {
  const float overlap =
      fabsf(green_pass(r, c, 0.f) + green_pass(c, r, (float)1e-5));
  const float uni = fmaxf(area_r + area_c - overlap, (float)1e-8);
  return overlap / uni;
}

}  // namespace de6d
