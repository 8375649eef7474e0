// The BEV-bounds pre-test shared by both NMS kernels (nms_mask.cu,
// nms_fused.cu): it proves a pair's IoU bit 0 without running the IoU.
// ops/kernels/nms_mask.py:skippable_plain is its plain twin, held against
// the plain IoU and the JAX package's on the CPU
// (tests/test_torch_nms_pretest.py).
//
// The pre-test skips a pair only when its bit is provably 0. Boxes r, c
// (corners as packed, which are the inputs of both the IoU and the test)
// with axis-aligned bounds separated along x or y by gap > delta =
// kGapAbs + kGapRel * S, S the largest |coordinate| of the two boxes:
//   * iou_bev.cuh:green_pass clips each edge of one box to the other box
//     with four Liang-Barsky constraints f(t) = f0 + t fd >= 0, f = (the
//     other box's edge) x (point - its start) - eps_b. Exactly, every point
//     of an edge lies at least gap from the other box, so it violates one
//     of the two constraints at that box's extreme corner (a right angle)
//     by at least gap / sqrt(2) (distance), and the constraints' allowed
//     t-intervals are disjoint. Computed, f0 and fd carry a few ulps of
//     |edge| * |p0 - a0| <= |edge| * 2.9 S, which moves a crossing by at
//     most ~4e-7 * 2.9 S in distance; eps_b = 1e-5 only tightens (moves a
//     line inward by 1e-5 / |edge|); the |fd| < 1e-8 branch treats a
//     near-parallel line as satisfied at most 2e-8 / |edge| <= 2e-6 m
//     beyond it. delta = 1e-3 m + 1e-4 S is far above all three, so every
//     clip interval is empty: t1 <= t0, and after the clamps q1 == q0;
//   * an empty span contributes 0.5 * (q0x * q0y - q0y * q0x) = 0 exactly
//     (products commute), so the overlap is exactly 0 and, with both areas
//     positive, the IoU is 0, which is not > thresh for thresh >= 0.
// A pair takes the full IoU whatever its bounds when either box has an
// edge shorter than kMinEdge or a packed area below kMinEdge^2 (degenerate
// or mirrored boxes: exactly where the IoU misbehaves), when a corner is
// not finite (every comparison with NaN fails), and for every pair when
// thresh < kMinThresh.

#pragma once

#include <cuda_runtime.h>

#include "iou_bev.cuh"

namespace de6d {

// ops/kernels/nms_mask.py holds the same constants
constexpr float kMinEdge = 1e-2f;
constexpr float kMinThresh = 1e-3f;
constexpr float kGapAbs = 1e-3f;
constexpr float kGapRel = 1e-4f;

// A box's BEV bounds and S. A box that must never be skipped (`ok` false
// in skippable_plain) gets bounds (-inf, inf, -inf, inf) and S = inf: its
// gap to any box is -inf or NaN and its delta inf, so no comparison with
// it can skip.
struct Bounds {
  float x0, x1, y0, y1, s;
};

__device__ __forceinline__ Bounds box_bounds(const Quad& q, float area) {
  Bounds b;
  b.x0 = b.x1 = q.x[0];
  b.y0 = b.y1 = q.y[0];
  b.s = fmaxf(fabsf(q.x[0]), fabsf(q.y[0]));
  bool ok = area >= kMinEdge * kMinEdge;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float x = q.x[e], y = q.y[e];
    b.x0 = fminf(b.x0, x);
    b.x1 = fmaxf(b.x1, x);
    b.y0 = fminf(b.y0, y);
    b.y1 = fmaxf(b.y1, y);
    b.s = fmaxf(b.s, fmaxf(fabsf(x), fabsf(y)));
    const float ex = q.x[(e + 1) % 4] - x;
    const float ey = q.y[(e + 1) % 4] - y;
    ok = ok && (ex * ex + ey * ey >= kMinEdge * kMinEdge);
  }
  if (!ok) {
    b.x0 = b.y0 = -INFINITY;
    b.x1 = b.y1 = b.s = INFINITY;
  }
  return b;
}

__device__ __forceinline__ bool skippable(const Bounds& r, const Bounds& c) {
  const float gap = fmaxf(fmaxf(c.x0 - r.x1, r.x0 - c.x1),
                          fmaxf(c.y0 - r.y1, r.y0 - c.y1));
  const float delta = kGapAbs + kGapRel * fmaxf(r.s, c.s);
  return gap > delta;
}

}  // namespace de6d
