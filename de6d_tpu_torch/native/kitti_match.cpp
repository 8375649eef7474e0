// Native eval-matching kernel for the KITTI AP protocol.
//
// The per-frame greedy matching (reference compute_statistics_jit,
// core/pcdet/datasets/kitti/kitti_object_eval_python/eval.py:158-276)
// is inherently sequential; the reference ran it under numba. numba is
// unavailable here, so the hot loop lives in this small C++ kernel,
// fused over (frames x thresholds) for one (class, difficulty,
// min_overlap) evaluation pass. Overlap matrices are computed in
// vectorized numpy by the caller.
//
// Built on demand by de6d_tpu_torch/native/native_eval.py into
// de6d_tpu_torch/build/:
//   g++ -O3 -shared -fPIC -std=c++17 kitti_match.cpp -o libkitti_match_<hash>.so

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double NO_DETECTION = -1e7;

// 2D image-box overlap with criterion 0 (inter / area_a) — used only
// for the don't-care suppression step (metric 0).
inline double image_overlap_c0(const double* a, const double* b) {
  double iw = std::min(a[2], b[2]) - std::max(a[0], b[0]);
  if (iw <= 0) return 0.0;
  double ih = std::min(a[3], b[3]) - std::max(a[1], b[1]);
  if (ih <= 0) return 0.0;
  double area_a = (a[2] - a[0]) * (a[3] - a[1]);
  return iw * ih / area_a;
}

struct FrameView {
  const double* overlaps;  // (ndt x ngt) row-major
  const double* gt;        // (ngt x 5) bbox+alpha
  const double* dt;        // (ndt x 6) bbox+alpha+score
  const int64_t* ignored_gt;
  const int64_t* ignored_det;
  const double* dc;        // (ndc x 4)
  int ngt, ndt, ndc;
};

void stats_one(const FrameView& f, int metric, double min_overlap,
               double thresh, bool compute_aos, double* pr_row) {
  std::vector<char> assigned(f.ndt, 0);
  std::vector<char> ignored_threshold(f.ndt, 0);
  for (int j = 0; j < f.ndt; ++j)
    if (f.dt[j * 6 + 5] < thresh) ignored_threshold[j] = 1;

  int tp = 0, fp = 0, fn = 0;
  double similarity = 0.0;
  std::vector<double> delta;

  for (int i = 0; i < f.ngt; ++i) {
    if (f.ignored_gt[i] == -1) continue;
    int det_idx = -1;
    double valid_detection = NO_DETECTION;
    double max_overlap = 0.0;
    bool assigned_ignored_det = false;
    for (int j = 0; j < f.ndt; ++j) {
      if (f.ignored_det[j] == -1 || assigned[j] || ignored_threshold[j])
        continue;
      double overlap = f.overlaps[j * f.ngt + i];
      if (overlap > min_overlap &&
          (overlap > max_overlap || assigned_ignored_det) &&
          f.ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (overlap > min_overlap && valid_detection == NO_DETECTION &&
                 f.ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }
    if (valid_detection == NO_DETECTION && f.ignored_gt[i] == 0) {
      fn += 1;
    } else if (valid_detection != NO_DETECTION &&
               (f.ignored_gt[i] == 1 || f.ignored_det[det_idx] == 1)) {
      assigned[det_idx] = 1;
    } else if (valid_detection != NO_DETECTION) {
      tp += 1;
      if (compute_aos)
        delta.push_back(f.gt[i * 5 + 4] - f.dt[det_idx * 6 + 4]);
      assigned[det_idx] = 1;
    }
  }
  for (int j = 0; j < f.ndt; ++j) {
    if (!(assigned[j] || f.ignored_det[j] == -1 || f.ignored_det[j] == 1 ||
          ignored_threshold[j]))
      fp += 1;
  }
  int nstuff = 0;
  if (metric == 0 && f.ndc > 0) {
    for (int i = 0; i < f.ndc; ++i) {
      for (int j = 0; j < f.ndt; ++j) {
        if (assigned[j] || f.ignored_det[j] == -1 || f.ignored_det[j] == 1 ||
            ignored_threshold[j])
          continue;
        if (image_overlap_c0(&f.dt[j * 6], &f.dc[i * 4]) > min_overlap) {
          assigned[j] = 1;
          nstuff += 1;
        }
      }
    }
  }
  fp -= nstuff;
  if (compute_aos) {
    if (tp > 0 || fp > 0) {
      for (double d : delta) similarity += (1.0 + std::cos(d)) / 2.0;
    } else {
      similarity = -1.0;
    }
  }
  pr_row[0] += tp;
  pr_row[1] += fp;
  pr_row[2] += fn;
  if (similarity != -1.0) pr_row[3] += similarity;
}

}  // namespace

extern "C" {

void fused_statistics(
    const double* overlaps, const int64_t* overlap_offsets,
    const int* gt_nums, const int* dt_nums, int n_frames,
    const double* gt_datas, const int64_t* gt_offsets,
    const double* dt_datas, const int64_t* dt_offsets,
    const int64_t* ignored_gt, const int64_t* ignored_det,
    const double* dc_bboxes, const int* dc_nums, const int64_t* dc_offsets,
    int metric, double min_overlap,
    const double* thresholds, int n_thresh, int compute_aos,
    double* pr_out /* n_thresh x 4, zero-initialized */) {
  for (int fidx = 0; fidx < n_frames; ++fidx) {
    FrameView f;
    f.overlaps = overlaps + overlap_offsets[fidx];
    f.gt = gt_datas + gt_offsets[fidx] * 5;
    f.dt = dt_datas + dt_offsets[fidx] * 6;
    f.ignored_gt = ignored_gt + gt_offsets[fidx];
    f.ignored_det = ignored_det + dt_offsets[fidx];
    f.dc = dc_bboxes + dc_offsets[fidx] * 4;
    f.ngt = gt_nums[fidx];
    f.ndt = dt_nums[fidx];
    f.ndc = dc_nums[fidx];
    for (int t = 0; t < n_thresh; ++t) {
      stats_one(f, metric, min_overlap, thresholds[t], compute_aos != 0,
                pr_out + t * 4);
    }
  }
}

}  // extern "C"
