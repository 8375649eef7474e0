"""Official KITTI AP evaluation protocol (numba-free).

Behavioral spec: reference
core/pcdet/datasets/kitti/kitti_object_eval_python/eval.py — 11/40
point AP over bbox2D / BEV / 3D / AOS with class+difficulty gating,
don't-care regions, and the exact two-pass threshold/matching scheme
(get_thresholds :10, clean_data :30, compute_statistics_jit :158,
eval_class :448, do_eval :579, get_official_eval_result :639).

numba is unavailable in this image, so:
- overlap matrices are vectorized numpy (rotate_iou_np);
- the inherently sequential per-frame greedy matching runs in a small
  C++ kernel (de6d_tpu_torch/native/kitti_match.cpp, compiled on first use)
  with a pure-Python fallback that is bit-identical (used in tests).
"""

from __future__ import annotations

import io as sysio

import numpy as np

from .rotate_iou_np import rotate_iou_matrix
from ...native import native_eval

CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting", "truck"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41
NO_DETECTION = -10000000


def get_thresholds(scores, num_gt, num_sample_pts=N_SAMPLE_PTS):
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and (
            i < len(scores) - 1
        ):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        bbox = gt_anno["bbox"][i]
        gt_name = str(gt_anno["name"][i]).lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (
            (gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty])
            or (gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty])
            or (height <= MIN_HEIGHT[difficulty])
        )
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt_anno["name"][i]) == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        valid_class = 1 if str(dt_anno["name"][i]).lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """Vectorized 2D box overlap (reference :87-114)."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0]
    )
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1]
    )
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_q = (query_boxes[:, 2] - query_boxes[:, 0]) * (
        query_boxes[:, 3] - query_boxes[:, 1]
    )
    if criterion == -1:
        ua = area_b[:, None] + area_q[None, :] - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_b[:, None], inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_q[None, :], inter.shape)
    else:
        ua = np.ones_like(inter)
    return np.where(inter > 0, inter / ua, 0.0)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    """Camera-frame BEV rotated overlap; boxes (N, 5) [x, z, l, w, ry]."""
    return rotate_iou_matrix(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """Camera-frame 3D overlap (reference d3_box_overlap :150):
    rotated BEV intersection x y-extent overlap (y points down, box y
    at bottom)."""
    rinc = rotate_iou_matrix(
        boxes[:, [0, 2, 3, 5, 6]], qboxes[:, [0, 2, 3, 5, 6]], criterion=2
    ).astype(np.float64)
    n, k = rinc.shape
    if n == 0 or k == 0:
        return rinc
    iw = np.minimum(boxes[:, None, 1], qboxes[None, :, 1]) - np.maximum(
        boxes[:, None, 1] - boxes[:, None, 4],
        qboxes[None, :, 1] - qboxes[None, :, 4],
    )
    vol_a = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = iw * rinc
    if criterion == -1:
        ua = vol_a + vol_b - inc
    elif criterion == 0:
        ua = np.broadcast_to(vol_a, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(vol_b, inc.shape)
    else:
        ua = inc
    return np.where((rinc > 0) & (iw > 0), inc / ua, 0.0)


def compute_statistics(
    overlaps, gt_datas, dt_datas, ignored_gt, ignored_det, dc_bboxes,
    metric, min_overlap, thresh=0.0, compute_fp=False, compute_aos=False,
):
    """Greedy per-frame matching (reference compute_statistics_jit
    :158-276) — pure-Python reference kernel; the C++ twin in
    native/kitti_match.cpp is used for full-dataset runs."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [
        compute_fp and dt_scores[i] < thresh for i in range(det_size)
    ]
    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp) and overlap > min_overlap and dt_score > valid_detection:
                det_idx = j
                valid_detection = dt_score
            elif (
                compute_fp and overlap > min_overlap
                and (overlap > max_overlap or assigned_ignored_det)
                and ignored_det[j] == 0
            ):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (
                compute_fp and overlap > min_overlap
                and valid_detection == NO_DETECTION
                and ignored_det[j] == 1
            ):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True
    if compute_fp:
        for j in range(det_size):
            if not (
                assigned_detection[j] or ignored_det[j] in (-1, 1)
                or ignored_threshold[j]
            ):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes):
            overlaps_dt_dc = image_box_overlap(
                dt_bboxes, np.asarray(dc_bboxes), 0
            )
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (
                        assigned_detection[j] or ignored_det[j] in (-1, 1)
                        or ignored_threshold[j]
                    ):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [0.0] * fp + [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def calculate_iou_partly(dt_annos, gt_annos, metric):
    """Per-frame (ndt, ngt) overlap matrices (reference :340-415,
    called with (dt, gt) order by eval_class)."""
    overlaps = []
    for dt, gt in zip(dt_annos, gt_annos):
        if metric == 0:
            o = image_box_overlap(
                np.asarray(dt["bbox"], np.float64),
                np.asarray(gt["bbox"], np.float64),
            )
        elif metric == 1:
            db = np.concatenate(
                [dt["location"][:, [0, 2]], dt["dimensions"][:, [0, 2]],
                 dt["rotation_y"][..., None]], axis=1,
            )
            gb = np.concatenate(
                [gt["location"][:, [0, 2]], gt["dimensions"][:, [0, 2]],
                 gt["rotation_y"][..., None]], axis=1,
            )
            o = bev_box_overlap(db, gb).astype(np.float64)
        elif metric == 2:
            db = np.concatenate(
                [dt["location"], dt["dimensions"], dt["rotation_y"][..., None]],
                axis=1,
            )
            gb = np.concatenate(
                [gt["location"], gt["dimensions"], gt["rotation_y"][..., None]],
                axis=1,
            )
            o = d3_box_overlap(db, gb).astype(np.float64)
        else:
            raise ValueError(metric)
        overlaps.append(o)
    return overlaps


def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt, dt, current_class, difficulty
        )
        ignored_gts.append(np.array(ignored_gt, np.int64))
        ignored_dets.append(np.array(ignored_det, np.int64))
        dontcares.append(
            np.stack(dc_bboxes, 0).astype(np.float64)
            if dc_bboxes else np.zeros((0, 4))
        )
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(
            np.concatenate([gt["bbox"], gt["alpha"][..., None]], 1)
        )
        dt_datas_list.append(
            np.concatenate(
                [dt["bbox"], dt["alpha"][..., None], dt["score"][..., None]], 1
            )
        )
    return (
        gt_datas_list, dt_datas_list, ignored_gts, ignored_dets, dontcares,
        total_num_valid_gt,
    )


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False,
               custom_iou_fn=None, custom_stats_fn=None):
    """(reference eval_class :448-554). custom_* hooks let the
    SlopedKITTI protocol extend metric 3 / extra statistics."""
    assert len(gt_annos) == len(dt_annos)
    iou_fn = custom_iou_fn or calculate_iou_partly
    stats_fn = custom_stats_fn or compute_statistics
    overlaps = iou_fn(dt_annos, gt_annos, metric)
    num_minoverlap = min_overlaps.shape[0]
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)
    for m, current_class in enumerate(current_classes):
        for d, difficulty in enumerate(difficultys):
            (
                gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
                dontcares, total_num_valid_gt,
            ) = _prepare_data(gt_annos, dt_annos, current_class, difficulty)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss = []
                for i in range(len(gt_annos)):
                    _, _, _, _, th = stats_fn(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap=min_overlap, thresh=0.0,
                        compute_fp=False,
                    )
                    thresholdss += th.tolist()
                thresholds = np.array(
                    get_thresholds(np.array(thresholdss), total_num_valid_gt)
                )
                pr = np.zeros([len(thresholds), 4])
                pr = _fused_statistics(
                    stats_fn, overlaps, gt_datas_list, dt_datas_list,
                    ignored_gts, ignored_dets, dontcares, metric,
                    min_overlap, thresholds, compute_aos,
                )
                for i in range(len(thresholds)):
                    recall[m, d, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, d, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, d, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, d, k, i] = np.max(precision[m, d, k, i:])
                    recall[m, d, k, i] = np.max(recall[m, d, k, i:])
                    if compute_aos:
                        aos[m, d, k, i] = np.max(aos[m, d, k, i:])
    return {"recall": recall, "precision": precision, "orientation": aos}


def _fused_statistics(stats_fn, overlaps, gt_datas_list, dt_datas_list,
                      ignored_gts, ignored_dets, dontcares, metric,
                      min_overlap, thresholds, compute_aos):
    """Accumulate tp/fp/fn/similarity per threshold over all frames
    (reference fused_compute_statistics :291). Uses the native kernel
    when available."""
    if native_eval.available() and stats_fn is compute_statistics:
        return native_eval.fused_statistics(
            overlaps, gt_datas_list, dt_datas_list, ignored_gts,
            ignored_dets, dontcares, metric, min_overlap, thresholds,
            compute_aos,
        )
    pr = np.zeros([len(thresholds), 4])
    for i in range(len(overlaps)):
        for t, thresh in enumerate(thresholds):
            tp, fp, fn, similarity, _ = stats_fn(
                overlaps[i], gt_datas_list[i], dt_datas_list[i],
                ignored_gts[i], ignored_dets[i], dontcares[i], metric,
                min_overlap=min_overlap, thresh=thresh,
                compute_fp=True, compute_aos=compute_aos,
            )
            pr[t, 0] += tp
            pr[t, 1] += fp
            pr[t, 2] += fn
            if similarity != -1:
                pr[t, 3] += similarity
    return pr


def get_mAP(prec):
    return sum(prec[..., i] for i in range(0, prec.shape[-1], 4)) / 11 * 100


def get_mAP_R40(prec):
    return sum(prec[..., i] for i in range(1, prec.shape[-1])) / 40 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False):
    difficultys = [0, 1, 2]
    ret = eval_class(
        gt_annos, dt_annos, current_classes, difficultys, 0, min_overlaps,
        compute_aos,
    )
    mAP_bbox = get_mAP(ret["precision"])
    mAP_bbox_R40 = get_mAP_R40(ret["precision"])
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret["orientation"])
        mAP_aos_R40 = get_mAP_R40(ret["orientation"])
    ret = eval_class(
        gt_annos, dt_annos, current_classes, difficultys, 1, min_overlaps
    )
    mAP_bev = get_mAP(ret["precision"])
    mAP_bev_R40 = get_mAP_R40(ret["precision"])
    ret = eval_class(
        gt_annos, dt_annos, current_classes, difficultys, 2, min_overlaps
    )
    mAP_3d = get_mAP(ret["precision"])
    mAP_3d_R40 = get_mAP_R40(ret["precision"])
    return (
        mAP_bbox, mAP_bev, mAP_3d, mAP_aos,
        mAP_bbox_R40, mAP_bev_R40, mAP_3d_R40, mAP_aos_R40,
    )


OVERLAP_0_7 = np.array(
    [[0.7, 0.5, 0.5, 0.7, 0.5, 0.7]] * 3
)
OVERLAP_0_5 = np.array(
    [
        [0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
        [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
        [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
    ]
)
MIN_OVERLAPS = np.stack([OVERLAP_0_7, OVERLAP_0_5], axis=0)  # (2, 3, 6)


def get_official_eval_result(gt_annos, dt_annos, current_classes):
    """(reference :639-746). Returns (result string, flat AP dict)."""
    name_to_class = {n: i for i, n in enumerate(
        ["Car", "Pedestrian", "Cyclist", "Van", "Person_sitting", "Truck"]
    )}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        name_to_class[c] if isinstance(c, str) else int(c)
        for c in current_classes
    ]
    min_overlaps = MIN_OVERLAPS[:, :, current_classes]

    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break

    (
        mAPbbox, mAPbev, mAP3d, mAPaos,
        mAPbbox_R40, mAPbev_R40, mAP3d_R40, mAPaos_R40,
    ) = do_eval(gt_annos, dt_annos, current_classes, min_overlaps, compute_aos)

    class_names_cap = ["Car", "Pedestrian", "Cyclist", "Van",
                       "Person_sitting", "Truck"]
    result = ""
    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        cls_name = class_names_cap[curcls]
        for i in range(min_overlaps.shape[0]):
            result += (
                f"{cls_name} AP@{min_overlaps[i, 0, j]:.2f}, "
                f"{min_overlaps[i, 1, j]:.2f}, {min_overlaps[i, 2, j]:.2f}:\n"
            )
            result += "bbox AP:%.4f, %.4f, %.4f\n" % tuple(mAPbbox[j, :, i])
            result += "bev  AP:%.4f, %.4f, %.4f\n" % tuple(mAPbev[j, :, i])
            result += "3d   AP:%.4f, %.4f, %.4f\n" % tuple(mAP3d[j, :, i])
            if compute_aos:
                result += "aos  AP:%.2f, %.2f, %.2f\n" % tuple(mAPaos[j, :, i])
            result += (
                f"{cls_name} AP_R40@{min_overlaps[i, 0, j]:.2f}, "
                f"{min_overlaps[i, 1, j]:.2f}, {min_overlaps[i, 2, j]:.2f}:\n"
            )
            result += "bbox AP:%.4f, %.4f, %.4f\n" % tuple(mAPbbox_R40[j, :, i])
            result += "bev  AP:%.4f, %.4f, %.4f\n" % tuple(mAPbev_R40[j, :, i])
            result += "3d   AP:%.4f, %.4f, %.4f\n" % tuple(mAP3d_R40[j, :, i])
            if compute_aos:
                result += "aos  AP:%.2f, %.2f, %.2f\n" % tuple(
                    mAPaos_R40[j, :, i]
                )
            if i == 0:
                for d, diff in enumerate(["easy", "moderate", "hard"]):
                    ret_dict[f"{cls_name}_3d/{diff}_R40"] = mAP3d_R40[j, d, 0]
                    ret_dict[f"{cls_name}_bev/{diff}_R40"] = mAPbev_R40[j, d, 0]
                    ret_dict[f"{cls_name}_image/{diff}_R40"] = mAPbbox_R40[j, d, 0]
                    ret_dict[f"{cls_name}_3d/{diff}"] = mAP3d[j, d, 0]
                    ret_dict[f"{cls_name}_bev/{diff}"] = mAPbev[j, d, 0]
                    ret_dict[f"{cls_name}_image/{diff}"] = mAPbbox[j, d, 0]
                    if compute_aos:
                        ret_dict[f"{cls_name}_aos/{diff}_R40"] = mAPaos_R40[j, d, 0]
                        ret_dict[f"{cls_name}_aos/{diff}"] = mAPaos[j, d, 0]
    return result, ret_dict
