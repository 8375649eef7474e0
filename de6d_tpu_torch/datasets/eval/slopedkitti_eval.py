"""SlopedKITTI full-pose evaluation protocol (a numpy copy of
``de6d_tpu/datasets/eval/slopedkitti_eval.py``).

Behavioral spec: reference
core/pcdet/datasets/slopedkitti/kitti_object_eval_python/eval.py —
extends the official KITTI protocol with:

- a 4th difficulty tier "all" (MIN_HEIGHT −1, no occlusion/truncation
  gating — reference :32-34);
- metric 3: center-distance matching score 2 − 2·sigmoid(‖Δctr‖)
  (d9_box_matching_score :159-196; thresholds 0.53/0.20 ≙ 1 m/2 m);
- per-TP translation/scale/orientation error accumulation over
  yaw/pitch/roll (ATE/ASE/AOE — :613-648) from the score-greedy first
  matching pass (thresh 0, compute_fp False);
- composite ODS = mAP/200 + Σ tp_scores/6 (get_tp_score :675,
  get_ods :690).
"""

from __future__ import annotations

import numpy as np

from . import kitti_eval
from .kitti_eval import (
    CLASS_NAMES, N_SAMPLE_PTS, get_thresholds, get_mAP, get_mAP_R40,
    image_box_overlap, bev_box_overlap, d3_box_overlap,
    compute_statistics, _fused_statistics,
)

MIN_HEIGHT = [40, 25, 25, -1]
MAX_OCCLUSION = [0, 1, 2, 10000]
MAX_TRUNCATION = [0.15, 0.3, 0.5, 10000]


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """4-tier difficulty gating (reference slopedkitti eval :30-85)."""
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
        valid_class = (
            1 if str(dt_anno["name"][i]).lower() == current_cls_name else -1
        )
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def d9_box_matching_score(boxes, query_boxes, score_type: int = 0):
    """(N, 9) x (K, 9) center-distance match score, vectorized
    (reference :159-196)."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    dist = np.linalg.norm(
        boxes[:, None, :3] - query_boxes[None, :, :3], axis=-1
    )
    sig = 1.0 / (1.0 + np.exp(-dist))
    if score_type == 0:
        return 2.0 - 2.0 * sig
    diag_b = np.linalg.norm(boxes[:, 3:6], axis=-1)[:, None]
    diag_q = np.linalg.norm(query_boxes[:, 3:6], axis=-1)[None, :]
    if score_type == 1:
        return 2.0 - 2.0 * sig * (2 * diag_b * diag_q) / (diag_q**2 + diag_b**2)
    if score_type == 2:
        return np.maximum(1.0 - 2.0 * dist / (diag_b + diag_q), 0.0)
    raise NotImplementedError(score_type)


def _boxes9d(anno):
    return np.concatenate(
        [
            anno["location"], anno["dimensions"],
            anno["rotation_y"][..., None], anno["pitch"][..., None],
            anno["roll"][..., None],
        ],
        axis=1,
    )


def calculate_iou_partly(dt_annos, gt_annos, metric):
    if metric != 3:
        return kitti_eval.calculate_iou_partly(dt_annos, gt_annos, metric)
    return [
        d9_box_matching_score(_boxes9d(dt), _boxes9d(gt)).astype(np.float64)
        for dt, gt in zip(dt_annos, gt_annos)
    ]


def compute_statistics_with_tp(
    overlaps, gt_datas, dt_datas, ignored_gt, ignored_det, dc_bboxes,
    metric, min_overlap, thresh=0.0, compute_fp=False, compute_aos=False,
):
    """First-pass matching that also records, per detection, the index
    of its matched gt (reference :218,:275-279 gt_of_tp_detection)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    assigned_detection = [False] * det_size
    gt_of_tp = np.full(det_size, -1, np.int32)
    thresholds = []
    NO_DETECTION = kitti_eval.NO_DETECTION
    tp = fn = 0
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned_detection[j]:
                continue
            overlap = overlaps[j, i]
            if overlap > min_overlap and dt_scores[j] > valid_detection:
                det_idx = j
                valid_detection = dt_scores[j]
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            gt_of_tp[det_idx] = i
            assigned_detection[det_idx] = True
    return tp, 0, fn, 0.0, np.array(thresholds), gt_of_tp


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
               min_overlaps, compute_aos=False):
    """(reference slopedkitti eval_class :499-661)."""
    assert len(gt_annos) == len(dt_annos)
    overlaps = calculate_iou_partly(dt_annos, gt_annos, metric)
    num_minoverlap = min_overlaps.shape[0]
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)
    ate = np.zeros([num_class, num_difficulty, num_minoverlap])
    ase = np.zeros_like(ate)
    aoe = np.zeros([num_class, num_difficulty, num_minoverlap, 3])
    num_tp = np.zeros_like(ate)

    for m, current_class in enumerate(current_classes):
        for d, difficulty in enumerate(difficultys):
            (
                gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
                dontcares, total_num_valid_gt,
            ) = _prepare_data(gt_annos, dt_annos, current_class, difficulty)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                thresholdss, gt_of_tpss = [], []
                for i in range(len(gt_annos)):
                    _, _, _, _, th, gt_of_tp = compute_statistics_with_tp(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap=min_overlap,
                    )
                    thresholdss += th.tolist()
                    gt_of_tpss.append(gt_of_tp)
                thresholds = np.array(
                    get_thresholds(np.array(thresholdss), total_num_valid_gt)
                )
                pr = _fused_statistics(
                    compute_statistics, overlaps, gt_datas_list,
                    dt_datas_list, ignored_gts, ignored_dets, dontcares,
                    metric, min_overlap, thresholds, compute_aos,
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
                if metric == 3:
                    for scene, gt_idx in enumerate(gt_of_tpss):
                        mask = gt_idx > -1
                        if mask.sum() == 0:
                            continue
                        vgt = gt_idx[mask]
                        ga, da = gt_annos[scene], dt_annos[scene]
                        dim_gt = ga["dimensions"][vgt]
                        loc_gt = ga["location"][vgt]
                        rot_gt = np.stack(
                            [ga["rotation_y"][vgt], ga["pitch"][vgt],
                             ga["roll"][vgt]], axis=-1,
                        ) % (2 * np.pi)
                        dim_dt = da["dimensions"][mask]
                        loc_dt = da["location"][mask]
                        rot_dt = np.stack(
                            [da["rotation_y"][mask], da["pitch"][mask],
                             da["roll"][mask]], axis=-1,
                        ) % (2 * np.pi)
                        ate[m, d, k] += np.linalg.norm(
                            loc_gt - loc_dt, axis=-1
                        ).sum()
                        inter = np.minimum(dim_gt, dim_dt).prod(axis=1)
                        union = dim_dt.prod(1) + dim_gt.prod(1) - inter
                        ase[m, d, k] += (1 - inter / union).sum()
                        rot_dis = np.abs(rot_dt - rot_gt)
                        rot_dis = np.where(
                            rot_dis > np.pi, 2 * np.pi - rot_dis, rot_dis
                        )
                        aoe[m, d, k] += rot_dis.sum(axis=0)
                        num_tp[m, d, k] += mask.sum()
    return {
        "recall": recall, "precision": precision, "orientation": aos,
        "ate": ate, "ase": ase, "aoe": aoe, "num_tp": num_tp,
    }


def get_tp_score(ate, ase, aoe, num_tp):
    """(reference :675-687)"""
    aoe = aoe.sum(axis=-1)
    n = np.maximum(num_tp, 1e-9)
    ats = np.clip(1 - ate / n, 0, 1)
    ass = np.clip(1 - ase / n, 0, 1)
    aos = np.clip(1 - aoe / n, 0, 1)
    return np.array([ats, ass, aos])


def get_ods(mAP, tp_score_list):
    """(reference :690-696)"""
    weight = 1.0 / (tp_score_list.shape[0] * 2)
    return mAP / 100.0 / 2.0 + (weight * tp_score_list).sum(axis=0)


OVERLAP_0_7 = np.array(
    [
        [0.70, 0.50, 0.50, 0.70, 0.50, 0.70],
        [0.70, 0.50, 0.50, 0.70, 0.50, 0.70],
        [0.70, 0.50, 0.50, 0.70, 0.50, 0.70],
        [0.53, 0.53, 0.53, 0.53, 0.53, 0.53],  # ctr: 2-2·sigmoid(1 m)
    ]
)
OVERLAP_0_5 = np.array(
    [
        [0.70, 0.50, 0.50, 0.70, 0.50, 0.50],
        [0.50, 0.25, 0.25, 0.50, 0.25, 0.50],
        [0.50, 0.25, 0.25, 0.50, 0.25, 0.50],
        [0.20, 0.20, 0.20, 0.20, 0.20, 0.20],  # ctr: ≈ 2 m
    ]
)
MIN_OVERLAPS = np.stack([OVERLAP_0_7, OVERLAP_0_5], axis=0)  # (2, 4, 6)


def do_eval_slopedkitti(gt_annos, dt_annos, current_classes, min_overlaps,
                        compute_aos=False):
    difficultys = [0, 1, 2, 3]
    ret = eval_class(
        gt_annos, dt_annos, current_classes, difficultys, 0, min_overlaps,
        compute_aos,
    )
    mAP_bbox, mAP_bbox_R40 = get_mAP(ret["precision"]), get_mAP_R40(ret["precision"])
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret["orientation"])
        mAP_aos_R40 = get_mAP_R40(ret["orientation"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1, min_overlaps)
    mAP_bev, mAP_bev_R40 = get_mAP(ret["precision"]), get_mAP_R40(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2, min_overlaps)
    mAP_3d, mAP_3d_R40 = get_mAP(ret["precision"]), get_mAP_R40(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 3, min_overlaps)
    mAP_3dctr, mAP_3dctr_R40 = get_mAP(ret["precision"]), get_mAP_R40(ret["precision"])
    tp_scores = get_tp_score(ret["ate"], ret["ase"], ret["aoe"], ret["num_tp"])
    ods = get_ods(mAP_3dctr, tp_scores)
    ods_R40 = get_ods(mAP_3dctr_R40, tp_scores)
    return (
        mAP_bbox, mAP_bev, mAP_3d, mAP_aos, mAP_3dctr, ods,
        mAP_bbox_R40, mAP_bev_R40, mAP_3d_R40, mAP_aos_R40, mAP_3dctr_R40,
        ods_R40, tp_scores,
    )


def get_slopedkitti_eval_result(gt_annos, dt_annos, current_classes):
    class_names_cap = ["Car", "Pedestrian", "Cyclist", "Van",
                       "Person_sitting", "Truck"]
    name_to_class = {n: i for i, n in enumerate(class_names_cap)}
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
        mAPbbox, mAPbev, mAP3d, mAPaos, mAP3dctr, ods,
        mAPbbox_R40, mAPbev_R40, mAP3d_R40, mAPaos_R40, mAP3dctr_R40,
        ods_R40, tp_scores,
    ) = do_eval_slopedkitti(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos
    )

    result = "\n"
    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        cls_name = class_names_cap[curcls]
        for i in range(min_overlaps.shape[0]):
            result += (
                f"{cls_name} AP_R40@"
                + ", ".join(f"{x:.2f}" for x in min_overlaps[i, :, j]) + ":\n"
            )
            result += "bbox AP:%.4f, %.4f, %.4f\n" % tuple(mAPbbox_R40[j, :3, i])
            result += "bev  AP:%.4f, %.4f, %.4f\n" % tuple(mAPbev_R40[j, :3, i])
            result += "3d   AP:%.4f, %.4f, %.4f\n" % tuple(mAP3d_R40[j, :3, i])
            if compute_aos:
                result += "aos  AP:%.2f, %.2f, %.2f\n" % tuple(mAPaos_R40[j, :3, i])
            result += f"3d  CAP: {mAP3dctr_R40[j, 3, i]:.4f}\n"
            result += f"3d  ATS: {tp_scores[0][j, 3, i]:.4f}\n"
            result += f"3d  ASS: {tp_scores[1][j, 3, i]:.4f}\n"
            result += f"3d  AOS: {tp_scores[2][j, 3, i]:.4f}\n"
            result += f"3d  ODS: {ods_R40[j, 3, i]:.4f}\n\n"
            if i == 0:
                for d, diff in enumerate(["easy", "moderate", "hard"]):
                    ret_dict[f"{cls_name}_3d/{diff}_R40"] = mAP3d_R40[j, d, 0]
                    ret_dict[f"{cls_name}_bev/{diff}_R40"] = mAPbev_R40[j, d, 0]
                    ret_dict[f"{cls_name}_image/{diff}_R40"] = mAPbbox_R40[j, d, 0]
                    if compute_aos:
                        ret_dict[f"{cls_name}_aos/{diff}_R40"] = mAPaos_R40[j, d, 0]
                ret_dict[f"{cls_name}_cap/all_R40"] = mAP3dctr_R40[j, 3, 0]
                ret_dict[f"{cls_name}_ats/all"] = tp_scores[0][j, 3, 0]
                ret_dict[f"{cls_name}_ass/all"] = tp_scores[1][j, 3, 0]
                ret_dict[f"{cls_name}_aoe_score/all"] = tp_scores[2][j, 3, 0]
                ret_dict[f"{cls_name}_ods/all_R40"] = ods_R40[j, 3, 0]
    return result, ret_dict
