"""Evaluation harness (counterpart of ``de6d_tpu/train/eval_utils.py``):
batched no-grad inference, recall counters, ``result.pkl``, then
``dataset.evaluation()``. Device outputs are fixed-size (post_max, ...)
buffers and counts; the host trims them to the counts before it builds
the prediction dicts.

Two batches stay in flight: batch i+1 is uploaded and queued before the
outputs of batch i are read, and a batch's outputs are read only after
the CUDA event recorded behind its step has completed.
"""

from __future__ import annotations

import pickle
import time
from collections import deque
from pathlib import Path

import torch

from ..models.detectors.detector3d_template import (
    generate_recall_record, post_processing,
)
from .train_loop import device_batch


def make_full_eval_step(model, post_cfg, num_class, thresh_list):
    """``step(batch) -> (post, recalls)``: the eval-mode forward,
    ``post_processing`` and the recall counters, as tensors on the
    model's device."""
    thresh_list = tuple(thresh_list)

    def step(batch):
        model.eval()
        with torch.no_grad():
            out = model(dict(batch))
            post = post_processing(out, post_cfg, num_class)
            recalls = generate_recall_record(
                out, post["pred_boxes"], post["pred_count"],
                thresh_list=thresh_list)
        return post, recalls

    return step


def eval_one_epoch(model, loader, dataset, model_cfg, class_names,
                   result_dir=None, logger=None, save_to_file=False,
                   allow_zero_recall=False):
    """Evaluate ``model`` (its weights loaded) over ``loader``. Returns
    (ret_dict: ``recall/recalled_<t>``, the AP entries,
    ``sec_per_example``, ``steady_sec_per_example`` (the median over the
    full batches after the first, None when withheld), ``zero_recall``,
    ``recall_counts``; det_annos)."""
    post_cfg = model_cfg["POST_PROCESSING"]
    thresh_list = post_cfg.get("RECALL_THRESH_LIST", [0.3, 0.5, 0.7])
    step = make_full_eval_step(model, post_cfg, len(class_names), thresh_list)
    device = next(model.parameters()).device
    det_annos = []
    recall_totals = {}
    n_frames = 0
    batch_times = []  # (wall_s, batch_size) per batch
    t_start = time.perf_counter()
    output_path = None
    if result_dir is not None:
        result_dir = Path(result_dir)
        result_dir.mkdir(parents=True, exist_ok=True)
        if save_to_file:
            output_path = result_dir / "final_result" / "data"
            output_path.mkdir(parents=True, exist_ok=True)

    pending = deque()
    last_done = t_start

    def _drain_one():
        nonlocal last_done, n_frames
        batch, post, recalls, done = pending.popleft()
        if done is not None:
            done.synchronize()
        post = {k: v.cpu().numpy() for k, v in post.items()}
        now = time.perf_counter()
        batch_times.append((now - last_done, batch["batch_size"]))
        last_done = now
        for k, v in recalls.items():
            recall_totals[k] = recall_totals.get(k, 0) + int(v)
        pred_dicts = []
        for i in range(batch["batch_size"]):
            cnt = int(post["pred_count"][i])
            pred_dicts.append({
                "pred_boxes": post["pred_boxes"][i, :cnt],
                "pred_scores": post["pred_scores"][i, :cnt],
                "pred_labels": post["pred_labels"][i, :cnt],
            })
        det_annos.extend(dataset.generate_prediction_dicts(
            batch, pred_dicts, class_names, output_path=output_path))
        n_frames += batch["batch_size"]

    for batch in loader:
        post, recalls = step(device_batch(batch, device))
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        pending.append((batch, post, recalls, done))
        if len(pending) >= 2:
            _drain_one()
    while pending:
        _drain_one()

    sec_per_example = (time.perf_counter() - t_start) / max(n_frames, 1)
    # zero-recall tripwire: an eval that recalls nothing at any threshold
    # against a nonzero GT set almost always means the checkpoint failed
    # to load (random weights); its latency figures are withheld unless
    # the caller opts in
    zero_recall = (
        recall_totals.get("gt", 0) > 0
        and not any(v > 0 for k, v in recall_totals.items()
                    if k.startswith("recalled_"))
    )
    steady = None
    if len(batch_times) > 1 and (allow_zero_recall or not zero_recall):
        # per-frame median over full-size batches after the first (the
        # first pays cuDNN's autotuning, a short last batch its own shapes)
        bmax = max(bs for _, bs in batch_times)
        per = sorted(s / bs for s, bs in batch_times[1:] if bs == bmax)
        steady = per[len(per) // 2] if per else None
    if logger:
        logger.info(
            f"eval: {n_frames} frames, {sec_per_example * 1e3:.1f} ms/frame")
        if zero_recall and not allow_zero_recall:
            logger.warning(
                "eval recalled 0 GT boxes at every threshold — "
                "checkpoint likely missing/random; steady-state latency "
                "WITHHELD (pass allow_zero_recall=True / "
                "--allow-zero-recall to report it anyway)")
        if steady is not None:
            logger.info(f"eval steady-state p50 (full batches, excl. "
                        f"first): {steady * 1e3:.1f} ms/frame")

    ret_dict = {}
    gt_num = max(recall_totals.get("gt", 0), 1)
    for k, v in recall_totals.items():
        if k.startswith("recalled_"):
            ret_dict[f"recall/{k}"] = v / gt_num
            if logger:
                logger.info(f"{k}: {v / gt_num:.4f}")

    if result_dir is not None:
        with open(result_dir / "result.pkl", "wb") as f:
            pickle.dump(det_annos, f)

    result_str, ap_dict = dataset.evaluation(det_annos, class_names)
    if logger and result_str:
        logger.info(result_str)
    ret_dict.update(ap_dict or {})
    ret_dict["sec_per_example"] = sec_per_example
    ret_dict["steady_sec_per_example"] = steady
    ret_dict["zero_recall"] = bool(zero_recall)
    ret_dict["recall_counts"] = dict(recall_totals)
    return ret_dict, det_annos
