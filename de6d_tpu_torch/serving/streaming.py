"""Streaming inference driver (counterpart of
``de6d_tpu/serving/streaming.py:StreamingDetector``).

Feed raw (N, 3|4) clouds and get detections back. ``submit`` enqueues
one frame and ``submit_batch`` several frames as one batch; both return
once the work is queued on the card. ``result()`` returns the oldest
finished frame, waiting on the card only for it. At most ``depth``
batches are in flight.

Boxes come back as the model makes them: (n, 7) for anchor heads,
(n, 9) for Det6D's full pose. For models with more than 1024 NMS
candidates (PointPillars) one host sync happens inside ``submit``: the
NMS prefix cascade decides on the host whether the full-width NMS pass
is needed (``ops/nms.py:nms_candidates_batched``); Det6D's 256
candidates skip the cascade.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .. import resolve_device
from ..models.detectors.detector3d_template import post_processing


class StreamingDetector:
    def __init__(self, model, model_cfg, num_class: int,
                 max_points: int = 16384, depth: int = 2, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.post_cfg = model_cfg["POST_PROCESSING"]
        self.num_class = num_class
        self.max_points = max_points
        self.depth = depth
        self._rng = np.random.default_rng(0)  # subsampling is reproducible
        self._queue: collections.deque = collections.deque()
        self._ready: collections.deque = collections.deque()

    def _prepare(self, points: np.ndarray):
        """Pad (or subsample) one cloud to ``max_points`` rows of xyzi."""
        n = points.shape[0]
        if points.shape[1] == 3:
            points = np.concatenate(
                [points, np.zeros((n, 1), points.dtype)], axis=1
            )
        if n >= self.max_points:
            sel = self._rng.choice(n, self.max_points, replace=False)
            buf = points[sel]
            n = self.max_points
        else:
            buf = np.concatenate(
                [points, np.zeros((self.max_points - n, points.shape[1]),
                                  points.dtype)],
            )
        mask = np.arange(self.max_points) < n
        return buf.astype(np.float32), mask

    @torch.no_grad()
    def infer(self, points, mask):
        """(B, N, 4) points + (B, N) mask tensors on the device → the
        post-processed (B, post) outputs (asynchronous apart from the
        NMS cascade's one sync)."""
        out = self.model({"points": points, "points_mask": mask})
        post = post_processing(out, self.post_cfg, self.num_class)
        return (post["pred_boxes"], post["pred_scores"],
                post["pred_labels"], post["pred_count"])

    def submit_batch(self, frames):
        """Enqueue a list of clouds as one batch."""
        bufs, masks = zip(*(self._prepare(f) for f in frames))
        t0 = time.perf_counter()
        points = torch.from_numpy(np.stack(bufs)).to(
            self.device, non_blocking=True
        )
        mask = torch.from_numpy(np.stack(masks)).to(
            self.device, non_blocking=True
        )
        self._queue.append((t0, self.infer(points, mask)))
        while len(self._queue) > self.depth:
            self._drain_one()

    def submit(self, points: np.ndarray):
        """Enqueue one frame."""
        self.submit_batch([points])

    def _drain_one(self):
        t0, outs = self._queue.popleft()
        boxes, scores, labels, counts = (o.cpu().numpy() for o in outs)
        latency = time.perf_counter() - t0
        for i, c in enumerate(counts.tolist()):
            self._ready.append({
                "boxes": boxes[i, :c],
                "scores": scores[i, :c],
                "labels": labels[i, :c],
                "latency_s": latency,
            })

    def result(self):
        """The oldest finished frame (waits on the card if needed); None
        when nothing is pending."""
        if not self._ready and self._queue:
            self._drain_one()
        return self._ready.popleft() if self._ready else None

    def detect_batch(self, frames):
        """Synchronous: submit a batch and return every pending frame."""
        self.submit_batch(frames)
        out = []
        while (r := self.result()) is not None:
            out.append(r)
        return out

    def detect(self, points: np.ndarray):
        """Synchronous convenience: submit one frame, drain everything,
        return the newest frame's result."""
        return self.detect_batch([points])[-1]
