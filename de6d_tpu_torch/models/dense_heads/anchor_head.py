"""Anchor-based dense head, inference only (counterpart of
``de6d_tpu/models/dense_heads/anchor_head.py:AnchorHeadSingle`` and
``decode_boxes_with_dir``). The target assigner and losses come with the
training slice.

Alone, the head hands ``post_processing`` a lazy decode (the candidates'
rows only). With ``predict_boxes_when_training`` (set when a RoI head
follows), it decodes every anchor into ``batch_box_preds`` and writes no
lazy dict, as the JAX head does: the proposal layer reads those boxes.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops import geometry
from ...registry import DENSE_HEADS
from ...utils import box_coder_utils
from ..model_utils.dtype_utils import compute_dtype
from ..model_utils.layers import Conv
from . import anchor_generator


def decode_boxes_with_dir(coder, dir_cfg, box_preds, dir_preds, anchors):
    """Residual decode + direction-bin yaw correction on matching
    (..., S) / (..., 7+) shapes; fp32."""
    batch_box = coder.decode(box_preds, anchors)
    if dir_preds is not None and dir_cfg is not None:
        dir_offset, dir_limit, num_bins = dir_cfg
        dir_labels = torch.argmax(dir_preds, dim=-1)
        period = 2 * math.pi / num_bins
        yaw = geometry.limit_period(
            batch_box[..., 6] - dir_offset, dir_limit, period
        )
        yaw = yaw + dir_offset + period * dir_labels.to(yaw.dtype)
        batch_box = torch.cat(
            [batch_box[..., :6], yaw[..., None], batch_box[..., 7:]], dim=-1
        )
    return batch_box


@DENSE_HEADS.register
class AnchorHeadSingle(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range,
                 predict_boxes_when_training=False):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.predict_boxes_when_training = predict_boxes_when_training
        tgt_cfg = model_cfg["TARGET_ASSIGNER_CONFIG"]
        self.box_coder = box_coder_utils.build_box_coder(
            tgt_cfg["BOX_CODER"], **dict(tgt_cfg.get("BOX_CODER_CONFIG", {}))
        )
        anchors, _, _, _, a_loc = anchor_generator.generate_anchors(
            model_cfg["ANCHOR_GENERATOR_CONFIG"], grid_size, point_cloud_range
        )
        self.num_anchors_per_location = a_loc
        self.register_buffer(
            "anchors", torch.from_numpy(anchors.reshape(-1, anchors.shape[-1])),
            persistent=False,
        )
        dt = compute_dtype(model_cfg)
        self.conv_cls = Conv(input_channels, a_loc * num_class, 1, dtype=dt)
        self.conv_box = Conv(
            input_channels, a_loc * self.box_coder.code_size, 1, dtype=dt
        )
        self.use_dir = model_cfg.get("USE_DIRECTION_CLASSIFIER", False)
        self.num_dir_bins = int(model_cfg.get("NUM_DIR_BINS", 2))
        if self.use_dir:
            self.conv_dir = Conv(
                input_channels, a_loc * self.num_dir_bins, 1, dtype=dt
            )

    def dir_cfg(self):
        if not self.use_dir:
            return None
        return (
            float(self.model_cfg.get("DIR_OFFSET", 0.78539)),
            float(self.model_cfg.get("DIR_LIMIT_OFFSET", 0.0)),
            self.num_dir_bins,
        )

    def forward(self, batch_dict):
        x = batch_dict["spatial_features_2d"]  # (B, H, W, C) NHWC view
        b, h, w = x.shape[0], x.shape[1], x.shape[2]
        x = x.permute(0, 3, 1, 2)

        def head(conv):  # raw predictions back to fp32, NHWC cell rows
            return conv(x).float().permute(0, 2, 3, 1).reshape(b, h * w, -1)

        cls_cell = head(self.conv_cls)
        box_cell = head(self.conv_box)
        dir_cell = head(self.conv_dir) if self.use_dir else None
        batch_dict["batch_cls_preds"] = cls_cell.reshape(b, -1, self.num_class)
        batch_dict["cls_preds_normalized"] = False
        if self.predict_boxes_when_training:
            # a RoI head follows: every anchor decoded, (B, A, 7)
            code = self.box_coder.code_size
            dir_preds = (None if dir_cell is None
                         else dir_cell.reshape(b, -1, self.num_dir_bins))
            batch_dict["batch_box_preds"] = decode_boxes_with_dir(
                self.box_coder, self.dir_cfg(), box_cell.reshape(b, -1, code),
                dir_preds, self.anchors[None])
            return batch_dict
        # post_processing decodes only the top-`pre` candidates; the full
        # (B, A, 7) decode of every anchor is never built
        batch_dict["lazy_box_decode"] = {
            "raw_cell": box_cell,
            "dir_cell": dir_cell,
            "anchors_cell": self.anchors.reshape(h * w, -1),
            "a_loc": self.num_anchors_per_location,
            "code_size": self.box_coder.code_size,
            "coder": self.box_coder,
            "dir_cfg": self.dir_cfg(),
        }
        return batch_dict
