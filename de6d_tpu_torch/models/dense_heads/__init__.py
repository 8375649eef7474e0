from .anchor_head import AnchorHeadSingle
from .point_head_box import PointHeadBox
from .point_head_vote import PointHeadBox6DVote

__all__ = ["AnchorHeadSingle", "PointHeadBox", "PointHeadBox6DVote"]
