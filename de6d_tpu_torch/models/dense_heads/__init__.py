from .anchor_head import AnchorHeadSingle
from .iassd_head import IASSD_Head
from .point_head_box import PointHeadBox, PointHeadSimple
from .point_head_box6d import PointHeadBox6D
from .point_head_vote import PointHeadBox6DVote, PointHeadBoxVote

__all__ = ["AnchorHeadSingle", "IASSD_Head", "PointHeadBox",
           "PointHeadBox6D", "PointHeadBox6DVote", "PointHeadBoxVote",
           "PointHeadSimple"]
