from .anchor_head import AnchorHeadSingle

__all__ = ["AnchorHeadSingle"]
