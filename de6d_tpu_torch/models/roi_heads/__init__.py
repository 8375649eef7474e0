from . import pointrcnn_head  # noqa: F401  (registers PointRCNNHead)
