from . import pointrcnn_head  # noqa: F401  (registers PointRCNNHead)
from . import pvrcnn_head  # noqa: F401  (registers PVRCNNHead)
from . import voxelrcnn_head  # noqa: F401  (registers VoxelRCNNHead)
