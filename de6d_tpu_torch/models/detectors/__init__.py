from . import det6d  # noqa: F401  (registers Det6D, SSD3D)
from . import ia_ssd  # noqa: F401  (registers IASSD)
from . import point_rcnn  # noqa: F401  (registers PointRCNN)
from . import pointpillar  # noqa: F401  (registers PointPillar)
from . import pv_rcnn  # noqa: F401  (registers PVRCNN)
from . import second_net  # noqa: F401  (registers SECONDNet)
from . import voxel_rcnn  # noqa: F401  (registers VoxelRCNN)
from .detector3d_template import DatasetSpec, post_processing

__all__ = ["DatasetSpec", "post_processing"]
