from . import iassd_backbone  # noqa: F401  (registers IASSD_Backbone)
from . import pointnet2_backbone  # noqa: F401  (registers the backbones)
from . import spconv_backbone  # noqa: F401  (registers VoxelBackBone8x)
from . import vfe  # noqa: F401  (registers VFEs)
