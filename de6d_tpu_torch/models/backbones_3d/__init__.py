from . import pointnet2_backbone  # noqa: F401  (registers PointNet2FSMSG)
from . import vfe  # noqa: F401  (registers VFEs)
