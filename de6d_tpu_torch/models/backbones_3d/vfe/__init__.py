from .mean_vfe import MeanVFE
from .pillar_vfe import PillarVFE

__all__ = ["MeanVFE", "PillarVFE"]
