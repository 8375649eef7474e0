from .pillar_vfe import PillarVFE

__all__ = ["PillarVFE"]
