from . import voxel_set_abstraction  # noqa: F401  (registers the PFE)
