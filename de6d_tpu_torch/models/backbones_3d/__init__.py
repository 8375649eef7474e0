from . import vfe  # noqa: F401  (registers VFEs)
