from .levelset import LevelSetInterpolant  # noqa: F401
from .geometry import CutGeometry, INSIDE, OUTSIDE, INTERSECTED  # noqa: F401
