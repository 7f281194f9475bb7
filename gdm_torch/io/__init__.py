"""Output: VTU files and convergence tables (port of gdm/io, host
numpy)."""

from .vtu import DataOut  # noqa: F401
from .tables import ConvergenceTable  # noqa: F401
