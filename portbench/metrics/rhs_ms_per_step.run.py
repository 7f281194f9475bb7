"""``rhs_ms_per_step`` of the wave cell, which moves ``run_s``."""

from portbench.metrics.rhs_ms_per_step import read  # noqa: F401
