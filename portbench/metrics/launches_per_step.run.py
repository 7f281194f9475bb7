"""``launches_per_step`` of the wave cell, which moves ``run_s``."""

from portbench.metrics.launches_per_step import read  # noqa: F401
