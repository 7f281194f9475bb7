"""``fallbacks`` of the wave cell, which moves ``run_s``."""

from portbench.metrics.fallbacks import read  # noqa: F401
