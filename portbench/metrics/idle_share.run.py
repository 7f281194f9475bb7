"""``idle_share`` of the wave cell, which moves ``run_s``."""

from portbench.metrics.idle_share import read  # noqa: F401
