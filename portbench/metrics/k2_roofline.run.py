"""``k2_roofline`` of the wave cell, which moves ``run_s``."""

from portbench.metrics.k2_roofline import read  # noqa: F401
