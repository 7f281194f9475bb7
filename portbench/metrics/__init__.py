"""One reader a per-layer metric, named as the metric: ``read(t)``
takes the traced run's readings (``trace.stretch``, with the run's
spans, fallbacks and the reference's node counts) and gives the value,
or None where the run has nothing to read."""
