"""Applications of the port: the uncut Poisson solve (``poisson``)."""
