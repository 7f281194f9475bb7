"""Applications of the port: the uncut Poisson solve (``poisson``) and
the cut wave/heat application's explicit time loops (``wave``)."""
