"""One module a family of configurations: ``Driver`` builds the port's
problem and runs the traffic's segments through its public entry,
``host`` reads a segment's outputs, ``Reference`` runs the plain
reference and compares."""
