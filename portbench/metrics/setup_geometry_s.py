"""Seconds to build the port's problem: geometry, cut tables and
operators on the host, and the first touch of the card."""


def read(t):
    return t.spans["setup_geometry_s"]
