"""Spectral analysis tools of the wave application (port of gdm/tools)."""
