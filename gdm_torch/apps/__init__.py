"""Command-line applications of the port (gdm/apps)."""
