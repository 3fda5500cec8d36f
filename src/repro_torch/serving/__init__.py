"""Serving engines of the port (VGGT so far)."""
