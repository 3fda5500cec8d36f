"""Launchers of the port (VGGT serving so far)."""
