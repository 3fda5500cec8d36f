"""Model code of the port (VGGT so far)."""
