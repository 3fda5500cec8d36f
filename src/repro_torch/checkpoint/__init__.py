"""Checkpoints for the port (port of ``repro/checkpoint``)."""
