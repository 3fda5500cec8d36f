"""Launchers of the port: serving, schedule compilation and training."""
