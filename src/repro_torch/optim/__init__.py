"""AdamW for the port (port of ``repro/optim``)."""
