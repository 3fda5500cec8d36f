"""Plain references of the served models: float32 PyTorch arithmetic of
the VersaQ W4A8 flow, worked out from the raw seed-made weights.  Nothing
here imports the program under test."""
