"""Core VersaQ-3D library of the port: orthogonal transforms, symmetric
quantization, the VersaQ weight flow and whole-model quantization."""
