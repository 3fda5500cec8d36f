"""Core VersaQ-3D library of the port: orthogonal transforms, symmetric
quantization, the VersaQ weight flow and whole-model quantization.

Re-exports the names ``repro.core`` does.  The ``versaq`` names load on
first use: ``core/versaq.py`` imports the kernel wrappers, which import
``core.quantize`` — an eager import here would close that loop.
"""
from repro_torch.core.quantize import QTensor, quantize, dequantize, pack_int4, unpack_int4
from repro_torch.core.transforms import apply_wht, fast_wht, hadamard_matrix, dct_matrix

_VERSAQ = ("QuantPolicy", "QuantLinear", "FoldedNorm", "apply_linear", "apply_norm",
           "prepare_linear", "W4A8", "W4A4")

__all__ = [
    "QTensor", "quantize", "dequantize", "pack_int4", "unpack_int4",
    "apply_wht", "fast_wht", "hadamard_matrix", "dct_matrix", *_VERSAQ,
]


def __getattr__(name):
    if name in _VERSAQ:
        from repro_torch.core import versaq

        return getattr(versaq, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
