#!/usr/bin/env python3
"""``fused_matmul``'s requantized output on the card against float64.

``chip_smoke.py`` holds the "requant a8" case of ``fused_matmul`` (M 1000,
K 1024, N 4096, W4A8, no norm, tanh-GELU, a 4096-point epilogue WHT,
per-token requantization to 8 bits) to its plain version: int8 outputs
within ±1 on 0.1% of entries, and per-token scales at ``rtol=1e-5`` against
the plain version fed the kernel's own prologue (a ±1 prologue flip moves
a scale of the plain version's own prologue by ~1.5e-5).  This
script runs that case on seeded inputs and prints, per seed, the kernel's
and the plain version's scales against a float64 evaluation of the same
function, fed either the plain version's int8 prologue or the kernel's own
(``norm_quant``, the same device code as the in-kernel prologue), and the
int8 flips of the prologue and of the output.

Run from the repository root on a machine with a CUDA card:

    PYTHONPATH=src python3 tools/fused_requant_margin.py [SEED ...]

(default seeds 0-23).
"""
import math
import sys

import torch

from repro_torch.core.quantize import quantize_weight, unpack_int4
from repro_torch.kernels import _build
from repro_torch.kernels import fused as fz

M, K, N = 1000, 1024, 4096


def fwht64(y: torch.Tensor) -> torch.Tensor:
    """Orthonormal Walsh-Hadamard transform of float64 rows (Sylvester order)."""
    y = y.clone()
    h = 1
    while h < y.shape[1]:
        y = y.view(y.shape[0], -1, 2, h)
        a, b = y[:, :, 0, :].clone(), y[:, :, 1, :].clone()
        y[:, :, 0, :], y[:, :, 1, :] = a + b, a - b
        y = y.view(y.shape[0], -1)
        h *= 2
    return y / math.sqrt(y.shape[1])


def scales64(xv, xs, wq, ws, bias) -> torch.Tensor:
    """The requantization scales of the case in float64, from int8 inputs."""
    y = (xv.double() @ unpack_int4(wq.values, 0).double()) * xs.double().reshape(-1, 1)
    y = y * ws.double() + bias.double()
    y = 0.5 * y * (1 + torch.tanh(math.sqrt(2 / math.pi) * (y + 0.044715 * y ** 3)))
    return fwht64(y).abs().amax(dim=1) / 127


def main(seeds) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    for seed in seeds:
        gen = torch.Generator(device=dev).manual_seed(1000 + seed)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        wq = quantize_weight(randn(K, N) / math.sqrt(K), 4)
        ws = wq.scale.reshape(1, -1).contiguous()
        bias, x = randn(N), randn(M, K)
        kw = dict(packed=wq.packed, a_bits=8, norm_kind=None, pro_wht_block=None, act="gelu",
                  epi_wht_block=N, requant_bits=8, dct_block=None)
        args = (x, wq.values, ws, None, bias, None)
        got, want = fz.fused_matmul(*args, **kw), fz.fused_matmul_plain(*args, **kw)
        pv, ps = fz._prologue(x, None, None, 1e-6, None, 8)
        kv, ks = fz.norm_quant(x, None, norm_kind=None, wht_block=None, a_bits=8)

        def rel(a, b):
            return ((a.reshape(-1).double() - b) / b).abs().max().item()

        s_plain, s_own = scales64(pv, ps, wq, ws, bias), scales64(kv, ks, wq, ws, bias)
        print(f"seed {seed}: prologue flips {int((kv != pv).sum())}; output flips "
              f"{int((got[0] != want[0]).sum())}; scales, max rel: kernel vs plain "
              f"{rel(got[1], want[1].reshape(-1).double()):.3g}, vs float64 on the plain "
              f"prologue: kernel {rel(got[1], s_plain):.3g} plain {rel(want[1], s_plain):.3g}, "
              f"on the kernel's prologue: kernel {rel(got[1], s_own):.3g} plain "
              f"{rel(want[1], s_own):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or range(24)))
