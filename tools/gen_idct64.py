#!/usr/bin/env python3
"""Generate ``src/repro_torch/csrc/idct64.cuh``: the 64-point block IDCT of the
fused kernels as straight-line float code with literal constants.

    python3 tools/gen_idct64.py            # rewrite the header
    python3 tools/gen_idct64.py --check    # exit 1 if the header is stale

The block IDCT is y = x . D with D[k][i] = a_k cos(pi (2i+1) k / 128)
(``core/transforms.py::dct_matrix``).  Splitting k into even and odd gives
y[n] = E[n] + O[n] and y[63-n] = E[n] - O[n] for n < 32, where E is a
32-point DCT-III of a_2m x[2m] and O = a_1 * DCT-IV_32(x[odd]).  The header
holds the two halves, each for one thread:

* ``idct64_even(z)``: z[m] = x[2m] in, E[n] out (the a_2m scaling included);
* ``idct64_odd(u)``: u[j] = x[2j+1] in, O[n] out.

The DCT-III recurses the same way (even part a DCT-III of half the size,
odd part a DCT-IV); each DCT-IV of size M is a complex FFT of M/2 points
between two twiddle passes (pre: exp(-i pi (n + 1/4) / M), post: exp(-i pi
k / M), the scaling folded into the post-twiddle), so every factor has
magnitude at most one.  About 17 operations an output, against the dense
product's 128.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "idct64.cuh"
A0, A1 = math.sqrt(1 / 64), math.sqrt(2 / 64)


def lit(c: float) -> str:
    return f"{np.float32(c)!r}".replace("np.float32(", "").rstrip(")") + "f"


class Gen:
    """Emits SSA float statements; values are variable names."""

    def __init__(self) -> None:
        self.lines: list[str] = []
        self.n = 0

    def new(self, expr: str) -> str:
        name = f"t{self.n}"
        self.n += 1
        self.lines.append(f"  const float {name} = {expr};")
        return name

    def add(self, a, b):
        return self.new(f"{a} + {b}")

    def sub(self, a, b):
        return self.new(f"{a} - {b}")

    def mul(self, a, c: float):
        return self.new(f"{a} * {lit(c)}")

    def cmul(self, a, b, c: float, d: float):
        """(a + ib) (c + id) for constants c, d."""
        if abs(d) < 1e-15:
            return self.mul(a, c), self.mul(b, c)
        if abs(c) < 1e-15:
            return self.mul(b, -d), self.mul(a, d)
        bd = self.mul(b, d)
        bc = self.mul(b, c)
        return (self.new(f"fmaf({a}, {lit(c)}, -{bd})"), self.new(f"fmaf({a}, {lit(d)}, {bc})"))

    def fft(self, v):
        """Forward DFT of complex values [(re, im)], radix-2."""
        h = len(v)
        if h == 1:
            return v
        ev, od = self.fft(v[0::2]), self.fft(v[1::2])
        out = [None] * h
        for k in range(h // 2):
            ang = -2 * math.pi * k / h
            if k == 0:
                t = od[k]
            elif 4 * k == h:  # times -i
                t = (od[k][1], self.new(f"-{od[k][0]}"))
            else:
                t = self.cmul(od[k][0], od[k][1], math.cos(ang), math.sin(ang))
            out[k] = (self.add(ev[k][0], t[0]), self.add(ev[k][1], t[1]))
            out[k + h // 2] = (self.sub(ev[k][0], t[0]), self.sub(ev[k][1], t[1]))
        return out

    def dct4(self, u, scale: float = 1.0):
        """y[n] = scale * sum_j u[j] cos(pi (2n+1)(2j+1) / (4M))."""
        m = len(u)
        if m == 1:
            return [self.mul(u[0], scale * math.cos(math.pi / 4))]
        h = m // 2
        v = []
        for n in range(h):
            th = -math.pi * (n + 0.25) / m
            v.append(self.cmul(u[2 * n], u[m - 1 - 2 * n], math.cos(th), math.sin(th)))
        w = self.fft(v)
        y = [None] * m
        for k in range(h):
            th = -math.pi * k / m
            re, im = self.cmul(w[k][0], w[k][1], scale * math.cos(th), scale * math.sin(th))
            y[2 * k] = re
            y[m - 1 - 2 * k] = self.new(f"-{im}")
        return y

    def dct3(self, z):
        """y[n] = sum_k z[k] cos(pi (2n+1) k / (2N))."""
        n = len(z)
        if n == 1:
            return z
        e, o = self.dct3(z[0::2]), self.dct4(z[1::2])
        y = [None] * n
        for i in range(n // 2):
            y[i] = self.add(e[i], o[i])
            y[n - 1 - i] = self.sub(e[i], o[i])
        return y


def function(name: str, doc: str, body) -> str:
    g = Gen()
    ins = [f"v[{i}]" for i in range(32)]
    outs = body(g, ins)
    lines = [doc, f"__device__ __forceinline__ void {name}(float (&v)[32]) {{", *g.lines]
    lines += [f"  v[{i}] = {o};" for i, o in enumerate(outs)]
    lines.append("}")
    return "\n".join(lines)


def even(g: Gen, x):
    z = [g.mul(x[0], A0)] + [g.mul(x[m], A1) for m in range(1, 32)]
    return g.dct3(z)


def odd(g: Gen, x):
    return g.dct4(x, A1)


def header() -> str:
    return "\n\n".join([
        "// Generated by tools/gen_idct64.py; do not edit.  The 64-point block IDCT\n"
        "// y = x . D (D[k][i] = a_k cos(pi (2i+1) k / 128)) in two halves of one\n"
        "// row: y[n] = E[n] + O[n] and y[63-n] = E[n] - O[n] for n < 32.\n"
        "#pragma once\n\nnamespace vq {",
        function("idct64_even", "// v[m] = x[2m] in, E[n] out", even),
        function("idct64_odd", "// v[j] = x[2j+1] in, O[n] out", odd),
        "}  // namespace vq\n",
    ])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    text = header()
    if args.check:
        return 0 if OUT.read_text() == text else 1
    OUT.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
