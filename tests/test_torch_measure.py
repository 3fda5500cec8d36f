"""The on-card measurement helpers, on the CPU: the two-stage attention
inputs they build, the count of int8 probabilities that differ, the fused
FFN and fused linear inputs, and the argument parsing, shape tables and
fused_ffn and fused_matmul entry point types of
``tools/time_kernel_sources.py``, and ``tools/rounding_sensitivity.py`` run
with the plain versions."""
import torch

from repro_torch.kernels import two_stage_attention as tsa
from repro_torch.kernels.measure import attention_inputs, pq_flips


def _inputs(b, hq, hkv, length, dh, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return attention_inputs(lambda *s: torch.randn(s, generator=gen), b, hq, hkv, length, dh)


def test_attention_inputs_shapes_and_gqa():
    args, gqa, vscale = _inputs(2, 4, 2, 37, 32)
    qv, qs, kv, ks, vv, vsq = args
    assert qv.shape == (8, 37, 32) and kv.shape == vv.shape == (4, 37, 32)
    assert qv.dtype == kv.dtype == vv.dtype == torch.int8
    assert qs.numel() == 8 * 37 and ks.numel() == 4 * 37
    assert gqa == {"q_heads": 4, "kv_heads": 2}
    assert vscale.shape == (4, 1, 1) and vsq.shape == (8, 1, 1)
    # each query head carries the scale of the K/V head it reads
    assert torch.equal(vsq.view(2, 4), vscale.view(2, 2).repeat_interleave(2, dim=1))
    assert int(vv.abs().max()) <= 127
    out = tsa.two_stage_attention(*args, **gqa)
    assert out.shape == (8, 37, 32) and torch.isfinite(out).all()
    assert _inputs(1, 2, 2, 5, 32)[1] == {}


def test_attention_inputs_take_another_key_length():
    """Lq != Lk (the card's ragged non-causal rows, dh 96 and MQA at dh 256):
    K/V and their scales follow ``lk``; the plain version runs and
    ``pq_flips`` counts Lq x Lk probabilities."""
    gen = torch.Generator().manual_seed(2)
    for hq, hkv, dh in ((2, 2, 96), (8, 1, 256)):
        args, gqa, _ = attention_inputs(lambda *s: torch.randn(s, generator=gen), 1, hq, hkv,
                                        20, dh, lk=45)
        qv, qs, kv, ks, vv, _ = args
        assert qv.shape == (hq, 20, dh) and kv.shape == vv.shape == (hkv, 45, dh)
        assert qs.numel() == hq * 20 and ks.numel() == hkv * 45
        out = tsa.two_stage_attention(*args, **gqa)
        assert out.shape == (hq, 20, dh) and torch.isfinite(out).all()
        assert pq_flips(args) == (0, 20 * 45)


def test_pq_flips_counts_changed_probabilities():
    args, _, _ = _inputs(1, 2, 2, 70, 32, seed=1)
    assert pq_flips(args) == (0, 70 * 70)

    def one_off(*a):  # head 1, row 3, column 8 reads pq[3, 32 + 8]
        out = tsa.two_stage_attention_plain(*a)
        out[1, 3, 8] += 1e-2 * out[1, 3, 8].abs() + 1e-3
        return out

    assert pq_flips(args, one_off) == (1, 70 * 70)


# ---------------------------------------------------------------------------
# tools/time_kernel_sources.py: its pure-Python parts
# ---------------------------------------------------------------------------

import importlib.util  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

from repro_torch.kernels import fused as fz  # noqa: E402
from repro_torch.kernels.measure import ffn_inputs, fused_matmul_inputs  # noqa: E402


def _tool(name="time_kernel_sources"):
    path = Path(__file__).resolve().parents[1] / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tool_parses_kernel_and_sources():
    tool = _tool()
    a = tool.parse_args([])
    assert a.kernel == "two_stage_attention" and a.sources == {} and a.sass is None
    a = tool.parse_args(["--kernel", "fused_ffn", "old=build/x.cu", "v2=y.cu", "--sass", "s.txt"])
    assert a.kernel == "fused_ffn" and list(a.sources) == ["old", "v2"]
    assert a.sources["old"] == Path("build/x.cu").resolve() and a.sass == "s.txt"
    assert not a.split
    a = tool.parse_args(["--kernel", "fused_matmul", "--split", "pr16=build/pr16/fused_matmul.cu"])
    assert a.kernel == "fused_matmul" and a.split and list(a.sources) == ["pr16"]
    a = tool.parse_args(["--kernel", "quant_matmul", "pr18=build/pr18/quant_matmul.cu"])
    assert a.kernel == "quant_matmul" and not a.split and list(a.sources) == ["pr18"]
    assert a.sources["pr18"] == Path("build/pr18/quant_matmul.cu").resolve()
    for kernel in ("norm_quant", "wht"):
        a = tool.parse_args(["--kernel", kernel, f"pr19=build/pr19/{kernel}.cu"])
        assert a.kernel == kernel and not a.split and list(a.sources) == ["pr19"]
        assert a.sources["pr19"] == Path(f"build/pr19/{kernel}.cu").resolve()


@pytest.mark.parametrize("argv", [
    ["noequals"], ["=x.cu"], ["a="], ["committed=x.cu"], ["a=x.cu", "a=y.cu"],
    ["--kernel", "norm"], ["--kernel"], ["--sass"],
    ["--split"], ["--kernel", "fused_ffn", "--split"], ["--kernel", "quant_matmul", "--split"],
    ["--kernel", "quant_matmul", "committed=x.cu"], ["--kernel", "wht", "--split"],
    ["--kernel", "norm_quant", "--split"],
])
def test_tool_rejects_bad_arguments(argv):
    with pytest.raises(SystemExit):
        _tool().parse_args(argv)


def test_tool_shape_tables_are_the_served_shapes():
    tool = _tool()
    m = 2 * 8 * (5 + 1024)
    assert tool.TOKENS == m == 16464
    assert tool.SHAPES["two_stage_attention"] == [("frame", 16, 16, 1029), ("global", 2, 16, 8232)]
    assert tool.SHAPES["fused_ffn"] == [("served", m, 1024, 4096)]
    assert tool.SHAPES["fused_matmul"] == [("wqkv", m, 1024, 3072, "ln"), ("wo", m, 1024, 1024, None)]
    # the unfused plan's W4A8 projections (wq/wk/wv/wo, w_up, w_down) and the W8 check
    assert tool.SHAPES["quant_matmul"] == [("wq", m, 1024, 1024, 4), ("w_up", m, 1024, 4096, 4),
                                           ("w_down", m, 4096, 1024, 4),
                                           ("w8 check", m, 1024, 4096, 8)]
    # the prologue phase's calls: ln + WHT 1024 + A8 at D=1024, the FFN hidden's WHT
    assert tool.SHAPES["norm_quant"] == [("served", m, 1024, "ln", 1024, 8)]
    assert tool.SHAPES["wht"] == [("ffn hidden", m, 4096, 4096)]
    # the split: served, then each part taken out by a launch argument, then both
    assert tool.SPLIT == [("served", True, False), ("idct off", False, False),
                          ("prequant", True, True), ("both off", False, True)]
    assert set(tool.SHAPES) == set(tool.KERNELS)


@pytest.mark.parametrize("earlier", [False, True])
def test_tool_ffn_argtypes(earlier):
    """The present entry point's 32 arguments; the earlier one adds the DCT
    matrix after the packing flags and the row-scale scratch after ``sq``."""
    import ctypes

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    now = [p, p, f, i, i, i] + [p] * 9 + [i] * 8 + [p] * 3 + [i] * 5 + [p]
    want = now[:18] + [p] + now[18:26] + [p] + now[26:] if earlier else now
    assert _tool().ffn_argtypes(earlier) == want and len(want) == 32 + 2 * earlier
    assert _tool().ffn_argtypes(False) == fz._ARGTYPES["fused_ffn"]


@pytest.mark.parametrize("earlier", [False, True])
def test_tool_fused_matmul_argtypes(earlier):
    """The present entry point's 26 arguments; the earlier one (bb9b1b2)
    adds the DCT matrix after the bias and the row-scale scratch after
    ``sq``, as ``kernels/fused.py`` declared it then."""
    import ctypes

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    now = [p, p, p, p, f, i, i, i, p, p, i, p] + [i] * 4 + [p] * 5 + [i] * 4 + [p]
    want = now[:12] + [p] + now[12:20] + [p] + now[20:] if earlier else now
    assert _tool().fm_argtypes(earlier) == want and len(want) == 26 + 2 * earlier
    assert _tool().fm_argtypes(False) == fz._ARGTYPES["fused_matmul"]


def test_tool_quant_matmul_launcher_types():
    """The launcher declares the C entry point every version of the source
    has: five pointers, M, N, K, the packing flag and the stream."""
    import ctypes
    import types

    class Fn:
        argtypes = restype = None

    lib = types.SimpleNamespace(vq_quant_matmul=Fn())
    _tool().qm_launcher(torch, lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    assert lib.vq_quant_matmul.argtypes == [p] * 5 + [i] * 4 + [p]
    assert lib.vq_quant_matmul.restype is ctypes.c_int


def test_tool_row_kernel_argtypes():
    """The wht and norm_quant entry points every version of the sources
    has, as the port's wrappers declare them."""
    import ctypes

    p, i = ctypes.c_void_p, ctypes.c_int
    tool = _tool()
    assert tool.row_argtypes("wht") == [p, p, i, i, i, i, p]
    assert tool.row_argtypes("norm_quant") == fz._ARGTYPES["norm_quant"]


@pytest.mark.parametrize("kernel", ["norm_quant", "wht"])
def test_tool_row_launcher_grid(kernel):
    """A source with ``vq_<kernel>_blocks_per_sm`` gets the wrapper's grid
    (ROW_WARPS rows a block, its resident blocks on every SM); one without
    it gets the earlier wrappers' (8 rows a block, 8 blocks an SM)."""
    import ctypes
    import types

    calls = []

    class Fn:
        argtypes = restype = None

        def __call__(self, *a):
            calls.append(a)
            return 0

    class PerSm(Fn):
        def __call__(self, width, out):
            out._obj.value = 3
            return 0

    class Props:
        multi_processor_count = 132

    fake = types.SimpleNamespace(
        empty=torch.empty, empty_like=torch.empty_like, int8=torch.int8, float32=torch.float32,
        cuda=types.SimpleNamespace(get_device_properties=lambda dev: Props(),
                                   current_stream=lambda: types.SimpleNamespace(cuda_stream=0)))
    x = torch.zeros((20000, 1024))
    args = (x, 1024) if kernel == "wht" else (x, None, "rms", 1024, 8)
    for per_sm, grid in ((PerSm(), min(-(-20000 // fz.ROW_WARPS), 3 * 132)),
                         (None, min(-(-20000 // 8), 8 * 132))):
        lib = types.SimpleNamespace(**{f"vq_{kernel}": Fn()})
        if per_sm is not None:
            setattr(lib, f"vq_{kernel}_blocks_per_sm", per_sm)
        _tool().row_launcher(fake, lib, kernel)(*args)
        assert calls[-1][-2] == grid and getattr(lib, f"vq_{kernel}").restype is ctypes.c_int


def test_fused_matmul_inputs_build_a_served_style_call():
    gen = torch.Generator().manual_seed(0)
    for norm in ("ln", None):
        args, kw = fused_matmul_inputs(lambda *s: torch.randn(s, generator=gen), 7, 128, 192,
                                       norm=norm)
        x, wv, ws, xs, bias, u = args
        assert x.shape == (7, 128) and wv.shape == (64, 192) and wv.dtype == torch.uint8
        assert ws.shape == (1, 192) and xs is None and bias.shape == (192,)
        assert (u is not None) == (norm == "ln") and kw == dict(
            packed=True, a_bits=8, norm_kind=norm, dct_block=64)
        out = fz.fused_matmul(*args, **kw)
        assert out.shape == (7, 192) and torch.isfinite(out).all()


def test_ffn_inputs_build_a_served_style_call():
    gen = torch.Generator().manual_seed(0)
    args, kw = ffn_inputs(lambda *s: torch.randn(s, generator=gen), 5, 64, 256)
    x, wu, wus, wd, wds, wg, wgs, bg, bu, bd, u = args
    assert x.shape == (5, 64) and wu.shape == (32, 256) and wu.dtype == torch.uint8
    assert wd.shape == (128, 64) and wus.shape == (1, 256) and wds.shape == (1, 64)
    assert wg is None and wgs is None and bg is None and bu.shape == (256,) and u.shape == (64,)
    assert kw["mid_wht_block"] == 256 and kw["dct_block"] == 64 and kw["act"] == "gelu"
    out = fz.fused_ffn(*args, **kw)
    assert out.shape == (5, 64) and torch.isfinite(out).all()
    args, kw = ffn_inputs(lambda *s: torch.randn(s, generator=gen), 3, 64, 2816, w_bits=8,
                          a_bits=4, gated=True, norm="rms", pro_wht=True)
    assert args[5].dtype == torch.int8 and args[10] is None and kw["pro_wht_block"] == 64
    assert kw["mid_wht_block"] == 256 and kw["act"] == "silu" and kw["a_bits_mid"] == 4
    out = fz.fused_ffn(*args, **kw)
    assert out.shape == (3, 64) and torch.isfinite(out).all()


def test_rounding_sensitivity_on_the_cpu():
    """On the CPU every fused call is its plain version: each call and the
    served forward read 0; a perturbed forward reads finite numbers."""
    import math

    tool = _tool("rounding_sensitivity")
    a = tool.parse_args([])
    assert a.trials == 8 and a.noise == 1e-7
    r = tool.run(trials=1, noise=1e-7)
    assert r["device"] == "cpu"
    assert [n for n, _ in r["calls"]] == ["fused_matmul", "fused_matmul", "fused_ffn"] * 4
    assert all(rel == 0 for _, rel in r["calls"]) and set(r["served"].values()) == {0.0}
    assert len(r["perturbed"]) == 1 and all(math.isfinite(v) for v in r["perturbed"][0].values())
