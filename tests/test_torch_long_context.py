"""``examples/torch_long_context.py`` (the port of ``examples/long_context.py``)
against the JAX package: at each context, the cache the port holds after
a prefill and two decode steps has the bytes of the reference's
``lm.init_cache`` at that context, computed here; rwkv6's bytes are the
same at every context; jamba's int8 K/V take half the bytes of bf16 ones.
The reference's cache also holds its write positions as int32 device
scalars (``pos`` and each KV cache's ``length``), which the port keeps as
host ints: they are left out of the reference's count."""
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import lm
from torch_dist import ROOT
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

sys.path.insert(0, str(ROOT / "examples"))
import torch_long_context as ex  # noqa: E402


def _reference_bytes(arch: str, ctx: int) -> int:
    cache = jax.eval_shape(lambda: jlm.init_cache(j_get_config(arch), 1, ctx))
    flat, _ = jax.tree_util.tree_flatten_with_path(cache)
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize for p, x in flat
               if getattr(p[-1], "key", getattr(p[-1], "name", None)) not in ("pos", "length"))


@pytest.mark.parametrize("arch", ex.ARCHS)
def test_cache_bytes_equal_the_reference_at_each_context(arch, monkeypatch):
    cfg = get_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    # the bytes depend on neither the prompt's length nor the number of
    # decode steps: 8 tokens and 1 step, not 64 and 16, for the test's time
    monkeypatch.setattr(ex, "PROMPT", 8)
    monkeypatch.setattr(ex, "DECODE", 1)
    got = {}
    for ctx in ex.CONTEXTS:
        ms, got[ctx] = ex.measure(cfg, params, ctx, "cpu")
        assert got[ctx] == _reference_bytes(arch, ctx), ctx
        assert ms > 0
    if "attn" not in cfg.pattern:  # the O(1) state
        assert len(set(got.values())) == 1, got
    else:
        assert got[128] < got[512] < got[2048]


def test_jamba_int8_kv_takes_half_the_bytes_of_bf16():
    cfg = get_config("jamba-v0.1-52b-smoke")
    for ctx in ex.CONTEXTS:
        assert 2 * ex.kv_bytes(cfg, ctx, torch.int8) == ex.kv_bytes(cfg, ctx, torch.bfloat16)
    assert ex.kv_bytes(get_config("rwkv6-1.6b-smoke"), 128, torch.int8) == 0
