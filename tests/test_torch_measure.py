"""The on-card measurement helpers, on the CPU: the two-stage attention
inputs they build and the count of int8 probabilities that differ."""
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


def test_pq_flips_counts_changed_probabilities():
    args, _, _ = _inputs(1, 2, 2, 70, 32, seed=1)
    assert pq_flips(args) == (0, 70 * 70)

    def one_off(*a):  # head 1, row 3, column 8 reads pq[3, 32 + 8]
        out = tsa.two_stage_attention_plain(*a)
        out[1, 3, 8] += 1e-2 * out[1, 3, 8].abs() + 1e-3
        return out

    assert pq_flips(args, one_off) == (1, 70 * 70)
