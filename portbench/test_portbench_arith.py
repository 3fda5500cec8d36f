"""The yardstick's arithmetic: tails with missing requests, rates, the
open-loop schedule, length draws, the check's sample and the frozen
operation counts."""
import math

from portbench import counts, stats, traffic
from portbench.drivers import common
from portbench.harness import Batch, Req, Run
from portbench.metrics import scene_p95_ms, scenes_per_s, tokens_per_s


def _run(reqs, T=10.0, batches=()):
    r = Run(cell="c", config={}, traffic={}, seed=1, window_s=T, trace=False)
    r.requests, r.batches = list(reqs), list(batches)
    return r


def test_failed_request_counts_as_missing_in_the_tail():
    reqs = [Req(index=i, due=i * 0.1, done=i * 0.1 + 0.2, ok=True) for i in range(19)]
    assert math.isclose(scene_p95_ms.read(_run(reqs)), 200.0, rel_tol=1e-9)
    reqs.append(Req(index=19, due=1.9, done=2.0, ok=False, error="NumericFault"))
    assert math.isclose(scene_p95_ms.read(_run(reqs)), 200.0)  # 1 of 20 missing: p95 is the 19th
    reqs.append(Req(index=20, due=2.0, done=None, ok=False))
    assert scene_p95_ms.read(_run(reqs)) == stats.MISSING_MS


def test_stalled_window_moves_the_tail():
    steady = [Req(index=i, due=i * 0.1, done=i * 0.1 + 0.2, ok=True) for i in range(40)]
    stalled = [Req(index=i, due=i * 0.1, done=max(i * 0.1, 2.5) + 0.2, ok=True)
               for i in range(40)]  # nothing served between 1.0 s and 2.5 s
    assert scene_p95_ms.read(_run(stalled)) > 5 * scene_p95_ms.read(_run(steady))


def test_rates_take_all_the_work_and_all_the_window():
    reqs = [Req(index=i, sent=0.0, done=d, ok=True, prompt_len=100, new_tokens=1)
            for i, d in enumerate((1.0, 4.0, 9.0, 11.0))]
    assert tokens_per_s.read(_run(reqs)) == 3 * 101 / 10.0
    calls = [Batch(t0=0.0, t1=4.0, real=2, batch=2), Batch(t0=4.0, t1=8.0, real=2, batch=2),
             Batch(t0=8.0, t1=12.0, real=2, batch=2)]
    assert math.isclose(scenes_per_s.read(_run([], batches=calls)), (2 + 2 + 1) / 10.0)


def test_open_loop_schedule_is_the_seeds_and_keeps_its_work():
    a = traffic.open_loop_times(4.0, 50.0, 2**31 + 11)
    assert a == traffic.open_loop_times(4.0, 50.0, 2**31 + 11)
    b = traffic.open_loop_times(4.0, 50.0, 7)
    assert a != b and len(a) == len(b) == 200
    assert all(0 < t < 50.0 for t in a) and a == sorted(a)

    def gaps(t):
        return sorted(x - y for x, y in zip(t, [0.0] + t[:-1]))

    assert all(math.isclose(x, y, rel_tol=1e-9) for x, y in zip(gaps(a), gaps(b)))
    assert 0.24 < sum(gaps(a)) / len(a) < 0.26


def test_the_check_sample_takes_every_row_of_a_batch():
    reqs = [Req(index=i, ok=i != 5) for i in range(40)]
    for seed in (1, 2**31 + 11, 2**33 + 3):
        pair = common.sample(reqs, 2, seed, slot=lambda r: r.index % 2)
        assert len(pair) == 2 and {r.index % 2 for r in pair} == {0, 1}
        picks = common.sample(reqs, 6, seed, longest=lambda r: r.index,
                              slot=lambda r: r.index % 4)
        assert len(picks) == 6 and picks[-1].index == 39
        assert {r.index % 4 for r in picks} == {0, 1, 2, 3} and all(r.ok for r in picks)
        assert picks == common.sample(reqs, 6, seed, longest=lambda r: r.index,
                                      slot=lambda r: r.index % 4)


def test_lengths_are_one_multiset_in_each_seeds_order():
    spec = {"dist": "lognormal", "median": 1024, "sigma": 0.5, "min": 256, "max": 2048}
    a, b = traffic.lengths(spec, 384, 1), traffic.lengths(spec, 384, 2)
    assert a != b and sorted(a) == sorted(b)
    assert min(a) >= 256 and max(a) == 2048 and sorted(a)[192] in range(990, 1060)
    assert sorted(a[:64]) == sorted(b[64:128])  # every block of 64 is one multiset


def test_global_attention_count_by_hand():
    n = 8 * 1041  # S = 8 frames of 5 special tokens + 1036 patches
    cfg = {"n_layers": 24, "d_model": 1024, "n_heads": 16, "d_ff": 4096, "n_special_tokens": 5}
    glob = [l for l in counts.vggt_launches(cfg, 1, 8, 1036)
            if l.kernel == "two_stage_attention"][1::2]
    assert len(glob) == 24
    g = glob[0]
    assert g.transcendentals == 16 * n * n  # B * H * N^2 exponentials
    assert g.int8_ops == 4 * n * n * 1024  # 4 N^2 d
    assert g.bytes == 16 * n * 68 + 16 * n * 132 + 64 + 16 * n * 256
    assert g.bound_s() == g.transcendentals / counts.PEAK_TRANSCENDENTALS  # exponential-bound


def test_phi3_projection_count_by_hand():
    cfg = {"n_layers": 32, "d_model": 3072, "n_heads": 32, "n_kv_heads": 32, "head_dim": 96,
           "d_ff": 8192, "vocab_size": 32064}
    w_up = counts.lm_launches(cfg, 4, 1024)[5]  # layer 0's w_up at a 4 x 1024 wave
    m = 4096
    assert w_up.int8_ops == 2 * m * 3072 * 8192
    assert w_up.bytes == m * 3072 + 4 * m + 1536 * 8192 + 4 * 8192 + 4 * m * 8192
    assert len(counts.lm_launches(cfg, 4, 1024)) == 7 * 32
    per_token = counts.lm_model_ops(cfg, 1) - 2.0 * 96 * 2 * 32 * 32
    assert 7.4e9 < per_token < 7.5e9

