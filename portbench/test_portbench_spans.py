"""The readers of the program's spans on synthetic runs: the submit tail,
the deadline share of the releases, the attention parts' glue, the idle
share inside prefill forwards and the note; and, on a run of a program
without these spans, nothing read and nothing raised."""
import math

import pytest

from portbench.harness import Batch, Req, Run
from portbench.metrics import (_spans, attn_glue_ms_per_ktoken, attn_glue_ms_per_scene,
                               deadline_flush_share, forward_idle_share, submit_block_p95_ms)

GLUE = "void at::native::elementwise_kernel<128, 2>(int, Func)"
HAND = "void (anonymous namespace)::two_stage_attention_kernel<64, true>(Params)"
READERS = (submit_block_p95_ms, deadline_flush_share, attn_glue_ms_per_scene,
           attn_glue_ms_per_ktoken, forward_idle_share)


COPY = "Memcpy DtoH (Device -> Pageable)"


class _Launch:
    def __init__(self, kernel):
        self.kernel = kernel


@pytest.fixture(autouse=True)
def counter(monkeypatch):
    """The counter expects the hand-written launches ``counter.want``
    (default: one two-stage attention launch per attention part)."""
    class Driver:
        want = None

        def launches(self, run, bt):
            n = self.want if self.want is not None else len(
                [k for k in run.profile["kernels"] if k[0] == HAND and bt.t0 <= k[1] <= bt.t1])
            return [_Launch("two_stage_attention")] * n

    d = Driver()
    monkeypatch.setattr(_spans, "driver", lambda run: d)
    return d


def _run(driver="vggt", events=(), kernels=(), window=(2.0, 4.0), batches=()):
    r = Run(cell="c", config={"driver": driver}, traffic={}, seed=1, window_s=4.0, trace=True)
    r.events, r.batches = list(events), list(batches)
    r.profile = {"window": window, "kernels": sorted(kernels, key=lambda k: k[1])}
    return r


def _call(phase, cid, t0, t1, model_parts, **labels):
    """A call span [t0, t1] and its children: assemble, a model span over
    the middle with ``model_parts`` (absolute device intervals), readback;
    each child's device interval equal to its host interval.  The trace's
    copy of the readback ends with it: ``(COPY, t1 - 0.005, t1)``."""
    mid0, mid1 = t0 + 0.1 * (t1 - t0), t0 + 0.9 * (t1 - t0)

    def child(i, name, a, b, **kw):
        return dict(phase=name, t=b, dur_s=b - a, id=cid + i, parent=cid, dev_start_s=a - b,
                    dev_end_s=0.0, **kw)

    parts = [[n, lb, a - mid1, b - mid1] for n, lb, a, b in model_parts]
    return [child(1, "assemble", t0, mid0), child(2, "model", mid0, mid1, parts=parts),
            child(3, "readback", mid1, t1),
            dict(phase=phase, t=t1, dur_s=t1 - t0, id=cid, dev_start_s=t0 - t1, dev_end_s=0.0,
                 **labels)]


def test_submit_tail_and_deadline_share():
    subs = [dict(phase="submit", t=0.1 * i + d, dur_s=d, req=f"r{i}")
            for i, d in enumerate([0.01] * 18 + [0.5, 0.9])]
    late = dict(phase="submit", t=3.5, dur_s=2.0)  # began at 1.5 s, before the sub-window
    after = dict(phase="submit", t=3.9, dur_s=0.1)  # began inside the sub-window: not read
    r = _run(events=subs + [late, after])
    assert math.isclose(submit_block_p95_ms.read(r), 900.0)
    flushes = [dict(phase="flush", t=t, reason=why, rows=1, wait_s=0.1, loop=True)
               for t, why in ((0.5, "deadline"), (1.0, "full"), (1.5, "deadline"),
                              (2.0, "deadline"), (-1.0, "sync"), (5.0, "drain"))]
    assert deadline_flush_share.read(_run(events=flushes)) == 75.0


def test_attention_glue_per_scene_and_note():
    att = [("attn", {"kind": "frame", "pair": 0}, 2.20, 2.30),
           ("attn", {"kind": "global", "pair": 0}, 2.50, 2.60)]
    ffn = [("ffn", {"kind": "frame", "pair": 0}, 2.35, 2.45)]
    evs = _call("vggt.call", 10, 2.0, 3.0, att + ffn + [("heads", {}, 2.7, 2.8)], scenes=2)
    evs += _call("vggt.call", 20, 1.0, 1.9, att, scenes=4)  # before the sub-window
    evs += [dict(phase="admit", t=2.01, request="r1", parent=10),  # events, not spans
            dict(phase="forward", t=2.9, dur_s=0.8, request="r1", parent=10)]
    kernels = [(GLUE, 2.21, 2.25), (HAND, 2.25, 2.29), (GLUE, 2.55, 2.58),  # attention
               (GLUE, 2.36, 2.40), (HAND, 2.40, 2.44),  # FFN
               (GLUE, 2.71, 2.75), (GLUE, 2.05, 2.06), (GLUE, 2.95, 2.96),  # heads, assemble, read
               (COPY, 2.995, 3.0)]
    r = _run(events=evs, kernels=kernels, batches=[Batch(t0=2.0, t1=3.0, real=2, batch=2)])
    assert math.isclose(attn_glue_ms_per_scene.read(r), (40 + 30) / 2, rel_tol=1e-9)
    (text,) = r.notes
    assert text.startswith("spans: 1 of 1 engine calls") and "0 of 16 span edges deeper" in text
    assert "attention 70.0, FFN 40.0, other 65.0" in text
    assert "sum 175.0, the harness's for the same calls 175.0" in text
    assert ("held by the children's device intervals 9, by the calls' 9, attributed by the "
            "harness 9 (the same kernels in 1 and 1 of 1 calls)") in text
    # idle inside the call by innermost span: assemble 0.09 of 0.1, readback 0.085 of 0.1
    assert "readback 85.0" in text and "assemble 90.0" in text and "left out" not in text


def test_prefill_attention_glue_per_ktoken_and_forward_idle():
    parts = [("mixer", {"kind": "attn"}, 2.20, 2.30), ("ffn", {"kind": "dense"}, 2.30, 2.40),
             ("mixer", {"kind": "attn"}, 2.40, 2.50), ("lm_head", {}, 2.80, 2.85)]
    evs = _call("prefill.call", 1, 2.0, 3.0, parts, rows=2, tokens=500)
    kernels = [(GLUE, 2.201, 2.26), (GLUE, 2.45, 2.47), (GLUE, 2.31, 2.39), (GLUE, 2.60, 2.799),
               (COPY, 2.995, 3.0)]
    r = _run("lm", evs, kernels, batches=[Batch(t0=2.0, t1=3.0, real=2, batch=2, length=256)])
    assert math.isclose(attn_glue_ms_per_ktoken.read(r), 79.0 / 0.5, rel_tol=1e-9)
    busy = 0.059 + 0.02 + 0.08 + 0.199  # inside the model's host interval [2.1, 2.9]
    assert math.isclose(forward_idle_share.read(r), 100.0 * (0.8 - busy) / 0.8, rel_tol=1e-9)
    assert _spans.calls(_run("vggt", evs, kernels)) == []  # a VGGT run reads its own calls


def test_a_run_without_the_spans_reads_nothing():
    parent = [dict(phase="admit", t=1.0, request="r1"), dict(phase="complete", t=2.0,
                                                              request="r1", dur_s=1.0)]
    for driver in ("vggt", "lm"):
        for r in (_run(driver, parent, [(GLUE, 2.1, 2.2)]), _run(driver),
                  _run(driver, window=None)):
            r.requests = [Req(index=0, sent=0.5, done=2.0, ok=True, req_id="r1")]
            assert [m.read(r) for m in READERS] == [None] * len(READERS)
            assert r.notes == []


@pytest.mark.parametrize("cell,metrics", [
    ("vggt1b-s8-poisson", {"submit_block_p95_ms.s8", "deadline_flush_share.s8",
                           "attn_glue_ms_per_scene.s8"}),
    ("phi3mini-w4a8-score", {"submit_block_p95_ms.score", "attn_glue_ms_per_ktoken.score",
                             "forward_idle_share.score"}),
    ("vggt1b-s32-backlog", {"attn_glue_ms_per_scene.s32"})])
def test_the_manifest_names_each_reader_in_its_cells(cell, metrics):
    from portbench import harness

    man = harness.manifest()
    named = {m["name"] for m in harness.cell_metrics(man, cell, True)}
    assert metrics <= named
    for m in metrics:
        assert callable(harness.reader(m))


def _two_calls(early_s=3.1e-3, drift=40e-6, move=None):
    """Two VGGT calls, [2.1, 2.6] and [3.0, 3.5] s on the spans' clock,
    each model a run of back-to-back kernels of uneven lengths 2 us apart
    with an attention part over kernels 10-40, and a trace that reads
    ``early_s`` early and drifts ``drift`` a second (or is ``move``d);
    (run, true kernels, true attention glue)."""
    evs, true_ks, want = [], [], 0.0
    for cid, (t0, t1) in ((10, (2.1, 2.6)), (20, (3.0, 3.5))):
        t, ks = t0 + 0.06, []
        for i in range(180):
            d = 2e-3 + 1e-6 * ((i * 7919) % 61)
            ks.append((GLUE if i % 3 else HAND, t, t + d))
            t += d + 2e-6
        att = [("attn", {"kind": "frame", "pair": 0}, ks[10][1] - 1e-6, ks[40][2] + 1e-6)]
        want += _spans.glue(ks[10:41])
        true_ks += ks + [(COPY, t1 - 3e-3, t1 - 1e-5)]
        evs += _call("vggt.call", cid, t0, t1, att, scenes=1)

    move = move or (lambda x: x - early_s - drift * (x - 2.5))

    ks = [(n, move(a), move(b)) for n, a, b in true_ks]
    batches = [Batch(t0=a, t1=b, real=1, batch=1) for a, b in ((2.1, 2.6), (3.0, 3.5))]
    return _run(events=evs, kernels=ks, window=(2.0, 4.0), batches=batches), true_ks, want


def test_the_readback_copies_put_the_trace_on_the_spans_clock():
    """A trace 3.1 ms early that drifts 40 us a second is moved back, by
    each call's readback copy and the one before it, to within 10 us (the
    copies end 10 us before their spans), and the attention glue is read as
    if it were aligned."""
    r, true_ks, want = _two_calls()
    got, left = _spans.placed(r)
    assert len(got) == 2 and not left
    for p in got.values():
        mine = [k for k in true_ks if p.call["t"] - p.call["dur_s"] <= k[1] <= p.call["t"]]
        moved = p.starting_in([_spans.device(p.call)])
        assert len(moved) == len(mine)
        assert max(abs(a[1] - b[1]) for a, b in zip(moved, mine)) < 11e-6
        assert (p.inside, p.edges) == (0, 10)
    assert math.isclose(attn_glue_ms_per_scene.read(r), 1e3 * want / 2, rel_tol=1e-3)
    assert "2 of 2 engine calls" in r.notes[-1] and "0 of 20 span edges deeper" in r.notes[-1]


def test_a_call_without_its_copy_or_its_launches_is_left_out(counter):
    """A call whose readback copy the trace lacks, or whose model span holds
    fewer hand-written launches than the counter expects, is left out; the
    readers read nothing from it and the note counts it."""
    r, _, _ = _two_calls()
    r.profile["kernels"] = [k for k in r.profile["kernels"] if k[0] != COPY or k[1] > 3.0]
    got, left = _spans.placed(r)
    assert len(got) == 1 and left == {"no readback copy in the trace": 1}
    counter.want = 1000
    r, _, _ = _two_calls()
    assert attn_glue_ms_per_scene.read(r) is None
    assert r.notes == ["spans: 0 of 2 engine calls of the profiled sub-window placed on the "
                       "spans' clock by their readback copies (shift +0.0..+0.0 us, drift "
                       "+0.0..+0.0 us/s; 0 of 0 span edges deeper than 0.2 ms inside an "
                       "activity); left out, launches the trace did not hold as the counter "
                       "expects: 2"]


def test_a_wrong_fit_shows_as_edges_inside_activities():
    """Moved 1 ms off, the span edges fall deep inside the kernels, and the
    check counts them."""
    r, _, _ = _two_calls()
    for p in _spans.placed(r)[0].values():
        x1, shift, drift = p.line
        off = _spans.Placed(p.call, p.kids, list(p.of), (x1, shift + 1e-3, drift))
        assert off.edges == 10 and off.inside >= 4


def test_a_drift_that_changes_inside_a_call_leaves_it_out():
    """A trace whose drift jumps by -2000 us a second in the middle of the
    second call: no line through the readback copies places that call, so
    it is left out; the first, between an earlier readback and its own,
    is read."""
    def move(x):
        return x - 3.1e-3 - 40e-6 * (x - 2.5) - 2000e-6 * max(0.0, x - 3.2)

    r, true_ks, _ = _two_calls(move=move)
    r.events.append(dict(phase="readback", t=1.5, dur_s=0.1, id=99, dev_start_s=-0.1,
                         dev_end_s=0.0))
    r.profile["kernels"].insert(0, (COPY, move(1.497), move(1.49999)))
    got, left = _spans.placed(r)
    assert [p.call["id"] for p in got.values()] == [10]
    assert left == {"span edges inside activities": 1}
    want = _spans.glue([k for k in true_ks[10:41]])
    assert math.isclose(attn_glue_ms_per_scene.read(r), 1e3 * want, rel_tol=1e-3)
