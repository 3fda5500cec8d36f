"""The port's spans (``repro_torch.obs.trace``): ids and parents across
threads, device intervals as offsets from ``t``, nothing recorded with
the tracer off, bit-equal model outputs either way, the compact model
parts, every ``flush`` reason, the ``submit`` -> ``lock_wait`` chain, and
a request's chain kept in the default ring across traced engine calls."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import lm, vggt
from repro_torch.obs import trace
from repro_torch.serving.batching import FLUSH_REASONS
from repro_torch.serving.engine import Engine
from repro_torch.serving.server import AsyncServer
from repro_torch.serving.vggt_engine import VGGTEngine
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

VGGT_KW = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128)
LM_KW = dict(n_layers=2)


@pytest.fixture
def tracer():
    prev = trace.install(trace.Tracer())
    try:
        yield trace.current()
    finally:
        trace.install(prev)


def _vggt():
    cfg = get_config("vggt-1b-smoke").with_(**VGGT_KW)
    return cfg, vggt.init_params(cfg, torch.Generator().manual_seed(0))


def _lm():
    cfg = get_config("qwen3-14b-smoke").with_(**LM_KW)
    return cfg, lm.init_params(cfg, torch.Generator().manual_seed(0))


def _scenes(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 2, 8, VGGT_KW["d_model"]), generator=g)


def _prompt(n, seed=0, vocab=None):
    return np.random.default_rng(seed).integers(0, vocab or _lm()[0].vocab_size, n)


def _by(tr, phase):
    return [e for e in tr.recent() if e.phase == phase]


def test_ids_parents_and_nesting_across_threads(tracer):
    barrier = threading.Barrier(2)

    def work(tag):
        with trace.span("outer", who=tag):
            barrier.wait(timeout=10)
            with trace.span("inner", who=tag):
                trace.emit("mark", request=tag)
            barrier.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    evs = tracer.recent()
    ids = [e.id for e in evs if e.id is not None]
    assert len(ids) == len(set(ids)) == 4
    for tag in ("t0", "t1"):
        (outer,) = [e for e in evs if e.phase == "outer" and e.labels["who"] == tag]
        (inner,) = [e for e in evs if e.phase == "inner" and e.labels["who"] == tag]
        (mark,) = [e for e in evs if e.phase == "mark" and e.request == tag]
        assert outer.parent is None and inner.parent == outer.id and mark.parent == inner.id
        assert mark.id is None  # an emitted event is no span
        assert outer.t - outer.dur_s <= inner.t - inner.dur_s <= inner.t <= outer.t
        d = inner.to_dict()
        assert (d["id"], d["parent"]) == (inner.id, outer.id) and "id" not in mark.to_dict()
    assert trace._stack() == []


class _Clock:
    """A fake device: events stamped on a clock 1000 s off the host's,
    each synchronize counted."""

    syncs = made = 0

    def __init__(self):
        self.t = None
        _Clock.made += 1

    def record(self):
        self.t = time.perf_counter() + 1000.0

    def query(self):
        return True

    def synchronize(self):
        _Clock.syncs += 1

    def elapsed_time(self, other):  # ms, as torch.cuda.Event
        return (other.t - self.t) * 1e3


def test_device_intervals_are_offsets_from_t_and_anchors_wait_for_nothing(tracer):
    tracer._cuda, tracer._new_event = True, _Clock
    _Clock.syncs = _Clock.made = 0
    with trace.span("model", parts=True):
        time.sleep(0.01)
        with trace.part("attn", kind="frame", pair=0):
            time.sleep(0.01)
        trace.anchor()
    with trace.span("readback"):
        time.sleep(0.005)
    trace.anchor()
    assert _Clock.syncs == 0  # an engine call's anchor never waits
    with trace.span("late"):  # no anchor after it: the reader drains the stream, anchors it
        pass
    model, readback, late = tracer.recent()
    for ev in (model, readback, late):
        assert ev.dev_start_s == pytest.approx(-ev.dur_s, abs=2e-4)
        assert ev.dev_end_s == pytest.approx(0.0, abs=2e-4)
    (attn,) = model.parts
    assert (attn[0], attn[1]) == ("attn", {"kind": "frame", "pair": 0})
    assert -model.dur_s < attn[2] < attn[3] < 0
    assert attn[3] - attn[2] == pytest.approx(0.01, abs=5e-3)
    assert model.to_dict()["parts"] == [list(p) for p in model.parts]
    assert _Clock.syncs == 2 and tracer._pending == [] and tracer._anchors == []
    assert len(tracer._free) == _Clock.made - 3 < 2 * 4 + 2  # every mark back in the pool


def test_a_late_record_does_not_move_the_intervals(tracer):
    """A thread switch between an anchor's host time and its record (here:
    5 ms) loosens only that anchor's bound: the anchors around it keep
    the intervals it resolves within 0.2 ms."""
    tracer._cuda, tracer._new_event = True, _Clock
    late = [False]
    record = _Clock.record

    def slow(self):
        if late[0]:
            time.sleep(0.005)
        record(self)

    _Clock.record = slow
    try:
        for i in range(3):
            with trace.span("call", i=i):
                time.sleep(0.002)
            late[0] = i == 1
            trace.anchor()
            late[0] = False
        evs = tracer.recent()
    finally:
        _Clock.record = record
    for ev in evs:
        assert ev.dev_start_s == pytest.approx(-ev.dur_s, abs=2e-4)
        assert ev.dev_end_s == pytest.approx(0.0, abs=2e-4)


def test_unanchored_events_still_reach_the_jsonl_mirror(tmp_path):
    """With no anchor ever (a CPU engine on a CUDA machine), the oldest
    pending events give up their device interval and are written all the
    same; the rest are written once a reader anchors them."""
    path = tmp_path / "trace.jsonl"
    tr = trace.Tracer(capacity=8, jsonl_path=str(path))
    tr._cuda, tr._new_event = True, _Clock
    prev = trace.install(tr)
    try:
        for i in range(20):
            with trace.span("call", i=i):
                pass
        tr.close()
    finally:
        trace.install(prev)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert sorted(d["i"] for d in lines) == list(range(20))
    dropped = [d for d in lines if "dev_start_s" not in d]
    assert 0 < len(dropped) < 20 and {d["i"] for d in dropped} == set(range(len(dropped)))


def test_a_reader_waits_for_the_device_without_the_lock(tracer):
    """While ``recent()`` waits for the stream, an engine thread's spans
    and events go on being recorded."""
    tracer._cuda, tracer._new_event = True, _Clock
    gate, waiting = threading.Event(), threading.Event()
    sync = _Clock.synchronize

    def slow(self):
        waiting.set()
        assert gate.wait(timeout=10)

    with trace.span("call"):
        pass
    _Clock.synchronize = slow
    try:
        reader = threading.Thread(target=tracer.recent)
        reader.start()
        assert waiting.wait(timeout=10)
        engine = threading.Thread(target=lambda: [trace.emit("flush", reason="full"),
                                                  trace.span("call").__enter__().__exit__()])
        engine.start()
        engine.join(timeout=5)
        assert not engine.is_alive()  # recorded while the reader still waits
    finally:
        gate.set()
        reader.join(timeout=10)
        _Clock.synchronize = sync
    assert [e.phase for e in tracer.recent()] == ["call", "flush", "call"]


def test_off_records_nothing_and_touches_no_device(monkeypatch):
    prev = trace.uninstall()

    def refuse(*a, **k):
        raise AssertionError("called with the tracer off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    try:
        with trace.span("model", parts=True, bucket="b") as sp:
            assert sp is None
            with trace.part("attn", kind="frame"):
                pass
        assert trace.emit("flush", reason="full") is None
        trace.anchor()
        cfg, params = _vggt()
        vggt.forward(cfg, params, _scenes(1))
    finally:
        trace.install(prev)
    assert trace._stack() == []


def test_forwards_bit_equal_with_tracer_on_and_parts_recorded():
    vcfg, vp = _vggt()
    lcfg, lp = _lm()
    x = _scenes(2)
    toks = torch.as_tensor(_prompt((2, 12), vocab=lcfg.vocab_size))
    prev = trace.uninstall()
    try:
        want_v = vggt.forward(vcfg, vp, x)
        want_l = lm.forward(lcfg, lp, toks)[0]
        tr = trace.Tracer()
        trace.install(tr)
        with trace.span("model", parts=True):
            got_v = vggt.forward(vcfg, vp, x)
        with trace.span("model", parts=True):
            got_l = lm.forward(lcfg, lp, toks)[0]
    finally:
        trace.install(prev)
    for k in want_v:
        assert torch.equal(got_v[k], want_v[k]), k
    assert torch.equal(got_l, want_l)
    ev_v, ev_l = tr.recent()
    names = [(p[0], p[1].get("kind"), p[1].get("pair")) for p in ev_v.parts]
    want = []
    for gi in range(VGGT_KW["n_layers"]):
        for kind in ("frame", "global"):
            want += [("attn", kind, gi), ("ffn", kind, gi)]
    assert names == want + [("heads", None, None)]
    assert [(p[0], p[1]) for p in ev_l.parts] == (
        [("mixer", {"kind": "attn"}), ("ffn", {"kind": "dense"})] * LM_KW["n_layers"]
        + [("lm_head", {})])
    assert all(p[2] is None and p[3] is None for p in ev_v.parts + ev_l.parts)  # no CUDA here


def _reasons(tr):
    return [(e.labels["reason"], e.labels["rows"], e.labels["loop"]) for e in _by(tr, "flush")]


def test_every_flush_reason_of_the_vggt_engine(tracer):
    cfg, params = _vggt()
    eng = VGGTEngine(cfg, params, device="cpu", max_batch=2, max_wait_s=0.01)
    eng.infer(_scenes(1))  # sync
    eng.enqueue(_scenes(1))
    eng.enqueue(_scenes(1, 1))  # full
    eng.enqueue(_scenes(1, 2))
    eng.flush()  # drain
    eng.enqueue(_scenes(1, 3))
    time.sleep(0.02)
    assert eng.poll() == 1  # deadline
    got = _reasons(tracer)
    assert got == [("sync", 1, False), ("full", 2, False), ("drain", 1, False),
                   ("deadline", 1, False)]
    waits = [e.labels["wait_s"] for e in _by(tracer, "flush")]
    assert waits[3] >= 0.01 and all(w >= 0 for w in waits)
    calls = _by(tracer, "vggt.call")
    assert [c.labels["scenes"] for c in calls] == [1, 2, 1, 1]
    kids = {c.id: [] for c in calls}
    for e in tracer.recent():
        if e.parent in kids and e.id is not None:
            kids[e.parent].append(e.phase)
    assert all(v == ["assemble", "model", "readback", "deliver"] for v in kids.values())
    fwd = {e.request: e.parent for e in _by(tracer, "forward")}
    assert set(fwd.values()) == set(kids)  # the per-request events hang off their call


def test_every_flush_reason_of_the_lm_scheduler(tracer):
    cfg, params = _lm()
    eng = Engine(cfg, params, device="cpu", max_len=64, max_batch=2, max_wait_s=0.2)
    eng.generate(_prompt((1, 8)), n_steps=1)  # sync
    eng.enqueue(_prompt(8, 1), 1)
    eng.enqueue(_prompt(8, 2), 1)  # full
    eng.enqueue(_prompt(8, 3), 1, deadline_s=60.0)
    eng.poll()  # sla
    eng.enqueue(_prompt(8, 4), 40)
    eng.flush()  # drain
    eng.enqueue(_prompt(8, 5), 40)
    time.sleep(0.25)
    eng.poll()  # deadline: the runner holds the request for 39 more steps
    eng.enqueue(_prompt(8, 6), 2)
    eng.poll()  # join the running batch
    eng.flush()
    got = [r for r, _, _ in _reasons(tracer)]
    assert got == ["sync", "full", "sla", "drain", "deadline", "join"]
    assert set(got) == set(FLUSH_REASONS)
    calls = _by(tracer, "prefill.call")
    assert [(c.labels["rows"], c.labels["tokens"]) for c in calls] == [
        (1, 8), (2, 16), (1, 8), (1, 8), (1, 8), (1, 8)]
    kids = [e.phase for e in tracer.recent() if e.parent == calls[0].id and e.id is not None]
    assert kids == ["assemble", "init_cache", "model", "readback"]
    assert _by(tracer, "decode_burst") and all(
        e.labels["steps"] > 0 for e in _by(tracer, "decode_burst"))


def test_submit_waits_for_the_lock_and_runs_its_auto_flush(tracer):
    cfg, params = _vggt()
    eng = VGGTEngine(cfg, params, device="cpu", max_batch=2, max_wait_s=3600.0)
    with AsyncServer(eng) as srv:
        a = srv.submit(_scenes(1))
        with srv._lock:  # the loop's hold: the next submit waits for it
            t = threading.Thread(target=lambda: srv.submit(_scenes(1, 1)))
            t.start()
            time.sleep(0.05)
        t.join(timeout=60)
        assert not t.is_alive()
        srv.result(a, timeout=60)
    evs = tracer.recent()
    subs = [e for e in evs if e.phase == "submit"]
    assert len(subs) == 2 and subs[0].labels["req"] == a.req_id
    waits = {e.parent: e for e in evs if e.phase == "lock_wait"}
    assert {s.id for s in subs} <= set(waits)
    assert waits[subs[1].id].dur_s >= 0.04  # blocked behind the held lock
    (call,) = [e for e in evs if e.phase == "vggt.call"]
    (flush,) = [e for e in evs if e.phase == "flush"]
    assert call.parent == subs[1].id and flush.parent == subs[1].id  # ran in the caller
    assert (flush.labels["reason"], flush.labels["loop"]) == ("full", False)
    assert subs[1].dur_s >= call.dur_s + waits[subs[1].id].dur_s


def test_default_ring_keeps_a_chain_across_twenty_engine_calls(tracer):
    cfg, params = _vggt()
    eng = VGGTEngine(cfg, params, device="cpu", max_batch=1, max_wait_s=3600.0)
    with AsyncServer(eng) as srv:
        first = srv.submit(_scenes(1))
        for i in range(19):
            srv.result(srv.submit(_scenes(1, i + 1)), timeout=60)
        srv.result(first, timeout=60)
    assert tracer.capacity == 2048 and len(_by(tracer, "vggt.call")) == 20
    assert len(tracer.recent()) < 400  # parts ride in the model span's event
    assert tracer.phases(first.req_id) == ["enqueue", "admit", "forward", "complete"]
