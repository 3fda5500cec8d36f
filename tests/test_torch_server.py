"""The port's ``AsyncServer`` over the VGGT engine on the CPU: serving,
drain and abort on stop, a failed flush, the strike counter, and the
telemetry endpoints on an ephemeral port, whose metric families and label
sets equal the JAX server's for the same traffic."""
import json
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.launch.specs import ServeSpec as JServeSpec
from repro.obs import metrics as j_metrics
from repro.serving.server import AsyncServer as JAsyncServer
from repro.serving.vggt_engine import VGGTEngine as JVGGTEngine
from repro_torch import obs
from repro_torch.launch.specs import ServeSpec
from repro_torch.models import vggt
from repro_torch.obs import metrics
from repro_torch.serving.batching import PendingRequest, ServerStopped
from repro_torch.serving.faults import InjectedFault
from repro_torch.serving.server import AsyncServer
from repro_torch.serving.vggt_engine import VGGTEngine
from tests.test_torch_vggt_engine import _fixture, _scenes
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TIERS = "quality=fp,balanced=w4a8"


def _engine(**kw):
    _, cfg, _, tp = _fixture()
    tiers = {n: s.materialize() for n, s in ServeSpec.parse_tiers(TIERS).items()}
    kw.setdefault("max_wait_s", 0.0)
    return VGGTEngine(cfg, tp, tiers=tiers, attn_impl="two_stage", max_batch=2, device="cpu",
                      **kw)


def _get(addr, path):
    host, port = addr
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=60) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def _families(text):
    """{family: {label-name tuple: set of label-value tuples}} from
    Prometheus text (histogram series folded into their family)."""
    out, kinds = {}, {}
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            kinds[name] = kind
            out.setdefault(name, {})
            continue
        if line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        float(value.replace("+Inf", "inf"))
        name, _, labels = series.partition("{")
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and kinds.get(name[: -len(suffix)]) == "histogram":
                name = name[: -len(suffix)]
        pairs = tuple(p.split("=", 1) for p in labels.rstrip("}").split('",') if p)
        pairs = tuple((k, v.strip('"')) for k, v in pairs if k != "le")
        key = tuple(k for k, _ in pairs)
        out.setdefault(name, {}).setdefault(key, set()).add(tuple(v for _, v in pairs))
    return out


def _serve(server_cls, eng, conv, reg, n=4):
    """n requests round-robin over the tiers through one server with a
    metrics port (with a long ``max_wait_s`` each tier's pair coalesces
    into one forward, whatever the loop's timing); returns (outputs,
    /metrics text, /stats, the first request's /trace chain, /healthz)."""
    names = list(eng.tiers)
    srv = server_cls(eng, metrics_port=0, registry=reg)
    with srv:
        reqs = [srv.submit(conv(_scenes(1, seed=i)), tier=names[i % len(names)])
                for i in range(n)]
        outs = [srv.result(r, timeout=300) for r in reqs]
        _, ctype, text = _get(srv.metrics_address, "/metrics")
        assert ctype.startswith("text/plain")
        _, ctype, stats = _get(srv.metrics_address, "/stats")
        assert ctype.startswith("application/json")
        _, _, chain = _get(srv.metrics_address, f"/trace?request={reqs[0].req_id}")
        health = _get(srv.metrics_address, "/healthz")
    return outs, text, json.loads(stats), json.loads(chain), health


def test_serves_vggt_requests_with_endpoints():
    eng = _engine(max_wait_s=3600.0)
    reg = metrics.Registry()
    try:
        outs, text, stats, chain, health = _serve(AsyncServer, eng, lambda x: x, reg)
    finally:
        obs.disable_all(registry=reg)
    for o in outs:
        assert all(torch.isfinite(o[k]).all() for k in ("pose", "points", "depth", "conf"))
    fams = _families(text)
    assert fams["serve_bucket_calls_total"][("kind", "bucket", "tier")] == {
        ("vggt", "balanced:b2xs2xp24", "balanced"), ("vggt", "quality:b2xs2xp24", "quality")}
    assert 'serve_items_total{kind="vggt"} 4' in text
    assert 'serve_pending_requests{kind="vggt"} 0' in text
    assert stats["kind"] == "vggt" and stats["totals"]["items"] == 4 and stats["pending"] == 0
    assert list(dict.fromkeys(e["phase"] for e in chain)) == [
        "enqueue", "admit", "forward", "complete"]
    assert health == (200, "text/plain", "ok\n")


def test_metric_families_match_reference_server():
    """The same traffic through both servers: the same metric families
    with the same label names, and the same label values on the serving
    and quant-health families.  The kernel-counter families are only held
    by name: the port's wrappers count launches on the card, so its CPU
    run labels none, where the reference counts its kernels as traced."""
    jcfg, _, jp, _ = _fixture()
    jtiers = {n: s.materialize() for n, s in JServeSpec.parse_tiers(TIERS).items()}
    jeng = JVGGTEngine(jcfg, jp, tiers=jtiers, attn_impl="two_stage", max_batch=2,
                       max_wait_s=3600.0)
    teng = _engine(max_wait_s=3600.0)
    texts = []
    for cls, eng, conv, o, reg in ((AsyncServer, teng, lambda x: x, obs, metrics.Registry()),
                                   (JAsyncServer, jeng, jnp.asarray, j_obs,
                                    j_metrics.Registry())):
        try:
            texts.append(_serve(cls, eng, conv, reg)[1])
        finally:
            o.disable_all(registry=reg)
    got, want = (_families(t) for t in texts)
    assert got.keys() == want.keys()
    assert {"kernel_launches_total", "kernel_modeled_hbm_bytes_total"} <= got.keys()
    for name in got:
        if not name.startswith("kernel_"):
            assert got[name] == want[name], name
    assert {v[0] for v in got["quant_health_samples_total"][("site", "a_bits")]} == {
        f"{blk}.{site}" for blk in ("frame", "global")
        for site in ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.w_up", "ffn.w_down")}


def test_stop_drains_pending():
    eng = _engine(max_wait_s=3600.0)  # only stop()'s drain can deliver
    srv = AsyncServer(eng, poll_interval_s=0.0005).start()
    req = srv.submit(_scenes(1, seed=0), tier="balanced")
    assert not req.ready
    srv.stop(drain=True)
    assert not srv.running
    assert req.ready and req.result()["points"].shape == (1, 2, 24, 3)


def test_stop_without_drain_fails_waiters():
    eng = _engine(max_wait_s=3600.0)
    srv = AsyncServer(eng, poll_interval_s=0.0005).start()
    req = srv.submit(_scenes(1, seed=0))
    srv.stop(drain=False)
    with pytest.raises(ServerStopped, match="before drain"):
        srv.result(req, timeout=10)


def test_result_timeout():
    eng = _engine(max_wait_s=3600.0)
    srv = AsyncServer(eng, poll_interval_s=0.0005).start()
    try:
        req = srv.submit(_scenes(1, seed=0))
        with pytest.raises(TimeoutError):
            srv.result(req, timeout=0.05)
    finally:
        srv.stop(drain=False)


def test_loop_survives_failed_flush():
    """A micro-batch that fails at flush time fails its owners but not the
    loop: a later request is served."""
    _, cfg, _, tp = _fixture()
    eng = _engine()
    with AsyncServer(eng, poll_interval_s=0.0005) as srv:
        bad = srv.submit(np.zeros((1, 2, 24, cfg.d_model + 1), np.float32))  # wrong d_model
        with pytest.raises(RuntimeError, match="micro-batch failed"):
            srv.result(bad, timeout=300)
        good = srv.submit(_scenes(1, seed=1), tier="quality")
        out = srv.result(good, timeout=300)
    want = vggt.forward(eng.cfg, tp, torch.as_tensor(_scenes(1, seed=1)))
    torch.testing.assert_close(out["points"], want["points"], rtol=1e-5, atol=1e-5)


def test_loop_survives_bounded_crashes_and_records_them():
    eng = _engine(faults="crash@poll:times=2")
    reg = metrics.Registry()
    with AsyncServer(eng, poll_interval_s=0.001, registry=reg) as srv:
        req = srv.submit(_scenes(1, seed=2))
        srv.result(req, timeout=300)
    assert srv.loop_failures == 2 and srv.consecutive_failures == 0
    assert isinstance(srv.last_error, InjectedFault)
    assert reg.get("serve_loop_failures_total").value(error="InjectedFault") == 2


def test_loop_escalates_after_k_strikes():
    """K consecutive poll failures abort the engine, mark the server
    failed and turn /healthz to 503."""
    eng = _engine(faults="crash@poll:times=0", max_wait_s=3600.0)
    reg = metrics.Registry()
    srv = AsyncServer(eng, poll_interval_s=0.001, max_loop_failures=3, metrics_port=0,
                      registry=reg)
    req = srv.submit(_scenes(1, seed=3))
    try:
        srv.start()
        deadline = time.monotonic() + 30
        while srv.running and time.monotonic() < deadline:
            time.sleep(0.005)
        assert srv._failed and srv.health() == (503, "unhealthy")
        with pytest.raises(ServerStopped, match="consecutive"):
            srv.result(req, timeout=10)
        with pytest.raises(ServerStopped, match="permanently"):
            srv.submit(_scenes(1, seed=4))
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(srv.metrics_address, "/healthz")
        assert exc.value.code == 503
    finally:
        srv.stop(drain=False)
        obs.disable_all(registry=reg)


def test_submit_goes_before_the_next_busy_poll():
    """A busy engine (decode slots occupied) has the loop re-take the lock
    poll after poll; a lock is not fair, so without the hand-off a submit
    waits out at least one more poll, and can starve.  With it, a submit
    made during a poll runs as soon as that poll ends (one race of a few
    microseconds may cost a poll now and then)."""

    class Busy:
        max_wait_s = 0.004
        active = 1

        def __init__(self):
            self.polls, self.seen = 0, []

        def enqueue(self, x):
            self.seen.append(self.polls)
            req = PendingRequest()
            req._deliver(x)
            return req

        def poll(self):
            self.polls += 1
            time.sleep(0.01)  # a burst; the GIL is free, as in a device sync
            return 0

        def flush(self):
            pass

        def abort(self, err=None):
            return 0

    eng = Busy()
    waited = []
    with AsyncServer(eng) as srv:
        time.sleep(0.05)
        for i in range(20):
            p0 = eng.polls
            srv.submit(i)
            waited.append(eng.seen[-1] - p0)
            time.sleep(0.003)
        eng.active = 0
    assert max(waited) <= 1 and sum(waited) <= 5, waited
