"""The port's telemetry (``repro_torch.obs`` and the kernel probe's global
counters) held against the JAX package's on the same calls: metrics text,
tracer events, probe counters, and the quant-health monitors sampled in a
quantized VGGT forward."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.core.model_quant import quantize_vggt as j_quantize_vggt
from repro.core.precision.plan import PrecisionPlan as JPlan
from repro.kernels import probe as j_probe
from repro.models import vggt as jvggt
from repro.obs import metrics as j_metrics
from repro.obs import quant_health as j_qh
from repro.obs import trace as j_trace
from repro_torch import obs
from repro_torch.core.model_quant import quantize_vggt
from repro_torch.core.precision.plan import PrecisionPlan
from repro_torch.kernels import probe
from repro_torch.models import vggt
from repro_torch.obs import metrics, quant_health, trace
from tests.test_torch_vggt_engine import _fixture, _scenes
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _script_basic(m):
    reg = m.Registry()
    c = reg.counter("reqs_total", "requests", ("kind",))
    c.inc(kind="lm")
    c.inc(2.5, kind="vggt")
    c.set_total(10, kind="lm")
    reg.gauge("depth", "queue depth").set(3)
    reg.gauge("occ", "occupancy", ("kind", "tier")).inc(0.125, kind="vggt", tier="fast")
    reg.counter("esc_total", 'has "quotes"', ("p",)).inc(p='a"b\\c\nd')
    return reg


def _script_hist(m):
    reg = m.Registry()
    h = reg.histogram("lat_seconds", "latency", ("kind",), buckets=(0.01, 0.1, 1.0))
    for v, k in ((0.005, "a"), (0.05, "a"), (0.05, "b"), (5.0, "a"), (1e20, "b")):
        h.observe(v, kind=k)
    reg.histogram("default_seconds", "default buckets").observe(0.3)
    reg.register_collector(lambda r: r.gauge("pulled", "collector").set(7))
    return reg


def _script_kernels(m):
    reg = m.Registry()
    m.export_kernel_counters(reg, {"quant_matmul": 3, "fused_ffn": 1}, {"quant_matmul": 1024})
    return reg


@pytest.mark.parametrize("script", [_script_basic, _script_hist])
def test_metrics_render_same_text(script):
    """For the same calls, both registries render the same Prometheus text
    and the same JSON text."""
    got, want = script(metrics), script(j_metrics)
    assert got.render_prometheus() == want.render_prometheus()
    assert got.render_json_text() == want.render_json_text()


def test_kernel_counter_export_same_series():
    """The kernel-counter families: the same names, labels and values (the
    help texts say what the port's counts mean)."""
    got = json.loads(_script_kernels(metrics).render_json_text())
    want = json.loads(_script_kernels(j_metrics).render_json_text())
    assert got.keys() == want.keys()
    for name in got:
        assert got[name]["kind"] == want[name]["kind"]
        assert got[name]["series"] == want[name]["series"]


def _events(tracer):
    return [(e.phase, e.request, e.dur_s, e.labels) for e in tracer.recent()]


def test_tracer_ring_phases_and_jsonl_match(tmp_path):
    tracers = []
    for mod, tag in ((trace, "port"), (j_trace, "ref")):
        tr = mod.Tracer(capacity=5, jsonl_path=str(tmp_path / f"{tag}.jsonl"))
        for phase in ("enqueue", "admit", "forward", "forward", "complete"):
            tr.emit(phase, request="r1", dur_s=0.5 if phase == "forward" else None, tier="fast")
        for i in range(3):
            tr.emit("enqueue", request=f"r{i + 2}", scenes=i)
        tr.close()
        tracers.append(tr)
    got, want = tracers
    assert _events(got) == _events(want)
    assert got.phases("r1") == want.phases("r1") == ["forward", "complete"]
    assert _events_n(got) == _events_n(want)
    strip = [{k: v for k, v in json.loads(ln).items() if k not in ("t", "wall")}
             for tag in ("port", "ref") for ln in open(tmp_path / f"{tag}.jsonl")]
    assert strip[:8] == strip[8:] and len(strip) == 16


def _events_n(tracer):
    return [(e.phase, e.request) for e in tracer.recent(n=2, request="r3")]


def test_span_events_match_and_noop_without_tracer():
    for mod in (trace, j_trace):
        prev = mod.uninstall()
        try:
            assert mod.emit("enqueue", request="r0") is None
            with mod.span("forward"):
                pass
            mod.install(mod.Tracer())
            with mod.span("forward", request="r7", bucket="b2xs2xp24"):
                pass
            with mod.span("forward", emit_event=False):
                pass
            (ev,) = mod.current().recent()
            assert (ev.phase, ev.request, ev.labels) == ("forward", "r7", {"bucket": "b2xs2xp24"})
            assert ev.dur_s >= 0.0
        finally:
            mod.install(prev)


def test_probe_global_counters_match():
    script = [("quant_matmul", 1, 100), ("fused_ffn", 2, 0), ("quant_matmul", 3, 7),
              ("wht", 1, 64)]
    out = []
    for mod in (probe, j_probe):
        mod.disable_global()
        g = mod.enable_global()
        assert mod.enable_global() is g
        with mod.tracking() as outer:
            for name, n, nb in script[:2]:
                mod.record(name, n, nbytes=nb)
            with mod.tracking() as inner:
                for name, n, nb in script[2:]:
                    mod.record(name, n, nbytes=nb)
        out.append((dict(g.counts), dict(g.nbytes), g.count, g.total_bytes, outer.calls,
                    dict(outer.nbytes), outer.total_bytes, inner.by_name()))
        g.reset()
        assert g.count == 0 and g.total_bytes == 0
        mod.disable_global()
        assert mod.global_counters() is None
    assert out[0] == out[1]


def test_enable_all_disable_all_round_trip():
    """Both packages' switches flip the same pillars, and the probe's
    counters reach the registry through the render-time collector."""
    texts = []
    for o, m, p, qh, tr in ((obs, metrics, probe, quant_health, trace),
                           (j_obs, j_metrics, j_probe, j_qh, j_trace)):
        o.disable_all()
        reg = m.Registry()
        try:
            t = o.enable_all(registry=reg)
            assert o.enabled() and m.live() and qh.enabled()
            assert p.global_counters() is not None and tr.current() is t
            p.record("some_kernel", 2, nbytes=64)
            texts.append([ln for ln in reg.render_prometheus().splitlines()
                          if not ln.startswith("#")])
        finally:
            o.disable_all(registry=reg)
        assert not o.enabled() and not m.live() and not qh.enabled()
        assert p.global_counters() is None and tr.current() is None
    assert texts[0] == texts[1]
    assert 'kernel_launches_total{kernel="some_kernel"} 2' in texts[0]


@functools.lru_cache(maxsize=None)
def _forwards(fused: bool):
    """The fixture model quantized by each package (w4a8 plan, kernels on,
    two-stage attention): (port forward, reference forward).  The
    reference's is jitted once; it is first called with the monitors on,
    so its graph carries their callbacks, whose host sink applies the
    sampling of the moment."""
    jcfg, cfg, jp, tp = _fixture()
    jcfg, cfg = jcfg.with_(attn_impl="two_stage"), cfg.with_(attn_impl="two_stage")
    jq = j_quantize_vggt(jcfg, jp, JPlan(default="w4a8", use_kernel=True, fuse=fused))
    tq = quantize_vggt(cfg, tp, PrecisionPlan(default="w4a8", use_kernel=True, fuse=fused))
    jfwd = jax.jit(functools.partial(jvggt.forward, jcfg))
    return (lambda x: vggt.forward(cfg, tq, torch.as_tensor(x)),
            lambda x: jfwd(jq, jnp.asarray(x)))


def _quant_health_run(fused: bool, every: int):
    """Three forwards through each package with the monitors on; returns
    (port, reference) (calls per site, quant_* series)."""
    xs = [_scenes(1, seed=s) for s in range(3)]
    out = []
    for (qh, m), fwd in zip(((quant_health, metrics), (j_qh, j_metrics)), _forwards(fused)):
        reg = m.Registry()
        qh.enable(every=every, registry=reg)
        try:
            for x in xs:
                np.asarray(fwd(x)["pose"])  # the reference's callbacks have fired
            calls = qh.sites_sampled()
        finally:
            qh.disable()
        blob = json.loads(reg.render_json_text())
        out.append((calls, {k: v for k, v in blob.items() if k.startswith("quant_")}))
    return out


@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("fused", [False, True])
def test_quant_health_samples_same_calls_and_stats(fused, every):
    """The same sites are monitored the same number of times, the same
    calls are sampled, and each sampled statistic agrees to 1e-6."""
    (got_calls, got), (want_calls, want) = _quant_health_run(fused, every)
    assert got_calls == want_calls and len(got_calls) == (6 if fused else 12)
    assert all(n == 3 for n in got_calls.values())  # one layer, three forwards
    assert got.keys() == want.keys() == {"quant_clip_rate", "quant_scale_crest",
                                         "quant_overflow_total", "quant_health_samples_total"}
    for name in got:
        g = {tuple(sorted(s["labels"].items())): s["value"] for s in got[name]["series"]}
        w = {tuple(sorted(s["labels"].items())): s["value"] for s in want[name]["series"]}
        assert g.keys() == w.keys() and len(g) == len(got_calls)
        for k in g:
            assert abs(g[k] - w[k]) <= 1e-6 * max(1.0, abs(w[k])), (name, k, g[k], w[k])
    samples = {s["labels"]["site"]: s["value"]
               for s in got["quant_health_samples_total"]["series"]}
    assert set(samples.values()) == {3.0 if every == 1 else 1.0}  # calls 0, 1, 2 or call 0


def test_quant_health_costs_nothing_when_off():
    """Off, or on an unnamed site, the monitor counts and computes nothing."""
    quant_health.disable()
    quant_health.monitor("some.site", torch.ones(2, 4), 8)
    quant_health.enable(every=1, registry=metrics.Registry())
    try:
        quant_health.monitor(None, torch.ones(2, 4), 8)
    finally:
        quant_health.disable()
    assert quant_health.sites_sampled() == {}
    with pytest.raises(ValueError):
        quant_health.enable(every=0)


def test_quant_health_stats_match_reference_sink():
    """The statistics of one tensor against the reference monitor's, on an
    input with outliers (clip, crest) and a4 (overflow at the rounding edge
    does not occur with amax scales: both read 0)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 64)).astype(np.float32)
    x[2, 5] = 40.0
    for bits in (4, 8):
        regs = []
        for qh, m, arr in ((quant_health, metrics, torch.as_tensor(x)),
                           (j_qh, j_metrics, jnp.asarray(x))):
            reg = m.Registry()
            qh.enable(every=1, registry=reg)
            try:
                qh.monitor("s", arr, bits)
            finally:
                qh.disable()
            regs.append(reg)
        for name in ("quant_clip_rate", "quant_scale_crest", "quant_overflow_total"):
            g = regs[0].get(name).value(site="s", a_bits=str(bits))
            w = regs[1].get(name).value(site="s", a_bits=str(bits))
            assert abs(g - w) <= 1e-6 * max(1.0, abs(w)), (name, g, w)
