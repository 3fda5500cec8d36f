"""Live observability tour on the PyTorch/CUDA port: serve quantized LM
traffic with the full telemetry stack on and consume every surface a
production scrape would (the port of ``examples/observe_serving.py``).

1. Build a tiny W8A8 kernel-routed LM engine and start ``AsyncServer``
   with ``metrics_port=0`` (ephemeral) — live telemetry flips on, span
   events mirror to a JSONL file.
2. Submit mixed-length prompt traffic and await the results.
3. Scrape ``/metrics`` (Prometheus text), ``/stats`` (summary JSON) and
   ``/trace?request=`` (one request's span chain) over real HTTP.
4. Tail the JSONL trace file and print the per-request chains plus the
   quant-health and kernel-launch counters the registry collected.

It runs on the CUDA device unless ``--device cpu`` is given (each kernel
wrapper then takes its plain PyTorch version, and launches nothing).

Run:  PYTHONPATH=src python examples/torch_observe_serving.py [--requests 4] [--device cpu]
"""
import argparse
import json
import os
import tempfile
import urllib.request

import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.precision import PrecisionPlan
from repro_torch.data.pipeline import mixed_len_prompts
from repro_torch.models import lm
from repro_torch.serving.batching import resolve_device
from repro_torch.serving.engine import Engine
from repro_torch.serving.server import AsyncServer

TINY = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64)


def _get(addr, path):
    host, port = addr
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=60) as r:
        return r.read().decode()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where to serve (default: the CUDA device; no fallback)")
    args = ap.parse_args()

    dev = resolve_device(args.device, "Engine")
    cfg = get_config("qwen3-14b-smoke").with_(**TINY)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = Engine(
        cfg, params, max_len=args.prompt_len + args.gen, mode="continuous",
        max_wait_s=0.002,
        policy=PrecisionPlan(default="w8a8", use_kernel=True, name="demo"),
        device=dev,
    )

    fd, trace_path = tempfile.mkstemp(suffix=".jsonl", prefix="spans_")
    os.close(fd)
    # enable before the server so the JSONL mirror catches every event;
    # quant_every=1 samples every monitored call (demo volume is tiny)
    obs.enable_all(trace_path=trace_path, quant_every=1)

    prompts = mixed_len_prompts(cfg.vocab_size, args.requests, args.prompt_len)
    with AsyncServer(eng, metrics_port=0) as srv:
        addr = srv.metrics_address
        print(f"telemetry: http://{addr[0]}:{addr[1]}/metrics  /stats  /trace")
        print(f"span JSONL: {trace_path}")

        reqs = [srv.submit(p, args.gen) for p in prompts]
        outs = [srv.result(r, timeout=600) for r in reqs]
        print(f"served {len(outs)} requests "
              f"-> {sum(o.shape[-1] for o in outs)} tokens")

        # ---- /metrics: Prometheus text ---------------------------------
        metrics_text = _get(addr, "/metrics")
        wanted = [
            "serve_admitted_total", "serve_bucket_calls_total",
            "serve_request_latency_seconds_bucket", "kernel_launches_total",
            "quant_clip_rate", "quant_health_samples_total",
        ]
        present = [n for n in wanted if n in metrics_text]
        print(f"scraped /metrics: {len(metrics_text.splitlines())} lines, "
              f"families present: {present}")
        for line in metrics_text.splitlines():
            if line.startswith(("kernel_launches_total{", "quant_clip_rate{")):
                print(f"  {line}")

        # ---- /stats: the unified engine summary ------------------------
        stats = json.loads(_get(addr, "/stats"))
        print(f"scraped /stats: kind={stats['kind']} totals={stats['totals']} "
              f"scheduler={stats['scheduler']}")

        # ---- /trace: one request's span chain --------------------------
        chain = json.loads(_get(addr, f"/trace?request={reqs[0].req_id}"))
        phases = list(dict.fromkeys(e["phase"] for e in chain))
        print(f"scraped /trace for {reqs[0].req_id}: chain={' -> '.join(phases)}")

    # ---- offline: tail the JSONL mirror --------------------------------
    with open(trace_path) as f:
        events = [json.loads(ln) for ln in f]
    by_req = {}
    for ev in events:
        if "request" in ev:
            by_req.setdefault(ev["request"], []).append(ev["phase"])
    complete = sum(
        1 for phases in by_req.values()
        if phases and phases[-1] in ("complete", "evicted", "failed")
    )
    print(f"JSONL trace: {len(events)} events, {len(by_req)} request chains, "
          f"{complete} closed")
    obs.disable_all()
    assert complete == len(reqs), "every request chain must close"
    assert all(n in metrics_text for n in wanted), "missing metric families"
    print("observability tour OK")


if __name__ == "__main__":
    main()
