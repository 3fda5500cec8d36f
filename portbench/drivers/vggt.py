"""VGGT through the port's server: ``AsyncServer`` over ``VGGTEngine``
with the configuration's precision tier, scenes of patch embeddings made
on the device from the seed, and the check of the delivered pose, depth,
points and confidences against ``reference/vggt.py``."""
from __future__ import annotations

import gc
import time

import torch

from portbench.drivers import common
from portbench.harness import Req, Run
from portbench.traffic import open_loop_times, sub_seed

OUTPUTS = ("pose", "depth", "points", "conf")
MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "norm",
              "norm_bias", "act", "pos", "n_special_tokens", "layerscale", "layerscale_init")


def model_config(config: dict):
    """The program's ModelConfig of the registry entry, with every model
    key of the configuration file applied."""
    from repro_torch.configs import get_config

    return get_config(config["arch"]).with_(**{k: config[k] for k in MODEL_KEYS if k in config})


def make_weights(cfg, seed: int, device):
    from repro_torch.models import vggt as vggt_mod

    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    return vggt_mod.init_params(cfg, gen, device=device)


def plain_tree(t):
    """The raw tree as plain dicts of tensors (norms as {"g", "b"})."""
    if hasattr(t, "g") and hasattr(t, "kind"):
        return {"g": t.g, "b": t.b}
    if isinstance(t, dict):
        return {k: plain_tree(v) for k, v in t.items()}
    return t


def make_scenes(seed: int, index: int, n: int, frames: int, patches: int, d: int, device):
    """``n`` scenes [n, S, P, d]: per scene a point cloud seen from S
    camera poses, its camera-space points, depths and translations
    projected into d dims by the seed's fixed projection, plus noise."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    proj = torch.randn((7, d), generator=g, device=device) / 7 ** 0.5
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 3, index))
    pts = torch.randn((n, 1, patches, 3), generator=g, device=device).expand(n, frames, patches, 3)
    pose = 0.3 * torch.randn((n, frames, 1, 3), generator=g, device=device)
    cam = pts + pose
    feats = torch.cat([cam, 2.0 + cam[..., 2:3].abs(), pose.expand(n, frames, patches, 3)], -1)
    noise = torch.randn((n, frames, patches, d), generator=g, device=device)
    return feats @ proj + 0.5 * noise


def build(run: Run, dev, tier: str, window):
    """The engine with the tier quantized and every batch bucket of the
    traffic warmed, its calls recorded into ``window``; returns (engine,
    undo of the recording)."""
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.serving.batching import pick_bucket
    from repro_torch.serving.vggt_engine import VGGTEngine

    tr, conf = run.traffic, run.config
    cfg = model_config(conf)
    buckets = tuple(tr["batch_buckets"])

    def describe(self, args, kw, out):
        real = 0
        for r in args[1]:  # the call's rows, in its requests' order
            window.run.slots[r.req_id] = real
            real += r.scenes.shape[0]
        return dict(real=real, batch=pick_bucket(self.batch_buckets, real))

    undo = common.record_calls(VGGTEngine, "_run", window, describe)
    eng = VGGTEngine(cfg, make_weights(cfg, run.seed, dev),
                     tiers={"served": ServeSpec.parse(tier).materialize()},
                     attn_impl=conf["attn_impl"], batch_buckets=buckets,
                     max_batch=tr["max_batch"], max_wait_s=tr["max_wait_s"], device=dev)
    eng.tier_params("served")
    for b in buckets:  # warm every batch bucket the traffic can fill
        eng.infer(make_scenes(run.seed, -1 - b, b, tr["frames"], tr["patches"], cfg.d_model,
                              dev), tier="served")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return eng, undo


def serve(run: Run, eng, window, dev, t_process: float) -> dict:
    """One measured window of ``run``'s traffic through ``AsyncServer``
    over ``eng``; returns the kept outputs by request index."""
    from repro_torch.serving.server import AsyncServer

    tr = run.traffic
    frames, patches, d = tr["frames"], tr["patches"], eng.cfg.d_model
    kept = {}

    def keep(r, out):
        kept[r.index] = {k: out[k][0].clone() for k in OUTPUTS}

    before = _counters(eng)
    srv = AsyncServer(eng).start()
    try:
        t0 = window.open()
        run.setup_s = t0 - t_process
        if tr["loop"] == "open":
            times = open_loop_times(tr["rate_per_s"], run.window_s, run.seed)
            run.requests = [Req(index=i, due=t) for i, t in enumerate(times)]
            common.open_loop(
                srv, window, run.requests,
                lambda r: make_scenes(run.seed, r.index, 1, frames, patches, d, dev),
                {"tier": "served"}, keep)
        else:
            def make(c, seq):
                idx = c * 1_000_000 + seq
                return (Req(index=idx, client=c),
                        make_scenes(run.seed, idx, 1, frames, patches, d, dev))

            run.requests = common.closed_loop(srv, window, tr["clients"], make,
                                              lambda r: {"tier": "served"}, keep)
        window.close()
    finally:
        srv.stop()
    after = _counters(eng)
    run.stats = {k: after[k] - before[k] for k in after}
    return kept


def run(run: Run, *, t_process: float, device: str, tier: str) -> None:
    dev = torch.device(device)
    win = common.Window(run)
    eng, undo = build(run, dev, tier, win)
    try:
        kept = serve(run, eng, win, dev, t_process)
    finally:
        undo()
    cfg = eng.cfg
    if dev.type == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(run, cfg, kept, dev)


def _counters(eng) -> dict:
    items = padded = calls = 0
    for b, s in eng.stats.buckets.items():
        items += s.items
        padded += s.padded_items
        calls += s.calls
    return {"items": items, "padded_items": padded, "calls": calls}


def check(run: Run, cfg, kept: dict, dev) -> None:
    """The delivered outputs of a seed-drawn sample of the window's
    requests, one from each row of a micro-batch among them, against the plain reference, worked out again from the
    seed-made weights: the widest relative L2 gap of each output."""
    from portbench.reference import vggt as ref

    t = time.perf_counter()
    tr = run.traffic
    picks = common.sample([r for r in run.in_window() if r.index in kept], tr["check_requests"],
                          run.seed, slot=lambda r: run.slots.get(r.req_id))
    if not picks:
        return
    raw = plain_tree(make_weights(cfg, run.seed, dev))
    scenes = [make_scenes(run.seed, r.index, 1, tr["frames"], tr["patches"], cfg.d_model, dev)[0]
              for r in picks]
    want = ref.forward(raw, {"d_model": cfg.d_model, "n_heads": cfg.n_heads, "d_ff": cfg.d_ff,
                             "n_special_tokens": cfg.n_special_tokens}, scenes)
    for k in OUTPUTS:
        run.checks[f"{k}_rel_l2"] = max(common.rel_l2(kept[r.index][k], w[k])
                                        for r, w in zip(picks, want))
    run.notes.append(f"check: {len(picks)} scenes against the reference in "
                     f"{time.perf_counter() - t:.1f} s")


def counter_cfg(run: Run) -> dict:
    return {k: run.config[k] for k in ("n_layers", "d_model", "n_heads", "d_ff",
                                       "n_special_tokens")}


def launches(run: Run, batch) -> list:
    from portbench import counts

    return counts.vggt_launches(counter_cfg(run), batch.batch, run.traffic["frames"],
                                run.traffic["patches"])


def model_ops(run: Run, batch) -> float:
    from portbench import counts

    return batch.real * counts.vggt_model_ops(counter_cfg(run), run.traffic["frames"],
                                              run.traffic["patches"])
