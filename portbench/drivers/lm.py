"""A decoder LM through the port's server: ``AsyncServer`` over the
continuous ``Engine`` with the configuration's precision tier, prompts of
token ids drawn from the seed, and the check of the served prefill's
last-position logits and served tokens against ``reference/lm.py``.

The engine returns ids only; the harness reads each wave's last-position
logits through a wrapper it installs around ``PrefillRunner.run`` in its
own process (the rows of a wave follow its requests' order)."""
from __future__ import annotations

import gc
import itertools
import time

import numpy as np
import torch

from portbench.drivers import common
from portbench.drivers.vggt import plain_tree
from portbench.harness import Req, Run
from portbench.traffic import lengths, rng, sub_seed

MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size",
              "norm", "act", "pos", "rope_theta", "max_seq")
MAX_REQUESTS = 1 << 16


def model_config(config: dict):
    from repro_torch.configs import get_config

    return get_config(config["arch"]).with_(**{k: config[k] for k in MODEL_KEYS if k in config})


def make_weights(cfg, seed: int, device):
    from repro_torch.models import lm

    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    return lm.init_params(cfg, gen, device=device)


def prompt(seed: int, index: int, n: int, vocab: int) -> np.ndarray:
    return rng(seed, 5, index).integers(0, vocab, n, dtype=np.int64)


def run(run: Run, *, t_process: float, device: str, tier: str) -> None:
    from repro_torch.launch.specs import ServeSpec
    from repro_torch.serving import engine as eng_mod
    from repro_torch.serving.server import AsyncServer

    tr, conf = run.traffic, run.config
    dev = torch.device(device)
    cfg = model_config(conf)
    buckets = tuple(tr["batch_buckets"])
    win = common.Window(run)
    logits = {}

    def describe(self, args, kw, out):
        reqs, L = args[0], args[1]
        i0 = 0
        for r in reqs:  # the wave's rows, in its requests' order
            n = r.prompts.shape[0]
            win.run.slots[r.req_id] = i0
            if win.t0 is not None:
                logits[r.req_id] = out.logits_last[i0:i0 + n].clone()
            i0 += n
        return dict(real=out.n_real, batch=out.bb, length=L,
                    lens=tuple(r.prompts.shape[1] for r in reqs for _ in range(r.prompts.shape[0])))

    undo = common.record_calls(eng_mod.PrefillRunner, "run", win, describe)
    eng = eng_mod.Engine(cfg, make_weights(cfg, run.seed, dev),
                         tiers={"served": ServeSpec.parse(tier).materialize()},
                         mode="continuous", max_len=tr["max_len"], batch_buckets=buckets,
                         max_batch=tr["max_batch"], max_wait_s=tr["max_wait_s"], device=dev)
    eng.tier_params("served")
    plens = tr["prompt_len"]
    for L in tr["prompt_buckets"]:  # every (batch, prompt) bucket of the traffic
        for b in buckets:
            n = max(plens["min"], L * 3 // 4) if L > plens["min"] else L
            ids = rng(run.seed, 6, b, L).integers(0, cfg.vocab_size, (b, n), dtype=np.int64)
            eng.generate(ids, n_steps=tr["new_tokens"], tier="served")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    before = _counters(eng)
    served = {}

    def keep(r, out):
        served[r.index] = int(np.asarray(out).reshape(-1)[0])

    # one stream of requests shared by the clients: the k-th request sent,
    # whichever client sends it, is the seed's k-th prompt
    lens = lengths(plens, MAX_REQUESTS, run.seed)
    counter = itertools.count()

    def make(c, seq):
        k = next(counter)
        r = Req(index=k, client=c, prompt_len=lens[k], new_tokens=tr["new_tokens"])
        return r, prompt(run.seed, k, lens[k], cfg.vocab_size)

    srv = AsyncServer(eng).start()
    try:
        t0 = win.open()
        run.setup_s = t0 - t_process
        run.requests = common.closed_loop(
            srv, win, tr["clients"], make,
            lambda r: {"n_steps": tr["new_tokens"], "tier": "served"}, keep)
        win.close()
    finally:
        srv.stop()
        undo()
    after = _counters(eng)
    run.stats = {k: after[k] - before[k] for k in after}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del srv, eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(run, cfg, logits, served, dev)


def _counters(eng) -> dict:
    """Real prompt tokens and prompt slots (batch bucket x prompt bucket)
    of the engine's prefill waves so far."""
    from repro_torch.serving.engine import PrefillBucket

    out = {"tokens": 0, "slots": 0}
    for b, s in eng.stats.buckets.items():
        if isinstance(b, PrefillBucket):
            out["tokens"] += s.tokens
            out["slots"] += s.calls * b.batch * b.prompt_len
    return out


def check(run: Run, cfg, logits: dict, served: dict, dev) -> None:
    """A seed-drawn sample of the window's requests, the longest prompt
    and one from each row of a wave among them, against the plain
    reference from the seed-made weights: the widest relative L2 gap of
    the last-position logits, and the widest gap by which a served
    (greedy) token's reference logit lies below the reference's best."""
    from portbench.reference import lm as ref

    t = time.perf_counter()
    picks = common.sample([r for r in run.in_window() if r.req_id in logits],
                          run.traffic["check_requests"], run.seed,
                          longest=lambda r: r.prompt_len,
                          slot=lambda r: run.slots.get(r.req_id))
    if not picks:
        return
    raw = plain_tree(make_weights(cfg, run.seed, dev))
    prompts = [torch.from_numpy(prompt(run.seed, r.index, r.prompt_len, cfg.vocab_size))
               for r in picks]
    want = ref.last_logits(raw, {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
                                 "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                                 "rope_theta": cfg.rope_theta}, prompts)
    rels, gaps = [], []
    for r, w in zip(picks, want):
        rels.append(common.rel_l2(logits[r.req_id][0], w))
        gaps.append(float(w.max() - w[served[r.index]]))
    run.checks["logits_rel_l2"] = max(rels)
    run.checks["served_token_gap"] = max(gaps)
    run.notes.append(f"check: {len(picks)} prompts ({sum(r.prompt_len for r in picks)} tokens) "
                     f"against the reference in {time.perf_counter() - t:.1f} s")


def counter_cfg(run: Run) -> dict:
    return {k: run.config[k] for k in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                                       "head_dim", "d_ff", "vocab_size")}


def launches(run: Run, batch) -> list:
    from portbench import counts

    return counts.lm_launches(counter_cfg(run), batch.batch, batch.length)


def model_ops(run: Run, batch) -> float:
    from portbench import counts

    return sum(counts.lm_model_ops(counter_cfg(run), n) for n in batch.lens)
