"""Calibration-free sensitivity planner: score sites, assign bits greedily
under a modeled budget (port of ``repro/core/precision/planner.py``).

**Scoring** (scene-agnostic, in the paper's calibration-free spirit): each
site's *actual* weight matrix is quantized at every candidate level and
multiplied against *synthetic* activations drawn from the paper's measured
premise — Gaussian tokens with a minority of saturated channels (Fig. 1/4)
— routed through the site's orthogonal transform (the online WHT, exactly
what ``apply_linear`` runs at serve time).  The per-site score is the
relative error vs the fp matmul; no calibration data is touched.  The
synthetic activations are the reference's, bit for bit (numpy seeded by
``zlib.crc32`` of the site name), so the scores match the reference's.

**Budgeting** uses the card's roofline constants (``launch/roofline_util``:
the H100's int8 tensor rate and HBM bandwidth).  A site at level ``L`` has

* modeled weight bytes  ``d_in·d_out·count·w_bits/8``  (count = stacked
  layer groups × experts), and
* modeled latency  ``max(t_compute, t_memory)`` for a reference token
  batch, where ``t_memory`` streams the weights plus a_bits activations.

**Assignment** is greedy: every site starts at the cheapest level and the
planner repeatedly applies the upgrade with the best
``error-reduction / modeled-cost`` ratio that still fits BOTH budgets.
With the default budgets (weight bytes capped at uniform-W4A4, latency at
1.25×) the planner spends the *free* axis first — sensitive sites get A8
activations at unchanged weight bytes — which is how a mixed plan beats
uniform W4A4 at equal-or-lower stored bytes.
"""
from __future__ import annotations

import dataclasses
import heapq
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision.plan import (
    PrecisionPlan,
    level_policy,
    level_weight_bits,
    parse_level,
)
from repro_torch.core.versaq import apply_linear, prepare_linear
from repro_torch.launch.roofline_util import HBM_BW, PEAK_FLOPS

__all__ = [
    "SiteInfo",
    "SiteScore",
    "enumerate_sites",
    "score_sites",
    "plan_model",
    "proxy_recon_error",
    "site_latency_from_stats",
    "uniform_weight_bytes",
]

# cheapest-first upgrade ladder (stored-bytes then activation width)
LADDER = ("w4a4", "w4a8", "w8a8", "bf16")


@dataclasses.dataclass(frozen=True)
class SiteInfo:
    """One quantizable weight site: dotted name, logical [d_in, d_out]
    shape, physical multiplicity (layer groups × experts), and a
    representative fp slice used for scoring."""

    site: str
    d_in: int
    d_out: int
    count: int
    weight: Any  # [d_in, d_out] representative slice

    @property
    def n_elems(self) -> int:
        return self.d_in * self.d_out * self.count


@dataclasses.dataclass
class SiteScore:
    info: SiteInfo
    errors: dict[str, float]  # level -> relative quantization error


# ---------------------------------------------------------------------------
# site enumeration (mirrors the model_quant walkers)
# ---------------------------------------------------------------------------


def _rep(w) -> Any:
    """Strip stacked leading dims down to the [d_in, d_out] matrix."""
    while w.ndim > 2:
        w = w[0]
    return w


def enumerate_sites(cfg: ModelConfig, params: dict) -> list[SiteInfo]:
    """Every site ``model_quant`` would quantize, with its dotted name.

    Heads, norms, embeddings, and the other bf16 islands are not
    enumerated — they are never quantized regardless of the plan.
    """
    sites: list[SiteInfo] = []

    def add(site: str, w) -> None:
        lead = w.ndim - 2
        count = int(np.prod(w.shape[:lead])) if lead else 1
        sites.append(SiteInfo(site, int(w.shape[-2]), int(w.shape[-1]), count, _rep(w)))

    if cfg.vggt:
        for blk in ("frame", "global"):
            bp = params["blocks"][blk]
            for n in ("wq", "wk", "wv", "wo"):
                add(f"{blk}.attn.{n}", bp["attn"][n]["w"])
            for n in ("w_gate", "w_up", "w_down"):
                if n in bp["ffn"]:
                    add(f"{blk}.ffn.{n}", bp["ffn"][n]["w"])
        return sites

    from repro_torch.models import lm  # local, as in the reference

    def layer(pfx: str, lp: dict, kind: str, fk: str) -> None:
        mx = lp["mixer"]
        if kind == "attn":
            names = (("wq", "w_kv_down", "w_k_up", "w_v_up", "wo") if cfg.mla
                     else ("wq", "wk", "wv", "wo"))
            for n in names:
                add(f"{pfx}.mixer.{n}", mx[n]["w"])
        elif kind == "mamba":
            for n in ("w_in", "w_out"):
                add(f"{pfx}.mixer.{n}", mx[n]["w"])
        elif kind == "rwkv":
            for n in ("wr", "wk", "wv", "wg", "wo"):
                add(f"{pfx}.mixer.{n}", mx[n]["w"])
        if fk in ("dense", "dense_inner"):
            for n in ("w_gate", "w_up", "w_down"):
                if n in lp["ffn"]:
                    add(f"{pfx}.ffn.{n}", lp["ffn"][n]["w"])
        elif fk == "moe":
            for n in ("w_gate", "w_up", "w_down"):
                if n in lp["ffn"]["experts"]:
                    add(f"{pfx}.ffn.experts.{n}", lp["ffn"]["experts"][n])
            if "shared" in lp["ffn"]:
                for n in ("w_gate", "w_up", "w_down"):
                    if n in lp["ffn"]["shared"]:
                        add(f"{pfx}.ffn.shared.{n}", lp["ffn"]["shared"][n]["w"])
        elif fk == "rwkv_channel":
            for n in ("w_up", "w_down"):
                add(f"{pfx}.ffn.{n}", lp["ffn"][n]["w"])

    for i, lp in enumerate(params["prefix"]):
        layer(f"prefix.{i}", lp, lm.mixer_kind(cfg, i), lm.ffn_kind(cfg, i))
    for j in range(len(cfg.pattern)):
        gi = cfg.first_dense + j
        layer(f"blocks.l{j}", params["blocks"][f"l{j}"], lm.mixer_kind(cfg, gi),
              lm.ffn_kind(cfg, gi))
    return sites


# ---------------------------------------------------------------------------
# sensitivity scoring
# ---------------------------------------------------------------------------


def _synthetic_activations(site: str, d_in: int, batch: int) -> np.ndarray:
    """Saturated-channel synthetic tokens (paper Fig. 1/4 premise), seeded
    from the site name so scores are deterministic and per-site distinct.
    crc32, not ``hash``: the builtin str hash is salted per process, which
    would make plans irreproducible across runs.  float32 numpy, the
    reference's values bit for bit."""
    rng = np.random.default_rng(zlib.crc32(site.encode()))
    x = rng.normal(size=(batch, d_in))
    sat = rng.choice(d_in, max(1, d_in // 10), replace=False)
    x[:, sat] *= 12.0
    return x.astype(np.float32)


def site_error(
    w: torch.Tensor, site: str, level: str, method: str, batch: int = 64
) -> float:
    """Relative error of ``x @ W`` at a level, with the site's online WHT
    in the loop (the transform apply_linear runs at serve time).  Runs the
    float emulation of the integer matmul on ``w``'s device."""
    pol = level_policy(level, method)
    if pol is None:
        return 0.0
    x = torch.as_tensor(_synthetic_activations(site, int(w.shape[0]), batch), device=w.device)
    with torch.no_grad():
        ql = prepare_linear(w, pol, rotate_input_online=True)
        y = apply_linear(ql, x)
        ref = x @ w.to(torch.float32)
        return float(torch.linalg.norm(y - ref) / (torch.linalg.norm(ref) + 1e-12))


def score_sites(
    cfg: ModelConfig,
    params: dict,
    *,
    levels: tuple[str, ...] = LADDER,
    method: str = "versaq",
    batch: int = 64,
) -> list[SiteScore]:
    return [
        SiteScore(
            info=s,
            errors={lv: site_error(s.weight, s.site, lv, method, batch) for lv in levels},
        )
        for s in enumerate_sites(cfg, params)
    ]


# ---------------------------------------------------------------------------
# modeled cost (roofline constants)
# ---------------------------------------------------------------------------


def site_weight_bytes(info: SiteInfo, level: str) -> float:
    return info.n_elems * level_weight_bits(level) / 8.0


def _rate_multiplier(level: str) -> float:
    """Inverse PE-array rate per level, normalized to the INT8 mode.

    The paper's reconfigurable array (§IV-B) runs its INT4 mode at twice
    the INT8 MAC rate (each int8 PE splits into two int4 PEs), and the
    BF16 mode at half of it.  This is the model the *planner* budgets
    against — the accelerator being reproduced — so plans stay comparable
    with the reference's.  The Hopper kernels do not run INT4 faster: they
    unpack W4 and A4 to s8 and run both at the int8 tensor rate."""
    bits = parse_level(level)
    if bits is None:
        return 2.0  # bf16 mode
    return 0.5 if max(bits) <= 4 else 1.0  # full-INT4 mode doubles rate


def site_latency_s(info: SiteInfo, level: str, tokens: int) -> float:
    """max(compute, memory) for one pass of ``tokens`` tokens through the
    site.  The level moves *both* roofline terms: the PE-array rate
    (INT4 mode is 2× INT8, BF16 is ½ — see :func:`_rate_multiplier`) and
    the memory term (stored weight bytes + a_bits activation traffic)."""
    bits = parse_level(level)
    a_bytes = 2.0 if bits is None else bits[1] / 8.0
    flops = 2.0 * tokens * info.d_in * info.d_out * info.count
    # weight streaming + a_bits activation reads; outputs stay on-chip in
    # the rotated domain (paper Fig. 5) and are level-independent anyway
    mem = site_weight_bytes(info, level) + tokens * info.d_in * a_bytes * info.count
    return max(flops * _rate_multiplier(level) / PEAK_FLOPS, mem / HBM_BW)


def uniform_weight_bytes(cfg: ModelConfig, params: dict, level: str) -> float:
    return sum(site_weight_bytes(s, level) for s in enumerate_sites(cfg, params))


def site_latency_from_stats(
    stats,
    cfg: ModelConfig,
    params: dict,
    *,
    tokens: Optional[int] = None,
    level: str = "w4a8",
):
    """Calibrate the roofline latency model against *measured* serving
    latencies.

    ``stats`` is an engine's ``serving.batching.ServeStats`` after real
    traffic: the modeled whole-model latency at ``level`` is rescaled so
    it equals the measured mean per-item latency
    (``ServeStats.mean_item_latency_s``), and the returned drop-in
    ``site_latency_s`` replacement (pass it to :func:`plan_model` via
    ``site_latency_fn=``) distributes that scale across sites.  Per-site
    *ratios* still come from the roofline model — serving measures whole
    forwards, not per-site times — but the budget the planner spends is
    anchored to reality instead of datasheet peaks.

    ``tokens`` must be the per-item token count of the *measured*
    traffic.  Token engines record it: when omitted, the mean served
    tokens-per-item is taken from ``stats``; engines that do not count
    tokens (VGGT scenes) require an explicit value.
    """
    measured = stats.mean_item_latency_s()
    if tokens is None:
        items = sum(s.items for s in stats.buckets.values())
        toks = sum(s.tokens for s in stats.buckets.values())
        if not toks:
            raise ValueError(
                "stats carry no token counts (scene engine?): pass the "
                "measured traffic's per-item token count via tokens="
            )
        tokens = max(1, round(toks / items))
    modeled = sum(site_latency_s(s, level, tokens) for s in enumerate_sites(cfg, params))
    scale = measured / max(modeled, 1e-30)

    def calibrated(info: SiteInfo, lv: str, toks: int) -> float:
        return scale * site_latency_s(info, lv, toks)

    calibrated.scale = scale  # exposed for reports/tests
    return calibrated


# ---------------------------------------------------------------------------
# greedy planning
# ---------------------------------------------------------------------------


def plan_model(
    cfg: ModelConfig,
    params: dict,
    *,
    method: str = "versaq",
    tokens: int = 4096,
    weight_bytes_budget: Optional[float] = None,
    latency_budget_s: Optional[float] = None,
    ladder: tuple[str, ...] = LADDER,
    batch: int = 64,
    use_kernel: bool = False,
    fuse: bool = False,
    name: str = "planned",
    site_latency_fn=None,
) -> tuple[PrecisionPlan, dict]:
    """Plan per-site levels under modeled budgets; returns (plan, report).

    Defaults: weight bytes capped at uniform-``ladder[0]`` (no stored-byte
    headroom — the planner can only spend the activation axis and
    whatever latency slack exists), latency capped at 1.25× the uniform
    baseline.  Pass explicit budgets to open up w8a8/bf16 islands.

    ``site_latency_fn`` overrides the roofline :func:`site_latency_s`
    (same signature) — e.g. :func:`site_latency_from_stats` to anchor the
    latency budget to measured serving latencies.  ``use_kernel`` and
    ``fuse`` stamp the resulting plan for the integer kernels and the
    unified-datapath fusion.
    """
    latency = site_latency_fn if site_latency_fn is not None else site_latency_s
    scored = score_sites(cfg, params, levels=ladder, method=method, batch=batch)
    base = ladder[0]
    w_total = sum(site_weight_bytes(s.info, base) for s in scored)
    t_total = sum(latency(s.info, base, tokens) for s in scored)
    w_budget = w_total if weight_bytes_budget is None else weight_bytes_budget
    t_budget = 1.25 * t_total if latency_budget_s is None else latency_budget_s

    level_idx = {s.info.site: 0 for s in scored}
    by_site = {s.info.site: s for s in scored}

    def candidate(s: SiteScore, li: int):
        """(neg-ratio, site, li) heap entry for the li -> li+1 upgrade."""
        cur, nxt = ladder[li], ladder[li + 1]
        gain = max(s.errors[cur] - s.errors[nxt], 0.0) * s.info.n_elems
        d_w = site_weight_bytes(s.info, nxt) - site_weight_bytes(s.info, cur)
        d_t = latency(s.info, nxt, tokens) - latency(s.info, cur, tokens)
        cost = max(d_t + d_w / HBM_BW, 1e-15)
        return (-gain / cost, s.info.site, li)

    heap = [candidate(s, 0) for s in scored if len(ladder) > 1]
    heapq.heapify(heap)
    while heap:
        _, site, li = heapq.heappop(heap)
        if level_idx[site] != li:
            continue  # stale entry (defensive: one live candidate per site)
        # zero-gain rungs are NOT skipped: they sort last (ratio 0) so they
        # only consume surplus budget, but dropping them would strand the
        # site below a higher rung with real gain (e.g. bf16's zero error)
        s = by_site[site]
        cur, nxt = ladder[li], ladder[li + 1]
        new_w = w_total + site_weight_bytes(s.info, nxt) - site_weight_bytes(s.info, cur)
        new_t = t_total + latency(s.info, nxt, tokens) - latency(s.info, cur, tokens)
        if new_w > w_budget * (1 + 1e-9) or new_t > t_budget * (1 + 1e-9):
            continue  # this upgrade never fits; its successors cost more
        level_idx[site] = li + 1
        w_total, t_total = new_w, new_t
        if li + 2 < len(ladder):
            heapq.heappush(heap, candidate(s, li + 1))

    assignment = {site: ladder[li] for site, li in level_idx.items()}
    counts: dict[str, int] = {}
    for lv in assignment.values():
        counts[lv] = counts.get(lv, 0) + 1
    default = max(counts, key=counts.get)
    overrides = tuple((site, lv) for site, lv in sorted(assignment.items()) if lv != default)
    plan = PrecisionPlan(
        default=default, overrides=overrides, method=method,
        use_kernel=use_kernel, fuse=fuse, name=name,
    )
    report = {
        "assignment": assignment,
        "level_counts": counts,
        "weight_bytes": w_total,
        "weight_bytes_budget": w_budget,
        "modeled_latency_s": t_total,
        "latency_budget_s": t_budget,
        "latency_scale": getattr(latency, "scale", 1.0),
        "uniform_weight_bytes": {
            lv: sum(site_weight_bytes(s.info, lv) for s in scored) for lv in ladder
        },
        "site_errors": {s.info.site: s.errors for s in scored},
    }
    return plan, report


# ---------------------------------------------------------------------------
# proxy model-level error (planner validation + benchmarks)
# ---------------------------------------------------------------------------


def proxy_recon_error(
    cfg: ModelConfig,
    params: dict,
    policy,
    generator: Optional[torch.Generator] = None,
    *,
    frames: int = 2,
    patches: int = 32,
    tokens: int = 16,
    batch: int = 2,
    inputs: Optional[torch.Tensor] = None,
) -> float:
    """Whole-model proxy error of a policy/plan vs the fp forward.

    VGGT: mean relative error over points/depth/pose on a synthetic scene
    batch ``[batch, frames, patches, d_model]``.  LM: relative logits error
    on random tokens ``[batch, tokens]`` (``[batch, tokens, d_model]``
    floats for an ``embed_inputs`` config).  The inputs are drawn from
    ``generator`` (default: seed 0 on the device of ``params``) unless
    ``inputs`` gives them; the reference draws them with ``jax.random``,
    which torch cannot reproduce, so a caller holding the two against each
    other passes the same ``inputs`` to both.  No calibration data; the
    same inputs are used for every policy, so the numbers are comparable
    across plans.
    """
    from repro_torch.core.model_quant import quantize_lm, quantize_vggt
    from repro_torch.models import lm, vggt

    dev = (params["patch_proj"] if cfg.vggt else params["embed"])["w"].device
    gen = torch.Generator(device=dev).manual_seed(0) if generator is None else generator
    if inputs is not None:
        x = inputs
    elif cfg.vggt:
        x = torch.randn((batch, frames, patches, cfg.d_model), generator=gen, device=dev)
    elif cfg.embed_inputs:
        x = torch.randn((batch, tokens, cfg.d_model), generator=gen, device=dev)
    else:
        x = torch.randint(0, cfg.vocab_size, (batch, tokens), generator=gen, device=dev)

    def rel(got, ref) -> float:
        return float(torch.linalg.norm(got - ref) / (torch.linalg.norm(ref) + 1e-9))

    with torch.inference_mode():
        if cfg.vggt:
            ref = vggt.forward(cfg, params, x)
            got = vggt.forward(cfg, quantize_vggt(cfg, params, policy), x)
            return float(np.mean([rel(got[k], ref[k]) for k in ("points", "depth", "pose")]))
        ref, _ = lm.forward(cfg, params, x)
        got, _ = lm.forward(cfg, quantize_lm(cfg, params, policy), x)
        return rel(got, ref)
