"""LM serving engine: continuous slot-batched decode, with a bucket-at-a-time
mode beside it (port of ``repro/serving/engine.py``).

* **PrefillRunner** — one coalesced prompt wave per call: LEFT-padded to
  a prompt bucket, batch padded up to a batch bucket, per
  ``(batch, prompt_len, masked, tier)``.  Left padding keeps the last real
  token in the last slot so one ``logits[:, -1]`` read works for every
  row; per-row RoPE positions and the attention length mask
  (``lm.forward(pad_lens=...)``) make real-token outputs match the
  unpadded forward.  Recurrent patterns (rwkv, Mamba) would carry pad
  tokens through their state, so they prefill at the exact prompt length.
* **DecodeRunner** — slot-batched continuous decode.  The decode cache's
  batch rows are *slots* with a free list: finished requests release their
  slots and newly admitted prompts join the *running* batch.  All slots
  share one decode clock T (a host int); a prompt prefilled at bucket
  width L joins at clock T by right-rolling its cache rows ``T - L`` slots
  (``lm.cache_install_rows(shift=T-L)``, written into the runner's own
  cache in place) so its last real token lands at slot T-1 and the roll garbage
  sits under the row's grown left pad, which the ``pad_lens`` mask already
  excludes.  Inactive slots carry the pad ``max_len + 1``, which masks
  every key.  The width grows along ``batch_buckets`` and resets when the
  runner drains idle.  A decode burst of N steps keeps its tokens,
  finiteness flags and sampling counters on the device and reads them back
  once, after the burst.  **StateDecodeRunner** serves position-free
  recurrent stacks (rwkv or Mamba with ``pos="none"``): states have no
  time axis, rows install directly and any prompt length joins at any time.
* **Scheduler** — admission: priority first, then earliest deadline, then
  FIFO; a ``(tier, prompt bucket)`` wave is due when it fills
  ``max_batch`` rows, waits past ``max_wait_s``, carries a deadline, or its
  tier's runner is mid-decode; requests past their deadline are evicted,
  queued or mid-decode, with ``DeadlineExceeded``.
* **Bucket mode** (``mode="bucket"``, and ``mode="auto"`` for patterns the
  continuous scheduler cannot serve, e.g. jamba's attention mixed with
  Mamba): the prefilled group decodes to completion before anything else is
  served (``Engine._execute``).
* **Precision tiers** — ``tiers={"quality": None, "balanced": plan}``:
  one engine, several precisions; tier is part of every bucket identity,
  each tier has its own decode runner, and each tier's tree is quantized
  lazily on first use.  A uniform ``w4a8`` plan with ``use_kernel=True``
  runs every projection of prefill and decode on the ``quant_matmul``
  kernel; a MoE layer's routed experts run on its batched launch, one per
  projection, and the ``pad_lens`` of every masked prefill wave and slot
  decode step keep pad and idle-slot rows out of routing and capacity.
  The served prefill and decode take the masked vanilla attention
  over the int8 cache, as in the reference; only
  ``lm.forward(mode="full")`` reaches the two-stage kernel.
* **Sampling** — per request, from an explicit ``torch.Generator``: in
  continuous mode ``enqueue(..., generator=g)`` draws one seed per row at
  enqueue, and the decode step samples on the device by Gumbel-max over a
  counter-based hash of (row seed, row step, vocabulary id)
  (:func:`sample_rows`), so a row draws the same tokens wherever its
  neighbours sit and no step reads anything back.  (The reference carries
  ``fold_in(key, row)`` streams; JAX keys cannot be reproduced in torch, so
  the port keeps the property, not the bits.)  Bucket mode samples the
  whole group from one generator with ``torch.multinomial``.
* **Robustness** — bounded admission (reject or shed), the degradation
  ladder over the tiers, seeded fault injection (``faults=``: the
  ``prefill.logits`` and ``decode.logits`` nan/inf sites, the ``prefill``
  and ``decode`` latency sites, the ``poll`` site and, in continuous
  mode, ``slot_alloc``), and the numeric quarantine: a request whose
  logits go non-finite fails alone with ``NumericFault`` (in continuous
  mode it is first re-queued once at ``numeric_retry_tier``, when set);
  co-batched requests are delivered.

``schedule=`` (a compiled ``KernelSchedule`` or a path to one) serves in
place of ``policy=``/``tiers=``: its plan sets each site's level, its
fusion decisions and launch tiles are read, not re-derived, its attention
tiles go on ``cfg.attn_tiles``, and its hash is part of every first-use
key.  ``compiles`` in the stats counts the first use of each
``(bucket, variant)`` — masked or unmasked prefill, greedy or sampled and
plain or fault-armed decode step — as in the port's ``VGGTEngine``: eager
PyTorch compiles nothing.  Results are numpy int32 ids, as in the
reference.  The engine runs on the CUDA device unless ``device`` says
otherwise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.model_quant import quantize_lm
from repro_torch.models import lm
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import batching, faults as faults_mod
from repro_torch.serving.batching import (
    DeadlineExceeded,
    NumericFault,
    QueueFull,
    next_pow2,
    pick_bucket,
)
from repro_torch.tree import to_device

__all__ = [
    "PrefillBucket",
    "DecodeBucket",
    "LMServeStats",
    "LMRequest",
    "PrefillRunner",
    "PrefillResult",
    "DecodeRunner",
    "StateDecodeRunner",
    "Scheduler",
    "Engine",
    "gumbel_rows",
    "sample_rows",
]

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8)
MIN_PROMPT_BUCKET = 8


@dataclasses.dataclass(frozen=True)
class PrefillBucket(batching.Bucket):
    """One prefill shape: coalesced batch (padded up) x bucketed prompt
    length, per precision tier."""

    batch: int
    prompt_len: int
    tier: str = "default"

    AXES = ("b", "l")

    def __str__(self):
        s = f"prefill:b{self.batch}xl{self.prompt_len}"
        return s if self.tier == "default" else f"{self.tier}:{s}"


@dataclasses.dataclass(frozen=True)
class DecodeBucket(batching.Bucket):
    """One decode step shape: batch width only (the KV cache is always
    ``max_len`` wide), per precision tier."""

    batch: int
    tier: str = "default"

    AXES = ("b",)

    def __str__(self):
        s = f"decode:b{self.batch}"
        return s if self.tier == "default" else f"{self.tier}:{s}"


class LMServeStats(batching.ServeStats):
    """Per-bucket LM serving stats.  Prefill buckets count sequences and
    prompt tokens; decode buckets count per-step calls and *decode* tokens
    — ``batch x (n_steps - 1)``, because the first generated token comes
    out of prefill.  ``mode`` records the scheduler actually serving (with
    why, when ``mode="auto"`` resolved to bucket mode)."""

    unit = "seqs"
    kind = "lm"

    def __init__(self, mode: str = "bucket"):
        super().__init__()
        self.mode = mode

    def _sum(self, kind, attr) -> float:
        return sum(getattr(s, attr) for b, s in self.buckets.items() if isinstance(b, kind))

    @property
    def prefill_s(self) -> float:
        return self._sum(PrefillBucket, "total_s")

    @property
    def decode_s(self) -> float:
        return self._sum(DecodeBucket, "total_s")

    @property
    def prefill_tokens(self) -> int:
        return int(self._sum(PrefillBucket, "tokens"))

    @property
    def decode_tokens(self) -> int:
        return int(self._sum(DecodeBucket, "tokens"))

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s > 0 else 0.0

    def summary(self) -> dict:
        return {**super().summary(), "mode": self.mode}

    def format(self) -> str:
        counters = ", ".join(f"{k}={v}" for k, v in self.scheduler.summary().items())
        return f"scheduler: {self.mode} ({counters})\n" + super().format()


@dataclasses.dataclass
class LMRequest(batching.PendingRequest):
    """A queued generation request; ``result()`` returns the generated ids
    (numpy int32) — [n_steps] for a single prompt, [b, n_steps] for a
    batch."""

    prompts: torch.Tensor  # [b, l] int64 on the engine's device
    n_steps: int
    squeeze: bool = False  # enqueued as a single [l] prompt
    tier: str = "default"  # precision tier (engine ``tiers`` key)
    L: int = 0  # bucketed prompt length (admission group key)
    seeds: Optional[np.ndarray] = None  # [b] int64 per-row sampling seeds; None = greedy
    retries: int = 0  # numeric-quarantine retries consumed

    @property
    def greedy(self) -> bool:
        return self.seeds is None


@dataclasses.dataclass
class PrefillResult:
    """One prefilled prompt wave, ready for decode."""

    cache: Any  # decode cache, bb rows, pos = L
    logits_last: torch.Tensor  # [bb, V] last-slot logits
    pad_lens: torch.Tensor  # [bb] (slack rows padded to L)
    pads: list[int]  # per *real* row left pad
    n_real: int
    bb: int
    L: int
    masked: bool
    ok_rows: np.ndarray = None  # [n_real] bool: last-slot logits all finite


class PrefillRunner:
    """Runs one coalesced prompt wave through the bucketed prefill and
    hands the filled cache and last-token logits to the decode loop."""

    def __init__(self, eng: "Engine"):
        self.eng = eng

    def run(self, reqs: list[LMRequest], L: int, tier: str) -> PrefillResult:
        """One wave: a ``prefill.call`` span (labels ``rows`` and ``tokens``:
        the real rows and prompt tokens) with ``assemble``, ``init_cache``,
        ``model`` and ``readback`` children."""
        n_real = sum(r.prompts.shape[0] for r in reqs)
        n_prompt_toks = sum(r.prompts.shape[0] * r.prompts.shape[1] for r in reqs)
        with obs_trace.span("prefill.call", rows=n_real, tokens=n_prompt_toks, tier=tier):
            return self._call(reqs, L, tier, n_real, n_prompt_toks)

    def _call(self, reqs: list[LMRequest], L: int, tier: str, n_real: int,
              n_prompt_toks: int) -> PrefillResult:
        eng = self.eng
        if eng._injector is not None:
            eng._injector.sleep("prefill")
        params = eng.tier_params(tier)
        dev = eng.device
        bb = eng.batch_bucket(n_real)

        with obs_trace.span("assemble"):
            parts, pads = [], []
            for r in reqs:
                x = r.prompts
                pad = L - x.shape[1]
                if pad:
                    x = torch.nn.functional.pad(x, (pad, 0))  # LEFT pad (see module doc)
                parts.append(x)
                pads += [pad] * x.shape[0]
            # only real length padding needs the masked variant — batch-slack
            # rows are garbage in, garbage out and get sliced off regardless
            masked = any(p > 0 for p in pads)
            real_pads = list(pads)
            if n_real < bb:
                parts.append(torch.zeros((bb - n_real, L), dtype=torch.long, device=dev))
                pads += [L] * (bb - n_real)
            toks = torch.cat(parts, dim=0)
            pad_lens = torch.tensor(pads, dtype=torch.long, device=dev)

        pbucket = PrefillBucket(bb, L, tier)
        eng._note_first_use(pbucket, masked)
        with obs_trace.span("init_cache"):
            cache = lm.init_cache(eng.cfg, bb, eng.max_len, device=dev)
        t0 = time.perf_counter()
        with obs_trace.span("model", parts=True, bucket=str(pbucket)), torch.inference_mode():
            logits, cache = lm.forward(eng.cfg, params, toks, cache=cache, mode="prefill",
                                       pad_lens=pad_lens if masked else None)
            lg_last = logits[:, -1]
            del logits
            eng._sync()
        dt = time.perf_counter() - t0
        ps = eng.stats.bucket(pbucket)
        ps.calls += 1
        ps.items += n_real
        ps.padded_items += bb - n_real
        ps.tokens += n_prompt_toks
        ps.total_s += dt
        ps.latencies_s.append(dt)
        for r in reqs:
            obs_trace.emit("prefill", request=r.req_id, dur_s=dt, bucket=str(pbucket),
                           tier=tier, rows=r.prompts.shape[0])
        if eng._injector is not None:  # host-side prefill.logits fault sites
            i0 = 0
            for r in reqs:
                b = r.prompts.shape[0]
                v = eng._injector.activation("prefill.logits", r.req_id)
                if v is not None:
                    lg_last = lg_last.clone()
                    lg_last[i0:i0 + b] += v
                i0 += b
        # per-row finiteness feeds the numeric quarantine: a NaN/Inf row
        # fails only its own request; batch-slack rows are garbage by design
        with obs_trace.span("readback"):
            ok_rows = torch.isfinite(lg_last).all(dim=-1)[:n_real].cpu().numpy()
        return PrefillResult(cache=cache, logits_last=lg_last, pad_lens=pad_lens,
                             pads=real_pads, n_real=n_real, bb=bb, L=L, masked=masked,
                             ok_rows=ok_rows)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply rounds) of int64 tensors
    holding values in [0, 2^32).  The multipliers are under 2^31, so no
    product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def gumbel_rows(seeds: torch.Tensor, steps: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, vocab] f32 Gumbel noise ``-log(-log(u))``, with uniforms from a
    counter-based hash of (``seeds[b]``, ``steps[b]``, vocabulary id):
    ``seeds``/``steps`` are [B] int64, on the device the noise is made on."""
    row = _mix32((seeds & _M32) ^ _mix32(steps & _M32))[:, None]
    vid = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    h = _mix32(_mix32(row ^ vid) ^ row)
    u = ((h >> 8).to(torch.float32) + 0.5) * 2.0**-24  # in (0, 1), 24 bits
    return -torch.log(-torch.log(u))


def sample_rows(logits: torch.Tensor, seeds: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """One token per row from ``softmax(logits)`` [B, V] by Gumbel-max over
    :func:`gumbel_rows`: a row's draw at its step depends on nothing else,
    so it is the same wherever the row sits in a batch, and nothing is read
    back.  ``seeds``/``steps``: [B] int64 on the logits' device."""
    g = gumbel_rows(seeds, steps, logits.shape[-1])
    return torch.argmax(logits.to(torch.float32) + g, dim=-1)


def _draw_seeds(generator: torch.Generator, rows: int) -> np.ndarray:
    """One 32-bit sampling seed per prompt row, drawn from ``generator``."""
    return torch.randint(0, 2**32, (rows,), generator=generator, device=generator.device,
                         dtype=torch.int64).cpu().numpy()


# ---------------------------------------------------------------------------
# continuous decode
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Active:
    """One request occupying decode slots from admission to completion."""

    req: LMRequest
    rows: list[int]  # slot ids, one per prompt row
    tok0: np.ndarray  # [b] first generated token (from prefill)
    remaining: int  # decode steps still to run (n_steps - 1 at admission)
    start_step: int  # runner.global_step at admission


class DecodeRunner:
    """Slot-batched continuous decode for attention-pattern configs.

    The runner owns one decode cache whose batch rows are request slots: a
    free list hands finished requests' slots to new admissions, the width
    grows along the ``batch_buckets`` ladder as occupancy demands (and
    resets when the runner drains idle), and every step runs one token for
    *all* slots — inactive slots carry a fully masking pad (``max_len + 1``)
    so their garbage never reaches a real row (nothing in the step reduces
    across rows).  All slots share one clock; per-slot logical positions
    live in ``pads`` (see the module docstring for the roll-install
    alignment argument).

    Per-slot host vectors (numpy) are sent to the device once a burst;
    ``step_log`` holds each global step's [width] tokens on the host, read
    back once a burst."""

    def __init__(self, eng: "Engine", tier: str):
        self.eng = eng
        self.tier = tier
        self.capacity = eng.batch_buckets[-1]
        self.width = 0  # slot width (0 = idle, no cache)
        self.cache: Optional[dict] = None
        self.clock = 0  # shared physical decode position
        self.active: list[_Active] = []
        self.slot_req: list[Optional[_Active]] = []
        self._reset_vectors()
        self.log_base = 0  # global step of step_log[0]
        self.global_step = 0

    def _reset_vectors(self) -> None:
        self.pads = np.zeros((0,), np.int64)
        self.tok = np.zeros((0,), np.int64)
        self.seeds = np.zeros((0,), np.int64)  # per-slot sampling seed
        self.ctr = np.zeros((0,), np.int64)  # per-slot sampling step of the next draw
        self.greedy = np.ones((0,), bool)
        self.step_log: list[np.ndarray] = []  # per global step: [width] tokens

    # -- config hooks the state-cache variant overrides -----------------

    @property
    def inactive_pad(self) -> int:
        return self.eng.max_len + 1  # masks every key slot

    def joinable(self, req: LMRequest, L: int) -> bool:
        """A prompt can join a *running* batch iff its bucketed length fits
        under the shared clock (the clock grows one slot per step, so longer
        prompts become joinable later) and its generation still fits the
        cache from the current clock."""
        if not self.width:
            return True
        return L <= self.clock and self.clock + req.n_steps - 1 <= self.eng.max_len

    def _install_shift(self, L: int) -> int:
        return self.clock - L

    def _on_first_wave(self, L: int) -> None:
        self.clock = L
        self.cache = lm.cache_set_clock(self.eng.cfg, self.cache, L)

    def _slot_pad(self, prefill_pad: int, shift: int) -> int:
        return prefill_pad + shift

    # -- slot bookkeeping ------------------------------------------------

    @property
    def active_rows(self) -> int:
        return sum(len(a.rows) for a in self.active)

    def _free_rows(self) -> int:
        free = sum(1 for a in self.slot_req if a is None)
        return free + max(0, self.capacity - self.width)

    def _grow(self, new_width: int) -> None:
        eng = self.eng
        if self.cache is None:
            self.cache = lm.init_cache(eng.cfg, new_width, eng.max_len, device=eng.device)
        else:
            self.cache = lm.cache_resize(eng.cfg, self.cache, new_width)
        extra = new_width - self.width
        self.slot_req += [None] * extra
        self.pads = np.concatenate([self.pads, np.full((extra,), self.inactive_pad, np.int64)])
        self.tok = np.concatenate([self.tok, np.zeros((extra,), np.int64)])
        self.seeds = np.concatenate([self.seeds, np.zeros((extra,), np.int64)])
        self.ctr = np.concatenate([self.ctr, np.zeros((extra,), np.int64)])
        self.greedy = np.concatenate([self.greedy, np.ones((extra,), bool)])
        # step-log entries are [old_width]; completed columns of surviving
        # requests must stay readable after growth
        self.step_log = [np.pad(t, (0, extra)) for t in self.step_log]
        self.width = new_width

    def _reset_idle(self) -> None:
        self.width = 0
        self.cache = None
        self.clock = 0
        self.slot_req = []
        self._reset_vectors()
        self.log_base = self.global_step

    # -- admission -------------------------------------------------------

    def admit(self, reqs: list[LMRequest], L: int, reason: str) -> list[LMRequest]:
        """Admit as many of the wave's requests as fit (free slots plus
        ladder growth room; an oversize wave is allowed onto an idle
        runner, as the bucket engine runs an oversize group alone).
        Returns the admitted requests, already prefilled and — for
        multi-step requests — installed into decode slots.  ``reason``:
        why the scheduler released the wave (``batching.FLUSH_REASONS``)."""
        eng = self.eng
        was_running = self.active_rows > 0
        budget = self._free_rows()
        take, rows = [], 0
        for r in reqs:
            b = r.prompts.shape[0]
            if take and rows + b > budget:
                break
            if not take and b > budget and was_running:
                break  # oversize joins only an idle runner
            if not self.joinable(r, L):
                continue
            take.append(r)
            rows += b
            if rows >= budget:
                break
        if not take:
            return []

        batching.emit_flush(reason, take, rows)
        for r in take:
            obs_trace.emit("admit", request=r.req_id, tier=self.tier, prompt_len=L,
                           mid_decode=was_running)
        pre = eng._prefill.run(take, L, self.tier)
        row_of, base = {}, 0
        for r in take:
            row_of[id(r)] = base
            base += r.prompts.shape[0]
        tok0 = self._first_tokens(pre, take, row_of)

        # numeric quarantine at admission: a request whose prefill logits
        # came back non-finite never reaches a decode slot — it fails (or
        # re-queues at the retry tier) here; co-prefilled requests continue
        bad_ids: set[int] = set()
        if not pre.ok_rows.all():
            for r in take:
                i0 = row_of[id(r)]
                if not pre.ok_rows[i0:i0 + r.prompts.shape[0]].all():
                    bad_ids.add(id(r))
                    eng._numeric_fault(r, phase="prefill")

        slot_reqs = [r for r in take if r.n_steps > 1 and id(r) not in bad_ids]
        if slot_reqs:
            need = sum(r.prompts.shape[0] for r in slot_reqs)
            if not self.width:
                self._grow(pick_bucket(eng.batch_buckets, need))
                self._on_first_wave(L)
            free = [i for i in range(self.width) if self.slot_req[i] is None]
            if need > len(free):
                self._grow(pick_bucket(eng.batch_buckets, self.width + need - len(free)))
                free = [i for i in range(self.width) if self.slot_req[i] is None]
            shift = self._install_shift(L)
            dst_rows, src_rows = [], []
            fi = 0
            for r in slot_reqs:
                b = r.prompts.shape[0]
                slots = free[fi:fi + b]
                fi += b
                i0 = row_of[id(r)]
                a = _Active(req=r, rows=slots, tok0=tok0[i0:i0 + b],
                            remaining=r.n_steps - 1, start_step=self.global_step)
                self.active.append(a)
                for j, s in enumerate(slots):
                    self.slot_req[s] = a
                    self.pads[s] = self._slot_pad(pre.pads[i0 + j], shift)
                    self.tok[s] = tok0[i0 + j]
                    self.seeds[s] = 0 if r.greedy else r.seeds[j]
                    self.ctr[s] = 1  # step 0 drew the first token
                    self.greedy[s] = r.greedy
                    dst_rows.append(s)
                    src_rows.append(i0 + j)
            self.cache = lm.cache_install_rows(
                eng.cfg, self.cache, pre.cache, dst_rows, src_rows,
                shift=shift if eng.pad_prompts else 0,
            )

        # single-token requests complete at prefill, never occupy a slot
        for r in take:
            if r.n_steps == 1 and id(r) not in bad_ids:
                b = r.prompts.shape[0]
                ids = tok0[row_of[id(r)]:row_of[id(r)] + b][:, None].astype(np.int32)
                r._deliver(ids[0] if r.squeeze else ids)

        sched = eng.stats.scheduler
        sched.admitted += len(take)
        if was_running:
            sched.admitted_mid_decode += len(take)
        return take

    def _first_tokens(self, pre: PrefillResult, take: list[LMRequest],
                      row_of: dict[int, int]) -> np.ndarray:
        """First generated token per real row: greedy argmax, or a sampled
        row's draw at its step 0 (:func:`sample_rows`).  One readback."""
        lg = pre.logits_last[:pre.n_real]
        tok = torch.argmax(lg, dim=-1)
        sampled = [r for r in take if not r.greedy]
        if sampled:
            seeds = np.zeros((pre.n_real,), np.int64)
            greedy = np.ones((pre.n_real,), bool)
            for r in sampled:
                i0 = row_of[id(r)]
                seeds[i0:i0 + r.prompts.shape[0]] = r.seeds
                greedy[i0:i0 + r.prompts.shape[0]] = False
            dev = lg.device
            st = sample_rows(lg, torch.from_numpy(seeds).to(dev),
                             torch.zeros(pre.n_real, dtype=torch.long, device=dev))
            tok = torch.where(torch.from_numpy(greedy).to(dev), tok, st)
        return tok.cpu().numpy().astype(np.int64)

    # -- stepping --------------------------------------------------------

    def run_steps(self, max_steps: int) -> int:
        """One bounded decode burst for every occupied slot.  Returns the
        number of steps run (0 when idle)."""
        if not self.active:
            return 0
        eng = self.eng
        n = min(max_steps, max(a.remaining for a in self.active))
        if n <= 0:
            return 0
        inj = eng._injector
        if inj is not None:
            inj.sleep("decode")
        params = eng.tier_params(self.tier)
        sampled = bool((~self.greedy).any())
        bucket = DecodeBucket(self.width, self.tier)
        eng._note_first_use(bucket, ("slot", sampled, inj is not None))
        # one host-to-device copy of the per-slot vectors for the burst
        host = np.stack([self.tok, self.pads, self.seeds, self.ctr, self.greedy])
        dv = torch.from_numpy(host.astype(np.int64)).to(eng.device)
        tok, pad, seeds, ctr, grd = dv[0], dv[1], dv[2], dv[3], dv[4].bool()
        burst_tokens = sum(min(n, a.remaining) * len(a.rows) for a in self.active)

        # a fault plan's inject vectors for the whole burst: one more copy
        inject = (torch.from_numpy(np.stack([self._inject_vector(inj, i) for i in range(n)]))
                  .to(eng.device) if inj is not None else None)
        # tokens and per-row finiteness stay on the device across the burst
        # and are read back once after it: the quarantine signal costs no
        # extra host round trip
        toks, oks = [], []
        t0 = time.perf_counter()
        with obs_trace.span("decode_burst", bucket=str(bucket), steps=n,
                            active=len(self.active), width=self.width), \
                torch.inference_mode():
            for i in range(n):
                tok, self.cache, ok = eng._slot_step(
                    params, tok, self.cache, pad, grd,
                    (seeds, ctr + i) if sampled else None,
                    inject[i] if inject is not None else None)
                toks.append(tok)
                oks.append(ok)
            out = torch.cat([torch.stack(toks), torch.stack(oks).long()]).cpu().numpy()
            if eng.device.type == "cuda":  # the readback synchronized
                obs_trace.anchor()
        dt = time.perf_counter() - t0

        ds = eng.stats.bucket(bucket)
        ds.calls += n
        ds.tokens += burst_tokens
        ds.total_s += dt
        ds.latencies_s.append(dt / n)
        sched = eng.stats.scheduler
        sched.occupied_slot_steps += burst_tokens
        sched.capacity_slot_steps += self.width * n

        # copies: admission writes new requests' rows into these vectors
        self.step_log.extend(np.array(out[i]) for i in range(n))
        self.tok = np.array(out[n - 1])
        self.ctr = self.ctr + n
        self.global_step += n
        self.clock += n
        # quarantine before completion: a request whose rows went non-finite
        # must fail (or re-queue at the retry tier), never deliver garbage
        # tokens.  Each request is judged only on the burst steps it used
        # (min(n, remaining)): a row that finished mid-burst keeps stepping
        # as filler and its later logits do not count.
        okm = out[n:].astype(bool)  # [n, width]
        for a in list(self.active):
            used = min(n, a.remaining)
            if not okm[:used, np.asarray(a.rows)].all():
                self._release(a)
                eng._numeric_fault(a.req, phase="decode")
        for a in list(self.active):
            a.remaining -= n
            if a.remaining <= 0:
                self._complete(a)
        self._trim_log()
        if not self.active:
            self._reset_idle()
        return n

    def _inject_vector(self, inj, burst_i: int) -> np.ndarray:
        """[width] additive fault vector for one burst step: 0.0 for
        untargeted rows (``x + 0.0`` keeps survivor tokens bit-exact),
        NaN/Inf on the rows of a request whose ``decode.logits`` spec fires
        at its request-relative decode step."""
        vec = np.zeros((self.width,), np.float32)
        for a in self.active:
            rel = (a.req.n_steps - 1 - a.remaining) + burst_i
            v = inj.activation("decode.logits", a.req.req_id, step=rel)
            if v is not None:
                vec[np.asarray(a.rows)] = v
        return vec

    def _complete(self, a: _Active) -> None:
        r = a.req
        lo = a.start_step - self.log_base
        gen = np.stack(self.step_log[lo:lo + r.n_steps - 1], axis=1)[np.asarray(a.rows)]
        ids = np.concatenate([a.tok0[:, None], gen], axis=1).astype(np.int32)
        self.eng.stats.bucket(DecodeBucket(self.width, self.tier)).items += len(a.rows)
        self._release(a)
        obs_trace.emit("decode", request=r.req_id, tier=self.tier, steps=r.n_steps - 1,
                       rows=len(a.rows))
        r._deliver(ids[0] if r.squeeze else ids)

    def evict(self, a: _Active, err: BaseException) -> None:
        """Mid-decode eviction (deadline miss, abort): fail the request and
        hand its slots back to the free list."""
        self._release(a)
        a.req._fail(err)
        if not self.active:
            self._reset_idle()

    def _release(self, a: _Active) -> None:
        for s in a.rows:
            self.slot_req[s] = None
            self.pads[s] = self.inactive_pad
            self.greedy[s] = True
        self.active.remove(a)

    def _trim_log(self) -> None:
        keep_from = min((a.start_step for a in self.active), default=self.global_step)
        drop = min(keep_from - self.log_base, len(self.step_log))
        if drop > 0:
            del self.step_log[:drop]
            self.log_base += drop


class StateDecodeRunner(DecodeRunner):
    """Continuous decode for position-free recurrent stacks (rwkv or Mamba
    with ``pos="none"``).  Recurrent states have no time axis: prefilled rows
    install directly, any prompt length joins a running batch at any time,
    and the shared clock and pads degenerate to plain row bookkeeping (the
    step runs without ``pad_lens``; rows are independent)."""

    @property
    def inactive_pad(self) -> int:
        return 0  # pads are unused: the step passes pad_lens=None

    def joinable(self, req: LMRequest, L: int) -> bool:
        return True

    def _install_shift(self, L: int) -> int:
        return 0

    def _on_first_wave(self, L: int) -> None:
        self.clock = 0

    def _slot_pad(self, prefill_pad: int, shift: int) -> int:
        return 0


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


def _attention_only(cfg: ModelConfig) -> bool:
    return all(k == "attn" for k in cfg.pattern)


class Scheduler:
    """Admission control for continuous serving: one pending queue, one
    decode runner per precision tier.

    Candidates are ordered (priority desc, deadline asc, FIFO); a wave — all
    pending requests sharing one ``(tier, prompt-bucket)`` group — is
    admitted when the group fills ``max_batch`` rows, its oldest request
    passes ``max_wait_s``, any member carries a deadline, or the tier's
    runner is already mid-decode (joining a running batch needs no
    coalescing wait).  Expired requests are evicted before every admission
    pass, queued or mid-decode."""

    def __init__(self, eng: "Engine"):
        self.eng = eng
        self._pending: list[LMRequest] = []
        self._runners: dict[str, DecodeRunner] = {}

    def runner(self, tier: str) -> DecodeRunner:
        r = self._runners.get(tier)
        if r is None:
            cls = DecodeRunner if _attention_only(self.eng.cfg) else StateDecodeRunner
            r = self._runners[tier] = cls(self.eng, tier)
        return r

    @property
    def pending(self) -> int:
        return len(self._pending)

    @property
    def active_rows(self) -> int:
        return sum(r.active_rows for r in self._runners.values())

    def add(self, req: LMRequest) -> None:
        self._pending.append(req)
        group = (req.tier, req.L)
        rows = sum(r.prompts.shape[0] for r in self._pending if (r.tier, r.L) == group)
        if rows >= self.eng.max_batch:
            # group full: serve it to completion synchronously (the bucket
            # engine's auto-flush contract)
            targets = [r for r in self._pending if (r.tier, r.L) == group]
            self.drain(targets=targets, only_group=group, reason="full")

    def poll(self) -> int:
        """One bounded scheduling turn: evict expired requests, admit due
        waves, then run at most ``decode_steps_per_poll`` decode steps per
        runner.  Returns the number of requests admitted."""
        now = time.perf_counter()
        self.evict_expired(now)
        admitted = self.admit(now)
        for r in self._runners.values():
            r.run_steps(self.eng.decode_steps_per_poll)
        return admitted

    def drain(self, targets: Optional[list[LMRequest]] = None,
              only_group: Optional[tuple] = None, reason: str = "drain") -> None:
        """Force-admit and step until ``targets`` (or everything) is done.
        Deadlines still apply — an expired request resolves with
        ``DeadlineExceeded``, which counts as done.  ``reason`` labels the
        waves it releases (``batching.FLUSH_REASONS``)."""
        while True:
            if targets is not None and all(r.ready for r in targets):
                return
            if targets is None and not self._pending and self.active_rows == 0:
                return
            now = time.perf_counter()
            self.evict_expired(now)
            n_adm = self.admit(now, force=True, only_group=only_group, reason=reason)
            n_steps = sum(r.run_steps(self.eng.decode_steps_per_poll)
                          for r in self._runners.values())
            if not n_adm and not n_steps:
                if targets is not None and all(r.ready for r in targets):
                    return
                if not self._pending and self.active_rows == 0:
                    return
                raise RuntimeError(
                    "scheduler stalled: pending work but no admission or decode progress")

    # -- admission pass --------------------------------------------------

    @staticmethod
    def _order(reqs: list[LMRequest]) -> list[LMRequest]:
        inf = float("inf")
        return sorted(reqs, key=lambda r: (
            -r.priority,
            r.t_enqueue + r.deadline_s if r.deadline_s is not None else inf,
            r.t_enqueue,
        ))

    def _due(self, wave: list[LMRequest], runner: DecodeRunner, now: float) -> Optional[str]:
        """Why the wave is due now (a ``batching.FLUSH_REASONS`` entry), or None."""
        if sum(r.prompts.shape[0] for r in wave) >= self.eng.max_batch:
            return "full"
        if now - min(r.t_enqueue for r in wave) >= self.eng.max_wait_s:
            return "deadline"
        if any(r.deadline_s is not None for r in wave):
            return "sla"  # SLA traffic admits immediately
        return "join" if runner.active_rows > 0 else None  # join the running batch

    def admit(self, now: float, force: bool = False,
              only_group: Optional[tuple] = None, reason: str = "drain") -> int:
        """Admit every due wave (with ``force``, every wave, released for
        ``reason``); returns the requests admitted."""
        if not self._pending:
            return 0
        admitted = 0
        seen: set[tuple] = set()
        for r in self._order(self._pending):
            group = (r.tier, r.L)
            if group in seen or r.ready:
                continue
            seen.add(group)
            if only_group is not None and group != only_group:
                continue
            wave = [q for q in self._order(self._pending)
                    if (q.tier, q.L) == group and not q.ready]
            runner = self.runner(r.tier)
            why = reason if force else self._due(wave, runner, now)
            if why is None:
                continue
            inj = self.eng._injector
            if inj is not None:
                # injected slot-allocation failures: the doomed request fails
                # at admission, the rest of the wave is served normally
                for q in [q for q in wave if inj.alloc_fails(q.req_id)]:
                    q._fail(faults_mod.InjectedFault(
                        "injected decode-slot allocation failure at admission"))
                    self._pending.remove(q)
                    wave.remove(q)
                if not wave:
                    continue
            taken = runner.admit(wave, r.L, why)
            admitted += len(taken)
            for q in taken:
                self._pending.remove(q)
        return admitted

    # -- eviction / abort ------------------------------------------------

    def evict_expired(self, now: Optional[float] = None) -> int:
        now = time.perf_counter() if now is None else now
        n = 0
        for r in [q for q in self._pending if q.expired(now)]:
            r._fail(DeadlineExceeded(f"request missed its {r.deadline_s:.3f}s deadline while "
                                     "queued"))
            self._pending.remove(r)
            n += 1
        for runner in self._runners.values():
            for a in [a for a in list(runner.active) if a.req.expired(now)]:
                runner.evict(a, DeadlineExceeded(
                    f"request missed its {a.req.deadline_s:.3f}s deadline mid-decode and was "
                    "evicted from the batch"))
                n += 1
        self.eng.stats.scheduler.deadline_evictions += n
        return n

    def abort_all(self, err: BaseException) -> int:
        n = len(self._pending)
        for r in self._pending:
            r._fail(err)
        self._pending.clear()
        for runner in self._runners.values():
            for a in list(runner.active):
                runner.evict(a, err)
                n += 1
        return n


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class Engine:
    """Continuous (or bucketed) LM prefill/decode serving — see the module
    docstring.  Implements the ``batching.ServingEngine`` protocol.

        eng = Engine(cfg, params, tiers={"quality": None, "balanced": plan},
                     max_len=2048)
        ids = eng.generate(prompts, n_steps=32)        # one call
        reqs = [eng.enqueue(p, 32) for p in prompts]   # micro-batched
        eng.flush()
        outs = [r.result() for r in reqs]

    ``params`` is the raw ``lm.init_params`` tree; each tier's policy
    (``QuantPolicy``, ``PrecisionPlan``; None = full precision) is applied
    on the tier's first use, on the engine's device.

    ``mode``: "continuous" | "bucket" | "auto" (default).  Auto serves the
    continuous scheduler whenever the config supports it (attention-only
    patterns, or position-free recurrent ones, and token inputs) and bucket
    mode otherwise.  An ``embed_inputs`` config (a stub frontend, as
    paligemma-3b's) constructs in bucket mode, as the reference's does, and
    ``enqueue``/``generate`` refuse its embeddings: decode feeds generated
    ids back, not embeddings.
    Scheduling controls (continuous mode): ``enqueue(..., priority=2)``
    admits before lower-priority traffic; ``deadline_s=0.5`` evicts with
    ``DeadlineExceeded`` if unserved in time; ``tier="auto"`` with
    ``deadline_s`` picks the best declared tier whose measured latency fits.
    Sampling draws from an explicit ``torch.Generator``: per request in
    continuous mode (``enqueue(..., generator=g)``), per ``generate`` call
    in bucket mode, whose queue coalesces greedy requests only.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        max_len: int = 2048,
        policy: Optional[Any] = None,
        schedule: Optional[Any] = None,
        tiers: Optional[dict[str, Any]] = None,
        default_tier: Optional[str] = None,
        attn_impl: Optional[str] = None,
        prompt_buckets: Optional[tuple[int, ...]] = None,
        batch_buckets: tuple[int, ...] = DEFAULT_BATCH_BUCKETS,
        max_batch: Optional[int] = None,
        max_wait_s: float = 0.005,
        mode: str = "auto",
        decode_steps_per_poll: int = 8,
        max_pending: Optional[int] = None,
        max_queued_tokens: Optional[int] = None,
        admission: str = "reject",
        degrade: Optional[batching.DegradeConfig | bool] = None,
        numeric_retry_tier: Optional[str] = None,
        faults: Optional[faults_mod.FaultPlan | str] = None,
        device=None,
    ):
        if attn_impl is not None and attn_impl not in ("flash", "two_stage", "vanilla"):
            raise ValueError(f"attn_impl={attn_impl!r}: expected flash | two_stage | vanilla")
        if mode not in ("auto", "continuous", "bucket"):
            raise ValueError(f"mode={mode!r}: expected auto | continuous | bucket")
        self.device = batching.resolve_device(device, "Engine")
        if self.device.type == "cuda":
            # the float parts of the forward (fp tiers, the IDCT blocks, the
            # attention emulation, lm_head) are float32 work, which TF32
            # would round to ~3 decimal digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg.with_(attn_impl=attn_impl) if attn_impl is not None else cfg
        # A compiled KernelSchedule (or a path to one) replaces the implicit
        # policy: the walker reads its fusion decisions and launch tiles, and
        # its hash keys every bucket and slot first use.
        self.schedule, self._schedule_hash = batching.load_schedule(schedule)
        if self.schedule is not None:
            if policy is not None or tiers is not None:
                raise ValueError("pass either schedule= or policy=/tiers=, not both")
            policy = self.schedule
            targets = self.schedule.attention_targets()
            if targets:
                self.cfg = self.cfg.with_(attn_tiles=targets)
        self._raw = to_device(params, self.device)
        self._tierset = batching.TierSet(
            tiers=tiers, policy=policy, default_tier=default_tier,
            raw_params=self._raw, quantize=self._quantize,
        )
        self.tiers = self._tierset.tiers
        self.default_tier = self._tierset.default_tier
        self.policy = self._tierset.default_policy
        self.max_len = max_len
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.prompt_buckets = tuple(sorted(prompt_buckets)) if prompt_buckets else None
        self.max_batch = max_batch if max_batch is not None else self.batch_buckets[-1]
        self.max_wait_s = max_wait_s
        # prompt-length padding rides on the attention length mask; a
        # recurrent mixer would carry pad tokens through its state, so rwkv
        # and Mamba patterns get exact-length buckets (batch bucketing only)
        self.pad_prompts = _attention_only(cfg)
        self.decode_steps_per_poll = decode_steps_per_poll
        if mode == "continuous" and not self._continuous_ok():
            raise ValueError(
                "mode='continuous' needs an attention-only pattern or a position-free "
                f"recurrent pattern, got {cfg.pattern} (pos={cfg.pos!r})")
        reason = ""
        if mode == "auto":
            mode = "continuous" if self._continuous_ok() else "bucket"
            if mode == "bucket" and cfg.embed_inputs:
                reason = (" (mode='auto': decode feeds generated ids back; embed_inputs "
                          "stub frontends can't serve)")
            elif mode == "bucket":
                reason = (f" (mode='auto': pattern {cfg.pattern} with pos={cfg.pos!r} is "
                          "neither attention-only nor position-free recurrent)")
        self.mode = mode  # the mode that serves
        self.stats = LMServeStats(mode + reason)
        self._seen: set = set()
        self._prefill = PrefillRunner(self)
        self._sched = Scheduler(self)
        self._queue = batching.MicroBatchQueue(self._run, self.max_batch, max_wait_s)
        self._admission = batching.AdmissionController(
            max_pending=max_pending, max_queued_tokens=max_queued_tokens, policy=admission,
        )
        self._degrade = (
            batching.DegradationController(None if degrade is True else degrade, len(self.tiers))
            if degrade else None
        )
        if numeric_retry_tier is not None and numeric_retry_tier not in self.tiers:
            raise ValueError(f"numeric_retry_tier {numeric_retry_tier!r} not in tiers "
                             f"{sorted(self.tiers)}")
        self.numeric_retry_tier = numeric_retry_tier
        self._injector = faults_mod.FaultInjector(faults) if faults is not None else None

    @property
    def continuous(self) -> bool:
        return self.mode == "continuous"

    def _continuous_ok(self) -> bool:
        if self.cfg.embed_inputs:
            return False  # decode feeds ids back; stub frontends can't serve
        if _attention_only(self.cfg):
            return True
        # recurrent rows are independent, but the decode position is a
        # shared scalar: only position-free stacks can mix generation depths
        # in one batch
        return set(self.cfg.pattern) <= {"mamba", "rwkv"} and self.cfg.pos == "none"

    def _quantize(self, policy) -> Any:
        with torch.no_grad():
            return quantize_lm(self.cfg, self._raw, policy)

    def _sync(self) -> None:
        """Wait for the device, and anchor the trace's device intervals there."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            obs_trace.anchor()

    # ---- tiers -----------------------------------------------------------

    @property
    def params(self) -> Any:
        """The default tier's parameter tree (quantized lazily, like every
        other tier's)."""
        return self._tierset.params(None)

    def tier_params(self, tier: str) -> Any:
        """The tier's (lazily quantized) parameter tree."""
        return self._tierset.params(tier)

    def _tier(self, tier: Optional[str]) -> str:
        return self._tierset.resolve(tier)

    def _resolve_tier(self, tier: Optional[str], deadline_s: Optional[float]) -> str:
        pinned = tier is not None and tier != "auto"
        if tier == "auto" and "auto" not in self.tiers:
            t = self._autoselect_tier(deadline_s)
        else:
            t = self._tier(tier)
        # degradation ladder: under sustained pressure, *unpinned*
        # admissions downshift toward later-declared (cheaper) tiers
        if not pinned and self._degrade is not None and self._degrade.level > 0:
            names = list(self.tiers)
            base = names.index(t)
            down = min(base + self._degrade.level, len(names) - 1)
            if down != base:
                self.stats.scheduler.degraded_admissions += 1
                t = names[down]
        return t

    def _measured_latency(self) -> Optional[float]:
        try:
            return self.stats.mean_item_latency_s()
        except ValueError:
            return None  # no served traffic yet — no latency pressure

    @property
    def degradation_level(self) -> int:
        """Current degradation-ladder level (0 = no downshift)."""
        return self._degrade.level if self._degrade is not None else 0

    def _autoselect_tier(self, deadline_s: Optional[float]) -> str:
        """SLA-aware tier choice: the first declared tier whose measured
        per-request latency fits the deadline; the fastest measured tier
        when nothing fits; the default tier before any traffic."""
        if deadline_s is None:
            return self.default_tier
        measured: dict[str, float] = {}
        for t in self.tiers:
            try:
                measured[t] = self.stats.mean_item_latency_s(tier=t)
            except ValueError:
                continue  # tier never served — no evidence either way
        for t in self.tiers:
            if t in measured and measured[t] <= deadline_s:
                return t
        if measured:
            return min(measured, key=measured.get)
        return self.default_tier

    # ---- buckets ---------------------------------------------------------

    def batch_bucket(self, b: int) -> int:
        return pick_bucket(self.batch_buckets, b)

    def prompt_bucket(self, n: int) -> int:
        """Bucketed prompt length (an oversize prompt runs exact); the
        exact length for recurrent patterns (``pad_prompts`` False)."""
        if not self.pad_prompts:
            return n
        if self.prompt_buckets is not None:
            return pick_bucket(self.prompt_buckets, n)
        # never bucket BELOW the real length: an over-long prompt must
        # reach _check_fits with its true length and fail there
        return max(min(next_pow2(n, floor=MIN_PROMPT_BUCKET), self.max_len), n)

    def _bucket_len(self, n: int, n_steps: int) -> int:
        """Bucketed prompt length for a request; the exact length when
        only the padding would overflow the KV cache."""
        L = self.prompt_bucket(n)
        if L + n_steps - 1 > self.max_len and n + n_steps - 1 <= self.max_len:
            L = n
        return L

    def _check_fits(self, real_len: int, bucket_len: int, n_steps: int) -> None:
        # prefill fills bucket_len slots and each of the n_steps-1 decode
        # steps appends one more; reject an overflow before prefill
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        need = bucket_len + n_steps - 1
        if need > self.max_len:
            bucketed = f" (bucketed to {bucket_len})" if bucket_len != real_len else ""
            raise ValueError(
                f"prompt of length {real_len}{bucketed} + n_steps {n_steps} - 1 = {need} "
                f"exceeds the KV cache (max_len={self.max_len})"
            )

    def _note_first_use(self, bucket: batching.Bucket, variant) -> None:
        """Count the first use of ``(bucket, variant)`` in the bucket's
        ``compiles`` field (the reference's stats schema, where each is a
        compile; here "bucket first use"): a prefill's ``masked`` flag, a
        slot step's ``("slot", sampled, faulty)``, a bucket-mode decode
        step's ``masked``.  Each variant counts apart, and the key holds the
        schedule's hash."""
        key = (bucket, variant, self._schedule_hash)
        if key not in self._seen:
            self._seen.add(key)
            self.stats.bucket(bucket).compiles += 1

    def _slot_step(self, params, tok, cache, pad, greedy, sampling, inject):
        """One continuous decode step: ``decode_step``, the optional fault
        vector (``inject``, [width]; 0.0 leaves a row bit-exact), per-row
        finiteness of the logits (the quarantine signal), the next token
        (argmax, or :func:`sample_rows` for the rows with ``greedy``
        False when ``sampling`` = (seeds, steps) is given).  Nothing here is
        read back, and nothing reduces across rows."""
        logits, cache = lm.decode_step(self.cfg, params, tok, cache,
                                       pad_lens=pad if self.pad_prompts else None)
        lg = logits[:, 0]
        if inject is not None:
            lg = lg + inject[:, None]
        ok = torch.isfinite(lg).all(dim=-1)
        nxt = torch.argmax(lg, dim=-1)
        if sampling is not None:
            nxt = torch.where(greedy, nxt, sample_rows(lg, *sampling))
        return nxt, cache, ok

    # ---- request path ----------------------------------------------------

    def _as_prompts(self, prompts) -> torch.Tensor:
        return torch.as_tensor(np.asarray(prompts) if not isinstance(prompts, torch.Tensor)
                               else prompts).to(device=self.device, dtype=torch.long)

    def enqueue(
        self,
        prompts,
        n_steps: int,
        tier: Optional[str] = None,
        *,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ) -> LMRequest:
        """Queue a prompt ([l] ints) or same-length prompt batch ([b, l]).

        ``tier`` selects the precision tier ("auto" + ``deadline_s``
        autoselects by measured latency); requests only coalesce within
        their tier and bucketed length.  ``priority`` (higher admits first)
        and ``deadline_s`` (evict with ``DeadlineExceeded`` if unserved in
        time; in continuous mode it also admits the request without a
        coalescing wait) order the queue.  ``generator`` samples the
        request (one seed per row is drawn from it here; continuous mode
        only), greedy when None.

        With admission bounds (``max_pending`` / ``max_queued_tokens``) an
        over-full queue raises :class:`~repro_torch.serving.batching.QueueFull`
        (policy "reject") or sheds the least-valuable queued requests
        (policy "shed")."""
        if generator is not None and not self.continuous:
            raise ValueError(
                "per-request sampling generators need the continuous scheduler "
                "(mode='continuous'); the bucket engine only coalesces greedy requests")
        if self._degrade is not None:
            self._degrade.observe(self.pending, self._measured_latency())
        tier = self._resolve_tier(tier, deadline_s)
        prompts = self._as_prompts(prompts)
        squeeze = prompts.ndim == 1
        if squeeze:
            prompts = prompts[None, :]
        if prompts.ndim != 2:
            raise ValueError(
                f"prompts must be [l] or [b, l] token ids, got {tuple(prompts.shape)}"
                + (" (embed_inputs stub frontends are not servable: decode feeds generated "
                   "ids back, not embeddings)" if self.cfg.embed_inputs else ""))
        L = self._bucket_len(prompts.shape[1], n_steps)
        self._check_fits(prompts.shape[1], L, n_steps)
        req = LMRequest(prompts=prompts, n_steps=n_steps, squeeze=squeeze, tier=tier, L=L,
                        seeds=None if generator is None else _draw_seeds(generator,
                                                                         prompts.shape[0]),
                        priority=priority, deadline_s=deadline_s)
        if self._admission.bounded:
            try:
                victims = self._admission.check(
                    req, self._pending_list(), self._req_tokens, self.stats.scheduler,
                )
            except QueueFull:
                obs_trace.emit("rejected", request=req.req_id, kind="lm", tier=tier)
                raise
            for v in victims:
                self._drop_pending(v)
                v._fail(QueueFull(
                    "request shed from the pending queue to admit "
                    "higher-priority traffic under overload"
                ))
        if self._injector is not None:
            self._injector.on_enqueue(req)
        obs_trace.emit("enqueue", request=req.req_id, kind="lm", tier=tier, prompt_len=L,
                       rows=prompts.shape[0], n_steps=n_steps, priority=priority)
        if self.continuous:
            self._sched.add(req)
        else:
            self._queue.add((tier, L), req, prompts.shape[0])
        return req

    @property
    def pending(self) -> int:
        """Requests waiting for admission."""
        return self._sched.pending if self.continuous else self._queue.pending

    @property
    def active(self) -> int:
        """Decode-slot rows currently mid-generation (continuous mode)."""
        return self._sched.active_rows if self.continuous else 0

    def _pending_list(self) -> list[LMRequest]:
        if self.continuous:
            return list(self._sched._pending)
        return [r for q in self._queue._queues.values() for r, _ in q]

    def _drop_pending(self, r: LMRequest) -> None:
        if self.continuous:
            self._sched._pending.remove(r)
        else:
            self._queue.remove(r)

    @staticmethod
    def _req_tokens(r: LMRequest) -> int:
        """Queued work size for ``max_queued_tokens``: prompt-bucket plus
        generation tokens across the request's rows."""
        return r.prompts.shape[0] * (r.L + r.n_steps)

    def _numeric_fault(self, req: LMRequest, phase: str) -> None:
        """Quarantine one request whose logits went non-finite: one bounded
        retry at ``numeric_retry_tier`` (continuous mode: a higher precision
        should clear a saturation blow-up), else fail with
        :class:`NumericFault`.  The caller has already released any decode
        slots the request held."""
        sched = self.stats.scheduler
        sched.numeric_faults += 1
        obs_trace.emit("numeric_fault", request=req.req_id, tier=req.tier, stage=phase)
        retry = self.numeric_retry_tier
        if self.continuous and retry is not None and retry != req.tier and req.retries < 1:
            req.retries += 1
            req.tier = retry
            sched.numeric_retries += 1
            obs_trace.emit("numeric_retry", request=req.req_id, tier=retry)
            # the scheduler's next admission pass (or drain) picks it up
            self._sched._pending.append(req)
            return
        req._fail(NumericFault(
            f"request produced non-finite activations during {phase} at tier {req.tier!r} "
            "and was quarantined (co-batched requests are unaffected)"
        ))

    def poll(self) -> int:
        """One scheduling turn.  Continuous: evict expired requests, admit
        due waves into the running batch, run a bounded decode burst;
        returns requests admitted.  Bucket: evict expired requests, flush
        groups past the coalescing deadline; returns groups flushed."""
        if self._injector is not None:
            self._injector.crash("poll")
            self._injector.sleep("poll")
        if self._degrade is not None:
            self._degrade.observe(self.pending, self._measured_latency())
        if self.continuous:
            return self._sched.poll()
        self._queue.evict_expired(stats=self.stats.scheduler)
        return self._queue.poll()

    def flush(self) -> None:
        """Serve every pending request to completion."""
        if self.continuous:
            self._sched.drain()
        else:
            self._queue.evict_expired(stats=self.stats.scheduler)
            self._queue.flush()

    def abort(self, err: Optional[BaseException] = None) -> int:
        """Fail every queued (and, in continuous mode, mid-decode) request
        without serving it (shutdown path)."""
        err = err or RuntimeError("engine aborted")
        if self.continuous:
            return self._sched.abort_all(err)
        return self._queue.fail_pending(err)

    def generate(
        self,
        prompts,
        n_steps: int,
        *,
        greedy: bool = True,
        generator: Optional[torch.Generator] = None,
        tier: Optional[str] = None,
    ) -> np.ndarray:
        """prompts: [B, L] ints.  Returns generated ids [B, n_steps] (numpy
        int32).  ``greedy=False`` samples every token (the first one, from
        prefill, too) from ``generator``, which it requires.  In continuous
        mode a blocking wrapper over ``enqueue`` and a targeted drain."""
        if not greedy and generator is None:
            raise ValueError("generate(greedy=False) requires an explicit torch.Generator")
        tier = self._tier(tier)
        prompts = self._as_prompts(prompts)
        if prompts.ndim != 2:
            raise ValueError(f"prompts must be [B, L] ints, got {tuple(prompts.shape)}")
        L = self._bucket_len(prompts.shape[1], n_steps)
        self._check_fits(prompts.shape[1], L, n_steps)
        if not self.continuous:
            req = LMRequest(prompts=prompts, n_steps=n_steps, tier=tier)
            self._execute(L, [req], greedy=greedy, generator=generator, tier=tier)
            # through result(): a quarantined request raises NumericFault here
            return np.asarray(req.result())
        req = LMRequest(prompts=prompts, n_steps=n_steps, tier=tier, L=L,
                        seeds=None if greedy else _draw_seeds(generator, prompts.shape[0]))
        self._sched.add(req)
        if not req.ready:
            self._sched.drain(targets=[req], only_group=(tier, L), reason="sync")
        return np.asarray(req.result())

    # ---- bucket-mode micro-batch execution -------------------------------

    def _run(self, key: tuple[str, int], reqs: list[LMRequest]) -> None:
        tier, L = key
        self._execute(L, reqs, greedy=True, generator=None, tier=tier)

    @staticmethod
    def _next_token(lg: torch.Tensor, greedy: bool, generator) -> torch.Tensor:
        if greedy:
            return torch.argmax(lg, dim=-1)
        probs = torch.softmax(lg.to(torch.float32), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def _execute(self, L: int, reqs: list[LMRequest], *, greedy: bool,
                 generator: Optional[torch.Generator], tier: str = "default") -> np.ndarray:
        """Bucket-at-a-time execution: one prefill wave, then the group's
        decode loop runs to completion before anything else is served."""
        params = self.tier_params(tier)
        for r in reqs:
            obs_trace.emit("admit", request=r.req_id, tier=tier, prompt_len=L, mid_decode=False)
        pre = self._prefill.run(reqs, L, tier)
        n_steps = max(r.n_steps for r in reqs)
        bb, masked, cache = pre.bb, pre.masked, pre.cache
        pad_lens = pre.pad_lens if masked else None
        row0, base = {}, 0
        for r in reqs:
            row0[id(r)] = base
            base += r.prompts.shape[0]

        tok = self._next_token(pre.logits_last, greedy, generator)
        out = [tok]
        ok_steps = []  # per decode step: [bb] finiteness, read after the burst
        if n_steps > 1:
            dbucket = DecodeBucket(bb, tier)
            self._note_first_use(dbucket, masked)
            if self._injector is not None:
                self._injector.sleep("decode")
            t0 = time.perf_counter()
            with obs_trace.span("decode_burst", bucket=str(dbucket), steps=n_steps - 1,
                                active=len(reqs), width=bb), \
                    torch.inference_mode():
                for step_i in range(n_steps - 1):
                    logits, cache = lm.decode_step(self.cfg, params, tok, cache,
                                                   pad_lens=pad_lens)
                    lg = logits[:, 0]
                    if self._injector is not None:
                        for r in reqs:
                            v = self._injector.activation("decode.logits", r.req_id,
                                                          step=step_i)
                            if v is not None:
                                i0 = row0[id(r)]
                                lg = lg.clone()
                                lg[i0:i0 + r.prompts.shape[0]] += v
                    ok_steps.append(torch.isfinite(lg).all(dim=-1))
                    tok = self._next_token(lg, greedy, generator)
                    out.append(tok)
                res = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
                if self.device.type == "cuda":  # the readback synchronized
                    obs_trace.anchor()
            dt = time.perf_counter() - t0
            for r in reqs:
                obs_trace.emit("decode", request=r.req_id, tier=tier, steps=r.n_steps - 1,
                               rows=r.prompts.shape[0])
            ds = self.stats.bucket(dbucket)
            ds.calls += n_steps - 1
            ds.items += pre.n_real
            # the first token comes from prefill — decode produced n_steps-1
            ds.tokens += pre.n_real * (n_steps - 1)
            ds.total_s += dt
            ds.latencies_s.append(dt / (n_steps - 1))
        else:
            res = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

        # [n_steps-1, bb]: each request is judged only on its own decode
        # steps (group members share L but may differ in n_steps)
        okm = (torch.stack(ok_steps, dim=0).cpu().numpy() if ok_steps
               else np.ones((0, bb), bool))
        i0 = 0
        for r in reqs:
            b = r.prompts.shape[0]
            ok_pre = bool(pre.ok_rows[i0:i0 + b].all())
            ok_dec = bool(okm[: r.n_steps - 1, i0:i0 + b].all())
            if not (ok_pre and ok_dec):
                # numeric quarantine: only this request fails
                self._numeric_fault(r, phase="decode" if ok_pre else "prefill")
            else:
                ids = res[i0:i0 + b, : r.n_steps]
                r._deliver(ids[0] if r.squeeze else ids)
            i0 += b
        return res[: pre.n_real]
