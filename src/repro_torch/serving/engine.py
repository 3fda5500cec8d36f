"""LM serving engine, bucket mode (port of ``repro/serving/engine.py``
without its continuous scheduler).

* **PrefillRunner** — one coalesced prompt wave per call: LEFT-padded to
  a prompt bucket, batch padded up to a batch bucket, per
  ``(batch, prompt_len, masked, tier)``.  Left padding keeps the last real
  token in the last slot so one ``logits[:, -1]`` read works for every
  row; per-row RoPE positions and the attention length mask
  (``lm.forward(pad_lens=...)``) make real-token outputs match the
  unpadded forward.
* **Bucket-at-a-time decode** — the prefilled group then decodes to
  completion before anything else is served (``Engine._execute``), one
  ``lm.decode_step`` per token on a cache of ``max_len`` slots.  The
  decode clock is a host int (``models/attention.py``), so a decode burst
  reads nothing back from the device until its last step.
* **Precision tiers** — ``tiers={"quality": None, "balanced": plan}``:
  one engine, several precisions; tier is part of every bucket identity
  and each tier's tree is quantized lazily on first use.  A uniform
  ``w4a8`` plan with ``use_kernel=True`` runs every projection of prefill
  and decode on the ``quant_matmul`` kernel.  The served prefill and decode
  take the masked vanilla attention over the int8 cache, as in the
  reference; only ``lm.forward(mode="full")`` reaches the two-stage kernel.
* **Robustness** — bounded admission (reject or shed), the degradation
  ladder over the tiers, seeded fault injection (``faults=``: the
  ``prefill.logits`` and ``decode.logits`` nan/inf sites, the ``prefill``
  and ``decode`` latency sites, the ``poll`` site), and the numeric
  quarantine: a request whose logits go non-finite fails alone with
  ``NumericFault``; co-batched requests are delivered.

Not ported yet (ROADMAP.md, queue 1): the continuous slot scheduler
(``DecodeRunner``, ``StateDecodeRunner``, ``Scheduler``).  ``mode="auto"``,
which the reference resolves to the continuous scheduler for
attention-only patterns, resolves to ``"bucket"`` here and says so in the
stats; ``mode="continuous"`` raises.  ``schedule=`` (a compiled kernel
schedule) waits for the compiler's LM lowering.

``compiles`` in the stats counts the first use of each ``(bucket,
masked)``, as in the port's ``VGGTEngine``: eager PyTorch compiles
nothing.  Results are numpy int32 ids, as in the reference.  The engine
runs on the CUDA device unless ``device`` says otherwise.
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
from repro_torch.serving.batching import NumericFault, QueueFull, next_pow2, pick_bucket
from repro_torch.tree import to_device

__all__ = [
    "PrefillBucket",
    "DecodeBucket",
    "LMServeStats",
    "LMRequest",
    "PrefillRunner",
    "PrefillResult",
    "Engine",
]

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8)
MIN_PROMPT_BUCKET = 8
CONTINUOUS_GAP = (
    "the continuous scheduler (DecodeRunner, Scheduler) is not ported yet "
    "(ROADMAP.md, queue 1 item 8)"
)


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
    why, when ``mode="auto"`` resolved to it)."""

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
        return f"scheduler: {self.mode}\n" + super().format()


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
        eng = self.eng
        if eng._injector is not None:
            eng._injector.sleep("prefill")
        params = eng.tier_params(tier)
        dev = eng.device
        n_real = sum(r.prompts.shape[0] for r in reqs)
        bb = eng.batch_bucket(n_real)

        parts, pads, n_prompt_toks = [], [], 0
        for r in reqs:
            x = r.prompts
            pad = L - x.shape[1]
            if pad:
                x = torch.nn.functional.pad(x, (pad, 0))  # LEFT pad (see module doc)
            parts.append(x)
            pads += [pad] * x.shape[0]
            n_prompt_toks += r.prompts.shape[0] * r.prompts.shape[1]
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
        cache = lm.init_cache(eng.cfg, bb, eng.max_len, device=dev)
        t0 = time.perf_counter()
        with obs_trace.span("prefill", emit_event=False, bucket=str(pbucket)), \
                torch.inference_mode():
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
        ok_rows = torch.isfinite(lg_last).all(dim=-1)[:n_real].cpu().numpy()
        return PrefillResult(cache=cache, logits_last=lg_last, pad_lens=pad_lens,
                             pads=real_pads, n_real=n_real, bb=bb, L=L, masked=masked,
                             ok_rows=ok_rows)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class Engine:
    """Bucketed LM prefill/decode serving — see the module docstring.
    Implements the ``batching.ServingEngine`` protocol.

        eng = Engine(cfg, params, tiers={"quality": None, "balanced": plan},
                     max_len=2048)
        ids = eng.generate(prompts, n_steps=32)        # one call
        reqs = [eng.enqueue(p, 32) for p in prompts]   # micro-batched
        eng.flush()
        outs = [r.result() for r in reqs]

    ``params`` is the raw ``lm.init_params`` tree; each tier's policy
    (``QuantPolicy``, ``PrecisionPlan``; None = full precision) is applied
    on the tier's first use, on the engine's device.  Sampling
    (``generate(greedy=False, generator=g)``) draws from an explicit
    ``torch.Generator``; the bucket engine coalesces greedy requests only.
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
        max_pending: Optional[int] = None,
        max_queued_tokens: Optional[int] = None,
        admission: str = "reject",
        degrade: Optional[batching.DegradeConfig | bool] = None,
        faults: Optional[faults_mod.FaultPlan | str] = None,
        device=None,
    ):
        if attn_impl is not None and attn_impl not in ("flash", "two_stage", "vanilla"):
            raise ValueError(f"attn_impl={attn_impl!r}: expected flash | two_stage | vanilla")
        if mode not in ("auto", "continuous", "bucket"):
            raise ValueError(f"mode={mode!r}: expected auto | continuous | bucket")
        if mode == "continuous":
            raise NotImplementedError(f"mode='continuous': {CONTINUOUS_GAP}")
        if schedule is not None:
            raise NotImplementedError(
                "Engine(schedule=...): the kernel-schedule compiler's LM lowering is not "
                "ported yet (ROADMAP.md, queue 1 item 7); serve tiers or a policy")
        if any(k != "attn" for k in cfg.pattern) or cfg.mla or cfg.moe or cfg.embed_inputs:
            raise NotImplementedError(
                f"{cfg.name}: only attention-only dense token LMs are ported (ROADMAP.md, "
                "queue 1 items 7 and 9)")
        self.device = batching.resolve_device(device, "Engine")
        if self.device.type == "cuda":
            # the float parts of the forward (fp tiers, the IDCT blocks, the
            # attention emulation, lm_head) are float32 work, which TF32
            # would round to ~3 decimal digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg.with_(attn_impl=attn_impl) if attn_impl is not None else cfg
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
        self.mode = "bucket"
        self.stats = LMServeStats(
            "bucket" if mode == "bucket" else f"bucket (mode='auto'; {CONTINUOUS_GAP})")
        self._seen: set = set()
        self._prefill = PrefillRunner(self)
        self._queue = batching.MicroBatchQueue(self._run, self.max_batch, max_wait_s)
        self._admission = batching.AdmissionController(
            max_pending=max_pending, max_queued_tokens=max_queued_tokens, policy=admission,
        )
        self._degrade = (
            batching.DegradationController(None if degrade is True else degrade, len(self.tiers))
            if degrade else None
        )
        self._injector = faults_mod.FaultInjector(faults) if faults is not None else None

    def _quantize(self, policy) -> Any:
        with torch.no_grad():
            return quantize_lm(self.cfg, self._raw, policy)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        """Bucketed prompt length (an oversize prompt runs exact).  Every
        ported pattern is attention-only, so prompts pad into length
        buckets (a recurrent mixer would carry pad tokens in its state)."""
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

    def _note_first_use(self, bucket: batching.Bucket, masked: bool) -> None:
        """Count the first use of ``(bucket, masked)`` in the bucket's
        ``compiles`` field (the reference's stats schema; here "bucket
        first use").  Masked and unmasked calls count apart."""
        key = (bucket, masked)
        if key not in self._seen:
            self._seen.add(key)
            self.stats.bucket(bucket).compiles += 1

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
        their tier and bucketed length.  Higher ``priority`` requests pack
        first into a flushing group; a request older than ``deadline_s`` is
        evicted with ``DeadlineExceeded``.  ``generator`` (per-request
        sampling) needs the continuous scheduler and raises here.

        With admission bounds (``max_pending`` / ``max_queued_tokens``) an
        over-full queue raises :class:`~repro_torch.serving.batching.QueueFull`
        (policy "reject") or sheds the least-valuable queued requests
        (policy "shed")."""
        if self._degrade is not None:
            self._degrade.observe(self.pending, self._measured_latency())
        tier = self._resolve_tier(tier, deadline_s)
        prompts = self._as_prompts(prompts)
        squeeze = prompts.ndim == 1
        if squeeze:
            prompts = prompts[None, :]
        if prompts.ndim != 2:
            raise ValueError(f"prompts must be [l] or [b, l] token ids, got {tuple(prompts.shape)}")
        L = self._bucket_len(prompts.shape[1], n_steps)
        self._check_fits(prompts.shape[1], L, n_steps)
        if generator is not None:
            raise ValueError(
                "per-request sampling generators need the continuous scheduler "
                f"(mode='continuous'; {CONTINUOUS_GAP}); the bucket engine only coalesces "
                "greedy requests")
        req = LMRequest(prompts=prompts, n_steps=n_steps, squeeze=squeeze, tier=tier, L=L,
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
                self._queue.remove(v)
                v._fail(QueueFull(
                    "request shed from the pending queue to admit "
                    "higher-priority traffic under overload"
                ))
        if self._injector is not None:
            self._injector.on_enqueue(req)
        obs_trace.emit("enqueue", request=req.req_id, kind="lm", tier=tier, prompt_len=L,
                       rows=prompts.shape[0], n_steps=n_steps, priority=priority)
        self._queue.add((tier, L), req, prompts.shape[0])
        return req

    @property
    def pending(self) -> int:
        """Requests waiting for admission."""
        return self._queue.pending

    def _pending_list(self) -> list[LMRequest]:
        return [r for q in self._queue._queues.values() for r, _ in q]

    @staticmethod
    def _req_tokens(r: LMRequest) -> int:
        """Queued work size for ``max_queued_tokens``: prompt-bucket plus
        generation tokens across the request's rows."""
        return r.prompts.shape[0] * (r.L + r.n_steps)

    def _numeric_fault(self, req: LMRequest, phase: str) -> None:
        """Quarantine one request whose logits went non-finite: it fails
        with :class:`NumericFault` (bucket mode has no retry path)."""
        self.stats.scheduler.numeric_faults += 1
        obs_trace.emit("numeric_fault", request=req.req_id, tier=req.tier, stage=phase)
        req._fail(NumericFault(
            f"request produced non-finite activations during {phase} at tier {req.tier!r} "
            "and was quarantined (co-batched requests are unaffected)"
        ))

    def poll(self) -> int:
        """One scheduling turn: evict expired requests, then flush groups
        past the coalescing deadline; returns groups flushed."""
        if self._injector is not None:
            self._injector.crash("poll")
            self._injector.sleep("poll")
        if self._degrade is not None:
            self._degrade.observe(self.pending, self._measured_latency())
        self._queue.evict_expired(stats=self.stats.scheduler)
        return self._queue.poll()

    def flush(self) -> None:
        """Serve every pending request to completion."""
        self._queue.evict_expired(stats=self.stats.scheduler)
        self._queue.flush()

    def abort(self, err: Optional[BaseException] = None) -> int:
        """Fail every queued request without serving it (shutdown path)."""
        return self._queue.fail_pending(err or RuntimeError("engine aborted"))

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
        prefill, too) from ``generator``, which it requires."""
        if not greedy and generator is None:
            raise ValueError("generate(greedy=False) requires an explicit torch.Generator")
        tier = self._tier(tier)
        prompts = self._as_prompts(prompts)
        if prompts.ndim != 2:
            raise ValueError(f"prompts must be [B, L] ints, got {tuple(prompts.shape)}")
        L = self._bucket_len(prompts.shape[1], n_steps)
        self._check_fits(prompts.shape[1], L, n_steps)
        req = LMRequest(prompts=prompts, n_steps=n_steps, tier=tier)
        self._execute(L, [req], greedy=greedy, generator=generator, tier=tier)
        # through result(): a quarantined request raises NumericFault here
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
            with obs_trace.span("decode_burst", emit_event=False, bucket=str(dbucket)), \
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
