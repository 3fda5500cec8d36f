"""VGGT serving engine: shape buckets + micro-batched scene queue +
quantized fast path + precision tiers and robustness (port of
``repro/serving/vggt_engine.py``).

* **Shape buckets** — requests are keyed on ``(batch, n_frames,
  n_patches)`` per precision tier; the batch dim is padded up to a bucket
  size, so a few shapes serve every request.  With ``pad_patches=True``
  the patch dim is rounded up too (masked out of every attention softmax
  via ``vggt.forward(patch_mask=...)``).
* **Micro-batching** — ``enqueue`` parks requests in a per-group queue
  (group = ``(tier, frames, bucketed patches)``); a group is flushed into
  one forward when it fills ``max_batch`` scenes, when its oldest request
  exceeds ``max_wait_s`` (``poll``), or on ``flush``.  Results are split
  back per request, padding sliced off.
* **Quantized fast path** — ``policy=PrecisionPlan(default="w4a8",
  use_kernel=True)`` serves ``quantize_vggt`` weights with every
  projection on the ``quant_matmul`` CUDA kernel; with ``fuse=True`` the
  unified datapath runs instead: per block one ``fused_matmul`` launch for
  Q/K/V (LayerNorm absorbed), one for ``wo``, one ``fused_ffn`` for the
  FFN.  ``attn_impl="two_stage"`` sends unmasked attention through the
  two-stage kernel.  Masked (patch-padded) buckets take the float
  attention emulation, as in the reference; their projections still run
  the kernels.
* **Precision tiers** — ``tiers={"quality": None, "balanced": plan,
  ...}``: one engine, several precisions; each tier's tree is quantized
  lazily on first use, on the engine's device.
* **Robustness** (``docs/robustness.md``) — bounded admission
  (``max_pending`` / ``max_queued_tokens``, reject or shed), a degradation
  ladder over the tiers, seeded fault injection (``faults=``), and
  quarantine: a request whose outputs are non-finite fails alone with
  ``NumericFault``; co-batched requests are delivered.

* **Compiled schedules** — ``schedule=`` (a ``KernelSchedule`` or a path
  to one, from ``python -m repro_torch.launch.compile``) replaces
  ``policy=``: fusion decisions and kernel launch tiles come from the
  schedule, its attention tiles land on ``cfg.attn_tiles``, and its hash
  is part of every bucket key.

The engine runs on the CUDA device unless ``device`` says otherwise; it
raises when asked for CUDA on a machine without it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.model_quant import quantize_vggt
from repro_torch.models import vggt as vggt_mod
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import batching, faults as faults_mod
from repro_torch.serving.batching import (
    BucketStats, NumericFault, QueueFull, next_pow2, pick_bucket,
)
from repro_torch.tree import to_device

__all__ = ["Bucket", "BucketStats", "VGGTServeStats", "PendingRequest", "VGGTEngine"]

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class Bucket(batching.Bucket):
    """One cached shape: batch padded up, frames exact, patches padded
    only with ``pad_patches``; per precision tier.  Prints as
    ``b4xs2xp24`` (``fast:b4xs2xp24`` for a non-default tier)."""

    batch: int
    frames: int
    patches: int
    tier: str = "default"

    AXES = ("b", "s", "p")


class VGGTServeStats(batching.ServeStats):
    """Per-bucket VGGT serving statistics; ``items`` == scenes."""

    unit = "scenes"
    kind = "vggt"


@dataclasses.dataclass
class PendingRequest(batching.PendingRequest):
    """A queued scene batch; ``result()`` is available after the engine
    flushes the request's micro-batch group."""

    scenes: torch.Tensor  # [b, S, P, d] on the engine's device
    n_patches: int  # real (unpadded) patch count
    tier: str = "default"  # precision tier (engine ``tiers`` key)


class VGGTEngine:
    """Bucketed, micro-batched VGGT serving (see module docstring).

        eng = VGGTEngine(cfg, params, policy=plan, attn_impl="two_stage")
        out = eng.infer(scenes)                  # one request
        reqs = [eng.enqueue(s) for s in many]    # micro-batched
        eng.flush()
        outs = [r.result() for r in reqs]

    Precision tiers (docs/serving.md "Precision tiers"): one engine, many
    quantization levels —

        eng = VGGTEngine(cfg, params, tiers={
            "quality": None, "balanced": plan, "fast": fused_plan,
        })
        out = eng.infer(scenes, tier="fast")

    ``params`` is the raw ``vggt.init_params`` tree; each tier's policy
    (``QuantPolicy``, ``PrecisionPlan`` or ``KernelSchedule``; None = full
    precision) is applied on the tier's first use.  ``schedule=`` (a
    compiled ``KernelSchedule`` or its path) serves one tier from it and
    is refused together with ``policy=`` or ``tiers=``.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        policy: Optional[Any] = None,
        schedule: Optional[Any] = None,
        tiers: Optional[dict[str, Any]] = None,
        default_tier: Optional[str] = None,
        attn_impl: Optional[str] = None,
        batch_buckets: tuple[int, ...] = DEFAULT_BATCH_BUCKETS,
        max_batch: Optional[int] = None,
        max_wait_s: float = 0.005,
        pad_patches: bool = False,
        max_pending: Optional[int] = None,
        max_queued_tokens: Optional[int] = None,
        admission: str = "reject",
        degrade: Optional[batching.DegradeConfig | bool] = None,
        faults: Optional[faults_mod.FaultPlan | str] = None,
        device=None,
    ):
        if attn_impl is not None and attn_impl not in ("flash", "two_stage", "vanilla"):
            raise ValueError(f"attn_impl={attn_impl!r}: expected flash | two_stage | vanilla")
        self.device = batching.resolve_device(device, "VGGTEngine")
        if self.device.type == "cuda":
            # the float parts of the forward (patch projection, IDCT blocks,
            # heads, the masked attention emulation) are float32 work, which
            # TF32 would round to ~3 decimal digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg.with_(attn_impl=attn_impl) if attn_impl is not None else cfg
        # A compiled KernelSchedule (or a path to one) replaces the implicit
        # policy: the walker reads its fusion decisions and launch tiles.
        self.schedule, self._schedule_hash = batching.load_schedule(schedule)
        if self.schedule is not None:
            if policy is not None or tiers is not None:
                raise ValueError("pass either schedule= or policy=/tiers=, not both")
            policy = self.schedule
            targets = self.schedule.attention_targets()
            if targets:
                self.cfg = self.cfg.with_(attn_tiles=targets)
        self._raw = to_device(params, self.device)
        # ``tiers``: tier name -> QuantPolicy | PrecisionPlan | None (fp).
        # Tier is part of the bucket identity (own first uses + stats rows
        # per tier) and of the queue group key (requests only coalesce
        # within their tier).
        self._tierset = batching.TierSet(
            tiers=tiers, policy=policy, default_tier=default_tier,
            raw_params=self._raw, quantize=self._quantize,
        )
        self.tiers = self._tierset.tiers
        self.default_tier = self._tierset.default_tier
        self.policy = self._tierset.default_policy
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.max_batch = max_batch if max_batch is not None else self.batch_buckets[-1]
        self.max_wait_s = max_wait_s
        self.pad_patches = pad_patches
        self.stats = VGGTServeStats()
        self._seen: set[tuple[Bucket, bool, Optional[str]]] = set()
        self._queue = batching.MicroBatchQueue(self._run, self.max_batch, max_wait_s)
        # robustness layer (docs/robustness.md): bounded admission,
        # degradation ladder, and the chaos injector — all off by default
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
            return quantize_vggt(self.cfg, self._raw, policy)

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

    # ---- buckets ---------------------------------------------------------

    def bucket_for(self, batch: int, frames: int, patches: int, tier: str = "default") -> Bucket:
        b = pick_bucket(self.batch_buckets, batch)
        p = next_pow2(patches) if self.pad_patches else patches
        return Bucket(batch=b, frames=frames, patches=p, tier=tier)

    def _note_first_use(self, bucket: Bucket, masked: bool) -> None:
        """Count the first use of ``(bucket, masked)`` in the bucket's
        ``compiles`` field.  Eager PyTorch compiles nothing; the field keeps
        the reference's stats schema and here means "bucket first use".
        Masked and unmasked calls count apart (the mask-free one keeps the
        two-stage kernel path live); the key holds the schedule's hash."""
        key = (bucket, masked, self._schedule_hash)
        if key not in self._seen:
            self._seen.add(key)
            self.stats.bucket(bucket).compiles += 1

    # ---- request path ----------------------------------------------------

    def _group_key(self, scenes: torch.Tensor, tier: str) -> tuple[str, int, int]:
        s, p_ = scenes.shape[1], scenes.shape[2]
        return (tier, s, next_pow2(p_) if self.pad_patches else p_)

    def infer(self, scenes, tier: Optional[str] = None) -> dict:
        """Serve one request synchronously (still bucket-padded).  Flushes
        only this request's group — pending micro-batches of other
        shapes/tiers keep coalescing."""
        req = self.enqueue(scenes, tier=tier)
        if not req.ready:
            self._queue.flush_group(self._group_key(req.scenes, req.tier))
        return req.result()

    def enqueue(
        self,
        scenes,
        tier: Optional[str] = None,
        *,
        priority: int = 0,
        deadline_s: Optional[float] = None,
    ) -> PendingRequest:
        """Queue a [b, S, P, d] scene batch (numpy or tensor); auto-flushes
        a group the moment it reaches ``max_batch`` scenes.  ``tier``
        selects the precision tier; requests only coalesce within their
        tier.  Higher ``priority`` requests are packed into a flushing
        micro-batch first; a request older than ``deadline_s`` seconds is
        evicted (its ``result()`` raises ``DeadlineExceeded``) instead of
        being served late.

        With admission bounds configured (``max_pending`` /
        ``max_queued_tokens``) an over-full queue raises
        :class:`~repro_torch.serving.batching.QueueFull` (policy "reject")
        or sheds the least-valuable queued requests (policy "shed")."""
        if self._degrade is not None:
            self._degrade.observe(self._queue.pending, self._measured_latency())
        pinned = tier is not None
        tier = self._tier(tier)
        if self._degrade is not None and self._degrade.level and not pinned:
            names = list(self.tiers)
            base = names.index(tier)
            down = min(base + self._degrade.level, len(names) - 1)
            if down != base:
                tier = names[down]
                self.stats.scheduler.degraded_admissions += 1
        scenes = torch.as_tensor(scenes).to(self.device)
        if scenes.ndim != 4:
            raise ValueError(f"scenes must be [b, S, P, d], got {tuple(scenes.shape)}")
        b, _, p_, _ = scenes.shape
        req = PendingRequest(scenes=scenes, n_patches=p_, tier=tier,
                             priority=priority, deadline_s=deadline_s)
        if self._admission.bounded:
            try:
                victims = self._admission.check(
                    req, self._pending_list(), self._req_tokens, self.stats.scheduler,
                )
            except QueueFull:
                obs_trace.emit("rejected", request=req.req_id, kind="vggt", tier=tier)
                raise
            for v in victims:
                self._queue.remove(v)
                v._fail(QueueFull(
                    "request shed from the pending queue to admit "
                    "higher-priority traffic under overload"
                ))
        if self._injector is not None:
            self._injector.on_enqueue(req)
        obs_trace.emit(
            "enqueue", request=req.req_id, kind="vggt", tier=tier,
            scenes=b, frames=scenes.shape[1], patches=p_, priority=priority,
        )
        self._queue.add(self._group_key(scenes, tier), req, b)
        return req

    @property
    def pending(self) -> int:
        """Scene requests waiting in the micro-batch queues."""
        return self._queue.pending

    @property
    def degradation_level(self) -> int:
        """Current ladder level (0 = serving at declared tiers)."""
        return self._degrade.level if self._degrade is not None else 0

    def _pending_list(self) -> list[PendingRequest]:
        return [r for q in self._queue._queues.values() for r, _ in q]

    @staticmethod
    def _req_tokens(r: PendingRequest) -> int:
        """Queued work size for ``max_queued_tokens``: patch tokens across
        the request's scenes and frames."""
        return r.scenes.shape[0] * r.scenes.shape[1] * r.n_patches

    def _measured_latency(self) -> Optional[float]:
        try:
            return self.stats.mean_item_latency_s()
        except ValueError:  # no traffic yet — no latency pressure
            return None

    def _numeric_fault(self, req: PendingRequest) -> None:
        """Quarantine one scene request whose forward outputs went
        non-finite: only this request fails, co-batched scenes deliver."""
        self.stats.scheduler.numeric_faults += 1
        obs_trace.emit("numeric_fault", request=req.req_id, tier=req.tier, stage="forward")
        req._fail(NumericFault(
            f"scene request produced non-finite reconstruction outputs at "
            f"tier {req.tier!r} and was quarantined (co-batched scenes "
            f"are unaffected)"
        ))

    def poll(self) -> int:
        """Evict requests past their deadline, then flush groups whose
        oldest request has waited past ``max_wait_s``.  Returns the number
        of groups flushed."""
        if self._injector is not None:
            self._injector.crash("poll")
            self._injector.sleep("poll")
        if self._degrade is not None:
            self._degrade.observe(self._queue.pending, self._measured_latency())
        self._queue.evict_expired(stats=self.stats.scheduler)
        return self._queue.poll()

    def flush(self) -> None:
        """Flush every pending group (expired requests are evicted first)."""
        self._queue.evict_expired(stats=self.stats.scheduler)
        self._queue.flush()

    def abort(self, err: Optional[BaseException] = None) -> int:
        """Fail every queued request without serving it (shutdown path)."""
        return self._queue.fail_pending(err or RuntimeError("engine aborted"))

    # ---- micro-batch execution -------------------------------------------

    def _run(self, key: tuple[str, int, int], reqs: list[PendingRequest]) -> None:
        """One micro-batch: a ``vggt.call`` span (label ``scenes``: the real
        scenes) with ``assemble``, ``model``, ``readback`` and ``deliver``
        children."""
        tier, frames, p_bucket = key
        n_real = sum(r.scenes.shape[0] for r in reqs)
        with obs_trace.span("vggt.call", scenes=n_real, tier=tier):
            self._call(tier, frames, p_bucket, n_real, reqs)

    def _call(self, tier: str, frames: int, p_bucket: int, n_real: int,
              reqs: list[PendingRequest]) -> None:
        for r in reqs:
            obs_trace.emit("admit", request=r.req_id, tier=tier, frames=frames,
                           patches=p_bucket, mid_decode=False)
        params = self.tier_params(tier)
        bucket = self.bucket_for(n_real, frames, p_bucket, tier)
        d = reqs[0].scenes.shape[-1]
        dtype = reqs[0].scenes.dtype

        # mask only when some request actually has padded patches: the
        # mask-free forward keeps the two-stage kernel path live
        masked = any(r.n_patches < bucket.patches for r in reqs)
        inj = self._injector
        if inj is not None:
            inj.sleep("prefill")  # the forward is VGGT's prefill stage
        with obs_trace.span("assemble"):
            parts, mask_parts = [], []
            for r in reqs:
                x = r.scenes
                if inj is not None:
                    v = inj.activation("scene", r.req_id)
                    if v is not None:  # poison one input element of this scene
                        x = x.clone()
                        x[0, 0, 0, 0] += v
                if x.shape[2] < bucket.patches:  # pad the patch dim (masked)
                    x = torch.nn.functional.pad(x, (0, 0, 0, bucket.patches - x.shape[2]))
                parts.append(x)
                if masked:
                    m = torch.zeros((x.shape[0], frames, bucket.patches), dtype=torch.bool,
                                    device=self.device)
                    m[:, :, : r.n_patches] = True
                    mask_parts.append(m)
            if n_real < bucket.batch:  # pad the batch dim with empty scenes
                slack = bucket.batch - n_real
                parts.append(torch.zeros((slack, frames, bucket.patches, d), dtype=dtype,
                                         device=self.device))
                if masked:
                    mask_parts.append(torch.ones((slack, frames, bucket.patches),
                                                 dtype=torch.bool, device=self.device))
            x = torch.cat(parts, dim=0)
            mask = torch.cat(mask_parts, dim=0) if masked else None
        self._note_first_use(bucket, masked)

        t0 = time.perf_counter()
        with obs_trace.span("model", parts=True, bucket=str(bucket)), torch.inference_mode():
            out = vggt_mod.forward(self.cfg, params, x, patch_mask=mask)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                obs_trace.anchor()
        dt = time.perf_counter() - t0

        bs = self.stats.bucket(bucket)
        bs.calls += 1
        bs.items += n_real
        bs.padded_items += bucket.batch - n_real
        bs.total_s += dt
        bs.latencies_s.append(dt)
        for r in reqs:
            obs_trace.emit("forward", request=r.req_id, dur_s=dt, bucket=str(bucket),
                           tier=tier, scenes=r.scenes.shape[0])

        # per-request finiteness over the real (unpadded) outputs, reduced on
        # the device and read in one transfer: a non-finite scene batch
        # fails only its own request
        with obs_trace.span("readback"):
            oks, i0 = [], 0
            for r in reqs:
                b = r.scenes.shape[0]
                ok = torch.ones((), dtype=torch.bool, device=self.device)
                for k in ("pose", "points", "depth", "conf"):
                    a = out[k][i0 : i0 + b]
                    if k != "pose":
                        a = a[:, :, : r.n_patches]
                    ok = ok & torch.isfinite(a).all()
                oks.append(ok)
                i0 += b
            okh = torch.stack(oks).cpu().tolist()

        with obs_trace.span("deliver"):
            i0 = 0
            ns = self.cfg.n_special_tokens
            for idx, r in enumerate(reqs):
                b = r.scenes.shape[0]
                if okh[idx]:
                    r._deliver(_slice_result(out, i0, b, r.n_patches, ns))
                else:
                    self._numeric_fault(r)
                i0 += b


def _slice_result(out: dict, i0: int, b: int, n_patches: int, ns: int) -> dict:
    """Split one request's rows out of a micro-batched forward, dropping
    padded patches/tokens."""
    return {
        "pose": out["pose"][i0 : i0 + b],
        "points": out["points"][i0 : i0 + b, :, :n_patches],
        "depth": out["depth"][i0 : i0 + b, :, :n_patches],
        "conf": out["conf"][i0 : i0 + b, :, :n_patches],
        "tokens": out["tokens"][i0 : i0 + b, :, : ns + n_patches],
    }
