"""VGGT serving engine: shape buckets + micro-batched scene queue +
quantized fast path (port of ``repro/serving/vggt_engine.py``).

* **Shape buckets** — requests are keyed on ``(batch, n_frames,
  n_patches)``; the batch dim is padded up to a bucket size, so a few
  shapes serve every request.  With ``pad_patches=True`` the patch
  dim is rounded up too (masked out of every attention softmax via
  ``vggt.forward(patch_mask=...)``).
* **Micro-batching** — ``enqueue`` parks requests in a per-group queue; a
  group is flushed into one forward when it fills ``max_batch`` scenes,
  when its oldest request exceeds ``max_wait_s`` (``poll``), or on
  ``flush``.  Results are split back per request, padding sliced off.
* **Quantized fast path** — ``policy=PrecisionPlan(default="w4a8",
  use_kernel=True)`` serves ``quantize_vggt`` weights with every
  projection on the ``quant_matmul`` CUDA kernel; with ``fuse=True`` the
  unified datapath runs instead: per block one ``fused_matmul`` launch for
  Q/K/V (LayerNorm absorbed), one for ``wo``, one ``fused_ffn`` for the
  FFN.  ``attn_impl="two_stage"`` sends unmasked attention through the
  two-stage kernel.  Masked (patch-padded) buckets take the float
  attention emulation, as in the reference; their projections still run
  the kernels.
* **Quarantine** — a request whose outputs are non-finite fails alone
  with ``NumericFault``; co-batched requests are delivered.

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
from repro_torch.serving import batching
from repro_torch.serving.batching import BucketStats, NumericFault, next_pow2, pick_bucket
from repro_torch.tree import to_device

__all__ = ["Bucket", "BucketStats", "VGGTServeStats", "PendingRequest", "VGGTEngine"]

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class Bucket(batching.Bucket):
    """One cached shape: batch padded up, frames exact, patches padded
    only with ``pad_patches``.  Prints as ``b4xs2xp24``."""

    batch: int
    frames: int
    patches: int

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


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "VGGTEngine runs on the CUDA device unless told otherwise, and no "
            "CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


class VGGTEngine:
    """Bucketed, micro-batched VGGT serving (see module docstring).

        eng = VGGTEngine(cfg, params, policy=plan, attn_impl="two_stage")
        out = eng.infer(scenes)                  # one request
        reqs = [eng.enqueue(s) for s in many]    # micro-batched
        eng.flush()
        outs = [r.result() for r in reqs]

    ``params`` is the raw ``vggt.init_params`` tree; with a ``policy``
    (``QuantPolicy`` or ``PrecisionPlan``) it is quantized on first use.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        policy: Optional[Any] = None,
        attn_impl: Optional[str] = None,
        batch_buckets: tuple[int, ...] = DEFAULT_BATCH_BUCKETS,
        max_batch: Optional[int] = None,
        max_wait_s: float = 0.005,
        pad_patches: bool = False,
        device=None,
    ):
        if attn_impl is not None and attn_impl not in ("flash", "two_stage", "vanilla"):
            raise ValueError(f"attn_impl={attn_impl!r}: expected flash | two_stage | vanilla")
        self.device = _resolve_device(device)
        if self.device.type == "cuda":
            # the float parts of the forward (patch projection, IDCT blocks,
            # heads, the masked attention emulation) are float32 work, which
            # TF32 would round to ~3 decimal digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg =cfg.with_(attn_impl=attn_impl) if attn_impl is not None else cfg
        self.policy = policy
        self._raw = to_device(params, self.device)
        self._params = None
        self.batch_buckets = tuple(sorted(batch_buckets))
        self.max_batch = max_batch if max_batch is not None else self.batch_buckets[-1]
        self.max_wait_s = max_wait_s
        self.pad_patches = pad_patches
        self.stats = VGGTServeStats()
        self._seen: set[tuple[Bucket, bool]] = set()
        self._queue = batching.MicroBatchQueue(self._run, self.max_batch, max_wait_s)

    @property
    def params(self) -> Any:
        """The served parameter tree (quantized lazily on first use)."""
        if self._params is None:
            if self.policy is None:
                self._params = self._raw
            else:
                with torch.no_grad():
                    self._params = quantize_vggt(self.cfg, self._raw, self.policy)
        return self._params

    # ---- buckets ---------------------------------------------------------

    def bucket_for(self, batch: int, frames: int, patches: int) -> Bucket:
        b = pick_bucket(self.batch_buckets, batch)
        p = next_pow2(patches) if self.pad_patches else patches
        return Bucket(batch=b, frames=frames, patches=p)

    def _note_first_use(self, bucket: Bucket, masked: bool) -> None:
        """Count the first use of ``(bucket, masked)`` in the bucket's
        ``compiles`` field.  Eager PyTorch compiles nothing; the field keeps
        the reference's stats schema and here means "bucket first use".
        Masked and unmasked calls count apart (the mask-free one keeps the
        two-stage kernel path live)."""
        if (bucket, masked) not in self._seen:
            self._seen.add((bucket, masked))
            self.stats.bucket(bucket).compiles += 1

    # ---- request path ----------------------------------------------------

    def _group_key(self, scenes: torch.Tensor) -> tuple[int, int]:
        s, p_ = scenes.shape[1], scenes.shape[2]
        return (s, next_pow2(p_) if self.pad_patches else p_)

    def infer(self, scenes) -> dict:
        """Serve one request synchronously (still bucket-padded/cached).
        Flushes only this request's group."""
        req = self.enqueue(scenes)
        if not req.ready:
            self._queue.flush_group(self._group_key(req.scenes))
        return req.result()

    def enqueue(self, scenes, *, deadline_s: Optional[float] = None) -> PendingRequest:
        """Queue a [b, S, P, d] scene batch (numpy or tensor); auto-flushes a
        group the moment it reaches ``max_batch`` scenes."""
        scenes = torch.as_tensor(scenes).to(self.device)
        if scenes.ndim != 4:
            raise ValueError(f"scenes must be [b, S, P, d], got {tuple(scenes.shape)}")
        b, _, p_, _ = scenes.shape
        req = PendingRequest(scenes=scenes, n_patches=p_, deadline_s=deadline_s)
        self._queue.add(self._group_key(scenes), req, b)
        return req

    @property
    def pending(self) -> int:
        """Scene requests waiting in the micro-batch queues."""
        return self._queue.pending

    def poll(self) -> int:
        """Evict requests past their deadline, then flush groups whose
        oldest request has waited past ``max_wait_s``.  Returns the number
        of groups flushed."""
        self._queue.evict_expired(stats=self.stats.scheduler)
        return self._queue.poll()

    def flush(self) -> None:
        """Flush every pending group (expired requests are evicted first)."""
        self._queue.evict_expired(stats=self.stats.scheduler)
        self._queue.flush()

    def abort(self, err: Optional[BaseException] = None) -> int:
        """Fail every queued request without serving it (shutdown path)."""
        return self._queue.fail_pending(err or RuntimeError("engine aborted"))

    def _numeric_fault(self, req: PendingRequest) -> None:
        self.stats.scheduler.numeric_faults += 1
        req._fail(NumericFault(
            "scene request produced non-finite reconstruction outputs and was "
            "quarantined (co-batched scenes are unaffected)"
        ))

    # ---- micro-batch execution -------------------------------------------

    def _run(self, key: tuple[int, int], reqs: list[PendingRequest]) -> None:
        frames, p_bucket = key
        params = self.params
        n_real = sum(r.scenes.shape[0] for r in reqs)
        bucket = self.bucket_for(n_real, frames, p_bucket)
        d = reqs[0].scenes.shape[-1]
        dtype = reqs[0].scenes.dtype

        # mask only when some request actually has padded patches: the
        # mask-free forward keeps the two-stage kernel path live
        masked = any(r.n_patches < bucket.patches for r in reqs)
        parts, mask_parts = [], []
        for r in reqs:
            x = r.scenes
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
                mask_parts.append(torch.ones((slack, frames, bucket.patches), dtype=torch.bool,
                                             device=self.device))
        x = torch.cat(parts, dim=0)
        self._note_first_use(bucket, masked)

        t0 = time.perf_counter()
        with torch.inference_mode():
            mask = torch.cat(mask_parts, dim=0) if masked else None
            out = vggt_mod.forward(self.cfg, params, x, patch_mask=mask)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0

        bs = self.stats.bucket(bucket)
        bs.calls += 1
        bs.items += n_real
        bs.padded_items += bucket.batch - n_real
        bs.total_s += dt
        bs.latencies_s.append(dt)

        # per-request finiteness over the real (unpadded) outputs, reduced on
        # the device and read in one transfer: a non-finite scene batch
        # fails only its own request
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
