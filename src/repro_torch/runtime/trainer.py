"""Fault-tolerant training runtime (port of ``repro/runtime/trainer.py``).

* auto-resume from the newest valid checkpoint (atomic, checksummed);
* restart-exact data (the step-seeded pipeline: no iterator state on disk);
* a straggler watchdog: flags steps slower than ``straggler_factor`` x the
  running median of step wall times (unit-tested by injection);
* a failure-injection hook (``fail_at``) for the restart tests.

Two steps, as in the reference:
* :func:`make_train_step`: the loss and its gradient on one device (or on
  a tree sharded by ``parallel.sharding.distribute_tree``, run under
  ``implicit_replication()``), then AdamW;
* :func:`make_ddp_compressed_step`: pure data parallelism, each rank's
  gradients of its rows of the batch averaged by the int8 error-feedback
  all-reduce (``parallel/compression.py``), then a replicated AdamW.
Both differentiate the float parameter leaves with ``torch.autograd`` and
update them in place with ``optim.adamw.apply``.  The trainer runs on the
CUDA device unless told otherwise; without a card it raises
(``serving.batching.resolve_device``).
"""
from __future__ import annotations

import dataclasses
import functools
import statistics
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, token_batch
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.parallel import compression
from repro_torch.serving.batching import resolve_device
from repro_torch.sharded import is_dtensor
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["lm_loss", "make_train_step", "make_ddp_compressed_step", "TrainerConfig",
           "Trainer"]


def lm_loss(cfg: ModelConfig, params: Any, batch: dict, *, remat: bool | str = False
            ) -> torch.Tensor:
    """Mean next-token cross entropy over float32 logits: logsumexp minus
    the gold logit.  ``batch``: ``token_batch``'s arrays (numpy or
    tensors, or DTensors on a sharded path), taken to the parameters'
    device.  Sharded logits (vocab over ``model``, batch over ``data``)
    are gathered whole first, and every rank computes the same loss:
    DTensor's ``gather`` cannot take vocab-sharded logits."""
    dev = tree_leaves(params)[0].device
    tokens, labels = (batch[k].to(dev) if isinstance(batch[k], torch.Tensor)
                      else torch.as_tensor(batch[k], device=dev) for k in ("tokens", "labels"))
    logits, _ = lm.forward(cfg, params, tokens, remat=remat)
    if is_dtensor(logits):
        logits = logits.full_tensor()
    if is_dtensor(labels):
        labels = labels.full_tensor()
    labels = labels.long()
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)


def _value_and_grad(loss_fn: Callable, params: Any, batch) -> tuple[torch.Tensor, Any]:
    """(the loss, its gradient tree: None where a leaf is not float or got
    no gradient)."""
    # differentiate fresh leaves that share the parameters' storage, so
    # the tree itself never carries requires_grad (a kernel wrapper
    # refuses such tensors when the trained tree is served)
    live = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    loss = loss_fn(live, batch)
    leaves = [p for p in tree_leaves(live) if p.requires_grad]
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    grads = tree_map(lambda p: next(got) if p.requires_grad else None, live)
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    loss_fn: Optional[Callable] = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss and its gradient over every float leaf, then one AdamW update
    in place; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` (device
    scalars).  ``loss_fn(params, batch)`` defaults to :func:`lm_loss`
    (``functools.partial(lm_loss, cfg, remat=True)`` checkpoints it)."""
    loss_fn = loss_fn or functools.partial(lm_loss, cfg)

    def step(params, opt_state, batch):
        loss, grads = _value_and_grad(loss_fn, params, batch)
        params, opt_state, metrics = adamw.apply(opt_cfg, opt_state, params, grads)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def make_ddp_compressed_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    mesh,
    axis: str = "data",
    loss_fn: Optional[Callable] = None,
):
    """Pure-DP step over the ``axis`` dim of ``mesh`` (a ``DeviceMesh``):
    ``step(params, opt_state, err, batch) -> (params, opt_state, err,
    metrics)``.  Every rank passes the same replicated ``params``,
    ``opt_state`` (``adamw.init``), ``err`` (``compression.
    init_error_state(params)``) and the global ``batch``; it takes its own
    rows of the batch (the batch dim split over ``axis``, as
    ``sharding.batch_pspec`` splits it on a mesh whose batch axis is
    ``axis``), computes its loss and gradients, averages the loss over the
    axis and the gradients through ``compression.compressed_tree_psum``,
    and applies the same AdamW update as every other rank."""
    loss_fn = loss_fn or functools.partial(lm_loss, cfg)
    dim = mesh.mesh_dim_names.index(axis)
    n_dev, rank, group = mesh.size(dim), mesh.get_local_rank(dim), mesh.get_group(dim)

    def step(params, opt_state, err, batch):
        rows = {}
        for k, v in batch.items():
            if v.shape[0] % n_dev:
                raise ValueError(f"batch {k} of {v.shape[0]} rows does not split over "
                                 f"{n_dev} ranks")
            per = v.shape[0] // n_dev
            rows[k] = v[rank * per:(rank + 1) * per]
        loss, grads = _value_and_grad(loss_fn, params, rows)
        grads = tree_map(lambda p, g: torch.zeros_like(p) if g is None else g, params, grads)
        dist.all_reduce(loss, group=group)
        grads, err = compression.compressed_tree_psum(grads, err, group, n_dev)
        params, opt_state, metrics = adamw.apply(opt_cfg, opt_state, params, grads)
        metrics["loss"] = loss / n_dev
        return params, opt_state, err, metrics

    return step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 300
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    keep_checkpoints: int = 3


class Trainer:
    """Checkpoint/restart training loop with a straggler watchdog."""

    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: adamw.AdamWConfig,
        data_cfg: DataConfig,
        tc: TrainerConfig,
        ckpt_dir: str,
        *,
        step_fn: Optional[Callable] = None,
        params: Any = None,
        seed: int = 0,
        device=None,
    ):
        self.cfg, self.opt_cfg, self.data_cfg, self.tc = cfg, opt_cfg, data_cfg, tc
        self.device = resolve_device(device, "Trainer")
        self.ckpt = CheckpointManager(ckpt_dir, keep=tc.keep_checkpoints)
        if params is None:
            params = lm.init_params(cfg, torch.Generator(device=self.device).manual_seed(seed))
        self.params = params
        self.opt_state = adamw.init(self.params)
        self.start_step = 0
        self.step_times: list[float] = []
        self.straggler_events: list[int] = []
        self.fail_at: Optional[int] = None  # test hook
        self._step = step_fn or make_train_step(cfg, opt_cfg)
        self.history: list[dict] = []
        self._maybe_resume()

    def _maybe_resume(self):
        if self.ckpt.latest_step() is None:
            return
        state = {"params": self.params, "opt": self.opt_state}
        state, meta, step = self.ckpt.restore(state)
        self.params, self.opt_state = state["params"], state["opt"]
        self.start_step = int(meta.get("next_step", step))

    def _watchdog(self, step: int, dt: float):
        self.step_times.append(dt)
        if len(self.step_times) >= 8:
            med = statistics.median(self.step_times[-64:])
            if dt > self.tc.straggler_factor * med:
                self.straggler_events.append(step)
                print(
                    f"[watchdog] step {step}: {dt*1e3:.1f}ms > "
                    f"{self.tc.straggler_factor}x median {med*1e3:.1f}ms — "
                    "straggler flagged (would trigger a hot-spare swap on a real cluster)"
                )

    def run(self) -> dict:
        for step in range(self.start_step, self.tc.total_steps):
            if self.fail_at is not None and step == self.fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            batch = token_batch(self.data_cfg, step)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step(self.params, self.opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
            self._watchdog(step, time.perf_counter() - t0)
            self.history.append({"step": step, **metrics})
            if step % self.tc.log_every == 0:
                print(
                    f"step {step:5d} loss {metrics['loss']:.4f} "
                    f"gnorm {metrics['grad_norm']:.3f} lr {metrics['lr']:.2e}"
                )
            if (step + 1) % self.tc.checkpoint_every == 0 or step + 1 == self.tc.total_steps:
                self.ckpt.save(
                    step + 1,
                    {"params": self.params, "opt": self.opt_state},
                    meta={"next_step": step + 1},
                )
        return {"history": self.history, "stragglers": self.straggler_events}
