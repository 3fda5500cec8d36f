"""Fault-tolerant training runtime (port of ``repro/runtime/trainer.py``).

* auto-resume from the newest valid checkpoint (atomic, checksummed);
* restart-exact data (the step-seeded pipeline: no iterator state on disk);
* a straggler watchdog: flags steps slower than ``straggler_factor`` x the
  running median of step wall times (unit-tested by injection);
* a failure-injection hook (``fail_at``) for the restart tests.

The step differentiates the float parameter leaves with ``torch.autograd``
and updates them in place with ``optim.adamw.apply``.  The reference's
data-parallel step with int8 error-feedback all-reduce
(``make_ddp_compressed_step``) waits for the port's multi-device layer.
The trainer runs on the CUDA device unless told otherwise; without a card
it raises (``serving.batching.resolve_device``).
"""
from __future__ import annotations

import dataclasses
import functools
import statistics
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, token_batch
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.serving.batching import resolve_device
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["lm_loss", "make_train_step", "TrainerConfig", "Trainer"]


def lm_loss(cfg: ModelConfig, params: Any, batch: dict, *, remat: bool | str = False
            ) -> torch.Tensor:
    """Mean next-token cross entropy over float32 logits: logsumexp minus
    the gold logit.  ``batch``: ``token_batch``'s arrays (numpy or
    tensors), taken to the parameters' device."""
    dev = tree_leaves(params)[0].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    logits, _ = lm.forward(cfg, params, tokens, remat=remat)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    loss_fn: Optional[Callable] = None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss and its gradient over every float leaf, then one AdamW update
    in place; ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` (device
    scalars).  ``loss_fn(params, batch)`` defaults to :func:`lm_loss`
    (``functools.partial(lm_loss, cfg, remat=True)`` checkpoints it)."""
    loss_fn = loss_fn or functools.partial(lm_loss, cfg)

    def step(params, opt_state, batch):
        # differentiate fresh leaves that share the parameters' storage, so
        # the tree itself never carries requires_grad (a kernel wrapper
        # refuses such tensors when the trained tree is served)
        live = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
        loss = loss_fn(live, batch)
        leaves = [p for p in tree_leaves(live) if p.requires_grad]
        got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        grads = tree_map(lambda p: next(got) if p.requires_grad else None, live)
        del live, leaves
        params, opt_state, metrics = adamw.apply(opt_cfg, opt_state, params, grads)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

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
