"""Fault-tolerant LM training on the PyTorch/CUDA port: checkpoint/restart
and the straggler watchdog (the port of ``examples/train_lm.py``).

Kill it mid-run and re-run: it resumes from the last checkpoint and
reproduces the uninterrupted loss curve (step-seeded data).  The
compressed data-parallel step the reference names beside this example is
``runtime.trainer.make_ddp_compressed_step`` (int8 error-feedback
gradient all-reduce over a ``DeviceMesh`` axis, ``parallel/compression.py``);
this example trains on one device.  It trains on the CUDA device unless
``--device cpu`` is given; the default ``--ckpt`` lies under the temporary
directory.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 300 [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="where to train (default: the CUDA device; no fallback)")
    args = ap.parse_args()

    cfg = get_config("qwen3-14b-smoke").with_(
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256
    )
    t = Trainer(
        cfg,
        adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
        DataConfig(vocab_size=256, batch=8, seq_len=64),
        TrainerConfig(total_steps=args.steps, checkpoint_every=50, log_every=20),
        args.ckpt,
        device=args.device,
    )
    if t.start_step:
        print(f"[resume] continuing from step {t.start_step}")
    res = t.run()
    if res["history"]:
        print(f"done. final loss {res['history'][-1]['loss']:.4f}, "
              f"{len(res['stragglers'])} straggler events")
    else:
        print(f"done. the checkpoint is already at step {t.start_step}")


if __name__ == "__main__":
    main()
