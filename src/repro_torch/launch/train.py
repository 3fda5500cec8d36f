"""Training launcher of the port: the fault-tolerant loop with auto-resume
(port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b-smoke \\
      --steps 300 --batch 8 --seq 64 --ckpt CKPT_DIR [--device cpu]

It trains on the CUDA device unless ``--device`` says otherwise; without a
card and without that flag it exits non-zero.  Run it again on the same
``--ckpt`` with more ``--steps`` and it resumes from the newest checkpoint.
The default ``--ckpt`` lies under the temporary directory (``TMPDIR``).
"""
import argparse
import os
import sys
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b-smoke")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="where to train (default: the CUDA device; no fallback)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    t = Trainer(
        cfg,
        adamw.AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
        DataConfig(vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq),
        TrainerConfig(total_steps=args.steps, checkpoint_every=args.checkpoint_every),
        args.ckpt,
        device=args.device,
    )
    if t.start_step:
        print(f"[resume] continuing from step {t.start_step}")
    res = t.run()
    if not res["history"]:
        print(f"nothing to do: the checkpoint is at step {t.start_step} of {args.steps}")
        return 0
    print(f"final loss: {res['history'][-1]['loss']:.4f}  "
          f"stragglers flagged: {len(res['stragglers'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
