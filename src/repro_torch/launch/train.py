"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 100 --batch 16 --seq 64 [--ckpt DIR] [--device cuda]

Uses the fault-tolerant loop (checkpoint / restart, straggler monitor,
prefetching data pipeline) on ``--device`` (``cuda`` unless given). As the
reference's, ``--reduced`` is on whatever the command line says (its flag
is ``store_true`` with default True), so the launcher always trains the
arch's reduced config; ``train.loop.train`` takes a full config. The
checkpoints go under ``--ckpt`` (``repro_ckpt`` in the temporary
directory unless given).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamW, cosine_schedule


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rep = train(cfg, None, steps=args.steps, global_batch=args.batch,
                seq_len=args.seq, ckpt_dir=args.ckpt,
                ckpt_every=args.ckpt_every,
                optimizer=AdamW(lr=cosine_schedule(
                    args.lr, args.steps // 10, args.steps)),
                device=args.device)
    print(f"done: {rep.steps_run} steps, final loss {rep.final_loss:.4f}, "
          f"restarts={rep.restarts}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
