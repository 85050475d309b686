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

Under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` in the
environment) it trains data parallel, as the reference's launcher does
over its devices: the process group is made with ``--backend`` (no
default: ``nccl`` with one card per rank, ``gloo`` on the CPU or with
ranks sharing a card) from torchrun's ``env://`` rendezvous, each rank
runs on ``cuda:LOCAL_RANK`` (with ``--device cuda``, the default) and the
mesh is the reference's ``(world, 1)`` data x model mesh:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --backend nccl --steps 100 --batch 16

Without those variables it runs on one device exactly as before.
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
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the process group's backend under torchrun")
    ap.add_argument("--init-method", default="env://",
                    help="the process group's rendezvous under torchrun "
                         "(its env:// unless given)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh, device = None, args.device
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        mesh, device = _torchrun_mesh(args)
    rep = train(cfg, mesh, steps=args.steps, global_batch=args.batch,
                seq_len=args.seq, ckpt_dir=args.ckpt,
                ckpt_every=args.ckpt_every,
                optimizer=AdamW(lr=cosine_schedule(
                    args.lr, args.steps // 10, args.steps)),
                device=device)
    if mesh is not None:
        import torch.distributed as dist
        rank = mesh.rank
        dist.destroy_process_group()
        if rank != 0:
            return 0
    print(f"done: {rep.steps_run} steps, final loss {rep.final_loss:.4f}, "
          f"restarts={rep.restarts}")
    return 0


def _torchrun_mesh(args):
    """The ``(world, 1)`` mesh over torchrun's ranks, and this rank's
    device."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.compat import make_process_mesh

    if args.backend is None:
        raise SystemExit("under torchrun, pass --backend nccl or gloo")
    world = int(os.environ["WORLD_SIZE"])
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    mesh = make_process_mesh(
        (world, 1), ("data", "model"), backend=args.backend,
        init_method=args.init_method, rank=int(os.environ["RANK"]),
        world_size=world, device=device)
    return mesh, device


if __name__ == "__main__":
    raise SystemExit(main())
