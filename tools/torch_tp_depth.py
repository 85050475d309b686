#!/usr/bin/env python3
"""How far a mamba2-370m train step over a (1, 2) tensor-parallel mesh
drifts from one process's with depth, on one CUDA card.

Run from the root of a checkout, on a machine with a card:

    python3 tools/torch_tp_depth.py [12 24 48]

For each depth (mamba2-370m at full width with that many layers, the
seeded model and batch of ``chip_smoke.py``'s phase 16 (d), B = 16,
S = 64) it takes one train step on one process, then on 2 gloo ranks
sharing the card (``chip_smoke.tp16_rank``'s arithmetic, deterministic
algorithms on both), and prints, as one JSON line: the losses, the
first-step gradients' worst gaps in bf16 ulps of each leaf's largest
(``chip_smoke.tp16_grad_gap``, gated there at TRAIN_GRAD_ULPS), each leaf
kind's largest |gradient|, and the largest within-chunk decay exponent
``seg`` of the forward's SSD (its float32 exp overflows past ~88.7).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "src")]


def _cfg(layers: int):
    import chip_smoke as cs
    return dataclasses.replace(cs.tp16d_cfg("mamba2-370m"),
                               num_layers=layers)


def _step(torch, cfg, params, batch, mesh):
    import chip_smoke as cs
    from repro_torch.launch import steps as S
    from repro_torch.train import optimizer as O

    opt = cs.GradCapture(O.AdamW(lr=O.cosine_schedule(3e-3, 1,
                                                      cs.TRAIN_STEPS)))
    step, _ = S.build_train_step(cfg, mesh, optimizer=opt)
    state = opt.init(params)
    torch.use_deterministic_algorithms(True)
    try:
        _, _, loss = step(params, state, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    return float(loss), opt.first


def _batch(torch, cfg, device):
    import chip_smoke as cs
    b = cs.tp16_batches(cfg, 0, 1)[0]
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def rank_body(rank, world, tmp, depths):
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.models import model as M

    dev, mesh = cs.pg_rank_mesh(torch, rank, world, tmp, "depth", "gloo",
                                shape=(1, world), axes=("data", "model"))
    out = {}
    for n in depths:
        cfg = _cfg(n)
        params = cs.tp16d_params(torch, M, cfg, 0, dev, mesh)
        loss, first = _step(torch, cfg, params, _batch(torch, cfg, dev),
                            mesh)
        one = torch.load(os.path.join(tmp, f"one_{n}.pt"))
        out[n] = dict(loss=loss, one_process_loss=one["loss"],
                      grads=cs.tp16_grad_gap(torch, M, params, first,
                                             one["grads"]),
                      largest=one["largest"], seg_max=one["seg_max"])
        del params, first, one
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        with open(os.path.join(tmp, "depth.json"), "w") as f:
            json.dump(out, f)
    mesh.barrier()
    dist.destroy_process_group()


def main() -> int:
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.models import model as M
    from repro_torch.models import ssm

    depths = [int(a) for a in sys.argv[1:]] or [12, 24, 48]
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    tmp = tempfile.mkdtemp(prefix="tp_depth_")
    real, segs = ssm.ssd_chunked, []

    def spy(xh, dt, A, B_, C_, chunk=128, h0=None):
        with torch.no_grad():
            c = min(chunk, dt.shape[1])
            cum = torch.cumsum(dt[:, :c].float() * A, dim=1)
            segs.append(float((cum[:, :, None] - cum[:, None]).max()))
        return real(xh, dt, A, B_, C_, chunk=chunk, h0=h0)

    for n in depths:
        cfg = _cfg(n)
        params = cs.tp16d_params(torch, M, cfg, 0, dev)
        segs.clear()
        ssm.ssd_chunked = spy
        try:
            loss, first = _step(torch, cfg, params, _batch(torch, cfg, dev),
                                None)
        finally:
            ssm.ssd_chunked = real
        largest: dict = {}
        for name, g in first.items():
            kind = name.split(".")[-1]
            largest[kind] = max(largest.get(kind, 0.0),
                                float(g.float().abs().max()))
        torch.save({"loss": loss, "grads": {k: v.cpu()
                                            for k, v in first.items()},
                    "largest": largest, "seg_max": max(segs)},
                   os.path.join(tmp, f"one_{n}.pt"))
        del params, first
        gc.collect()
        torch.cuda.empty_cache()
    cs.pg_spawn(torch, rank_body, 2, tmp, depths)
    with open(os.path.join(tmp, "depth.json")) as f:
        print(f.read(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
