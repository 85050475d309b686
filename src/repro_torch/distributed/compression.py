"""Gradient compression: int8 block-quantized all-reduce with error
feedback (port of ``repro.distributed.compression``).

The wire format is the reference's: each tensor is padded to whole
:data:`~repro_torch.quant.BLOCK` rows, every block's amax is max-reduced
across the axis (one scale shared by all shards, so the int32 sums
dequantize consistently), the blocks are quantized to int8
(``quant.quantize_blocks``), summed as int32, and dequantized to the mean.
The quantization residual of this shard's contribution is its new
error-feedback buffer, added to the next round's gradient (EF-SGD).

Both functions take the mesh's local stack (``compat``): ``grad`` [S, ...]
holds the S shards' gradients this process holds (one on a
``ProcessGroupMesh``, all P on a ``LocalMesh``), and ``ef`` the same.
"""
from __future__ import annotations

import torch

from repro_torch.quant import BLOCK, block_view, quantize_blocks

__all__ = ["BLOCK", "compressed_psum", "tree_compressed_psum"]

#: XLA rewrites the reference's ``amax / 127.0`` under ``jit`` as a product
#: with the float32 reciprocal; the port takes the same product
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def compressed_psum(grad: torch.Tensor, mesh, axis: str | None = None,
                    ef: torch.Tensor | None = None):
    """int8 error-feedback all-reduce of one tensor over ``axis``.

    Returns ``(mean_grad, new_ef)``: the mean, replicated, in ``grad``'s
    dtype and block shape (``grad.shape[1:]``), and the shards' new
    error-feedback buffers, float32 [S, ...]. ``ef`` is the buffer of the
    previous round (zeros, or None, at first)."""
    S, shape = grad.shape[0], grad.shape[1:]
    g = grad.to(torch.float32)
    if ef is not None:
        g = g + ef
    blocks = torch.stack([block_view(g[s].reshape(-1))[0] for s in range(S)])
    n = g[0].numel()
    local_amax = blocks.abs().amax(dim=2, keepdim=True)     # [S, nb, 1]
    amax = mesh.pmax(local_amax, axis)                       # [nb, 1]
    scale = torch.clamp(amax, min=1e-12) * _INV127.to(amax.device)
    q = quantize_blocks(blocks, scale)                       # [S, nb, BLOCK]
    total = mesh.psum(q.to(torch.int32), axis)
    world = mesh.psum(torch.ones((S,), dtype=torch.int32,
                                 device=grad.device), axis)
    mean = (total.to(torch.float32) * scale) / world.to(torch.float32)
    # XLA contracts ``blocks - q * scale`` into one fused multiply-add: the
    # product (at most 8 + 24 bits) and the difference are exact in
    # float64, so one rounding to float32 gives the fused result
    resid = (blocks.double() - q.double() * scale.double()).float()
    new_ef = resid.reshape(S, -1)[:, :n].reshape(S, *shape)
    out = mean.reshape(-1)[:n].reshape(shape)
    return out.to(grad.dtype), new_ef


def tree_compressed_psum(grads: dict, mesh, axis: str | None = None,
                         ef_tree: dict | None = None):
    """``compressed_psum`` over every leaf of a dict of local stacks.
    Returns ``(means, new_ef_tree)``, dicts of the same keys."""
    outs, efs = {}, {}
    for name, g in grads.items():
        e = None if ef_tree is None else ef_tree[name]
        if isinstance(g, dict):
            outs[name], efs[name] = tree_compressed_psum(g, mesh, axis, e)
        else:
            outs[name], efs[name] = compressed_psum(g, mesh, axis, e)
    return outs, efs
