"""Elastic scaling: move serving state between differently-sized meshes
(port of ``repro.distributed.elastic``).

``plan`` summarizes a mesh change for logs and controllers; ``reshard_tree``
moves a tree across it. Two tree families are served, both laid out by the
tree itself plus the target shard count:

* ``ShardedIndex`` (the corpus): the stacked rows re-blocked onto the new
  shard count, quantized codes and scales exactly, shard graphs rebuilt
  (``sharded_search.reshard_index``);
* ``ShardedSearchState`` (in-flight lane beams): every lane's per-shard
  queues and visited rows re-bucketed by global id
  (``sharded_search.migrate_sharded_state``), so paused searches resume on
  the new topology without redoing expansions.

    new_mesh = make_mesh((4,), ("data",))
    idx4 = reshard_tree(idx2, new_mesh, all_vectors=x)
    st4 = reshard_tree(st2, new_mesh, capacity=cap4)

The reference's third family, model parameters placed by name-based
sharding rules, belongs to the training stack (ROADMAP queue 1 G).
"""
from __future__ import annotations

from typing import Any


def plan(old_mesh, new_mesh) -> dict:
    """What changes between two meshes: ``old`` / ``new`` axis sizes, the
    ``data`` and ``model`` growth ratios (``dp_change`` / ``tp_change``) and
    every named axis's (``axis_changes``). ``plan(a, b)`` and ``plan(b, a)``
    are exact inverses."""
    old = dict(zip(old_mesh.axis_names, (int(s) for s in old_mesh.shape)))
    new = dict(zip(new_mesh.axis_names, (int(s) for s in new_mesh.shape)))
    changes = {a: new.get(a, 1) / old.get(a, 1)
               for a in sorted(set(old) | set(new))}
    return dict(old=old, new=new, dp_change=changes.get("data", 1.0),
                tp_change=changes.get("model", 1.0), axis_changes=changes)


def reshard_tree(tree: Any, new_mesh=None, cfg=None, spec_fn=None, *,
                 axis: str = "data", shards: int | None = None,
                 all_vectors=None, M: int | None = None,
                 builder: str = "knng", capacity: int | None = None) -> Any:
    """Re-place ``tree`` onto ``new_mesh`` (or a bare ``shards=`` count).

    ``all_vectors`` / ``M`` / ``builder`` go to a ``ShardedIndex``
    (quantized corpora, non-default graph builds); ``capacity`` to a
    ``ShardedSearchState`` (the target queue width, default the current
    one). ``cfg`` / ``spec_fn`` belong to the model-parameter family, which
    raises ``NotImplementedError``."""
    from repro_torch.sharded_search.search import (ShardedIndex,
                                                   ShardedSearchState,
                                                   migrate_sharded_state,
                                                   reshard_index)

    if shards is None:
        if new_mesh is None:
            raise ValueError("reshard_tree needs a new_mesh or shards=")
        shards = int(dict(zip(new_mesh.axis_names,
                              new_mesh.shape)).get(axis, 1))
    if isinstance(tree, ShardedIndex):
        return reshard_index(tree, shards, all_vectors, M=M, builder=builder)
    if isinstance(tree, ShardedSearchState):
        return migrate_sharded_state(tree, shards, capacity, mesh=new_mesh,
                                     axis=axis)
    del cfg, spec_fn
    raise NotImplementedError(
        "resharding a model-parameter tree needs sharding rules over a "
        "process-group mesh, which are not ported yet — ROADMAP queue 1 D")
