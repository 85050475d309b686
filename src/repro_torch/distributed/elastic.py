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

The third family is model parameters (the reference's params tree of
whole leaves, as ``models.model.stack`` lays them out): on a process-group
mesh each rank keeps its slice of every leaf under the target mesh's
``distributed.sharding.param_spec_tree`` (``cfg=`` keys the rules), cut
by ``sharding.param_cut`` (Mamba-2's concatenated leaves part by part). With
``old_mesh=`` the leaves are this rank's slices under the old mesh's specs,
gathered whole first, so a tree moves from one mesh shape to another over
the same ranks.
"""
from __future__ import annotations

from typing import Any

import torch


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
                 builder: str = "knng", capacity: int | None = None,
                 old_mesh=None) -> Any:
    """Re-place ``tree`` onto ``new_mesh`` (or a bare ``shards=`` count).

    ``all_vectors`` / ``M`` / ``builder`` go to a ``ShardedIndex``
    (quantized corpora, non-default graph builds); ``capacity`` to a
    ``ShardedSearchState`` (the target queue width, default the current
    one). ``cfg`` / ``spec_fn`` / ``old_mesh`` belong to the
    model-parameter family (see the module's docstring)."""
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
    if new_mesh is None:
        raise ValueError("resharding a model-param tree needs new_mesh= "
                         "(a process-group mesh; the rank keeps its slices)")
    if cfg is None:
        raise ValueError("resharding a model-param tree needs cfg= "
                         "(the sharding rules key on it)")
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.model import abstract_params

    layout = sh.param_layout(abstract_params(cfg))
    spec_fn = spec_fn or sh.param_spec_tree
    new_specs = spec_fn(cfg, layout, new_mesh)
    if old_mesh is not None:
        tree = _zip(tree, spec_fn(cfg, layout, old_mesh),
                    lambda path, x, s: sh.param_cut(
                        cfg, path, s, old_mesh).gather(x, old_mesh))
    return _zip(tree, new_specs,
                lambda path, x, s: sh.param_cut(cfg, path, s, new_mesh)
                .shard(torch.as_tensor(x), new_mesh))


def _zip(tree: dict, specs: dict, fn, path=()) -> dict:
    """``fn(path, leaf, spec)`` over two trees of the same keys."""
    if set(tree) != set(specs):
        raise ValueError(f"the tree's keys {sorted(tree)} are not the "
                         f"params' {sorted(specs)}")
    return {k: _zip(v, specs[k], fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v, specs[k]) for k, v in tree.items()}
