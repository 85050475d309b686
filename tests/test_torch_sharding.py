"""``repro_torch.distributed.sharding`` against ``repro.distributed.sharding``.

The rules read nothing of a mesh but ``shape`` and ``axis_names``, so both
packages run in process on a stand-in mesh object (a dict of axis sizes,
as a JAX ``Mesh`` gives). For every one of the ten configs (reduced, and
at full width for the fsdp rule, whose 2^20-element threshold few reduced
leaves reach) and for the meshes (1, 1), (2, 2), (4, 2) and a (2, 4, 2)
pod mesh, each leaf's spec of ``param_spec_tree`` (fsdp off and on),
``batch_spec_tree`` and ``cache_spec_tree`` must be the reference's
``PartitionSpec`` entry for entry; ``bytes_of`` must agree on the cache.
The port's parameters are its module on ``meta`` (laid out by
``param_layout`` as ``models.model.stack`` stacks them), its cache and
batch tensors on ``meta``.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.distributed import sharding as JS
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.distributed import sharding as TS
from repro_torch.models import model as TM

torch.set_num_threads(1)

MESHES = {"1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2},
          "4x2": {"data": 4, "model": 2},
          "pod2x4x2": {"pod": 2, "data": 4, "model": 2}}


class StandIn:
    """What the rules read of a mesh."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _flat(tree, prefix=()):
    """(path, leaf) of a nested dict (the port's trees)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _ref_flat(tree):
    """(path, PartitionSpec) of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(tuple(str(getattr(p, "key", p)) for p in path), spec)
            for path, spec in leaves]


def _entry(e):
    """A spec entry in one spelling: ``PartitionSpec`` reads an empty tuple
    of axes as None (replicated) and a 1-tuple as its one axis."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def _assert_same(port_tree, ref_tree, what):
    ref = dict(_ref_flat(ref_tree))
    got = dict(_flat(port_tree))
    assert set(got) == set(ref), (what, sorted(set(got) ^ set(ref)))
    for path, spec in ref.items():
        want = tuple(_entry(e) for e in spec)
        have = tuple(_entry(e) for e in got[path])
        # the reference's PartitionSpec drops no trailing None; compare
        # padded to the leaf's rank
        n = max(len(want), len(have))
        want += (None,) * (n - len(want))
        have += (None,) * (n - len(have))
        assert have == want, (what, path, have, want)


def _cfgs(name):
    jc, tc = JC.get_config(name), TC.get_config(name)
    return jc.reduced(), tc.reduced(), jc, tc


@pytest.mark.parametrize("name", JC.ARCH_NAMES)
def test_param_specs_match_reference(name):
    jr, tr, jfull, tfull = _cfgs(name)
    for width, jc, tc in (("reduced", jr, tr), ("full", jfull, tfull)):
        ja = JM.abstract_params(jc)
        ta = TM.abstract_params(tc)
        for mname, sizes in MESHES.items():
            mesh = StandIn(sizes)
            for fsdp in (False, True):
                _assert_same(TS.param_spec_tree(tc, ta, mesh, fsdp=fsdp),
                             JS.param_spec_tree(jc, ja, mesh, fsdp=fsdp),
                             f"{name} {width} {mname} fsdp={fsdp}")


@pytest.mark.parametrize("name", JC.ARCH_NAMES)
def test_batch_and_cache_specs_match_reference(name):
    jc, tc, _, _ = _cfgs(name)
    for b in (1, 4, 8, 16):
        jb = JM.make_batch(jc, b, 16, abstract=True)
        tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
        jcache = jax.eval_shape(lambda: JM.init_cache(jc, b, 32))
        tcache = TM.init_cache(tc, b, 32, device="meta")
        assert TS.bytes_of(tcache) == JS.bytes_of(jcache)
        for mname, sizes in MESHES.items():
            mesh = StandIn(sizes)
            _assert_same(TS.batch_spec_tree(tc, tb, mesh),
                         JS.batch_spec_tree(jc, jb, mesh),
                         f"{name} batch {b} {mname}")
            _assert_same(TS.cache_spec_tree(tc, tcache, mesh),
                         JS.cache_spec_tree(jc, jcache, mesh),
                         f"{name} cache {b} {mname}")
            for reserve in (False, True):
                assert TS.batch_axes_for(b, mesh, reserve) == \
                    JS.batch_axes_for(b, mesh, reserve)


def test_param_layout_is_the_stacked_tree():
    """``param_layout`` of the port's module is the shapes of
    ``models.model.stack`` of its parameters."""
    cfg = TC.get_config("recurrentgemma-9b").reduced()
    params = TM.init_params(cfg, 0, device="cpu")
    want = {p: tuple(v.shape) for p, v in _flat(
        TM.stack(params.named_parameters()))}
    got = {p: tuple(s) for p, s in _flat(TS.param_layout(params))}
    assert got == want


def test_shard_leaf_splits_row_major():
    """A dimension split over (pod, data) takes the piece at the rank's
    row-major coordinate over those axes; unsplit dims stay whole."""
    class Mesh3:
        shape = (2, 2, 2)
        axis_names = ("pod", "data", "model")
        coords = (1, 0, 1)

    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    got = TS.shard_leaf(t, (("pod", "data"), "model"), Mesh3())
    np.testing.assert_array_equal(got.numpy(), t[4:6, 3:6].numpy())
    with pytest.raises(ValueError, match="does not split"):
        TS.shard_leaf(torch.zeros(3, 2), ("data", None), Mesh3())
