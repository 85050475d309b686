"""``compat.ProcessGroupMesh`` against ``compat.LocalMesh`` on gloo ranks.

Four spawned ranks (``tests/torch_dist_ranks.py``, no JAX in them) each
run every collective on their own block of seeded integer-valued inputs
(so every sum is exact in any order): ``psum``, ``pmax``, ``all_gather``
at each axis and ``exchange`` over the butterfly and ring permutations
must equal the one-process ``LocalMesh`` result on the stacked blocks, row
by row. The same ranks lay out the reference's ``make_test_mesh`` (2, 2)
and pod (2, 1, 2) meshes, whose axis sub-groups are checked by hand, and
``batch_axes``. One rank alone must also equal a ``LocalMesh`` of one.
"""
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro_torch.compat import make_mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh4"))
    R.spawn(R.mesh_rank, 4, tmp)
    return [R.load(tmp, "meshgloo", r) for r in range(4)]


@pytest.fixture(scope="module")
def rank1(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh1"))
    R.spawn(R.mesh_rank, 1, tmp)
    return [R.load(tmp, "meshgloo", 0)]


@pytest.fixture(scope="module")
def local4():
    return _full_local(4)


def _full_local(world):
    x = R.mesh_inputs(world)
    mesh = make_mesh((world,), ("data",), device="cpu")
    out = {}
    for name, t in x.items():
        out[f"psum_{name}"] = mesh.psum(t)
        out[f"pmax_{name}"] = mesh.pmax(t)
        for axis in range(t.dim()):
            out[f"gather{axis}_{name}"] = mesh.all_gather(t, axis=axis)
        for ex, src in R.exchanges(world).items():
            out[f"{ex}_{name}"] = mesh.exchange(t, src)
    out["axis_index"] = mesh.axis_index()
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("op", ["psum", "pmax"])
def test_reductions_equal_local_mesh(ranks4, local4, op):
    for r, got in enumerate(ranks4):
        for name in ("f", "i"):
            np.testing.assert_array_equal(got[f"{op}_{name}"],
                                          local4[f"{op}_{name}"])
            assert got[f"{op}_{name}"].dtype == local4[f"{op}_{name}"].dtype


def test_all_gather_equals_local_mesh(ranks4, local4):
    for got in ranks4:
        for key in [k for k in local4 if k.startswith("gather")]:
            np.testing.assert_array_equal(got[key], local4[key], err_msg=key)


@pytest.mark.parametrize("ex", ["xor1", "xor2", "ring_next", "ring_prev"])
def test_exchange_equals_local_mesh(ranks4, local4, ex):
    """A rank's exchange is the row of the LocalMesh's ``ppermute`` it
    holds."""
    for r, got in enumerate(ranks4):
        for name in ("f", "i"):
            np.testing.assert_array_equal(got[f"{ex}_{name}"],
                                          local4[f"{ex}_{name}"][r:r + 1])


def test_axis_index_and_broadcast(ranks4, local4):
    for r, got in enumerate(ranks4):
        np.testing.assert_array_equal(got["axis_index"],
                                      local4["axis_index"][r:r + 1])
        assert int(got["bcast"]) == 0
        assert int(got["staged"]) == 0       # CPU tensors are not staged


def test_test_mesh_2x2_axes(ranks4):
    """(2, 2) data x model: rank r at (r // 2, r % 2); a collective along
    one axis reads the other axis's coordinate fixed."""
    f = R.mesh_inputs(4)["f"].numpy().reshape(2, 2, 3, 5)
    for r, got in enumerate(ranks4):
        d, m = divmod(r, 2)
        assert tuple(got["coords_2x2"]) == (d, m)
        assert tuple(got["batch_axes_2x2"]) == ("data",)
        np.testing.assert_array_equal(got["psum_data"], f[:, m].sum(0))
        np.testing.assert_array_equal(got["psum_model"], f[d].sum(0))
        np.testing.assert_array_equal(got["gather_data"],
                                      np.moveaxis(f[:, m], 0, 1))
        np.testing.assert_array_equal(got["gather_model"],
                                      np.moveaxis(f[d], 0, 1))
        np.testing.assert_array_equal(got["xor_data"], f[1 - d, m][None])
        np.testing.assert_array_equal(got["xor_model"], f[d, 1 - m][None])
        assert list(got["index_data"]) == [d]
        assert list(got["index_model"]) == [m]


def test_pod_mesh_axes(ranks4):
    f = R.mesh_inputs(4)["f"].numpy().reshape(2, 1, 2, 3, 5)
    for r, got in enumerate(ranks4):
        p, m = divmod(r, 2)
        assert tuple(got["coords_pod"]) == (p, 0, m)
        assert tuple(got["batch_axes_pod"]) == ("pod", "data")
        np.testing.assert_array_equal(got["psum_pod"], f[:, 0, m].sum(0))


def test_one_rank_equals_local_mesh(rank1):
    want = _full_local(1)
    got = rank1[0]
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)


def test_make_process_mesh_needs_the_group_arguments():
    """No default group and not all of (backend, init_method, rank,
    world_size): refused, nothing chosen for the caller."""
    import torch.distributed as dist

    from repro_torch.compat import make_process_mesh

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="backend"):
        make_process_mesh((2,), ("data",), init_method="file:///nowhere",
                          rank=0, world_size=2)
