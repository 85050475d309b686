"""``repro_torch.distributed.{compression,collectives}`` against the
reference's on four ranks.

The reference runs in one subprocess with four forced host devices under
``shard_map`` (``tests/dist_scripts/compression_check.py`` and
``ring_matmul_check.py``'s inputs, plus a second round with error
feedback, a ragged leaf of 3 000 elements and ``tree_compressed_psum``)
and saves every device's outputs. The port runs the same calls on four
spawned gloo ranks (``tests/torch_dist_ranks.py``) and, in process, on a
``LocalMesh`` of four. ``compressed_psum``'s mean and new error feedback
must be the reference's bit for bit (its wire format is the reference's);
both matmuls within the reference script's 1e-5 of ``x @ w``, and the
process group's equal to the ``LocalMesh``'s bit for bit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro_torch.compat import make_mesh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TESTS = os.path.dirname(os.path.abspath(__file__))

REF_SCRIPT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.distributed.collectives import allgather_matmul, ring_allgather_matmul
from repro.distributed.compression import compressed_psum, tree_compressed_psum
import torch_dist_ranks as R

a = {k: np.asarray(v) for k, v in R.collectives_inputs().items()}
mesh = make_mesh((4,), ("data",))

def rounds(g, g2):
    m1, e1 = compressed_psum(g[0], "data", None)
    m2, e2 = compressed_psum(g2[0], "data", e1)
    return m1[None], e1[None], m2[None], e2[None]

def tree(g, r):
    m, e = tree_compressed_psum({"g": g[0], "r": r[0]}, "data")
    return m["g"][None], m["r"][None], e["r"][None]

run = jax.jit(shard_map(rounds, mesh, in_specs=(P("data"), P("data")),
                        out_specs=(P("data"),) * 4))
out = dict(zip(("mean", "ef", "mean2", "ef2"), run(a["g"], a["g2"])))
trun = jax.jit(shard_map(tree, mesh, in_specs=(P("data"), P("data")),
                         out_specs=(P("data"),) * 3))
out.update(zip(("tree_g", "tree_r", "tree_ef_r"), trun(a["g"], a["r"])))
for name, fn in (("agmm", allgather_matmul), ("ringmm", ring_allgather_matmul)):
    f = jax.jit(shard_map(lambda x, w, fn=fn: fn(x, w, "data"), mesh,
                          in_specs=(P("data"), P()), out_specs=P()))
    out[name] = f(a["x"], a["w"])
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's run, started with the module so that it overlaps
    the ranks; stopped when the module ends."""
    path = str(tmp_path_factory.mktemp("collref") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [SRC, TESTS, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, path
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def ref(reference):
    proc, path = reference
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("coll4"))
    R.spawn(R.collectives_rank, 4, tmp)
    return [R.load(tmp, "collgloo", r) for r in range(4)]


@pytest.fixture(scope="module")
def local():
    mesh = make_mesh((4,), ("data",), device="cpu")
    return {k: v.numpy() for k, v in R.collectives_ops(
        mesh, R.collectives_inputs(), slice(0, 4)).items()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("key", ["mean", "mean2", "tree_g", "tree_r"])
def test_compressed_mean_bit_equal_to_reference(ranks, ref, local, key):
    """The replicated mean, on every rank and on the LocalMesh."""
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(_bits(got[key]), _bits(ref[key][r]),
                                      err_msg=f"rank {r} {key}")
    np.testing.assert_array_equal(_bits(local[key]), _bits(ref[key][0]))


@pytest.mark.parametrize("key", ["ef", "ef2", "tree_ef_r"])
def test_error_feedback_bit_equal_to_reference(ranks, ref, local, key):
    """Each shard's new buffer, the second round's after the first's
    feedback."""
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(_bits(got[key][0]), _bits(ref[key][r]),
                                      err_msg=f"rank {r} {key}")
    np.testing.assert_array_equal(_bits(local[key]), _bits(ref[key]))


def test_compressed_mean_is_close_to_the_mean():
    """The reference script's own bounds: the mean within 5 % of the true
    mean's largest magnitude, the residual under 2 % of the inputs'."""
    a = R.collectives_inputs()
    mesh = make_mesh((4,), ("data",), device="cpu")
    from repro_torch.distributed.compression import compressed_psum

    mean, ef = compressed_psum(a["g"], mesh)
    true = a["g"].mean(0)
    err = float((mean - true).abs().max() / (true.abs().max() + 1e-9))
    assert err < 0.05, err
    assert float(ef.abs().max()) < float(a["g"].abs().max()) * 0.02


@pytest.mark.parametrize("key", ["agmm", "ringmm"])
def test_matmuls_match_reference(ranks, ref, local, key):
    a = R.collectives_inputs()
    want = (a["x"] @ a["w"]).numpy()
    np.testing.assert_allclose(ref[key], want, rtol=1e-5, atol=1e-5)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[key], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(_bits(got[key]), _bits(local[key]),
                                      err_msg=f"rank {r}")
