"""repro_torch graph carriers and index.flat against the reference: the
KNN-graph builder, exact top-k, from_host/to_host, descend and the lane
state carrier."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import lane_state as jls
from repro.index import flat as jflat
from repro_torch.core import graph as tgraph
from repro_torch.core import lane_state as tls
from repro_torch.index import flat as tflat

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _reference_knn(x, metric, overfetch):
    """The reference builder's candidate lists (its numpy top-k)."""
    sims = jflat._sims_block(x, x, metric)
    sims[np.arange(len(x)), np.arange(len(x))] = -np.inf
    part = np.argpartition(-sims, overfetch, axis=1)[:, :overfetch]
    ps = np.take_along_axis(sims, part, axis=1)
    return np.take_along_axis(part, np.argsort(-ps, axis=1, kind="stable"), 1)


@pytest.mark.parametrize("metric,fixture", [("l2", "small_graph"),
                                            ("cos", "small_graph_cos")])
def test_build_knn_graph_matches_reference(clustered_data, metric, fixture,
                                           request):
    """From the same candidate lists every pass gives the reference's
    neighbours exactly; the whole builder does too, except that clustered
    cosine data has exact float32 ties near sim = 1, which the reference
    orders by numpy's argpartition and the port by ``torch.topk``."""
    ref = request.getfixturevalue(fixture)
    x = clustered_data
    got = tflat.build_knn_graph(x, metric=metric, M=8, device="cpu")
    a, b = got.neighbors.numpy(), np.asarray(ref.neighbors)
    assert got.entry == int(ref.entry)
    assert got.metric == metric and got.num_upper_levels == 0
    rows = np.flatnonzero((a != b).any(axis=1))
    assert rows.size == 0 if metric == "l2" else rows.size <= 3
    # the port's top-k lists hold the reference's candidates at bitwise
    # equal similarities: they differ only in the order of exact ties
    xt = torch.from_numpy(x)
    norms = tflat._norm_terms(x, metric)
    norms_t = None if norms is None else torch.from_numpy(norms)
    knn_ref = _reference_knn(x, metric, 48)
    knn = tflat._exact_knn(xt, norms_t, 48, metric, 512)
    sims = jflat._sims_block(x, x, metric)
    np.testing.assert_array_equal(np.take_along_axis(sims, knn, 1),
                                  np.take_along_axis(sims, knn_ref, 1))
    nb = tflat._alpha_prune(xt, norms_t, knn_ref, 16, metric, 1.0, 4096)
    nb = tflat._add_reverse_edges(nb)
    nb = tflat._stitch_components(xt, norms_t, nb, got.entry, metric)
    nb = tflat._directed_repair(xt, norms_t, nb, got.entry, knn_ref, metric)
    np.testing.assert_array_equal(nb, b)


def test_reverse_edges_and_repairs_match_reference():
    """Tiny graphs leave free slots and islands: the order-dependent
    passes (reverse edges, stitching, directed repair) then do work."""
    rng = np.random.default_rng(4)
    centers = rng.normal(size=(6, 8)) * 6.0
    x = (centers[rng.integers(0, 6, 40)]
         + rng.normal(size=(40, 8)) * 0.2).astype(np.float32)
    for M in (8, 24):
        ref = jflat.build_knn_graph(x, metric="l2", M=M)
        got = tflat.build_knn_graph(x, metric="l2", M=M, device="cpu")
        np.testing.assert_array_equal(got.neighbors.numpy(),
                                      np.asarray(ref.neighbors))
        assert got.entry == int(ref.entry)


def test_exact_topk_matches_reference(clustered_data):
    qs = clustered_data[:7] + 0.01
    ids, sc = tflat.exact_topk(qs, clustered_data, 10, "l2", device="cpu")
    rids, rsc = jflat.exact_topk(qs, clustered_data, 10, "l2")
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_allclose(sc, rsc, rtol=1e-5, atol=1e-5)


def test_from_host_round_trip_and_quantized_refusal(small_graph):
    host = jgraph.to_host(small_graph)
    g = tgraph.from_host(host, device="cpu")
    back = tgraph.to_host(g)
    for key in ("vectors", "neighbors", "upper"):
        np.testing.assert_array_equal(back[key], host[key])
    assert back["entry"] == host["entry"] and back["metric"] == "l2"
    assert g.vectors.dtype == torch.float32 and g.neighbors.dtype == torch.int32
    with pytest.raises(TypeError, match="quantized"):
        tgraph.from_host(dict(host, vectors=host["vectors"].astype(np.int8)),
                         device="cpu")


def test_descend_through_upper_levels_matches_reference(clustered_data):
    rng = np.random.default_rng(1)
    n = clustered_data.shape[0]
    nbrs = rng.integers(0, n, (n, 8)).astype(np.int32)
    upper = np.full((2, n, 4), -1, np.int32)
    upper[0, :, :] = rng.integers(0, n, (n, 4))
    upper[1, :, :3] = rng.integers(0, n, (n, 3))
    jg = jgraph.make_flat_graph(clustered_data, nbrs, upper, 5, "l2")
    tg = tgraph.from_host(jgraph.to_host(jg), device="cpu")
    for q in clustered_data[[3, 100, 400]] + 0.05:
        assert tgraph.descend(tg, torch.from_numpy(q)) == int(
            jgraph.descend(jg, jnp.asarray(q)))


def test_lane_state_carrier_matches_port_init(small_graph, clustered_data):
    qs = clustered_data[[1, 50, 300]] + 0.02
    jstate = jls.init_lanes(small_graph, jnp.asarray(qs), 256)
    host = ((np.asarray(jstate.queue.ids), np.asarray(jstate.queue.scores),
             np.asarray(jstate.queue.stable)), np.asarray(jstate.visited),
            np.asarray(jstate.steps))
    carried = tls.from_host(host, device="cpu")
    tg = tgraph.from_host(jgraph.to_host(small_graph), device="cpu")
    mine = tls.init_lanes(tg, torch.from_numpy(qs), 256)
    for a, b in zip(carried.queue, mine.queue):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert torch.equal(carried.visited, mine.visited)
    assert torch.equal(carried.steps, mine.steps)
