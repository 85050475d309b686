"""The paper's baselines and the diversity-graph helpers:
repro_torch.core.{baselines,batch,diversity_graph} and the single-lane
kernels.ops.greedy_diversify against repro.core / repro.kernels.ops on the
conftest graphs (shared through to_host -> from_host), on the CPU with the
reference at impl="ref".

Ids, selections, counts and certificates must be equal; scores may differ
by rtol = atol = 1e-5 and totals by 1e-4 (the two packages reduce in
different orders). The oracle's exact l2 scores are the exception: both
packages take the squared distance as |q|^2 + |x|^2 less twice the dot,
each in its own product, so a near neighbour's score carries the rounding
of the two large terms; they are held through the squared distance they
encode, d2 = (1 - s)^2, to ~8 float32 ulps of |q|^2 + |x|^2, as
tests/test_torch_beam_search.py holds the beam's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro.core import batch as jbatch
from repro.core import diversity_graph as jdg
from repro.core.graph import to_host
from repro.kernels import ops as jops
from repro_torch.core import baselines as tbl
from repro_torch.core import batch as tbatch
from repro_torch.core import diversity_graph as tdg
from repro_torch.core import graph as tgraph
from repro_torch.core.similarity import pairwise_sim
from repro_torch.kernels import ops as tops

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

RTOL = ATOL = 1e-5
TOTAL_TOL = 1e-4
D2_ULPS = 1e-6       # ~8 float32 ulps of |q|^2 + |x|^2
EPS = {"l2": -1.0, "cos": 0.98}


@pytest.fixture(scope="module")
def graphs(small_graph, small_graph_cos):
    return {"l2": (small_graph, tgraph.from_host(to_host(small_graph),
                                                 device="cpu")),
            "cos": (small_graph_cos,
                    tgraph.from_host(to_host(small_graph_cos), device="cpu"))}


def _queries(x, num=3, seed=5):
    rng = np.random.default_rng(seed)
    return (x[rng.integers(0, x.shape[0], num)]
            + rng.normal(size=(num, x.shape[1])) * 0.05).astype(np.float32)


def _assert_same(got, ref, what=""):
    np.testing.assert_array_equal(got.ids, np.asarray(ref.ids), err_msg=what)
    np.testing.assert_allclose(got.scores, np.asarray(ref.scores), rtol=RTOL,
                               atol=ATOL, err_msg=what)
    assert abs(got.total - ref.total) <= TOTAL_TOL, what
    assert got.stats.K_final == ref.stats.K_final, what
    assert got.stats.certified == ref.stats.certified, what


def _assert_oracle_same(got, ref, q, x, metric, what):
    """``_assert_same`` for the oracle, its l2 scores held through d2."""
    if metric != "l2":
        return _assert_same(got, ref, what)
    np.testing.assert_array_equal(got.ids, ref.ids, err_msg=what)
    assert (got.stats.K_final, got.stats.certified) == (
        ref.stats.K_final, ref.stats.certified), what
    ok = got.ids >= 0
    g, r = got.scores[ok].astype(np.float64), ref.scores[ok].astype(np.float64)
    mag = (q @ q + (x[got.ids[ok]] ** 2).sum(1)).astype(np.float64)
    np.testing.assert_array_less(np.abs((1 - g) ** 2 - (1 - r) ** 2),
                                 D2_ULPS * mag + 1e-7, err_msg=what)


def _tie_free_ids(x, metric, eps, W, seed):
    """W distinct candidate ids with no pair's similarity within 1e-4 of
    eps (a pair on eps may round to either side in the two packages), the
    last few padding (-1)."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(x.shape[0], 4 * W, replace=False)
    s = pairwise_sim(torch.from_numpy(x[ids]), torch.from_numpy(x[ids]),
                     metric).numpy()
    near = (np.abs(s - eps) <= 1e-4) & ~np.eye(len(ids), dtype=bool)
    keep = ids[~near.any(axis=1)][:W].astype(np.int32)
    assert len(keep) == W
    keep[-3:] = -1
    return keep


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_build_and_extend_adjacency_match_reference(graphs, clustered_data,
                                                    metric):
    jg, tg = graphs[metric]
    eps = EPS[metric]
    new = _tie_free_ids(clustered_data, metric, eps, 96, seed=1)
    tadj = tdg.build_adjacency(tg, torch.from_numpy(new), eps)
    jadj = jdg.build_adjacency(jg, jnp.asarray(new), eps)
    np.testing.assert_array_equal(tadj.numpy(), np.asarray(jadj))
    old = torch.from_numpy(new[:64])
    t_old = tdg.build_adjacency(tg, old, eps)
    text = tdg.extend_adjacency(tg, t_old, old, torch.from_numpy(new), eps)
    jext = jdg.extend_adjacency(jg, jdg.build_adjacency(jg, jnp.asarray(
        new[:64]), eps), jnp.asarray(new[:64]), jnp.asarray(new), eps)
    np.testing.assert_array_equal(text.numpy(), np.asarray(jext))
    # extending a prefix equals building the longer prefix fresh
    np.testing.assert_array_equal(text.numpy(), tadj.numpy())
    assert tadj.any() and not tadj.diagonal().any()
    # equal widths: the old adjacency comes back unchanged
    assert tdg.extend_adjacency(tg, t_old, old, old, eps) is t_old


@pytest.mark.parametrize("W", [1, 33, 64, 100])
def test_single_lane_greedy_matches_reference(W):
    """Tied scores (lowest index wins), padding, and a dense adjacency."""
    rng = np.random.default_rng(W)
    scores = np.round(rng.normal(size=W), 1).astype(np.float32)
    valid = rng.random(W) > 0.15
    adj = rng.random((W, W)) < 0.2
    adj = adj | adj.T
    np.fill_diagonal(adj, False)
    for k in (1, 5, 10):
        jsel, jcnt = jops.greedy_diversify(jnp.asarray(scores),
                                           jnp.asarray(adj), k,
                                           valid=jnp.asarray(valid),
                                           impl="ref")
        tsel, tcnt = tops.greedy_diversify(torch.from_numpy(scores),
                                           torch.from_numpy(adj), k,
                                           valid=torch.from_numpy(valid))
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
        assert int(tcnt) == int(jcnt)
        # one lane of the batched op
        bsel, bcnt = tops.greedy_diversify_batch(
            torch.from_numpy(scores)[None], torch.from_numpy(adj)[None], k,
            valid=torch.from_numpy(valid)[None])
        assert torch.equal(bsel[0], tsel) and int(bcnt[0]) == int(tcnt)


@pytest.mark.parametrize("metric,eps", [("l2", -2.0), ("cos", 0.95)])
def test_div_astar_oracle_doubles_like_reference(clustered_data, metric, eps):
    """X = 64 is too few to certify: X doubles, and the final X and the
    div-A* certificate equal the reference's."""
    qs = _queries(clustered_data, seed=3)
    grew = 0
    for i, q in enumerate(qs):
        ref = jbl.div_astar_oracle(clustered_data, metric, q, 5, eps, X=64)
        got = tbl.div_astar_oracle(clustered_data, metric, q, 5, eps, X=64,
                                   device="cpu")
        _assert_oracle_same(got, ref, q, clustered_data, metric,
                            f"query {i}")
        grew += got.stats.K_final > 64
    assert grew
    # no growth when asked not to
    one = tbl.div_astar_oracle(clustered_data, metric, qs[1], 5, eps, X=64,
                               grow_until_certified=False, device="cpu")
    assert one.stats.K_final == 64


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_greedy_fixed_and_ip_greedy_match_reference(graphs, clustered_data,
                                                    metric):
    jg, tg = graphs[metric]
    for i, q in enumerate(_queries(clustered_data)):
        _assert_same(tbl.greedy_fixed(tg, q, 5, EPS[metric], L=96),
                     jbl.greedy_fixed(jg, q, 5, EPS[metric], L=96),
                     f"greedy query {i}")
        _assert_same(tbl.ip_greedy(tg, q, 5, 0.7, L=96),
                     jbl.ip_greedy(jg, q, 5, 0.7, L=96),
                     f"ip_greedy query {i}")
    # an eps so strict that nothing but the first pick fits: missing slots
    # score 0
    res = tbl.greedy_fixed(tg, clustered_data[0], 5,
                           -50.0 if metric == "l2" else -1.0, L=32)
    assert (res.ids >= 0).sum() == 1 and (res.scores[res.ids < 0] == 0).all()


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_batch_greedy_diverse_matches_reference(graphs, clustered_data,
                                                metric):
    jg, tg = graphs[metric]
    qs = _queries(clustered_data, num=4, seed=7)
    rid, rsc, rcnt = jbatch.batch_greedy_diverse(jg, jnp.asarray(qs), 5,
                                                 EPS[metric], 64)
    gid, gsc, gcnt = tbatch.batch_greedy_diverse(tg, qs, 5, EPS[metric], 64)
    np.testing.assert_array_equal(gid.numpy(), np.asarray(rid))
    np.testing.assert_allclose(gsc.numpy(), np.asarray(rsc), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(rcnt))
    # each lane is greedy_fixed at the same L (the same capacity-L beam)
    for i, q in enumerate(qs):
        one = tbl.greedy_fixed(tg, q, 5, EPS[metric], L=64)
        np.testing.assert_array_equal(gid[i].numpy(), one.ids)
        np.testing.assert_array_equal(gsc[i].numpy().view(np.int32),
                                      one.scores.view(np.int32))


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_batch_optimal_diverse_matches_reference(graphs, clustered_data,
                                                 metric):
    jg, tg = graphs[metric]
    qs = _queries(clustered_data, num=4, seed=11)
    ref = jbatch.batch_optimal_diverse(jg, jnp.asarray(qs), 5, EPS[metric],
                                       K=32, ef=4)
    got = tbatch.batch_optimal_diverse(tg, qs, 5, EPS[metric], K=32, ef=4)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               rtol=TOTAL_TOL, atol=TOTAL_TOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
