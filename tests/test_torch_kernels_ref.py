"""repro_torch.kernels.ops (ref rung, CPU) against repro.kernels.ops at
impl="ref", and the dispatch ladder. The CUDA kernels are held against
their plain versions in ``test_torch_cuda_kernels.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.batch_progressive import _batched_adjacency
from repro.kernels import ops as jops
from repro_torch.core import similarity as tsim
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

RTOL = ATOL = 1e-5
METRICS = ["l2", "ip", "cos"]
# thresholds that give the d=24 test corpus a few percent of edges
EPS = {"l2": -5.0, "ip": 2.0, "cos": 0.1}


def _corpus(seed=0, n=300, d=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d))).astype(np.float32)


def _prefixes(x, metric, B=4, W=64, seed=1):
    """Raw sorted queue prefixes: distinct ids by score desc, -1/-inf tail."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    ids = np.full((B, W), -1, np.int32)
    scores = np.full((B, W), -np.inf, np.float32)
    for b in range(B):
        m = int(rng.integers(W // 2, W + 1))
        pick = rng.choice(n, m, replace=False)
        s = rng.normal(size=m).astype(np.float32)
        order = np.argsort(-s, kind="stable")
        ids[b, :m], scores[b, :m] = pick[order], s[order]
    Ks = rng.integers(1, W + 1, B)
    eps = EPS[metric] + rng.normal(size=B).astype(np.float32) * 0.05
    return ids, scores, Ks, eps.astype(np.float32)


@pytest.mark.parametrize("metric", METRICS)
def test_batch_similarity_ops_match_reference(metric):
    x = _corpus()
    qs = _corpus(5, n=3)
    xt, qt = torch.from_numpy(x), torch.from_numpy(qs)
    for i in range(3):
        ref = np.asarray(jops.batch_similarity(jnp.asarray(qs[i]), jnp.asarray(x),
                                               metric, impl="ref"))
        np.testing.assert_allclose(tops.batch_similarity(qt[i], xt, metric).numpy(),
                                   ref, rtol=RTOL, atol=ATOL)
    lanes = tops.batch_similarity(qt, xt, metric).numpy()
    for i in range(3):  # the lane form is each lane's own call, bit for bit
        np.testing.assert_array_equal(
            lanes[i], tops.batch_similarity(qt[i], xt, metric).numpy())
    ref_many = np.asarray(jops.batch_similarity_many(
        jnp.asarray(qs), jnp.asarray(x), metric, impl="ref"))
    np.testing.assert_allclose(tops.batch_similarity_many(qt, xt, metric).numpy(),
                               ref_many, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_batch_similarity_gather_matches_per_lane_reference(metric):
    x = _corpus()
    qs = _corpus(6, n=4)
    ids = np.random.default_rng(2).integers(-1, x.shape[0], (4, 16)).astype(np.int32)
    got = tops.batch_similarity_gather(torch.from_numpy(qs), torch.from_numpy(x),
                                       torch.from_numpy(ids), metric).numpy()
    for b in range(4):
        ref = np.asarray(jops.batch_similarity(
            jnp.asarray(qs[b]), jnp.asarray(x[np.maximum(ids[b], 0)]), metric,
            impl="ref"))
        np.testing.assert_allclose(got[b], ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [24, 30, 96])
def test_plain_gather_equals_corpus_columns_bitwise(metric, d):
    """The equalities the CUDA similarity kernels are held to on the card,
    here on their plain versions: the gathered scores (ids of -1 score row
    0, M = 1 and M = 12) equal the gathered columns of the corpus scores bit
    for bit, and the corpus scores do not depend on the batch around a
    lane."""
    x = torch.from_numpy(_corpus(d, n=200, d=d))
    qs = torch.from_numpy(_corpus(d + 1, n=5, d=d))
    ids = np.random.default_rng(d).integers(-1, 200, (5, 12)).astype(np.int32)
    ids[:, 3] = -1
    ids = torch.from_numpy(ids)
    many = tref.batch_similarity(qs, x, metric)
    for m in (ids[:, :1], ids):
        got = tref.batch_similarity_gather(qs, x, m.contiguous(), metric)
        want = torch.gather(many, 1, m.clamp(min=0).long())
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for b in range(qs.shape[0]):
        lane = tref.batch_similarity(qs[b:b + 1], x, metric)[0]
        assert torch.equal(lane.view(torch.int32), many[b].view(torch.int32))


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_adjacency_batch_matches_reference(metric):
    x = _corpus()
    ids, _, _, eps = _prefixes(x, metric)
    ref = np.asarray(_batched_adjacency(jnp.asarray(x), jnp.asarray(ids),
                                        jnp.asarray(eps), metric))
    got = tops.pairwise_adjacency_batch(torch.from_numpy(x), torch.from_numpy(ids),
                                        torch.from_numpy(eps), metric).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size // 2


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("W", [1, 33, 64, 100])
def test_greedy_diversify_matches_reference(W, tied):
    """The plain greedy, which the CUDA kernel is held to on the card, picks
    as the reference does at the kernel's staged widths, also on scores
    with ties (three distinct values), where both take the lowest index."""
    x = _corpus()
    ids, scores, _, eps = _prefixes(x, "l2", B=5, W=W)
    if tied:
        scores = np.where(ids >= 0, np.abs(np.round(scores)), -np.inf).astype(
            np.float32)
    adj = tops.pairwise_adjacency_batch(torch.from_numpy(x), torch.from_numpy(ids),
                                        torch.from_numpy(eps), "l2")
    valid = ids >= 0
    for k in (1, 5, 10):
        sel, cnt = tops.greedy_diversify_batch(torch.from_numpy(scores), adj, k,
                                               valid=torch.from_numpy(valid))
        jsel, jcnt = jops.greedy_diversify_batch(
            jnp.asarray(scores), jnp.asarray(adj.numpy()), k,
            valid=jnp.asarray(valid), impl="ref")
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        for b in range(scores.shape[0]):  # each lane as the single-lane op
            js1, jc1 = jops.greedy_diversify(jnp.asarray(scores[b]),
                                             jnp.asarray(adj[b].numpy()), k,
                                             jnp.asarray(valid[b]), impl="ref")
            np.testing.assert_array_equal(sel[b].numpy(), np.asarray(js1))
            assert int(cnt[b]) == int(jc1)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [5, 10])
def test_fused_round_batch_matches_reference(metric, k):
    x = _corpus()
    ids, scores, Ks, eps = _prefixes(x, metric, B=6)
    got = tops.fused_round_batch(torch.from_numpy(x), ids, scores, Ks, eps, k,
                                 metric)
    ref = jops.fused_round_batch(jnp.asarray(x), ids, scores, Ks, eps, k,
                                 metric, impl="ref")
    # ids, scores, counts and the certificate (summed in pick order, as
    # XLA's CPU reduce sums k = 5, 10), bit for bit
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("k", [1, 5, 10, 13, 16, 32])
def test_certificate_total_sums_in_pick_order(k):
    """The plain certificate's total is the float32 sum of the picked
    scores in pick order, which is the JAX reference's per-lane ``jnp.sum``
    bit for bit and what the CUDA kernel accumulates; ``torch.sum`` orders
    it otherwise and differs in the last bits on many lanes."""
    import jax

    rng = np.random.default_rng(k)
    B = 512
    sc = (rng.normal(size=(B, k)) * rng.uniform(0.1, 100, (B, 1))).astype(
        np.float32)
    for b in range(B):   # lanes with fewer picks are zero-padded
        sc[b, rng.integers(0, k + 1):] = 0.0
    ids_m = np.zeros((B, 4), np.int32)
    cert = tref.certificate(torch.from_numpy(sc), torch.from_numpy(ids_m),
                            torch.zeros((B, 4)))
    seq = np.zeros(B, np.float32)
    for j in range(k):
        seq = (seq + sc[:, j]).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jnp.sum))(jnp.asarray(sc)))
    np.testing.assert_array_equal(want.view(np.int32), seq.view(np.int32))
    np.testing.assert_array_equal(cert[:, 0].numpy().view(np.int32),
                                  seq.view(np.int32))


def _greedy_over_picked_rows(x, ids, scores, Ks, eps, k, metric):
    """The fused-round kernel's order of work, in plain torch: per lane,
    each step takes the best unbanned valid candidate (lowest index on
    ties), then scores only that row against the candidates still unbanned
    and bans those over eps, then the pick. No adjacency is built."""
    B, W = ids.shape
    sel_ids = np.full((B, k), -1, np.int32)
    for b in range(B):
        valid = (np.arange(W) < Ks[b]) & (ids[b] >= 0)
        banned = ~valid
        for t in range(k):
            avail = np.where(banned, -np.inf, scores[b])
            j = int(np.argmax(avail))
            if not np.isfinite(avail[j]):
                break
            sel_ids[b, t] = ids[b, j]
            rows = torch.from_numpy(x[np.maximum(ids[b], 0)])
            sims = tsim.query_sim(rows[j], rows, metric).numpy()
            banned = banned | (~banned & (sims > eps[b]))
            banned[j] = True
    return sel_ids


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [5, 10])
def test_greedy_over_picked_rows_equals_the_reference_round(metric, k):
    """What the fused-round kernel relies on: greedy reads only the rows it
    picks and a banned candidate stays banned, so scoring each pick against
    the unbanned candidates gives the reference's picks over its whole
    G^eps."""
    x = _corpus()
    ids, scores, Ks, eps = _prefixes(x, metric, B=6)
    ref = jops.fused_round_batch(jnp.asarray(x), ids, scores, Ks, eps, k,
                                 metric, impl="ref")
    got = _greedy_over_picked_rows(x, ids, scores, Ks, eps, k, metric)
    np.testing.assert_array_equal(got, np.asarray(ref[0]))
    assert (got >= 0).sum() > 6


def test_ladder_names_and_no_hidden_fallback():
    x = torch.from_numpy(_corpus(n=20))
    with pytest.raises(ValueError):
        tops.batch_similarity_many(x[:2], x, "l2", impl="pallas")
    with pytest.raises(ValueError):
        tops.set_default_impl("interpret")
    # the kernel rung on a CPU tensor raises instead of quietly using ref
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.batch_similarity_many(x[:2], x, "l2", impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.fused_round_batch(x, np.zeros((1, 8), np.int32),
                               np.zeros((1, 8), np.float32), [8], [0.0], 2,
                               "l2", impl="cuda")
    tops.set_default_impl("cuda")
    try:
        with pytest.raises(ValueError):
            tops.batch_similarity(x[0], x, "l2")
    finally:
        tops.set_default_impl(None)
    assert tops.resolve(None, x) == "ref"
    tops.reset_launch_counts()
    tops.batch_similarity(x[0], x, "l2")
    assert sum(tops.launch_counts().values()) == 0
