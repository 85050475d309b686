"""Every CUDA kernel of repro_torch against its plain version, on the card.

This file imports neither JAX nor the reference package, so it runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda_kernels.py -q

Without a card every test here skips. Tolerances: the similarity kernels
(``sim_many``, ``sim_gather``) reduce in ``dot_seq``'s order and round the
metric transform as the plain version does, so their scores must equal it
bit for bit, and each other; the adjacency and the fused round threshold
those same bits, so their edges, picks and picked scores must be equal, and
so must the fused round's certificate (its total summed in pick order on
both sides); every integer output, and the exact int8 dots and ordered LUT
sums, must be equal.
"""
import numpy as np
import pytest
import torch

from repro_torch import quant as tq
from repro_torch.core import similarity as tsim
from repro_torch.kernels import ops as tops

METRICS = ["l2", "ip", "cos"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _corpus(seed=0, n=300, d=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d))).astype(np.float32)


def _prefixes(x, B, W, seed=1):
    """Raw sorted queue prefixes: distinct ids by score desc, -1/-inf tail,
    and each lane's candidate budget."""
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
    return ids, scores, rng.integers(1, W + 1, B)


def _assert_bits_equal(got, want):
    """Equal float32 bit patterns (so -0.0 differs from +0.0)."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    bad = got.contiguous().view(torch.int32) != want.contiguous().view(torch.int32)
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} scores differ, max "
        f"{float((got - want).abs().max())}")


def _gather_ids(rng, B, M, n):
    """Random row ids [B, M] with a -1 in every lane (scored as row 0)."""
    ids = rng.integers(-1, n, (B, M)).astype(np.int32)
    ids[:, M // 2] = -1
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_kernels_match_plain_versions(cuda_device, metric):
    x = torch.from_numpy(_corpus(n=2000, d=96)).to(cuda_device)
    qs = torch.from_numpy(_corpus(3, n=16, d=96)).to(cuda_device)
    ids_np, scores_np, Ks = _prefixes(_corpus(n=2000, d=96), B=8, W=256)
    ids = torch.from_numpy(ids_np).to(cuda_device)
    scores = torch.from_numpy(scores_np).to(cuda_device)
    # eps at each lane's 0.9 quantile of pair similarity: ~10% edges
    rows = x[ids.clamp(min=0).long()]
    eps = torch.quantile(tsim.pairwise_sim(rows, rows, metric).flatten(1),
                         0.9, dim=1).contiguous()
    _assert_bits_equal(tops.batch_similarity(qs, x, metric, impl="cuda"),
                       tops.batch_similarity(qs, x, metric, impl="ref"))
    nb = ids.clamp(min=0)[:, :32].contiguous()
    _assert_bits_equal(
        tops.batch_similarity_gather(qs[:8], x, nb, metric, impl="cuda"),
        tops.batch_similarity_gather(qs[:8], x, nb, metric, impl="ref"))
    adj_k = tops.pairwise_adjacency_batch(x, ids, eps, metric, impl="cuda")
    adj_r = tops.pairwise_adjacency_batch(x, ids, eps, metric, impl="ref")
    assert torch.equal(adj_k, adj_r) and bool(adj_k.any())
    valid = ids >= 0
    for k in (5, 10):
        gk = tops.greedy_diversify_batch(scores, adj_r, k, valid, impl="cuda")
        gr = tops.greedy_diversify_batch(scores, adj_r, k, valid, impl="ref")
        assert torch.equal(gk[0], gr[0]) and torch.equal(gk[1], gr[1])
        fk = tops.fused_round_batch(x, ids, scores, Ks, eps, k, metric,
                                    impl="cuda")
        fr = tops.fused_round_batch(x, ids, scores, Ks, eps, k, metric,
                                    impl="ref")
        for a, b in zip(fk, fr):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [24, 30, 96, 128])
def test_cuda_similarity_kernels_equal_plain_versions_bitwise(cuda_device,
                                                              metric, d):
    """sim_many and sim_gather against their plain versions, bit for bit, at
    a ragged N = 100 003 and B in {1, 5, 16, 17} (17: two query chunks),
    gathered ids with -1 at M = 1 and 32; and against each other, as the
    engine needs: sim_gather[b, m] == sim_many[b, max(ids[b, m], 0)], and
    sim_many of one lane is that lane's row of the batch's call. A copy of
    the corpus at a base 4 bytes off 16-byte alignment takes the kernels'
    4-byte copy path and must give the same bits."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.batch_similarity import (sim_gather_cuda,
                                                      sim_many_cuda)

    n = 100_003
    x = torch.from_numpy(_corpus(d, n=n, d=d)).to(cuda_device)
    buf = torch.empty(n * d + 1, device=cuda_device)
    x_off = buf[1:].view(n, d)
    x_off.copy_(x)
    qs_all = torch.from_numpy(_corpus(d + 1, n=17, d=d)).to(cuda_device)
    rng = np.random.default_rng(d)
    for B in (1, 5, 16, 17):
        qs = qs_all[:B].contiguous()
        many = sim_many_cuda(qs, x, metric)
        _assert_bits_equal(many, ref.batch_similarity(qs, x, metric))
        for b in range(B):
            _assert_bits_equal(sim_many_cuda(qs[b:b + 1].contiguous(), x,
                                             metric)[0], many[b])
        _assert_bits_equal(sim_many_cuda(qs, x_off, metric), many)
        for M in (1, 32):
            ids = torch.from_numpy(_gather_ids(rng, B, M, n)).to(cuda_device)
            got = sim_gather_cuda(qs, x, ids, metric)
            _assert_bits_equal(got, ref.batch_similarity_gather(qs, x, ids,
                                                                metric))
            _assert_bits_equal(got, torch.gather(many, 1,
                                                 ids.clamp(min=0).long()))
            _assert_bits_equal(sim_gather_cuda(qs, x_off, ids, metric), got)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_gather_at_the_sharded_width_bitwise(cuda_device, metric):
    """sim_gather at B x M = 64 x 32 (4 shards x 16 lanes, M0 = 32), d = 96:
    equal bits to its plain version and to sim_many's gathered columns
    (sim_many at B = 64 runs four query chunks)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.batch_similarity import (sim_gather_cuda,
                                                      sim_many_cuda)

    n = 100_003
    x = torch.from_numpy(_corpus(5, n=n, d=96)).to(cuda_device)
    qs = torch.from_numpy(_corpus(6, n=64, d=96)).to(cuda_device)
    ids = torch.from_numpy(_gather_ids(np.random.default_rng(7), 64, 32,
                                       n)).to(cuda_device)
    got = sim_gather_cuda(qs, x, ids, metric)
    _assert_bits_equal(got, ref.batch_similarity_gather(qs, x, ids, metric))
    many = sim_many_cuda(qs, x, metric)
    _assert_bits_equal(got, torch.gather(many, 1, ids.clamp(min=0).long()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4096, 96), (1037, 30)])
def test_cuda_quantized_kernels_equal_plain_versions(cuda_device, n, d):
    from repro_torch.kernels.int8_similarity import int8_dot_cuda
    from repro_torch.kernels.pq_lut_similarity import pq_lut_sum_cuda
    from repro_torch.kernels.ref import int8_dot

    x = torch.from_numpy(_corpus(d, n=n, d=d)).to(cuda_device)
    qs = torch.from_numpy(_corpus(d + 1, n=16, d=d)).to(cuda_device)
    c8 = tq.quantize_corpus(x, "int8")
    qc, _ = tq.quantize_queries(qs)
    assert torch.equal(int8_dot_cuda(qc, c8.codes), int8_dot(qc, c8.codes))
    pq = tq.quantize_corpus(x, "pq", pq_m=16 if d == 96 else 5, pq_iters=3)
    for metric in METRICS:
        T, S, _ = tq.pq_luts_many(qs, pq.codebooks, metric)
        for table in (T, S[None].contiguous()):
            assert torch.equal(pq_lut_sum_cuda(table, pq.codes),
                               tq.pq_lut_sum(table, pq.codes))
        for corpus in (c8, pq):
            assert torch.equal(
                tops.quantized_similarity_many(qs, corpus, metric, impl="cuda"),
                tops.quantized_similarity_many(qs, corpus, metric, impl="ref"))
    # a code at or above C is refused, as the plain version's gather refuses it
    with pytest.raises(ValueError, match=">= C"):
        pq_lut_sum_cuda(torch.zeros((1, 2, 4), device=cuda_device),
                        torch.full((3, 2), 4, dtype=torch.uint8,
                                   device=cuda_device))


def _merge_runs(R, L, seed):
    """Two runs a row, [R, L] each, sorted by (score desc, id asc): ids
    drawn per row from [0, 4L) (the runs share ids), scores from nine
    values with about a third zeros, half of those -0.0, and a (-1, -inf)
    padding tail of random length; row 0 of run b is all padding."""
    rng = np.random.default_rng(seed)
    runs = []
    for r_ in range(2):
        ids = np.argsort(rng.random((R, 4 * L)), axis=1)[:, :L].astype(np.int32)
        sc = (rng.integers(-4, 5, (R, L)) * 0.5).astype(np.float32)
        sc[rng.random((R, L)) < 0.3] = 0.0
        sc[rng.random((R, L)) < 0.5] *= -1.0
        npad = rng.integers(0, L // 4 + 1, R)
        if r_ == 1:
            npad[0] = L
        for row in range(R):
            order = np.lexsort((ids[row], -sc[row]))
            ids[row], sc[row] = ids[row][order], sc[row][order]
            ids[row, L - npad[row]:] = -1
            sc[row, L - npad[row]:] = -np.inf
        runs.append((ids, sc))
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 10, 32, 100, 128, 1000, 4096])
def test_cuda_topk_merge_equals_plain_version(cuda_device, L):
    """64 rows (4 shards x 16 lanes) of a tournament round, ragged L
    included: ids and score bits equal (a -0.0 stays -0.0)."""
    (ia, sa), (ib, sb) = _merge_runs(64, L, seed=L)
    args = [torch.from_numpy(a).to(cuda_device) for a in (ia, sa, ib, sb)]
    gi, gs = tops.topk_merge(*args, impl="cuda")
    ri, rs = tops.topk_merge(*args, impl="ref")
    assert torch.equal(gi, ri)
    assert torch.equal(gs.view(torch.int32), rs.view(torch.int32))
    # over leading axes [P, B, L], as the tournament calls it
    gi3, _ = tops.topk_merge(*(a.reshape(4, 16, L) for a in args),
                             impl="cuda")
    assert torch.equal(gi3.reshape(64, L), ri)


def _tournament_runs(P, B, L, seed):
    """The shards' runs [P, B, L] as ``_merge_runs`` makes them: ids drawn
    per row from [0, 4L) (shards share ids), tied scores, +-0.0 and padding
    tails; lane 0 of the last shard is all padding, and lane B - 1 of shard
    1 repeats shard 0's with its zeros' signs flipped (ties on both keys,
    other bits)."""
    runs = [_merge_runs(B, L, seed + 7 * p)[p % 2] for p in range(P)]
    ids = np.stack([r[0] for r in runs])
    sc = np.stack([r[1] for r in runs])
    ids[-1, 0], sc[-1, 0] = -1, -np.inf
    ids[1, -1] = ids[0, -1]
    sc[1, -1] = np.where(sc[0, -1] == 0.0, -sc[0, -1], sc[0, -1])
    return ids, sc


def _assert_tournament(ids, sc):
    gi, gs = tops.topk_tournament(ids, sc, impl="cuda")
    ri, rs = tops.topk_tournament(ids, sc, impl="ref")
    assert torch.equal(gi, ri)
    assert torch.equal(gs.view(torch.int32), rs.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 10, 32, 64, 100, 1000, 4096])
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_cuda_topk_tournament_equals_butterfly(cuda_device, P, B, L):
    """One launch over [P, B, L] equals shard 0's rows after the plain
    version's log2 P butterfly rounds, ids and score bits, runs sharing ids
    across shards included. Lanes of fewer than 256 entries, and P = 8 at
    L = 4096 (256 KB of runs a lane), search device memory; the rest are
    staged in shared memory, past 2048 entries over several blocks."""
    ids, sc = (torch.from_numpy(a).to(cuda_device)
               for a in _tournament_runs(P, B, L, seed=P * 10_000 + L))
    _assert_tournament(ids, sc)
    # the two-run kernel's butterfly gives the same rows
    mi, ms = ids, sc
    for r in range(P.bit_length() - 1):
        other = torch.arange(P, device=cuda_device) ^ (1 << r)
        mi, ms = tops.topk_merge(mi, ms, mi[other], ms[other], impl="cuda")
    gi, gs = tops.topk_tournament(ids, sc, impl="cuda")
    assert torch.equal(gi, mi[0])
    assert torch.equal(gs.view(torch.int32), ms[0].view(torch.int32))


@pytest.mark.cuda
def test_cuda_topk_tournament_routes_and_checks(cuda_device):
    """Runs 4 bytes off a 16-byte boundary and L % 4 != 0 (staged by
    4-byte copies), 64 runs (32 lanes an entry, two runs a lane), a lane
    split over several blocks at each route, 300 launches in a row, the
    launch count, and what the wrapper refuses."""
    from repro_torch.kernels.topk_merge import topk_tournament_cuda

    for P, B, L in ((4, 16, 32), (4, 3, 1000), (2, 5, 4096), (8, 4, 65)):
        ids, sc = (torch.from_numpy(a).to(cuda_device)
                   for a in _tournament_runs(P, B, L, seed=L))
        _assert_tournament(_unaligned(ids), _unaligned(sc))
    for P, B, L in ((8, 4, 33), (64, 2, 100), (8, 2, 8192)):
        ids, sc = (torch.from_numpy(a).to(cuda_device)
                   for a in _tournament_runs(P, B, L, seed=3))
        _assert_tournament(ids, sc)
    ids, sc = (torch.from_numpy(a).to(cuda_device)
               for a in _tournament_runs(4, 16, 32, seed=4))
    ri, rs = tops.topk_tournament(ids, sc, impl="ref")
    tops.reset_launch_counts()
    for _ in range(300):
        gi, gs = tops.topk_tournament(ids, sc)
    torch.cuda.synchronize()
    assert tops.launch_counts()["topk_merge"] == 300
    assert torch.equal(gi, ri) and torch.equal(gs, rs)
    with pytest.raises(ValueError, match="power of two"):
        topk_tournament_cuda(ids[:3].contiguous(), sc[:3].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        topk_tournament_cuda(ids.transpose(1, 2), sc.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        topk_tournament_cuda(ids[0], sc[0])
    with pytest.raises(ValueError, match="contiguous"):
        topk_tournament_cuda(ids, sc.double())


@pytest.mark.cuda
def test_cuda_tournament_merge_is_one_launch(cuda_device, monkeypatch):
    """The sharded path's tournament merge on the card: one kernel launch,
    no two-run merge, shard 0's rows of the plain butterfly."""
    from repro_torch.compat import make_mesh
    from repro_torch.sharded_search import search as ssearch

    def no_pairwise(*a, **kw):
        raise AssertionError("the tournament ran a two-run merge")

    monkeypatch.setattr(tops, "topk_merge", no_pairwise)
    ids, sc = (torch.from_numpy(a).to(cuda_device)
               for a in _tournament_runs(4, 16, 32, seed=5))
    mesh = make_mesh((4,), ("data",), device=cuda_device)
    tops.reset_launch_counts()
    gi, gs = ssearch._merge(ids, sc, mesh, "tournament", 32)
    assert tops.launch_counts()["topk_merge"] == 1
    ri, rs = tops.topk_tournament(ids, sc, impl="ref")
    assert torch.equal(gi, ri)
    assert torch.equal(gs.view(torch.int32), rs.view(torch.int32))


@pytest.mark.cuda
def test_cuda_occupied_prefix_equals_whole_queue(cuda_device, monkeypatch):
    """The sharded path on the card (4 shards of 2 000 rows, resumable
    queues of 2 048 slots): the beam loop on each queue's occupied prefix
    and forced to the whole queue give equal ids, score bits, certificates
    and budgets."""
    from repro_torch import sharded_search as ss
    from repro_torch.compat import make_mesh
    from repro_torch.core import beam_search as bs

    x = _corpus(7, n=8000, d=24)
    qs = _corpus(8, n=8, d=24)
    index = ss.build_sharded_index(x, 4, "ip", M=8, device=cuda_device)
    mesh = make_mesh((4,), ("data",), device=cuda_device)

    def run():
        return ss.sharded_progressive_diverse(index, x, qs, 8, 5.0, mesh,
                                              K0=16, resume="beam")

    prefix = run()
    monkeypatch.setattr(bs, "_occupied_width", lambda n, capacity: capacity)
    whole = run()
    ids, scores, cert, K_final = prefix
    for got, want in zip((ids, scores.view(np.int32), cert, K_final),
                         (whole[0], whole[1].view(np.int32), *whole[2:])):
        np.testing.assert_array_equal(got, want)


def _lanes(x, B, W, metric, seed):
    """B tie-free lanes of width W over corpus x for the adjacency and the
    fused round: raw prefixes (ids -1 past a random count, scores -inf
    there), lane 0 with a budget Ks = 0, lane 1 all -1 ids, and per-lane eps
    at the lane's 0.9 quantile of pair similarity. The plain version's sims
    come from a matmul, whose order of summation is not the kernels', so a
    candidate with any pair within 1e-5 * (1 + |eps|) of its lane's eps is
    made a -1 sentinel (and sorted to the back, as a queue keeps them)."""
    ids_np, scores_np, Ks = _prefixes(x.cpu().numpy(), B=B, W=W, seed=seed)
    ids_np[1 % B] = -1
    scores_np[1 % B] = -np.inf
    Ks[0] = 0
    dev = x.device
    ids = torch.from_numpy(ids_np).to(dev)
    scores = torch.from_numpy(scores_np).to(dev)
    rows = x[ids.clamp(min=0).long()]
    sims = tsim.pairwise_sim(rows, rows, metric)
    flat = sims.flatten(1)
    eps = torch.quantile(flat[:, ::max(1, flat.shape[1] // 4096)], 0.9,
                         dim=1).contiguous()
    near = (sims - eps[:, None, None]).abs() <= 1e-5 * (1 + eps.abs())[
        :, None, None]
    near &= ~torch.eye(W, dtype=torch.bool, device=dev)
    bad = near.any(dim=2)
    ids = torch.where(bad, -1, ids)
    scores = torch.where(bad, float("-inf"), scores)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return (torch.gather(ids, 1, order).contiguous(),
            torch.gather(scores, 1, order).contiguous(),
            torch.from_numpy(Ks.astype(np.int32)).to(dev), eps)


def _off_by_4_bytes(x):
    """A copy of x whose base is 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, device=x.device)
    x_off = buf[1:].view(x.shape)
    x_off.copy_(x)
    return x_off


# (W, d): every width at every d; 8 192 at d = 96 is past what a cluster of
# 8 blocks holds in shared memory, so the fused round streams its rows
WIDTHS = [(W, d) for W in (1, 33, 64, 100, 1024, 4096) for d in (30, 96, 128)]
FUSED_WIDTHS = WIDTHS + [(8192, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("W,d", WIDTHS)
def test_cuda_adjacency_equals_plain_version(cuda_device, metric, W, d):
    """The finished bool adjacency (diagonal and padding false) equals the
    plain version's, is symmetric, and is the same from a corpus 4 bytes
    off alignment (the kernel's 4-byte copy path)."""
    x = torch.from_numpy(_corpus(W + d, n=max(3 * W, 64), d=d)).to(cuda_device)
    ids, _, _, eps = _lanes(x, 2 if W >= 1024 else 4, W, metric, seed=W + d)
    got = tops.pairwise_adjacency_batch(x, ids, eps, metric, impl="cuda")
    want = tops.pairwise_adjacency_batch(x, ids, eps, metric, impl="ref")
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got, want), f"{int((got != want).sum())} edges differ"
    assert torch.equal(got, got.transpose(1, 2))
    assert not bool(got[1].any())   # the all-padding lane
    if W >= 64:
        assert bool(got.any())
    assert torch.equal(tops.pairwise_adjacency_batch(
        _off_by_4_bytes(x), ids, eps, metric, impl="cuda"), got)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("W,d", FUSED_WIDTHS)
def test_cuda_fused_round_equals_plain_version(cuda_device, metric, W, d):
    """Global ids, picked scores, counts and certificates equal the plain
    version's, for a lane with Ks = 0, a lane of -1 ids and k past the
    valid count; the same from a corpus 4 bytes off alignment."""
    x = torch.from_numpy(_corpus(W + d, n=max(3 * W, 64), d=d)).to(cuda_device)
    # lanes 0 and 1 hold no valid candidate (Ks = 0, all -1), so at least
    # one lane past them
    B = 3 if W >= 1024 else 4
    ids, scores, Ks, eps = _lanes(x, B, W, metric, seed=W + d + 1)
    Ks[B - 1] = W   # one lane over its whole prefix
    x_off = _off_by_4_bytes(x)
    for k in sorted({10, min(W, 100) + 3}):
        got = tops.fused_round_batch(x, ids, scores, Ks, eps, k, metric,
                                     impl="cuda")
        want = tops.fused_round_batch(x, ids, scores, Ks, eps, k, metric,
                                      impl="ref")
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert int(got[2][0]) == 0 and int(got[2][1 % B]) == 0
        if W >= 64:
            assert int(got[2][B - 1]) > 1   # a lane with picks
        off = tops.fused_round_batch(x_off, ids, scores, Ks, eps, k, metric,
                                     impl="cuda")
        for a, b in zip(off, got):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_fused_round_routes(cuda_device):
    """The widths above run every layout: one block per lane, a cluster
    of 8 blocks with the rows in shared memory, and the streamed rows."""
    from repro_torch.kernels.fused_round import fused_round_plan

    plans = {(W, d): fused_round_plan(W, d) for W, d in FUSED_WIDTHS}
    for W, d in ((64, 96), (100, 128), (1024, 30)):
        assert plans[(W, d)]["route"] == "staged"
        assert plans[(W, d)]["cluster"] == 1
    for W, d in ((1024, 96), (1024, 128), (4096, 96)):
        assert plans[(W, d)]["route"] == "staged"
        assert plans[(W, d)]["cluster"] == 8
    assert plans[(8192, 96)]["route"] == "streamed"
    assert plans[(4096, 128)]["route"] == "streamed"
    for p in plans.values():
        assert p["smem"] <= 227 * 1024 and p["threads"] % 32 == 0
        assert p["cluster"] in (1, 8)
        assert p["cluster"] * p["per_block"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,W", [(16, 1024), (3, 8192)])
def test_cuda_fused_round_cluster_routes_repeat(cuda_device, B, W):
    """The two cluster routes (rows staged in 8 blocks' shared memory at
    16 x 1024, streamed at 3 x 8192; d = 96), launched 300 times in a row,
    give the plain version's round every time: blocks store into each
    other's shared memory only after the cluster's first barrier."""
    from repro_torch.kernels.fused_round import fused_round_plan

    d, k = 96, 10
    assert fused_round_plan(W, d)["cluster"] == 8
    x = torch.from_numpy(_corpus(W, n=3 * W, d=d)).to(cuda_device)
    ids, scores, Ks, eps = _lanes(x, B, W, "l2", seed=W + 5)
    Ks[B - 1] = W
    want = tops.fused_round_batch(x, ids, scores, Ks, eps, k, "l2",
                                  impl="ref")
    assert int(want[2].sum()) > B
    bad = 0
    for _ in range(300):
        got = tops.fused_round_batch(x, ids, scores, Ks, eps, k, "l2",
                                     impl="cuda")
        bad += not all(torch.equal(a, b) for a, b in zip(got, want))
    assert bad == 0, f"{bad} of 300 launches differ from the plain version"


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_threshold_pins_the_shared_reduction_order(cuda_device, metric):
    """Without tie-free data: eps set to a pair's similarity exactly as
    sim_gather computes it. The edge is absent at that eps and present at
    the next float below it, in the adjacency and in the fused round's
    bans, so all three kernels reduce that pair in one order."""
    from repro_torch.kernels.batch_similarity import sim_gather_cuda

    x = torch.from_numpy(_corpus(11, n=500, d=96)).to(cuda_device)
    W = 64
    ids = torch.from_numpy(np.random.default_rng(12).choice(
        500, W, replace=False).astype(np.int32)).to(cuda_device)[None]
    u, v = ids[0, 0].long(), ids[0, 1:2][None]
    s = sim_gather_cuda(x[u][None].contiguous(), x, v.contiguous(), metric)[0]
    below = torch.nextafter(s, torch.tensor(-np.inf, device=cuda_device))
    # scores: candidate 0 first, candidate 1 second, the rest after
    scores = -torch.arange(W, dtype=torch.float32, device=cuda_device)[None]
    Ks = torch.tensor([W], dtype=torch.int32, device=cuda_device)
    for eps, edge in ((s, False), (below, True)):
        adj = tops.pairwise_adjacency_batch(x, ids, eps, metric, impl="cuda")
        assert bool(adj[0, 0, 1]) == edge and bool(adj[0, 1, 0]) == edge
        sel_ids = tops.fused_round_batch(x, ids, scores, Ks, eps.reshape(1),
                                         2, metric, impl="cuda")[0]
        assert int(sel_ids[0, 0]) == int(ids[0, 0])
        # candidate 1 is picked second unless the first pick banned it
        assert (int(sel_ids[0, 1]) == int(ids[0, 1])) == (not edge)


def _unaligned(t):
    """A copy of uint8 t whose base is 1 byte past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


class _CudaArray:
    """Device memory at a raw address, as torch.as_tensor takes it."""

    def __init__(self, ptr, n):
        self.__cuda_array_interface__ = dict(shape=(n,), typestr="|u1",
                                             data=(ptr, False), version=3)


@pytest.fixture
def guarded(cuda_device):
    """guarded(t): a copy of uint8 t whose last byte is the last mapped byte
    before address space that is reserved and not mapped, so a kernel that
    reads one byte past t faults (the CUDA driver's virtual memory calls).
    The mappings are undone after the test."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    u64, size_t = ctypes.c_uint64, ctypes.c_size_t

    class Location(ctypes.Structure):
        _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]

    class Flags(ctypes.Structure):
        _fields_ = [("compressionType", ctypes.c_ubyte),
                    ("gpuDirectRDMACapable", ctypes.c_ubyte),
                    ("usage", ctypes.c_ushort),
                    ("reserved", ctypes.c_ubyte * 4)]

    class Prop(ctypes.Structure):
        _fields_ = [("type", ctypes.c_int),
                    ("requestedHandleTypes", ctypes.c_int),
                    ("location", Location),
                    ("win32HandleMetaData", ctypes.c_void_p),
                    ("allocFlags", Flags)]

    class Access(ctypes.Structure):
        _fields_ = [("location", Location), ("flags", ctypes.c_int)]

    def ok(rc, what):
        assert rc == 0, f"{what} returned CUresult {rc}"

    torch.zeros(1, device=cuda_device)   # the primary context is current
    here = Location(1, torch.cuda.current_device())   # the device
    prop = Prop(type=1, location=here)                # pinned device memory
    gran = size_t()
    ok(cu.cuMemGetAllocationGranularity(ctypes.byref(gran),
                                        ctypes.byref(prop), 0),
       "cuMemGetAllocationGranularity")
    undo = []

    def make(t):
        n = t.numel()
        mapped = -(-n // gran.value) * gran.value
        base, handle = u64(), u64()
        ok(cu.cuMemAddressReserve(ctypes.byref(base), size_t(mapped + gran.value),
                                  size_t(0), u64(0), u64(0)),
           "cuMemAddressReserve")
        undo.append(lambda: cu.cuMemAddressFree(base, size_t(mapped +
                                                             gran.value)))
        ok(cu.cuMemCreate(ctypes.byref(handle), size_t(mapped),
                          ctypes.byref(prop), u64(0)), "cuMemCreate")
        undo.append(lambda: cu.cuMemRelease(handle))
        ok(cu.cuMemMap(base, size_t(mapped), size_t(0), handle, u64(0)),
           "cuMemMap")
        undo.append(lambda: cu.cuMemUnmap(base, size_t(mapped)))
        access = Access(here, 3)                        # read and write
        ok(cu.cuMemSetAccess(base, size_t(mapped), ctypes.byref(access),
                             size_t(1)), "cuMemSetAccess")
        out = torch.as_tensor(_CudaArray(base.value + mapped - n, n),
                              device=cuda_device).view(t.shape)
        out.copy_(t)
        return out

    yield make
    torch.cuda.synchronize()
    for f in reversed(undo):
        f()


def _tables(rng, B, M, C):
    """Tables f32[B, M, C] with signed zeros among the entries, so a sum
    that started anywhere but at the first entry (or at -0.0) shows."""
    T = rng.normal(size=(B, M, C)).astype(np.float32)
    T[rng.random(T.shape) < 0.05] = -0.0
    T[rng.random(T.shape) < 0.05] = 0.0
    return T


@pytest.mark.cuda
@pytest.mark.parametrize("C", [7, 256])
@pytest.mark.parametrize("M", [1, 5, 16, 32])
@pytest.mark.parametrize("B", [1, 5, 8, 16, 17])
def test_cuda_pq_lut_sum_equals_plain_version_bitwise(cuda_device, B, M, C):
    """Every query-group size the kernel plans (1, 4, 8 tables a block),
    every code path (16-byte, 4-byte and byte loads: M = 16 and 32 aligned,
    then the same codes 1 byte off alignment), at a row count that is no
    multiple of any block's rows."""
    from repro_torch.kernels.pq_lut_similarity import pq_lut_sum_cuda

    rng = np.random.default_rng(B * 1000 + M * 10 + C)
    n = 2053
    T = torch.from_numpy(_tables(rng, B, M, C)).to(cuda_device)
    codes = torch.from_numpy(rng.integers(0, C, (n, M)).astype(
        np.uint8)).to(cuda_device)
    want = tq.pq_lut_sum(T, codes)
    _assert_bits_equal(pq_lut_sum_cuda(T, codes), want)
    _assert_bits_equal(pq_lut_sum_cuda(T, _unaligned(codes)), want)


@pytest.mark.cuda
def test_cuda_pq_lut_sum_at_the_table_limit(cuda_device):
    """One query's tables at the wrapper's limit, M * C * 4 = 200 KB, run
    one table a block; one byte more is refused."""
    from repro_torch.kernels.pq_lut_similarity import (MAX_TABLE_BYTES,
                                                       pq_lut_sum_cuda)

    M, C = MAX_TABLE_BYTES // (4 * 256), 256
    assert M * C * 4 == MAX_TABLE_BYTES
    rng = np.random.default_rng(3)
    T = torch.from_numpy(_tables(rng, 3, M, C)).to(cuda_device)
    codes = torch.from_numpy(rng.integers(0, C, (1001, M)).astype(
        np.uint8)).to(cuda_device)
    _assert_bits_equal(pq_lut_sum_cuda(T, codes), tq.pq_lut_sum(T, codes))
    with pytest.raises(ValueError, match="M\\*C\\*4"):
        pq_lut_sum_cuda(torch.zeros((1, M + 1, C), device=cuda_device),
                        torch.zeros((4, M + 1), dtype=torch.uint8,
                                    device=cuda_device))


@pytest.mark.cuda
def test_cuda_pq_lut_sum_repeat(cuda_device):
    """300 launches in a row at the compressed path's shape (16 queries x
    1M rows, M = 16, C = 256) give the plain version's sums every time."""
    from repro_torch.kernels.pq_lut_similarity import pq_lut_sum_cuda

    g = torch.Generator(device=cuda_device).manual_seed(5)
    T = torch.randn((16, 16, 256), generator=g, device=cuda_device)
    codes = torch.randint(0, 256, (1_000_000, 16), generator=g,
                          device=cuda_device, dtype=torch.uint8)
    want = tq.pq_lut_sum(T, codes).view(torch.int32)
    bad = sum(not torch.equal(pq_lut_sum_cuda(T, codes).view(torch.int32),
                              want) for _ in range(300))
    assert bad == 0, f"{bad} of 300 launches differ from the plain version"


def _greedy_lanes(rng, W, density, device):
    """Seven lanes of width W, with -inf past a random valid count: lane 0
    all -inf; lane 1 tied (three distinct values, unsorted); lanes 2 and 4
    sorted descending (the queue's order, lane 4 tied); lane 3 three valid
    candidates and no edge; lane 5 a NaN and lane 6 a +inf among its
    scores (no pick at all, as the plain argmax takes them first). The
    adjacency is random uint8 (values 0, 1 and 7) at ``density``, drawn on
    the card."""
    B = 7
    s = rng.normal(size=(B, W)).astype(np.float32)
    s[1] = rng.integers(0, 3, W)
    s[2] = -np.sort(-s[2])
    s[4] = -np.sort(-np.round(s[4]))
    for b in range(B):
        s[b, rng.integers(max(1, W // 2), W + 1):] = -np.inf
    s[0] = -np.inf
    s[3] = rng.normal(size=W)
    s[3, 3:] = -np.inf
    s[5, rng.integers(W)] = np.nan
    s[6, rng.integers(W)] = np.inf
    g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
    edge = torch.rand((B, W, W), generator=g, device=device) < density
    seven = torch.rand((B, W, W), generator=g, device=device) < 0.5
    adj = torch.where(edge, torch.where(seven, 7, 1), 0).to(torch.uint8)
    adj[3] = 0
    return torch.from_numpy(s).to(device), adj


def _greedy_equal(scores, adj, k):
    from repro_torch.kernels import ref
    from repro_torch.kernels.greedy_diversify import greedy_cuda

    got = greedy_cuda(scores, adj, k)
    want = ref.greedy_diversify(scores, adj != 0, k)[0]
    assert torch.equal(got, want), (
        f"{int((got != want).sum())} picks differ:\n{got}\n{want}")
    return got


# every route: staged (<= 128), prefetch (<= 1 024), block (wider)
GREEDY_WIDTHS = [1, 33, 64, 100, 128, 200, 1024, 4096]


@pytest.mark.cuda
@pytest.mark.parametrize("W", GREEDY_WIDTHS)
def test_cuda_greedy_equals_plain_version(cuda_device, W):
    """Picks equal the plain version's on every route, for sorted lanes
    (the queue's order) and unsorted ones, tied scores, an all-invalid lane, non-finite scores, k up to past
    the valid count, adjacency bytes that are not 0/1, and from an
    adjacency 1 byte off alignment (the byte-copy path)."""
    rng = np.random.default_rng(W)
    for density in (0.1, 0.01):
        scores, adj = _greedy_lanes(rng, W, density, cuda_device)
        for k in sorted({1, 10, min(W, 200) + 3}):
            got = _greedy_equal(scores, adj, k)
            for b in (0, 5, 6):   # all -inf, a NaN, a +inf: no pick
                assert bool((got[b] == -1).all())
            assert int((got[3] >= 0).sum()) == min(k, 3, W)
            assert int((got[2] >= 0).sum()) >= min(k, 1)
        _greedy_equal(scores, _unaligned(adj), 10)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [33, 100, 200, 513, 528, 1100])
def test_cuda_greedy_reads_nothing_past_the_adjacency(cuda_device, guarded,
                                                      W):
    """An adjacency that ends where mapped memory ends, at widths that are
    no multiple of a warp's 32 R bytes a row (every route, the prefetch
    route both aligned, 200 and 528, and byte by byte, 513): the last
    candidate of every lane scores highest, so the last row is read first,
    and the picks equal the plain version's with no fault."""
    rng = np.random.default_rng(W + 2)
    s = rng.normal(size=(7, W)).astype(np.float32)
    s[:, -1] = 10.0
    s[1] = np.sort(s[1])   # ascending
    scores = torch.from_numpy(s).to(cuda_device)
    adj = torch.from_numpy((rng.random((7, W, W)) < 0.05).astype(
        np.uint8)).to(cuda_device)
    got = _greedy_equal(scores, guarded(adj), 10)
    assert bool((got[:, 0] == W - 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B, M", [(16, 16), (5, 16), (3, 5), (1, 32)])
def test_cuda_pq_lut_sum_reads_nothing_past_the_codes(cuda_device, guarded,
                                                       B, M):
    """Codes that end where mapped memory ends, at a row count that is no
    multiple of any block's rows (the skewed, 16-byte and byte paths): the
    sums equal the plain version's with no fault."""
    from repro_torch.kernels.pq_lut_similarity import pq_lut_sum_cuda

    rng = np.random.default_rng(B * 100 + M)
    T = torch.from_numpy(_tables(rng, B, M, 256)).to(cuda_device)
    codes = torch.from_numpy(rng.integers(0, 256, (2053, M)).astype(
        np.uint8)).to(cuda_device)
    _assert_bits_equal(pq_lut_sum_cuda(T, guarded(codes)),
                       tq.pq_lut_sum(T, codes))


@pytest.mark.cuda
def test_cuda_greedy_routes(cuda_device):
    from repro_torch.kernels.greedy_diversify import greedy_plan

    routes = {W: greedy_plan(W)["route"] for W in GREEDY_WIDTHS}
    assert all(routes[W] == "staged" for W in (1, 33, 64, 100, 128))
    assert routes[200] == routes[1024] == "prefetch"
    assert routes[4096] == "block"
    for W in (0, *GREEDY_WIDTHS):
        p = greedy_plan(W)
        assert p["smem"] <= 227 * 1024 and p["threads"] % 32 == 0
        if p["route"] in ("staged", "prefetch"):
            assert p["threads"] == 32 and 32 * p["per_thread"] >= W
    assert greedy_plan(60_000)["route"] == "block_streamed"


@pytest.mark.cuda
def test_cuda_greedy_block_streamed_route(cuda_device):
    """One lane too wide for its scores to fit in shared memory (60 000
    candidates, 3.6 GB of adjacency, about 20 edges a row) reads them from
    device memory each step; its picks equal the plain version's."""
    from repro_torch.kernels.greedy_diversify import greedy_plan

    W = 60_000
    assert greedy_plan(W)["route"] == "block_streamed"
    g = torch.Generator(device=cuda_device).manual_seed(9)
    scores = torch.randn((1, W), generator=g, device=cuda_device)
    scores[0, W // 2:] = float("-inf")
    adj = torch.zeros((1, W, W), dtype=torch.uint8, device=cuda_device)
    flat = torch.randint(0, W * W, (20 * W,), generator=g, device=cuda_device)
    adj.view(-1)[flat] = 1
    got = _greedy_equal(scores, adj, 40)
    assert int((got >= 0).sum()) == 40


@pytest.mark.cuda
@pytest.mark.parametrize("W", [64, 1024])
def test_cuda_greedy_repeat(cuda_device, W):
    """300 launches in a row at 16 lanes (the staged route at W = 64, the
    prefetch route at W = 1024; half the lanes sorted, as a queue keeps
    them) give the plain version's picks every time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.greedy_diversify import greedy_cuda

    rng = np.random.default_rng(W + 1)
    s = rng.normal(size=(16, W)).astype(np.float32)
    s[::2] = -np.sort(-s[::2], axis=1)
    scores = torch.from_numpy(s).to(cuda_device)
    adj = torch.from_numpy((rng.random((16, W, W)) < 0.1).astype(
        np.uint8)).to(cuda_device)
    want = ref.greedy_diversify(scores, adj != 0, 10)[0]
    bad = sum(not torch.equal(greedy_cuda(scores, adj, 10), want)
              for _ in range(300))
    assert bad == 0, f"{bad} of 300 launches differ from the plain version"
