"""repro_torch's tournament-merge primitive against repro's, on the CPU.

``kernels.ops.topk_merge`` (its plain version here, on CPU tensors) must
equal ``repro.kernels.ref.topk_merge`` bit for bit: ids, and scores down to
the sign of a zero. Runs are sorted by (score desc, id asc), with equal
scores, -0.0 beside +0.0 and (-1, -inf) padding tails injected; a
butterfly over P rows merges as the sharded search's tournament does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

_jmerge = jax.jit(jref.topk_merge)


def _run(rng, L, ids_pool, pad=0, ties=False, zeros=False):
    """One run of length L sorted by (score desc, id asc): distinct ids
    from ``ids_pool``, the last ``pad`` entries (-1, -inf)."""
    m = L - pad
    ids = rng.choice(ids_pool, size=m, replace=False).astype(np.int32)
    if ties:
        scores = rng.integers(-3, 4, size=m).astype(np.float32)
    else:
        scores = rng.normal(size=m).astype(np.float32)
    if zeros:
        scores[rng.random(m) < 0.4] = 0.0
        scores[rng.random(m) < 0.5] *= -1.0        # -0.0 beside +0.0
    order = np.lexsort((ids, -scores))
    ids = np.concatenate([ids[order], np.full(pad, -1, np.int32)])
    scores = np.concatenate([scores[order],
                             np.full(pad, -np.inf, np.float32)])
    return ids, scores


def _assert_same(got, ref):
    gi, gs = (np.asarray(a) for a in got)
    ri, rs = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(gs.view(np.int32), rs.view(np.int32))


def _port(a, b):
    return tops.topk_merge(*(torch.from_numpy(x) for x in (*a, *b)))


@pytest.mark.parametrize("L", [1, 5, 32, 100, 128, 300])
@pytest.mark.parametrize("case", ["plain", "ties", "zeros", "padding",
                                  "all_padding"])
def test_topk_merge_matches_reference(L, case):
    rng = np.random.default_rng(L * 7 + len(case))
    pool = np.arange(4 * L + 8)
    pad = {"padding": L // 3, "all_padding": L}.get(case, 0)
    a = _run(rng, L, pool, pad=pad if case == "padding" else 0,
             ties=case in ("ties", "zeros"), zeros=case == "zeros")
    b = _run(rng, L, pool, pad=pad, ties=case in ("ties", "zeros"),
             zeros=case == "zeros")
    _assert_same(_port(a, b), _jmerge(*(jnp.asarray(x) for x in (*a, *b))))
    # the same ids in both runs (equal keys across runs keep run a first)
    _assert_same(_port(a, a), _jmerge(*(jnp.asarray(x) for x in (*a, *a))))


def test_topk_merge_signed_zero_ties_break_by_id():
    a = (np.array([7, 3], np.int32), np.array([-0.0, -0.0], np.float32))
    b = (np.array([2, 9], np.int32), np.array([0.0, -np.inf], np.float32))
    a = (a[0][np.lexsort((a[0], -a[1]))], a[1])
    got = _port(a, b)
    _assert_same(got, _jmerge(*(jnp.asarray(x) for x in (*a, *b))))
    np.testing.assert_array_equal(got[0].numpy(), [2, 3])


@pytest.mark.parametrize("P", [2, 4, 8])
def test_topk_merge_butterfly(P):
    """log2(P) rounds of pairwise merges over the rows of a [P, B, L]
    tensor (one call a round), against the reference merging each row's
    pair in the same order."""
    rng = np.random.default_rng(P)
    B, L = 3, 40
    runs = [[_run(rng, L, np.arange(s * 1000, s * 1000 + 200),
                  pad=int(rng.integers(0, L // 2)), ties=True, zeros=True)
             for _ in range(B)] for s in range(P)]
    ids = torch.from_numpy(np.array([[r[0] for r in sh] for sh in runs]))
    sc = torch.from_numpy(np.array([[r[1] for r in sh] for sh in runs]))
    ref = [[(jnp.asarray(r[0]), jnp.asarray(r[1])) for r in sh] for sh in runs]
    for r in range(P.bit_length() - 1):
        other = torch.arange(P) ^ (1 << r)
        ids, sc = tops.topk_merge(ids, sc, ids[other], sc[other])
        ref = [[_jmerge(*ref[s][b], *ref[s ^ (1 << r)][b]) for b in range(B)]
               for s in range(P)]
    for s in range(P):
        for b in range(B):
            _assert_same((ids[s, b], sc[s, b]), ref[s][b])
    # every shard ends with the same global top L
    assert all(torch.equal(ids[0], ids[s]) for s in range(P))


def test_topk_merge_rungs_and_shapes():
    """The plain version over leading rows equals its per-row calls; the
    cuda rung refuses a CPU tensor."""
    rng = np.random.default_rng(0)
    a = [_run(rng, 16, np.arange(64), ties=True) for _ in range(4)]
    b = [_run(rng, 16, np.arange(64), ties=True) for _ in range(4)]
    stack = [torch.from_numpy(np.stack([r[i] for r in runs]))
             for runs in (a, b) for i in (0, 1)]
    ids, sc = tref.topk_merge(*stack)
    for r in range(4):
        ri, rs = tref.topk_merge(*(t[r] for t in stack))
        assert torch.equal(ids[r], ri) and torch.equal(sc[r], rs)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.topk_merge(*stack, impl="cuda")


_jmerge_rows = jax.jit(jax.vmap(jref.topk_merge))


def _shard_runs(rng, P, B, L, shared_ids=False):
    """[P, B, L] runs sorted by (score desc, id asc) with tied scores,
    -0.0 beside +0.0 and padding tails. Every shard draws its ids from one
    pool, so equal keys meet across shards; with ``shared_ids`` shard 1
    repeats shard 0's runs with their zeros' signs flipped (ties on both
    keys, other bits)."""
    pool = np.arange(3 * L + 2)
    runs = [[_run(rng, L, pool, pad=int(rng.integers(0, L // 2 + 1)),
                  ties=True, zeros=True) for _ in range(B)] for _ in range(P)]
    ids = np.array([[r[0] for r in sh] for sh in runs])
    sc = np.array([[r[1] for r in sh] for sh in runs])
    if shared_ids:
        ids[1] = ids[0]
        sc[1] = np.where(sc[0] == 0.0, -sc[0], sc[0])
    return ids, sc


def _jax_butterfly(ids, sc):
    """The reference's pairwise merge vmapped over the P * B (shard, lane)
    rows of each butterfly round, shard s merging with s ^ 2^r; shard 0's
    rows."""
    P, B, L = ids.shape
    ji, js = jnp.asarray(ids), jnp.asarray(sc)
    for r in range(P.bit_length() - 1):
        other = np.arange(P) ^ (1 << r)
        ji, js = (a.reshape(P, B, L) for a in _jmerge_rows(
            ji.reshape(-1, L), js.reshape(-1, L),
            ji[other].reshape(-1, L), js[other].reshape(-1, L)))
    return ji[0], js[0]


@pytest.mark.parametrize("L", [1, 10, 40])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_topk_tournament_matches_reference_butterfly(P, L):
    """The plain rung of ``ops.topk_tournament`` equals the reference's
    pairwise merge run as a butterfly, shard 0's rows: ids and score bits,
    on runs with ties, +-0.0, padding and ids shared across shards."""
    rng = np.random.default_rng(100 * P + L)
    for shared in (False, True):
        ids, sc = _shard_runs(rng, P, 3, L, shared_ids=shared)
        got = tops.topk_tournament(torch.from_numpy(ids),
                                   torch.from_numpy(sc), impl="ref")
        assert got[0].shape == (3, L) and got[0].dtype == torch.int32
        _assert_same(got, _jax_butterfly(ids, sc))


@pytest.mark.parametrize("P", [2, 4, 8])
def test_topk_tournament_is_the_first_L_of_all_runs(P):
    """What the one-launch kernel computes: the tournament's result is the
    first L of every shard's run concatenated in shard order and sorted by
    (score desc, id asc), ties on both keys in that order."""
    rng = np.random.default_rng(P + 7)
    for shared in (False, True):
        ids, sc = (torch.from_numpy(a)
                   for a in _shard_runs(rng, P, 3, 40, shared_ids=shared))
        got = tops.topk_tournament(ids, sc, impl="ref")
        want = tref.sort_top(ids.permute(1, 0, 2).reshape(3, -1),
                             sc.permute(1, 0, 2).reshape(3, -1), 40)
        _assert_same(got, want)


def test_topk_tournament_rejects_other_shapes():
    """P must be a power of two >= 2 and the inputs [P, B, L] alike; the
    cuda rung refuses a CPU tensor."""
    def runs(*shape):
        return (torch.zeros(shape, dtype=torch.int32),
                torch.zeros(shape, dtype=torch.float32))

    for shape in ((3, 2, 4), (6, 2, 4), (1, 2, 4)):
        with pytest.raises(ValueError, match="power of two"):
            tops.topk_tournament(*runs(*shape))
    for shape in ((4, 8), (2, 2, 2, 4)):
        with pytest.raises(ValueError, match=r"\[P, B, L\]"):
            tops.topk_tournament(*runs(*shape))
    with pytest.raises(ValueError, match=r"\[P, B, L\]"):
        tops.topk_tournament(runs(4, 2, 4)[0], runs(4, 2, 5)[1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.topk_tournament(*runs(4, 2, 4), impl="cuda")


def test_tournament_merge_is_one_topk_tournament_call(monkeypatch):
    """The sharded path's tournament merge makes one ``topk_tournament``
    call and no two-run merge, and gives the reference butterfly's rows."""
    from repro_torch.compat import make_mesh
    from repro_torch.sharded_search import search as ssearch

    calls = []
    real = tops.topk_tournament

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def no_pairwise(*a, **kw):
        raise AssertionError("the tournament ran a two-run merge")

    monkeypatch.setattr(tops, "topk_tournament", counted)
    monkeypatch.setattr(tops, "topk_merge", no_pairwise)
    ids, sc = _shard_runs(np.random.default_rng(5), 4, 3, 10)
    mesh = make_mesh((4,), ("data",), device="cpu")
    got = ssearch._merge(torch.from_numpy(ids), torch.from_numpy(sc), mesh,
                         "tournament", 10)
    assert len(calls) == 1
    _assert_same(got, _jax_butterfly(ids, sc))
