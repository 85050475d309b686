"""repro_torch.core.queue / bucketing and the engine's rank-merge insert
against the reference's, on random tie-free candidate batches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucketing as jb
from repro.core import queue as jq
from repro.core.batch_progressive import _merge_insert as j_merge
from repro_torch.core import bucketing as tb
from repro_torch.core import queue as tq
from repro_torch.core.batch_progressive import _merge_insert as t_merge

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _queues(B=4, C=32, M=16, n=200, seed=0):
    """Sorted queues with sentinels, plus candidate batches that repeat
    queue ids, repeat each other and carry -1 entries."""
    rng = np.random.default_rng(seed)
    ids = np.full((B, C), -1, np.int32)
    sc = np.full((B, C), -np.inf, np.float32)
    st = np.ones((B, C), bool)
    for b in range(B):
        m = int(rng.integers(1, C))
        pick = rng.choice(n, m, replace=False)
        s = rng.normal(size=m).astype(np.float32)
        o = np.argsort(-s, kind="stable")
        ids[b, :m], sc[b, :m] = pick[o], s[o]
        st[b, :m] = rng.random(m) < 0.5
    new_ids = rng.integers(-1, n, (B, M)).astype(np.int32)
    new_ids[:, :3] = ids[:, :3]               # already queued
    new_ids[:, 5] = new_ids[:, 4]              # duplicated in the batch
    new_sc = rng.normal(size=(B, M)).astype(np.float32)
    mask = rng.random((B, M)) < 0.8
    return ids, sc, st, new_ids, new_sc, mask


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in a]


def _j(*a):
    return [jnp.asarray(v) for v in a]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_and_merge_insert_match_reference(seed):
    ids, sc, st, nid, nsc, mask = _queues(seed=seed)
    tq_ = tq.Queue(*_t(ids, sc, st))
    t_ins = tq.insert(tq_, *_t(nid, nsc, mask))
    t_mrg = t_merge(tq_, *_t(nid, nsc, mask))
    for b in range(ids.shape[0]):
        jq_ = jq.Queue(*_j(ids[b], sc[b], st[b]))
        j_ins = jq.insert(jq_, *_j(nid[b], nsc[b], mask[b]))
        j_mrg = jax.jit(j_merge)(jq_, *_j(nid[b], nsc[b], mask[b]))
        for got, ref in ((t_ins, j_ins), (t_mrg, j_mrg)):
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g[b].numpy(), np.asarray(r))


@pytest.mark.parametrize("seed", [0, 3])
def test_scans_and_builders_match_reference(seed):
    ids, sc, st, _, _, _ = _queues(seed=seed)
    q = tq.Queue(*_t(ids, sc, st))
    limits = np.array([3, 10, 32, 0])
    p, ex = tq.first_unstable(q, torch.from_numpy(limits))
    cnt = tq.stable_count(q)
    for b in range(ids.shape[0]):
        jq_ = jq.Queue(*_j(ids[b], sc[b], st[b]))
        jp, jex = jq.first_unstable(jq_, int(limits[b]))
        assert bool(ex[b]) == bool(jex)
        if bool(jex):
            assert int(p[b]) == int(jp)
        assert int(cnt[b]) == int(jq.stable_count(jq_))
        assert int(tq.valid_count(q)[b]) == int(jq.valid_count(jq_))
    shuffled = np.random.default_rng(seed).permutation(ids.shape[1])
    fe = tq.from_entries(*_t(ids[:, shuffled], sc[:, shuffled], st[:, shuffled]), 40)
    g = tq.grow(q, 40)
    for b in range(ids.shape[0]):
        jfe = jq.from_entries(*_j(ids[b, shuffled], sc[b, shuffled],
                                  st[b, shuffled]), 40)
        jg = jq.grow(jq.Queue(*_j(ids[b], sc[b], st[b])), 40)
        for got, ref in ((fe, jfe), (g, jg)):
            for a, r in zip(got, ref):
                np.testing.assert_array_equal(a[b].numpy(), np.asarray(r))
    mq, jmq = tq.make_queue(8), jq.make_queue(8)
    for a, r in zip(mq, jmq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


@pytest.mark.parametrize("x", [0, 1, 2, 3, 5, 64, 65, 1000])
def test_bucketing_matches_reference(x):
    assert tb.next_pow2(x) == jb.next_pow2(x)
    assert tb.pow2_group_sizes(max(x, 1)) == jb.pow2_group_sizes(max(x, 1))
    if x:
        idx = np.arange(x) * 3
        np.testing.assert_array_equal(tb.pow2_padded_indices(idx),
                                      jb.pow2_padded_indices(idx))
