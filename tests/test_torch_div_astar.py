"""repro_torch.core.div_astar (host loop), theorems and degrees against the
reference's jitted div-A*, its numpy oracle and its theorem predicates."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import diversity_graph as jdg
from repro.core import theorems as jth
from repro.core.div_astar import div_astar as j_div_astar
from repro.core.div_astar_ref import div_astar_ref
from repro_torch.core import diversity_graph as tdg
from repro_torch.core import theorems as tth
from repro_torch.core.div_astar import div_astar

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _instance(K, density, seed, invalid=0):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=K).astype(np.float32) + 3.0
    if invalid:
        scores[rng.choice(K, invalid, replace=False)] = -np.inf
    a = rng.random((K, K)) < density
    adj = np.triu(a, 1)
    adj = adj | adj.T
    return scores, adj


@pytest.mark.parametrize("K,density,k,seed,invalid", [
    (16, 0.3, 4, 0, 2), (40, 0.2, 5, 1, 0), (64, 0.5, 6, 2, 0),
    (64, 0.05, 10, 3, 8), (128, 0.3, 5, 4, 0)])
def test_div_astar_matches_reference_step_for_step(K, density, k, seed,
                                                   invalid):
    scores, adj = _instance(K, density, seed, invalid=invalid)
    got = div_astar(scores, adj, k)
    ref = j_div_astar(jnp.asarray(scores), jnp.asarray(adj), k)
    np.testing.assert_array_equal(got.best_sets, np.asarray(ref.best_sets))
    np.testing.assert_array_equal(got.best_scores, np.asarray(ref.best_scores))
    assert got.complete == bool(ref.complete)
    assert got.expansions == int(ref.expansions)
    assert got.complete
    if not invalid:  # second check: the numpy oracle's optimal sets
        sets, best, complete = div_astar_ref(scores, adj, k)
        assert complete
        np.testing.assert_allclose(got.best_scores, best, rtol=1e-5)
        for m, s in enumerate(sets):
            if s is not None:
                assert sorted(got.best_sets[m, :m + 1].tolist()) == s


def test_div_astar_budget_exhaustion_matches_reference():
    scores, adj = _instance(96, 0.05, 7)
    got = div_astar(scores, adj, 10, max_expansions=300)
    ref = j_div_astar(jnp.asarray(scores), jnp.asarray(adj), 10,
                      max_expansions=300)
    assert not got.complete and not bool(ref.complete)
    assert got.expansions == int(ref.expansions) == 300
    np.testing.assert_array_equal(got.best_sets, np.asarray(ref.best_sets))
    np.testing.assert_array_equal(got.best_scores, np.asarray(ref.best_scores))


@pytest.mark.parametrize("k", [1, 2, 5, 10])
def test_theorems_and_degrees_match_reference(k):
    rng = np.random.default_rng(k)
    best = np.sort(rng.normal(size=k).astype(np.float32) * 3)
    best[: k // 3] = -np.inf if k > 2 else best[: k // 3]
    mv = float(tth.theorem2_min_value(torch.from_numpy(best), k))
    assert mv == float(jth.theorem2_min_value(jnp.asarray(best), k))
    assert bool(tth.theorem2_holds(torch.from_numpy(best), k, 0.1)) == bool(
        jth.theorem2_holds(jnp.asarray(best), k, 0.1))
    _, adj = _instance(50, 0.2, k)
    valid = rng.random(50) < 0.8
    deg = tdg.degrees(torch.from_numpy(adj), torch.from_numpy(valid))
    jdeg = jdg.degrees(jnp.asarray(adj), jnp.asarray(valid))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))
    assert int(tth.theorem1_K(deg, k, torch.from_numpy(valid))) == int(
        jth.theorem1_K(jdeg, k, jnp.asarray(valid)))
