"""The serving front door's scheduler: repro_torch.serve.scheduler and
repro_torch.serve.policies against repro.serve.scheduler / policies on the
conftest graph (shared through to_host -> from_host), on the CPU with the
reference at its default rung ("auto", which is "ref" off a TPU).

Tolerances: ids, certificates, K_final, admission orders and every counter
must be equal; scores within rtol = atol = 1e-5 (torch and XLA reduce in
different orders), as in test_torch_batch_pss.py. The cost model's JSON
must be the reference's, byte for byte.
"""
import json

import numpy as np
import pytest
import torch

from repro.core.graph import to_host
from repro.serve import policies as jpol
from repro.serve import scheduler as jsch
from repro_torch.core.graph import from_host
from repro_torch.serve import policies as tpol
from repro_torch.serve import scheduler as tsch

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

KS = [3, 5, 8] * 4
EPSS = [0.0, -0.5] * 6
METHODS = ["pss", "pgs", "pds"] * 4
TENANTS = ["tight", "lax", "heavy"] * 4


class FakeClock:
    """Strictly increasing deterministic clock: timestamps (and so EDF
    deadlines and every stat) depend only on the call sequence."""

    def __init__(self, dt: float = 1e-3):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


@pytest.fixture(scope="module")
def world(small_graph, clustered_data):
    rng = np.random.default_rng(11)
    qs = (clustered_data[rng.integers(0, clustered_data.shape[0], 12)]
          + rng.normal(size=(12, clustered_data.shape[1])) * 0.05
          ).astype(np.float32)
    return small_graph, from_host(to_host(small_graph), device="cpu"), qs


def _sched(pkg, graph, **kw):
    kw = dict(dict(num_lanes=3, max_k=8, default_ef=10, prewarm=False), **kw)
    if pkg is tsch:
        kw["device"] = "cpu"
    return pkg.LaneScheduler(graph, **kw)


def _serve(sched, qs, methods=None, tenants=None, exc=()):
    """Submit every request (pumping on backpressure), then drain; the
    requests the policy dropped are counted by the scheduler."""
    reqs = []
    for i in range(len(qs)):
        while True:
            try:
                reqs.append(sched.submit(
                    qs[i], KS[i], EPSS[i],
                    method=None if methods is None else methods[i],
                    tenant="default" if tenants is None else tenants[i]))
                break
            except exc[0] if exc else ():
                sched.pump()
            except exc[1:] if exc else ():
                reqs.append(None)
                break
    sched.drain()
    return reqs


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.ids, np.asarray(ref.ids))
    np.testing.assert_allclose(got.scores, np.asarray(ref.scores),
                               rtol=1e-5, atol=1e-5)
    assert got.stats.certified == ref.stats.certified
    assert got.stats.K_final == ref.stats.K_final


def _admission_order(sched) -> list[int]:
    done = [r for r in sched.completed if r.t_admit is not None]
    return [r.rid for r in sorted(done, key=lambda r: r.t_admit)]


def test_scheduler_matches_reference_mixed_methods(world):
    """12 requests over 3 lanes with k in {3, 5, 8}, two eps and methods
    pss / pgs / pds: every result, recycled lanes included, equals the
    reference scheduler's."""
    jg, tg, qs = world
    exc = (jsch.SchedulerSaturated,)
    ref = _serve(_sched(jsch, jg), qs, METHODS, exc=exc)
    got = _serve(_sched(tsch, tg), qs, METHODS,
                 exc=(tsch.SchedulerSaturated,))
    for g, r in zip(got, ref):
        _assert_same(g.result, r.result)


def test_lockstep_and_continuous_agree(world):
    """The batching regime changes latency, never results — and both
    regimes equal the reference's lockstep run."""
    jg, tg, qs = world
    cont = _sched(tsch, tg).run(qs, KS, EPSS)
    lock = _sched(tsch, tg, admission="lockstep").run(qs, KS, EPSS)
    ref = _sched(jsch, jg, admission="lockstep").run(qs, KS, EPSS)
    for a, b, r in zip(cont, lock, ref):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        _assert_same(a, r)


def _model(pol):
    """A frozen cost model with learned buckets and a known time rate: one
    second of predicted service per request of every shape in the trace."""
    m = pol.ExpansionCostModel()
    for k in sorted(set(KS)):
        for eps in sorted(set(EPSS)):
            for method in ("pss", "pgs", "pds"):
                m.observe(k, eps, method, expansions=1000, rounds=2,
                          service=1.0)
    return m.freeze()


def _policy(pol, name):
    if name == "slo_cost":
        return pol.SloCostPolicy(budgets={"tight": 2.5, "lax": 60.0,
                                          "heavy": 0.5})
    return pol.make_policy(name)


@pytest.mark.parametrize("name", ["fifo", "drr", "slo_cost"])
def test_admission_order_and_conservation_match_reference(world, name):
    """Contract 4: with an injected clock and a frozen cost model a policy's
    decisions are a pure function of the trace, so the port admits in the
    reference's order, sheds and defers the same requests, and every
    offered request is served, shed or deferred exactly once."""
    jg, tg, qs = world
    out = []
    for sch, pol, g in ((jsch, jpol, jg), (tsch, tpol, tg)):
        sched = _sched(sch, g, policy=_policy(pol, name),
                       cost_model=_model(pol), max_pending=len(qs),
                       clock=FakeClock())
        reqs = _serve(sched, qs, METHODS, TENANTS,
                      exc=(sch.SchedulerSaturated, sch.RequestShed,
                           sch.RequestDeferred))
        st = sched.latency_stats()
        served = sum(r is not None for r in reqs)
        assert served == st["completed"]
        assert st["completed"] + st["shed"] + st["deferred"] == len(qs)
        out.append((_admission_order(sched), st["completed"], st["shed"],
                    st["deferred"],
                    {t: (v["completed"], v["shed"], v["deferred"])
                     for t, v in st["tenants"].items()},
                    [r.rid if r is not None else None for r in reqs]))
    assert out[1] == out[0]
    if name == "slo_cost":          # the trace exercises every decision
        assert out[0][2] > 0 and out[0][3] > 0


def test_backpressure_and_stats(world):
    _, tg, qs = world
    sched = _sched(tsch, tg, num_lanes=2, max_pending=2)
    sched.submit(qs[0], 3, 0.0)
    sched.submit(qs[1], 3, 0.0)
    with pytest.raises(tsch.SchedulerSaturated):
        sched.submit(qs[2], 3, 0.0)
    assert sched.try_submit(qs[2], 3, 0.0) is None
    sched.pump()                       # admits into lanes, queue drains
    assert sched.try_submit(qs[2], 3, 0.0) is not None
    sched.drain()
    st = sched.latency_stats()
    assert st["completed"] == 3 and st["pending"] == st["inflight"] == 0
    assert st["p99_latency"] >= st["p50_latency"] >= 0
    assert st["shards"] is None and st["scale_events"] == 0
    for r in sched.completed:
        assert r.t_submit <= r.t_admit <= r.t_done
    assert tsch.jain_fairness([1.0, 1.0]) == pytest.approx(1.0)
    assert tsch.percentile([], 50) == 0.0


def test_elastic_refuses_the_single_host_engine(world):
    _, tg, _ = world
    with pytest.raises(ValueError, match="rescalable"):
        _sched(tsch, tg, elastic=True)


def _observed(pol):
    m = pol.ExpansionCostModel(K0=16, alpha=0.5, eps_bands=(0.25, 0.75))
    rng = np.random.default_rng(4)
    for _ in range(20):
        k = int(rng.integers(2, 12))
        eps = float(rng.uniform(0.0, 1.0))
        m.observe(k, eps, "pss", expansions=float(rng.integers(50, 500)),
                  rounds=int(rng.integers(1, 5)),
                  service=float(rng.uniform(0.01, 0.2)))
        m.observe_cache(k, eps, "pss", hit=bool(rng.random() < 0.5))
    return m


def _predictions(m):
    out = []
    for k in (2, 5, 11, 16):
        for eps in (0.1, 0.5, 0.9):
            out.append((m.predict_expansions(k, eps, "pss"),
                        m.predict_expansions(k, eps, "pss", offered=True),
                        m.predict_service(k, eps, "pss"),
                        m.predict_rounds(k, eps, "pss"),
                        m.predict_hit_rate(k, eps, "pss")))
    return out


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_cost_model_json_and_cross_load(tmp_path, direction):
    """The same observations give the reference's JSON byte for byte, and a
    model saved by one package loads in the other with equal predictions
    and stats."""
    jm, tm = _observed(jpol), _observed(tpol)
    jm.save(tmp_path / "ref.json")
    tm.save(tmp_path / "port.json")
    assert (tmp_path / "port.json").read_text() \
        == (tmp_path / "ref.json").read_text()
    src, dst = (("port.json", jpol) if direction == "port_to_reference"
                else ("ref.json", tpol))
    loaded = dst.ExpansionCostModel.load(tmp_path / src)
    assert _predictions(loaded) == _predictions(jm)
    assert loaded.stats() == jm.stats()
    doc = json.loads((tmp_path / src).read_text())
    assert doc["version"] == 1 and len(doc["buckets"]) == len(jm._buckets)


def test_policy_cold_priors_match_reference():
    for k in (1, 2, 3, 8, 16, 64):
        assert tpol.theorem1_prior(k) == jpol.theorem1_prior(k)
    with pytest.raises(ValueError):
        tpol.make_policy("lifo")
    with pytest.raises(ValueError):
        tpol.DrrPolicy(quanta={"a": 0.0})
