"""The RAG serving path: repro_torch.serve.rag and repro_torch.launch.serve
against repro.serve.rag / repro.launch.serve, on the CPU.

Both pipelines serve the conftest graph (tests/test_rag.py's setting), the
reference's carried over by ``core.graph.from_host``, with qwen2-1.5b's
reduced config on the reference's parameters (``models.model.from_host``).
Retrieval is exact: ids and certificates must be equal for every engine
and wiring. Generation is held as tests/test_torch_models.py holds decode:
teacher-forced logits along the reference's generated sequence within 4
bf16 ulps of the largest |logit|, and tokens equal wherever the
reference's top-2 margin exceeds twice that.
"""
import contextlib
import functools
import io
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import db as jdb
from repro.core.graph import to_host
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.serve import rag as jrag
from repro.serve.query import Query as JQuery
from repro_torch import configs as tconfigs
from repro_torch import db as tdb
from repro_torch.core.batch_progressive import ProgressiveEngine
from repro_torch.core.graph import from_host
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serve import rag as trag
from repro_torch.serve.query import Query as TQuery

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

ARCH, K, EPS, EF, K_BUDGET, LANES = "qwen2-1.5b", 4, 0.0, 4, 32, 3
STEPS, LOGIT_ULPS = 6, 4


def bf16_tol(ref: np.ndarray) -> float:
    top = float(np.max(np.abs(ref)))
    return LOGIT_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.fixture(scope="module")
def world(clustered_data, small_graph):
    cfg = jconfigs.get_config(ARCH).reduced()
    tcfg = tconfigs.get_config(ARCH).reduced()
    params = JM.init_params(cfg, jax.random.key(0))
    tparams = TM.from_host(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    rng = np.random.default_rng(3)
    qs = (clustered_data[rng.integers(0, len(clustered_data), 5)]
          + 0.05 * rng.normal(size=(5, clustered_data.shape[1]))
          ).astype(np.float32)
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                jgraph=small_graph, x=clustered_data,
                tgraph=from_host(to_host(small_graph), device="cpu"), qs=qs)


def _pipes(w, **kw):
    """The reference's and the port's pipeline through the graph= shim."""
    kw = dict(dict(k=K, eps=EPS, K_budget=K_BUDGET, ef=EF,
                   num_lanes=LANES), **kw)
    return (jrag.RagPipeline(w["cfg"], w["params"], w["jgraph"], **kw),
            trag.RagPipeline(w["tcfg"], w["tparams"], w["tgraph"], **kw))


def _dbs(w):
    kw = dict(index=None, metric="l2", num_lanes=LANES, max_k=16,
              default_ef=EF, prewarm=False)
    return (jdb.DiverseVectorDB(**dict(kw, index=w["jgraph"])),
            tdb.DiverseVectorDB(**dict(kw, index=w["tgraph"]), device="cpu"))


def _retrieve(pipe, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return pipe.retrieve(*args, **kw)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int32 and got[1].dtype == bool


@pytest.mark.parametrize("engine", ["scheduler", "lockstep", "fixed_k"])
@pytest.mark.parametrize("k, eps", [(K, EPS), (5, -1.0)])
def test_retrieve_matches_reference(world, engine, k, eps):
    jp, tp = _pipes(world, engine=engine, k=k, eps=eps)
    got = _retrieve(tp, world["qs"])
    _assert_same(got, _retrieve(jp, world["qs"]))
    assert (got[0] >= 0).all()


def test_retrieve_through_db_and_queries(world):
    """``db=`` with raw embeddings and per-request overrides, then a
    ``Query`` list carrying its own k / eps / tenant."""
    jd, td = _dbs(world)
    jp = jrag.RagPipeline(world["cfg"], world["params"], db=jd, k=K, eps=EPS,
                          ef=EF)
    tp = trag.RagPipeline(world["tcfg"], world["tparams"], db=td, k=K,
                          eps=EPS, ef=EF)
    qs = world["qs"]
    _assert_same(tp.retrieve(qs), jp.retrieve(qs))
    ks, epss = [3, 4, 5, 4, 3], [0.0, -0.5, 0.0, -1.0, 0.0]
    tenants = ["a", "b", "a", "b", "a"]
    _assert_same(tp.retrieve(qs, ks=ks, epss=epss, tenants=tenants),
                 jp.retrieve(qs, ks=ks, epss=epss, tenants=tenants))
    jq = [JQuery(q, k=k, eps=e, tenant=t)
          for q, k, e, t in zip(qs, ks, epss, tenants)]
    tq = [TQuery(q, k=k, eps=e, tenant=t)
          for q, k, e, t in zip(qs, ks, epss, tenants)]
    got = tp.retrieve(tq)
    _assert_same(got, jp.retrieve(jq))
    assert got[0].shape == (len(qs), max(ks))


def test_generate_matches_reference(world):
    """The same ids and certificates; the port's decode under teacher
    forcing of the reference's tokens within tolerance; its own greedy
    tokens equal the reference's up to the first position whose top-2
    margin is within twice the tolerance."""
    cfg, tcfg = world["cfg"], world["tcfg"]
    jd, td = _dbs(world)
    jp = jrag.RagPipeline(cfg, world["params"], db=jd, k=K, eps=EPS, ef=EF)
    tp = trag.RagPipeline(tcfg, world["tparams"], db=td, k=K, eps=EPS, ef=EF)
    qs = world["qs"]
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (len(qs), 3)).astype(np.int32)
    jtok, jids, jcert = jp.generate(qs, prompts, steps=STEPS)
    ttok, tids, tcert = tp.generate(qs, prompts, steps=STEPS)
    np.testing.assert_array_equal(tids, np.asarray(jids))
    np.testing.assert_array_equal(tcert, np.asarray(jcert))
    assert ttok.shape == (len(qs), STEPS) and ttok.dtype == np.int32
    seq = np.concatenate([np.asarray(jids) % cfg.vocab_size, prompts,
                          np.asarray(jtok)], axis=1).astype(np.int32)
    max_seq = seq.shape[1]
    step = jax.jit(functools.partial(JM.decode_step, cfg))
    jc = JM.init_cache(cfg, len(qs), max_seq)
    tc = TM.init_cache(tcfg, len(qs), max_seq, device="cpu")
    jl, tl = [], []
    for t in range(max_seq):
        lg, jc = step(world["params"], jc, jnp.asarray(seq[:, t:t + 1]))
        jl.append(np.asarray(lg[:, 0]))
        lg, tc = TM.decode_step(tcfg, world["tparams"], tc, seq[:, t:t + 1])
        tl.append(lg[:, 0].numpy())
    jl, tl = np.stack(jl, 1), np.stack(tl, 1)
    tol = bf16_tol(jl)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol)
    # the generated tokens are the argmax of the last STEPS positions'
    # predecessors
    gen = slice(seq.shape[1] - STEPS - 1, seq.shape[1] - 1)
    np.testing.assert_array_equal(np.argmax(jl[:, gen], -1), np.asarray(jtok))
    top2 = np.sort(jl[:, gen], -1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * tol
    np.testing.assert_array_equal(np.argmax(tl[:, gen], -1)[sure],
                                  np.asarray(jtok)[sure])
    prefix = np.cumprod(sure, axis=1).astype(bool)
    np.testing.assert_array_equal(ttok[prefix], np.asarray(jtok)[prefix])
    print(f"tokens compared at {sure.mean():.3f} of the positions, the "
          f"free-running ones at {prefix.mean():.3f}")


def test_context_tokens_use_floor_modulo(world, monkeypatch):
    """A shed row's -1 ids become vocab_size - 1 (Python's floor modulo,
    the reference's ``ids % vocab_size``), not -1 as ``fmod`` gives."""
    tp = trag.RagPipeline(world["tcfg"], world["tparams"], world["tgraph"],
                          k=3)
    ids = np.array([[-1, 5, 600], [7, -1, -1]], np.int32)
    monkeypatch.setattr(tp, "retrieve",
                        lambda *a, **k: (ids, np.zeros(2, bool)))
    fed = []
    step = trag.M.decode_step

    def recording(cfg, params, cache, token):
        fed.append(torch.as_tensor(token).reshape(-1).tolist())
        return step(cfg, params, cache, token)

    monkeypatch.setattr(trag.M, "decode_step", recording)
    tp.generate(world["qs"][:2], np.zeros((2, 1), np.int32), steps=1)
    v = world["tcfg"].vocab_size
    assert np.array(fed[:3]).T.tolist() == (ids % v).tolist()
    assert fed[0][0] == v - 1 and fed[2][0] == 600 % v


def test_shims_warn_and_errors_match(world):
    tp = trag.RagPipeline(world["tcfg"], world["tparams"], world["tgraph"])
    with pytest.warns(DeprecationWarning, match="graph=.*deprecated"):
        tp.scheduler
    eng = ProgressiveEngine(world["tgraph"], LANES, max_k=16, default_ef=EF)
    tb = trag.RagPipeline(world["tcfg"], world["tparams"], backend=eng, k=K,
                          eps=EPS, ef=EF)
    with pytest.warns(DeprecationWarning, match="backend=.*deprecated"):
        got = tb.retrieve(world["qs"])
    _assert_same(got, _retrieve(_pipes(world)[0], world["qs"]))
    tq = [TQuery(q, k=K, eps=EPS) for q in world["qs"]]
    jq = [JQuery(q, k=K, eps=EPS) for q in world["qs"]]
    for jp, tp, kw in ((*_pipes(world), dict(ks=[K] * 5)),
                       (*_pipes(world, engine="lockstep"), {})):
        msgs = []
        for pipe, queries in ((jp, jq), (tp, tq)):
            with pytest.raises(ValueError) as err:
                _retrieve(pipe, queries, **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    for pkg, cfg, params in ((jrag, world["cfg"], world["params"]),
                             (trag, world["tcfg"], world["tparams"])):
        with pytest.raises(ValueError, match="single-host graph"):
            pkg.RagPipeline(cfg, params, engine="lockstep").retrieve(
                world["qs"])


def test_launcher_prints_the_reference_ids(monkeypatch):
    """``main([... "--device", "cpu", "--corpus", "1000"])`` prints the
    reference launcher's retrieved ids and certificates."""
    argv = ["--corpus", "1000", "--requests", "4"]

    def lines(run):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        out = buf.getvalue().splitlines()
        at = out.index("retrieved ids:")
        return out[at - 1].split("certified=")[1], out[at + 1:at + 5]

    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    want = lines(jserve.main)
    got = lines(lambda: tserve.main(argv + ["--device", "cpu"]))
    assert got == want
    assert want[0] == "[True, True, True, True]"
