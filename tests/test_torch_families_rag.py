"""The other model families served through the RAG path:
repro_torch.serve.rag and repro_torch.launch.serve against
repro.serve.rag / repro.launch.serve, on the CPU.

For each non-dense arch's reduced config, both pipelines serve the conftest
graph (tests/test_torch_rag.py's setting) through ``DiverseVectorDB`` on
the reference's parameters (``models.model.from_host``). Retrieval is
exact: ids and certificates equal. Generation is held as
tests/test_torch_rag.py holds it: the port's decode under teacher forcing
of the reference's generated sequence within 4 bf16 ulps of the largest
|logit| of the reference's (compiled with every bf16 cast a rounding, as
tests/test_torch_families.py explains), and the port's own greedy tokens
equal to the reference's up to the first position whose top-2 margin is
within twice that. The reference's RAG never fills encdec's or vlm's cross
cache (src/repro/serve/rag.py), so both decode against zero cross k / v.

The launchers run in process, one arch of each family: the port's
``main([..., "--arch", name, "--device", "cpu"])`` must print the
reference launcher's retrieved ids and certificates.
"""
import contextlib
import functools
import io
import sys

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
from repro_torch import configs as tconfigs
from repro_torch import db as tdb
from repro_torch.core.graph import from_host
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serve import rag as trag

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b", "mamba2-370m",
         "recurrentgemma-9b", "whisper-small", "llama-3.2-vision-90b")
# one arch of each family for the launcher
FAMILY_ARCHS = ("moonshot-v1-16b-a3b", "mamba2-370m", "recurrentgemma-9b",
                "whisper-small", "llama-3.2-vision-90b")
K, EPS, EF, LANES, STEPS, LOGIT_ULPS = 4, 0.0, 4, 3, 6, 4
STRICT = {"xla_allow_excess_precision": False}


def bf16_tol(ref: np.ndarray) -> float:
    top = float(np.max(np.abs(ref)))
    return LOGIT_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.fixture(scope="module")
def graphs(clustered_data, small_graph):
    rng = np.random.default_rng(3)
    qs = (clustered_data[rng.integers(0, len(clustered_data), 5)]
          + 0.05 * rng.normal(size=(5, clustered_data.shape[1]))
          ).astype(np.float32)
    return small_graph, from_host(to_host(small_graph), device="cpu"), qs


@pytest.mark.parametrize("name", ARCHS)
def test_generate_matches_reference(graphs, name):
    jgraph, tgraph, qs = graphs
    cfg = jconfigs.get_config(name).reduced()
    tcfg = tconfigs.get_config(name).reduced()
    params = JM.init_params(cfg, jax.random.key(0))
    tparams = TM.from_host(tcfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    kw = dict(metric="l2", num_lanes=LANES, max_k=16, default_ef=EF,
              prewarm=False)
    jp = jrag.RagPipeline(cfg, params, db=jdb.DiverseVectorDB(
        index=jgraph, **kw), k=K, eps=EPS, ef=EF)
    tp = trag.RagPipeline(tcfg, tparams, db=tdb.DiverseVectorDB(
        index=tgraph, device="cpu", **kw), k=K, eps=EPS, ef=EF)
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (len(qs), 3)).astype(np.int32)
    jtok, jids, jcert = jp.generate(qs, prompts, steps=STEPS)
    ttok, tids, tcert = tp.generate(qs, prompts, steps=STEPS)
    np.testing.assert_array_equal(tids, np.asarray(jids))
    np.testing.assert_array_equal(tcert, np.asarray(jcert))
    assert (tids >= 0).all()
    assert ttok.shape == (len(qs), STEPS) and ttok.dtype == np.int32
    # teacher-forced decode along the reference's sequence
    seq = np.concatenate([np.asarray(jids) % cfg.vocab_size, prompts,
                          np.asarray(jtok)], axis=1).astype(np.int32)
    max_seq = seq.shape[1]
    jc = JM.init_cache(cfg, len(qs), max_seq)
    step = jax.jit(functools.partial(JM.decode_step, cfg)).lower(
        params, jc, jnp.asarray(seq[:, :1])).compile(compiler_options=STRICT)
    tc = TM.init_cache(tcfg, len(qs), max_seq, device="cpu")
    jl, tl = [], []
    for t in range(max_seq):
        lg, jc = step(params, jc, jnp.asarray(seq[:, t:t + 1]))
        jl.append(np.asarray(lg[:, 0]))
        lg, tc = TM.decode_step(tcfg, tparams, tc, seq[:, t:t + 1])
        tl.append(lg[:, 0].numpy())
    jl, tl = np.stack(jl, 1), np.stack(tl, 1)
    tol = bf16_tol(jl)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol)
    gen = slice(max_seq - STEPS - 1, max_seq - 1)
    top2 = np.sort(jl[:, gen], -1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 2 * tol
    np.testing.assert_array_equal(np.argmax(jl[:, gen], -1)[sure],
                                  np.asarray(jtok)[sure])
    prefix = np.cumprod(sure, axis=1).astype(bool)
    np.testing.assert_array_equal(ttok[prefix], np.asarray(jtok)[prefix])
    assert prefix[:, 0].any()
    print(f"{name}: tokens compared at {sure.mean():.3f} of the positions, "
          f"the free-running ones at {prefix.mean():.3f}")


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_launcher_prints_the_reference_ids(monkeypatch, name):
    argv = ["--corpus", "1000", "--requests", "4", "--arch", name]

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
