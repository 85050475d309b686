"""repro_torch.core.similarity against repro.core.similarity, and the
port's import boundary (no jax, no repro)."""
import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import similarity as jsim
from repro_torch.core import similarity as tsim

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

RTOL = ATOL = 1e-5
# the reference engine runs query_sim under jit, where XLA fuses the
# multiply into the reduce; eager jnp would round the products first
_jit_query_sim = jax.jit(jsim.query_sim, static_argnames=("metric",))


def _data(seed=0, n=50, d=24):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, d)) * 2).astype(np.float32),
            (rng.normal(size=(4, d)) * 2).astype(np.float32))


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_query_sim_matches_reference(metric):
    x, qs = _data()
    for q in qs:
        ref = np.asarray(_jit_query_sim(jnp.asarray(q), jnp.asarray(x), metric))
        got = tsim.query_sim(torch.from_numpy(q), torch.from_numpy(x),
                             metric).numpy()
        # same reduction order as XLA's CPU reduce (sequential FMA over d):
        # the dots agree bitwise, the metric transform to a rounding step
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        if metric == "ip":
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_pairwise_sim_and_sim_one_match_reference(metric):
    x, qs = _data(1)
    ref = np.asarray(jsim.pairwise_sim(jnp.asarray(qs), jnp.asarray(x), metric))
    got = tsim.pairwise_sim(torch.from_numpy(qs), torch.from_numpy(x),
                            metric).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    one_ref = float(jsim.sim_one(jnp.asarray(qs[0]), jnp.asarray(x[3]), metric))
    one = float(tsim.sim_one(torch.from_numpy(qs[0]), torch.from_numpy(x[3]),
                             metric))
    assert one == pytest.approx(one_ref, rel=RTOL, abs=ATOL)


def test_query_sim_is_batch_invariant():
    """A lane's scores are bitwise the same alone and inside a batch."""
    x, qs = _data(2)
    xt, qt = torch.from_numpy(x), torch.from_numpy(qs)
    batched = tsim.query_sim(qt[:, None, :], xt[None], "l2")
    for i in range(len(qs)):
        assert torch.equal(batched[i], tsim.query_sim(qt[i], xt, "l2"))
        assert torch.equal(batched[i, :7], tsim.query_sim(qt[i], xt[:7], "l2"))


def test_unknown_metric_raises():
    x, qs = _data()
    with pytest.raises(ValueError):
        tsim.query_sim(torch.from_numpy(qs[0]), torch.from_numpy(x), "hamming")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core.batch_progressive\n"
        "import repro_torch.index.flat, repro_torch.kernels.ops\n"
        "import repro_torch.core.div_astar, repro_torch.core.theorems\n"
        "import repro_torch.quant, repro_torch.core.batch\n"
        "import repro_torch.kernels.int8_similarity\n"
        "import repro_torch.kernels.pq_lut_similarity\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    # run from src/, so the package imports whatever PYTHONPATH says
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=src)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_and_chip_smoke_never_import_jax_or_repro():
    """Every import statement, at any depth, of the port and of
    chip_smoke.py, which the card runs without JAX installed."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{f.relative_to(root)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 20 and not bad, bad
