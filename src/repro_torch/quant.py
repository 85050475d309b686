"""Quantized corpora (port of ``repro.quant``): the block quantizer, int8
and PQ corpora, their builders, and the scoring arithmetic both the plain
versions and the CUDA kernels share.

* :class:`Int8Corpus` — symmetric int8 codes with one float32 scale per
  ``scale_rows`` consecutive rows: ``d + 4 / scale_rows`` bytes per vector.
* :class:`PQCorpus` — product quantization: ``M`` uint8 codebook indices per
  row, ``C <= 256`` centroids per subspace trained by seeded k-means.

Scoring semantics, as in the reference: int8 scores are exact int32 dots
(``kernels/int8_similarity.py``) fed through :func:`int8_postprocess`; PQ
scores are the lookup-table sum :func:`pq_lut_sum`, added subspace by
subspace from ``m = 0`` (``kernels/pq_lut_similarity.py``) and fed through
:func:`pq_postprocess`. The kernels compute only the exact integer or
gather-sum part, so a kernel and its plain version agree bit for bit.

Everything here takes optional leading lane axes where the reference takes
one query: :func:`prepare_query` of ``q[B, d]`` and :func:`score_rows` of
``idx[B, m]`` score every lane's own gathered rows at once.

uint8 codes are cast to ``long`` before any indexing: torch reads a uint8
index tensor as a boolean mask.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.similarity import sqrt_rn

_EPS = 1e-12          # norm guard, mirrors core.similarity._EPS

# --------------------------------------------------------------------------
# The flat block quantizer
# --------------------------------------------------------------------------

BLOCK = 2048


def quantize_blocks(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8: ``scale`` is the per-step size (amax/127);
    ``q = clip(round(x / scale), -127, 127)`` (round half to even)."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def block_view(flat: torch.Tensor):
    """Pad a flat vector to whole :data:`BLOCK`-sized rows.

    Returns ``(blocks[nb, BLOCK], n)`` with ``n`` the original length."""
    n = flat.shape[0]
    nb = -(-n // BLOCK)
    return torch.nn.functional.pad(flat, (0, nb * BLOCK - n)).reshape(
        nb, BLOCK), n


# --------------------------------------------------------------------------
# Corpus representations
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Int8Corpus:
    """Symmetric int8 corpus with one f32 scale per ``scale_rows`` rows:
    ``codes[i] = round(x[i] / scales[i // scale_rows])``."""
    codes: torch.Tensor    # int8[n, d]
    scales: torch.Tensor   # f32[nb], nb = ceil(n / scale_rows)
    scale_rows: int = 8

    @property
    def shape(self) -> tuple:
        return tuple(self.codes.shape)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def to(self, device) -> "Int8Corpus":
        return Int8Corpus(self.codes.to(device).contiguous(),
                          self.scales.to(device).contiguous(),
                          self.scale_rows)

    def row_scales(self) -> torch.Tensor:
        """Per-row step sizes f32[n] (the scale sidecar, expanded)."""
        n = self.codes.shape[0]
        return self.scales[torch.arange(n, device=self.device)
                           // self.scale_rows]

    def dequantize(self) -> torch.Tensor:
        """Reconstructed f32[n, d] corpus."""
        return self.codes.to(torch.float32) * self.row_scales()[:, None]

    def bytes_per_vector(self) -> float:
        n, d = self.codes.shape
        return (n * d * 1 + self.scales.shape[0] * 4) / n

    def code_bytes_per_vector(self) -> float:
        """Code payload only — exactly ``d`` bytes (4x smaller than f32)."""
        return float(self.codes.shape[1])


@dataclasses.dataclass(frozen=True)
class PQCorpus:
    """Product-quantized corpus: ``d`` split into ``M`` contiguous subspaces
    of ``d // M`` dims; each row stores its nearest centroid per subspace."""
    codes: torch.Tensor      # uint8[n, M]
    codebooks: torch.Tensor  # f32[M, C, d // M]

    @property
    def shape(self) -> tuple:
        m, _, ds = self.codebooks.shape
        return (int(self.codes.shape[0]), m * ds)

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def to(self, device) -> "PQCorpus":
        return PQCorpus(self.codes.to(device).contiguous(),
                        self.codebooks.to(device).contiguous())

    def dequantize(self) -> torch.Tensor:
        idx = self.codes.long()
        return torch.cat([self.codebooks[j, idx[:, j]]
                          for j in range(self.codebooks.shape[0])], dim=-1)

    def bytes_per_vector(self) -> float:
        n, m = self.codes.shape
        return (n * m * 1 + self.codebooks.numel() * 4) / n

    def code_bytes_per_vector(self) -> float:
        return float(self.codes.shape[1])


QUANT_SCHEMES = ("int8", "pq")


def is_quantized(corpus) -> bool:
    return isinstance(corpus, (Int8Corpus, PQCorpus))


def corpus_bytes_per_vector(corpus) -> float:
    """Stored bytes per vector: quantized corpora report their real payload
    (codes + amortized sidecars); a float tensor reports ``itemsize * d``."""
    if is_quantized(corpus):
        return float(corpus.bytes_per_vector())
    return float(corpus.element_size() * corpus.shape[-1])


def corpus_from_host(host: dict, device=None):
    """A corpus from numpy arrays on ``device`` (``cuda`` unless given):
    int8 from ``codes``/``scales``/``scale_rows``, PQ from
    ``codes``/``codebooks`` — the carrier a corpus of the reference package
    crosses over by."""
    device = resolve_device(device)
    codes = torch.as_tensor(np.array(host["codes"]), device=device)
    if "codebooks" in host:
        return PQCorpus(codes.to(torch.uint8).contiguous(),
                        torch.as_tensor(np.array(host["codebooks"],
                                                 np.float32),
                                        device=device).contiguous())
    return Int8Corpus(codes.to(torch.int8).contiguous(),
                      torch.as_tensor(np.array(host["scales"], np.float32),
                                      device=device).contiguous(),
                      int(host["scale_rows"]))


def corpus_to_host(corpus) -> dict:
    """The numpy dict :func:`corpus_from_host` reads."""
    if isinstance(corpus, PQCorpus):
        return dict(codes=corpus.codes.cpu().numpy(),
                    codebooks=corpus.codebooks.cpu().numpy())
    if isinstance(corpus, Int8Corpus):
        return dict(codes=corpus.codes.cpu().numpy(),
                    scales=corpus.scales.cpu().numpy(),
                    scale_rows=int(corpus.scale_rows))
    raise TypeError(f"not a quantized corpus: {type(corpus).__name__}")


# --------------------------------------------------------------------------
# Builders (on the corpus's device)
# --------------------------------------------------------------------------

def _as_f32(x, device=None) -> torch.Tensor:
    """``x`` as a float32 tensor: a tensor stays on its device unless
    ``device`` is given; an array goes to ``device`` (``cuda`` unless given)."""
    if isinstance(x, torch.Tensor):
        return x.to(device if device is not None else x.device,
                    torch.float32).contiguous()
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=resolve_device(device)).contiguous()


def quantize_int8(x, scale_rows: int = 8, device=None) -> Int8Corpus:
    """Quantize a corpus to :class:`Int8Corpus`: one shared scale per
    ``scale_rows`` consecutive rows (amax of the whole row block / 127)."""
    x = _as_f32(x, device)
    n, d = x.shape
    nb = -(-n // scale_rows)
    xb = torch.nn.functional.pad(x, (0, 0, 0, nb * scale_rows - n)).reshape(
        nb, scale_rows * d)
    amax = torch.amax(torch.abs(xb), dim=1)
    scales = torch.clamp(amax, min=_EPS) / 127.0
    codes = quantize_blocks(xb, scales[:, None]).reshape(nb * scale_rows, d)
    return Int8Corpus(codes=codes[:n].contiguous(), scales=scales,
                      scale_rows=int(scale_rows))


def _sq_dists(sub: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances f32[n, C], composed as the reference composes
    them: ``|s|^2 - 2 s.c + |c|^2``."""
    return (torch.sum(sub * sub, dim=1)[:, None] - 2.0 * (sub @ cb.T)
            + torch.sum(cb * cb, dim=1)[None, :])


def _kmeans(sub: torch.Tensor, c: int, iters: int,
            rng: np.random.Generator) -> torch.Tensor:
    """Seeded k-means (squared L2) for one PQ subspace, on ``sub``'s device.

    The initial centroids come from ``rng`` in the reference's call order;
    ``argmin`` keeps the first of tied centroids and an empty cluster keeps
    its centroid, as the reference does. Cluster sums are taken in float64
    and rounded once, where the reference adds float32 rows in turn, so a
    centroid can differ from the reference's in its last bits and a
    near-tied assignment can then flip."""
    n, ds = sub.shape
    init = torch.as_tensor(rng.choice(n, size=c, replace=False),
                           device=sub.device)
    cb = sub[init].clone()
    sub64 = sub.to(torch.float64)
    for _ in range(iters):
        assign = torch.argmin(_sq_dists(sub, cb), dim=1)
        sums = torch.zeros((c, ds), dtype=torch.float64,
                           device=sub.device).index_add_(0, assign, sub64)
        counts = torch.bincount(assign, minlength=c)
        mean = sums.to(torch.float32) / counts.clamp(min=1).to(
            torch.float32)[:, None]
        cb = torch.where((counts > 0)[:, None], mean, cb)
    return cb


def pq_encode(x, codebooks: torch.Tensor, block: int = 1 << 18) -> torch.Tensor:
    """Nearest-centroid codes uint8[n, M] for ``x`` under ``codebooks``, on
    the codebooks' device, ``block`` rows at a time."""
    x = _as_f32(x, codebooks.device)
    m, _, ds = codebooks.shape
    codes = torch.empty((x.shape[0], m), dtype=torch.uint8, device=x.device)
    for s in range(0, x.shape[0], block):
        for j in range(m):
            sub = x[s:s + block, j * ds:(j + 1) * ds]
            codes[s:s + block, j] = torch.argmin(
                _sq_dists(sub, codebooks[j]), dim=1).to(torch.uint8)
    return codes


def default_pq_m(d: int, max_m: int = 16) -> int:
    """Default PQ subspace count: the largest ``m <= max_m`` that splits
    ``d`` evenly with subspace width ``>= 2`` (``1`` when ``d < 4``)."""
    for m in range(min(int(max_m), d // 2), 1, -1):
        if d % m == 0:
            return m
    return 1


def train_pq(x, m: int = 8, codes: int = 256, iters: int = 10,
             seed: int = 0, sample: int = 16384, device=None) -> PQCorpus:
    """Train per-subspace codebooks (seeded k-means on a sample) and encode.

    The sample and the initial centroids come from
    ``np.random.default_rng(seed)`` in the reference's order; the Lloyd
    steps and the encoding run in torch on the corpus's device."""
    x = _as_f32(x, device)
    n, d = x.shape
    if d % m:
        raise ValueError(f"d={d} does not split into m={m} subspaces")
    if codes > 256:
        raise ValueError(f"codes={codes} > 256 would not fit uint8")
    c = min(int(codes), n)
    rng = np.random.default_rng(seed)
    fit = x[torch.as_tensor(rng.choice(n, size=min(int(sample), n),
                                       replace=False), device=x.device)]
    ds = d // m
    cbs = torch.stack([_kmeans(fit[:, j * ds:(j + 1) * ds].contiguous(), c,
                               int(iters), rng) for j in range(m)])
    return PQCorpus(codes=pq_encode(x, cbs), codebooks=cbs.contiguous())


def quantize_corpus(x, scheme: str, *, scale_rows: int = 8,
                    pq_m: int | None = None, pq_codes: int = 256,
                    pq_iters: int = 10, pq_sample: int = 16384,
                    seed: int = 0, device=None):
    """Build the quantized corpus for ``scheme`` in :data:`QUANT_SCHEMES`.

    ``pq_m=None`` picks :func:`default_pq_m` for the corpus width. A tensor
    corpus is quantized on its own device, an array on ``device``."""
    if scheme == "int8":
        return quantize_int8(x, scale_rows=scale_rows, device=device)
    if scheme == "pq":
        m = pq_m if pq_m is not None else default_pq_m(x.shape[-1])
        return train_pq(x, m=m, codes=pq_codes, iters=pq_iters, seed=seed,
                        sample=pq_sample, device=device)
    raise ValueError(
        f"unknown quantization scheme {scheme!r}; expected {QUANT_SCHEMES}")


# --------------------------------------------------------------------------
# Shared scoring arithmetic (the plain versions' AND the kernels')
# --------------------------------------------------------------------------

#: float32(1 / 127): the reference quantizes queries only under ``jit``,
#: where XLA rewrites ``amax / 127.0`` as ``amax * float32(1 / 127)``
_INV127 = float(np.float32(1.0 / 127.0))


def quantize_queries(qs: torch.Tensor):
    """Per-row symmetric int8 query codes: ``(codes int8[..., d], scales
    f32[...])`` with ``scale = max(amax, eps) * float32(1/127)`` per row,
    the reference's scale as it runs (under ``jit``), so query codes and
    int8 scores agree with it bit for bit."""
    qs = qs.to(torch.float32)
    scales = torch.clamp(torch.amax(torch.abs(qs), dim=-1),
                         min=_EPS) * _INV127
    return quantize_blocks(qs, scales[..., None]), scales


def int8_postprocess(dots, qsq, xsq, q_scale, x_scale, metric: str):
    """Dequantize int32 dot/norm accumulators and apply the metric
    transform. Shapes broadcast. Each operation rounds on its own (no fused
    multiply-add), on the CPU and the card alike."""
    s = q_scale * x_scale
    dots_f = dots.to(torch.float32) * s
    if metric == "ip":
        return dots_f
    q2 = qsq.to(torch.float32) * (q_scale * q_scale)
    x2 = xsq.to(torch.float32) * (x_scale * x_scale)
    if metric == "cos":
        qn = sqrt_rn(torch.clamp(q2, min=_EPS))
        xn = sqrt_rn(torch.clamp(x2, min=_EPS))
        return dots_f / (qn * xn)
    if metric == "l2":
        d2 = torch.clamp(q2 + x2 - 2.0 * dots_f, min=0.0)
        return 1.0 - sqrt_rn(d2)
    raise ValueError(f"unknown metric {metric!r}")


def _sq_norms_i32(codes: torch.Tensor) -> torch.Tensor:
    c = codes.to(torch.int32)
    return torch.sum(c * c, dim=-1, dtype=torch.int32)


def int8_score_from_dots(dots, q_codes, q_scales, corpus: Int8Corpus,
                         metric: str):
    """Batched int8 scores f32[b, n] from exact integer dots int32[b, n].

    Recomputes the corpus rows' squared code norms on every call, as the
    reference does."""
    qsq = _sq_norms_i32(q_codes)[:, None]
    xsq = _sq_norms_i32(corpus.codes)[None, :]
    return int8_postprocess(dots, qsq, xsq, q_scales[:, None],
                            corpus.row_scales()[None, :], metric)


def _sub_dots(qsub: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """dots[b, m, c] = sum_s qsub[b, m, s] * codebooks[m, c, s], added from
    s = 0 in turn: the same bits for any batch size and on any device."""
    acc = qsub[:, :, None, 0] * codebooks[None, :, :, 0]
    for s in range(1, qsub.shape[-1]):
        acc = acc + qsub[:, :, None, s] * codebooks[None, :, :, s]
    return acc


def _sq_sum_seq(a: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of a * a, added from index 0 in turn."""
    acc = a[..., 0] * a[..., 0]
    for s in range(1, a.shape[-1]):
        acc = acc + a[..., s] * a[..., s]
    return acc


def pq_luts_many(qs: torch.Tensor, codebooks: torch.Tensor, metric: str):
    """Per-subspace ADC lookup tables for a query batch qs[b, d].

    Returns ``(T f32[b, M, C], S f32[M, C], qn f32[b])``: the score is a
    transform of ``sum_m T[b, m, code]`` (squared distances for l2, dots
    for ip/cos), ``S`` the centroid squared norms cos needs, ``qn`` the
    float query norms. Each sum over a subspace is taken in one fixed
    order, so T is batch-invariant; it may differ from the reference's
    (an XLA contraction) in the last bit."""
    qs = qs.to(torch.float32)
    m, _, ds = codebooks.shape
    qsub = qs.reshape(qs.shape[0], m, ds)
    dots = _sub_dots(qsub, codebooks)
    csq = _sq_sum_seq(codebooks)                          # [M, C]
    if metric == "l2":
        qsq = _sq_sum_seq(qsub)                           # [b, M]
        T = qsq[:, :, None] - 2.0 * dots + csq[None]
    elif metric in ("ip", "cos"):
        T = dots
    else:
        raise ValueError(f"unknown metric {metric!r}")
    qn = sqrt_rn(torch.clamp(_sq_sum_seq(qs), min=_EPS))
    return T, csq, qn


def pq_lut_sum(T: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``sum_m T[..., m, codes[..., r, m]]`` -> f32[..., r], added subspace
    by subspace from ``m = 0`` (the kernel's order, and the reference's).

    ``T`` [..., M, C]; ``codes`` [..., r, M] (uint8 or int), whose leading
    axes broadcast against T's: one code table shared by every query, or
    each lane's own gathered rows."""
    idx = codes.long()                       # a uint8 index is a mask
    lead = torch.broadcast_shapes(T.shape[:-2], idx.shape[:-2])
    out = None
    for j in range(T.shape[-2]):
        v = torch.gather(T[..., j, :].expand(*lead, T.shape[-1]), -1,
                         idx[..., j].expand(*lead, idx.shape[-2]))
        out = v if out is None else out + v
    return out


def pq_postprocess(sumT, sumS, qn, metric: str):
    """Metric transform over the LUT sums (shared by oracle and kernel).
    Only cos reads ``sumS``, the sums of the centroid norms; the other
    metrics take None there."""
    if metric == "ip":
        return sumT
    if metric == "l2":
        return 1.0 - sqrt_rn(torch.clamp(sumT, min=0.0))
    if metric == "cos":
        xn = sqrt_rn(torch.clamp(sumS, min=_EPS))
        return sumT / (qn * xn)
    raise ValueError(f"unknown metric {metric!r}")


# --------------------------------------------------------------------------
# Per-search query views (the beam loop's compressed block scoring)
# --------------------------------------------------------------------------

class Int8Query(NamedTuple):
    """Queries pre-quantized for int8 block scoring."""
    codes: torch.Tensor   # int8[..., d]
    scale: torch.Tensor   # f32[...]


class PQQuery(NamedTuple):
    """Queries' ADC tables for PQ block scoring."""
    luts: torch.Tensor     # f32[..., M, C]
    sq_luts: torch.Tensor  # f32[M, C] centroid squared norms
    qnorm: torch.Tensor    # f32[...]


def prepare_query(corpus, q: torch.Tensor, metric: str):
    """The per-search query view for ``corpus`` of q[d] or q[B, d].

    Float corpora return ``q`` unchanged; quantized corpora return the small
    view the block scorer reads, computed once per search."""
    if isinstance(corpus, Int8Corpus):
        codes, scales = quantize_queries(q)
        return Int8Query(codes=codes, scale=scales)
    if isinstance(corpus, PQCorpus):
        lead = q.shape[:-1]
        T, S, qn = pq_luts_many(q.reshape(-1, q.shape[-1]), corpus.codebooks,
                                metric)
        return PQQuery(luts=T.reshape(*lead, *T.shape[1:]), sq_luts=S,
                       qnorm=qn.reshape(lead))
    return q


def score_rows(prep, corpus, idx: torch.Tensor, metric: str) -> torch.Tensor:
    """Score the gathered compressed rows ``corpus[idx]`` against ``prep``.

    ``idx`` int[..., m] (non-negative), its leading axes those of ``prep``.
    Uses the batched op's arithmetic on the same integers and LUT entries;
    values agree with ``kernels.ops.quantized_similarity_many`` to float32
    rounding."""
    idx = idx.long()
    if isinstance(corpus, Int8Corpus):
        rows = corpus.codes[idx].to(torch.int32)              # (..., m, d)
        rsc = corpus.scales[idx // corpus.scale_rows]         # (..., m)
        qc = prep.codes.to(torch.int32)
        dots = torch.sum(rows * qc[..., None, :], dim=-1, dtype=torch.int32)
        return int8_postprocess(dots, _sq_norms_i32(qc)[..., None],
                                _sq_norms_i32(rows), prep.scale[..., None],
                                rsc, metric)
    if isinstance(corpus, PQCorpus):
        codes = corpus.codes[idx]                             # (..., m, M)
        sumT = pq_lut_sum(prep.luts, codes)
        sumS = (pq_lut_sum(prep.sq_luts, codes) if metric == "cos"
                else None)
        return pq_postprocess(sumT, sumS, prep.qnorm[..., None], metric)
    raise TypeError(f"score_rows needs a quantized corpus, got {type(corpus)}")
