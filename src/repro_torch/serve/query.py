"""The one per-request parameter object: a frozen ``Query`` (port of
``repro.serve.query``).

Before this module, per-request knobs drifted across three kwarg lists
(``LaneScheduler.submit``, ``RagPipeline.retrieve``, ``launch/serve.py``),
and every new knob (tenant, SLO, method) had to be threaded through each.
``Query`` consolidates them: one frozen dataclass carried from the public
``DiverseVectorDB.search`` front door down to the scheduler's admission
queue. The backend-facing ``core.backend.LaneRequest`` and the scheduler's
``Request`` stay *internal* — callers construct ``Query``, never those.

``text_or_embedding`` is either the query embedding (anything
``np.asarray`` accepts) or raw text; text is resolved by the owner of an
embedder (``DiverseVectorDB(embed=...)``) — layers without one refuse it
rather than guess.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class Query:
    """One diverse-search request (the paper's Definition 1: the query owns
    its diversification level — ``k``/``eps`` ride the request, never an
    index rebuild).

    * ``text_or_embedding`` — query embedding, or raw text for callers
      constructed with an embedder.
    * ``k`` / ``eps`` — result size and the diversity threshold.
    * ``method`` — backend search method (``None`` = the backend's native
      default, e.g. ``"pss"`` single-host / ``"sharded"`` on a mesh).
    * ``tenant`` — fairness/accounting label for the admission policies.
    * ``slo`` — optional latency budget in seconds; admission policies and
      shed callbacks may read it (``None`` = best effort).
    * ``ef`` / ``max_K`` — optional expansion-factor and candidate-budget
      overrides (backend defaults when ``None``).
    """
    text_or_embedding: Any
    k: int = 10
    eps: float = 0.0
    method: str | None = None
    tenant: str = "default"
    slo: float | None = None
    ef: int | None = None
    max_K: int | None = None

    @property
    def is_text(self) -> bool:
        return isinstance(self.text_or_embedding, str)

    def embedding(self, embed=None) -> np.ndarray:
        """The query as a float32 embedding vector.

        Text queries need ``embed`` (a ``str -> vector`` callable); an
        embedding passes through unchanged. Raises ``TypeError`` for text
        without an embedder — resolving text is the *caller's* capability,
        not something lower layers guess at.
        """
        if self.is_text:
            if embed is None:
                raise TypeError(
                    "text query needs an embedder — construct "
                    "DiverseVectorDB(embed=...) or pass an embedding")
            return np.asarray(embed(self.text_or_embedding), np.float32)
        return np.asarray(self.text_or_embedding, np.float32)

    def resolve(self, embed=None) -> "Query":
        """A copy whose ``text_or_embedding`` is the resolved embedding."""
        if not self.is_text:
            return self
        return dataclasses.replace(
            self, text_or_embedding=self.embedding(embed))
