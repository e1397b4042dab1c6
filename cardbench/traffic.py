"""The traffic generator and the percentile, frozen with the benchmark.

``SyntheticLM`` is a copy of the port's ``data/pipeline.py`` stream: a
Zipfian marginal with short-range Markov structure (with p = 0.35 a token
is the previous one + 1), every batch a pure function of (seed, step).
``percentile`` is the nearest-rank percentile of the port's
``sim/stats.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def batch(self, step: int) -> dict:
        """Global batch for ``step``: tokens/labels [B, S] int32."""
        rng = self._rng(step)
        b, s, v = self.global_batch, self.seq_len, self.vocab
        ranks = rng.zipf(self.zipf_a, size=(b, s + 1)).astype(np.int64)
        base = (ranks - 1) % v
        copy = rng.random((b, s + 1)) < 0.35
        toks = base.copy()
        for t in range(1, s + 1):
            toks[:, t] = np.where(copy[:, t], (toks[:, t - 1] + 1) % v,
                                  toks[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def percentile(values: List[float], p: float) -> float:
    """Nearest-rank percentile; ``p`` in [0, 100]."""
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile p={p!r} out of range [0, 100]")
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    k = max(0, min(len(s) - 1, math.ceil(p / 100.0 * len(s)) - 1))
    return s[k]
