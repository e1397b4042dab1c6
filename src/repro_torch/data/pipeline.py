"""Deterministic, stateless synthetic-token pipeline.

Every batch is a pure function of (seed, step) — the property fault
tolerance needs: after a restart from step N the pipeline replays the
identical stream with no persisted iterator state.  Tokens follow a Zipfian
marginal with short-range Markov structure so cross-entropy training has
learnable signal (``repro_torch.examples.train_tinylm`` drives loss well
below the uniform entropy).

Host sharding: ``shard_for`` slices the global batch for a data-parallel
host, matching the (pod, data) mesh axes.

A textual copy of the JAX package's ``repro/data/pipeline.py`` (numpy
only): its batches are bit-equal to the reference's.
"""
from __future__ import annotations

import dataclasses

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
        # short-range Markov structure: with p=0.35 copy prev token + 1
        copy = rng.random((b, s + 1)) < 0.35
        toks = base.copy()
        for t in range(1, s + 1):
            toks[:, t] = np.where(copy[:, t], (toks[:, t - 1] + 1) % v,
                                  toks[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def shard_for(self, step: int, shard: int, num_shards: int) -> dict:
        assert self.global_batch % num_shards == 0
        per = self.global_batch // num_shards
        full = self.batch(step)
        sl = slice(shard * per, (shard + 1) * per)
        return {k: v[sl] for k, v in full.items()}


def batch_for_step(vocab: int, seq_len: int, global_batch: int, step: int,
                   seed: int = 1234) -> dict:
    return SyntheticLM(vocab, seq_len, global_batch, seed).batch(step)
