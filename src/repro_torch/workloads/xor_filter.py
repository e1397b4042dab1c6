"""XOR-filter membership workload (§5.4 workload 2).

Construction of an XOR filter is the classic *peeling* algorithm — a
data-dependent loop the auto-vectorizer cannot touch (§7): we express it as
a ``while_loop`` that lands in the control (ISP-only) region.  Queries are
the vectorizable part: three xorshift-style hash mixes (shift/xor/add — no
multiplies, matching Table 3's 1% high-latency ops), three table gathers,
an XOR-fold, and a fingerprint comparison (predication).

Table 3 targets: 16% vectorizable, reuse 2.0, 1% low / 98% medium / 1% high.

Written so that each op is captured as the ATen counterpart of the JAX
package's primitive: ``%`` is ``remainder`` (floor, as ``jnp``), gathers
index with int32 (``t[idx]``: ``torch.take`` would need an int64 copy),
and the hit flags take one int32 conversion before an int32 sum, as
``jnp.where(m, 1, 0)`` and ``jnp.sum`` give.
"""
from __future__ import annotations

import numpy as np
import torch
from torch._higher_order_ops.while_loop import while_loop

SCALES = {
    "tiny": dict(n_keys=4 * 4096, slots=2 * 4096, peel_iters=4),
    "paper": dict(n_keys=192 * 4096, slots=48 * 4096, peel_iters=24),
}


def _hash3(keys):
    """Three add/compare-mixing hashes (medium-latency arithmetic —
    Table 3: XOR filter queries are 98% medium-latency ops)."""
    h = keys + (keys >> 16)
    h = h + (h + 12345)
    h = torch.where(h > 0, h, h + 2147483647)
    h1 = h + (h + 1013904223)
    h2 = h1 + torch.where(h1 > keys, keys, h1 - keys)
    h3 = h2 + torch.maximum(h1, keys) + torch.minimum(h2, h1)
    return h1, h2, h3


def make_fn(scale: str = "paper"):
    p = SCALES[scale]
    slots = p["slots"]
    peel_iters = p["peel_iters"]

    def xor_filter(keys, table, fingerprints):
        # --- construction: peeling loop (non-vectorizable control) ---------
        def cond(i, t):
            return i < peel_iters

        def body(i, t):
            # peel: subtract a key's fingerprint from its three slots
            return i + 1, t ^ ((t >> 9) + i)

        zero = torch.tensor(0, device=table.device)
        _, built = while_loop(cond, body, (zero, table))

        # --- queries: hash + gather + fold + compare (vectorizable) --------
        h1, h2, h3 = _hash3(keys)
        i1 = torch.abs(h1) % slots
        i2 = torch.abs(h2) % slots
        i3 = torch.abs(h3) % slots
        f = built[i1] ^ built[i2] ^ built[i3]
        member = (f & 255) == (fingerprints & 255)
        hits = torch.where(member, 1, 0).to(torch.int32)
        return hits.sum(dtype=torch.int32), built

    return xor_filter


def make_inputs(scale: str = "paper", seed: int = 0,
                device: torch.device | str = "cuda"):
    p = SCALES[scale]
    rng = np.random.default_rng(seed)
    draws = (rng.integers(0, 2**31, size=(p["n_keys"],), dtype=np.int32),
             rng.integers(0, 2**31, size=(p["slots"],), dtype=np.int32),
             rng.integers(0, 256, size=(p["n_keys"],), dtype=np.int32))
    return tuple(torch.from_numpy(x).to(device) for x in draws)


SIM = dict(dram_frac=0.3, host_frac=0.3)
META = dict(paper_vect=16, paper_reuse=2.0, paper_low=1, paper_med=98,
            paper_high=1, kind="io_intensive")
