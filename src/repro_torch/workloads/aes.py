"""AES-256 encryption workload (§5.4 workload 1).

Structure: counter-mode (CTR) encryption is embarrassingly parallel and
auto-vectorizes (bitsliced round function: AddRoundKey XOR, a bitsliced
SubBytes fragment built from AND/XOR/NOT/shifts, ShiftRows/MixColumns as
shift+XOR "xtime" chains).  A fraction of blocks is encrypted in *CBC* mode
— an inherently sequential chain the auto-vectorizer cannot handle (§7),
emitted as a non-vectorizable control region — and the S-box for a slice of
the state uses a table lookup (gather), which only the ISP cores support.

Table 3 targets: 65% vectorizable, reuse 15.2, 87% low / 13% medium / 0% high.
The 14 encryption rounds re-read the state and round keys (reuse ~15),
and the round function is almost entirely bitwise (low latency).

Written so that each op is captured as the ATen counterpart of the JAX
package's primitive: the CBC body is functional (``index_select`` /
``index_copy``: ``while_loop`` bodies may not index with a traced scalar
or write in place), its counter is int64 because ``index_copy`` takes no
other index type, and the checksum sums in int32 as ``jnp.sum`` does.
"""
from __future__ import annotations

import numpy as np
import torch
from torch._higher_order_ops.while_loop import while_loop

SCALES = {
    # elements (INT8 lanes); one logical page = 4096 lanes
    "tiny": dict(n=8 * 4096, cbc_blocks=2, rounds=6),
    "paper": dict(n=96 * 4096, cbc_blocks=8, rounds=14),
}


def _round(state, rk, sbox):
    state = state ^ rk                                    # AddRoundKey (broadcast)
    # bitsliced SubBytes fragment (affine + inversion approximation)
    r1 = (state << 1) ^ (state >> 7)
    r2 = state & r1
    r3 = ~state
    state = r2 ^ r3 ^ (r1 | state)
    # ShiftRows + MixColumns: xtime chains
    xt = (state << 1) ^ ((state >> 31) & 27)
    state = xt ^ r1
    return state


def _cbc_chain(blocks, rk0):
    """Sequential CBC chaining over pages — non-vectorizable (§7)."""
    n = blocks.shape[0]

    def cond(i, prev, out):
        return i < n

    def body(i, prev, out):
        x = out.index_select(0, i.reshape(1))[0] ^ prev
        x = x ^ rk0.index_select(0, (i % rk0.shape[0]).reshape(1))[0]
        out = out.index_copy(0, i.reshape(1), x[None])
        return i + 1, x, out

    zero = torch.tensor(0, device=blocks.device)
    _, _, out = while_loop(cond, body, (zero, blocks[0], blocks))
    return out


def make_fn(scale: str = "paper"):
    p = SCALES[scale]
    rounds = p["rounds"]

    def aes(state, round_keys, sbox_table, cbc_blocks, checksum_seed):
        # CTR-mode parallel encryption (vectorizable)
        for r in range(rounds):
            state = _round(state, round_keys[r], sbox_table)
        # table-lookup S-box pass on a slice (gather; ISP-class)
        idx = state[: state.shape[0] // 8] & 255
        subbed = sbox_table[idx]
        # integrity checksum (medium-latency add/cmp mix)
        csum = (state + checksum_seed)
        flags = csum > 0
        csum = torch.where(flags, csum, -csum)
        # CBC region (sequential; control fallback)
        cbc = _cbc_chain(cbc_blocks, round_keys)
        return state, subbed, csum.sum(dtype=torch.int32), cbc

    return aes


def make_inputs(scale: str = "paper", seed: int = 0,
                device: torch.device | str = "cuda"):
    p = SCALES[scale]
    rng = np.random.default_rng(seed)
    n = p["n"]
    draws = (rng.integers(0, 2**31, size=(n // 4096, 4096), dtype=np.int32),
             rng.integers(0, 2**31, size=(p["rounds"], 4096), dtype=np.int32),
             rng.integers(0, 256, size=(256,), dtype=np.int32),
             rng.integers(0, 2**31, size=(p["cbc_blocks"], 4096),
                          dtype=np.int32),
             rng.integers(0, 127, size=(n // 4096, 4096), dtype=np.int32))
    return tuple(torch.from_numpy(x).to(device) for x in draws)


# simulator pressure knobs: AES has high reuse -> modest DRAM suffices
SIM = dict(dram_frac=0.6, host_frac=0.6)
META = dict(paper_vect=65, paper_reuse=15.2, paper_low=87, paper_med=13,
            paper_high=0, kind="io_intensive")
