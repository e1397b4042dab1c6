"""In-flash exact-match search on Hopper (IFP match line, paper §7).

Search-in-Memory / TCAM-SSD style search: a query record is compared with
every stored record of a page by XNOR(query, word) and an all-bits AND of
the record's words — both MWS primitives.  ``stack[rows, words]`` int32
holds records of ``wpr`` consecutive words; the result is the bool match
bitmap ``[rows, words / wpr]``.

Replaces the Pallas kernel ``repro/kernels/search.py`` ``_search_kernel``
with the CUDA kernel ``search_kernel`` of ``csrc/ndp.cu``: one thread per
record ANDs the XNOR of each of its words with the query onto a match line
held in a register and writes one byte.  The TPU kernel tiles 8 rows at a
time; here there is no tile, so any row count passes unpadded.  Bound on an
H100: bytes, 4 * wpr read and 1 written per record (PERF.md).

``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0


def search_pages(stack: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Bool ``[rows, words // wpr]``: record r of row p matches iff all of
    its ``wpr = len(query)`` words equal the query's."""
    global LAUNCHES
    _build.check_operands("search_pages", (torch.int32,), stack, query)
    if stack.ndim != 2 or query.ndim != 1:
        raise ValueError(f"search_pages: expected [rows, words] and [wpr], "
                         f"got {tuple(stack.shape)} and {tuple(query.shape)}")
    rows, words = stack.shape
    wpr = query.shape[0]
    if wpr < 1 or words % wpr:
        raise ValueError(f"search_pages: {words} words per row do not hold "
                         f"records of {wpr} words")
    out = torch.empty((rows, words // wpr), dtype=torch.bool,
                      device=stack.device)
    _build.call("ndp_search_i32", stack.data_ptr(), query.data_ptr(),
                out.data_ptr(), out.numel(), wpr,
                torch.cuda.current_stream(stack.device).cuda_stream)
    LAUNCHES += 1
    return out
