"""The dense, Mamba2 and shared-block family: the parameter tree of
``weights.layout`` and the counts of ``counts``, for every configuration
that names no ``layout``.  A family of its own is a module beside this one
with the same three functions; a family whose attention does not go
through K6 has ``k6_calls_per_prefill`` return 0."""
from cardbench.counts import k6_calls_per_prefill, prefill_flops
from cardbench.weights import layout

__all__ = ["layout", "prefill_flops", "k6_calls_per_prefill"]
