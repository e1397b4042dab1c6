"""Random weights from ``--seed``, made on the device into the port's
parameter tree (``{"emb", "ln_f", ["unemb"], "layers": [one dict per
entry of the pattern], ["shared_attn"]}``, a shared block's entry of
``layers`` empty), and the zero AdamW moments beside them.

Every random leaf is a view of one normal draw in the working type from a
``torch.Generator`` seeded with the seed, in the tree's order, scaled in
place: 1/sqrt(fan-in) for a projection (its input width ``shape[-2]``, so
a stacked ``[E, d_in, d_out]`` leaf takes 1/sqrt(d_in)), 0.02 for the
embedding, 0.01 for Mamba2's Δ projection and 0.1 for its convolution;
norm gains are ones, Mamba2's skip ones and its ``a_log`` fp32 zeros
(A = -1).  A configuration's ``init`` may scale a projection's
1/sqrt(fan-in) by a factor, by block kind and leaf name
(``{"mamba.w_bc": 0.25}``); its ``departures`` say why.

:func:`layout` is the tree of the dense, Mamba2 and shared-block family
(``layouts/lm.py``); a configuration with a ``layout`` key has its tree
drawn from its own module's.  The same seed gives the same tensors, so the
reference is handed them again after the window by calling :func:`make`
once more.
"""
from __future__ import annotations

import math
from types import ModuleType
from typing import Any, Iterator, List, Optional, Tuple

import torch

from cardbench import counts

Tree = Any


def _attention_block(arch: dict) -> dict:
    d, dh, ff = arch["d_model"], counts.head_dim(arch), arch["d_ff"]
    h, hkv = arch["n_heads"], arch["n_kv_heads"]
    return {"ln1": ("ones", (d,)),
            "attn": {"wq": ("fan_in", (d, h * dh)),
                     "wk": ("fan_in", (d, hkv * dh)),
                     "wv": ("fan_in", (d, hkv * dh)),
                     "wo": ("fan_in", (h * dh, d))},
            "ln2": ("ones", (d,)),
            "mlp": {"w1": ("fan_in", (d, ff)), "w3": ("fan_in", (d, ff)),
                    "w2": ("fan_in", (ff, d))}}


def _mamba_block(arch: dict) -> dict:
    d = arch["d_model"]
    di = arch["ssm_expand"] * d
    n = arch["ssm_state"]
    return {"w_in": ("fan_in", (d, 2 * di)),
            "w_bc": ("fan_in", (d, 2 * n)),
            "w_dt": (0.01, (d, di)),
            "conv_w": (0.1, (arch["conv_kernel"], di)),
            "a_log": ("zeros_fp32", (di,)), "d_skip": ("ones", (di,)),
            "w_out": ("fan_in", (di, d)), "norm": ("ones", (d,))}


def _scaled(block: dict, kind: str, init: dict) -> dict:
    """``block`` with the fan-in factors ``init`` gives for ``kind``."""
    for key, factor in init.items():
        k, leaf = key.split(".")
        if k == kind:
            block[leaf] = (("fan_in", factor), block[leaf][1])
    return block


def layout(arch: dict, init: Optional[dict] = None) -> dict:
    """The tree of ``(init, shape)`` pairs the port's parameters take."""
    d, v = arch["d_model"], arch["vocab"]
    blocks = {"attn": _attention_block, "mamba": _mamba_block,
              "sattn": lambda _: {}}
    tree = {"emb": (0.02, (v, d)), "ln_f": ("ones", (d,))}
    if not arch["tie_embeddings"]:
        tree["unemb"] = ("fan_in", (d, v))
    tree["layers"] = [_scaled(blocks[kind](arch), kind, init or {})
                      for kind in counts.pattern(arch)]
    if arch.get("shared_attn_every"):
        tree["shared_attn"] = _scaled(_attention_block(arch), "sattn",
                                      init or {})
    return tree


_lm_layout = layout   # ``make``'s argument ``layout`` shadows the name


def items(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` in the tree's order (dicts in insertion order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from items(v, f"{prefix}{k}" if not prefix
                             else f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from items(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in items(tree)]


def tree_map(fn, tree: Tree) -> Tree:
    """``fn`` over every leaf (anything not a dict or list)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def make(arch: dict, seed: int, device: torch.device | str,
         init: Optional[dict] = None,
         layout: Optional[ModuleType] = None) -> Tree:
    """The parameters of ``arch`` from ``seed`` on ``device``, with the
    fan-in factors of a configuration's ``init``, in the tree of the
    ``layout`` module (:func:`cardbench.spec.layout`; ``lm``'s without
    one)."""
    dtype = getattr(torch, arch["dtype"])
    spec = (layout.layout if layout is not None else _lm_layout)(arch, init)
    random = [leaf for leaf in leaves(spec)
              if leaf[0] not in ("ones", "zeros_fp32")]
    total = sum(math.prod(shape) for _, shape in random)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn((total,), generator=gen, dtype=dtype, device=device)
    offset = [0]

    def build(leaf):
        init, shape = leaf
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init == "zeros_fp32":
            return torch.zeros(shape, dtype=torch.float32, device=device)
        n = math.prod(shape)
        w = flat[offset[0]:offset[0] + n].view(shape)
        offset[0] += n
        if init == "fan_in":
            init = ("fan_in", 1.0)
        scale = (init[1] / math.sqrt(shape[-2]) if isinstance(init, tuple)
                 else init)
        return w.mul_(scale)

    return tree_map(build, spec)

