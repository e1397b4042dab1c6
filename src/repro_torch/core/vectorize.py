"""Compile-time preprocessing (§4.3.1): programmer-transparent vectorization.

The paper runs a custom LLVM pass (``-force-vector-width=4096
-force-vector-interleave=1``) that turns loops into page-aligned SIMD
operations and embeds metadata in the IR.  Here the IR is the **ATen
graph**: the user writes ordinary PyTorch code; :func:`vectorize` captures
it with ``make_fx``, walks the nodes, and strip-mines every op into 16 KiB
page-aligned :class:`~repro_torch.core.isa.VectorInstr` ops — 4096 lanes of
32-bit, or 16384 lanes after the paper's INT8 quantization (§5.4) — with
SSA dependency edges, operand logical pages, and operation-type metadata
(Table 1).

Each ATen op is first named by its JAX-primitive counterpart
(:data:`_ATEN_TO_PRIM`), then lowered through the same primitive ->
mnemonic tables as the JAX package's jaxpr walk, so a program written
both ways gives the same instruction stream and page table.  Differences
in how the two frameworks capture a program are absorbed here:

* ``aten.slice.Tensor`` slices one dim at a time where ``lax.slice`` cuts
  all dims at once; consecutive slices over increasing dims of one tensor
  are composed into one multi-dim slice before the page range is aliased.
* Negative slice starts and the ``2**63 - 1`` "to the end" sentinel are
  normalised to the tensor's extent.
* A Python scalar argument, a ``scalar_tensor``, or a captured tensor of
  <= 8 elements is a literal (no pages), like a jaxpr ``Literal``.
* ``x[i]`` (``aten.select.int``) is JAX's ``slice`` + ``squeeze``: it
  aliases the selected pages.
* ATen records no node for NumPy rank promotion (``[r, c] ^ [c]``); where
  ``jnp`` would emit a ``broadcast_in_dim`` to ``[1, c]`` before the op,
  the walk emits that ``broadcast`` itself.
* ``jnp.where``, ``jnp.take``, ``%`` and ``jnp.cumsum`` reach the jaxpr
  walk as a nested ``jit`` that it does not enter; their ATen counterparts
  (:data:`_NESTED_JIT`) take the same CONTROL region, pages named ``jit``.

Partial vectorization (strip-mining, §4.3.1): array tails that do not fill
a page become shorter-``vlen`` instructions.  Ops with no vector lowering
(data-dependent control flow such as ``while_loop``, sorts, unknown-trip-
count loops — the §7 limitations — and, until later slices of the port,
matrix products) are emitted as ``CONTROL`` instructions pinned to ISP,
mirroring the paper's treatment of control-intensive regions.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from repro_torch.core.isa import VectorInstr
from repro_torch.core.mapping import PageTable
from repro_torch.core.trace import Trace, TraceBudgetExceeded, _compact
from repro_torch.hw.ssd_spec import DEFAULT_SSD, SSDSpec

# -- primitive -> mnemonic table (the auto-vectorizer's pattern match) -------

# The JAX package's tables (``repro/core/vectorize.py``), less the
# primitives no ATen op below is named after.
_ELEMENTWISE = {
    "add": "add", "sub": "sub", "mul": "mul",
    "div": "div", "rem": "div", "pow": "mul",
    "neg": "sub", "sign": "cmp", "abs": "max",
    "exp": "exp", "exp2": "exp", "log": "exp", "log1p": "exp",
    "expm1": "exp", "tanh": "tanh", "logistic": "logistic",
    "sqrt": "rsqrt", "rsqrt": "rsqrt",
    "sin": "exp", "cos": "exp", "erf": "exp", "erf_inv": "exp",
    "max": "max", "min": "min",
    "and": "and", "or": "or", "xor": "xor", "not": "not",
    "shift_left": "shl", "shift_right_arithmetic": "shr",
    "lt": "cmp", "le": "cmp", "gt": "cmp", "ge": "cmp",
    "eq": "cmp", "ne": "cmp",
    "floor": "cmp", "ceil": "cmp", "round": "cmp",
    "is_finite": "cmp", "square": "mul",
    "clamp": "select", "select_n": "select", "nextafter": "add",
}

_REDUCTIONS = {
    "reduce_sum": "reduce_sum", "reduce_max": "reduce_max",
    "reduce_min": "reduce_max", "reduce_prod": "reduce_sum",
    "reduce_and": "reduce_max", "reduce_or": "reduce_max",
    "argmax": "reduce_max", "argmin": "reduce_max",
}

_COPYLIKE = {
    "broadcast_in_dim": "broadcast", "convert_element_type": "copy",
    "concatenate": "copy", "pad": "copy",
    "iota": "iota", "copy": "copy",
}

_SHUFFLE = {"transpose": "shuffle", "rev": "shuffle"}
_FREE = {"reshape", "squeeze", "expand_dims", "stop_gradient", "copy_p"}

# -- ATen op -> JAX-primitive name --------------------------------------------
# Keyed by the op's overload packet name (``aten.add.Tensor`` -> "add").
# Page and instruction names come from the primitive name, as in the JAX
# package's trace.  An op missing here takes the CONTROL fallback.

_ATEN_TO_PRIM = {
    # elementwise
    "add": "add", "sub": "sub", "rsub": "sub", "mul": "mul", "div": "div",
    "fmod": "rem", "pow": "pow", "neg": "neg",
    "sign": "sign", "abs": "abs", "exp": "exp", "exp2": "exp2",
    "log": "log", "log1p": "log1p", "expm1": "expm1", "tanh": "tanh",
    "sigmoid": "logistic", "sqrt": "sqrt", "rsqrt": "rsqrt", "sin": "sin",
    "cos": "cos", "erf": "erf", "erfinv": "erf_inv",
    "maximum": "max", "minimum": "min", "clamp_min": "max",
    "clamp_max": "min", "clamp": "clamp",
    "bitwise_and": "and", "logical_and": "and", "bitwise_or": "or",
    "logical_or": "or", "bitwise_xor": "xor", "logical_xor": "xor",
    "bitwise_not": "not", "logical_not": "not",
    "__lshift__": "shift_left", "bitwise_left_shift": "shift_left",
    "__rshift__": "shift_right_arithmetic",
    "bitwise_right_shift": "shift_right_arithmetic",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne",
    "floor": "floor", "ceil": "ceil", "round": "round",
    "isfinite": "is_finite", "square": "square", "nextafter": "nextafter",
    # reductions
    "sum": "reduce_sum", "amax": "reduce_max", "amin": "reduce_min",
    "prod": "reduce_prod", "all": "reduce_and", "any": "reduce_or",
    "argmax": "argmax", "argmin": "argmin",
    # copies
    "cat": "concatenate", "clone": "copy", "copy": "copy",
    "_to_copy": "convert_element_type", "expand": "broadcast_in_dim",
    "full": "broadcast_in_dim", "full_like": "broadcast_in_dim",
    "zeros": "broadcast_in_dim", "zeros_like": "broadcast_in_dim",
    "ones": "broadcast_in_dim", "ones_like": "broadcast_in_dim",
    "constant_pad_nd": "pad", "arange": "iota",
    # shuffles
    "t": "transpose", "transpose": "transpose", "permute": "transpose",
    "flip": "rev",
    # views (aliasing, no data movement)
    "view": "reshape", "_unsafe_view": "reshape", "reshape": "reshape",
    "squeeze": "squeeze", "unsqueeze": "expand_dims",
    "detach": "stop_gradient", "alias": "copy_p",
    # slices
    "slice": "slice", "select": "select",
    # higher-order ops (the CONTROL fallback)
    "while_loop": "while",
}

# ATen ops whose ``jnp`` counterpart jax 0.9 wraps in a nested ``jit``
# (``_where``, ``_take``, ``remainder``, ``cumsum``): the jaxpr walk does
# not enter it, so it is one CONTROL region whose pages are named ``jit``.
_NESTED_JIT = {"where", "index", "take", "remainder", "cumsum"}

# aten.max/min overloads: ``other`` is the binary elementwise op, ``default``
# the full reduction (``dim`` returns values+indices: CONTROL fallback).
_OVERLOAD_PRIM = {
    ("max", "other"): "max", ("min", "other"): "min",
    ("max", "default"): "reduce_max", ("min", "default"): "reduce_min",
}

# ops that write a constant and read no tensor (JAX broadcasts a literal)
_FILLS = {"full", "full_like", "zeros", "zeros_like", "ones", "ones_like",
          "arange"}

_LITERAL_MAX_ELEMS = 8


@dataclasses.dataclass(frozen=True)
class _Aval:
    """The abstract value of a node: what the page math reads of it."""

    size: int
    itemsize: int


def _aval(val) -> _Aval:
    if isinstance(val, torch.Tensor):
        return _Aval(val.numel(), val.element_size())
    return _Aval(1, 8)                         # a Python scalar


@dataclasses.dataclass(frozen=True)
class _SliceView:
    """A (possibly composed) multi-dim slice of a base tensor's pages."""

    base_pages: Optional[List[int]]
    base_shape: tuple
    base_aval: _Aval
    starts: tuple
    limits: tuple
    last_dim: int


def _names(target) -> Tuple[str, str]:
    """(ATen op name, JAX-primitive name) of a node's target."""
    if target is operator.getitem:
        return "getitem", "getitem"
    packet = getattr(target, "overloadpacket", None)
    if packet is None:                          # higher-order op, Python fn
        name = getattr(target, "__name__", str(target))
        return name, _ATEN_TO_PRIM.get(name, name)
    name = packet.__name__
    key = (name, getattr(target, "_overloadname", ""))
    if key in _OVERLOAD_PRIM:
        return name, _OVERLOAD_PRIM[key]
    if name in _NESTED_JIT:
        return name, "jit"
    return name, _ATEN_TO_PRIM.get(name, name)


class _Vectorizer:
    def __init__(self, spec: SSDSpec, elem_bytes: int, quantize: bool,
                 max_instrs: int):
        self.spec = spec
        self.page_bytes = spec.page_size
        self.elem_bytes = elem_bytes
        self.quantize = quantize
        self.max_instrs = max_instrs
        self.pages = PageTable(spec)
        self.instrs: List[VectorInstr] = []
        self.producer: Dict[int, int] = {}      # page id -> producing iid
        self._iid = 0
        self.views: Dict[torch.fx.Node, _SliceView] = {}

    # -- helpers --------------------------------------------------------------

    def _ebytes(self, aval: _Aval) -> int:
        if self.quantize:
            return self.elem_bytes           # INT8 quantization (§5.4)
        return aval.itemsize

    def _lanes(self, ebytes: int) -> int:
        return self.page_bytes // ebytes

    def _npages(self, aval: _Aval) -> int:
        return max(1, math.ceil(aval.size * self._ebytes(aval) / self.page_bytes))

    @staticmethod
    def aval(node) -> _Aval:
        return _aval(node.meta["val"])

    def pages_for(self, env: Dict, arg) -> Optional[List[int]]:
        """Logical pages for a node argument (None = scalar literal)."""
        if isinstance(arg, torch.fx.Node):
            return env[arg]
        return None

    def emit(self, op: str, srcs: Sequence[Optional[int]], dst: int,
             vlen: int, ebytes: int, tag: str = "",
             vectorizable: bool = True) -> int:
        if len(self.instrs) >= self.max_instrs:
            raise TraceBudgetExceeded(
                f"trace exceeded max_instrs={self.max_instrs}; "
                f"reduce the workload scale (tag={tag})")
        real_srcs = tuple(s for s in srcs if s is not None)
        deps = tuple(sorted({self.producer[s] for s in real_srcs
                             if s in self.producer}
                            | ({self.producer[dst]} if dst in self.producer
                               else set())))
        iid = self._iid
        self._iid += 1
        self.instrs.append(VectorInstr(
            iid=iid, op=op, vlen=vlen, elem_bytes=ebytes,
            srcs=real_srcs, dst=dst, deps=deps, tag=tag,
            vectorizable=vectorizable))
        self.producer[dst] = iid
        return iid

    def emit_map(self, op: str, in_pages: Sequence[Optional[List[int]]],
                 out_pages: List[int], aval: _Aval, tag: str,
                 vectorizable: bool = True) -> None:
        """Strip-mine an elementwise op over the output pages."""
        ebytes = self._ebytes(aval)
        lanes = self._lanes(ebytes)
        total = aval.size
        for i, dst in enumerate(out_pages):
            vlen = min(lanes, total - i * lanes) if total > 0 else lanes
            srcs = []
            for pl in in_pages:
                if not pl:
                    srcs.append(None)
                else:
                    srcs.append(pl[min(i, len(pl) - 1)])  # broadcast reuse
            self.emit(op, srcs, dst, max(1, vlen), ebytes, tag,
                      vectorizable=vectorizable)

    def _alloc(self, aval: _Aval, name: str) -> List[int]:
        return self.pages.alloc_array(aval.size * self._ebytes(aval), name)

    # -- node dispatch --------------------------------------------------------

    def node(self, node, env: Dict) -> None:
        aten, prim = _names(node.target)
        args = node.args

        if prim == "getitem":                  # one output of a tuple op
            env[node] = env[args[0]][args[1]]
            return

        if aten == "lift_fresh_copy":          # a captured constant, as is
            env[node] = self.pages_for(env, args[0])
            return

        if aten == "scalar_tensor":            # a Python scalar made 0-d
            env[node] = None
            return

        if prim in _FREE:
            src = self.pages_for(env, args[0])
            out_aval = self.aval(node)
            need = self._npages(out_aval)
            if src is None or len(src) < need:
                out = self._alloc(out_aval, prim)
                self.emit_map("copy", [src], out, out_aval, prim)
                env[node] = out
            else:
                env[node] = src[:need]   # aliasing, no data movement
            return

        if prim == "slice":
            self._slice(node, env)
            return

        if prim == "select":
            self._select(node, env)
            return

        if prim in _ELEMENTWISE:
            ins = self._promote_ranks(node, env)
            out = self._alloc(self.aval(node), prim)
            self.emit_map(_ELEMENTWISE[prim], ins, out, self.aval(node), prim)
            env[node] = out
            return

        if prim in _REDUCTIONS:
            self._reduction(node, env, _REDUCTIONS[prim])
            return

        if prim in _COPYLIKE:
            if prim == "concatenate":
                operands = args[0]
            elif aten in _FILLS:
                operands = []
            else:
                operands = args[:1]
            ins = [self.pages_for(env, a) for a in operands]
            out = self._alloc(self.aval(node), prim)
            self.emit_map(_COPYLIKE[prim], ins, out, self.aval(node), prim)
            env[node] = out
            return

        if prim in _SHUFFLE:
            ins = [self.pages_for(env, args[0])]
            out = self._alloc(self.aval(node), prim)
            self.emit_map(_SHUFFLE[prim], ins, out, self.aval(node), prim)
            env[node] = out
            return

        # Unknown op, loops, nested-jit ops (and, until a later slice,
        # matmuls): conservatively non-vectorizable (paper §7).
        self._fallback_control(node, env, prim)

    def _promote_ranks(self, node, env: Dict) -> List[Optional[List[int]]]:
        """Operand pages of an elementwise op after NumPy rank promotion.

        ``jnp`` (``promote_shapes``) brings operands of two or more
        distinct non-scalar ranks to the result rank with a
        ``broadcast_in_dim`` that prepends 1-dims; it is emitted here, in
        operand order, since ATen broadcasts inside the op."""
        args = node.args
        ranks = [getattr(a.meta.get("val"), "ndim", 0)
                 if isinstance(a, torch.fx.Node) else 0 for a in args]
        ins = [self.pages_for(env, a) for a in args]
        if len({r for r in ranks if r}) < 2:
            return ins
        rank = max(ranks)
        for k, (a, r) in enumerate(zip(args, ranks)):
            if 0 < r < rank and ins[k] is not None:
                aval = self.aval(a)
                out = self._alloc(aval, "broadcast_in_dim")
                self.emit_map(_COPYLIKE["broadcast_in_dim"], [ins[k]], out,
                              aval, "broadcast_in_dim")
                ins[k] = out
        return ins

    def _fallback_control(self, node, env: Dict, prim: str) -> None:
        if prim == "while":
            # JAX's ``while`` reads (cond consts, body consts, carries); the
            # HOP is (cond, body, carries, additional inputs), the lifted
            # closures of cond and body last.  The sub-graphs are not walked.
            operands = list(node.args[3]) + list(node.args[2])
        else:
            operands = pytree.tree_leaves(node.args)
        ins = [self.pages_for(env, a) for a in operands]
        val = node.meta.get("val")
        vals = val if isinstance(val, (list, tuple)) else [val]
        outs = []
        for v in vals:
            aval = _aval(v)
            out = self._alloc(aval, prim)
            # CONTROL region: per-page scalar execution on ISP.
            self.emit_map("scalar", ins, out, aval, tag=prim,
                          vectorizable=False)
            outs.append(out)
        env[node] = outs if isinstance(val, (list, tuple)) else outs[0]

    def _slice(self, node, env: Dict) -> None:
        """A vectorized load at an offset reads the source pages in place:
        alias the page sub-range covering the sliced bytes (no copy)."""
        src = node.args[0]
        shape = tuple(src.meta["val"].shape)
        params = list(node.args[1:]) + [None] * (4 - len(node.args[1:]))
        dim, start, end = params[0] or 0, params[1], params[2]
        dim %= len(shape)
        size = shape[dim]
        start = 0 if start is None else start
        end = size if end is None else end     # 2**63 - 1 clamps to size
        start = min(max(start + size if start < 0 else start, 0), size)
        end = min(max(end + size if end < 0 else end, 0), size)

        prev = self.views.get(src)
        if prev is not None and prev.last_dim < dim:
            # a multi-dim index slices dim by dim: compose into one slice
            off = prev.starts[dim]
            starts = prev.starts[:dim] + (off + start,) + prev.starts[dim + 1:]
            limits = prev.limits[:dim] + (off + end,) + prev.limits[dim + 1:]
            view = dataclasses.replace(prev, starts=starts, limits=limits,
                                       last_dim=dim)
        else:
            zeros = (0,) * len(shape)
            view = _SliceView(
                base_pages=self.pages_for(env, src), base_shape=shape,
                base_aval=self.aval(src),
                starts=zeros[:dim] + (start,) + zeros[dim + 1:],
                limits=shape[:dim] + (end,) + shape[dim + 1:], last_dim=dim)
        self.views[node] = view
        env[node] = self._slice_pages(view)

    def _slice_pages(self, view: _SliceView) -> Optional[List[int]]:
        """The base pages that hold the bytes of a multi-dim slice."""
        if view.base_pages is None:
            return None
        eb = self._ebytes(view.base_aval)
        acc, flat_start, flat_last = 1, 0, 0
        for d in range(len(view.base_shape) - 1, -1, -1):
            flat_start += view.starts[d] * acc
            flat_last += (view.limits[d] - 1) * acc
            acc *= view.base_shape[d]
        first = (flat_start * eb) // self.page_bytes
        last = (flat_last * eb) // self.page_bytes
        src_pages = view.base_pages
        return src_pages[first:last + 1] or src_pages[-1:]

    def _select(self, node, env: Dict) -> None:
        """``x[i]`` along ``dim``: JAX's ``slice`` of ``[i, i + 1)`` then a
        ``squeeze``, both aliasing (no data movement)."""
        src, dim, index = node.args
        shape = tuple(src.meta["val"].shape)
        dim %= len(shape)
        index %= shape[dim]
        zeros = (0,) * len(shape)
        pages = self._slice_pages(_SliceView(
            base_pages=self.pages_for(env, src), base_shape=shape,
            base_aval=self.aval(src),
            starts=zeros[:dim] + (index,) + zeros[dim + 1:],
            limits=shape[:dim] + (index + 1,) + shape[dim + 1:],
            last_dim=dim))
        env[node] = (None if pages is None
                     else pages[:self._npages(self.aval(node))])

    def _reduction(self, node, env: Dict, op: str) -> None:
        src = self.pages_for(env, node.args[0])
        in_aval = self.aval(node.args[0])
        out_aval = self.aval(node)
        out = self.pages.alloc_array(
            max(1, out_aval.size) * self._ebytes(out_aval), op)
        ebytes = self._ebytes(in_aval)
        lanes = self._lanes(ebytes)
        if src is None:
            self.emit(op, [], out[0], 1, ebytes, op)
        else:
            # accumulate page partials into the (smaller) output; successive
            # accumulations into one page serialize via the producer dep.
            for i, s in enumerate(src):
                dst = out[i % len(out)]
                self.emit(op, [s, dst], dst,
                          min(lanes, in_aval.size), ebytes, op)
        env[node] = out


def vectorize(fn: Callable, *example_args,
              spec: SSDSpec = DEFAULT_SSD,
              elem_bytes: int = 1,                 # INT8 quantization (§5.4)
              quantize: bool = True,
              max_instrs: int = 400_000,
              scan_unroll_limit: int = 128,
              matmul_k_steps: int = 16,
              name: str = "") -> Trace:
    """Trace ``fn`` and emit the Conduit vector-instruction binary.

    This is the full compile-time phase: loop auto-vectorization (ATen
    nodes are already loop-free SSA over tensors — each node is the
    vectorized loop body), strip-mining into page-aligned instructions, and
    metadata embedding.  Inputs are assumed resident in flash at t=0 (§4.4
    "we assume all application data resides in the SSD").

    ``fn`` is captured on fake tensors, so no data is computed and the
    example arguments may live on any device.  ``scan_unroll_limit`` and
    ``matmul_k_steps`` keep the JAX package's signature; counted loops and
    matrix products take the CONTROL fallback until the port's later
    slices lower them.
    """
    del scan_unroll_limit, matmul_k_steps
    gm = make_fx(fn, tracing_mode="fake",
                 _allow_non_fake_inputs=True)(*example_args)
    v = _Vectorizer(spec, elem_bytes, quantize, max_instrs)
    env: Dict = {}
    input_pages: Dict[str, List[int]] = {}
    nodes = list(gm.graph.nodes)
    # allocation order as in the jaxpr walk: inputs, then constants, then
    # ops — so that _compact hands out the same page ids
    for i, node in enumerate(n for n in nodes if n.op == "placeholder"):
        aval = v.aval(node)
        pids = v.pages.alloc_array(max(1, aval.size) * v._ebytes(aval),
                                   name=f"in{i}")
        env[node] = pids
        input_pages[f"in{i}"] = pids
    for node in nodes:
        if node.op != "get_attr":
            continue
        val = getattr(gm, node.target)
        if (not isinstance(val, torch.Tensor)
                or val.numel() <= _LITERAL_MAX_ELEMS):
            env[node] = None                   # literal / sub-graph
        else:
            env[node] = v.pages.alloc_array(
                max(1, val.numel()) * v.elem_bytes, name="const")
    out_pages = []
    for node in nodes:
        if node.op == "call_function":
            v.node(node, env)
        elif node.op == "output":
            for res in pytree.tree_leaves(node.args[0]):
                pl = env.get(res) if isinstance(res, torch.fx.Node) else None
                out_pages.append(pl or [])
    new_pages, new_in, new_out = _compact(v.instrs, v.pages, input_pages,
                                          out_pages, spec)
    return Trace(instrs=v.instrs, pages=new_pages, input_pages=new_in,
                 output_pages=new_out,
                 name=name or getattr(fn, "__name__", "fn"))
