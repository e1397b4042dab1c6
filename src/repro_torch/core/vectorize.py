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
* ``jnp.where``, ``jnp.take``, ``%``, ``jnp.cumsum`` and ``jax.nn.silu``
  reach the jaxpr walk as a nested ``jit`` that it does not enter; their
  ATen counterparts (:data:`_NESTED_JIT`) take the same CONTROL region,
  pages named ``jit``.
* ``aten.mm`` / ``aten.bmm`` are ``dot_general``.  ``torch.einsum`` would
  decompose into ``unsqueeze`` / ``permute`` / ``view`` chains around a
  ``bmm`` where ``jnp.einsum`` emits one ``dot_general`` and no transpose;
  during capture a two-operand einsum is kept as one node
  (:class:`_KeepEinsum`), lowered with the dimension numbers
  ``jnp.einsum`` gives.  A permute the program writes (``x @ w.T``,
  ``.permute(1, 0, 2)``) stays a ``transpose``, as in JAX.
* ``reshape`` of a strided view is ``clone`` + ``_unsafe_view`` in ATen and
  one ``reshape`` (no data movement) in JAX: such a clone aliases.
* ``mean(keepdim=True)`` and ``softmax`` are one ATen node each; they emit
  the sequences ``jnp.mean`` and ``jax.nn.softmax`` record, and every
  ``keepdim`` reduction the ``broadcast_in_dim`` that ``keepdims`` adds.
* ``x[i]`` with a negative ``i`` is, in jax 0.9, a run-time index
  normalisation (``lt``, ``add``, ``select_n``) and a ``dynamic_slice``,
  which aliases the source from its first page.
* ``unsqueeze`` (``x[None]``) is a view in ATen and a ``broadcast_in_dim``
  copy in JAX; ``torch.stack`` is one node, JAX's ``broadcast_in_dim`` of
  each operand and a ``concatenate``.
* ``torch.func.grad_and_value(f)`` runs autograd's formulas, which give
  another stream than ``jax.value_and_grad``'s linearise-and-transpose.
  During capture the call is kept as one node (:func:`_grad_and_value_node`,
  which still returns the real values); its loss ``f`` is captured again
  and recorded as JAX records it (:mod:`repro_torch.core.autodiff`), then
  lowered equation by equation as the jaxpr walk lowers an equation
  (:meth:`_Vectorizer.eqn`).

Partial vectorization (strip-mining, §4.3.1): array tails that do not fill
a page become shorter-``vlen`` instructions.  Ops with no vector lowering
(data-dependent control flow such as ``while_loop``, sorts, unknown-trip-
count loops — the §7 limitations) are emitted as ``CONTROL`` instructions
pinned to ISP, mirroring the paper's treatment of control-intensive
regions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import operator
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from repro_torch.core import autodiff
from repro_torch.core.isa import Location, VectorInstr
from repro_torch.core.mapping import PageTable
from repro_torch.core.trace import Trace, TraceBudgetExceeded, _compact
from repro_torch.hw.ssd_spec import DEFAULT_SSD, SSDSpec

# -- primitive -> mnemonic table (the auto-vectorizer's pattern match) -------

# The JAX package's tables (``repro/core/vectorize.py``), less the
# primitives that neither an ATen op below nor a recorded gradient
# (:mod:`repro_torch.core.autodiff`) is named after.
_ELEMENTWISE = {
    "add": "add", "add_any": "add", "sub": "sub", "mul": "mul",
    "div": "div", "rem": "div", "pow": "mul", "integer_pow": "mul",
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
# ``split`` is free: its first output aliases the source's pages and every
# later output takes fresh pages that no instruction writes (hazard R5)
_FREE = {"reshape", "squeeze", "stop_gradient", "copy_p", "split"}

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
    "unsqueeze": "broadcast_in_dim",
    # shuffles
    "t": "transpose", "transpose": "transpose", "permute": "transpose",
    "flip": "rev",
    # views (aliasing, no data movement)
    "view": "reshape", "_unsafe_view": "reshape", "reshape": "reshape",
    "squeeze": "squeeze", "detach": "stop_gradient", "alias": "copy_p",
    # slices
    "slice": "slice", "select": "select",
    # matrix products (``einsum``: the node :class:`_KeepEinsum` records)
    "mm": "dot_general", "bmm": "dot_general", "einsum": "dot_general",
    # one ATen node, a sequence of primitives in JAX
    "mean": "mean", "_softmax": "softmax", "stack": "stack",
    # higher-order ops (the CONTROL fallback)
    "while_loop": "while",
}

# ATen ops whose ``jnp`` counterpart jax 0.9 wraps in a nested ``jit``
# (``_where``, ``_take``, ``remainder``, ``cumsum``, ``silu``): the jaxpr
# walk does not enter it, so it is one CONTROL region whose pages are
# named ``jit``.
_NESTED_JIT = {"where", "index", "take", "remainder", "cumsum", "silu"}

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


def _einsum_labels(equation: str) -> Optional[Tuple[str, str, str]]:
    """``(lhs, rhs, out)`` labels of a two-operand einsum that ``jnp.einsum``
    lowers to one ``dot_general``: no ellipsis, no repeated label, and every
    label in at least two of the three terms (none summed away on one
    side).  None for any other equation."""
    eq = equation.replace(" ", "")
    if "..." in eq or eq.count("->") != 1:
        return None
    ins, out = eq.split("->")
    if ins.count(",") != 1:
        return None
    lhs, rhs = ins.split(",")
    terms = (lhs, rhs, out)
    if any(len(set(t)) != len(t) for t in terms):
        return None
    if any(sum(c in t for t in terms) < 2 for c in lhs + rhs + out):
        return None
    return lhs, rhs, out


@torch.library.custom_op("repro_torch::einsum", mutates_args=())
def _einsum_node(equation: str, operands: List[torch.Tensor]) -> torch.Tensor:
    """One two-operand ``torch.einsum``, recorded by ``make_fx`` as one
    node."""
    return torch.einsum(equation, *operands)


@_einsum_node.register_fake
def _einsum_node_fake(equation, operands):
    lhs, rhs, out = _einsum_labels(equation)
    size = {**dict(zip(lhs, operands[0].shape)),
            **dict(zip(rhs, operands[1].shape))}
    return operands[0].new_empty([size[c] for c in out],
                                 dtype=torch.result_type(*operands))


class _KeepEinsum(TorchFunctionMode):
    """While tracing, a ``torch.einsum`` that ``jnp.einsum`` lowers to one
    ``dot_general`` is recorded as one :func:`_einsum_node` instead of
    ATen's ``unsqueeze`` / ``permute`` / ``view`` / ``bmm`` decomposition;
    every other call runs as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.einsum and not kwargs:
            equation, *operands = args
            if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
                operands = list(operands[0])
            if len(operands) == 2 and _einsum_labels(equation):
                return _einsum_node(equation, list(operands))
        return func(*args, **kwargs)


# The ``torch.func.grad_and_value`` calls of the program being captured:
# (loss function, pytree spec of its arguments, which flat leaves are
# differentiated), indexed by the region number of each recorded node.
_GRAD_REGIONS: List[Tuple[Callable, pytree.TreeSpec, List[bool]]] = []


@torch.library.custom_op("repro_torch::grad_and_value", mutates_args=())
def _grad_and_value_node(region: int, args: List[torch.Tensor]
                         ) -> List[torch.Tensor]:
    """One ``torch.func.grad_and_value(func)(*args)``, recorded by
    ``make_fx`` as one node: the loss, then the gradient of each
    differentiated leaf.  It exists only inside a capture, on fake
    tensors (:func:`_grad_and_value_fake`)."""
    raise RuntimeError("repro_torch::grad_and_value runs only while "
                       "vectorize captures a program")


@_grad_and_value_node.register_fake
def _grad_and_value_fake(region, args):
    _, _, diff = _GRAD_REGIONS[region]
    picked = [a for a, d in zip(args, diff) if d]
    # grad_and_value differentiates a scalar loss
    return [picked[0].new_empty(())] + [a.new_empty(a.shape) for a in picked]


def _recording_grad_and_value(func, argnums=0, has_aux=False):
    """``torch.func.grad_and_value`` while a program is captured: the call
    becomes one :func:`_grad_and_value_node` that still returns the
    gradients and the loss."""
    if has_aux or not isinstance(argnums, int):
        raise NotImplementedError(
            "the tracer records grad_and_value with one int argnums and no "
            "aux output")

    def wrapper(*args):
        flat, spec = pytree.tree_flatten(args)
        diff = [i == argnums for i, a in enumerate(args)
                for _ in pytree.tree_leaves(a)]
        _GRAD_REGIONS.append((func, spec, diff))
        outs = _grad_and_value_node(len(_GRAD_REGIONS) - 1, flat)
        grads = pytree.tree_unflatten(
            list(outs[1:]), pytree.tree_structure(args[argnums]))
        return grads, outs[0]

    return wrapper


@contextlib.contextmanager
def _recording_gradients():
    """Bind ``torch.func.grad_and_value`` to the recording wrapper while a
    program is captured; yields the list of regions it records."""
    saved = torch.func.grad_and_value
    _GRAD_REGIONS.clear()
    torch.func.grad_and_value = _recording_grad_and_value
    try:
        yield _GRAD_REGIONS
    finally:
        torch.func.grad_and_value = saved


@dataclasses.dataclass(frozen=True)
class _Aval:
    """The abstract value of a node: what the page math reads of it."""

    size: int
    itemsize: int


def _aval(val) -> _Aval:
    if isinstance(val, torch.Tensor):
        return _Aval(val.numel(), autodiff.x32_itemsize(val.dtype))
    # a Python or symbolic scalar (a while_loop's int carry): jax's
    # weak-typed int32 or float32
    return _Aval(1, 4)


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


def _while_operands(node) -> list:
    """The operands of JAX's ``while`` for a ``while_loop`` HOP node: cond
    consts, body consts, carries.  The HOP is (cond, body, carries,
    additional inputs), and each sub-graph's placeholders are the carries
    and then every additional input.  A jaxpr's consts are the closed-over
    tensors it uses, in the order of first use, so each sub-graph gives
    the additional inputs its nodes read, in that order; a tensor that
    both sub-graphs read is an operand twice, as in the jaxpr."""
    gm = node.graph.owning_module
    carries, extra = list(node.args[2]), list(node.args[3])
    operands = []
    for sub in node.args[:2]:
        graph = getattr(gm, sub.target).graph
        lifted = [n for n in graph.nodes
                  if n.op == "placeholder"][len(carries):]
        used = {}                                # dict: insertion order
        for n in graph.nodes:
            for a in n.all_input_nodes:
                if a in lifted:
                    used.setdefault(a)
        operands += [extra[lifted.index(p)] for p in used]
    return operands + carries


class _Vectorizer:
    def __init__(self, spec: SSDSpec, elem_bytes: int, quantize: bool,
                 max_instrs: int, matmul_k_steps: int = 16,
                 regions: Sequence = ()):
        self.spec = spec
        self.regions = regions
        self.page_bytes = spec.page_size
        self.elem_bytes = elem_bytes
        self.quantize = quantize
        self.max_instrs = max_instrs
        self.matmul_k_steps = matmul_k_steps
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

        if aten == "clone" and node.users and all(
                _names(u.target)[0] == "_unsafe_view" for u in node.users):
            prim = "reshape"        # ATen's reshape of a strided view

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

        lower = {"slice": self._slice, "select": self._select,
                 "dot_general": self._dot_general, "mean": self._mean,
                 "softmax": self._softmax, "stack": self._stack,
                 "grad_and_value": self._grad_and_value}.get(prim)
        if lower is not None:
            lower(node, env)
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

        # Unknown op, loops, nested-jit ops: conservatively
        # non-vectorizable (paper §7).
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
            operands = _while_operands(node)
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
        """``x[i]`` along ``dim``.  A non-negative ``i`` is JAX's ``slice``
        of ``[i, i + 1)`` then a ``squeeze``, both aliasing (no data
        movement).  A negative ``i`` is normalised at run time in jax 0.9
        (``lt``, ``add``, ``select_n`` on scalars) for a ``dynamic_slice``,
        which aliases every page of the source; the ``squeeze`` keeps the
        first pages."""
        src, dim, index = node.args
        shape = tuple(src.meta["val"].shape)
        dim %= len(shape)
        src_pages = self.pages_for(env, src)
        need = self._npages(self.aval(node))
        if index < 0:
            flag, idx, sel = (_Aval(1, 1), _Aval(1, 4), _Aval(1, 4))
            lt = self._alloc(flag, "lt")
            self.emit_map("cmp", [None, None], lt, flag, "lt")
            add = self._alloc(idx, "add")
            self.emit_map("add", [None, None], add, idx, "add")
            self.emit_map("select", [lt, None, add],
                          self._alloc(sel, "select_n"), sel, "select_n")
            env[node] = None if src_pages is None else src_pages[:need]
            return
        zeros = (0,) * len(shape)
        pages = self._slice_pages(_SliceView(
            base_pages=src_pages, base_shape=shape, base_aval=self.aval(src),
            starts=zeros[:dim] + (index,) + zeros[dim + 1:],
            limits=shape[:dim] + (index + 1,) + shape[dim + 1:],
            last_dim=dim))
        env[node] = None if pages is None else pages[:need]

    def _reduce(self, src: Optional[List[int]], in_aval: _Aval,
                out_aval: _Aval, op: str) -> List[int]:
        """Accumulate the page partials of ``src`` into the (smaller)
        output; successive accumulations into one page serialize via the
        producer dep."""
        out = self.pages.alloc_array(
            max(1, out_aval.size) * self._ebytes(out_aval), op)
        ebytes = self._ebytes(in_aval)
        lanes = self._lanes(ebytes)
        if src is None:
            self.emit(op, [], out[0], 1, ebytes, op)
        else:
            for i, s in enumerate(src):
                dst = out[i % len(out)]
                self.emit(op, [s, dst], dst,
                          min(lanes, in_aval.size), ebytes, op)
        return out

    def _broadcast(self, src: List[int], aval: _Aval) -> List[int]:
        out = self._alloc(aval, "broadcast_in_dim")
        self.emit_map(_COPYLIKE["broadcast_in_dim"], [src], out, aval,
                      "broadcast_in_dim")
        return out

    def _reduction(self, node, env: Dict, op: str) -> List[int]:
        """A reduction, then the ``broadcast_in_dim`` that ``keepdims``
        adds in JAX (``keepdim`` is the third argument of every ATen
        reduction that has one)."""
        out_aval = self.aval(node)
        out = self._reduce(self.pages_for(env, node.args[0]),
                           self.aval(node.args[0]), out_aval, op)
        if node.kwargs.get("keepdim",
                           len(node.args) > 2 and node.args[2]):
            out = self._broadcast(out, out_aval)
        env[node] = out
        return out

    def _mean(self, node, env: Dict) -> None:
        """``jnp.mean``: ``reduce_sum`` (and the ``keepdims`` broadcast),
        then a ``div`` by the element count (a literal)."""
        out = self._reduction(node, env, "reduce_sum")
        quot = self._alloc(self.aval(node), "div")
        self.emit_map("div", [out, None], quot, self.aval(node), "div")
        env[node] = quot

    def _softmax(self, node, env: Dict) -> None:
        """``jax.nn.softmax``: ``reduce_max``, ``max`` with -inf,
        ``broadcast_in_dim``, ``stop_gradient`` (free), ``sub``, ``exp``,
        ``reduce_sum``, ``broadcast_in_dim``, ``div``."""
        x = self.pages_for(env, node.args[0])
        aval = self.aval(node.args[0])
        val = node.args[0].meta["val"]
        red = _Aval(aval.size // max(1, val.shape[node.args[1]]),
                    aval.itemsize)
        peak = self._reduce(x, aval, red, "reduce_max")
        top = self._alloc(red, "max")
        self.emit_map("max", [None, peak], top, red, "max")
        top = self._broadcast(top, red)
        diff = self._alloc(aval, "sub")
        self.emit_map("sub", [x, top], diff, aval, "sub")
        num = self._alloc(aval, "exp")
        self.emit_map("exp", [diff], num, aval, "exp")
        den = self._broadcast(self._reduce(num, aval, red, "reduce_sum"), red)
        out = self._alloc(aval, "div")
        self.emit_map("div", [num, den], out, aval, "div")
        env[node] = out

    def _stack(self, node, env: Dict) -> None:
        """``jnp.stack``: a ``broadcast_in_dim`` of each operand, then one
        ``concatenate``."""
        parts = [self._broadcast(self.pages_for(env, a), self.aval(a))
                 for a in node.args[0]]
        out = self._alloc(self.aval(node), "concatenate")
        self.emit_map(_COPYLIKE["concatenate"], parts, out, self.aval(node),
                      "concatenate")
        env[node] = out

    def _dot_general(self, node, env: Dict) -> None:
        """Decompose a matmul into page-wide multiply + accumulate chains.

        C[b, m, n] += A[b, m, k] * B[b, k, n]: each (m, k, n-page) triple
        becomes a ``mul`` into a scratch page followed by an ``add`` into
        the accumulator page — the two native SIMD ops every resource's ISA
        exposes.  Contraction steps are grouped into at most
        ``matmul_k_steps`` macro-iterations per output page, each one
        page-wide mul+add pair, as in the JAX package's ``_dot_general``.

        Only the contraction length ``k`` and the operand order shape the
        stream.  ``mm`` contracts ``[m, k] @ [k, n]``, ``bmm`` ``[b, m, k]
        @ [b, k, n]``; an einsum contracts the labels its operands share
        and the result lacks, with ``jnp.einsum``'s choice of operand order
        and its ``transpose`` when neither order gives the result's labels
        as ``dot_general`` lays them out (batch, lhs free, rhs free).
        """
        aten = _names(node.target)[0]
        if aten == "einsum":
            equation, (a, b) = node.args
            lhs, rhs, res = _einsum_labels(equation)
            size = dict(zip(lhs, a.meta["val"].shape))
            k = math.prod(size[c] for c in lhs if c in rhs and c not in res)
            batch = [c for c in res if c in lhs and c in rhs]
            a_free = [c for c in lhs if c not in rhs]
            b_free = [c for c in rhs if c not in lhs]
            # jnp.einsum takes the operands in opt_einsum's (second, first)
            # order and keeps the order that needs no transpose, if either
            transpose = False
            if batch + a_free + b_free != list(res):
                a, b = b, a
                transpose = batch + b_free + a_free != list(res)
        else:                                   # mm, bmm: [..., m, k]
            a, b = node.args
            k = a.meta["val"].shape[-1]
            transpose = False
        out_aval = self.aval(node)
        out = self._emit_dot(self.pages_for(env, a) or [],
                             self.pages_for(env, b) or [], out_aval, k)
        if transpose:
            shuffled = self._alloc(out_aval, "transpose")
            self.emit_map(_SHUFFLE["transpose"], [out], shuffled, out_aval,
                          "transpose")
            out = shuffled
        env[node] = out

    def _emit_dot(self, a_pages: List[int], b_pages: List[int],
                  out_aval: _Aval, k: int) -> List[int]:
        """The mul + add chains of one matrix product with contraction
        length ``k``, as the JAX package's ``_dot_general`` emits them."""
        ebytes = self._ebytes(out_aval)
        lanes = self._lanes(ebytes)
        out = self.pages.alloc_array(out_aval.size * ebytes, "dot")
        bp = max(1, len(b_pages))
        ap = max(1, len(a_pages))
        scratch = self.pages.alloc_array(
            min(len(out), 8) * self.page_bytes, "dot_tmp", Location.DRAM)
        k_steps = min(max(1, k), self.matmul_k_steps)
        # Vectorize over the flattened OUTPUT; the contraction is the
        # serial loop, grouped into k_steps macro-iterations.
        for opg, dst in enumerate(out):
            tmp = scratch[opg % len(scratch)]
            vlen = max(1, min(lanes, out_aval.size - opg * lanes))
            for ki in range(k_steps):
                a_pid = a_pages[(opg * k_steps + ki) % ap] if a_pages else None
                b_pid = (b_pages[(ki * len(out) + opg) % bp] if b_pages
                         else None)
                self.emit("mul", [a_pid, b_pid], tmp, vlen, ebytes,
                          "dot_general")
                self.emit("add", [tmp, dst], dst, vlen, ebytes, "dot_general")
        return out

    # -- a recorded gradient --------------------------------------------------

    def _grad_and_value(self, node, env: Dict) -> None:
        """A ``torch.func.grad_and_value`` call: capture the loss's
        forward graph, record what ``jax.value_and_grad`` records for it
        (:func:`~repro_torch.core.autodiff.value_and_grad_eqns`) and lower
        those equations; the node's outputs are the loss and the
        gradients."""
        func, spec, diff = self.regions[node.args[0]]
        flat = node.args[1]
        metas = [torch.empty(a.meta["val"].shape, dtype=a.meta["val"].dtype,
                             device="meta") for a in flat]

        def loss_fn(*leaves):
            return func(*pytree.tree_unflatten(list(leaves), spec))

        with _KeepEinsum():
            gm = make_fx(loss_fn, tracing_mode="fake",
                         _allow_non_fake_inputs=True)(*metas)
        eqns, ins, outs = autodiff.value_and_grad_eqns(gm, diff)
        sub = {var: self.pages_for(env, a) for var, a in zip(ins, flat)}
        for e in eqns:
            self.eqn(e, sub)
        env[node] = [sub[v] for v in outs]

    def eqn(self, e: "autodiff.Eqn", env: Dict) -> None:
        """Lower one recorded equation as the JAX package's jaxpr walk
        lowers it."""
        prim = e.prim
        ins = [None if isinstance(a, autodiff.Lit) else env[a]
               for a in e.ins]
        out_aval = _Aval(e.outs[0].size, e.outs[0].itemsize)

        if prim == "dot_general":
            (contract, _), _ = e.params["dimension_numbers"]
            k = math.prod(e.ins[0].shape[d] for d in contract) or 1
            env[e.outs[0]] = self._emit_dot(ins[0] or [], ins[1] or [],
                                            out_aval, k)
            return

        if prim in _FREE:
            src = ins[0]
            need = self._npages(out_aval)
            if src is None or len(src) < need:
                out = self._alloc(out_aval, prim)
                self.emit_map("copy", [src], out, out_aval, prim)
                env[e.outs[0]] = out
            else:
                env[e.outs[0]] = src[:need]    # aliasing, no data movement
            for extra in e.outs[1:]:           # fresh pages, no instruction
                env[extra] = self._alloc(_Aval(extra.size, extra.itemsize),
                                         prim)
            return

        if prim == "slice":
            src = e.ins[0]
            env[e.outs[0]] = self._slice_pages(_SliceView(
                base_pages=ins[0], base_shape=src.shape,
                base_aval=_Aval(src.size, src.itemsize),
                starts=e.params["start_indices"],
                limits=e.params["limit_indices"], last_dim=0))
            return

        if prim in _ELEMENTWISE:
            out = self._alloc(out_aval, prim)
            self.emit_map(_ELEMENTWISE[prim], ins, out, out_aval, prim)
            env[e.outs[0]] = out
            return

        if prim in _REDUCTIONS:
            src = e.ins[0]
            env[e.outs[0]] = self._reduce(
                ins[0], _Aval(src.size, src.itemsize), out_aval,
                _REDUCTIONS[prim])
            return

        table = (_COPYLIKE if prim in _COPYLIKE else _SHUFFLE
                 if prim in _SHUFFLE else None)
        op, vectorizable = (("scalar", False) if table is None
                            else (table[prim], True))
        # a nested ``jit`` (CONTROL region: per-page scalar execution on
        # ISP), or a copy or shuffle, one strip per output
        for ov in e.outs:
            aval = _Aval(ov.size, ov.itemsize)
            out = self._alloc(aval, prim)
            self.emit_map(op, ins, out, aval, prim, vectorizable=vectorizable)
            env[ov] = out


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
    example arguments may live on any device.  ``matmul_k_steps`` bounds
    the macro-iterations of each matrix product's contraction.
    ``scan_unroll_limit`` keeps the JAX package's signature: the port has
    no counted-loop construct to unroll yet.
    """
    del scan_unroll_limit
    with _KeepEinsum(), _recording_gradients() as regions:
        gm = make_fx(fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*example_args)
        regions = list(regions)
    v = _Vectorizer(spec, elem_bytes, quantize, max_instrs, matmul_k_steps,
                    regions)
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
