"""Reverse-mode differentiation recorded as the JAX package's tracer sees it.

The JAX package traces ``jax.value_and_grad(loss_fn)`` into one jaxpr: the
*linearised* program (each primitive's primal equation followed by the
residual equations of its JVP rule that depend on primal values only),
then the *transposed* linear program (each linear equation's transpose
rule, in reverse order, with an ``add_any`` wherever two cotangents of
one value meet), as ``jax.linearize`` and ``ad.backward_pass`` build it.
Torch autograd computes the same gradient through other formulas, so its
graph does not give that stream.

:func:`value_and_grad_eqns` takes the forward graph of the loss (an ATen
graph captured by ``make_fx``), names each node by its JAX primitives as
``jnp`` emits them, and replays JAX's rules on that program:

* **JVP** — each primitive binds its primal equation, then the residual
  equations of its JVP rule (``rsqrt``'s ``div`` and ``mul -0.5``,
  ``div``'s ``integer_pow``, ``reduce_max``'s location mask and count,
  ``max``'s balanced-equality selects, ``abs``'s ``ge``, the zeros that
  ``select_n`` instantiates), in the order the rule evaluates them; its
  linear equations are recorded apart.  A tangent that is symbolically
  zero (``stop_gradient``, an input not differentiated) takes no
  equation.
* **Transpose** — the linear equations are walked backwards; one whose
  output has no cotangent (dead, e.g. the tangent that ``stop_gradient``
  discards) emits nothing, every other one emits its transpose rule:
  ``dot_general`` with the ``transpose`` that restores the operand's
  layout, ``reduce_sum`` for ``broadcast_in_dim``, ``broadcast_in_dim`` for
  ``reduce_sum`` and ``squeeze``, ``pad`` for ``slice``, ``split`` for
  ``concatenate``, ``neg`` for ``sub``, ``_unbroadcast``'s ``reduce_sum``
  and ``reshape`` for an operand broadcast inside a binary op.
* **Nested jits** — ``jnp.take``, ``jnp.where``, ``jax.nn.silu`` and
  ``jnp.take_along_axis`` are each a nested ``jit`` that the reference
  walk does not enter (hazard R2).  Partial evaluation splits each into a
  known ``jit`` (its outputs and residuals) and a linear one whose
  transpose is another ``jit``; both are recorded with the residuals the
  reference's jaxpr gives them.

The result is a flat list of :class:`Eqn` that the vectorizer lowers with
the reference's tables.  Only the recorded stream follows JAX: the values
the port computes are torch autograd's.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import operator
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


# jax with x64 off, as the reference runs, has no 64-bit array: int64 and
# float64 become 32-bit, complex128 becomes complex64
_X32_ITEMSIZE = {torch.int64: 4, torch.uint64: 4, torch.float64: 4,
                 torch.complex128: 8}


def x32_itemsize(dtype: torch.dtype) -> int:
    """``dtype``'s element width as the reference's jaxpr records it."""
    return _X32_ITEMSIZE.get(dtype, dtype.itemsize)


class Var:
    """One array of the recorded program: its shape and dtype."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: Sequence[int], dtype: torch.dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def itemsize(self) -> int:
        return x32_itemsize(self.dtype)

    def __repr__(self) -> str:
        return f"Var{list(self.shape)}:{self.dtype}"


@dataclasses.dataclass(frozen=True)
class Lit:
    """A scalar literal operand (no pages), as a jaxpr ``Literal``."""

    value: float
    shape: tuple = ()


Atom = Union[Var, Lit]


@dataclasses.dataclass
class Eqn:
    """One equation of the recorded program."""

    prim: str
    ins: List[Atom]
    outs: List[Var]
    params: dict


@dataclasses.dataclass
class _Lin:
    """One equation of the linear program: ``ins`` mixes tangents (linear)
    and residuals (primal values)."""

    prim: str
    ins: List[Atom]
    out: Var
    params: dict


@dataclasses.dataclass(frozen=True)
class _Dual:
    """A primal atom and its tangent (None: symbolically zero)."""

    p: Atom
    t: Optional[Var] = None


_F32 = torch.float32
_BOOL = torch.bool
_I32 = torch.int32


def _bshape(*shapes: tuple) -> tuple:
    """The result shape of a binary op: equal ranks, size-1 dims stretch
    (a scalar takes the other operand's shape)."""
    shapes = [s for s in shapes if s]
    if not shapes:
        return ()
    return tuple(max(d) for d in zip(*shapes))


def _remaining(original, *removed_lists) -> list:
    removed = set(itertools.chain(*removed_lists))
    return [i for i in original if i not in removed]


def _ranges_like(*xs):
    start = 0
    for x in xs:
        yield list(range(start, start + len(x)))
        start += len(x)


def _dot_shape(a: tuple, b: tuple, dims) -> tuple:
    (ac, bc), (ab, bb) = dims
    return (tuple(a[d] for d in ab)
            + tuple(a[d] for d in _remaining(range(len(a)), ac, ab))
            + tuple(b[d] for d in _remaining(range(len(b)), bc, bb)))


class _Recorder:
    """Binds equations in order and records the linear program apart."""

    def __init__(self):
        self.eqns: List[Eqn] = []
        self.lins: List[_Lin] = []
        self.linear: set = set()                 # ids of tangent vars

    # -- the emitted program ------------------------------------------------

    def bind(self, prim: str, ins: Sequence[Atom], shape, dtype=_F32,
             **params) -> Var:
        out = Var(shape, dtype)
        self.eqns.append(Eqn(prim, list(ins), [out], params))
        return out

    def bind_n(self, prim: str, ins: Sequence[Atom],
               avals: Sequence[Tuple[tuple, torch.dtype]], **params
               ) -> List[Var]:
        outs = [Var(s, d) for s, d in avals]
        self.eqns.append(Eqn(prim, list(ins), outs, params))
        return outs

    def lin(self, prim: str, ins: Sequence[Atom], shape, **params) -> Var:
        out = Var(shape, _F32)
        self.linear.add(id(out))
        self.lins.append(_Lin(prim, list(ins), out, params))
        return out

    def is_linear(self, a) -> bool:
        return isinstance(a, Var) and id(a) in self.linear

    # -- lax helpers used by the rules --------------------------------------

    def broadcast_in_dim(self, x: Atom, shape, dims) -> Var:
        return self.bind("broadcast_in_dim", [x], shape, _dtype(x),
                         broadcast_dimensions=tuple(dims))

    def expand_dims(self, x: Var, dims) -> Var:
        if not dims:
            return x
        shape = list(x.shape)
        for d in sorted(dims):
            shape.insert(d, 1)
        kept = [i for i in range(len(shape)) if i not in set(dims)]
        return self.broadcast_in_dim(x, shape, kept)

    def reduce_sum(self, x: Var, axes) -> Var:
        shape = [d for i, d in enumerate(x.shape) if i not in set(axes)]
        return self.bind("reduce_sum", [x], shape, x.dtype, axes=tuple(axes))

    def transpose(self, x: Var, perm) -> Var:
        perm = tuple(int(p) for p in perm)
        if perm == tuple(range(len(perm))):
            return x                          # lax.transpose: identity
        return self.bind("transpose", [x], [x.shape[p] for p in perm],
                         x.dtype, permutation=perm)

    def unbroadcast(self, shape: tuple, x: Var) -> Var:
        """``lax._unbroadcast``: sum ``x`` back to an operand's shape."""
        if x.shape == shape:
            return x
        if not shape:
            return self.reduce_sum(x, list(range(len(x.shape))))
        dims = [i for i, (a, b) in enumerate(zip(x.shape, shape)) if a != b]
        if dims:
            x = self.reduce_sum(x, dims)
        return self.bind("reshape", [x], shape, x.dtype)

    def dot_general(self, a: Var, b: Var, dims) -> Var:
        return self.bind("dot_general", [a, b],
                         _dot_shape(a.shape, b.shape, dims),
                         dimension_numbers=dims)


def _dtype(a: Atom) -> torch.dtype:
    return a.dtype if isinstance(a, Var) else _F32


# -- JVP rules: primal + residual equations, linear equations apart ---------

class _Jvp:
    def __init__(self, rec: _Recorder):
        self.r = rec

    def _sum_tangents(self, terms: List[Var], shape) -> Optional[Var]:
        """``ad.add_tangents`` over a primitive's JVP terms."""
        terms = [t for t in terms if t is not None]
        if not terms:
            return None
        out = terms[0]
        for t in terms[1:]:
            out = self.r.lin("add_any", [out, t], shape)
        return out

    def _maybe_broadcast(self, shape, t: Var) -> Var:
        if t.shape == shape:
            return t
        if not t.shape:
            return self.r.lin("broadcast_in_dim", [t], shape,
                              broadcast_dimensions=())
        dims = [i for i, (a, b) in enumerate(zip(t.shape, shape)) if a == b]
        t = self.r.lin("reshape", [t], [t.shape[i] for i in dims])
        return self.r.lin("broadcast_in_dim", [t], shape,
                          broadcast_dimensions=tuple(dims))

    # elementwise

    def add(self, x: _Dual, y: _Dual) -> _Dual:
        shape = _bshape(x.p.shape, y.p.shape)
        out = self.r.bind("add", [x.p, y.p], shape, _dtype(x.p))
        if x.t is not None and y.t is not None:
            return _Dual(out, self.r.lin("add", [x.t, y.t], shape))
        t = x.t if x.t is not None else y.t
        return _Dual(out, None if t is None else self._maybe_broadcast(
            shape, t))

    def sub(self, x: _Dual, y: _Dual) -> _Dual:
        shape = _bshape(x.p.shape, y.p.shape)
        out = self.r.bind("sub", [x.p, y.p], shape, _dtype(x.p))
        if x.t is not None and y.t is not None:
            return _Dual(out, self.r.lin("sub", [x.t, y.t], shape))
        if x.t is not None:
            return _Dual(out, self._maybe_broadcast(shape, x.t))
        if y.t is not None:
            neg = self.r.lin("neg", [y.t], y.t.shape)
            return _Dual(out, self._maybe_broadcast(shape, neg))
        return _Dual(out)

    def mul(self, x: _Dual, y: _Dual) -> _Dual:
        shape = _bshape(x.p.shape, y.p.shape)
        out = self.r.bind("mul", [x.p, y.p], shape, _dtype(x.p))
        terms = []
        if x.t is not None:
            terms.append(self.r.lin("mul", [x.t, y.p], shape))
        if y.t is not None:
            terms.append(self.r.lin("mul", [x.p, y.t], shape))
        return _Dual(out, self._sum_tangents(terms, shape))

    def div(self, x: _Dual, y: _Dual) -> _Dual:
        shape = _bshape(x.p.shape, y.p.shape)
        out = self.r.bind("div", [x.p, y.p], shape, _dtype(x.p))
        terms = []
        if x.t is not None:                      # div(g, y)
            terms.append(self.r.lin("div", [x.t, y.p], shape))
        if y.t is not None:          # mul(mul(neg(g), x), integer_pow(y, -2))
            neg = self.r.lin("neg", [y.t], y.t.shape)
            m = self.r.lin("mul", [neg, x.p],
                           _bshape(y.t.shape, x.p.shape))
            inv2 = self.r.bind("integer_pow", [y.p], y.p.shape, y=-2)
            terms.append(self.r.lin("mul", [m, inv2], shape))
        return _Dual(out, self._sum_tangents(terms, shape))

    def rsqrt(self, x: _Dual) -> _Dual:
        out = self.r.bind("rsqrt", [x.p], x.p.shape)
        if x.t is None:
            return _Dual(out)
        # mul(g, mul(-0.5, div(ans, x)))
        d = self.r.bind("div", [out, x.p], x.p.shape)
        c = self.r.bind("mul", [Lit(-0.5), d], x.p.shape)
        return _Dual(out, self.r.lin("mul", [x.t, c], x.p.shape))

    def exp(self, x: _Dual) -> _Dual:
        out = self.r.bind("exp", [x.p], x.p.shape)
        return _Dual(out, None if x.t is None else
                     self.r.lin("mul", [x.t, out], x.p.shape))

    def log(self, x: _Dual) -> _Dual:
        out = self.r.bind("log", [x.p], x.p.shape)
        return _Dual(out, None if x.t is None else
                     self.r.lin("div", [x.t, x.p], x.p.shape))

    def abs(self, x: _Dual) -> _Dual:
        out = self.r.bind("abs", [x.p], x.p.shape)
        if x.t is None:
            return _Dual(out)
        # select(ge(x, 0), g, neg(g))
        ge = self.r.bind("ge", [x.p, Lit(0.0)], x.p.shape, _BOOL)
        neg = self.r.lin("neg", [x.t], x.p.shape)
        return _Dual(out, self.r.lin("select_n", [ge, neg, x.t], x.p.shape))

    def unary_zero(self, prim: str, x: _Dual, dtype=_F32) -> _Dual:
        """A primitive whose JVP is zero (``sign``, ``is_finite``,
        ``stop_gradient``)."""
        return _Dual(self.r.bind(prim, [x.p], x.p.shape, dtype))

    def max_lit(self, lit: Lit, x: _Dual) -> _Dual:
        """``max(lit, x)``, the ``initial=-inf`` of ``jnp.max``."""
        shape = x.p.shape
        out = self.r.bind("max", [lit, x.p], shape)
        if x.t is None:
            return _Dual(out)
        # mul(g, _balanced_eq(x, ans, lit))
        b = self.r.broadcast_in_dim
        e1 = self.r.bind("eq", [x.p, out], shape, _BOOL)
        one, zero = b(Lit(1.0), shape, ()), b(Lit(0.0), shape, ())
        s1 = self.r.bind("select_n", [e1, zero, one], shape)
        e2 = self.r.bind("eq", [lit, out], shape, _BOOL)
        two, one = b(Lit(2.0), shape, ()), b(Lit(1.0), shape, ())
        s2 = self.r.bind("select_n", [e2, one, two], shape)
        res = self.r.bind("div", [s1, s2], shape)
        return _Dual(out, self.r.lin("mul", [x.t, res], shape))

    def select_n(self, which: _Dual, *cases: _Dual) -> _Dual:
        shape = cases[0].p.shape
        out = self.r.bind("select_n", [which.p] + [c.p for c in cases],
                          shape, _dtype(cases[0].p))
        if all(c.t is None for c in cases):
            return _Dual(out)
        zeros = self.r.broadcast_in_dim(Lit(0.0), shape, ())
        tangents = [zeros if c.t is None else c.t for c in cases]
        return _Dual(out, self.r.lin("select_n", [which.p] + tangents, shape))

    # reductions

    def reduce_sum(self, x: _Dual, axes) -> _Dual:
        out = self.r.reduce_sum(x.p, axes)
        return _Dual(out, None if x.t is None else self.r.lin(
            "reduce_sum", [x.t], out.shape, axes=tuple(axes)))

    def reduce_max(self, x: _Dual, axes) -> _Dual:
        shape = [d for i, d in enumerate(x.p.shape) if i not in set(axes)]
        out = self.r.bind("reduce_max", [x.p], shape, axes=tuple(axes))
        if x.t is None:
            return _Dual(out)
        keep = [1 if i in axes else d for i, d in enumerate(x.p.shape)]
        ans = self.r.bind("reshape", [out], keep)
        loc = self.r.bind("eq", [x.p, ans], x.p.shape, _BOOL)
        loc = self.r.bind("convert_element_type", [loc], x.p.shape)
        counts = self.r.reduce_sum(loc, axes)
        m = self.r.lin("mul", [x.t, loc], x.p.shape)
        s = self.r.lin("reduce_sum", [m], shape, axes=tuple(axes))
        return _Dual(out, self.r.lin("div", [s, counts], shape))

    # shapes

    def broadcast_in_dim(self, x: _Dual, shape, dims) -> _Dual:
        out = self.r.broadcast_in_dim(x.p, shape, dims)
        return _Dual(out, None if x.t is None else self.r.lin(
            "broadcast_in_dim", [x.t], shape,
            broadcast_dimensions=tuple(dims)))

    def reshape(self, x: _Dual, shape) -> _Dual:
        out = self.r.bind("reshape", [x.p], shape, x.p.dtype)
        return _Dual(out, None if x.t is None else
                     self.r.lin("reshape", [x.t], shape))

    def squeeze(self, x: _Dual, dims) -> _Dual:
        shape = [d for i, d in enumerate(x.p.shape) if i not in set(dims)]
        out = self.r.bind("squeeze", [x.p], shape, x.p.dtype,
                          dimensions=tuple(dims))
        return _Dual(out, None if x.t is None else self.r.lin(
            "squeeze", [x.t], shape, dimensions=tuple(dims)))

    def transpose(self, x: _Dual, perm) -> _Dual:
        out = self.r.transpose(x.p, perm)
        return _Dual(out, None if x.t is None else self.r.lin(
            "transpose", [x.t], out.shape, permutation=tuple(perm)))

    def slice(self, x: _Dual, starts, limits) -> _Dual:
        shape = [b - a for a, b in zip(starts, limits)]
        out = self.r.bind("slice", [x.p], shape, x.p.dtype,
                          start_indices=tuple(starts),
                          limit_indices=tuple(limits))
        return _Dual(out, None if x.t is None else self.r.lin(
            "slice", [x.t], shape, start_indices=tuple(starts),
            limit_indices=tuple(limits)))

    def concatenate(self, xs: Sequence[_Dual], dim: int) -> _Dual:
        shape = list(xs[0].p.shape)
        shape[dim] = sum(x.p.shape[dim] for x in xs)
        out = self.r.bind("concatenate", [x.p for x in xs], shape,
                          dimension=dim)
        if all(x.t is None for x in xs):
            return _Dual(out)
        if any(x.t is None for x in xs):
            raise NotImplementedError(
                "concatenate of differentiated and constant operands")
        return _Dual(out, self.r.lin("concatenate", [x.t for x in xs],
                                     shape, dimension=dim))

    def dot_general(self, a: _Dual, b: _Dual, dims) -> _Dual:
        out = self.r.dot_general(a.p, b.p, dims)
        terms = []
        if a.t is not None:
            terms.append(self.r.lin("dot_general", [a.t, b.p], out.shape,
                                    dimension_numbers=dims))
        if b.t is not None:
            terms.append(self.r.lin("dot_general", [a.p, b.t], out.shape,
                                    dimension_numbers=dims))
        return _Dual(out, self._sum_tangents(terms, out.shape))

    # nested jits: (known outputs, residuals the transposed jit reads)

    def _jit(self, name: str, x: _Dual, ins, out_shape, residual_avals,
             transposed_reads_input: bool = False) -> _Dual:
        out, *res = self.r.bind_n(
            "jit", ins, [(out_shape, _F32)] + list(residual_avals), name=name)
        if x.t is None:
            return _Dual(out)
        reads = res + ([x.p] if transposed_reads_input else [])
        return _Dual(out, self.r.lin("jit", [x.t], out_shape, name=name,
                                     residuals=reads))

    def take(self, x: _Dual, idx: _Dual) -> _Dual:
        """``jnp.take(x, idx, axis=0)``: the gathered rows, and the
        clamped indices ``[n, 1]`` that the scatter-add transpose reads."""
        n = idx.p.shape[0]
        return self._jit("_take", x, [x.p, idx.p], (n,) + x.p.shape[1:],
                         [((n, 1), _I32)])

    def where(self, mask: _Dual, x: _Dual, other: Lit) -> _Dual:
        """``jnp.where(mask, x, other)``: the result, the broadcast mask and
        the zeros the transposed select reads."""
        shape = x.p.shape
        return self._jit("_where", x, [mask.p, x.p, other], shape,
                         [(shape, _BOOL), (shape, _F32)])

    def silu(self, x: _Dual) -> _Dual:
        """``jax.nn.silu``: ``x * sigmoid(x)``, its residuals ``s * (1 - s)``
        and ``s``; the transpose also reads ``x``."""
        shape = x.p.shape
        return self._jit("silu", x, [x.p], shape,
                         [(shape, _F32), (shape, _F32)],
                         transposed_reads_input=True)

    def take_along_axis(self, x: _Dual, idx: _Dual) -> _Dual:
        """``jnp.take_along_axis(x, idx, axis=-1)`` with ``idx`` ``[n, 1]``:
        the gathered ``[n, 1]`` and the indices ``[n, 1, 1]`` the
        scatter-add transpose reads."""
        return self._jit("take_along_axis", x, [x.p, idx.p], idx.p.shape,
                         [(idx.p.shape + (1,), _I32)])


# -- transpose rules ---------------------------------------------------------

def _transpose(r: _Recorder, e: _Lin, ct: Atom) -> List[Tuple[Var, Var]]:
    """(tangent, cotangent) pairs for the linear inputs of ``e``."""
    lin = [a for a in e.ins if r.is_linear(a)]
    p = e.prim
    if p in ("add_any", "add"):
        return [(t, r.unbroadcast(t.shape, ct)) for t in lin]
    if p == "sub":
        x, y = e.ins
        out = []
        if r.is_linear(x):
            out.append((x, r.unbroadcast(x.shape, ct)))
        if r.is_linear(y):
            neg = r.bind("neg", [ct], ct.shape)
            out.append((y, r.unbroadcast(y.shape, neg)))
        return out
    if p == "neg":
        return [(e.ins[0], r.bind("neg", [ct], ct.shape))]
    if p == "mul":
        x, y = e.ins
        if r.is_linear(x):
            m = r.bind("mul", [ct, y], _bshape(ct.shape, y.shape))
            return [(x, r.unbroadcast(x.shape, m))]
        m = r.bind("mul", [x, ct], _bshape(x.shape, ct.shape))
        return [(y, r.unbroadcast(y.shape, m))]
    if p == "div":
        x, y = e.ins
        d = r.bind("div", [ct, y], _bshape(ct.shape, y.shape))
        return [(x, r.unbroadcast(x.shape, d))]
    if p == "reduce_sum":
        x, = e.ins
        kept = [i for i in range(len(x.shape)) if i not in e.params["axes"]]
        return [(x, r.broadcast_in_dim(ct, x.shape, kept))]
    if p == "broadcast_in_dim":
        x, = e.ins
        unit = [i for i, s in enumerate(x.shape) if s == 1]
        bdims = [d for i, d in enumerate(e.params["broadcast_dimensions"])
                 if i not in unit]
        axes = [i for i in range(len(e.out.shape)) if i not in bdims]
        return [(x, r.expand_dims(r.reduce_sum(ct, axes), unit))]
    if p == "reshape":
        x, = e.ins
        return [(x, r.bind("reshape", [ct], x.shape))]
    if p == "squeeze":
        x, = e.ins
        return [(x, r.expand_dims(ct, e.params["dimensions"]))]
    if p == "transpose":
        x, = e.ins
        return [(x, r.transpose(ct, np.argsort(e.params["permutation"])))]
    if p == "slice":
        x, = e.ins
        lo, hi = e.params["start_indices"], e.params["limit_indices"]
        config = tuple((a, s - b, 0) for a, b, s in zip(lo, hi, x.shape))
        return [(x, r.bind("pad", [ct, Lit(0.0)], x.shape,
                           padding_config=config))]
    if p == "concatenate":
        dim = e.params["dimension"]
        sizes = tuple(x.shape[dim] for x in e.ins)
        parts = r.bind_n("split", [ct], [(x.shape, _F32) for x in e.ins],
                         axis=dim, sizes=sizes)
        return list(zip(e.ins, parts))
    if p == "select_n":
        which, *cases = e.ins
        zeros = r.broadcast_in_dim(Lit(0.0), ct.shape, ())
        out = []
        for i, c in enumerate(cases):
            if r.is_linear(c):
                picks = [ct if j == i else zeros for j in range(len(cases))]
                out.append((c, r.bind("select_n", [which] + picks,
                                      ct.shape)))
        return out
    if p == "dot_general":
        x, y = e.ins
        dims = e.params["dimension_numbers"]
        if r.is_linear(x):
            return [(x, _dot_transpose_lhs(r, ct, x.shape, y, dims))]
        (xc, yc), (xb, yb) = dims
        return [(y, _dot_transpose_lhs(r, ct, y.shape, x,
                                       ((yc, xc), (yb, xb)), swap_ans=True))]
    if p == "jit":
        x, = lin
        return [(x, r.bind("jit", e.params["residuals"] + [ct], x.shape,
                           name=e.params["name"]))]
    raise NotImplementedError(f"no transpose rule for {p}")


def _dot_transpose_lhs(r: _Recorder, g: Var, x_shape: tuple, y: Var, dims,
                       swap_ans: bool = False) -> Var:
    """``lax._dot_general_transpose_lhs``."""
    (x_contract, y_contract), (x_batch, y_batch) = dims
    x_kept = _remaining(range(len(x_shape)), x_contract, x_batch)
    y_kept = _remaining(range(len(y.shape)), y_contract, y_batch)
    if swap_ans:
        ans_batch, ans_y, _ = _ranges_like(x_batch, y_kept, x_kept)
    else:
        ans_batch, _, ans_y = _ranges_like(x_batch, x_kept, y_kept)
    new_dims = ((tuple(ans_y), tuple(y_kept)),
                (tuple(ans_batch), tuple(y_batch)))
    x_contract_sorted_by_y = list(np.take(x_contract, np.argsort(y_contract)))
    unsorted_axes = list(x_batch) + x_kept + x_contract_sorted_by_y
    return r.transpose(r.dot_general(g, y, new_dims),
                       np.argsort(unsorted_axes))


# -- the forward graph, named by JAX primitives ------------------------------

def _einsum_dims(equation: str, a, b):
    """``(lhs, rhs, dims, perm)`` of a two-operand einsum as ``jnp.einsum``
    lowers it: the operands in opt_einsum's order, the ``dot_general``
    dimension numbers and the ``transpose`` (None if none) after it."""
    eq = equation.replace(" ", "")
    ins, res = eq.split("->")
    lhs, rhs = ins.split(",")
    batch = [c for c in res if c in lhs and c in rhs]
    if batch + [c for c in lhs if c not in rhs] + [
            c for c in rhs if c not in lhs] != list(res):
        a, b, lhs, rhs = b, a, rhs, lhs
    contract = [c for c in lhs if c in rhs and c not in res]
    dims = ((tuple(lhs.index(c) for c in contract),
             tuple(rhs.index(c) for c in contract)),
            (tuple(lhs.index(c) for c in batch),
             tuple(rhs.index(c) for c in batch)))
    got = batch + [c for c in lhs if c not in rhs] + [
        c for c in rhs if c not in lhs]
    perm = None if got == list(res) else [got.index(c) for c in res]
    return a, b, dims, perm


def _norm(dim: int, rank: int) -> int:
    return dim % rank if rank else 0


class _Forward:
    """Walks a ``make_fx`` graph of the loss and replays it through
    :class:`_Jvp`, named as ``jnp`` names each op."""

    def __init__(self, rec: _Recorder):
        self.r = rec
        self.j = _Jvp(rec)

    def atom(self, env, a) -> _Dual:
        if isinstance(a, torch.fx.Node):
            return env[a]
        return _Dual(Lit(float(a)))

    def promote(self, x: _Dual, y: _Dual) -> Tuple[_Dual, _Dual]:
        """``jnp``'s rank promotion: a lower-rank non-scalar operand gets a
        ``broadcast_in_dim`` that prepends 1-dims."""
        rx, ry = len(x.p.shape), len(y.p.shape)
        if rx and ry and rx != ry:
            rank = max(rx, ry)

            def up(v: _Dual) -> _Dual:
                k = rank - len(v.p.shape)
                if not k:
                    return v
                return self.j.broadcast_in_dim(
                    v, (1,) * k + v.p.shape, range(k, rank))
            x, y = up(x), up(y)
        return x, y

    def node(self, n, env) -> None:
        t = n.target
        name = (t.overloadpacket.__name__ if hasattr(t, "overloadpacket")
                else getattr(t, "__name__", str(t)))
        a = n.args
        j = self.j
        val = n.meta.get("val")
        shape = tuple(val.shape) if isinstance(val, torch.Tensor) else ()
        if t is operator.getitem:
            env[n] = env[a[0]][a[1]]
        elif name in ("add", "sub", "mul", "div"):
            x, y = self.promote(self.atom(env, a[0]), self.atom(env, a[1]))
            env[n] = getattr(j, name)(x, y)
        elif name == "rsqrt":
            env[n] = j.rsqrt(env[a[0]])
        elif name == "mean":
            x = env[a[0]]
            rank = len(x.p.shape)
            axes = (sorted(_norm(d, rank) for d in a[1]) if len(a) > 1
                    else list(range(rank)))
            out = j.reduce_sum(x, axes)
            if len(a) > 2 and a[2]:
                kept = [i for i in range(rank) if i not in axes]
                out = j.broadcast_in_dim(out, shape, kept)
            count = math.prod(x.p.shape[i] for i in axes)
            env[n] = j.div(out, _Dual(Lit(float(count))))
        elif name == "mm":
            env[n] = j.dot_general(env[a[0]], env[a[1]],
                                   (((1,), (0,)), ((), ())))
        elif name == "einsum":
            lhs, rhs, dims, perm = _einsum_dims(a[0], *[env[x] for x in a[1]])
            out = j.dot_general(lhs, rhs, dims)
            env[n] = out if perm is None else j.transpose(out, perm)
        elif name in ("view", "_unsafe_view", "reshape"):
            x = env[a[0]]
            env[n] = x if x.p.shape == shape else j.reshape(x, shape)
        elif name in ("clone", "expand", "remainder", "alias"):
            if tuple(env[a[0]].p.shape) != shape:
                raise NotImplementedError(f"{name} that changes the shape")
            env[n] = env[a[0]]        # no data movement in the jaxpr
        elif name in ("permute", "t"):
            perm = a[1] if name == "permute" else (1, 0)
            env[n] = j.transpose(env[a[0]], perm)
        elif name == "slice":
            x = env[a[0]]
            rank = len(x.p.shape)
            dim = _norm(a[1] if len(a) > 1 else 0, rank)
            size = x.p.shape[dim]
            lo = a[2] if len(a) > 2 and a[2] is not None else 0
            hi = a[3] if len(a) > 3 and a[3] is not None else size
            lo = min(max(lo + size if lo < 0 else lo, 0), size)
            hi = min(max(hi + size if hi < 0 else hi, 0), size)
            starts = [0] * rank
            limits = list(x.p.shape)
            starts[dim], limits[dim] = lo, hi
            env[n] = j.slice(x, starts, limits)
        elif name == "select":
            x, dim, i = env[a[0]], a[1], a[2]
            rank = len(x.p.shape)
            dim = _norm(dim, rank)
            if i < 0:
                raise NotImplementedError("x[-i] inside a differentiated "
                                          "region")
            starts = [0] * rank
            limits = list(x.p.shape)
            starts[dim], limits[dim] = i, i + 1
            env[n] = j.squeeze(j.slice(x, starts, limits), (dim,))
        elif name == "cat":
            xs = [env[x] for x in a[0]]
            dim = _norm(a[1] if len(a) > 1 else 0, len(xs[0].p.shape))
            env[n] = j.concatenate(xs, dim)
        elif name == "unsqueeze":
            x = env[a[0]]
            dim = _norm(a[1], len(shape))
            kept = [i for i in range(len(shape)) if i != dim]
            env[n] = j.broadcast_in_dim(x, shape, kept)
        elif name == "scalar_tensor":
            env[n] = _Dual(Lit(float(a[0])))
        elif name == "index":
            env[n] = j.take(env[a[0]], env[a[1][0]])
        elif name == "where":
            other = self.atom(env, a[2]).p
            if not isinstance(other, Lit):
                raise NotImplementedError("where with a tensor 'other'")
            env[n] = j.where(env[a[0]], env[a[1]], other)
        elif name == "silu":
            env[n] = j.silu(env[a[0]])
        elif name == "gather":
            env[n] = j.take_along_axis(env[a[0]], env[a[2]])
        elif name == "_softmax":
            env[n] = self.softmax(env[a[0]], _norm(a[1], len(shape)))
        elif name == "logsumexp":
            x = env[a[0]]
            rank = len(x.p.shape)
            env[n] = self.logsumexp(x, sorted(_norm(d, rank) for d in a[1]))
        else:
            raise NotImplementedError(
                f"no JAX lowering for aten.{name} in a differentiated region")

    def softmax(self, x: _Dual, axis: int) -> _Dual:
        """``jax.nn.softmax``: ``exp(x - stop_gradient(max)) / sum``."""
        j = self.j
        rank = len(x.p.shape)
        keep = tuple(1 if i == axis else d for i, d in enumerate(x.p.shape))
        kept = [i for i in range(rank) if i != axis]
        top = j.max_lit(Lit(-math.inf), j.reduce_max(x, [axis]))
        top = j.unary_zero("stop_gradient",
                           j.broadcast_in_dim(top, keep, kept))
        num = j.exp(j.sub(x, top))
        den = j.broadcast_in_dim(j.reduce_sum(num, [axis]), keep, kept)
        return j.div(num, den)

    def logsumexp(self, x: _Dual, axes) -> _Dual:
        """``jax.nn.logsumexp`` (``keepdims=False``)."""
        j = self.j
        rank = len(x.p.shape)
        amax = j.max_lit(Lit(-math.inf), j.reduce_max(x, axes))
        finite = j.unary_zero("is_finite", amax, _BOOL)
        zeros = _Dual(self.r.broadcast_in_dim(Lit(0.0), amax.p.shape, ()))
        amax = j.unary_zero("stop_gradient", j.select_n(finite, zeros, amax))
        keep = tuple(1 if i in axes else d for i, d in enumerate(x.p.shape))
        wide = j.broadcast_in_dim(
            amax, keep, [i for i in range(rank) if i not in axes])
        total = j.reduce_sum(j.exp(j.sub(x, wide)), axes)
        j.unary_zero("sign", total)
        return j.add(j.log(j.abs(total)), amax)


def value_and_grad_eqns(gm: torch.fx.GraphModule, argnums_leaves: Sequence[
        bool]) -> Tuple[List[Eqn], List[Var], List[Var]]:
    """The equations ``jax.value_and_grad`` records for the loss ``gm``.

    ``argnums_leaves[i]`` says whether the i-th placeholder is a leaf of
    the differentiated argument.  Returns the equations, the input vars
    (one per placeholder) and the output vars: the loss, then the gradient
    of each differentiated leaf in placeholder order."""
    rec = _Recorder()
    fwd = _Forward(rec)
    env: Dict = {}
    inputs: List[Var] = []
    tangents: List[Var] = []
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for node, diff in zip(placeholders, argnums_leaves):
        val = node.meta["val"]
        var = Var(val.shape, val.dtype)
        tan = None
        if diff:
            tan = Var(val.shape, _F32)
            rec.linear.add(id(tan))
            tangents.append(tan)
        inputs.append(var)
        env[node] = _Dual(var, tan)
    out = None
    for node in gm.graph.nodes:
        if node.op == "call_function":
            fwd.node(node, env)
        elif node.op == "output":
            out, = node.args[0] if isinstance(node.args[0], (list, tuple)) \
                else (node.args[0],)
    loss = env[out]
    # the transposed program: ``ad.backward_pass`` from a unit cotangent
    cts: Dict[int, Atom] = {}
    if loss.t is not None:
        cts[id(loss.t)] = Lit(1.0)
    for e in reversed(rec.lins):
        ct = cts.pop(id(e.out), None)
        if ct is None:
            continue                              # dead: no cotangent
        for tan, c in _transpose(rec, e, ct):
            prev = cts.get(id(tan))
            cts[id(tan)] = c if prev is None else rec.bind(
                "add_any", [prev, c], tan.shape)
    grads = []
    for tan in tangents:
        g = cts.get(id(tan))
        if g is None or isinstance(g, Lit):
            g = rec.broadcast_in_dim(Lit(0.0), tan.shape, ())
        grads.append(g)
    return rec.eqns, inputs, [loss.p] + grads
