"""Per-device cost counts of a DTensor program: the counterpart of XLA's
cost analysis in the JAX package's dry-run.

A cell's step runs once on its DTensor arguments (fake local shards, a
fake process group: :mod:`repro_torch.launch.specs`) under a dispatch
mode that lets DTensor desugar each call into the local ops and the
functional collectives of one rank (it returns ``NotImplemented`` for a
DTensor call), and counts what that rank runs:

- ``flops``: the local ops' flops by ``torch.utils.flop_counter``'s
  formulas (``FlopCounterMode``'s registry; matmuls, convolutions,
  attention);
- ``collectives``: the result bytes of each ``c10d_functional``
  collective by kind (all-reduce, all-gather, reduce-scatter, all-to-all,
  collective-permute), with ``ops`` and ``total`` (``CommDebugMode`` gives
  counts only);
- ``op_bytes``: the bytes each ATen op reads and writes (its tensor
  inputs once, its outputs once; views and collectives move none), the
  port's stand-in for the HLO's "bytes accessed", since there is no HLO;
- ``peak_bytes``: the rank's peak of live tensor bytes, arguments
  included (``torch.distributed._tools.mem_tracker.MemTracker``), in place
  of XLA's ``memory_analysis``.

The port's layers are a Python loop, so every layer is counted where XLA
counts a scanned body once and the JAX package adds ``(count - 1)`` probe
compiles (``corrected_costs``); nothing here needs that correction.  The
Mamba2/xLSTM time loops are the exception in the other direction: a
32768-step scan under DTensor dispatch would take hours on the host.
Each step has the same shapes, so a cell's counts are linear in the
steps: :func:`count_cell` counts the program with the scans cut to
``SCAN_PROBE`` steps and extrapolates each count to the sequence's length
(``peak_bytes`` too, where the scan's per-step outputs grow with the
steps).

A mesh of device type ``cpu`` (the dry-run's) makes DTensor lower a
shard-to-shard move into an all-gather and a chunk (the CPU process group
has no all-to-all): such moves count as all-gathers.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch._guards import active_fake_mode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models import ssm as S

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# the scan lengths counted before extrapolating to a sequence's length
SCAN_PROBE = (2, 4)


def _collective_kinds() -> Dict[Any, str]:
    kinds = {}
    for ns in (torch.ops._c10d_functional,
               torch.ops._c10d_functional_autograd):
        for name, kind in (("all_reduce", "all-reduce"),
                           ("all_reduce_", "all-reduce"),
                           ("all_reduce_coalesced", "all-reduce"),
                           ("all_gather_into_tensor", "all-gather"),
                           ("all_gather_into_tensor_coalesced",
                            "all-gather"),
                           ("all_gather_into_tensor_out", "all-gather"),
                           ("reduce_scatter_tensor", "reduce-scatter"),
                           ("reduce_scatter_tensor_coalesced",
                            "reduce-scatter"),
                           ("all_to_all_single", "all-to-all")):
            if hasattr(ns, name):
                kinds[getattr(ns, name)] = kind
    # DTensor's shard-to-shard move on a GPU mesh
    dtensor = getattr(torch.ops, "_dtensor", None)
    if dtensor is not None and hasattr(dtensor, "shard_dim_alltoall"):
        kinds[dtensor.shard_dim_alltoall] = "all-to-all"
    return kinds


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _propagation(tree, fake_mode_on_entry) -> bool:
    """Whether an op (given its inputs or its output) is DTensor's sharding
    propagation, which runs it on global shapes, under a fake mode of its
    own or on the meta device, to learn its output's metadata: not work of
    this rank."""
    if active_fake_mode() is not fake_mode_on_entry:
        return True
    return any((t if isinstance(t, torch.device) else t.device).type
               == "meta" for t in pytree.tree_leaves(tree)
               if isinstance(t, (torch.Tensor, torch.device)))


class RankMemTracker(MemTracker):
    """``MemTracker`` that leaves DTensor's sharding propagation alone
    (newer torch releases skip it themselves, older ones track it)."""

    def __enter__(self):
        self._rank_fake_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not any(issubclass(t, DTensor) for t in types) and _propagation(
                (args, kwargs), self._rank_fake_mode):
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class CostCounter(TorchDispatchMode):
    """Counts one rank's local ops (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.kinds = _collective_kinds()
        self.flops = 0
        self.op_bytes = 0
        self.collectives = dict.fromkeys(COLLECTIVES, 0)
        self.collective_ops = 0

    def __enter__(self):
        self._fake_mode_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _propagation(out, self._fake_mode_on_entry):
            return out
        packet = func._overloadpacket
        kind = self.kinds.get(packet)
        if kind is not None:
            self.collectives[kind] += _nbytes(out)
            self.collective_ops += 1
        elif func.namespace == "aten" and not func.is_view:
            self.op_bytes += _nbytes((args, kwargs)) + _nbytes(out)
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](*args, **kwargs,
                                                        out_val=out))
        return out

    def record(self) -> Dict[str, Any]:
        coll = dict(self.collectives)
        coll["ops"] = self.collective_ops
        coll["total"] = sum(self.collectives.values())
        return {"flops": self.flops, "op_bytes": self.op_bytes,
                "collectives": coll}


def local_tensors(tree) -> list:
    """Every tensor leaf of ``tree``, a DTensor as its local shard."""
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def argument_bytes(args) -> int:
    """One rank's bytes of a step's arguments: its shard of each DTensor,
    each plain tensor whole, and a host int (a decode step's position) as
    the int32 scalar the JAX package passes in its place."""
    ints = sum(4 for a in pytree.tree_leaves(args)
               if isinstance(a, int) and not isinstance(a, bool))
    return _nbytes(local_tensors(args)) + ints


def _fresh(tree):
    """New lists, tuples and dicts around the same leaves: a step that
    replaces a cache entry in its list leaves the caller's list alone."""
    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(leaves, spec)


def count(fn: Callable, args: Tuple) -> Dict[str, Any]:
    """One run of ``fn(*args)`` on one rank: flops, op bytes, collective
    bytes by kind and the peak of live bytes."""
    args = _fresh(args)
    counter = CostCounter()
    tracker = RankMemTracker()
    tracker.track_external(*local_tensors(args))
    with implicit_replication(), tracker, counter:
        fn(*args)
    rec = counter.record()
    peak = tracker.get_tracker_snapshot("peak")
    rec["peak_bytes"] = sum(int(snap.get("Total", 0))
                            for snap in peak.values())
    return rec


def _extrapolate(a, b, n_a: int, n_b: int, n: int):
    """The value at ``n`` of the line through (n_a, a) and (n_b, b), leaf
    by leaf; exact where the counts are linear in the steps."""
    if isinstance(a, dict):
        return {k: _extrapolate(a[k], b[k], n_a, n_b, n) for k in a}
    return a + (b - a) * (n - n_a) // (n_b - n_a)


def count_cell(cfg, fn: Callable, args: Tuple, steps: int
               ) -> Dict[str, Any]:
    """``count`` of a cell whose scans run ``steps`` time steps: counted
    whole when the config has no scan (``sub_quadratic``) or ``steps`` is
    within ``SCAN_PROBE``, else at each probe length and extrapolated to
    ``steps`` (the record then names the lengths it counted)."""
    n_a, n_b = SCAN_PROBE
    if not cfg.sub_quadratic or steps <= n_b:
        return count(fn, args)
    with S.scan_steps(n_a):
        rec_a = count(fn, args)
    with S.scan_steps(n_b):
        rec_b = count(fn, args)
    rec = _extrapolate(rec_a, rec_b, n_a, n_b, steps)
    rec["scan_steps_counted"] = [n_a, n_b]
    return rec
