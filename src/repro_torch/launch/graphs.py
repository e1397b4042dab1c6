"""The serving decode step as one CUDA graph, captured once and replayed.

An eager decode step of the port is about two thousand small launches
from Python (zamba2-1.2b at 32 x 1149: 1,983), and the card waits for the
host between them.  :func:`decode`, the serving step, replays a CUDA
graph of ``models/model.py`` ``decode_step`` instead on a CUDA device
where ``decode_capturable`` holds (``decode_step``'s docstring gives the
conditions); every other step runs eagerly, as on the CPU.

One graph is held in the process at a time.  It is made at the first
step on caches that it does not hold, and those caches become its
buffers: prefill and every step write the keys, values, MLA latents and
Mamba2 states in place, so a batch keeps its buffers from prefill to its last
token.  Its first ``WARMUP_STEPS`` steps run eagerly (they load every
kernel and library handle the step uses, which a capture cannot do);
the next step is captured, under a private spans recording, and
replayed, as is every later one.  A step on other caches, another
config or other parameters frees the graph and starts a new one.  The
serving loop takes a batch's caches from :func:`init_cache`: the held
graph's buffers, zeroed, where the batch fits the graph, so one capture
serves every batch of a shape.  The graph reads the parameters where
they lie; it holds them weakly and goes when they do.

Counters (:mod:`repro_torch.spans`), while spans record: a step counts
``graph.replays``, 1 a replay and 0 an eager step, beside what its code
counts; a replay adds what the captured step counted (``attn.cast_bytes``,
``mla.cache_bytes``, ``ssm.scan_steps``, ``ssm.scan_kernel_steps``); a
capture counts ``graph.captures`` 1.  A replayed step has no ``block.*``,
``mla``, ``moe``, ``ssm.scan`` or ``model.head`` spans: its host runs none
of that code.  The kernels' launch counters (``ops.launch_counts``) count
the wrappers' launches, the eager steps' and the capture's; a replay runs
no wrapper, and only a device trace sees the kernels it runs.
"""
from __future__ import annotations

import itertools
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch import spans
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig

WARMUP_STEPS = 3


def engages(cfg: ArchConfig, device: torch.device | str) -> bool:
    """Whether the serving decode step of ``cfg`` on ``device`` replays a
    graph: a CUDA device and ``M.decode_capturable``."""
    return (torch.device(device).type == "cuda"
            and M.decode_capturable(cfg))


def _max_seq(caches) -> Optional[int]:
    """The cache length of the first KV or MLA latent cache, if any."""
    for c in caches:
        for key in ("k", "latent"):
            if key in c:
                return c[key].shape[1]
    return None


class DecodeGraph:
    """The decode step of ``cfg`` with ``params`` on ``caches``, which it
    keeps as its buffers: eager for ``WARMUP_STEPS`` steps, then captured
    and replayed."""

    def __init__(self, cfg: ArchConfig, params: M.Params, caches,
                 token: torch.Tensor):
        self.cfg, self.params_id = cfg, id(params)
        self.serial = next(_SERIALS)
        self.caches = [dict(c) for c in caches]
        self.token = torch.zeros_like(token)
        self.index = torch.zeros((), dtype=torch.int64, device=token.device)
        self.eager_steps = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.counts: Dict[str, int] = {}
        # the graph goes when the parameters do, with its buffers
        weakref.finalize(pytree.tree_leaves(params)[0], _release,
                         self.serial)

    def serves(self, cfg: ArchConfig, params: M.Params, caches) -> bool:
        """Whether a step of ``cfg`` with ``params`` on ``caches`` is this
        graph's: the caches are its buffers, tensor for tensor."""
        return (id(params) == self.params_id and cfg == self.cfg
                and len(caches) == len(self.caches)
                and all(c.keys() == mine.keys()
                        and all(c[k] is t for k, t in mine.items())
                        for c, mine in zip(caches, self.caches)))

    def fits(self, cfg: ArchConfig, params: M.Params, batch: int,
             max_seq: int, device: torch.device | str) -> bool:
        """Whether a batch of ``batch`` rows and ``max_seq`` positions can
        be served on this graph's buffers."""
        device = torch.device(device)
        return (id(params) == self.params_id and cfg == self.cfg
                and self.token.shape[0] == batch
                and _max_seq(self.caches) in (None, max_seq)
                and device.type == self.token.device.type
                and device.index in (None, self.token.device.index))

    def _step(self, params: M.Params):
        with torch.no_grad():
            logits, out = M.decode_step(self.cfg, params, self.token,
                                        self.index, list(self.caches))
        if not self.serves(self.cfg, params, out):
            raise RuntimeError("decode graph: a step left a cache or state "
                               "outside the graph's buffers")
        return logits

    def _capture(self, params: M.Params) -> None:
        self.graph = torch.cuda.CUDAGraph()
        with spans.private() as rec:
            with torch.cuda.graph(self.graph):
                self.logits = self._step(params)
        for c in rec.counters():
            self.counts[c["name"]] = self.counts.get(c["name"], 0) \
                + c["value"]
        spans.count("graph.captures", 1)

    def __call__(self, params: M.Params, token: torch.Tensor, index):
        self.token.copy_(token)
        self.index.fill_(index)
        if self.graph is None and self.eager_steps < WARMUP_STEPS:
            self.eager_steps += 1
            return self._step(params), [dict(c) for c in self.caches]
        if self.graph is None:
            self._capture(params)
        self.graph.replay()
        if spans.on():
            for name, n in self.counts.items():
                spans.count(name, n)
        return self.logits.clone(), [dict(c) for c in self.caches]


_HELD: List[Optional[DecodeGraph]] = [None]
_SERIALS = itertools.count()


def _release(serial: Optional[int] = None) -> None:
    """Frees the held graph (only the one of ``serial``, where given)."""
    graph = _HELD[0]
    if graph is not None and serial in (None, graph.serial):
        _HELD[0] = None


def init_cache(cfg: ArchConfig, params: M.Params, batch: int, max_seq: int,
               device: torch.device | str):
    """A serving batch's caches: the held graph's buffers, zeroed as
    ``M.init_cache`` makes them, where the batch fits the graph; else
    ``M.init_cache``'s."""
    graph = _HELD[0]
    if graph is None or not (engages(cfg, device) and graph.fits(
            cfg, params, batch, max_seq, device)):
        return M.init_cache(cfg, batch, max_seq, device)
    for c in graph.caches:
        for t in c.values():
            t.zero_()
    return [dict(c) for c in graph.caches]


def decode(cfg: ArchConfig, params: M.Params, caches, token: torch.Tensor,
           index, enc_out: Optional[torch.Tensor] = None):
    """One serving decode step; returns (logits, caches).  Where
    :func:`engages` holds, through the held graph, made anew where the
    step is not the held graph's; else ``decode_step``, eagerly."""
    replayed = 0
    if engages(cfg, token.device):
        graph = _HELD[0]
        if graph is None or not graph.serves(cfg, params, caches):
            _release()
            graph = _HELD[0] = DecodeGraph(cfg, params, caches, token)
        out = graph(params, token, index)
        replayed = int(graph.graph is not None)
    else:
        out = M.decode_step(cfg, params, token, index, caches,
                            enc_out=enc_out)
    spans.count("graph.replays", replayed)
    return out
