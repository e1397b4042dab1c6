"""Batched serving driver: batched prefill, then greedy decode, over a
request queue.

The counterpart of the JAX package's ``repro/launch/serve.py``: requests
with prompts of one length are taken from the queue a batch at a time; the
batch is prefilled once, then decoded step by step, each request retiring
at its token budget.  Reports throughput and per-request latency
percentiles, and the wall time spent in prefill (each batch up to its
first tokens on the host) and in decode.  Any ``--arch`` serves; as in
the JAX package's loop, the prompts carry no modality stubs, so a VLM
serves text alone and an encoder-decoder decodes without
cross-attention (the steps of :mod:`repro_torch.launch.steps` take the
stubs where a caller has them).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --requests 16 --batch 4 --max-new 16 [--full] [--device cpu]

It runs on the GPU unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs, spans
from repro_torch.device import resolve_device
from repro_torch.launch import graphs
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.sim.stats import percentile


class Request:
    def __init__(self, rid: int, prompt: np.ndarray, max_new: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.generated: List[int] = []
        self.t_arrive: Optional[float] = None  # serve_requests took it
        self.t_start: Optional[float] = None   # its batch's prefill began
        self.t_first: Optional[float] = None   # its first token on the host
        self.t_done: Optional[float] = None


def make_requests(cfg: ArchConfig, n_requests: int, prompt_len: int,
                  max_new: int, seed: int = 0) -> List[Request]:
    """The JAX package's requests: prompts drawn in order from numpy's
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab, size=prompt_len,
                                    dtype=np.int32), max_new)
            for i in range(n_requests)]


def serve_requests(cfg: ArchConfig, params: M.Params,
                   requests: Sequence[Request], batch: int, prompt_len: int,
                   max_new: int, device: torch.device | str
                   ) -> List[Request]:
    """The JAX package's serving loop: returns the requests, finished, with
    their greedy tokens in ``generated``, in the order they were served.
    Decode step ``step`` writes position ``prompt_len + step``; ``argmax``
    takes the first index on a tie, as ``jnp.argmax`` does."""
    if max_new < 1:
        raise ValueError(f"max_new must be at least 1, got {max_new}")
    prefill_fn = build_prefill_step(cfg)
    serve_fn = build_serve_step(cfg)
    max_seq = prompt_len + max_new
    taken = time.perf_counter()
    for r in requests:
        r.t_arrive = taken
    queue = list(requests)
    done: List[Request] = []
    with spans.under_profiler():
        while queue:
            active = [queue.pop(0) for _ in range(min(batch, len(queue)))]
            with spans.batch(active):
                _serve_batch(cfg, params, active, prefill_fn, serve_fn,
                             prompt_len, max_new, max_seq, device)
            done.extend(active)
    return done


def _serve_batch(cfg: ArchConfig, params: M.Params, active: List[Request],
                 prefill_fn, serve_fn, prompt_len: int, max_new: int,
                 max_seq: int, device: torch.device | str) -> None:
    """Prefill ``active`` once, then decode until each has its tokens.
    The span ``serve.prefill`` runs from ``t_start`` to ``t_first``, the
    same clock readings; each ``serve.decode_step`` from its step's launch
    to its tokens on the host."""
    t_ns = time.perf_counter_ns()
    t_start = t_ns / 1e9
    pending = spans.begin("serve.prefill", t_ns)   # ended by its sync
    tokens = torch.from_numpy(np.stack([r.prompt for r in active])).to(
        device=device, dtype=torch.int64)
    with spans.span("serve.cache_init"):
        caches = graphs.init_cache(cfg, params, len(active), max_seq,
                                   device)
    with spans.span("model.prefill"):
        logits, caches = prefill_fn(params, caches, {"tokens": tokens})
        nxt = torch.argmax(logits[:, -1], dim=-1)
    for step in range(max_new):
        with spans.span("serve.sync"):
            toks = nxt.tolist()                 # waits for the device
        now_ns = time.perf_counter_ns()
        spans.end(pending, now_ns)
        now = now_ns / 1e9
        for r, tok in zip(active, toks):
            if r.t_start is None:
                r.t_start, r.t_first = t_start, now
            if r.t_done is None:
                r.generated.append(tok)
                if len(r.generated) >= r.max_new:
                    r.t_done = time.perf_counter()
        if all(r.t_done is not None for r in active):
            break
        pending = spans.begin("serve.decode_step")
        with spans.span("model.decode"):
            logits, caches = serve_fn(params, caches, nxt, prompt_len + step)
            nxt = torch.argmax(logits, dim=-1)
    spans.end(pending)
    for r in active:
        if r.t_done is None:
            r.t_done = time.perf_counter()


def serve(arch: str, n_requests: int, batch: int, prompt_len: int,
          max_new: int, reduced: bool = True, seed: int = 0,
          device: Optional[torch.device | str] = None) -> dict:
    """Serve ``n_requests`` random prompts with a model of ``arch``
    initialised from ``seed``; ``device=None`` means the GPU."""
    device = resolve_device(device)
    cfg = configs.get(arch)
    if reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = M.init_params(cfg, gen)
    requests = make_requests(cfg, n_requests, prompt_len, max_new, seed)
    t0 = time.perf_counter()
    done = serve_requests(cfg, params, requests, batch, prompt_len, max_new,
                          device)
    wall = time.perf_counter() - t0
    total_tokens = sum(len(r.generated) for r in done)
    lat = [(r.t_done - r.t_arrive) * 1e3 for r in done]
    # the requests of one batch share t_start and t_first
    batches = [done[i:i + batch] for i in range(0, len(done), batch)]
    return {
        "requests": len(done),
        "tokens": total_tokens,
        "tokens_per_s": total_tokens / wall,
        "wall_s": wall,
        "latency_ms_p50": percentile(lat, 50),
        "latency_ms_p99": percentile(lat, 99),
        "prefill_s": sum(g[0].t_first - g[0].t_start for g in batches),
        "decode_s": sum(max(r.t_done for r in g) - g[0].t_first
                        for g in batches),
        "device": str(device),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=configs.ARCHS)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU")
    args = ap.parse_args()
    res = serve(args.arch, args.requests, args.batch, args.prompt_len,
                args.max_new, reduced=not args.full, device=args.device)
    for k, v in res.items():
        print(f"  {k}: {v:.2f}" if isinstance(v, float) else f"  {k}: {v}")


if __name__ == "__main__":
    main()
