"""The kind of cell: serving, a closed loop of clients through the port's
``serve_requests``.  A cell makes its inputs and weights from the seed,
warms every shape it uses up in set-up, measures for the given seconds,
reads a traced segment when asked, frees the program's state and then
judges what the timed path produced against the plain reference.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from torch.profiler import record_function

from cardbench import counts, spec, trace, weights
from cardbench.reference.precision import Precision
from cardbench.traffic import SyntheticLM, percentile


def program_config(config: dict):
    """The port's ``ArchConfig`` of a configuration file's ``arch``."""
    from repro_torch.models.config import ArchConfig
    fields = dict(config["arch"])
    if "block_pattern" in fields:
        fields["block_pattern"] = tuple(fields["block_pattern"])
    return ArchConfig(**fields)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def check(value: float, limit: float) -> Dict[str, float]:
    return {"value": value, "limit": limit}


# -- serving -------------------------------------------------------------------

class Serving:
    """A closed loop of ``clients`` clients: each round hands ``clients``
    new requests (prompts of ``prompt_len`` tokens, ``max_new`` greedy
    tokens) to one call of the program's ``serve_requests``, so a client
    sends its next request when its last one is done."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.launch import serve as program_serve
        self.serve = program_serve
        self.arch = config["arch"]
        self.init = config.get("init")
        self.layout = spec.layout(config)
        self.cfg = program_config(config)
        self.t = traffic
        self.seed = seed
        self.device = device
        b, p = traffic["clients"], traffic["prompt_len"]
        data = SyntheticLM(self.arch["vocab"], p, b, seed, traffic["zipf_a"])
        self.pool = [data.batch(r)["tokens"]
                     for r in range(traffic["pool_rounds"])]
        self.params = weights.make(self.arch, seed, device, self.init,
                                   self.layout)

    def round(self, r: int) -> Dict:
        b, p, n = (self.t["clients"], self.t["prompt_len"],
                   self.t["max_new"])
        prompts = self.pool[r % len(self.pool)]
        reqs = [self.serve.Request(r * b + i, prompts[i], n)
                for i in range(b)]
        handover = time.perf_counter()
        done = self.serve.serve_requests(self.cfg, self.params, reqs, b, p,
                                         n, self.device)
        back = time.perf_counter()
        return {"r": r, "handover": handover, "return": back,
                "requests": done}

    def failed(self, rnd: Dict) -> List[int]:
        """Ids of a round's requests that are missing, have another number
        of tokens than asked, a token outside the vocabulary, or times out
        of order (handover <= start <= first <= done <= return)."""
        n, vocab = self.t["max_new"], self.arch["vocab"]
        ids = {r.rid for r in rnd["requests"]}
        want = range(rnd["r"] * self.t["clients"],
                     (rnd["r"] + 1) * self.t["clients"])
        bad = [i for i in want if i not in ids]
        for r in rnd["requests"]:
            times = (rnd["handover"], r.t_start, r.t_first, r.t_done,
                     rnd["return"])
            if (len(r.generated) != n
                    or any(not 0 <= tok < vocab for tok in r.generated)
                    or any(t is None for t in times)
                    or any(a > b_ for a, b_ in zip(times, times[1:]))):
                bad.append(r.rid)
        return bad

    def traced_rounds(self, first: int) -> Dict:
        """``trace_rounds`` rounds under the profiler, the program's
        prefill and decode step functions inside harness spans."""
        serve = self.serve
        build_prefill, build_decode = (serve.build_prefill_step,
                                       serve.build_serve_step)

        def spanned(build, name):
            def make(cfg):
                fn = build(cfg)

                def call(*args, **kwargs):
                    with record_function(name):
                        return fn(*args, **kwargs)
                return call
            return make

        serve.build_prefill_step = spanned(build_prefill, "prefill")
        serve.build_serve_step = spanned(build_decode, "decode")
        n = self.t["trace_rounds"]
        try:
            with trace.traced(torch.device(self.device).type == "cuda") \
                    as prof:
                for k in range(n):
                    with record_function("round"):
                        with record_function("serve_requests"):
                            self.round(first + k)
                        sync(self.device)
        finally:
            serve.build_prefill_step = build_prefill
            serve.build_serve_step = build_decode
        reduced = trace.reduce(prof)
        b, p = self.t["clients"], self.t["prompt_len"]
        call = counts.k6_call(self.arch, b, p)
        reduced.update(
            rounds=n, prompt_tokens=n * b * p,
            decode_steps=n * (self.t["max_new"] - 1),
            k6_bound_s=n * self.layout.k6_calls_per_prefill(self.arch)
            * call["bound_s"], k6_by=call["by"])
        return reduced

    def judged(self, rounds: List[Dict]) -> Dict:
        """The requests to judge: ``check_requests`` of the window's,
        drawn from the seed among those that came back whole.  Each
        sequence is the prompt and the served tokens but the last; the
        served tokens are judged at the positions that produced them."""
        n = self.t["max_new"]
        every = [r for rnd in rounds for r in rnd["requests"]
                 if len(r.generated) == n]
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 1]))
        k = min(self.t["check_requests"], len(every))
        picked = sorted(rng.choice(len(every), size=k, replace=False))
        p = self.t["prompt_len"]
        seqs = np.stack([np.concatenate([every[i].prompt.astype(np.int64),
                                         np.asarray(every[i].generated[:-1],
                                                    np.int64)])
                         for i in picked])
        served = np.asarray([every[i].generated for i in picked], np.int64)
        return {"seqs": seqs, "served": served,
                "positions": np.arange(p - 1, p + n - 1)}

    def close(self) -> None:
        del self.params
        free(self.device)


def served_gaps(ref, params, judged: Dict, arch: dict, batch: int,
                device, control: Optional[Precision] = None):
    """By how much each served token's reference logit lies below the
    reference's best at its position ``[requests, tokens]``; with a
    ``control`` precision, also the same gap of the token the control,
    run on the same tokens, puts first (``None`` without)."""
    fp32 = Precision("fp32")
    positions = torch.as_tensor(judged["positions"], device=device)
    served = torch.as_tensor(judged["served"], device=device)
    gaps, control_gaps = [], []
    with torch.no_grad():
        for i in range(0, len(judged["seqs"]), batch):
            toks = torch.as_tensor(judged["seqs"][i:i + batch],
                                   device=device)
            with fp32.active():
                lg = ref.position_logits(params, toks, positions, arch,
                                         fp32)
            best = lg.max(dim=-1).values
            gold = torch.gather(lg, -1, served[i:i + batch][..., None])
            gaps.append((best - gold[..., 0]).cpu().numpy())
            if control is not None:
                with control.active():
                    first = ref.position_logits(params, toks, positions,
                                                arch, control).argmax(-1)
                chosen = torch.gather(lg, -1, first[..., None])[..., 0]
                control_gaps.append((best - chosen).cpu().numpy())
            del lg
    return (np.concatenate(gaps),
            np.concatenate(control_gaps) if control is not None else None)


def serve_cell(config: dict, traffic: dict, limits: dict, seed: int,
               seconds: float, traced: bool, device, t_process: float
               ) -> Dict:
    run = Serving(config, traffic, seed, device)
    for w in range(traffic["warm_rounds"]):
        run.round(-1 - w)
    sync(device)
    setup_s = time.perf_counter() - t_process
    rounds = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        rounds.append(run.round(len(rounds)))
    t1 = time.perf_counter()
    window_s = t1 - t0
    reqs = [r for rnd in rounds for r in rnd["requests"]]
    failed = sorted(i for rnd in rounds for i in run.failed(rnd))
    handover = {r.rid: rnd["handover"] for rnd in rounds
                for r in rnd["requests"]}
    ttft = [(r.t_first - handover[r.rid]) * 1e3 for r in reqs]
    b, p, n = traffic["clients"], traffic["prompt_len"], traffic["max_new"]
    e2e = {"setup_s": setup_s,
           "serve_tokens_per_s": sum(len(r.generated) for r in reqs)
           / window_s,
           "ttft_p95_ms": percentile(ttft, 95)}
    window = {"kind": "serve", "window_s": window_s,
              "rounds": [{"t_start": rnd["requests"][0].t_start,
                          "t_first": rnd["requests"][0].t_first,
                          "t_done": max(r.t_done for r in rnd["requests"]),
                          "prompt_tokens": b * p, "decode_steps": n - 1,
                          "prefill_flops": run.layout.prefill_flops(
                              run.arch, b, p)}
                         for rnd in rounds]}
    traced_segment = run.traced_rounds(len(rounds)) if traced else None
    peak = memory_peak(device)
    judged = run.judged(rounds)
    run.close()
    ref = spec.reference(config)
    params = weights.make(config["arch"], seed, device, config.get("init"),
                          run.layout)
    gaps, _ = served_gaps(ref, params, judged, config["arch"],
                          traffic["check_batch"], device)
    del params
    free(device)
    widest = float(gaps.max()) if gaps.size else math.inf
    checks = {"served_gap": check(widest, limits["served_gap"]["limit"])}
    return {"attempted": len(rounds) * b, "failed": len(set(failed)),
            "e2e": e2e, "window": window,
            "trace": traced_segment, "memory_peak_bytes": peak,
            "checks": checks,
            "info": {"round_s": [round(rnd["return"] - rnd["handover"], 4)
                                 for rnd in rounds],
                     "judged_tokens": int(gaps.size),
                     "judged_requests": int(len(judged["seqs"])),
                     "exact_tokens": int((gaps == 0).sum())}}


CELLS = {"serve": serve_cell}
