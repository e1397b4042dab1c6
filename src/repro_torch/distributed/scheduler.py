"""Conduit for a GPU cluster: the paper's six-feature cost function lifted
to distributed execution planning.

The counterpart of the JAX package's ``repro/distributed/scheduler.py``,
its arithmetic line for line, with the H100's constants
(:mod:`repro_torch.hw.gpu_spec`) in place of the TPU's.  A GPU cluster is
also a set of heterogeneous compute/memory resources (tensor cores, CUDA
cores, HBM, the host tier, NVLink and the network).  For a (model, shape,
mesh) the scheduler scores *candidate execution plans* — sharding layout
choices, remat policy, logits chunking, gradient compression — with the
same feature structure Conduit applies per instruction:

  operation type        -> FLOP class mix (matmul vs elementwise vs gather)
  operand location      -> resident vs needs-all-gather vs host-offloaded
  data dependence delay -> non-overlappable fraction of collectives
  resource queueing     -> per-resource occupancy (tensor cores / HBM / links)
  data movement cost    -> reshard + offload bytes over link bandwidth
  computation latency   -> analytic roofline terms per resource

  total_latency(plan) = max(compute, memory) + exposed_collectives        (1')
  plan* = argmin_plan total_latency                                        (2')

Eqn (1') is the pipelined analogue of the paper's Eqn 1: compute and
memory overlap on-chip (max), while the non-overlapped collective fraction
adds like the paper's movement term.  Collectives move at the spec's
``collective_bw`` (the NIC's, for the 16-wide axes of the production
mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.hw.gpu_spec import H100, GPUSpec
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class CandidatePlan:
    name: str
    # sharding knobs
    fsdp_weights: bool = True          # shard weights over data axis
    seq_shard_cache: bool = True       # KV caches sharded over sequence
    vocab_shard_logits: bool = True    # logits sharded over model axis
    # schedule knobs
    remat: bool = True
    logits_chunk: int = 0              # 0 = no chunking
    grad_compression: bool = False     # INT8 + error feedback on pod axis
    microbatches: int = 1
    activation_shard_model: bool = True

    def describe(self) -> str:
        on = [k for k, v in dataclasses.asdict(self).items()
              if v and k != "name"]
        return f"{self.name}: " + ", ".join(on)


@dataclasses.dataclass
class PlanEstimate:
    plan: CandidatePlan
    compute_s: float
    memory_s: float
    collective_s: float
    exposed_collective_s: float
    hbm_gb: float
    total_s: float
    feasible: bool
    notes: str = ""


def default_candidates() -> List[CandidatePlan]:
    return [
        CandidatePlan("baseline"),
        CandidatePlan("no-remat", remat=False),
        CandidatePlan("chunked-logits", logits_chunk=8),
        CandidatePlan("compressed-grads", grad_compression=True),
        CandidatePlan("replicated-weights", fsdp_weights=False),
        CandidatePlan("micro4", microbatches=4),
        CandidatePlan("act-replicated", activation_shard_model=False),
    ]


class ConduitScheduler:
    """Analytic planner; napkin math per candidate, argmin per Eqn (2')."""

    def __init__(self, spec: GPUSpec = H100):
        self.spec = spec

    def estimate(self, cfg: ArchConfig, kind: str, global_batch: int,
                 seq_len: int, chips: int, data_par: int, model_par: int,
                 pods: int, plan: CandidatePlan) -> PlanEstimate:
        t = self.spec
        n_active = cfg.active_param_count()
        tokens = global_batch * (seq_len if kind != "decode" else 1)

        # (6) computation latency: model FLOPs + remat recompute
        flops = (6 if kind == "train" else 2) * n_active * tokens
        if kind == "train" and plan.remat:
            flops *= 4.0 / 3.0
        compute_s = flops / (chips * t.peak_bf16_flops)

        # memory term: weight + activation traffic per chip
        weight_bytes = 2 * cfg.param_count() / (model_par *
                                                (data_par if plan.fsdp_weights
                                                 else 1))
        act_bytes_chip = (2 * tokens * cfg.d_model * len(cfg.pattern)
                          / (data_par * pods)
                          / (model_par if plan.activation_shard_model else 1))
        passes = 3 if kind == "train" else 1
        memory_s = passes * (weight_bytes + act_bytes_chip) / t.hbm_bw

        # (2,5) operand location / movement: weight all-gather (FSDP) +
        # gradient reduce-scatter + MoE all-to-all + logits collectives
        coll_bytes = 0.0
        if plan.fsdp_weights:
            coll_bytes += passes * weight_bytes * (data_par - 1) / data_par
        if kind == "train":
            grad_bytes = 2 * cfg.param_count() / (model_par * data_par)
            if plan.grad_compression:
                grad_bytes *= 0.25
            coll_bytes += 2 * grad_bytes
        if cfg.moe:
            coll_bytes += (4 * tokens * cfg.d_model * 2
                           * cfg.experts_per_tok / chips)
        if not plan.vocab_shard_logits and kind == "train":
            coll_bytes += 4 * tokens * cfg.d_model / (data_par * pods)
        if plan.activation_shard_model:
            # per-layer activation all-gathers over the model axis
            coll_bytes += (passes * len(cfg.pattern) * 2 * tokens
                           * cfg.d_model / (data_par * pods)
                           * (model_par - 1) / model_par)
        collective_s = coll_bytes / t.collective_bw

        # (3) dependence: fraction of collectives on the critical path that
        # cannot overlap compute (micro-batching overlaps gradient comms)
        overlap = 0.6 if plan.microbatches > 1 else 0.3
        exposed = collective_s * (1 - overlap)

        # HBM feasibility
        hbm = weight_bytes
        if kind == "train":
            hbm += 5 * weight_bytes          # fp32 master-ish + moments
            hbm += act_bytes_chip * (1 if plan.remat else len(cfg.pattern))
        if kind == "decode":
            kv_per_tok = (2 * cfg.n_kv_heads * cfg.head_dim
                          if not cfg.mla else
                          cfg.kv_lora_rank + cfg.rope_head_dim)
            hbm += (2 * global_batch * seq_len * kv_per_tok
                    * len([b for b in cfg.pattern if b in
                           ("attn", "moe", "xdec")]) / chips)
        if plan.logits_chunk == 0 and kind == "train":
            hbm += 4 * tokens * cfg.vocab / chips / \
                (model_par if plan.vocab_shard_logits else 1)
        feasible = hbm < 0.9 * t.hbm_bytes

        total = max(compute_s, memory_s) + exposed
        return PlanEstimate(plan, compute_s, memory_s, collective_s,
                            exposed, hbm / 1e9, total, feasible)

    def choose(self, cfg: ArchConfig, kind: str, global_batch: int,
               seq_len: int, chips: int, data_par: int, model_par: int,
               pods: int = 1,
               candidates: Optional[List[CandidatePlan]] = None
               ) -> Tuple[PlanEstimate, List[PlanEstimate]]:
        cands = candidates or default_candidates()
        ests = [self.estimate(cfg, kind, global_batch, seq_len, chips,
                              data_par, model_par, pods, c) for c in cands]
        ok = [e for e in ests if e.feasible] or ests
        best = min(ok, key=lambda e: e.total_s)
        return best, ests
