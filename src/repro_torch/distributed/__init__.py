from repro_torch.distributed.scheduler import (CandidatePlan, ConduitScheduler,
                                         PlanEstimate, default_candidates)

__all__ = ["CandidatePlan", "ConduitScheduler", "PlanEstimate",
           "default_candidates"]
