"""Input-shape sets assigned to the LM-family architectures (40 cells).

  train_4k     seq_len=4096   global_batch=256   (training)
  prefill_32k  seq_len=32768  global_batch=32    (inference prefill)
  decode_32k   seq_len=32768  global_batch=128   (decode: 1 new token / KV)
  long_500k    seq_len=524288 global_batch=1     (long-context decode;
                                                  sub-quadratic archs only)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def applicable(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell; else (False, reason).

    long_500k requires sub-quadratic attention — pure full-attention archs
    skip it (recorded in EXPERIMENTS.md §Dry-run), SSM/hybrid archs run it.
    """
    spec = SHAPES[shape]
    if spec.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skip: pure full-attention architecture — 524k-token "
                       "decode shape is assigned to sub-quadratic archs only")
    return True, ""
