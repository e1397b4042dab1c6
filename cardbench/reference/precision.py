"""How the reference multiplies: in fp32 with TF32 off (the reference),
or in a lower precision for the control of ``correct``: TF32 (for an
fp32 configuration) or fp8 e4m3 (for a bf16 one: every operand of every
product rounded to e4m3 with a scale per row of the contraction, the
product summed in fp32, as an fp8 GEMM with per-row scales computes)."""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

FP8_MAX = 448.0   # the largest finite float8_e4m3fn


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """``mode``: ``fp32`` (the reference), ``tf32`` or ``fp8``."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a [..., K] @ b [K, N]``."""
        a, b = a.float(), b.float()
        if self.mode == "fp8":
            a, b = _fp8(a, -1), _fp8(b, 0)
        return a @ b

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a [..., M, K] @ b [..., K, N]``."""
        if self.mode == "fp8":
            a, b = _fp8(a, -1), _fp8(b, -2)
        return a @ b

    @contextlib.contextmanager
    def active(self) -> Iterator[None]:
        """TF32 on for ``tf32``, off otherwise; the flags restored."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved
