"""Public wrappers of the NDP-resource kernels (shape checks + dispatch).

Keeps the JAX package's ``repro.kernels.ops`` contract: 2-D ``[rows,
cols]`` operands of one shape, int8 or int32 (int32 for
``shift_add_mul``), any rows and cols — there is no tiling to pad to.

Dispatch is by where the tensors lie, and nothing else: a CPU tensor is
computed by the kernel's plain PyTorch version (:mod:`.ref`); a CUDA
tensor goes to the hand-written CUDA kernel, which raises if it cannot
launch.  There is no fall-back from one to the other.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import bitserial as _bitserial
from repro_torch.kernels import ref
from repro_torch.kernels import shift_add as _shift_add


def _check(a: torch.Tensor, b: torch.Tensor, dtypes, name: str) -> None:
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"{name}: expected two [rows, cols] operands of one "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in dtypes:
        raise TypeError(f"{name}: expected one dtype of {dtypes}, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")


def bitserial_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b, _bitserial.DTYPES, "bitserial_add")
    if a.is_cuda:
        return _bitserial.bitserial_add(a.contiguous(), b.contiguous())
    return ref.bitserial_add_plain(a, b)


def bitserial_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b, _bitserial.DTYPES, "bitserial_mul")
    if a.is_cuda:
        return _bitserial.bitserial_mul(a.contiguous(), b.contiguous())
    return ref.bitserial_mul_plain(a, b)


def shift_add_mul(a: torch.Tensor, b: torch.Tensor,
                  bits: int = 8) -> torch.Tensor:
    _check(a, b, (torch.int32,), "shift_add_mul")
    if a.is_cuda:
        return _shift_add.shift_add_mul(a.contiguous(), b.contiguous(),
                                        bits=bits)
    return ref.shift_add_mul_plain(a, b, bits)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel."""
    return {"bitserial_add": _bitserial.ADD_LAUNCHES,
            "bitserial_mul": _bitserial.MUL_LAUNCHES,
            "shift_add_mul": _shift_add.LAUNCHES}


def reset_launch_counts() -> None:
    _bitserial.ADD_LAUNCHES = 0
    _bitserial.MUL_LAUNCHES = 0
    _shift_add.LAUNCHES = 0
