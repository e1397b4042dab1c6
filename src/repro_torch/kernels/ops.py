"""Public wrappers of the NDP-resource kernels (shape checks + dispatch).

Keeps the JAX package's ``repro.kernels.ops`` contract: 2-D ``[rows,
cols]`` operands of one shape, int8 or int32 (int32 for
``shift_add_mul``); a ``[n_ops, rows, cols]`` int8 or int32 stack for
``mws_bitwise``; an int32 ``[rows, words]`` stack and ``[wpr]`` query
for ``search_pages``; int8 ``[M, K]`` and ``[K, N]`` for ``int8_matmul``;
fp32 or bf16 ``q [H, Sq, dh]``, ``k, v [H, Sk, dh]`` with dh 16, 32, 64
or 128 for ``flash_attention``.  Any rows and cols, any Sq and Sk — there
is no tiling to pad to.

Dispatch is by where the tensors lie, and nothing else: a CPU tensor is
computed by the kernel's plain PyTorch version (:mod:`.ref`); a CUDA
tensor goes to the hand-written CUDA kernel, which raises if it cannot
launch.  There is no fall-back from one to the other.
"""
from __future__ import annotations

from typing import Dict

import math

import torch

from repro_torch.kernels import attention as _attention
from repro_torch.kernels import bitserial as _bitserial
from repro_torch.kernels import int8_matmul as _int8_matmul
from repro_torch.kernels import mws as _mws
from repro_torch.kernels import ref
from repro_torch.kernels import search as _search
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


def mws_bitwise(stack: torch.Tensor, op: str = "and") -> torch.Tensor:
    """Bulk bitwise reduce of stacked pages (Flash-Cosmos MWS)."""
    if stack.ndim != 3:
        raise ValueError(f"mws_bitwise: expected [n_ops, rows, cols], got "
                         f"{tuple(stack.shape)}")
    if stack.dtype not in _mws.DTYPES:
        raise TypeError(f"mws_bitwise: expected one dtype of {_mws.DTYPES}, "
                        f"got {stack.dtype}")
    if op not in _mws.OPS:
        raise ValueError(f"mws_bitwise: op {op!r} not one of {_mws.OPS}")
    if stack.is_cuda:
        return _mws.mws_bitwise(stack.contiguous(), op)
    return ref.mws_plain(stack, op)


def search_pages(stack: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """In-flash exact-match search (§7 extensibility kernel)."""
    if stack.ndim != 2 or query.ndim != 1:
        raise ValueError(f"search_pages: expected [rows, words] and [wpr], "
                         f"got {tuple(stack.shape)} and {tuple(query.shape)}")
    if stack.dtype != torch.int32 or query.dtype != torch.int32:
        raise TypeError(f"search_pages: expected int32, got {stack.dtype} "
                        f"and {query.dtype}")
    if query.shape[0] < 1 or stack.shape[1] % query.shape[0]:
        raise ValueError(f"search_pages: {stack.shape[1]} words per row do "
                         f"not hold records of {query.shape[0]} words")
    if stack.device != query.device:
        raise ValueError(f"search_pages: operands on {stack.device} and "
                         f"{query.device}")
    if stack.is_cuda:
        return _search.search_pages(stack.contiguous(), query.contiguous())
    return ref.search_plain(stack, query)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """INT8 GEMM with int32 accumulation (the LLM workloads' §5.4 lanes)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul: expected [M, K] and [K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if min(*a.shape, b.shape[1]) < 1:
        raise ValueError(f"int8_matmul: empty operand, {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul: expected int8, got {a.dtype} and "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"int8_matmul: operands on {a.device} and "
                         f"{b.device}")
    if a.is_cuda:
        return _int8_matmul.int8_matmul(a.contiguous(), b.contiguous())
    return ref.int8_matmul_plain(a, b)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Attention over ``q [H, Sq, dh]``, ``k, v [H, Sk, dh]`` with an
    online softmax; ``scale`` defaults to 1/sqrt(dh); the causal mask keeps
    ``q_pos >= k_pos`` (top-left, as the JAX package's kernel).

    Forward only: the kernel has no backward, as the JAX package's has no
    VJP, so a call that autograd would record raises ``RuntimeError`` on
    every device (a gradient through the plain version would hold on the
    CPU only).  Training attends through the chunked einsum path of
    ``models/layers.py``."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention: expected q [H, Sq, dh] and k, v "
                         f"[H, Sk, dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] not in _attention.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {q.shape[2]} not one "
                         f"of {_attention.HEAD_DIMS}")
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError(f"flash_attention: empty sequence, Sq "
                         f"{q.shape[1]}, Sk {k.shape[1]}")
    if len({q.dtype, k.dtype, v.dtype}) != 1 or \
            q.dtype not in _attention.DTYPES:
        raise TypeError(f"flash_attention: expected one dtype of "
                        f"{_attention.DTYPES}, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_attention: operands on {q.device}, "
                         f"{k.device} and {v.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: the kernel (K6) has no backward, in the JAX "
            "package as here; call it under torch.no_grad() or on tensors "
            "that do not require grad, and train through the einsum path "
            "(models/layers.py _sdpa with flash=False)")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    if q.is_cuda:
        return _attention.flash_attention(q.contiguous(), k.contiguous(),
                                          v.contiguous(), causal, scale)
    return ref.flash_attention_plain(q, k, v, causal, scale)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel."""
    return {"bitserial_add": _bitserial.ADD_LAUNCHES,
            "bitserial_mul": _bitserial.MUL_LAUNCHES,
            "shift_add_mul": _shift_add.LAUNCHES,
            "mws_bitwise": _mws.LAUNCHES,
            "search_pages": _search.LAUNCHES,
            "int8_matmul": _int8_matmul.LAUNCHES,
            "flash_attention": _attention.LAUNCHES}


def reset_launch_counts() -> None:
    _bitserial.ADD_LAUNCHES = 0
    _bitserial.MUL_LAUNCHES = 0
    _shift_add.LAUNCHES = 0
    _mws.LAUNCHES = 0
    _search.LAUNCHES = 0
    _int8_matmul.LAUNCHES = 0
    _attention.LAUNCHES = 0
