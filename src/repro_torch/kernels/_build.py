"""Build, load and call the hand-written CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface, so it is compiled with ``nvcc`` alone
(no PyTorch headers: seconds, not minutes) into a shared library of its
own and bound with ``ctypes``.  The build runs at first use, never at
import, into ``build/repro_torch/`` at the root of the checkout, one
``nvcc`` per source, all started together; a library's name carries a
hash of its source and the flags, so an edited source is rebuilt and a
stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
# source stem -> {C entry point -> argtypes}; every entry point returns an
# int: a cudaError_t, for *_smem_bytes a byte count, for *_plan 0
SIGNATURES = {
    "ndp": {
        "ndp_bitserial_add_i8": (_P, _P, _P, _N, _P),
        "ndp_bitserial_add_i32": (_P, _P, _P, _N, _P),
        "ndp_bitserial_mul_i8": (_P, _P, _P, _N, _P),
        "ndp_bitserial_mul_i32": (_P, _P, _P, _N, _P),
        "ndp_shift_add_mul_i32": (_P, _P, _P, _N, _I, _P),
        "ndp_mws_i8": (_P, _P, _N, _N, _I, _P),
        "ndp_mws_i32": (_P, _P, _N, _N, _I, _P),
        "ndp_search_i32": (_P, _P, _P, _N, _I, _P),
        "ndp_int8_matmul": (_P, _P, _P, _N, _N, _N, _I, _P),
        "ndp_int8_matmul_plan": (_N, _N, _N, _I, _IP),
    },
    # q, k, v, out, heads, sq, sk, dh, dv, causal, scale * log2(e), stream
    "attention": {
        "ndp_flash_attn_f32": (_P, _P, _P, _P, _N, _N, _N, _I, _I, _I, _F,
                               _P),
        "ndp_flash_attn_bf16": (_P, _P, _P, _P, _N, _N, _N, _I, _I, _I, _F,
                                _P),
        "ndp_flash_attn_bf16_smem_bytes": (_I, _I),
    },
    # dt, u, B, C, a, h0, y, h, batch, steps, di, n, B's and C's batch and
    # step strides, stream
    "scan": {
        "ndp_selective_scan_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _N, _N,
                                   _N, _I, _N, _N, _N, _N, _P),
    },
}
_SOURCE_OF = {fn: stem for stem, fns in SIGNATURES.items() for fn in fns}


def find_nvcc() -> Optional[str]:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``; None when the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def library_path(stem: str) -> pathlib.Path:
    source = CSRC / f"{stem}.cu"
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{stem}-{key}.so"


@functools.lru_cache(maxsize=1)
def build() -> Dict[str, dict]:
    """Compile every source of :data:`SIGNATURES` whose library is not
    built yet, one ``nvcc`` per source, all running at once.

    Returns ``{stem: {"path", "seconds", "log"}}``: ``seconds`` is 0.0 and
    ``log`` empty for a library that was already there; ``log`` holds
    ``ptxas``'s per-kernel register and spill report otherwise.
    """
    result, running = {}, {}
    for stem in SIGNATURES:
        out = library_path(stem)
        if out.is_file():
            result[stem] = {"path": str(out), "seconds": 0.0, "log": ""}
            continue
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError("nvcc not found (PATH, CUDA_HOME, "
                               "/usr/local/cuda): cannot build the CUDA "
                               "kernels")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[stem] = (proc, tmp, out, time.perf_counter())
    failed = []
    for stem, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
        result[stem] = {"path": str(out), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return result


@functools.lru_cache(maxsize=None)
def library(stem: str) -> ctypes.CDLL:
    """The loaded kernel library of ``csrc/<stem>.cu``, built first (with
    every other source) if need be."""
    lib = ctypes.CDLL(build()[stem]["path"])
    for name, argtypes in SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_operands(name: str, dtypes, *tensors) -> None:
    """Raise unless ``tensors`` are what the kernel ``name`` takes:
    contiguous CUDA tensors on one device, of one dtype from ``dtypes``."""
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name}: expected CUDA tensors, got "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: operands on "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.dtype for t in tensors}) != 1 or tensors[0].dtype not in dtypes:
        raise TypeError(f"{name}: expected one dtype of {dtypes}, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")


def check_pair(a, b, dtypes, name: str) -> None:
    """:func:`check_operands` for two operands of one shape."""
    check_operands(name, dtypes, a, b)
    if a.shape != b.shape:
        raise ValueError(f"{name}: shapes differ, {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")


def call(fn_name: str, *args) -> None:
    """Call one C entry point; raise if its launch was refused."""
    err = getattr(library(_SOURCE_OF[fn_name]), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed, cudaError_t "
                           f"{err}")
