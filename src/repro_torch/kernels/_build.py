"""Build, load and call the hand-written CUDA kernels (``csrc/ndp.cu``).

The source has a plain C interface, so it is compiled with ``nvcc`` alone
(no PyTorch headers: seconds, not minutes) into a shared library and bound
with ``ctypes``.  The build runs at first use, never at import, into
``build/repro_torch/`` at the root of the checkout; the library's name
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded.
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
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "ndp.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_N = ctypes.c_longlong
# name -> argtypes; every function returns a cudaError_t as int
SIGNATURES = {
    "ndp_bitserial_add_i8": (_P, _P, _P, _N, _P),
    "ndp_bitserial_add_i32": (_P, _P, _P, _N, _P),
    "ndp_bitserial_mul_i8": (_P, _P, _P, _N, _P),
    "ndp_bitserial_mul_i32": (_P, _P, _P, _N, _P),
    "ndp_shift_add_mul_i32": (_P, _P, _P, _N, ctypes.c_int, _P),
    "ndp_mws_i8": (_P, _P, _N, _N, ctypes.c_int, _P),
    "ndp_mws_i32": (_P, _P, _N, _N, ctypes.c_int, _P),
    "ndp_search_i32": (_P, _P, _P, _N, ctypes.c_int, _P),
}


def find_nvcc() -> Optional[str]:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``; None when the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def library_path() -> pathlib.Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libndp-{key}.so"


@functools.lru_cache(maxsize=1)
def build() -> dict:
    """Compile ``ndp.cu`` unless this source's library is already built.

    Returns ``{"path", "seconds", "log"}``: ``seconds`` is 0.0 and ``log``
    empty when the library was already there; ``log`` holds ``ptxas``'s
    per-kernel register and spill report otherwise.
    """
    out = library_path()
    if out.is_file():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)"
                           ": cannot build the CUDA kernels")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds,
            "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
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
    err = getattr(library(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed, cudaError_t "
                           f"{err}")
