#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero before the
last line:

1. card   — ``nvidia-smi`` name and power limit, ``torch.cuda`` name/count;
2. build  — ``csrc/ndp.cu`` compiled for sm_90a from this checkout;
3. kernels — each CUDA kernel held exactly equal to its plain PyTorch
   version over the kernel-test grids, the page-scale shape [160, 4096]
   and the shape jacobi1d gives it, with CUDA-event times of the kernel,
   the plain version and the one PyTorch call that computes the same
   function, beside the card's least time for the work;
4. pipeline — jacobi1d at paper scale through the package's entry points:
   numeric run on the card, trace, Table 3 row, ``simulate`` under every
   policy (the conduit makespan must match the JAX package's to the bit);
5. replay — the jacobi1d sweep again on the card with its adds through the
   PuD bit-serial adder and its x85 through the IFP shift-add multiplier
   (then through the bit-serial multiplier); both must equal the numeric
   run bit for bit, and the launch counters must show the kernels ran.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this script, it fails and prints no result.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM's HBM3 rate (NVIDIA data sheet); ops peaks are read off the
# card itself in phase 1
HBM_BYTES_PER_S = 3.35e12
# INT32 lanes per SM on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput: 32-bit integer add, shift,
# and bitwise logic at 64 results per clock per SM)
INT32_OPS_PER_CLOCK_PER_SM = 64

INT_SHAPES = [(8, 128), (16, 256), (8, 512), (24, 384), (64, 128)]
PAGE_SHAPE = (160, 4096)           # jacobi1d paper: one 16 KiB page a row
CONDUIT_MAKESPAN_NS = 11562718.5767338
JACOBI_PAPER_ROW = {"vectorizable_pct": 100.0, "avg_reuse": 2.0,
                    "low_pct": 0, "medium_pct": 67, "high_pct": 33,
                    "instrs": 480}
POLICIES = ("cpu", "isp", "pud", "dm", "bw", "conduit", "ideal")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_report(lib_path: str, nvcc: str) -> None:
    """Print, per kernel, what the compiler made of its gate-level loop:
    SASS instruction count, LOP3/IMAD/SHF counts, and the length of each
    loop body (instructions from a backward branch's target to the
    branch).  Informational: a missing ``cuobjdump`` is reported, not
    fatal."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(tool):
        print(f"  sass: {tool} not found")
        return
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split()[0]
        kernel = re.search(r"\d+([a-z_]+_kernel)I([hj])E", name)
        if kernel:                  # mangled template arg: h uint8, j uint32
            elem = {"h": "u8", "j": "u32"}[kernel.group(2)]
            label = f"{kernel.group(1)}<{elem}>"
        else:
            label = name
        instrs = re.findall(r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\w+\s+)?"
                            r"([A-Z][A-Z0-9_.]*)([^;]*);", chunk)
        ops = [op.split(".")[0] for _, op, _ in instrs]
        loops = []
        for addr, op, rest in instrs:
            target = re.match(r"\s*(0x[0-9a-f]+)", rest)
            if op.startswith("BRA") and target and \
                    int(target.group(1), 16) < int(addr, 16):
                loops.append((int(addr, 16) - int(target.group(1), 16))
                             // 16 + 1)
        real = [o for o in ops if o != "NOP"]
        print(f"  sass {label}: {len(real)} instructions, LOP3 "
              f"{ops.count('LOP3')}, IMAD {ops.count('IMAD')}, SHF "
              f"{ops.count('SHF')}; loop bodies {sorted(loops)}")


def time_ms(fn, reps: int, clock_hz: float, rounds: int = 5) -> float:
    """Device time of one call of ``fn``, in ms: the median over ``rounds``
    of CUDA events around ``reps`` back-to-back calls, averaged.  Each
    round is queued behind a device-side sleep longer than the host needs
    to enqueue it, so the host's launch overhead stays out of the device's
    timeline (where a call is thousands of launches, as in the plain
    versions, the host still paces the device once the queue is full)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * reps * host_s * clock_hz) + 100_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def rand(rng, shape, dtype):
    lo, hi = ((-128, 128) if dtype == np.int8 else (-2 ** 30, 2 ** 30))
    return torch.from_numpy(
        rng.integers(lo, hi, size=shape, dtype=dtype)).cuda()


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.sim import simulate
    from repro_torch.workloads import (get_trace, jacobi1d, make_inputs,
                                       run_numeric)

    # -- 1. card ----------------------------------------------------------
    phase("card")
    card = nvidia_smi("name,power.limit")
    print(card)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int32_ops_per_s = sms * INT32_OPS_PER_CLOCK_PER_SM * max_sm_mhz * 1e6
    print(f"torch.cuda: {kind} x{count}, {sms} SMs, max SM clock "
          f"{max_sm_mhz:.0f} MHz -> INT32 peak {int32_ops_per_s:.4g} op/s; "
          f"HBM {HBM_BYTES_PER_S:.4g} B/s; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}")

    # -- 2. build ---------------------------------------------------------
    phase("build")
    info = _build.build()
    print(f"built {info['path']} in {info['seconds']:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    _build.library()
    sass_report(info["path"], _build.find_nvcc())

    # -- 3. kernels vs plain versions --------------------------------------
    phase("kernels")
    rng = np.random.default_rng(42)
    cases = []                                  # (kernel, dtype, shape, bits)
    for dt in (np.int32, np.int8):
        for shape in INT_SHAPES:
            cases.append(("bitserial_add", dt, shape, None))
        for shape in INT_SHAPES[:3]:
            cases.append(("bitserial_mul", dt, shape, None))
    for bits in (4, 8):
        for shape in INT_SHAPES[:3] + [PAGE_SHAPE]:
            cases.append(("shift_add_mul", np.int32, shape, bits))
    cases += [("bitserial_add", np.int32, PAGE_SHAPE, None),
              ("bitserial_mul", np.int32, PAGE_SHAPE, None)]
    kernel_fn = {"bitserial_add": lambda a, b, bits: ops.bitserial_add(a, b),
                 "bitserial_mul": lambda a, b, bits: ops.bitserial_mul(a, b),
                 "shift_add_mul": lambda a, b, bits:
                     ops.shift_add_mul(a, b, bits=bits)}
    plain_fn = {"bitserial_add": lambda a, b, bits:
                    ref.bitserial_add_plain(a, b),
                "bitserial_mul": lambda a, b, bits:
                    ref.bitserial_mul_plain(a, b),
                "shift_add_mul": lambda a, b, bits:
                    ref.shift_add_mul_plain(a, b, bits)}
    for name, dt, shape, bits in cases:
        a, b = rand(rng, shape, dt), rand(rng, shape, dt)
        got = kernel_fn[name](a, b, bits)
        want = plain_fn[name](a, b, bits)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {np.dtype(dt).name} {shape} "
                                 f"bits={bits}: kernel != plain version")
    print(f"{len(cases)} cases: every kernel equal to its plain version")

    # timing at the shape the jacobi1d replay gives each kernel (n - 2
    # points of one sweep as one [1, n - 2] row) and at the page shape.
    # Bound: the least time for the function each kernel computes (a + b,
    # a * b, a * (b & 255)): its bytes over HBM, or its 1-2 int ops per
    # element over the INT32 peak, whichever is larger.  The gate-level
    # loop's own op count (3W+1, W(6W+5), 5 * bits per element) is printed
    # beside it: it is the model's method, and the compiler already does
    # less than it (dead carry rounds are known zero), so it bounds nothing.
    n = jacobi1d.SCALES["paper"]["n"] - 2
    w = 32                                       # int32 lanes
    function_ops = {"bitserial_add": 1, "bitserial_mul": 1,
                    "shift_add_mul": 2}
    gate_ops = {"bitserial_add": 3 * w + 1, "bitserial_mul": w * (6 * w + 5),
                "shift_add_mul": 5 * 8}
    library = {"bitserial_add": torch.add, "bitserial_mul": torch.mul,
               "shift_add_mul": None}
    replaces = {"bitserial_add": "src/repro/kernels/bitserial.py:19",
                "bitserial_mul": "src/repro/kernels/bitserial.py:34",
                "shift_add_mul": "src/repro/kernels/shift_add.py:21"}
    clock_hz = max_sm_mhz * 1e6
    records = {}
    for shape_name, shape in (("jacobi1d", (1, n)), ("page", PAGE_SHAPE)):
        for name in ("bitserial_add", "bitserial_mul", "shift_add_mul"):
            a, b = rand(rng, shape, np.int32), rand(rng, shape, np.int32)
            if name == "shift_add_mul":
                b = torch.full_like(a, 85)      # the x85 the sweep sends
            got = kernel_fn[name](a, b, 8)
            want = plain_fn[name](a, b, 8)
            err = int((got.long() - want.long()).abs().max())
            ms = time_ms(lambda: kernel_fn[name](a, b, 8), 50,
                         clock_hz)
            plain_ms = time_ms(lambda: plain_fn[name](a, b, 8), 2,
                               clock_hz, rounds=3)
            lib = library[name]
            lib_ms = (time_ms(lambda: lib(a, b), 50, clock_hz)
                      if lib is not None else None)
            elems = a.numel()
            bytes_ms = 3 * elems * a.element_size() / HBM_BYTES_PER_S * 1e3
            ops_ms = function_ops[name] * elems / int32_ops_per_s * 1e3
            gate_ms = gate_ops[name] * elems / int32_ops_per_s * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            print(f"{name:14s} {shape_name:8s} {str(shape):14s} "
                  f"kernel {ms:.6f} ms  plain {plain_ms:.6f} ms  library "
                  f"{lib_ms if lib_ms is None else f'{lib_ms:.6f}'} ms  "
                  f"bound {bound_ms:.6f} ms ({bound_by}; ops "
                  f"{ops_ms:.6f}; gate-level ops at INT32 peak "
                  f"{gate_ms:.6f})  max_abs_err {err}", flush=True)
            if err != 0:
                raise AssertionError(f"{name}: kernel != plain version")
            if shape_name == "jacobi1d":
                records[name] = {
                    "name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/ndp.cu",
                    "replaces": replaces[name], "launches": 0,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms}

    # -- 4. pipeline: jacobi1d paper through the entry points ---------------
    phase("pipeline")
    ops.reset_launch_counts()
    a, b = make_inputs("jacobi1d", "paper")
    if not (a.is_cuda and b.is_cuda):
        raise AssertionError("make_inputs did not place the inputs on the card")
    numeric = run_numeric("jacobi1d", "paper")
    torch.cuda.synchronize()
    if not (numeric.is_cuda and numeric.shape == a.shape
            and numeric.dtype == torch.int32):
        raise AssertionError(f"run_numeric gave {numeric.device} "
                             f"{tuple(numeric.shape)} {numeric.dtype}")
    trace = get_trace("jacobi1d", "paper")
    row = trace.characterize().as_row()
    print("characterize:", json.dumps(row))
    if row != JACOBI_PAPER_ROW:
        raise AssertionError(f"Table 3 row {row} != {JACOBI_PAPER_ROW}")
    for policy in POLICIES:
        r = simulate(trace, policy)
        mix = {k.value: round(100 * v, 1)
               for k, v in sorted(r.decision_mix().items(),
                                  key=lambda kv: kv[0].value)}
        print(f"simulate {policy:8s} makespan {r.makespan_ns!r} ns  energy "
              f"{r.total_energy_nj!r} nJ  mix {mix}")
        if policy == "conduit" and r.makespan_ns != CONDUIT_MAKESPAN_NS:
            raise AssertionError(f"conduit makespan {r.makespan_ns!r} != "
                                 f"{CONDUIT_MAKESPAN_NS!r}")
    if any(ops.launch_counts().values()):
        raise AssertionError("the simulator launched a kernel: "
                             f"{ops.launch_counts()}")

    # -- 5. replay of the offloaded ops through the kernels ----------------
    phase("replay")
    tsteps = jacobi1d.SCALES["paper"]["tsteps"]

    def sweep(a, mul):
        for _ in range(tsteps):
            x0, x1, x2 = (s.reshape(1, -1) for s in (a[:-2], a[1:-1], a[2:]))
            s = ops.bitserial_add(ops.bitserial_add(x0, x1), x2)   # PuD
            b = mul(s, torch.full_like(s, 85)).reshape(-1)
            a = torch.cat([a[:1], b, a[-1:]])
        return a

    variants = (("ifp_shift_add", lambda x, k: ops.shift_add_mul(x, k, bits=8),
                 {"bitserial_add": 6, "bitserial_mul": 0,
                  "shift_add_mul": 3}),
                ("pud_bitserial_mul", ops.bitserial_mul,
                 {"bitserial_add": 6, "bitserial_mul": 3,
                  "shift_add_mul": 0}))
    for label, mul, want_counts in variants:
        ops.reset_launch_counts()
        out = sweep(make_inputs("jacobi1d", "paper")[0], mul)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        same = torch.equal(out, numeric)
        print(f"replay {label}: equal to run_numeric {same}, launches "
              f"{counts}")
        if not same:
            raise AssertionError(f"replay {label} != run_numeric")
        if counts != want_counts:
            raise AssertionError(f"replay {label} launches {counts} != "
                                 f"{want_counts}")
        for k, c in counts.items():
            records[k]["launches"] = max(records[k]["launches"], c)

    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
