#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero before the
last line:

1. card   — ``nvidia-smi`` name and power limit, ``torch.cuda`` name/count;
2. build  — ``csrc/ndp.cu`` compiled for sm_90a from this checkout;
3. kernels — each CUDA kernel held exactly equal to its plain PyTorch
   version over the kernel-test grids and the shapes the replays give it,
   with CUDA-event times of the kernel, the plain version and the one
   PyTorch call that computes the same function, beside the card's least
   time for the work;
4. pipeline — jacobi1d, aes, xor_filter and heat3d at paper scale through
   the package's entry points: numeric run on the card (its outputs'
   digest must be the JAX package's), trace, Table 3 row, ``simulate``
   under every policy (the conduit makespan must match the JAX package's
   to the bit);
5. replay — the offloaded ops again on the card through the kernels: the
   jacobi1d sweep (adds through the PuD bit-serial adder, x85 through the
   IFP shift-add multiplier, then through the bit-serial multiplier); the
   aes CTR rounds with every and/or/xor/not through the Flash-Cosmos MWS
   kernel; the xor_filter query fold and masks through MWS; heat3d's adds
   through the bit-serial adder and its x2/x41 through the shift-add
   multiplier; a ``search`` instruction, which the conduit policy sends to
   IFP, through the match-line kernel on xor_filter's built table.  Each
   must equal the numeric run (or, for search, the plain version) bit for
   bit, and the launch counters, zeroed before each replay, must show the
   kernels ran.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this script, it fails and prints no result.
"""
from __future__ import annotations

import hashlib
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

from repro_torch.core.cost import SystemView  # noqa: E402
from repro_torch.core.isa import Location, Resource, VectorInstr  # noqa: E402
from repro_torch.core.policies import make_policy  # noqa: E402
from repro_torch.hw.ssd_spec import DEFAULT_SSD  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.sim import simulate  # noqa: E402
from repro_torch.workloads import (WORKLOADS, get_trace,  # noqa: E402
                                   jacobi1d, make_inputs, run_numeric,
                                   xor_filter)

# the H100 SXM's HBM3 rate (NVIDIA data sheet); ops peaks are read off the
# card itself in phase 1
HBM_BYTES_PER_S = 3.35e12
# INT32 lanes per SM on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput: 32-bit integer add, shift,
# and bitwise logic at 64 results per clock per SM)
INT32_OPS_PER_CLOCK_PER_SM = 64

INT_SHAPES = [(8, 128), (16, 256), (8, 512), (24, 384), (64, 128)]
PAGE_SHAPE = (160, 4096)           # jacobi1d paper: one 16 KiB page a row
MWS_OPS = ("and", "or", "xor", "nand", "nor")
POLICIES = ("cpu", "isp", "pud", "dm", "bw", "conduit", "ideal")
SEARCH_WPR = 4                     # a 16-byte record in the search replay

# The JAX package's results at "paper" scale: Table 3 row, conduit
# makespan, and the digest of ``run_numeric``'s outputs (output_digest).
# The card has no jax; tests/test_torch_chip_smoke.py holds these against
# the JAX package on the CPU.
REFERENCE = {
    "jacobi1d": {
        "row": {"vectorizable_pct": 100.0, "avg_reuse": 2.0, "low_pct": 0,
                "medium_pct": 67, "high_pct": 33, "instrs": 480},
        "conduit_makespan_ns": 11562718.5767338,
        "numeric_sha256": "038132f2d625eb2de9a5cccc97a92ec8"
                          "c5ed935088107bd9be9cc6510a153999"},
    "aes": {
        "row": {"vectorizable_pct": 99.4, "avg_reuse": 1.6, "low_pct": 98,
                "medium_pct": 2, "high_pct": 0, "instrs": 4848},
        "conduit_makespan_ns": 501847176.5095089,
        "numeric_sha256": "b94d4f2df192be95158a45d1b9fab8ee"
                          "b58716c138d80ea4b1d6336e967c21b2"},
    "xor_filter": {
        "row": {"vectorizable_pct": 72.9, "avg_reuse": 1.5, "low_pct": 21,
                "medium_pct": 79, "high_pct": 0, "instrs": 1645},
        "conduit_makespan_ns": 79816531.38080545,
        "numeric_sha256": "f746a0178e4fd38531c1624f8e06a8e9"
                          "2bbc24d4ec230a5b0416d3f1eda4c339"},
    "heat3d": {
        "row": {"vectorizable_pct": 100.0, "avg_reuse": 1.6, "low_pct": 0,
                "medium_pct": 60, "high_pct": 40, "instrs": 2410},
        "conduit_makespan_ns": 36017434.409664914,
        "numeric_sha256": "70e3c3dc8cfe244dea5e59161ea6ccbb"
                          "6c8b5672d9ff9c2eb9a457118a87b86f"},
}

REPLACES = {"bitserial_add": "src/repro/kernels/bitserial.py:19",
            "bitserial_mul": "src/repro/kernels/bitserial.py:34",
            "shift_add_mul": "src/repro/kernels/shift_add.py:21",
            "mws_bitwise": "src/repro/kernels/mws.py:27",
            "search_pages": "src/repro/kernels/search.py:24"}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def output_digest(arrays) -> str:
    """sha256 over each int32 output's shape and little-endian bytes."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.asarray(a, dtype="<i4")
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_report(lib_path: str, nvcc: str) -> None:
    """Print, per kernel, what the compiler made of its loops: SASS
    instruction count, LOP3/IMAD/SHF counts, and the length of each loop
    body (instructions from a backward branch's target to the branch).
    Informational: a missing ``cuobjdump`` is reported, not fatal."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(tool):
        print(f"  sass: {tool} not found")
        return
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split()[0]
        # mangled template args: h uint8, j uint32; Li<k>E the MWS op code
        kernel = re.search(r"\d+([a-z_]+_kernel)(?:I([hj])(?:Li(\d)E)?E)?",
                           name)
        if kernel and kernel.group(2):
            elem = {"h": "u8", "j": "u32"}[kernel.group(2)]
            op = (f", {MWS_OPS[int(kernel.group(3))]}"
                  if kernel.group(3) is not None else "")
            label = f"{kernel.group(1)}<{elem}{op}>"
        else:
            label = kernel.group(1) if kernel else name
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


# -- phase 5: the offloaded ops of each workload through the kernels --------
# Each replay returns (what the kernels gave, what it must equal).  On CPU
# tensors ``ops`` takes the plain versions, so the replays also run, at
# "tiny" scale, in the CPU tests.

def mws(op, *pages):
    """One multi-wordline sense over ``pages``, broadcast to one shape and
    stacked on the operand axis as ``[n_ops, rows, cols]``."""
    stack = torch.stack(torch.broadcast_tensors(*pages))
    out = ops.mws_bitwise(stack.reshape(len(pages), -1, stack.shape[-1]), op)
    return out.reshape(stack.shape[1:])


def replay_jacobi1d(numeric, mul, scale, device):
    """The sweep with its adds through the PuD adder and x85 through
    ``mul``."""
    a = make_inputs("jacobi1d", scale, device=device)[0]
    for _ in range(jacobi1d.SCALES[scale]["tsteps"]):
        x0, x1, x2 = (s.reshape(1, -1) for s in (a[:-2], a[1:-1], a[2:]))
        s = ops.bitserial_add(ops.bitserial_add(x0, x1), x2)
        b = mul(s, torch.full_like(s, 85)).reshape(-1)
        a = torch.cat([a[:1], b, a[-1:]])
    return a, numeric["jacobi1d"]


def replay_aes(numeric, scale, device):
    """The CTR rounds with every and/or/xor/not as one MWS sense (the
    3-way xor as one 3-page sense, NOT as a 1-page inverted sense)."""
    state, round_keys = make_inputs("aes", scale, device=device)[:2]
    for r in range(WORKLOADS["aes"].SCALES[scale]["rounds"]):
        state = mws("xor", state, round_keys[r])           # AddRoundKey
        r1 = mws("xor", state << 1, state >> 7)
        r2 = mws("and", state, r1)
        r3 = mws("nand", state)
        state = mws("xor", r2, r3, mws("or", r1, state))
        xt = mws("xor", state << 1,
                 mws("and", state >> 31, torch.full_like(state, 27)))
        state = mws("xor", xt, r1)
    return state, numeric["aes"][0]


def replay_xor_filter(numeric, scale, device):
    """The query side on the built table: the 3-way fold of the gathered
    slots and the fingerprint masks as MWS senses."""
    keys, _, fingerprints = make_inputs("xor_filter", scale, device=device)
    hits, built = numeric["xor_filter"]
    slots = xor_filter.SCALES[scale]["slots"]
    idx = [torch.abs(h) % slots for h in xor_filter._hash3(keys)]
    f = mws("xor", *(built[i] for i in idx))
    mask = torch.full_like(f, 255)
    member = mws("and", f, mask) == mws("and", fingerprints, mask)
    return member.sum(dtype=torch.int32), hits


def replay_heat3d(numeric, scale, device):
    """The stencil with its adds through the PuD adder and its x2 / x41
    through the IFP shift-add multiplier (8 latch rounds)."""
    u = make_inputs("heat3d", scale, device=device)[0]
    m = u.shape[0] - 2

    def flat(t):
        return t.reshape(m, m * m)

    def times(x, k):
        return ops.shift_add_mul(x, torch.full_like(x, k), bits=8)

    for _ in range(WORKLOADS["heat3d"].SCALES[scale]["tsteps"]):
        c = flat(u[1:-1, 1:-1, 1:-1])
        dd = [ops.bitserial_add(flat(hi) - times(c, 2), flat(lo))
              for hi, lo in ((u[2:, 1:-1, 1:-1], u[:-2, 1:-1, 1:-1]),
                             (u[1:-1, 2:, 1:-1], u[1:-1, :-2, 1:-1]),
                             (u[1:-1, 1:-1, 2:], u[1:-1, 1:-1, :-2]))]
        upd = c
        for d in dd:
            upd = ops.bitserial_add(upd, times(d, 41))
        u = torch.nn.functional.pad(upd.reshape(m, m, m), (1,) * 6)
    return u, numeric["heat3d"]


def replay_search(numeric):
    """A ``search`` instruction on a flash-resident page goes to IFP under
    the conduit policy; its match lines then run on xor_filter's built
    table, ``[slots / 4096, 4096]``, with a query planted in one record."""
    ins = VectorInstr(iid=0, op="search", vlen=DEFAULT_SSD.page_size,
                      elem_bytes=1, srcs=(0,), dst=1)
    view = SystemView(0.0, lambda r: 0.0, lambda i: 0.0,
                      lambda p: Location.FLASH)
    decision = make_policy("conduit", DEFAULT_SSD).select(ins, view)
    if decision.resource != Resource.IFP or \
            ins.native(Resource.IFP) != "ifp.mws_match":
        raise AssertionError(f"search went to {decision.resource}")
    stack = numeric["xor_filter"][1].reshape(-1, 4096).clone()
    query = torch.tensor([7, -1, 1 << 30, 12345], dtype=torch.int32,
                         device=stack.device)
    row, rec = stack.shape[0] // 3, 321
    stack[row, rec * SEARCH_WPR:(rec + 1) * SEARCH_WPR] = query
    got = ops.search_pages(stack, query)
    if not bool(got[row, rec]):
        raise AssertionError("search missed the planted record")
    return got, ref.search_plain(stack, query)


def replay_plan(numeric, scale="paper", device="cuda"):
    """``(label, replay, launches it must make)`` for every replay, given
    the numeric run's outputs by workload."""
    def counts(**launched):
        return {k: launched.get(k, 0) for k in ops.launch_counts()}

    rounds = WORKLOADS["aes"].SCALES[scale]["rounds"]
    tsteps = WORKLOADS["heat3d"].SCALES[scale]["tsteps"]
    return (
        ("jacobi1d ifp_shift_add",
         lambda: replay_jacobi1d(
             numeric, lambda x, k: ops.shift_add_mul(x, k, bits=8), scale,
             device),
         counts(bitserial_add=6, shift_add_mul=3)),
        ("jacobi1d pud_bitserial_mul",
         lambda: replay_jacobi1d(numeric, ops.bitserial_mul, scale, device),
         counts(bitserial_add=6, bitserial_mul=3)),
        ("aes ctr rounds", lambda: replay_aes(numeric, scale, device),
         counts(mws_bitwise=9 * rounds)),
        ("xor_filter fold", lambda: replay_xor_filter(numeric, scale, device),
         counts(mws_bitwise=3)),
        ("heat3d", lambda: replay_heat3d(numeric, scale, device),
         counts(bitserial_add=6 * tsteps, shift_add_mul=6 * tsteps)),
        ("search on the built table", lambda: replay_search(numeric),
         counts(search_pages=1)),
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

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
    cases = []                                  # (kernel, dtype, shape, arg)
    for dt in (np.int32, np.int8):
        for shape in INT_SHAPES:
            cases.append(("bitserial_add", dt, shape, None))
        for shape in INT_SHAPES[:3]:
            cases.append(("bitserial_mul", dt, shape, None))
        for op in MWS_OPS:                      # tests/test_kernels.py grid
            for n_ops in (2, 3, 7, 48):
                cases.append(("mws_bitwise", dt, (n_ops, 16, 256), op))
    for bits in (4, 8):
        for shape in INT_SHAPES[:3] + [PAGE_SHAPE]:
            cases.append(("shift_add_mul", np.int32, shape, bits))
    for rows in (8, 24, 13):
        for wpr in (1, 2, 4):
            cases.append(("search_pages", np.int32, (rows, 32), wpr))
    cases += [("bitserial_add", np.int32, PAGE_SHAPE, None),
              ("bitserial_mul", np.int32, PAGE_SHAPE, None)]

    def operands(name, dt, shape, arg):
        """The operands of one call: (a, b) for the elementwise kernels, the
        stack for MWS, (stack, query) with the query planted as record 0 of
        row 3 for search."""
        if name == "mws_bitwise":
            return (rand(rng, shape, dt),)
        if name == "search_pages":
            stack = rand(rng, shape, dt)
            query = torch.arange(arg, dtype=torch.int32, device="cuda")
            stack[3, :arg] = query
            return stack, query
        return rand(rng, shape, dt), rand(rng, shape, dt)

    kernel_fn = {"bitserial_add": lambda a, b, arg: ops.bitserial_add(a, b),
                 "bitserial_mul": lambda a, b, arg: ops.bitserial_mul(a, b),
                 "shift_add_mul": lambda a, b, arg:
                     ops.shift_add_mul(a, b, bits=arg),
                 "mws_bitwise": lambda s, arg: ops.mws_bitwise(s, arg),
                 "search_pages": lambda s, q, arg: ops.search_pages(s, q)}
    plain_fn = {"bitserial_add": lambda a, b, arg:
                    ref.bitserial_add_plain(a, b),
                "bitserial_mul": lambda a, b, arg:
                    ref.bitserial_mul_plain(a, b),
                "shift_add_mul": lambda a, b, arg:
                    ref.shift_add_mul_plain(a, b, arg),
                "mws_bitwise": lambda s, arg: ref.mws_plain(s, arg),
                "search_pages": lambda s, q, arg: ref.search_plain(s, q)}
    for name, dt, shape, arg in cases:
        xs = operands(name, dt, shape, arg)
        got = kernel_fn[name](*xs, arg)
        want = plain_fn[name](*xs, arg)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name} {np.dtype(dt).name} {shape} "
                                 f"arg={arg}: kernel != plain version")
        if name == "search_pages" and not bool(got[3, 0]):
            raise AssertionError(f"search_pages {shape} wpr={arg}: the "
                                 f"planted record was not found")
    print(f"{len(cases)} cases: every kernel equal to its plain version")

    # Timing at the shapes the replays give each kernel (first listed per
    # kernel is its record).  Bound: the least time for the function each
    # kernel computes: its bytes (each input read once, each output
    # written once) over HBM, or its int ops over the INT32 peak, whichever
    # is larger.  For the PuD/IFP arithmetic the gate-level loop's own op
    # count (3W+1, W(6W+5), 5 * bits per element) is printed beside it: it
    # is the model's method, and the compiler already does less than it
    # (dead carry rounds are known zero), so it bounds nothing.
    n = jacobi1d.SCALES["paper"]["n"] - 2
    aes_rows = WORKLOADS["aes"].SCALES["paper"]["n"] // 4096
    keys = xor_filter.SCALES["paper"]["n_keys"]
    slots = xor_filter.SCALES["paper"]["slots"]
    m = WORKLOADS["heat3d"].SCALES["paper"]["n"] - 2
    w = 32                                       # int32 lanes
    gate_ops = {"bitserial_add": 3 * w + 1, "bitserial_mul": w * (6 * w + 5),
                "shift_add_mul": 5 * 8}
    library = {"bitserial_add": lambda a, b, arg: torch.add(a, b),
               "bitserial_mul": lambda a, b, arg: torch.mul(a, b),
               "shift_add_mul": None}
    mws_library = {"and": torch.bitwise_and, "or": torch.bitwise_or,
                   "xor": torch.bitwise_xor}
    timed = [  # (label, kernel, shape, arg)
        ("jacobi1d", "bitserial_add", (1, n), None),
        ("jacobi1d", "bitserial_mul", (1, n), None),
        ("jacobi1d", "shift_add_mul", (1, n), 8),
        ("page", "bitserial_add", PAGE_SHAPE, None),
        ("page", "bitserial_mul", PAGE_SHAPE, None),
        ("page", "shift_add_mul", PAGE_SHAPE, 8),
        ("heat3d", "bitserial_add", (m, m * m), None),
        ("heat3d", "shift_add_mul", (m, m * m), 8),
        ("aes", "mws_bitwise", (2, aes_rows, 4096), "xor"),
        ("aes", "mws_bitwise", (3, aes_rows, 4096), "xor"),
        ("aes", "mws_bitwise", (1, aes_rows, 4096), "nand"),
        ("xor_filter", "mws_bitwise", (3, 1, keys), "xor"),
        ("xor_filter", "search_pages", (slots // 4096, 4096), SEARCH_WPR),
    ]
    clock_hz = max_sm_mhz * 1e6
    records = {}
    for label, name, shape, arg in timed:
        xs = operands(name, np.int32, shape, arg)
        if name == "shift_add_mul":            # the x85 / x41 replayed
            xs = (xs[0], torch.full_like(xs[0], 41 if label == "heat3d"
                                         else 85))
        got = kernel_fn[name](*xs, arg)
        want = plain_fn[name](*xs, arg)
        err = int((got.long() - want.long()).abs().max())
        ms = time_ms(lambda: kernel_fn[name](*xs, arg), 50, clock_hz)
        plain_ms = time_ms(lambda: plain_fn[name](*xs, arg), 2, clock_hz,
                           rounds=3)
        if name == "mws_bitwise":
            n_ops = shape[0]
            lib = (None if n_ops != 2 or arg not in mws_library else
                   lambda s, arg: mws_library[arg](s[0], s[1]))
            elems = shape[1] * shape[2]
            nbytes = (n_ops + 1) * elems * 4
            nops = max(1, n_ops - 1) * elems
        elif name == "search_pages":
            lib = None
            stack = xs[0]
            recs = stack.numel() // arg
            nbytes = stack.numel() * 4 + recs
            nops = 2 * stack.numel()             # XNOR and AND per word
        else:
            lib = library[name]
            elems = xs[0].numel()
            nbytes = 3 * elems * 4
            nops = (2 if name == "shift_add_mul" else 1) * elems
        lib_ms = (time_ms(lambda: lib(*xs, arg), 50, clock_hz)
                  if lib is not None else None)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / int32_ops_per_s * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        gate = (f"; gate-level ops at INT32 peak "
                f"{gate_ops[name] * xs[0].numel() / int32_ops_per_s * 1e3:.6f}"
                if name in gate_ops else "")
        print(f"{name:14s} {label:10s} {str(shape):18s} arg={arg} "
              f"kernel {ms:.6f} ms  plain {plain_ms:.6f} ms  library "
              f"{lib_ms if lib_ms is None else f'{lib_ms:.6f}'} ms  "
              f"bound {bound_ms:.6f} ms ({bound_by}; bytes {bytes_ms:.6f}, "
              f"ops {ops_ms:.6f}{gate})  max_abs_err {err}", flush=True)
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain version")
        if name not in records:
            records[name] = {
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/ndp.cu",
                "replaces": REPLACES[name], "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}

    # -- 4. pipeline: each workload at paper scale through the entry points
    phase("pipeline")
    ops.reset_launch_counts()
    numeric = {}
    for name, want in REFERENCE.items():
        inputs = make_inputs(name, "paper")
        if not all(x.is_cuda for x in inputs):
            raise AssertionError(f"{name}: make_inputs did not place the "
                                 f"inputs on the card")
        t0 = time.perf_counter()
        out = run_numeric(name, "paper")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        outs = out if isinstance(out, tuple) else (out,)
        if not all(o.is_cuda and o.dtype == torch.int32 for o in outs):
            raise AssertionError(f"{name}: run_numeric gave "
                                 f"{[(str(o.device), o.dtype) for o in outs]}")
        digest = output_digest([o.cpu().numpy() for o in outs])
        print(f"{name}: run_numeric on the card in {seconds:.3f} s, outputs "
              f"{[tuple(o.shape) for o in outs]}, sha256 {digest}")
        if digest != want["numeric_sha256"]:
            raise AssertionError(f"{name}: numeric outputs differ from the "
                                 f"JAX package's ({digest})")
        numeric[name] = out
        trace = get_trace(name, "paper")
        row = trace.characterize().as_row()
        print(f"{name} characterize:", json.dumps(row))
        if row != want["row"]:
            raise AssertionError(f"{name}: Table 3 row {row} != "
                                 f"{want['row']}")
        for policy in POLICIES:
            r = simulate(trace, policy)
            mix = {k.value: round(100 * v, 1)
                   for k, v in sorted(r.decision_mix().items(),
                                      key=lambda kv: kv[0].value)}
            print(f"{name} simulate {policy:8s} makespan {r.makespan_ns!r} "
                  f"ns  energy {r.total_energy_nj!r} nJ  mix {mix}")
            if policy == "conduit" and \
                    r.makespan_ns != want["conduit_makespan_ns"]:
                raise AssertionError(
                    f"{name}: conduit makespan {r.makespan_ns!r} != "
                    f"{want['conduit_makespan_ns']!r}")
    if any(ops.launch_counts().values()):
        raise AssertionError("the pipeline launched a kernel: "
                             f"{ops.launch_counts()}")

    # -- 5. replay of the offloaded ops through the kernels ----------------
    phase("replay")
    for label, replay, want_counts in replay_plan(numeric):
        ops.reset_launch_counts()
        got, want = replay()
        torch.cuda.synchronize()
        launched = ops.launch_counts()
        same = torch.equal(got, want)
        print(f"replay {label}: equal {same}, launches {launched}")
        if not same:
            raise AssertionError(f"replay {label} differs")
        if launched != want_counts:
            raise AssertionError(f"replay {label} launches {launched} != "
                                 f"{want_counts}")
        for k, c in launched.items():
            records[k]["launches"] += c
    unused = [k for k, r in records.items() if r["launches"] == 0]
    if unused:
        raise AssertionError(f"no replay launched {unused}")

    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
