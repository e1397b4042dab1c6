#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero before the
last line:

1. card   — ``nvidia-smi`` name and power limit, ``torch.cuda`` name/count;
2. build  — ``csrc/ndp.cu`` and ``csrc/attention.cu`` compiled for sm_90a
   from this checkout; ptxas registers and spills, and per kernel its SASS
   counts and loop bodies (the 16-byte loops of the prefix adder, the IFP
   multiplier and the match line, a unit of work at a time, with their
   opcodes); every INT8 GEMM instance must run on the tensor cores (IMMA,
   no IDP) without spilling, and every 16-byte instance of the adder, the
   IFP multiplier and the match line must run a loop that holds a 16-byte
   load, without spilling;
3. kernels — each CUDA kernel held exactly equal to its plain PyTorch
   version over the kernel-test grids and the shapes the replays give it
   (the bit-plane multiplier and the prefix adder also on a ragged n, the
   jacobi1d length and the dtypes' extreme values; the adder also on the
   jacobi1d sweep's unaligned slices; the MWS sense on 1-6 pages of every
   op, ragged, unaligned and with a tail; the IFP multiplier on n % 4 = 1,
   2, 3, the unaligned slices, bits 0, 1, 7, 31, 32 and the extremes; the
   match line at wpr 1-4, 8, 16, 32 on 1 and 48 rows, whole and 4 bytes off, with
   records planted first and last; the INT8 GEMM on a layout probe,
   the replay shapes, a GEMV, a small K, unaligned pitches and views and
   wrapping sums), flash attention within its tolerance (also
   with logits large enough to move the running max inside a tile), with
   CUDA-event times of the kernel, the plain version and the one PyTorch
   call that computes the same function (for the IFP multiplier and the
   match line, which have none, a floor: ``torch.mul``, and the record
   compare as two calls), beside the card's least time for the work, also
   at one shape beyond L2 for the IFP multiplier and the match line, and
   for the INT8 GEMM at llama2_infer's and llm_train's shapes, forward and
   backward, and for flash attention at each shape phase 10 gives it
   (``FAMILY_ATTN``, one query token against 256 keys among them);
4. pipeline — jacobi1d, aes, xor_filter, heat3d, llama2_infer and
   llm_train at paper scale through the package's entry points: numeric
   run on the card (its outputs' digest must be the JAX package's; fp32
   matmuls without TF32; llm_train's loss and the L1 norm of its SGD step
   within a stated tolerance of the JAX package's, since two autodiff
   frameworks sum in other orders), trace, Table 3 row, ``simulate`` under
   every policy (the conduit makespan must match the JAX package's to the
   bit), with the seconds each trace and its simulations take;
5. replay — the offloaded ops again on the card through the kernels: the
   jacobi1d sweep (adds through the PuD bit-serial adder, x85 through the
   IFP shift-add multiplier, then through the bit-serial multiplier); the
   aes CTR rounds with every and/or/xor/not through the Flash-Cosmos MWS
   kernel; the xor_filter query fold and masks through MWS; heat3d's adds
   through the bit-serial adder and its x2/x41 through the shift-add
   multiplier; a ``search`` instruction, which the conduit policy sends to
   IFP, through the match-line kernel on xor_filter's built table;
   llama2_infer's prefill and decode with every 2-D ``x @ W`` in the §5.4
   INT8 lanes (per-tensor symmetric quantization, the INT8 GEMM,
   dequantization); llm_train's step with every ``x @ W`` in the INT8
   lanes forward and backward (``dX = q(dY) q(W)^T``, ``dW = q(X)^T
   q(dY)``, each through the INT8 GEMM).  Each must equal the numeric run
   (or, for search and the GEMMs, the plain version) bit for bit, and the
   launch counters, zeroed before each replay, must show the kernels ran;
6. serve — the LM serving path (``repro_torch.launch.serve``), whose
   prefill attends through the flash-attention kernel: reduced
   tinyllama-1.1b in fp32 on weights made here from a seed in the JAX
   package's tree layout (every request's greedy tokens must have the
   JAX package's digest), then tinyllama-1.1b at full width and depth in
   bf16 through ``serve`` (8 requests of 1024 tokens, batch 4, 16 new
   tokens): the kernel must launch once per layer and batch, every call
   (recorded in a second run) must agree with the plain version, and the
   throughput, latency, prefill/decode wall time and peak memory are
   printed beside the card's name and power limit;
7. mix — multi-tenancy, which calls no kernel: ``simulate_mix`` of
   jacobi1d's and heat3d's paper traces under conduit beside a Zipf host
   I/O stream on a preconditioned drive with garbage collection; the
   makespan, host I/O counts and FTL counters must be the JAX package's;
8. open-loop — serving, which calls no kernel either, on the same paper
   traces: ``simulate_serving`` under conduit at a rate under and one over
   its saturation with the flight recorder on and its analysis report;
   ``find_saturation`` of conduit, bw and dm at a 50 ms p99 SLO, and
   ``batched_find_saturation`` of the three, which must equal them; a
   three-drive ``simulate_fleet`` with a collecting drive, its merged
   trace exported, validated and blamed.  Every result's digest must be
   the JAX package's, with the seconds each run takes;
9. train — the LM training path (``repro_torch.launch.train``), whose
   attention is the JAX package's chunked einsum path (the kernel has no
   backward and refuses autograd): three AdamW steps of reduced
   tinyllama-1.1b in fp32 on the serving phase's seeded weights, whole
   and in two microbatches (each step's loss, learning rate, gradient
   norm and the L1 norm of its update within a stated tolerance of the
   JAX package's); ``train`` with checkpoints every two steps, straight
   and under ``run_elastic`` with a failure injected at step 4 (the
   resumed run must equal the straight one); then tinyllama-1.1b at full
   width and depth in bf16 with remat, batch 4 x 1024 tokens (two q
   blocks of the einsum path): every parameter's gradient finite and
   non-zero, six finite steps, no flash-attention launch, and the step
   time, tokens/s, peak memory and model-flops share printed beside the
   card's name and power limit, with one more step under
   ``torch.profiler``: the device's busy time and the ATen ops that take
   it;
10. families — the LM families phases 6 and 9 do not cover (qwen2-vl-2b,
   zamba2-1.2b, xlstm-125m, seamless-m4t-medium, dbrx-132b,
   deepseek-v2-236b: M-RoPE, Mamba2 with a shared attention block,
   xLSTM, an encoder-decoder, MoE, MLA).  Pinned: each reduced in fp32
   on weights made here from a seed in the JAX package's tree layout
   (zamba2 over a whole period, so that its shared block runs) through
   the serving loop, and qwen2-vl and seamless also through prefill with
   their patch or frame stubs and four decode steps (seamless
   cross-attending to the encoder's output): every request's greedy
   tokens must have the JAX package's digest (on a mismatch the
   smallest top-k gate and logit margins are printed, so that a near
   tie can be told from a fault).  Then each at its published widths in
   bf16 from a seeded random init, dbrx and deepseek cut to 4 layers
   (their whole depth outgrows the card), one batch of 4 x 1024-token
   prompts with their stubs, prefill and 7 decode steps: the kernel's
   launches exactly ``FAMILIES_K6``, every call of a recorded second run
   within ``ATTN_TOL`` of the plain version, the last-token logits
   finite and within ``FAMILIES_LOGIT_RTOL`` of the einsum path's; the
   prefill and decode times, tokens/s, peak memory and the MoE share of
   (token, expert) pairs dropped by capacity are printed beside the
   card's name and power limit;
11. planning — distributed planning (``repro_torch.launch.dryrun``):
   three production cells, each a DTensor program on rank 0 of a fake
   process group of the mesh's size (256 or 512 ranks), its arguments
   DTensors with fake local shards, counted by
   ``repro_torch.launch.costing`` (flops, op bytes and collective bytes a
   device, peak bytes a device): tinyllama-1.1b ``train_4k`` on 16 x 16,
   deepseek-v2-236b ``decode_32k`` on 2 x 16 x 16 (the pod axis, MLA
   caches, the expert-parallel MoE), zamba2-1.2b ``long_500k`` on 16 x 16
   (sharded SSM state); each record printed, its per-device argument
   bytes held equal to the JAX package's (``PLANNING_REFERENCE``).  Then
   deepseek-v2-236b's MoE layer at its published width on 4 x 1024
   tokens, through the single-device path and through the
   expert-parallel path on a 1 x 1 mesh over a one-rank NCCL group: the
   two outputs bit-equal, their CUDA-event times and the peak memory
   printed beside the card's name and power limit.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this script, it fails and prints no result.
"""
from __future__ import annotations

import base64
import contextlib
import dataclasses
import enum
import hashlib
import itertools
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils import _pytree as pytree

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.cost import SystemView  # noqa: E402
from repro_torch.core.isa import Location, Resource, VectorInstr  # noqa: E402
from repro_torch.core.policies import make_policy  # noqa: E402
from repro_torch.hw.ssd_spec import DEFAULT_SSD  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import (_build, attention,  # noqa: E402
                                 int8_matmul, ops, ref)
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.elastic import run_elastic  # noqa: E402
from repro_torch.launch.serve import (make_requests, serve,  # noqa: E402
                                      serve_requests)
from repro_torch.launch.steps import (build_prefill_step,  # noqa: E402
                                      build_serve_step, build_train_step,
                                      loss_and_grads)
from repro_torch.launch.train import (device_batch,  # noqa: E402
                                      make_state, state_from_numpy, train)
from repro_torch.optim import AdamWState  # noqa: E402
from repro_torch.models import layers, model as M  # noqa: E402
from repro_torch import sim as torch_sim  # noqa: E402
from repro_torch.sim import simulate  # noqa: E402
from repro_torch.workloads import (WORKLOADS, _llama,  # noqa: E402
                                   get_trace, jacobi1d, llama2_infer,
                                   llm_train, make_inputs, run_numeric,
                                   xor_filter)

# the H100 SXM's HBM3 rate (NVIDIA data sheet); ops peaks are read off the
# card itself in phase 1
HBM_BYTES_PER_S = 3.35e12
# INT32 lanes per SM on compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instruction throughput: 32-bit integer add, shift,
# and bitwise logic at 64 results per clock per SM)
INT32_OPS_PER_CLOCK_PER_SM = 64
# the H100 SXM's dense INT8 and bf16 tensor-core peaks (NVIDIA data sheet),
# at the 700 W power limit
INT8_TENSOR_OPS_PER_S = 1.979e15
BF16_TENSOR_FLOPS_PER_S = 989e12
# fp32 outside the tensor cores (the same data sheet)
FP32_FLOPS_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

INT_SHAPES = [(8, 128), (16, 256), (8, 512), (24, 384), (64, 128)]
PAGE_SHAPE = (160, 4096)           # jacobi1d paper: one 16 KiB page a row
MWS_OPS = ("and", "or", "xor", "nand", "nor")
POLICIES = ("cpu", "isp", "pud", "dm", "bw", "conduit", "ideal")
SEARCH_WPR = 4                     # a 16-byte record in the search replay
# INT8 GEMM cases (M, K, N): the tests/test_kernels.py grid, shapes that
# divide nothing, and all -128 operands at K = 4096 and at the K where the
# int32 sum (K * 2**14) wraps
MATMUL_SHAPES = [(32, 64, 32), (16, 32, 48), (128, 128, 128), (64, 96, 160),
                 (13, 37, 29), (1, 1, 1)]
MATMUL_EXTREMES = [(16, 4096, 24), (4, 1 << 17, 8)]
# the tensor-core GEMM's cases (M, K, N, arg): the layout probe (one m16
# tile of structured values, on the byte and the 16-byte load paths), the
# llama2_infer replay shapes, a GEMV, a small K at a large M (the training
# backward's x^T dY), pitches not 16-byte aligned, A or B a view one byte
# past an allocation's start, and all -128 where the split sums wrap
MATMUL_MMA = [(16, 32, 8, "probe"), (16, 32, 16, "probe"),
              (48, 1024, 1024, None), (48, 1024, 2816, None),
              (48, 2816, 1024, None), (48, 1024, 8192, None),
              (1, 1024, 8192, None), (1024, 48, 1024, None),
              (48, 1030, 8200, None), (48, 1024, 1024, "view_a"),
              (48, 1024, 1024, "view_b"), (48, 1 << 17, 64, "min")]
# flash-attention cases (heads, Sq, Sk, dh): the tests/test_kernels.py
# grid, causal Sq != Sk, ragged lengths, each head dim, several q tiles
ATTN_CASES = [(2, 64, 64, 32), (1, 128, 128, 64), (4, 32, 32, 16),
              (2, 32, 128, 32), (3, 13, 37, 64), (2, 37, 13, 16),
              (1, 24, 40, 128), (2, 300, 300, 128), (2, 520, 1040, 64)]
# the shapes phase 10 gives the kernel (heads, Sq, Sk, dh, causal): a
# prefill batch of qwen2-vl-2b (4 x 12 heads, 64 patches + 1024 tokens,
# dh 128), of dbrx-132b (4 x 48 heads), zamba2-1.2b's shared block (4 x
# 32 heads, dh 64), seamless-m4t-medium's encoder over 256 frames, its
# decoder's self-attention, its cross-attention in prefill and in a decode
# step (one query token); each also in ATTN_CASES (both masks, both types)
FAMILY_ATTN = [(48, 1088, 1088, 128, True), (192, 1024, 1024, 128, True),
               (128, 1024, 1024, 64, True), (64, 256, 256, 64, False),
               (64, 1024, 1024, 64, True), (64, 1024, 256, 64, False),
               (64, 1, 256, 64, False)]
ATTN_CASES += [shape[:4] for shape in FAMILY_ATTN]
# tolerance (atol = rtol) against the plain version: fp32 as
# tests/test_kernels.py:79 holds the Pallas kernel; bf16: the tensor-core
# kernel rounds the softmax weights to bf16 for the product with v (2**-9
# relative a weight) and sums the normaliser from the same rounded weights,
# so its output is a mean of v under weights within 2**-9 of the plain
# version's fp32 ones; both then round the result to bf16 once (one ulp,
# 2**-8 relative, apart).  The largest |diff| measured is in PERF.md.
ATTN_TOL = {torch.float32: 3e-5, torch.bfloat16: 1e-2}
# q and k drawn x8 (bf16): logits of tens, so the running max moves inside
# a 64-key tile and rescales by factors that underflow.  fp32 draws x4: at
# x8 the fp32 plain version is itself ~3.5e-5 from the exact (float64)
# answer, over its 3e-5 tolerance, so no fp32 kernel could be held there.
ATTN_LARGE = (2, 300, 300, 64)
LARGE_LOGITS = {torch.bfloat16: 8.0, torch.float32: 4.0}
# the bit-plane multiplier's and the prefix adder's edges: a ragged n, the
# jacobi1d replay length (neither a multiple of 32 elements, nor of a
# warp's 1024, nor of an adder block's chunk), and every ordered pair of
# each dtype's extremes
RAGGED = [(3, 37), (1, 655358)]
EXTREMES = {np.int32: [-2 ** 31, -1, 2 ** 31 - 1, 0, 1, 3],
            np.int8: [-128, 127, -1, 0, 1, 3]}
# MWS page counts held on the card: the main path's 1-3, the kernel's
# 4-page instance, and two through its general instance
MWS_PAGES = range(1, 7)
# the IFP multiplier's edges: n % 4 = 1, 2, 3 (the elements after its last
# whole 16 bytes), and the round counts at and around the ends of 0..32
SHIFT_RAGGED = [(1, 4097), (1, 4098), (1, 4099), (3, 37)]
SHIFT_BITS = (0, 1, 7, 31, 32)
# the match line's record widths: its 16-byte path (4) and its
# one-record-a-thread path (the rest)
SEARCH_EDGE_WPR = (1, 2, 3, 4, 8, 16, 32)
# the serving path: the default --arch of repro.launch.serve
SERVE_ARCH = "tinyllama-1.1b"
# full width and depth, bf16: two batches of four 1024-token prompts
SERVE_FULL = {"n_requests": 8, "batch": 4, "prompt_len": 1024,
              "max_new": 16}
# the pinned run: reduced config, fp32, weights from jax_layout_params
SERVE_PINNED = {"n_requests": 4, "batch": 2, "prompt_len": 8, "max_new": 4}

# Phase 10, the LM families (the configs phase 6 and 9 do not cover)
FAMILY_ARCHS = ("qwen2-vl-2b", "zamba2-1.2b", "xlstm-125m",
                "seamless-m4t-medium", "dbrx-132b", "deepseek-v2-236b")
# zamba2's reduced config keeps the first four blocks of its pattern, all
# mamba; the pinned one holds a whole period, so that the shared block runs
ZAMBA2_PERIOD = ("mamba",) * 6 + ("sattn",)
# the configs whose stubs go through prefill (and, for frames, decode)
FAMILIES_EXTRAS = ("qwen2-vl-2b", "seamless-m4t-medium")
# patch stubs a VLM prompt carries (repro/launch/steps.py extra_inputs)
N_PATCHES = 64
# the pinned stubbed run: prefill of two 8-token prompts, 4 decode steps
FAMILIES_PINNED_EXTRAS = {"batch": 2, "prompt_len": 8, "max_new": 5}
# published widths, bf16: one batch of 4 prompts x 1024 tokens, prefill
# and 7 decode steps (8 greedy tokens)
FAMILIES_FULL = {"batch": 4, "prompt_len": 1024, "max_new": 8}
# the depth cuts: the whole models (263 GB and 477 GB of bf16 weights)
# outgrow one card's 80 GB; 4 layers with all their experts
FAMILIES_DEPTH = {"dbrx-132b": 4, "deepseek-v2-236b": 4}
# flash-attention launches of a FAMILIES_FULL run (prefill, decode steps):
# qwen2-vl 28 layers at [48, 1088, 128]; zamba2's 6 shared blocks at
# [128, 1024, 64]; seamless 12 encoder [64, 256, 64] + 12 self [64, 1024,
# 64] + 12 cross [64, 1024 -> 256, 64] in prefill, then the encoder again
# for enc_out and 12 cross [64, 1 -> 256, 64] a step; dbrx 4 layers at
# [192, 1024, 128]; none in xlstm (no attention) or deepseek (MLA)
# the full-width prefill's last-token logits through the kernel against
# the einsum path (flash=False): max |diff| at most this share of the
# largest |logit|.  Both paths round to bf16 at every layer, and the
# kernel normalises by its rounded weights (ATTN_TOL's 1e-2 a call);
# reduced to 4 layers on the CPU they differ by 0.5-1.2 % of it, and
# a wrong kernel moves logits by their own size
FAMILIES_LOGIT_RTOL = 0.1
FAMILIES_K6 = {"qwen2-vl-2b": (28, 0), "zamba2-1.2b": (6, 0),
               "xlstm-125m": (0, 0), "seamless-m4t-medium": (36, 12 + 7 * 12),
               "dbrx-132b": (4, 0), "deepseek-v2-236b": (0, 0)}

# The JAX package's greedy tokens of phase 10's pinned runs
# (family_config(arch), jax_layout_params(cfg, seed=0)): "serve" the
# serving loop at SERVE_PINNED's sizes on the prompts of serve(seed=0);
# "extras" the prefill and serve steps at FAMILIES_PINNED_EXTRAS on
# family_prompts and family_extras(seed=0).  output_digest of each
# request's tokens, in order; tests/test_torch_chip_smoke.py recomputes
# them with the JAX package's steps.
FAMILIES_REFERENCE = {
    "qwen2-vl-2b": {
        "serve": [
            "3794a7dc031f135c896667e932a04c2d"
            "e81dfbe5147e01ecd3649b12e393e277",
            "b1a9edacd6e7d842da5c1823f000d7da"
            "8e42eab8f8707de4db1115676e218f58",
            "aec9a743ca53de8a7a2d06858cb2ed80"
            "32969be092fcefcd07c26e82379aa7fa",
            "1ebbccb5c12d62a633e47c5d446a040d"
            "8d595e544f098b23d1a80afaeafb4144"],
        "extras": [
            "0726411dfb2c161f54983a23d149a9b8"
            "18e84500a97537ea0c81ba27bd1277a1",
            "0a268b3fbfb3d2366ac5fc7117062cbc"
            "d0ec655a467e334a5f79b4a82720b725"]},
    "zamba2-1.2b": {
        "serve": [
            "8cfd070e4db7d758baf6e789ce1a2afb"
            "a51bab36b420b66f221f57f96e1fb5df",
            "ab494571b82489e6b47005224d60e152"
            "f47a790d8bfa131e064a5e8bfa08a489",
            "4d6550f369539e3f56cbcfd6f542f60a"
            "06248fcbbe5f722b8d3e345b1bcc6027",
            "fefda00bb9b1215bc6446b7063fc5e0a"
            "54a5e0bde802de377a657d953d93b9b7"]},
    "xlstm-125m": {
        "serve": [
            "e553f4a0463587285a4b731770722ffd"
            "0aa6e445440e5a624b57cf0279aaf8fb",
            "45a904f344f8bff4fd8df0ff886a2fdb"
            "13a0f35c5acd69d9c9c65317ac476d32",
            "23a06f2d74302841ebe8f2da7a74fd97"
            "efebef8df525fe813cd0dcb3e4ffe848",
            "817614c89d010a11a16f2ee930ac5834"
            "6281b5e3495076d175ed94e15b20529e"]},
    "seamless-m4t-medium": {
        "serve": [
            "067f5740b4b406319d485c5d5c531c67"
            "9002763b6e371bf3cc0d1425bf2333d8",
            "496b2100d290ea97aac59cc4289f0b84"
            "5c16ae90b327f765a000599c98df5ed0",
            "7c4cef68079c2ec8700e58a9d6a97ac8"
            "4dae572ef383bde7bd246f7c64dd423b",
            "23d95767ec01712d1fe0e5a58f1b9d06"
            "4435ea1dd7b5cf9ceeb930d2b2fd35e0"],
        "extras": [
            "b5701eb7d6c7d3c49d44c89e4defdf99"
            "7e0ebb7bea368065fac20ea0ea125a22",
            "dd954292f9c064934be3f46e9215736c"
            "64585ccbaf7343f2c7832849bdce6b62"]},
    "dbrx-132b": {
        "serve": [
            "0bf5eae8079bf1af177561f683d65a0d"
            "be363b965811a2cefed143d449229ac6",
            "d96314082ef0c22697083fc98fcf62b4"
            "36857bb9c0444a23365cd8f64f9ff6b2",
            "cacefe3b6d6234ad8216a53dcbea1247"
            "94ae7481e229d2d8d28aae3b50dd60f8",
            "5cd6ae1186cd45e8748208386e05b52b"
            "ee7a78d5cbf55b755c4398a5bb7211f6"]},
    "deepseek-v2-236b": {
        "serve": [
            "914c940a7b0d60de4e5329c8925d8907"
            "cbb15225da35dc09270b39675cfafd19",
            "49fb3919d3265041e75bebb275c2883c"
            "95dfcdd7fb57fe59d86bbe4caa7c1c5f",
            "bd810e031c56e26ddb7fd0bc4b4e9a3e"
            "4f23d368cc28589cd61b762b57c9f8b6",
            "bb3ca153eec7b224297d01f153cf4a87"
            "ec7181f60a9eb3907f2e6bca54be4957"]}}

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
    "llama2_infer": {
        "row": {"vectorizable_pct": 99.3, "avg_reuse": 1.7, "low_pct": 0,
                "medium_pct": 55, "high_pct": 45, "instrs": 15989},
        "conduit_makespan_ns": 341937142.7739298,
        "numeric_sha256": "868e385395133e28feda427b671da1f2"
                          "af73db3a9b821e7aa595adcd0e665ad3"},
    # no sha256: torch autograd and jax.value_and_grad sum in other orders,
    # so the fp32 step is equal only within a tolerance (TRAIN_TOL); pinned
    # are the loss and the L1 norm of the SGD step over every parameter
    "llm_train": {
        "row": {"vectorizable_pct": 99.3, "avg_reuse": 1.9, "low_pct": 0,
                "medium_pct": 52, "high_pct": 48, "instrs": 69036},
        "conduit_makespan_ns": 496250020.29490834,
        "loss": 9.1482515335083,
        "step_l1": 304.3739208225464},
}
# llm_train's tolerances against the JAX package's fp32 step: the loss
# within 1e-5 absolute, and the L1 norm of the step (sum of |w' - w| in
# float64) within 1e-5 relative.  On the CPU the port's step is 9.5e-7
# (loss) and 5.1e-8 relative (step) from the JAX package's at paper scale
# (tests/test_torch_workloads.py:36-38 holds every parameter within 1e-6).
# The train phase holds its AdamW steps to the same bounds, the global
# gradient norm within 1e-5 relative as the L1 norm, and the learning
# rate within 1e-6 relative (the schedule is float32 in both packages,
# a few ulp apart at most).
TRAIN_TOL = {"loss": 1e-5, "step_l1_rtol": 1e-5, "grad_norm_rtol": 1e-5,
             "lr_rtol": 1e-6}
# The mix phase: jacobi1d and heat3d at paper beside a Zipf (0.95) host
# I/O stream, 30 % reads, on a drive preconditioned to 90 % with greedy GC
# (tests/_golden.py's gc_ftl scenario at the default FTL geometry and
# 20000 requests).  MIX_REFERENCE is the JAX package's result;
# tests/test_torch_chip_smoke.py recomputes it.
MIX_WORKLOADS = ("jacobi1d", "heat3d")
MIX_FTL = dict(prefill=0.9)
MIX_IO = dict(rate_iops=250_000, read_fraction=0.3, n_requests=20_000,
              zipf_theta=0.95)
MIX_REFERENCE = {
    "makespan_ns": 1263123120.1834362,
    "tenant_makespans_ns": [317491726.8500267, 712119955.4764321],
    "n_reads": 6128, "n_writes": 13872,
    "host_pages_written": 13872, "gc_pages_copied": 3460,
    "blocks_erased": 273, "gc_invocations": 59, "overflow_blocks": 180}
# The open-loop phase: a session catalog of jacobi1d and heat3d at paper
# (weights 3:1, catalog seed 5), Poisson sessions (64, seed 9).
# simulate_serving under conduit at a rate under its saturation and one
# over it, with the flight recorder on for the analysis report;
# find_saturation (and batched_find_saturation, which must equal it) at a
# 50 ms p99 SLO for three policies; simulate_fleet as
# examples/fleet_serving.py configures it (3 drives, hash placement, two
# replicas, drive 0 collecting garbage under write churn) with recorders on.
# OPEN_LOOP_REFERENCE holds the JAX package's results as digests of their
# plain data (result_digest); tests/test_torch_chip_smoke.py recomputes it.
OPEN_LOOP_CATALOG = (("jacobi1d", 3.0), ("heat3d", 1.0))
OPEN_LOOP_CATALOG_SEED = 5
OPEN_LOOP_SESSIONS = 64
OPEN_LOOP_SEED = 9
OPEN_LOOP_RATES = (10.0, 40.0)               # sessions/s
OPEN_LOOP_POLICIES = ("conduit", "bw", "dm")
OPEN_LOOP_SEARCH = dict(slo_p99_ns=50e6, rate_lo=1.0, rate_hi=200.0,
                        iters=6)
OPEN_LOOP_TELEMETRY = dict(spans=True, audit=True, interval_ns=1e6)
# the fleet's recorders keep the spans fleet_blame reads, not the audit
OPEN_LOOP_FLEET_TELEMETRY = dict(spans=True, audit=False, interval_ns=1e6)
OPEN_LOOP_FLEET_RATE = 20.0                  # sessions/s across the fleet
OPEN_LOOP_FLEET_CHURN = 1200                 # drive 0's host writes
ANALYSIS_GIT_SHA = "chip-smoke"   # the report's git_sha, fixed for its digest
OPEN_LOOP_REFERENCE = {
    "serving@10":
        "e2621fdb34bf9a4336bbe53585bf26a92de30e9348d1f3967418e9064afdea74",
    "analysis@10":
        "2b04296f673c7a6558ee4eee24fab9319f5e0af5952a01b231312c545c97b216",
    "serving@40":
        "d6aff4d0608d5f98022aa4e71b736df0f6f2fc36391874d83b364d257b1c6292",
    "analysis@40":
        "de9e9c50f3654473d95be959b82400ed74d1e1359e4952571b34420e52128bca",
    "saturation/conduit":
        "def3309af95dfc5cc4b584b5eb00afe8f97ce6b82d16747fceef0c6af9518550",
    "saturation/bw":
        "4cf44a29944b62e27ec8ed3a9159156ec114b0924b3160cdcaadb23fdc95968e",
    "saturation/dm":
        "6e80b97b269ef7d5ca16de9150c74edfc8681c28d7698521be17f7cd0e6cce82",
    "fleet":
        "802cdb698a15973b1912850ed058a424c53e27f0a2b497f03237919a924d9e63",
    "fleet_blame":
        "dc62132113ab42ab52f1efabaeed2b466783d317f5d56eda19b1971542f45299"}
# The JAX package's greedy tokens of the pinned serving run (reduced
# tinyllama-1.1b in fp32 on jax_layout_params(cfg, seed=0), SERVE_PINNED,
# the prompts of its serve(seed=0)): output_digest of each request's
# tokens, in request order.  tests/test_torch_chip_smoke.py recomputes
# them with the JAX package's prefill and serve steps.
SERVE_REFERENCE = {"tokens_sha256": [
    "71c2320dc58320cf6f617a86941611a16ca5d3025a3b85b6229aa7d32adf91ea",
    "97e52bc2e8d1fd8bdad649eb9f34897d258da6fc96c36a4d21bd9c8c2c74e608",
    "e23d31ac734784fed22b7bd93aa4bc0c94332db4bbe170c6b19cd7457d8039a0",
    "001b3cba040c4bc14856d52d3af2f8b70952b698aefd7039ce4052b051a41958"]}
# The train phase.  (a) pinned: the serving phase's pinned config and
# weights (reduced tinyllama-1.1b, fp32, jax_layout_params(cfg, seed=0))
# with zero AdamW state, three steps of build_train_step(cfg,
# total_steps=3, base_lr=1e-3) on SyntheticLM(cfg.vocab, 32, 4, seed=0)
# batches 0-2 (TRAIN_PINNED_STREAM), whole and in two microbatches.
# TRAIN_LM_REFERENCE holds the JAX package's metrics of each step (keyed
# by microbatches) and the L1 norm of its update;
# tests/test_torch_chip_smoke.py recomputes them with
# repro.launch.steps.build_train_step.
TRAIN_PINNED = {"seq": 32, "batch": 4, "steps": 3, "base_lr": 1e-3}
# Those batches as the JAX package draws them: numpy's Generator.zipf
# draws other values from one seed in numpy 2.0 and 2.3, so a SyntheticLM
# made beside another numpy gives other tokens.  Each step's [batch,
# seq + 1] stream (tokens are its first seq columns, labels its last) as
# little-endian uint16, base64; tests/test_torch_chip_smoke.py holds it
# equal to both packages' SyntheticLM batches.
TRAIN_PINNED_STREAM = (
    "nQCeAHEAQABBAHcBBAAAAAEAdQBTAQEAAgADAEQARQACAAAA7QDfAQYAAgAMAAAA"
    "BAAIAB4AHwCtAK4AAAAZABoAAAABAAIAAwACAQMBBwAIAAMA0gAAAFEApwEEAJ8B"
    "bgE2AJoAAAAAAAEAAwAEAGYACQDgANAB0QF5AAEADwA8AAEAJwBtAQAAAQACAAgB"
    "SQBKAAEAAAAAALEAVgEAAAEAAgANAe4BAAABAHwAUwEAAAoACwDEAfUB9gH3ATAA"
    "DAABAAIAkABDAAoACwAMAAAAAQACAB8AAQA/AEAAQQA+AG8AgQEBAAgAPQAjAGQB"
    "AgAAAAEAAgADAA0BAQAHALoBGAAAAEsArwEAABMBgwAAAAEA9gBLAAAAAwAQABEA"
    "EgAHAKYApwAKAAsADAACAAMACABUAGwBbQEMAAAAAQAAAPkB+gFBAH8AAQAUAAAA"
    "EgHdAFAAUQABAAIAFwAFAQYBBwECAAAAewEAABYAAAABAAIAAAABAAAAAQACAAEA"
    "xgAAAAEAAAAVABYABQAFAAEAAgD3AQUABgAHAAgABgCVAZYBawFsAW0BjQBAAAAA"
    "GAAZAAEAAgAAAAEAAgADAAQABQAGAAIBkQEDAQQBkgGTAQAAEQASABMARgBHAAAA"
    "AQAtAGIBYwFkAbMBewA3ABUAFgAQAAAApQAAAAEAAgADAIMBhAEUABUAFgDXANgA"
    "AABiAAAAAAAZABoAGwAcADYAAwAAAAYAAQBLAEwAOQAFAEYARwBIAAAAAQACAAYA"
    "BwAAABQAHAAAAJcAcQE1APsBOgAAAAEAAgCvALAAAAAHAAgAkQCSAJMAGwFLAEwA"
    "6QEGAAcAAgADAAQABgADAAQABQBpAQIAEABvAHAAcQByAAAAJAAAAAEAJgEAAAUA"
    "VwFYARgAKAApAAgACQBjAGQAZQAVAM8AAAAAAAEA+QAGAKoAagBVAFYAAAAAAAEA"
    "AgADAAQACwDWADUAAQACAAkABQAGAAEAAAAAAAEABgAHAAgAZwFoAWkBDAANAAAA"
    "JQAmAFkALgEvAQAAAQAsASYAAAABACYA")
TRAIN_LM_REFERENCE = {
    1: [{"loss": 6.791132926940918, "lr": 0.00010000000474974513,
         "grad_norm": 11.107434272766113, "step_l1": 69.8164639514367},
        {"loss": 6.765918731689453, "lr": 0.00020000000949949026,
         "grad_norm": 13.32223892211914, "step_l1": 94.53674616340099},
        {"loss": 6.705817699432373, "lr": 0.0003000000142492354,
         "grad_norm": 12.461749076843262, "step_l1": 117.88666881342087}],
    2: [{"loss": 6.791132926940918, "lr": 0.00010000000474974513,
         "grad_norm": 11.107434272766113, "step_l1": 69.81646367397704},
        {"loss": 6.7659196853637695, "lr": 0.00020000000949949026,
         "grad_norm": 13.322239875793457, "step_l1": 94.53674658731859},
        {"loss": 6.705817222595215, "lr": 0.0003000000142492354,
         "grad_norm": 12.461750984191895, "step_l1": 117.88667720704973}]}
# (b) restart: train() on the pinned config, checkpoints every 2 steps,
# straight and under run_elastic with a failure injected at step 4.
TRAIN_RESTART = {"steps": 6, "batch": 4, "seq": 32, "ckpt_every": 2,
                 "fail_at": 4}
# (c) full width and depth, bf16, remat: batch 4 x 1024 tokens (two
# SDPA_CHUNK q blocks), six steps, the step time the median of the last
# five
TRAIN_FULL = {"steps": 6, "batch": 4, "seq": 1024, "base_lr": 1e-3}
# the ATen ops printed from the profiled step, by device time
TRAIN_PROFILE_ROWS = 16
# the arch name under which train() finds the pinned config
PINNED_ARCH = "tinyllama-1.1b-pinned"
# run_numeric's output dtype where it is not the JAX package's int32: the
# tokens torch.argmax gives are int64 (jnp.argmax gives int32); the digest
# reads every output as int32
OUTPUT_DTYPES = {"llama2_infer": torch.int64}

REPLACES = {"bitserial_add": "src/repro/kernels/bitserial.py:19",
            "bitserial_mul": "src/repro/kernels/bitserial.py:34",
            "shift_add_mul": "src/repro/kernels/shift_add.py:21",
            "mws_bitwise": "src/repro/kernels/mws.py:27",
            "search_pages": "src/repro/kernels/search.py:24",
            "int8_matmul": "src/repro/kernels/int8_matmul.py:18",
            "flash_attention": "src/repro/kernels/attention.py:21"}


# Phase 11, distributed planning.  (a) The dry-run cells, each on rank 0
# of a fake process group of the mesh's size (arch, shape, multi_pod):
# FSDP and tensor-parallel training; the pod axis, MLA caches and the
# expert-parallel MoE; the sub-quadratic cell with sharded SSM state.
PLANNING_CELLS = (("tinyllama-1.1b", "train_4k", False),
                  ("deepseek-v2-236b", "decode_32k", True),
                  ("zamba2-1.2b", "long_500k", False))
# the fake mesh's device type: the card's, so that DTensor moves a shard
# from one dim to another by an all-to-all (a cpu mesh gathers instead)
PLANNING_MESH_DEVICE = "cuda"
# The JAX package's per-device argument bytes of each cell: its
# input_specs on the production mesh, each leaf's shard under its
# PartitionSpec, summed (the decode position an int32 scalar);
# tests/test_torch_chip_smoke.py recomputes them from the JAX package
PLANNING_REFERENCE = {("tinyllama-1.1b", "train_4k", "16x16"): 44412932,
                      ("deepseek-v2-236b", "decode_32k", "2x16x16"):
                          1502773780,
                      ("zamba2-1.2b", "long_500k", "16x16"): 1624541192}
# (b) deepseek-v2-236b's MoE layer at its published width on one batch of
# 4 x 1024 tokens: t * k = 24576 > 1024, so the single-device path and the
# expert-parallel path (a 1 x 1 mesh over a one-rank NCCL group) both
# bound each expert at int(1.25 * 24576 / 160) = 192 slots
PLANNING_MOE = {"arch": "deepseek-v2-236b", "batch": 4, "seq": 1024}


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


# one-letter and literal template arguments of an Itanium-mangled name
_MANGLED_ARG = re.compile(r"([hjxyf])|L([ib])(\d+)E")
_ELEM = {"h": "u8", "j": "u32", "x": "i64", "y": "u64", "f": "f32"}


def kernel_label(name: str) -> str:
    """A readable name of one kernel instance: the ``*_kernel`` identifier
    of the mangled ``name`` and its template arguments (h uint8, j uint32,
    x long long, f float, Li<k>E an int, Lb<k>E a bool)."""
    for digits in re.finditer(r"(?=(\d+))", name):
        end = digits.start() + len(digits.group(1))
        ident = name[end:end + int(digits.group(1))]
        if not ident.endswith("_kernel"):
            continue
        rest, args = name[end + len(ident):], []
        if rest.startswith("I"):
            pos = 1
            while (m := _MANGLED_ARG.match(rest, pos)) is not None:
                args.append(_ELEM[m.group(1)] if m.group(1)
                            else int(m.group(3)))
                pos = m.end()
        if ident == "mws_kernel" and len(args) == 4:
            elem, op, pages, index = args
            args = [elem, MWS_OPS[op], f"{pages or 'any'} pages",
                    "32-bit index" if index == "u32" else "64-bit index"]
        elif ident == "bitserial_add_kernel" and len(args) == 2:
            args = [args[0], "16-byte I/O" if args[1] else "unaligned"]
        elif ident == "shift_add_mul_kernel" and len(args) == 2:
            args = [f"{args[0] or 'any'} rounds",
                    "16-byte I/O" if args[1] else "unaligned"]
        elif ident == "search_chunk_kernel":
            args = ["wpr 4", "16-byte loads"]
        elif ident == "int8_matmul_mma_kernel" and len(args) == 2:
            args = [f"{16 * args[0]} rows",
                    "16-byte loads" if args[1] else "byte loads"]
        elif ident == "flash_attn_mma_kernel":
            args = ["bf16", f"dh {args[0]}"]
        elif ident == "flash_attn_kernel":
            args = [args[0], f"dh {args[1]}"]
        return f"{ident}<{', '.join(map(str, args))}>" if args else ident
    return name


# the SASS opcodes sass_report counts: integer logic and shifts, the FMA
# pipe's integer ops, bf16 tensor-core (HMMA) and int8 tensor-core (IMMA)
# products, and __dp4a (IDP)
COUNTED_OPCODES = ("LOP3", "IMAD", "SHF", "HMMA", "IMMA", "IDP")


def sass_instructions(chunk: str) -> list:
    """``(address, opcode, operands)`` of every instruction of one
    function's ``cuobjdump -sass`` listing, predicates dropped."""
    return [(int(addr, 16), op, rest) for addr, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
        r"([A-Z][A-Z0-9_.]*)([^;]*);", chunk)]


def opcode_counts(instrs) -> dict:
    """Static count of each of COUNTED_OPCODES (the opcode before its first
    '.') in ``instrs``."""
    ops_ = [op.split(".")[0] for _, op, _ in instrs]
    return {op: ops_.count(op) for op in COUNTED_OPCODES}


def loop_ranges(instrs) -> list:
    """``(first, last)`` address of each loop body: from a backward
    branch's target to the branch."""
    loops = []
    for addr, op, rest in instrs:
        target = re.match(r"\s*(0x[0-9a-f]+)", rest)
        if op.startswith("BRA") and target and \
                int(target.group(1), 16) < addr:
            loops.append((int(target.group(1), 16), addr))
    return loops


# the elementwise kernels whose 16-byte instances (a "16-byte" label) must
# run a loop that holds a 16-byte global load, without spilling
VECTOR_KERNELS = ("bitserial_add_kernel", "shift_add_mul_kernel",
                  "search_chunk_kernel")


def vector_unit(label: str):
    """(count, noun, loads) of the work behind ``loads`` 16-byte loads of
    a 16-byte loop body: 4 int32 or 16 int8 elements from two loads (adder,
    IFP multiplier), or one 4-word record from one (match line).  A body
    the compiler unrolled holds a multiple of ``loads``."""
    if label.startswith("search_chunk_kernel"):
        return 1, "record", 1
    return (16 if "u8" in label else 4), "element", 2


def vector_loop_report(label: str, instrs, use: dict) -> list:
    """Lines that report each loop of a 16-byte instance of
    VECTOR_KERNELS that holds a 16-byte global load (LDG...128): its
    instructions, per unit of work (counted from its 16-byte loads), and
    its opcodes.  Raises AssertionError when there is no such loop, or
    when ptxas reported spills (``use`` from :func:`ptxas_usage`).  Other
    kernels: []."""
    if not (label.startswith(VECTOR_KERNELS) and "16-byte" in label):
        return []
    count, noun, loads = vector_unit(label)
    lines = []
    for first, last in loop_ranges(instrs):
        body = [op for addr, op, _ in instrs
                if first <= addr <= last and op != "NOP"]
        wide = sum(op.startswith("LDG") and ".128" in op for op in body)
        if not wide:
            continue
        units = max(1, wide // loads) * count
        hist = {}
        for op in body:
            hist[op] = hist.get(op, 0) + 1
        article = "an" if noun.startswith("e") else "a"
        lines.append(f"16-byte loop body: {len(body)} instructions for "
                     f"{units} {noun}{'s' if units > 1 else ''} a thread, "
                     f"{len(body) / units:g} "
                     f"{article} {noun}; opcodes {dict(sorted(hist.items()))}")
    if not lines:
        raise AssertionError(f"{label}: no loop with a 16-byte load")
    if use.get("spill_stores") or use.get("spill_loads"):
        raise AssertionError(f"{label} spills: {use}")
    return lines


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes per mangled kernel name from ``ptxas
    -v``'s log: ``{name: {"registers", "stack", "spill_stores",
    "spill_loads"}}``."""
    usage, name = {}, None
    for line in log.splitlines():
        if (m := re.search(r"Function properties for (\S+)", line)):
            name = m.group(1)
            usage[name] = {}
        elif name and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", line)):
            usage[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name]["registers"] = int(m.group(1))
    return usage


def sass_report(lib_path: str, nvcc: str, usage: dict) -> dict:
    """Print, per kernel, what the compiler made of its loops: SASS
    instruction count, the counts of COUNTED_OPCODES (static: code the
    compiler copies for a divergent warp counts again), the length of each
    loop body (instructions from a backward branch's target to the
    branch), and its registers, stack and static shared bytes (``cuobjdump
    -res-usage``).  For the 16-byte instances of the prefix adder, the IFP
    multiplier and the match line, the body of each loop that holds a
    16-byte load, per unit of work, and its opcodes; such an instance
    without that loop, or with spills in ``usage`` (:func:`ptxas_usage`),
    fails.  Returns the opcode counts by kernel label ({} when
    ``cuobjdump`` is missing, which is reported, not fatal)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(tool):
        print(f"  sass: {tool} not found")
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    resources = dict(re.findall(
        r"Function (\S+):\s*\n\s*(REG:\d+ STACK:\d+ SHARED:\d+ LOCAL:\d+)",
        subprocess.run([tool, "-res-usage", lib_path], capture_output=True,
                       text=True, check=True, timeout=120).stdout))
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split()[0]
        label = kernel_label(name)
        instrs = sass_instructions(chunk)
        ops_ = [op.split(".")[0] for _, op, _ in instrs]
        counts[label] = opcode_counts(instrs)
        loops = loop_ranges(instrs)
        real = [o for o in ops_ if o != "NOP"]
        print(f"  sass {label}: {len(real)} instructions, "
              + ", ".join(f"{op} {n}" for op, n in counts[label].items())
              + f"; loop bodies "
              f"{sorted((b - a) // 16 + 1 for a, b in loops)}; "
              f"{resources.get(name, 'resource usage not found')}")
        for line in vector_loop_report(label, instrs, usage.get(name, {})):
            print("    " + line)
    return counts


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


def attn_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs attention scores: all of them, or under the
    top-left causal mask the keys 0..i of query i."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def plane_mul_ops(w: int) -> float:
    """Integer operations per element of the bit-plane multiplier for W-bit
    elements, 32 a lane: W(W+1)/2 full adders of three gates (the partial
    product's AND, the XOR sum, the MAJ carry), and three butterfly
    transposes of log2 W stages over W/2 word pairs, ~6 operations a
    pair."""
    adders = 3 * w * (w + 1) // 2
    transposes = 3 * 6 * (w // 2) * int(math.log2(w))
    return (adders + transposes) / 32


def prefix_add_ops(w: int) -> int:
    """Instructions per element of the prefix adder for W-bit elements (one
    a word): p and g, log2 W levels of g |= p & (g << d) (a shift and a
    LOP3), log2 W - 1 of p &= p << d (a shift and an AND), and the sum's
    shift and 3-input XOR."""
    levels = int(math.log2(w))
    return 2 + 2 * levels + 2 * (levels - 1) + 2


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


def quantize(x):
    """Per-tensor symmetric INT8 quantization (the §5.4 lanes): int8 values
    in [-127, 127] and the fp32 scale that maps them back."""
    scale = x.abs().max().clamp_min(torch.finfo(torch.float32).tiny) / 127
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale


def replay_llama2_infer(numeric, scale, device):
    """``infer`` (prefill, then greedy decode) with every 2-D ``x @ W`` in
    the INT8 lanes: both operands quantized, multiplied by the INT8 GEMM,
    dequantized.  The two per-head einsums stay fp32.  Each GEMM's output
    is held against the plain version's on the same operands; the tokens
    and the logits' distance from the fp32 forward are printed as
    information."""
    p = llama2_infer.SCALES[scale]
    params, tokens, cos, sin, mask = make_inputs("llama2_infer", scale,
                                                 device=device)
    got, want = [], []

    def mm(x, w):
        qx, sx = quantize(x)
        qw, sw = quantize(w)
        acc = ops.int8_matmul(qx, qw)
        got.append(acc.reshape(-1))
        want.append(ref.int8_matmul_plain(qx, qw).reshape(-1))
        return acc.float() * (sx * sw)

    def attention(x, layer):
        seq, d = x.shape
        heads = p["n_heads"]
        q, k, v = (mm(x, layer[w]).reshape(seq, heads, d // heads)
                   .permute(1, 0, 2) for w in ("wq", "wk", "wv"))
        q, k = _llama.rope(q, cos, sin), _llama.rope(k, cos, sin)
        scores = torch.einsum("hqd,hkd->hqk", q, k) / math.sqrt(d // heads)
        probs = torch.softmax(torch.where(mask, scores, -1e9), dim=-1)
        out = torch.einsum("hqk,hkd->hqd", probs, v)
        return mm(out.permute(1, 0, 2).reshape(seq, d), layer["wo"])

    def forward(tokens):
        x = params["emb"][tokens]
        for layer in params["layers"]:
            x = x + attention(_llama.rmsnorm(x, layer["ln1"]), layer)
            h = _llama.rmsnorm(x, layer["ln2"])
            x = x + mm(torch.nn.functional.silu(mm(h, layer["w1"]))
                       * mm(h, layer["w3"]), layer["w2"])
        return mm(_llama.rmsnorm(x, params["lnf"]), params["emb"].T)

    emitted, err = [], 0.0
    for step in range(1 + p["decode_steps"]):
        if step:
            tokens = torch.cat([tokens[1:], nxt[None]])
        logits = forward(tokens)
        exact = _llama.forward(params, tokens, cos, sin, mask, p["n_heads"])
        err = max(err, float((logits - exact).abs().max()))
        nxt = torch.argmax(logits[-1])
        emitted.append(int(nxt))
    print(f"  llama2_infer INT8 lanes: tokens {emitted}, fp32 tokens "
          f"{numeric['llama2_infer'].tolist()}; largest |logit - fp32 "
          f"logit| {err!r} (information only)")
    return torch.cat(got), torch.cat(want)


class Int8Linear(torch.autograd.Function):
    """``x @ w`` in the INT8 lanes, forward and backward: the forward
    quantizes ``x`` and ``w`` and multiplies them through ``gemm``; the
    backward quantizes ``dY`` and makes ``dX = q(dY) q(W)^T`` and ``dW =
    q(X)^T q(dY)`` through the same ``gemm``, each dequantized by its
    operands' scales."""

    @staticmethod
    def forward(ctx, x, w, gemm):
        qx, sx = quantize(x)
        qw, sw = quantize(w)
        ctx.save_for_backward(qx, qw, sx, sw)
        ctx.gemm = gemm
        return gemm(qx, qw).float() * (sx * sw)

    @staticmethod
    def backward(ctx, dy):
        qx, qw, sx, sw = ctx.saved_tensors
        qdy, sdy = quantize(dy)
        dx = ctx.gemm(qdy, qw.T).float() * (sdy * sw)
        dw = ctx.gemm(qx.T, qdy).float() * (sx * sdy)
        return dx, dw, None


def step_l1(new_params, params) -> float:
    """The L1 norm of an SGD step, sum of |w' - w| over every parameter,
    in float64."""
    return sum(float((a.double() - b.double()).abs().sum())
               for a, b in zip(pytree.tree_leaves(new_params),
                               pytree.tree_leaves(params)))


def replay_llm_train(numeric, scale, device):
    """``train_step`` with every ``x @ W`` through :class:`Int8Linear`:
    3 INT8 GEMMs a product (one forward, two backward).  The two per-head
    einsums stay fp32.  Each GEMM's output is held against the plain
    version's on the same operands; the loss and the largest parameter
    difference from the fp32 step are printed as information."""
    p = llm_train.SCALES[scale]
    params, tokens, labels, cos, sin, mask = make_inputs(
        "llm_train", scale, device=device)
    got, want = [], []

    def gemm(a, b):
        acc = ops.int8_matmul(a, b)
        got.append(acc.reshape(-1))
        want.append(ref.int8_matmul_plain(a, b).reshape(-1))
        return acc

    def mm(x, w):
        return Int8Linear.apply(x, w, gemm)

    def attention(x, layer):
        seq, d = x.shape
        heads = p["n_heads"]
        q, k, v = (mm(x, layer[w]).reshape(seq, heads, d // heads)
                   .permute(1, 0, 2) for w in ("wq", "wk", "wv"))
        q, k = _llama.rope(q, cos, sin), _llama.rope(k, cos, sin)
        scores = torch.einsum("hqd,hkd->hqk", q, k) / math.sqrt(d // heads)
        probs = torch.softmax(torch.where(mask, scores, -1e9), dim=-1)
        out = torch.einsum("hqk,hkd->hqd", probs, v)
        return mm(out.permute(1, 0, 2).reshape(seq, d), layer["wo"])

    def loss_fn(params):
        x = params["emb"][tokens]
        for layer in params["layers"]:
            x = x + attention(_llama.rmsnorm(x, layer["ln1"]), layer)
            h = _llama.rmsnorm(x, layer["ln2"])
            x = x + mm(torch.nn.functional.silu(mm(h, layer["w1"]))
                       * mm(h, layer["w3"]), layer["w2"])
        logits = mm(_llama.rmsnorm(x, params["lnf"]), params["emb"].T)
        gold = torch.take_along_dim(logits, labels[:, None], dim=-1)[:, 0]
        return (torch.logsumexp(logits, dim=-1) - gold).mean()

    leaves, spec = pytree.tree_flatten(params)
    leaves = [w.detach().requires_grad_() for w in leaves]
    loss = loss_fn(pytree.tree_unflatten(leaves, spec))
    grads = torch.autograd.grad(loss, leaves)
    new = [(w - 0.01 * g).detach() for w, g in zip(leaves, grads)]
    fp32_loss, fp32_new = numeric["llm_train"]
    err = max(float((a - b).abs().max())
              for a, b in zip(new, pytree.tree_leaves(fp32_new)))
    print(f"  llm_train INT8 lanes: loss {float(loss.detach())!r}, fp32 loss "
          f"{float(fp32_loss)!r}; largest |w' - fp32 w'| {err!r} "
          f"(information only)")
    return torch.cat(got), torch.cat(want)


def mix_counters(sim, traces) -> dict:
    """``sim.simulate_mix`` of ``traces`` under conduit with MIX_IO's host
    I/O stream and MIX_FTL's garbage-collected drive; ``sim`` is a
    package's ``sim`` module, so the same run is made by either package."""
    ftl = sim.FTLConfig(**MIX_FTL)
    io = sim.HostIOStream(n_logical_pages=ftl.logical_pages(), **MIX_IO)
    m = sim.simulate_mix(traces, "conduit", io_stream=io, ftl=ftl,
                         compute_solo=False)
    return {"makespan_ns": m.makespan_ns,
            "tenant_makespans_ns": [t.makespan_ns for t in m.tenants],
            "n_reads": m.host_io.n_reads, "n_writes": m.host_io.n_writes,
            "host_pages_written": m.ftl.host_pages_written,
            "gc_pages_copied": m.ftl.gc_pages_copied,
            "blocks_erased": m.ftl.blocks_erased,
            "gc_invocations": m.ftl.gc_invocations,
            "overflow_blocks": m.ftl.overflow_blocks}


def plain(x):
    """A simulator result as JSON-able plain data, by field name, with every
    float as its exact repr; the same for either package's classes."""
    if x is None or isinstance(x, (bool, int, str)):
        return x
    if isinstance(x, float):
        return repr(x)
    if isinstance(x, enum.Enum):
        return plain(x.value)
    if dataclasses.is_dataclass(x):
        return {"__type__": type(x).__name__,
                **{f.name: plain(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return [[plain(k), plain(v)] for k, v in x.items()]
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if hasattr(x, "chrome_trace"):                 # a flight recorder
        text = json.dumps(x.chrome_trace())        # floats as exact reprs
        return {"__type__": type(x).__name__,
                "sha256": hashlib.sha256(text.encode()).hexdigest()}
    raise TypeError(f"no plain form for {type(x).__name__}")


def result_digest(x) -> str:
    return hashlib.sha256(json.dumps(plain(x)).encode()).hexdigest()


def open_loop_steps(sim, traces, n_sessions=OPEN_LOOP_SESSIONS,
                    fleet_churn=OPEN_LOOP_FLEET_CHURN):
    """The open-loop phase through a package's ``sim`` module on
    ``traces`` (workload name -> trace): ``(label, run)`` pairs in order,
    each ``run()`` returning ``(line, digests)`` where ``digests`` maps a
    result's key in OPEN_LOOP_REFERENCE to its result_digest.  The batched
    search runs after the scalar ones and fails unless it equals them.
    The tests cut ``n_sessions`` and the straggler's ``fleet_churn``."""
    catalog = sim.SessionCatalog(
        [sim.CatalogEntry(name, traces[name], weight=w)
         for name, w in OPEN_LOOP_CATALOG], seed=OPEN_LOOP_CATALOG_SEED)
    scalar = {}

    def serving(rate):
        arr = sim.PoissonArrivals(rate_per_sec=rate, n_sessions=n_sessions,
                                  seed=OPEN_LOOP_SEED)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")          # Little's-law notes
            r = sim.simulate_serving(
                catalog, arr, "conduit",
                serving=sim.ServingConfig(keep_session_results=False),
                telemetry=sim.TelemetryConfig(**OPEN_LOOP_TELEMETRY))
        report = r.analysis(git_sha=ANALYSIS_GIT_SHA)
        share = report["blame"]["p99_cohort"]["share"]
        line = (f"completed {r.n_completed}, rejected {r.n_rejected}, "
                f"p50 {r.p(50)!r} ns, p99 {r.p(99)!r} ns, "
                f"{r.completed_rate_per_sec!r} sessions/s; the p99 cohort's "
                f"largest blame share is {max(share, key=share.get)!r}")
        return line, {f"serving@{rate:g}": result_digest(r),
                      f"analysis@{rate:g}": result_digest(report)}

    def saturation(policy):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sat = sim.find_saturation(catalog, policy,
                                      n_sessions=n_sessions,
                                      seed=OPEN_LOOP_SEED,
                                      **OPEN_LOOP_SEARCH)
        scalar[policy] = sat
        line = (f"{sat.rate_per_sec!r} sessions/s, bracket "
                f"{sat.bracket!r}, {len(sat.probes)} probes")
        return line, {f"saturation/{policy}": result_digest(sat)}

    def batched():
        lanes = [sim.SweepLane(policy=p, seed=OPEN_LOOP_SEED,
                               n_sessions=n_sessions)
                 for p in OPEN_LOOP_POLICIES]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = sim.batched_find_saturation(catalog, lanes,
                                              **OPEN_LOOP_SEARCH)
        for p, sat in zip(OPEN_LOOP_POLICIES, got):
            if plain(sat) != plain(scalar[p]):
                raise AssertionError(f"batched_find_saturation {p} differs "
                                     f"from find_saturation")
        return (f"{[s.rate_per_sec for s in got]!r} sessions/s, equal to "
                f"the scalar searches"), {}

    def fleet():
        ftl = sim.FTLConfig(blocks_per_die=4, pages_per_block=8,
                            op_ratio=0.28, prefill=0.9, gc_suspend=True,
                            gc_reserve_blocks=1)
        churn = sim.HostIOStream(rate_iops=150_000, read_fraction=0.1,
                                 n_requests=fleet_churn, zipf_theta=0.9,
                                 n_logical_pages=ftl.logical_pages(),
                                 seed=11)
        cfg = sim.FleetConfig(
            n_drives=3, placement="hash", replication=2,
            profiles=((0, sim.DriveProfile(io_stream=churn, ftl=ftl)),))
        res = sim.simulate_fleet(
            catalog, sim.PoissonArrivals(rate_per_sec=OPEN_LOOP_FLEET_RATE,
                                         n_sessions=n_sessions,
                                         seed=OPEN_LOOP_SEED),
            "conduit",
            serving=sim.ServingConfig(keep_session_results=False,
                                      warmup_ns=1e5, cooldown_ns=1e5,
                                      little_law_warn_tol=float("inf")),
            fleet=cfg,
            telemetry=sim.TelemetryConfig(**OPEN_LOOP_FLEET_TELEMETRY))
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "fleet_trace.json")
            sim.export_fleet_trace(res.telemetry, path)
            with open(path) as f:
                trace = json.load(f)
        errors = sim.validate_trace(trace)
        if errors:
            raise AssertionError(f"merged fleet trace: {errors[:3]}")
        blame = sim.fleet_blame(trace)
        s = blame["straggler"]
        line = (f"fleet p99 {res.p(99)!r} ns, per drive "
                f"{res.per_drive_p(99)!r}; trace valid; straggler drive "
                f"{s['drive']} ({s['tail_share']!r} of the tail, "
                f"{s['dominant_component']!r})")
        return line, {"fleet": result_digest(res),
                      "fleet_blame": result_digest(blame)}

    steps = [(f"simulate_serving conduit @ {r:g}/s",
              lambda r=r: serving(r)) for r in OPEN_LOOP_RATES]
    steps += [(f"find_saturation {p}", lambda p=p: saturation(p))
              for p in OPEN_LOOP_POLICIES]
    steps.append(("batched_find_saturation", batched))
    steps.append(("simulate_fleet", fleet))
    return steps


def replay_plan(numeric, scale="paper", device="cuda"):
    """``(label, replay, launches it must make)`` for every replay, given
    the numeric run's outputs by workload."""
    def counts(**launched):
        return {k: launched.get(k, 0) for k in ops.launch_counts()}

    rounds = WORKLOADS["aes"].SCALES[scale]["rounds"]
    tsteps = WORKLOADS["heat3d"].SCALES[scale]["tsteps"]
    llama = llama2_infer.SCALES[scale]
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
        ("llama2_infer int8 GEMMs",
         lambda: replay_llama2_infer(numeric, scale, device),
         counts(int8_matmul=(7 * llama["n_layers"] + 1)
                * (1 + llama["decode_steps"]))),
        ("llm_train int8 GEMMs",
         lambda: replay_llm_train(numeric, scale, device),
         counts(int8_matmul=3 * (7 * llm_train.SCALES[scale]["n_layers"]
                                 + 1))),
    )


# -- phase 6: the LM serving path ---------------------------------------------
# On CPU tensors ``ops`` takes the plain versions, so these also run, at the
# reduced size, in the CPU tests.

def jax_layout_params(cfg, seed: int) -> dict:
    """fp32 numpy weights of ``cfg`` in the JAX package's parameter tree
    layout (``{"emb", "ln_f", ["unemb"], "segments": [one stacked dict per
    segment, None for a shared-block segment], ["shared_attn"],
    ["encoder"]}``, experts stacked ``[layers, E, ...]``), drawn from
    ``default_rng(seed)`` at the scales of its init (the card has no JAX
    to draw its own); norm gains, Mamba's ``d_skip`` 1 + N(0, 0.1) and its
    ``a_log`` N(0, 0.1).  The segments are drawn first, then the shared
    block, the encoder and the embeddings, so that a dense config's draws
    are those of one ``attn`` segment."""
    rng = np.random.default_rng(seed)
    d, dh, heads = cfg.d_model, cfg.head_dim, cfg.n_heads

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def gain(*shape):
        return 1 + normal(*shape, scale=0.1)

    def dense(lead, d_in, d_out, scale=None):
        return normal(*lead, d_in, d_out,
                      scale=d_in ** -0.5 if scale is None else scale)

    def mlp(lead, ff):
        return {"w1": dense(lead, d, ff), "w3": dense(lead, d, ff),
                "w2": dense(lead, ff, d)}

    def attn(lead, mla):
        if mla:
            r, rd, ql = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.q_lora_rank
            a = {"w_dkv": dense(lead, d, r + rd), "kv_norm": gain(*lead, r),
                 "w_uk": dense(lead, r, heads * dh),
                 "w_uv": dense(lead, r, heads * dh),
                 "wo": dense(lead, heads * dh, d)}
            if ql:
                a.update(w_dq=dense(lead, d, ql), q_norm=gain(*lead, ql),
                         w_uq=dense(lead, ql, heads * (dh + rd)))
            else:
                a["w_q"] = dense(lead, d, heads * (dh + rd))
            return a
        a = {"wq": dense(lead, d, heads * dh),
             "wk": dense(lead, d, cfg.n_kv_heads * dh),
             "wv": dense(lead, d, cfg.n_kv_heads * dh),
             "wo": dense(lead, heads * dh, d)}
        if cfg.qk_norm:
            a.update(q_norm=gain(*lead, dh), k_norm=gain(*lead, dh))
        return a

    def block(kind, lead):
        if kind in ("attn", "moe"):
            a = attn(lead, cfg.mla)
            blk = {"ln1": gain(*lead, d), "attn": a, "ln2": gain(*lead, d)}
            if kind == "attn":
                blk["mlp"] = mlp(lead, cfg.d_ff)
                return blk
            ff, e = cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
            blk["moe"] = {"router": dense(lead, d, e, scale=0.02),
                          "experts": mlp((*lead, e), ff)}
            if cfg.n_shared_experts:
                blk["moe"]["shared"] = mlp(lead, ff * cfg.n_shared_experts)
            return blk
        if kind == "xdec":
            a, xa = attn(lead, False), attn(lead, False)
            return {"ln1": gain(*lead, d), "attn": a,
                    "lnx": gain(*lead, d), "xattn": xa,
                    "ln2": gain(*lead, d), "mlp": mlp(lead, cfg.d_ff)}
        if kind == "mamba":
            di, n = cfg.ssm_expand * d, cfg.ssm_state
            return {"w_in": dense(lead, d, 2 * di),
                    "w_bc": dense(lead, d, 2 * n),
                    "w_dt": dense(lead, d, di, scale=0.01),
                    "conv_w": normal(*lead, cfg.conv_kernel, di, scale=0.1),
                    "a_log": normal(*lead, di, scale=0.1),
                    "d_skip": gain(*lead, di), "w_out": dense(lead, di, d),
                    "norm": gain(*lead, d)}
        if kind == "mlstm":
            return {"wq": dense(lead, d, d), "wk": dense(lead, d, d),
                    "wv": dense(lead, d, d),
                    "w_if": dense(lead, d, 2 * heads, scale=0.02),
                    "wo": dense(lead, d, d), "norm": gain(*lead, d),
                    "out_norm": gain(*lead, d // heads)}
        if kind == "slstm":
            return {"w_gates": dense(lead, d, 4 * d),
                    "r_gates": dense(lead, d, 4 * d, scale=0.02),
                    "wo": dense(lead, d, d), "norm": gain(*lead, d)}
        raise ValueError(kind)

    segments = [None if kind == "sattn" else block(kind, (count,))
                for kind, count in M.segments_of(cfg)]
    tree = {}
    if cfg.shared_attn_every:
        tree["shared_attn"] = block("attn", ())
    if cfg.enc_layers:
        tree["encoder"] = block("attn", (cfg.enc_layers,))
    tree.update(emb=normal(cfg.vocab, d, scale=0.02), ln_f=gain(d),
                segments=segments)
    if not cfg.tie_embeddings:
        tree["unemb"] = normal(d, cfg.vocab, scale=d ** -0.5)
    return tree


def pinned_config():
    """Reduced tinyllama-1.1b (4 layers, d 128, 4 heads, 1 KV head,
    dh 16) in fp32."""
    return dataclasses.replace(configs.get(SERVE_ARCH).reduced(),
                               dtype="float32")


def serve_pinned(device) -> list:
    """The serving loop on the pinned config and weights: each request's
    greedy tokens, in request order."""
    cfg = pinned_config()
    params = M.params_from_numpy(cfg, jax_layout_params(cfg, seed=0),
                                 device)
    p = SERVE_PINNED
    requests = make_requests(cfg, p["n_requests"], p["prompt_len"],
                             p["max_new"], seed=0)
    done = serve_requests(cfg, params, requests, p["batch"],
                          p["prompt_len"], p["max_new"], device)
    return [r.generated for r in done]


def token_digests(tokens) -> list:
    return [output_digest([np.asarray(t, dtype=np.int32)]) for t in tokens]


@contextlib.contextmanager
def attention_through(fn):
    """Route the model's attention calls (``ops.flash_attention``, which
    ``models/layers.py`` looks up at each call) through ``fn`` for the
    duration."""
    kernel = ops.flash_attention
    ops.flash_attention = fn
    try:
        yield
    finally:
        ops.flash_attention = kernel


def serve_recorded(cfg, params, p, device):
    """The serving loop with every attention call's operands and result
    kept: (tokens per request, [(q, k, v, causal, out)])."""
    calls = []
    kernel = ops.flash_attention

    def record(q, k, v, causal=True, scale=None):
        out = kernel(q, k, v, causal=causal, scale=scale)
        calls.append((q, k, v, causal, out))
        return out

    with attention_through(record):
        done = serve_requests(cfg, params,
                              make_requests(cfg, p["n_requests"],
                                            p["prompt_len"], p["max_new"]),
                              p["batch"], p["prompt_len"], p["max_new"],
                              device)
    return [r.generated for r in done], calls


def serve_plain(cfg, params, p, device):
    """The serving loop with attention through the kernel's plain version
    (tokens per request): the yardstick of the kernel path's tokens."""
    with attention_through(ref.flash_attention_plain):
        done = serve_requests(cfg, params,
                              make_requests(cfg, p["n_requests"],
                                            p["prompt_len"], p["max_new"]),
                              p["batch"], p["prompt_len"], p["max_new"],
                              device)
    return [r.generated for r in done]


# -- phase 9: the LM training path --------------------------------------------
# On CPU tensors these also run, at the pinned size, in the CPU tests.

def pinned_batches() -> list:
    """TRAIN_PINNED's batches 0-2 of SyntheticLM(cfg.vocab, seq, batch,
    seed=0), as the JAX package draws them (TRAIN_PINNED_STREAM)."""
    p = TRAIN_PINNED
    toks = np.frombuffer(base64.b64decode("".join(TRAIN_PINNED_STREAM)),
                         dtype="<u2").astype(np.int32).reshape(
        p["steps"], p["batch"], p["seq"] + 1)
    return [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]


def train_pinned(device, microbatches: int) -> list:
    """TRAIN_PINNED's steps of build_train_step on the pinned weights
    (jax_layout_params(cfg, seed=0)) with zero AdamW state: each step's
    loss, learning rate, gradient norm and update L1 norm."""
    cfg = pinned_config()
    p = TRAIN_PINNED
    tree = jax_layout_params(cfg, seed=0)
    zeros = pytree.tree_map(np.zeros_like, tree)
    params, opt = state_from_numpy(cfg, tree, AdamWState(0, zeros, zeros),
                                   device).values()
    step_fn = build_train_step(cfg, total_steps=p["steps"],
                               base_lr=p["base_lr"],
                               microbatches=microbatches)
    rows = []
    for batch in pinned_batches():
        new, opt, metrics = step_fn(params, opt, device_batch(batch, device))
        rows.append({"loss": float(metrics["loss"]),
                     "lr": float(metrics["lr"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "step_l1": step_l1(new, params)})
        params = new
    return rows


def train_metrics_within(got: dict, want: dict) -> bool:
    tol = TRAIN_TOL
    return (abs(got["loss"] - want["loss"]) <= tol["loss"]
            and abs(got["lr"] - want["lr"]) <= tol["lr_rtol"] * want["lr"]
            and abs(got["grad_norm"] - want["grad_norm"])
            <= tol["grad_norm_rtol"] * want["grad_norm"]
            and abs(got["step_l1"] - want["step_l1"])
            <= tol["step_l1_rtol"] * want["step_l1"])


@contextlib.contextmanager
def arch_registered(name: str, cfg):
    """``configs.get(name)`` gives ``cfg`` for the duration (the train
    driver reads its config there), as the train_tinylm example routes
    its config through the driver."""
    get = configs.get
    configs.get = lambda n: cfg if n == name else get(n)
    try:
        yield
    finally:
        configs.get = get


def train_restart(device, directory: str):
    """TRAIN_RESTART through train() on the pinned config: (the straight
    run's result, the result of the run resumed under run_elastic after
    the injected failure, the number of attempts)."""
    p = TRAIN_RESTART
    kw = dict(steps=p["steps"], batch=p["batch"], seq=p["seq"],
              ckpt_every=p["ckpt_every"], reduced=False, log_every=1,
              device=device)
    attempts, results = [], []

    def once(_resume_step):
        # fail only on the first attempt, as the driver's main() does
        fail = None if attempts else p["fail_at"]
        attempts.append(fail)
        results.append(train(PINNED_ARCH,
                             ckpt_dir=os.path.join(directory, "elastic"),
                             fail_at=fail, **kw))
        return p["steps"]

    with arch_registered(PINNED_ARCH, pinned_config()):
        straight = train(PINNED_ARCH,
                         ckpt_dir=os.path.join(directory, "straight"), **kw)
        run_elastic(once, max_restarts=1, on_restart=lambda n, e: print(
            f"[elastic] restart #{n}: {e}"))
    return straight, results[-1], len(attempts)


def largest_difference(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def gradient_report(grads) -> dict:
    """Each gradient leaf by its path: (finite, L2 norm)."""
    flat, _ = pytree.tree_flatten_with_path(grads)
    finite = torch.stack([torch.isfinite(g).all() for _, g in flat]).cpu()
    norms = torch.stack([g.float().norm() for _, g in flat]).cpu()
    return {pytree.keystr(path): (bool(f), float(n))
            for (path, _), f, n in zip(flat, finite, norms)}


def profiled_step(step_fn, params, opt, batch) -> dict:
    """One train step under ``torch.profiler``: the device's busy time
    (the sum of its kernels, copies and fills) and the device time of the
    ATen ops that launched them, largest first."""
    activities = [ProfilerActivity.CPU]
    if params["emb"].is_cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        _, _, metrics = step_fn(params, opt, batch)
        float(metrics["loss"])
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type != DeviceType.CPU)
    by_op = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                    for e in events if e.device_type == DeviceType.CPU
                    and e.self_device_time_total > 0),
                   key=lambda row: -row[1])
    return {"device_busy_ms": busy / 1e3, "ops": by_op}


def train_full(cfg, device) -> dict:
    """TRAIN_FULL on ``cfg`` from make_state(cfg, seed=0): the step-0
    gradient of every parameter (loss_and_grads, outside the timed steps),
    then the steps of build_train_step, each timed to the host's copy of
    its loss (the copy waits for the whole step), then one more step under
    the profiler (:func:`profiled_step`), not timed."""
    p = TRAIN_FULL
    # unpacked so that no reference keeps the initial state alive
    params, opt = make_state(cfg, seed=0, device=device).values()
    data = SyntheticLM(cfg.vocab, p["seq"], p["batch"], seed=0)
    _, grads = loss_and_grads(cfg, params, device_batch(data.batch(0), device))
    report = gradient_report(grads)
    del grads
    step_fn = build_train_step(cfg, total_steps=p["steps"],
                               base_lr=p["base_lr"])
    losses, norms, seconds = [], [], []
    for step in range(p["steps"]):
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt,
                                       device_batch(data.batch(step), device))
        losses.append(float(metrics["loss"]))
        if params["emb"].is_cuda:
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        norms.append(float(metrics["grad_norm"]))
    prof = profiled_step(step_fn, params, opt,
                         device_batch(data.batch(p["steps"]), device))
    return {"gradients": report, "losses": losses, "grad_norms": norms,
            "step_s": seconds, "profile": prof,
            "n_params": sum(t.numel() for t in pytree.tree_leaves(params))}


def train_phase(card: str) -> None:
    """Phase 9 on the card (``card``: the nvidia-smi name and power
    limit); raises where a check fails."""
    phase("train")
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    # (a) pinned: reduced, fp32, the JAX package's metrics
    for microbatches, want in TRAIN_LM_REFERENCE.items():
        got = train_pinned("cuda", microbatches)
        for step, (g, w) in enumerate(zip(got, want)):
            print(f"pinned train (reduced {SERVE_ARCH}, fp32, microbatches "
                  f"{microbatches}) step {step}: {json.dumps(g)}; JAX "
                  f"{json.dumps(w)}")
            if not train_metrics_within(g, w):
                raise AssertionError(f"pinned train step {step} is not "
                                     f"within {TRAIN_TOL} of the JAX "
                                     f"package's")
    # (b) restart: straight against resumed after an injected failure
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        straight, resumed, attempts = train_restart("cuda", directory)
    diff = largest_difference(straight["state"], resumed["state"])
    print(f"restart: {attempts} attempts; final loss straight "
          f"{straight['final_loss']!r}, resumed {resumed['final_loss']!r}; "
          f"losses straight {straight['losses']}, resumed "
          f"{resumed['losses']}; largest |state difference| {diff!r} in "
          f"{time.perf_counter() - t0:.3f} s")
    if attempts != 2 or straight["final_loss"] != resumed["final_loss"] \
            or diff != 0.0:
        raise AssertionError("the resumed run differs from the straight "
                             "one")
    # (c) full width and depth, bf16, remat
    full = configs.get(SERVE_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = train_full(full, "cuda")
    peak = torch.cuda.max_memory_allocated()
    bad = {k: v for k, v in res["gradients"].items()
           if not v[0] or v[1] == 0.0}
    norms = [v[1] for v in res["gradients"].values()]
    print(f"full train step 0: {len(norms)} parameter gradients, all finite "
          f"and non-zero: {not bad}; norms {min(norms)!r} to "
          f"{max(norms)!r}")
    if bad:
        raise AssertionError(f"full train: gradients missing, zero or not "
                             f"finite: {bad}")
    if not all(math.isfinite(x) for x in res["losses"] + res["grad_norms"]):
        raise AssertionError(f"full train: {res}")
    p = TRAIN_FULL
    tokens = p["batch"] * p["seq"]
    step_s = statistics.median(res["step_s"][1:])
    mfu = 6 * res["n_params"] * tokens / step_s / BF16_TENSOR_FLOPS_PER_S
    print(f"full train ({SERVE_ARCH}, {full.n_layers} layers, d "
          f"{full.d_model}, bf16, remat {full.remat}, {p}) on [{card}]: "
          f"losses {res['losses']}, grad norms {res['grad_norms']}; step "
          f"seconds {res['step_s']}; median of steps 2-{p['steps']} "
          f"{step_s * 1e3:.3f} ms, {tokens / step_s:.1f} tokens/s; peak "
          f"memory {peak} B; {res['n_params']} parameters, mfu "
          f"{mfu:.4f} (6 N tokens / step / {BF16_TENSOR_FLOPS_PER_S:.4g}, "
          f"remat's recompute not counted)")
    prof = res["profile"]
    print(f"full train, one more step under torch.profiler: device busy "
          f"{prof['device_busy_ms']:.3f} ms, "
          f"{prof['device_busy_ms'] / 1e3 / step_s:.4f} "
          f"of the median step; device ms by ATen op (calls):")
    for name, ms, count in prof["ops"][:TRAIN_PROFILE_ROWS]:
        print(f"  {name}: {ms:.3f} ms ({count})")
    launched = ops.launch_counts()
    print(f"train phase in {time.perf_counter() - t_phase:.3f} s; launches "
          f"{launched}")
    if any(launched.values()):
        raise AssertionError(f"the train phase launched a kernel: "
                             f"{launched}")


# -- phase 10: the LM families -----------------------------------------------
# On CPU tensors ``ops`` takes the plain versions, so these also run, at the
# reduced size, in the CPU tests.

def family_config(arch: str, full: bool = False):
    """Pinned (``full`` false): ``arch`` reduced, in fp32, zamba2 with
    ZAMBA2_PERIOD as its pattern.  Full: the published config in bf16,
    its depth cut to FAMILIES_DEPTH where the card cannot hold it."""
    cfg = configs.get(arch)
    if full:
        if arch in FAMILIES_DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=FAMILIES_DEPTH[arch])
        return cfg
    cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    if arch == "zamba2-1.2b":
        cfg = dataclasses.replace(cfg, block_pattern=ZAMBA2_PERIOD,
                                  n_layers=len(ZAMBA2_PERIOD))
    return cfg


def family_prompts(cfg, batch: int, prompt_len: int, seed: int
                   ) -> np.ndarray:
    """int32 prompts [batch, prompt_len] from ``default_rng(seed)``."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(batch, prompt_len), dtype=np.int32)


def family_extras(cfg, batch: int, prompt_len: int, seed: int) -> dict:
    """The modality stubs of ``cfg``'s frontend as numpy arrays, drawn
    from ``default_rng(seed)``: N_PATCHES patch embeddings (N(0, 0.02),
    the token embeddings' scale) and their ``pos3`` for a VLM, the
    patches an 8 x 8 grid (t 0, h its row, w its column) and the text
    at the next position in all three streams, as Qwen2-VL places a
    picture before its caption; ``max(8, prompt_len // 4)`` frames
    (N(0, 1)) for an audio encoder-decoder; nothing otherwise."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vision_patches":
        side = math.isqrt(N_PATCHES)
        grid = np.arange(N_PATCHES)
        text = side + np.arange(prompt_len)
        streams = [np.concatenate([np.zeros_like(grid), text]),
                   np.concatenate([grid // side, text]),
                   np.concatenate([grid % side, text])]
        pos3 = np.broadcast_to(np.stack(streams)[:, None],
                               (3, batch, N_PATCHES + prompt_len))
        return {"extra_embeds": (rng.standard_normal(
                    (batch, N_PATCHES, cfg.d_model)) * 0.02
                    ).astype(np.float32),
                "pos3": pos3.astype(np.int32)}
    if cfg.frontend == "audio_frames":
        frames = max(8, prompt_len // 4)
        return {"enc_feats": rng.standard_normal(
            (batch, frames, cfg.d_model)).astype(np.float32)}
    return {}


def k6_calls(cfg, extras: dict, max_new: int) -> tuple:
    """Flash-attention calls of one :func:`generate` run: (prefill, the
    decode steps).  Prefill: every GQA self-attention (``attn``, ``moe``,
    ``xdec`` and ``sattn`` blocks; MLA takes its einsum product), and
    with frames the encoder's layers and each ``xdec`` block's
    cross-attention.  Decode: with frames, the encoder once more (for
    ``enc_out``) and each ``xdec`` block's cross-attention a step (a
    single query token: the self-attention of a decode step is the
    masked product over the cache)."""
    self_attn = 0 if cfg.mla else sum(
        kind in ("attn", "moe", "xdec", "sattn") for kind in cfg.pattern)
    if not (cfg.enc_layers and "enc_feats" in extras):
        return self_attn, 0
    cross = sum(kind == "xdec" for kind in cfg.pattern)
    return (self_attn + cfg.enc_layers + cross,
            cfg.enc_layers + cross * (max_new - 1))


@contextlib.contextmanager
def routing_recorded():
    """Record, for the duration, each MoE layer's routed (token, expert)
    pairs, the pairs kept by the capacity bound, and the smallest margin
    between a token's k-th and (k+1)-th gate; and for each logits of the
    model's last position, the smallest margin between the top two.
    Yields a dict of lists of tensors (``pairs`` ints)."""
    route, logits_of = layers.moe_route, M.logits_of
    rec = {"pairs": [], "kept": [], "gate_margin": [], "logit_margin": []}

    def recording_route(p, cfg, xf, capacity_factor=1.25):
        r = route(p, cfg, xf, capacity_factor)
        k = cfg.experts_per_tok
        top = torch.topk(r.gates, k + 1, dim=-1).values
        rec["pairs"].append(r.keep.numel())
        rec["kept"].append(r.keep.sum())
        rec["gate_margin"].append((top[:, k - 1] - top[:, k]).min())
        return r

    def recording_logits(cfg, params, h):
        lg = logits_of(cfg, params, h)
        top = torch.topk(lg[:, -1].float(), 2, dim=-1).values
        rec["logit_margin"].append((top[:, 0] - top[:, 1]).min())
        return lg

    layers.moe_route, M.logits_of = recording_route, recording_logits
    try:
        yield rec
    finally:
        layers.moe_route, M.logits_of = route, logits_of


def routing_summary(rec) -> dict:
    """The share of routed pairs the capacity bound dropped (None without
    MoE) and the smallest gate and logit margins of a recorded run."""
    pairs = sum(rec["pairs"])
    kept = int(sum(int(k) for k in rec["kept"]))

    def least(key):
        return (float(torch.stack(rec[key]).min()) if rec[key] else None)
    return {"dropped_share": (pairs - kept) / pairs if pairs else None,
            "pairs": pairs, "dropped": pairs - kept,
            "gate_margin": least("gate_margin"),
            "logit_margin": least("logit_margin")}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def generate(cfg, params, tokens: np.ndarray, extras: dict, max_new: int,
             device) -> dict:
    """Greedy generation through the step functions a server calls:
    ``build_prefill_step`` on the prompts and their stubs, then
    ``max_new - 1`` steps of ``build_serve_step``, cross-attending to
    ``encode(...)`` of the frames when there are any (the JAX package's
    prefill does not return the encoder's output).  Returns each row's
    tokens, the prefill's last-token logits (fp32, on the host), the wall
    seconds of prefill (to its first tokens on the host) and of the
    decode steps, and the flash-attention launches of each."""
    batch = {"tokens": torch.from_numpy(tokens).to(device, torch.int64)}
    batch.update({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in extras.items()})
    b, seq = tokens.shape
    if "extra_embeds" in extras:
        seq += extras["extra_embeds"].shape[1]
    caches = M.init_cache(cfg, b, seq + max_new, device)
    prefill_fn, serve_fn = build_prefill_step(cfg), build_serve_step(cfg)
    _sync(device)
    launches0 = ops.launch_counts()["flash_attention"]
    t0 = time.perf_counter()
    logits, caches = prefill_fn(params, caches, batch)
    nxt = torch.argmax(logits[:, -1], dim=-1)
    out = [nxt.tolist()]                          # waits for the device
    prefill_s = time.perf_counter() - t0
    launches1 = ops.launch_counts()["flash_attention"]
    enc_out = None
    if "enc_feats" in batch:
        feats = batch["enc_feats"]
        enc_out = M.encode(cfg, params, feats.to(M.torch_dtype(cfg)),
                           torch.arange(feats.shape[1], device=device)
                           .expand(feats.shape[:2]))
    steps = []
    for step in range(max_new - 1):
        step_logits, caches = serve_fn(params, caches, nxt, seq + step,
                                       enc_out)
        nxt = torch.argmax(step_logits, dim=-1)
        steps.append(nxt)
    if steps:
        out += torch.stack(steps, dim=1).T.tolist()
    _sync(device)
    decode_s = time.perf_counter() - t0 - prefill_s
    return {"tokens": [list(row) for row in zip(*out)],
            "logits": logits[:, -1].float().cpu(), "prefill_s": prefill_s,
            "decode_s": decode_s,
            "launches": (launches1 - launches0,
                         ops.launch_counts()["flash_attention"] - launches1)}


def einsum_prefill_logits(cfg, params, tokens: np.ndarray, extras: dict,
                          device) -> torch.Tensor:
    """The prefill's last-token logits with every attention through the
    einsum path (``flash=False``), fp32 on the host."""
    kw = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
          for k, v in extras.items()}
    b, seq = tokens.shape
    if "extra_embeds" in extras:
        seq += extras["extra_embeds"].shape[1]
    logits, _ = M.prefill(cfg, params, torch.from_numpy(tokens).to(
        device, torch.int64), M.init_cache(cfg, b, seq, device), **kw,
        flash=False)
    return logits[:, -1].float().cpu()


def families_pinned(arch: str, device) -> dict:
    """Phase 10 (a) for ``arch``: the serving loop at SERVE_PINNED's sizes
    on the pinned config and weights (``jax_layout_params(cfg, seed=0)``,
    the prompts of ``serve(seed=0)``), and for FAMILIES_EXTRAS
    :func:`generate` at FAMILIES_PINNED_EXTRAS with the stubs of
    ``family_extras(seed=0)``.  Each run's tokens per request and its
    routing summary."""
    cfg = family_config(arch)
    params = M.params_from_numpy(cfg, jax_layout_params(cfg, seed=0),
                                 device)
    p = SERVE_PINNED
    with routing_recorded() as rec:
        done = serve_requests(cfg, params, make_requests(
            cfg, p["n_requests"], p["prompt_len"], p["max_new"], seed=0),
            p["batch"], p["prompt_len"], p["max_new"], device)
    runs = {"serve": ([r.generated for r in done], routing_summary(rec))}
    if arch in FAMILIES_EXTRAS:
        e = FAMILIES_PINNED_EXTRAS
        with routing_recorded() as rec:
            res = generate(cfg, params, family_prompts(
                cfg, e["batch"], e["prompt_len"], seed=0), family_extras(
                cfg, e["batch"], e["prompt_len"], seed=0), e["max_new"],
                device)
        runs["extras"] = (res["tokens"], routing_summary(rec))
    return runs


def families_full(arch: str, device, sizes: dict, model=None) -> dict:
    """Phase 10 (b) for ``arch`` at ``sizes`` (FAMILIES_FULL on the card)
    on ``family_config(arch, full=True)`` with random weights from seed 0
    (or on ``model``, a (cfg, params) pair the caller made): a timed
    :func:`generate` run under :func:`routing_recorded`, a second run
    with every flash-attention
    call's operands and result kept, and the einsum path's prefill
    logits.  The model is freed before it returns."""
    if model is None:
        cfg = family_config(arch, full=True)
        params = M.init_params(cfg, torch.Generator(device).manual_seed(0))
    else:
        cfg, params = model
    tokens = family_prompts(cfg, sizes["batch"], sizes["prompt_len"], 0)
    extras = family_extras(cfg, sizes["batch"], sizes["prompt_len"], 0)
    with routing_recorded() as rec:
        res = generate(cfg, params, tokens, extras, sizes["max_new"],
                       device)
    res["routing"] = routing_summary(rec)
    res["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if torch.device(device).type == "cuda" else None)
    calls = []
    kernel = ops.flash_attention

    def record(q, k, v, causal=True, scale=None):
        out = kernel(q, k, v, causal=causal, scale=scale)
        calls.append((q, k, v, causal, out))
        return out

    with attention_through(record):
        again = generate(cfg, params, tokens, extras, sizes["max_new"],
                         device)
    res["calls"] = calls
    res["again_tokens"] = again["tokens"]
    res["einsum_logits"] = einsum_prefill_logits(cfg, params, tokens,
                                                 extras, device)
    res["k6_calls"] = k6_calls(cfg, extras, sizes["max_new"])
    res["stubs"] = sorted(extras)
    res["n_params"] = sum(t.numel() for t in pytree.tree_leaves(params))
    res["cfg"] = cfg
    del params
    return res


def families_phase(card: str, records: dict) -> None:
    """Phase 10 on the card (``card``: the nvidia-smi name and power
    limit); adds the full-width runs' flash-attention launches to
    ``records``; raises where a check fails."""
    phase("families")
    t_phase = time.perf_counter()
    # (a) pinned: reduced, fp32, the JAX package's token digests
    for arch in FAMILY_ARCHS:
        ops.reset_launch_counts()
        for run, (tokens, routing) in families_pinned(arch, "cuda").items():
            digests = token_digests(tokens)
            print(f"pinned {run} (reduced {arch}, fp32): tokens {tokens}; "
                  f"flash_attention launches so far "
                  f"{ops.launch_counts()['flash_attention']}")
            if digests != FAMILIES_REFERENCE[arch][run]:
                raise AssertionError(
                    f"pinned {run} of {arch}: tokens differ from the JAX "
                    f"package's ({digests}); smallest top-k gate margin "
                    f"{routing['gate_margin']!r}, smallest logit margin "
                    f"{routing['logit_margin']!r}")
    # (b) published widths, bf16, random weights from seed 0
    sizes = FAMILIES_FULL
    for arch in FAMILY_ARCHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = families_full(arch, "cuda", sizes)
        cfg = res["cfg"]
        want = FAMILIES_K6[arch]
        if res["launches"] != want or res["k6_calls"] != want:
            raise AssertionError(f"{arch}: flash_attention launches "
                                 f"{res['launches']} (prefill, decode), "
                                 f"by the config {res['k6_calls']}; want "
                                 f"{want}")
        if len(res["calls"]) != sum(want):
            raise AssertionError(f"{arch}: the recorded run made "
                                 f"{len(res['calls'])} calls")
        worst, shapes = 0.0, {}
        for q, k, v, causal, out in res["calls"]:
            plain = ref.flash_attention_plain(q, k, v, causal=causal)
            err = float((out.float() - plain.float()).abs().max())
            tol = ATTN_TOL[q.dtype]
            if not torch.allclose(out.float(), plain.float(), atol=tol,
                                  rtol=tol):
                raise AssertionError(f"{arch}: a flash_attention call "
                                     f"{tuple(q.shape)} x {tuple(k.shape)} "
                                     f"is off by {err!r}")
            worst = max(worst, err)
            key = (tuple(q.shape), k.shape[1], causal)
            shapes[key] = shapes.get(key, 0) + 1
        del res["calls"]
        logits, einsum = res["logits"], res["einsum_logits"]
        if not (torch.isfinite(logits).all() and
                torch.isfinite(einsum).all()):
            raise AssertionError(f"{arch}: logits not finite")
        diff = float((logits - einsum).abs().max())
        scale = float(einsum.abs().max())
        if diff > FAMILIES_LOGIT_RTOL * scale:
            raise AssertionError(f"{arch}: last-token logits through the "
                                 f"kernel are {diff!r} from the einsum "
                                 f"path's (largest |logit| {scale!r})")
        b, s, new = sizes["batch"], sizes["prompt_len"], sizes["max_new"]
        decode_ms = res["decode_s"] / (new - 1) * 1e3
        wall = res["prefill_s"] + res["decode_s"]
        cut = (f"depth cut {configs.get(arch).n_layers} -> {cfg.n_layers}"
               if arch in FAMILIES_DEPTH else "whole depth")
        routing = res["routing"]
        print(f"full {arch} ({cut}, {len(cfg.pattern)} blocks, d "
              f"{cfg.d_model}, {res['n_params']} parameters, bf16, batch "
              f"{b} x {s} tokens + stubs {res['stubs']}, {new} new) on "
              f"[{card}]: prefill "
              f"{res['prefill_s'] * 1e3:.3f} ms, decode {decode_ms:.3f} ms "
              f"a step ({new - 1} steps), {b * new / wall:.2f} tokens/s; "
              f"peak memory {res['peak_bytes']} B; flash_attention "
              f"launches {res['launches']} (prefill, decode), calls by "
              f"(q shape, Sk, causal) {shapes}, max |kernel - plain| "
              f"{worst!r}; last-token logits max |kernel path - einsum "
              f"path| {diff!r} (largest |logit| {scale!r}); MoE pairs "
              f"dropped by capacity {routing['dropped']} of "
              f"{routing['pairs']} (share {routing['dropped_share']!r}); "
              f"tokens {res['tokens']} (the recorded run's equal: "
              f"{res['again_tokens'] == res['tokens']}); in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        records["flash_attention"]["launches"] += sum(res["launches"])
        del res
    print(f"families phase in {time.perf_counter() - t_phase:.3f} s")


def moe_layer(cfg, device, dtype, seed: int = 0):
    """One MoE layer's parameters (router, routed and shared experts) from
    a seed, as ``layers.moe_init`` makes them, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return layers.moe_init(gen, cfg, dtype)


def moe_two_paths(cfg, p, x, backend: str, device_type: str):
    """``layers.moe_apply`` of ``x`` through the single-device path, and
    through the expert-parallel path on a 1 x 1 (data, model)
    ``DeviceMesh`` over a one-rank ``backend`` process group, with the
    inputs as DTensors laid out by the sharding plan.  Returns (the
    single-device output, a function that runs the expert-parallel path
    and returns its local output); the caller destroys the group
    (``dist.destroy_process_group``) when done."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import mesh as MS, sharding as SH

    layers.set_mesh_axes((), None)
    single = layers.moe_apply(p, cfg, x)
    with socket.socket() as sock:            # a free port on this host
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    dmesh = MS.make_mesh((1, 1), ("data", "model"), device_type)
    specs = SH.param_specs(p, dmesh)

    def place(t, spec):
        return DTensor.from_local(t, dmesh, SH.placements(spec, dmesh),
                                  run_check=False)

    p_d = SH.map_with_path(lambda path, t: place(t, SH.at_path(specs, path)),
                           p)
    x_d = place(x, SH.embeds_spec(x.shape, dmesh))

    def expert_parallel():
        layers.set_mesh_axes(*MS.mesh_axes(dmesh))
        try:
            with implicit_replication():
                return layers.moe_apply(p_d, cfg, x_d).full_tensor()
        finally:
            layers.set_mesh_axes((), None)

    return single, expert_parallel


def planning_phase(card: str) -> None:
    """Phase 11 on the card's host and the card (``card``: the nvidia-smi
    name and power limit); raises where a check fails."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    phase("planning")
    t_phase = time.perf_counter()
    # (a) the dry-run cells on the fake process group
    for arch, shape, multi in PLANNING_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod=multi,
                              device=PLANNING_MESH_DEVICE)
        print(f"dry-run {arch} {shape} {rec['mesh']} in "
              f"{time.perf_counter() - t0:.3f} s: {json.dumps(rec)}",
              flush=True)
        want = PLANNING_REFERENCE[(arch, shape, rec["mesh"])]
        if rec["argument_size_in_bytes"] != want:
            raise AssertionError(f"{arch} {shape} {rec['mesh']}: "
                                 f"{rec['argument_size_in_bytes']} argument "
                                 f"bytes a device, the JAX package's {want}")
        if rec["flops"] <= 0 or rec["collectives"]["total"] <= 0:
            raise AssertionError(f"{arch} {shape}: nothing counted")
    if dist.is_initialized():
        raise AssertionError("the fake process group outlived its cells")
    # (b) the MoE layer at deepseek-v2-236b's width, both paths
    cfg = configs.get(PLANNING_MOE["arch"])
    b, s = PLANNING_MOE["batch"], PLANNING_MOE["seq"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p = moe_layer(cfg, "cuda", torch.bfloat16)
    x = torch.randn((b, s, cfg.d_model), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(1)
                    ).to(torch.bfloat16)
    single, expert_parallel = moe_two_paths(cfg, p, x, "nccl", "cuda")
    try:
        ep = expert_parallel()
        equal = torch.equal(single, ep)
        diff = float((single.float() - ep.float()).abs().max())
        if not (torch.isfinite(single).all() and equal):
            raise AssertionError(f"the expert-parallel MoE differs from the "
                                 f"single-device path by {diff!r}")
        times = {}
        for label, fn in (("single-device",
                           lambda: layers.moe_apply(p, cfg, x)),
                          ("expert-parallel", expert_parallel)):
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            runs = []
            for _ in range(5):
                start.record()
                fn()
                end.record()
                end.synchronize()
                runs.append(start.elapsed_time(end))
            times[label] = statistics.median(runs)
    finally:
        dist.destroy_process_group()
    n_exp = sum(t.numel() * t.element_size()
                for t in pytree.tree_leaves(p["experts"]))
    print(f"MoE {cfg.name} (d {cfg.d_model}, {cfg.n_experts} routed + "
          f"{cfg.n_shared_experts} shared experts, top-"
          f"{cfg.experts_per_tok}, expert d_ff {cfg.moe_d_ff}, "
          f"{n_exp} B of bf16 routed experts) on {b} x {s} tokens on "
          f"[{card}]: single-device {times['single-device']:.3f} ms, "
          f"expert-parallel (1 x 1 mesh, NCCL) "
          f"{times['expert-parallel']:.3f} ms (CUDA events, median of 5); "
          f"bit-equal {equal} (max |diff| {diff!r}); peak memory "
          f"{torch.cuda.max_memory_allocated()} B", flush=True)
    del p, x, single, ep
    print(f"planning phase in {time.perf_counter() - t_phase:.3f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # fp32 matrix products in full fp32: the token digest is held against
    # the JAX package's CPU run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
          f"HBM {HBM_BYTES_PER_S:.4g} B/s; INT8 tensor peak "
          f"{INT8_TENSOR_OPS_PER_S:.4g} op/s; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}; numpy {np.__version__}; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}")

    # -- 2. build ---------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    infos = _build.build()
    print(f"built {len(infos)} libraries in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for stem, info in infos.items():
        print(f"built {info['path']} in {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or \
                    "entry function" in line:
                print("  ptxas:", line.strip())
        _build.library(stem)
        usage = ptxas_usage(info["log"])
        counts = sass_report(info["path"], _build.find_nvcc(), usage)
        # the INT8 GEMM: tensor cores only, and no spills
        for name, use in usage.items():
            label = kernel_label(name)
            if not label.startswith("int8_matmul"):
                continue
            got = counts.get(label, {})
            print(f"  K5 {label}: {use.get('registers')} registers, "
                  f"{use.get('spill_stores')} B spill stores, "
                  f"{use.get('spill_loads')} B spill loads, stack "
                  f"{use.get('stack')} B; IMMA {got.get('IMMA')}, IDP "
                  f"{got.get('IDP')}")
            if use.get("spill_stores") or use.get("spill_loads"):
                raise AssertionError(f"{label} spills: {use}")
            if counts and (not got.get("IMMA") or got.get("IDP")):
                raise AssertionError(f"{label} is not on the tensor cores: "
                                     f"{got}")
    print("  flash_attn_mma_kernel dynamic shared memory a block: "
          + ", ".join(f"dh {dh} {attention.mma_smem_bytes(dh)} B"
                      for dh in attention.HEAD_DIMS))

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
    cases += [("bitserial_mul", dt, shape, None)
              for dt in (np.int32, np.int8) for shape in RAGGED]
    cases += [("bitserial_mul", dt, None, "extremes") for dt in EXTREMES]
    cases += [("int8_matmul", np.int8, shape, None)
              for shape in MATMUL_SHAPES]
    cases += [("int8_matmul", np.int8, shape, "min")
              for shape in MATMUL_EXTREMES]
    cases += [("int8_matmul", np.int8, (m, k, n), arg)
              for m, k, n, arg in MATMUL_MMA]

    def unaligned(t):
        """``t``'s values in a contiguous view one element past an
        allocation's start."""
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:]
        flat.copy_(t.reshape(-1))
        return flat.reshape(t.shape)

    def operands(name, dt, shape, arg):
        """The operands of one call: (a, b) for the elementwise kernels
        (every ordered pair of the dtype's extremes as [1, n] for ``arg ==
        "extremes"``; for ``arg == "+k"``, a[:, :n] and a[:, k:k + n] of one
        buffer, as the jacobi1d sweep slices it, b not 16-byte aligned for k
        = 1, 2), the stack for MWS, (stack, query) with the query
        planted as record 0 of row 3 for search, int8 (a[M, K], b[K, N])
        for the GEMM (all -128 for ``arg == "min"``; for ``"probe"``
        A[i, k] = i + 16 (k % 4) and B[k, j] = k // 4 - j, which tell every
        fragment index apart; for ``"view_a"`` / ``"view_b"`` that operand
        a contiguous view one byte past an allocation's start)."""
        if name == "int8_matmul":
            m, k, n = shape
            if arg == "min":
                return (torch.full((m, k), -128, dtype=torch.int8,
                                   device="cuda"),
                        torch.full((k, n), -128, dtype=torch.int8,
                                   device="cuda"))
            if arg == "probe":
                i, kk = torch.arange(m)[:, None], torch.arange(k)[None, :]
                kr, j = torch.arange(k)[:, None], torch.arange(n)[None, :]
                return ((i + 16 * (kk % 4)).to(torch.int8).cuda(),
                        (kr // 4 - j).to(torch.int8).cuda())
            a, b = rand(rng, (m, k), np.int8), rand(rng, (k, n), np.int8)
            if arg == "view_a":
                a = unaligned(a)
            elif arg == "view_b":
                b = unaligned(b)
            return a, b
        if name == "mws_bitwise":
            return (rand(rng, shape, dt),)
        if name == "search_pages":
            stack = rand(rng, shape, dt)
            query = torch.arange(arg, dtype=torch.int32, device="cuda")
            stack[3, :arg] = query
            return stack, query
        if arg == "extremes":
            a, b = np.meshgrid(np.array(EXTREMES[dt], dt),
                               np.array(EXTREMES[dt], dt))
            return (torch.from_numpy(a.reshape(1, -1)).cuda(),
                    torch.from_numpy(b.reshape(1, -1)).cuda())
        if isinstance(arg, str) and arg.startswith("+"):
            n, k = shape[1], int(arg[1:])
            base = rand(rng, (1, n + 2), dt)
            return base[:, :n], base[:, k:k + n]
        return rand(rng, shape, dt), rand(rng, shape, dt)

    kernel_fn = {"bitserial_add": lambda a, b, arg: ops.bitserial_add(a, b),
                 "bitserial_mul": lambda a, b, arg: ops.bitserial_mul(a, b),
                 "shift_add_mul": lambda a, b, arg:
                     ops.shift_add_mul(a, b, bits=arg),
                 "mws_bitwise": lambda s, arg: ops.mws_bitwise(s, arg),
                 "search_pages": lambda s, q, arg: ops.search_pages(s, q),
                 "int8_matmul": lambda a, b, arg: ops.int8_matmul(a, b)}
    plain_fn = {"bitserial_add": lambda a, b, arg:
                    ref.bitserial_add_plain(a, b),
                "bitserial_mul": lambda a, b, arg:
                    ref.bitserial_mul_plain(a, b),
                "shift_add_mul": lambda a, b, arg:
                    ref.shift_add_mul_plain(a, b, arg),
                "mws_bitwise": lambda s, arg: ref.mws_plain(s, arg),
                "search_pages": lambda s, q, arg: ref.search_plain(s, q),
                "int8_matmul": lambda a, b, arg:
                    ref.int8_matmul_plain(a, b)}
    for name, dt, shape, arg in cases:
        xs = operands(name, dt, shape, arg)
        got = kernel_fn[name](*xs, arg)
        want = plain_fn[name](*xs, arg)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            where = ""
            if name == "int8_matmul":
                r, c = (got != want).nonzero()[0].tolist()
                where = (f"; first wrong ({r}, {c}): got {int(got[r, c])}, "
                         f"want {int(want[r, c])}; plan "
                         f"{int8_matmul.plan(shape[0], shape[2], shape[1])}")
            raise AssertionError(f"{name} {np.dtype(dt).name} {shape} "
                                 f"arg={arg}: kernel != plain version{where}")
        if name == "search_pages" and not bool(got[3, 0]):
            raise AssertionError(f"search_pages {shape} wpr={arg}: the "
                                 f"planted record was not found")
        if name == "int8_matmul" and arg in ("view_a", "view_b"):
            if not any(x.data_ptr() % 16 for x in xs):
                raise AssertionError(f"int8_matmul {arg}: the view is "
                                     f"16-byte aligned")
        if name == "int8_matmul" and arg == "min":
            k = shape[1]
            wrapped = (k * 2 ** 14 + 2 ** 31) % 2 ** 32 - 2 ** 31
            if not bool((got == wrapped).all()):
                raise AssertionError(f"int8_matmul {shape} all -128: not "
                                     f"the int32-wrapped {wrapped}")
    print(f"{len(cases)} cases: every kernel equal to its plain version")

    # the prefix adder and the MWS sense off their 16-byte paths: ragged n,
    # extremes, the jacobi1d slices (+1 and +2 elements), int8; 1-6 pages
    # of every op on whole and ragged pages, on a stack one element past an
    # allocation's start, and on one page whose n leaves a tail.  The IFP
    # multiplier on n % 4 = 1, 2, 3, the jacobi1d slices (either operand
    # off by 4 or 8 bytes), bits 0, 1, 7, 31 and 32 on its 16-byte and
    # element paths, and the extremes; the match line at wpr 4 (its 16-byte
    # path) and six other widths on 1 and 48 rows, whole and on a stack 4 bytes past an
    # allocation's start, with the query planted in the first and the last
    # record and a near miss (one bit off) in the second.
    n = jacobi1d.SCALES["paper"]["n"] - 2
    edges = []                                  # (kernel, operands, arg)
    for dt in (np.int32, np.int8):
        edges += [("bitserial_add", operands("bitserial_add", dt, shape,
                                             arg), None)
                  for shape, arg in [(sh, None) for sh in RAGGED]
                  + [(None, "extremes"), ((1, n), "+1"), ((1, n), "+2")]]
        stacks = [rand(rng, (1, 1, 4099), dt)]
        for pages in MWS_PAGES:
            stacks += [rand(rng, (pages, 16, 256), dt),
                       rand(rng, (pages, 3, 37), dt),
                       unaligned(rand(rng, (pages, 16, 256), dt))]
        edges += [("mws_bitwise", (st,), op) for st in stacks
                  for op in MWS_OPS]
    for shape in SHIFT_RAGGED:
        edges.append(("shift_add_mul",
                      operands("shift_add_mul", np.int32, shape, None), 8))
    for k in ("+1", "+2"):
        a, b = operands("shift_add_mul", np.int32, (1, n), k)
        edges += [("shift_add_mul", (a, b), 8), ("shift_add_mul", (b, a), 8)]
    for bits in SHIFT_BITS:
        a, b = operands("shift_add_mul", np.int32, (8, 512), None)
        edges += [("shift_add_mul", (a, b), bits),
                  ("shift_add_mul", (unaligned(a), b), bits)]
    edges += [("shift_add_mul", operands("shift_add_mul", np.int32, None,
                                         "extremes"), bits)
              for bits in (8, 32)]
    searches = []
    for wpr in SEARCH_EDGE_WPR:
        for rows, recs in ((1, 13), (48, 96)):
            stack = rand(rng, (rows, recs * wpr), np.int32)
            query = rand(rng, (wpr,), np.int32)
            stack[0, :wpr] = query
            stack[0, wpr:2 * wpr] = query
            stack[0, 2 * wpr - 1] ^= 1 << 30           # the near miss
            stack[-1, -wpr:] = query
            searches += [(stack, query), (unaligned(stack), query)]
    edges += [("search_pages", xs, None) for xs in searches]
    for name, xs, arg in edges:
        got = kernel_fn[name](*xs, arg)
        want = plain_fn[name](*xs, arg)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"{name} {xs[0].dtype} {tuple(xs[0].shape)} arg={arg} at "
                f"{[x.data_ptr() % 16 for x in xs]} bytes past 16: kernel "
                f"!= plain version")
        if name == "search_pages" and not (bool(got[0, 0]) and
                                           bool(got[-1, -1]) and
                                           not bool(got[0, 1])):
            raise AssertionError(f"search_pages {tuple(xs[0].shape)} wpr="
                                 f"{xs[1].numel()}: a planted record missed "
                                 f"or the near miss matched")
    print(f"{len(edges)} prefix-adder, MWS, IFP-multiplier and match-line "
          f"cases on ragged, unaligned, extreme and tail paths: equal to the "
          f"plain versions")
    # out of the serve's peak memory
    del edges, stacks, searches, stack, query, a, b, xs, got, want

    # flash attention: fp32 and bf16, causal or not, against the plain
    # version at ATTN_TOL
    n_attn, worst = 0, {dtype: 0.0 for dtype in ATTN_TOL}
    for (h, sq, sk, dh), causal, dtype in itertools.product(
            ATTN_CASES + [ATTN_LARGE], (True, False), ATTN_TOL):
        big = LARGE_LOGITS[dtype] if (h, sq, sk, dh) == ATTN_LARGE else 1.0
        q, k, v = (torch.from_numpy(
            (rng.standard_normal((h, s_, dh)) * x).astype(np.float32)).to(
                "cuda", dtype) for s_, x in ((sq, big), (sk, big), (sk, 1.0)))
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        tol = ATTN_TOL[dtype]
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != dtype or not torch.allclose(
                got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention {(h, sq, sk, dh)} causal="
                                 f"{causal} {dtype} q, k x{big}: max |kernel "
                                 f"- plain| {err!r} over the tolerance {tol}")
        worst[dtype] = max(worst[dtype], err)
        n_attn += 1
    print(f"{n_attn} flash_attention cases within tolerance (fp32 "
          f"{ATTN_TOL[torch.float32]}, bf16 {ATTN_TOL[torch.bfloat16]}; q, "
          f"k x{LARGE_LOGITS} at {ATTN_LARGE}); largest |kernel - plain| "
          f"fp32 {worst[torch.float32]!r}, bf16 {worst[torch.bfloat16]!r}")

    # Timing at the shapes the replays give each kernel (first listed per
    # kernel is its record).  Bound: the least time for the function each
    # kernel computes: its bytes (each input read once, each output
    # written once) over HBM, or its int ops over the INT32 peak (the GEMM:
    # its 2MNK ops over the INT8 tensor-core peak), whichever is larger.
    # The GEMM's operands fit in L2 and the timing loop reuses them; its
    # time with cold operands (cycling through sets of more than twice the
    # L2) is printed beside it.  For the PuD/IFP arithmetic the gate-level
    # circuit's own op count per element (the prefix adder's, the bit-plane
    # multiplier's full adders and transposes, plane_mul_ops, the IFP
    # multiplier's 5 * bits) is printed beside it: it is the model's method,
    # not the function's least work, so it bounds nothing.
    aes_rows = WORKLOADS["aes"].SCALES["paper"]["n"] // 4096
    keys = xor_filter.SCALES["paper"]["n_keys"]
    slots = xor_filter.SCALES["paper"]["slots"]
    m = WORKLOADS["heat3d"].SCALES["paper"]["n"] - 2
    w = 32                                       # int32 lanes
    gate_ops = {"bitserial_add": prefix_add_ops(w),
                "bitserial_mul": plane_mul_ops(w),
                "shift_add_mul": 5 * 8}
    # torch._int_mm: cuBLASLt's INT8 GEMM, K5's yardstick only (the port
    # never calls it)
    library = {"bitserial_add": lambda a, b, arg: torch.add(a, b),
               "bitserial_mul": lambda a, b, arg: torch.mul(a, b),
               "shift_add_mul": None,
               "int8_matmul": lambda a, b, arg: torch._int_mm(a, b)}
    mws_library = {"and": torch.bitwise_and, "or": torch.bitwise_or,
                   "xor": torch.bitwise_xor}
    # K3 and K4 have no one-call equivalent; as a floor only: torch.mul
    # (not the same function: b is not masked to its low bits) and the
    # record compare as two calls (eq, then all)
    floor = {"shift_add_mul": ("torch.mul, not the same function",
                               lambda a, b, arg: torch.mul(a, b)),
             "search_pages": ("eq + all, two calls",
                              lambda s, q, arg: (s.view(s.shape[0], -1,
                                                        arg) == q).all(-1))}
    timed = [  # (label, kernel, shape, arg)
        ("jacobi1d", "bitserial_add", (1, n), None),
        ("jacobi1d", "bitserial_add", (1, n), "+1"),   # unaligned slices
        ("jacobi1d", "bitserial_add", (1, n), "+2"),
        ("jacobi1d", "bitserial_mul", (1, n), None),
        ("jacobi1d", "shift_add_mul", (1, n), 8),
        ("page", "bitserial_add", PAGE_SHAPE, None),
        ("page", "bitserial_mul", PAGE_SHAPE, None),
        ("page", "shift_add_mul", PAGE_SHAPE, 8),
        ("heat3d", "bitserial_add", (m, m * m), None),
        ("heat3d", "shift_add_mul", (m, m * m), 8),    # 60 of K3's 63
        ("aes", "mws_bitwise", (2, aes_rows, 4096), "xor"),
        ("aes", "mws_bitwise", (3, aes_rows, 4096), "xor"),
        ("aes", "mws_bitwise", (1, aes_rows, 4096), "nand"),
        ("xor_filter", "mws_bitwise", (3, 1, keys), "xor"),
        ("xor_filter", "search_pages", (slots // 4096, 4096), SEARCH_WPR),
        # operands beyond L2, for information: does the pass stream at the
        # HBM rate?
        ("large", "shift_add_mul", (1, 1 << 24), 8),
        ("large", "search_pages", (8192, 4096), SEARCH_WPR),
    ]
    llama = llama2_infer.SCALES["paper"]
    seq, d, d_ff = llama["seq"], llama["d"], llama["d_ff"]
    timed += [("llama2_infer", "int8_matmul", shape, None)
              for shape in ((seq, d, llama["vocab"]),      # logits, record
                            (seq, d, d), (seq, d, d_ff), (seq, d_ff, d))]
    # llm_train's step, every shape its replay launches (M, K, N): the
    # forward x @ W (and the backward dY W^T at the same shapes but the
    # logits'), dY emb, and the X^T dY of each weight (K = seq), the
    # logits' as emb^T's gradient; then dY^T x, emb's gradient made
    # directly (for comparison: the replay does not launch it)
    train = llm_train.SCALES["paper"]
    seq, d, d_ff, vocab = train["seq"], train["d"], train["d_ff"], \
        train["vocab"]
    timed += [("llm_train", "int8_matmul", shape, None)
              for shape in ((seq, d, d), (seq, d, d_ff), (seq, d_ff, d),
                            (seq, d, vocab), (seq, vocab, d),
                            (d, seq, d), (d, seq, d_ff), (d_ff, seq, d),
                            (d, seq, vocab), (vocab, seq, d))]
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
            words = xs[0].numel()
            nbytes = words * 4 + words // arg
            nops = 2 * words                     # XNOR and AND per word
        elif name == "int8_matmul":
            lib = library[name]
            m_, k_, n_ = shape
            nbytes = m_ * k_ + k_ * n_ + 4 * m_ * n_
            nops = 2 * m_ * n_ * k_
            sets = itertools.cycle([
                operands(name, None, shape, arg)
                for _ in range(-(-2 * L2_BYTES // nbytes) + 1)])
            cold_ms = time_ms(lambda: kernel_fn[name](*next(sets), arg), 50,
                              clock_hz)
        else:
            lib = library[name]
            elems = xs[0].numel()
            nbytes = 3 * elems * 4
            nops = (2 if name == "shift_add_mul" else 1) * elems
        lib_ms = (time_ms(lambda: lib(*xs, arg), 50, clock_hz)
                  if lib is not None else None)
        floor_txt = ""
        if name in floor:
            what, fn = floor[name]
            floor_txt = (f"  floor ({what}) "
                         f"{time_ms(lambda: fn(*xs, arg), 50, clock_hz):.6f}"
                         f" ms")
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / (INT8_TENSOR_OPS_PER_S if name == "int8_matmul"
                         else int32_ops_per_s) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        gate = (f"; gate-level ops {gate_ops[name]:g} an element, at INT32 "
                f"peak "
                f"{gate_ops[name] * xs[0].numel() / int32_ops_per_s * 1e3:.6f}"
                if name in gate_ops else "")
        if name == "int8_matmul":
            # the launcher's cut of K (S ranges) and its tile; the same
            # call unsplit beside it
            cut = int8_matmul.plan(m_, n_, k_)
            unsplit_ms = (time_ms(lambda: int8_matmul.int8_matmul(
                *xs, splits=1), 50, clock_hz) if cut["splits"] > 1 else ms)
            zeroed = torch.empty((m_, n_), dtype=torch.int32, device="cuda")
            zero_ms = time_ms(zeroed.zero_, 50, clock_hz)
            gate = (f"; cold operands {cold_ms:.6f}; S {cut['splits']}, "
                    f"tile {cut['tile_m']}x{cut['tile_n']}, "
                    f"{cut['stage_k']} B of K a stage; at S 1 "
                    f"{unsplit_ms:.6f}; zeroing the output alone "
                    f"{zero_ms:.6f}")
        print(f"{name:14s} {label:10s} {str(shape):18s} arg={arg} "
              f"kernel {ms:.6f} ms  plain {plain_ms:.6f} ms  library "
              f"{lib_ms if lib_ms is None else f'{lib_ms:.6f}'} ms  "
              f"bound {bound_ms:.6f} ms ({bound_by}; bytes {bytes_ms:.6f}, "
              f"ops {ops_ms:.6f}{gate}){floor_txt}  max_abs_err {err}  "
              f"[{card}]", flush=True)
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

    # flash attention at the serving shape: the prefill of one batch of the
    # full-width run (B 4 x H 32 heads, prompt 1024, dh 64, causal), bf16,
    # then fp32 for information.  Bound: q, k, v and out once over HBM, or
    # the causal pairs' 4 dh flops (two products) over the bf16
    # tensor-core peak.  Library: PyTorch's fused attention
    # (scaled_dot_product_attention, is_causal=True: top-left), which the
    # port never calls.
    full = configs.get(SERVE_ARCH)
    heads = SERVE_FULL["batch"] * full.n_heads
    sq, dh = SERVE_FULL["prompt_len"], full.head_dim
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.from_numpy(rng.standard_normal((heads, sq, dh))
                                    .astype(np.float32)).to("cuda", dtype)
                   for _ in range(3))
        got = ops.flash_attention(q, k, v, causal=True)
        want = ref.flash_attention_plain(q, k, v, causal=True)
        err = float((got.float() - want.float()).abs().max())
        tol = ATTN_TOL[dtype]
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention serving shape {dtype}: "
                                 f"max |kernel - plain| {err!r}")
        ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True), 20,
                     clock_hz)
        plain_ms = time_ms(lambda: ref.flash_attention_plain(
            q, k, v, causal=True), 2, clock_hz, rounds=3)
        # [1, heads, S, dh] views: the fused backends take 4-D inputs
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_ms(lambda: sdpa(q[None], k[None], v[None],
                                      is_causal=True), 20, clock_hz)
        nbytes = 4 * q.numel() * q.element_size()
        flops = 4 * dh * heads * sq * (sq + 1) // 2
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / (BF16_TENSOR_FLOPS_PER_S if dtype == torch.bfloat16
                          else FP32_FLOPS_PER_S) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"flash_attention serving {[heads, sq, dh]} {dtype} causal "
              f"kernel {ms:.6f} ms  plain {plain_ms:.6f} ms  library (sdpa) "
              f"{lib_ms:.6f} ms  bound {bound_ms:.6f} ms ({bound_by}; bytes "
              f"{bytes_ms:.6f}, ops {ops_ms:.6f}: {flops} flops)  "
              f"max_abs_err {err!r}  [{card}]", flush=True)
        if dtype == torch.bfloat16:
            records["flash_attention"] = {
                "name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/attention.cu",
                "replaces": REPLACES["flash_attention"], "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}
            attn_ms = ms
        del q, k, v, got, want
    # the same, bf16, at each shape of phase 10 with its own mask
    for heads, sq, sk, dh, causal in FAMILY_ATTN:
        q, k, v = (torch.from_numpy(rng.standard_normal((heads, s_, dh))
                                    .astype(np.float32)).to(
                                        "cuda", torch.bfloat16)
                   for s_ in (sq, sk, sk))
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_plain(q, k, v, causal=causal)
        err = float((got.float() - want.float()).abs().max())
        tol = ATTN_TOL[torch.bfloat16]
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"flash_attention {[heads, sq, sk, dh]} "
                                 f"causal={causal}: max |kernel - plain| "
                                 f"{err!r}")
        ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                     20, clock_hz)
        plain_ms = time_ms(lambda: ref.flash_attention_plain(
            q, k, v, causal=causal), 2, clock_hz, rounds=3)
        lib_ms = time_ms(lambda: sdpa(q[None], k[None], v[None],
                                      is_causal=causal), 20, clock_hz)
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
        flops = 4 * dh * heads * attn_pairs(sq, sk, causal)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / BF16_TENSOR_FLOPS_PER_S * 1e3
        print(f"flash_attention family {[heads, sq, sk, dh]} bf16 causal="
              f"{causal} kernel {ms:.6f} ms  plain {plain_ms:.6f} ms  "
              f"library (sdpa) {lib_ms:.6f} ms  bound "
              f"{max(bytes_ms, ops_ms):.6f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; bytes "
              f"{bytes_ms:.6f}, ops {ops_ms:.6f}: {flops} flops)  "
              f"max_abs_err {err!r}  [{card}]", flush=True)
        del q, k, v, got, want

    # -- 4. pipeline: each workload at paper scale through the entry points
    phase("pipeline")
    ops.reset_launch_counts()
    numeric = {}
    for name, want in REFERENCE.items():
        inputs = make_inputs(name, "paper")
        if not all(x.is_cuda for x in pytree.tree_leaves(inputs)):
            raise AssertionError(f"{name}: make_inputs did not place the "
                                 f"inputs on the card")
        t0 = time.perf_counter()
        out = run_numeric(name, "paper")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        outs = pytree.tree_leaves(out)
        dtype = (torch.float32 if name == "llm_train"
                 else OUTPUT_DTYPES.get(name, torch.int32))
        if not all(o.is_cuda and o.dtype == dtype for o in outs):
            raise AssertionError(f"{name}: run_numeric gave "
                                 f"{[(str(o.device), o.dtype) for o in outs]}")
        if name == "llm_train":
            loss, new = out
            l1 = step_l1(new, inputs[0])
            print(f"{name}: run_numeric on the card in {seconds:.3f} s, loss "
                  f"{float(loss)!r} (JAX {want['loss']!r}), step L1 {l1!r} "
                  f"(JAX {want['step_l1']!r})")
            if abs(float(loss) - want["loss"]) > TRAIN_TOL["loss"] or abs(
                    l1 - want["step_l1"]) > TRAIN_TOL["step_l1_rtol"] * \
                    want["step_l1"]:
                raise AssertionError(f"{name}: the step is not within "
                                     f"{TRAIN_TOL} of the JAX package's")
        else:
            digest = output_digest([o.cpu().numpy() for o in outs])
            print(f"{name}: run_numeric on the card in {seconds:.3f} s, "
                  f"outputs {[tuple(o.shape) for o in outs]}, sha256 "
                  f"{digest}")
            if digest != want["numeric_sha256"]:
                raise AssertionError(f"{name}: numeric outputs differ from "
                                     f"the JAX package's ({digest})")
        numeric[name] = out
        t0 = time.perf_counter()
        trace = get_trace(name, "paper")
        trace_s = time.perf_counter() - t0
        row = trace.characterize().as_row()
        print(f"{name} characterize:", json.dumps(row))
        if row != want["row"]:
            raise AssertionError(f"{name}: Table 3 row {row} != "
                                 f"{want['row']}")
        t0 = time.perf_counter()
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
        print(f"{name}: trace {trace_s:.3f} s, {len(trace.instrs)} "
              f"instructions, {len(trace.pages)} pages; {len(POLICIES)} "
              f"simulations {time.perf_counter() - t0:.3f} s")
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
    # out of the serve's peak memory: llm_train's weights and step, its
    # replay's GEMM outputs
    del numeric, out, inputs, got, want

    # -- 6. the LM serving path ---------------------------------------------
    phase("serve")
    # (a) pinned: reduced, fp32, weights in the JAX layout from a seed
    ops.reset_launch_counts()
    tokens = serve_pinned("cuda")
    launched = ops.launch_counts()
    digests = token_digests(tokens)
    cfg = pinned_config()
    want_launches = cfg.n_layers * -(-SERVE_PINNED["n_requests"]
                                      // SERVE_PINNED["batch"])
    print(f"pinned serve (reduced {SERVE_ARCH}, fp32): tokens {tokens}, "
          f"flash_attention launches {launched['flash_attention']}")
    if digests != SERVE_REFERENCE["tokens_sha256"]:
        raise AssertionError(f"pinned serve tokens differ from the JAX "
                             f"package's: {digests}")
    if launched != {**{k: 0 for k in launched},
                    "flash_attention": want_launches}:
        raise AssertionError(f"pinned serve launches {launched}, want "
                             f"{want_launches} flash_attention")

    # (b) full width and depth, bf16.  First a run that records every
    # attention call and holds it against the plain version, then the same
    # with attention through the plain version (its tokens are information
    # only: bf16 rounds the two paths differently), then the timed run
    # through the serve entry point, whose launches the record reports.
    want_launches = full.n_layers * -(-SERVE_FULL["n_requests"]
                                       // SERVE_FULL["batch"])
    params = M.init_params(full, torch.Generator("cuda").manual_seed(0))
    ops.reset_launch_counts()
    tokens_k6, calls = serve_recorded(full, params, SERVE_FULL, "cuda")
    launched = ops.launch_counts()["flash_attention"]
    if launched != want_launches or len(calls) != want_launches:
        raise AssertionError(f"full serve: {launched} flash_attention "
                             f"launches, {len(calls)} calls; want "
                             f"{want_launches}")
    worst = 0.0
    for q, k, v, causal, out in calls:
        want = ref.flash_attention_plain(q, k, v, causal=causal)
        err = float((out.float() - want.float()).abs().max())
        worst = max(worst, err)
        tol = ATTN_TOL[q.dtype]
        if not torch.allclose(out.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"full serve: a flash_attention call "
                                 f"{tuple(q.shape)} is off by {err!r}")
    print(f"full serve: {len(calls)} flash_attention calls of "
          f"{tuple(calls[0][0].shape)} {calls[0][0].dtype}, each within "
          f"{ATTN_TOL[torch.bfloat16]} of the plain version (max |diff| "
          f"{worst!r})")
    del calls
    ops.reset_launch_counts()
    tokens_plain = serve_plain(full, params, SERVE_FULL, "cuda")
    if ops.launch_counts()["flash_attention"]:
        raise AssertionError("the plain-path serve launched the kernel")
    same = sum(a == b for a, b in zip(itertools.chain(*tokens_k6),
                                      itertools.chain(*tokens_plain)))
    print(f"full serve tokens, kernel path: {tokens_k6}")
    print(f"full serve tokens, plain path:  {tokens_plain}")
    print(f"  {same} of {sum(map(len, tokens_k6))} tokens equal "
          f"(information only)")
    # what the card must do at least: read every weight once a decode
    # step; the prefill's matrix products at the bf16 peak
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in pytree.tree_leaves(params))
    layer_macs = (full.d_model * (full.n_heads + 2 * full.n_kv_heads)
                  * full.head_dim + full.n_heads * full.head_dim
                  * full.d_model + 3 * full.d_model * full.d_ff)
    prefill_flops = (2 * SERVE_FULL["batch"] * SERVE_FULL["prompt_len"]
                     * full.n_layers * layer_macs)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve(SERVE_ARCH, reduced=False, seed=0, **SERVE_FULL)
    launched = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if launched != {**{k: 0 for k in launched},
                    "flash_attention": want_launches}:
        raise AssertionError(f"full serve launches {launched}, want "
                             f"{want_launches} flash_attention")
    if res["requests"] != SERVE_FULL["n_requests"] or res["tokens"] != \
            SERVE_FULL["n_requests"] * SERVE_FULL["max_new"]:
        raise AssertionError(f"full serve finished {res}")
    batches = -(-SERVE_FULL["n_requests"] // SERVE_FULL["batch"])
    steps = batches * (SERVE_FULL["max_new"] - 1)
    print(f"full serve ({SERVE_ARCH}, {full.n_layers} layers, d "
          f"{full.d_model}, bf16, {SERVE_FULL}) on [{card}]: "
          f"{json.dumps(res)}; peak memory {peak} B; flash_attention "
          f"launches {launched['flash_attention']}; the kernel's time at "
          f"this shape x {full.n_layers} layers is "
          f"{attn_ms * full.n_layers:.3f} ms of a batch's "
          f"{res['prefill_s'] / batches * 1e3:.3f} ms prefill wall time; "
          f"decode {res['decode_s'] / steps * 1e3:.3f} ms a step "
          f"({steps} steps); reading the {weight_bytes} B of weights once "
          f"takes {weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; a batch's "
          f"prefill matrix products, {prefill_flops} flops, take "
          f"{prefill_flops / BF16_TENSOR_FLOPS_PER_S * 1e3:.3f} ms at the "
          f"bf16 peak")
    records["flash_attention"]["launches"] = launched["flash_attention"]

    unused = [k for k, r in records.items() if r["launches"] == 0]
    if unused:
        raise AssertionError(f"no replay or serve launched {unused}")

    # -- 7. multi-tenancy beside host I/O and garbage collection ------------
    phase("mix")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = mix_counters(torch_sim, [get_trace(name, "paper")
                                   for name in MIX_WORKLOADS])
    print(f"simulate_mix {'+'.join(MIX_WORKLOADS)} conduit, host I/O "
          f"{MIX_IO}, FTL {MIX_FTL}: {json.dumps(got)} in "
          f"{time.perf_counter() - t0:.3f} s")
    if got != MIX_REFERENCE:
        raise AssertionError(f"simulate_mix differs from the JAX package's: "
                             f"{MIX_REFERENCE}")
    if any(ops.launch_counts().values()):
        raise AssertionError(f"the mix launched a kernel: "
                             f"{ops.launch_counts()}")

    # -- 8. open-loop serving, saturation, fleets and trace analysis --------
    phase("open-loop")
    ops.reset_launch_counts()
    traces = {name: get_trace(name, "paper") for name, _ in OPEN_LOOP_CATALOG}
    t_phase = time.perf_counter()
    for label, run in open_loop_steps(torch_sim, traces):
        t0 = time.perf_counter()
        line, digests = run()
        print(f"{label}: {line} in {time.perf_counter() - t0:.3f} s")
        for key, digest in digests.items():
            print(f"  {key} sha256 {digest}")
            if digest != OPEN_LOOP_REFERENCE[key]:
                raise AssertionError(f"{key} differs from the JAX "
                                     f"package's")
    print(f"open-loop phase in {time.perf_counter() - t_phase:.3f} s")
    if any(ops.launch_counts().values()):
        raise AssertionError(f"the open-loop phase launched a kernel: "
                             f"{ops.launch_counts()}")

    # -- 9. LM training: AdamW steps, checkpoint restart, full width ---------
    train_phase(card)

    # -- 10. the LM families: pinned digests, published widths -------------
    families_phase(card, records)

    # -- 11. distributed planning: the dry-run, the expert-parallel MoE ------
    planning_phase(card)

    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
