// Functional models of the SSD's NDP resources, written for Hopper (sm_90a).
//
//   bitserial add        — PuD (SIMDRAM/MIMDRAM) add as a log-depth
//                          prefix circuit of row operations; replaces
//                          repro/kernels/bitserial.py _add_kernel.  See
//                          its own note below.
//   bitserial mul        — PuD multiply on SIMDRAM's vertical bit-planes;
//                          replaces repro/kernels/bitserial.py _mul_kernel.
//                          See its own note below.
//   shift_add_mul        — IFP (Ares-Flash) latch shift-and-add multiply;
//                          replaces repro/kernels/shift_add.py
//                          _shift_add_kernel.  See its own note below.
//   mws                  — IFP (Flash-Cosmos) multi-wordline sensing: a
//                          bulk and/or/xor/nand/nor over n_ops stacked
//                          pages; replaces repro/kernels/mws.py
//                          _mws_kernel.  See its own note below.
//   search               — IFP match line: XNOR of every record word with
//                          the query, wired-AND over the record; replaces
//                          repro/kernels/search.py _search_kernel.  See
//                          its own note below.
//   int8_matmul          — the INT8 GEMM of the quantized LLM workloads
//                          (§5.4), int8[M,K] @ int8[K,N] -> int32[M,N];
//                          replaces repro/kernels/int8_matmul.py
//                          _matmul_kernel.  See its own note below.
//
// Each elementwise kernel (all but int8_matmul) computes with the PuD or
// IFP primitives of the TPU kernel, because the gate-level circuit *is* the
// model of the in-memory computation: the adder is built only from AND, OR,
// XOR and shift row operations, the IFP multiplier from predicated shifted
// partial products, the PuD multiplier from full adders (XOR sum, MAJ
// carry) over bit-planes.  It is not carried over block by block: no VMEM
// tiles and no (8, 128) padding, but a pass over n contiguous elements,
// neighbouring threads on neighbouring addresses (the adder, the MWS and
// the IFP multiplier 16 bytes a thread, the match line one 4-word record
// of 16 bytes a thread, the PuD multiplier 32 elements a thread; each on
// aligned operands, with an element or a record a thread for the rest),
// the ragged end masked by the index test.
//
// All arithmetic runs on unsigned views (uint8_t / uint32_t):
//   * a left shift of a negative signed value is undefined before C++20;
//   * uint8_t promotes to int, so every round is cut back to 8 bits, which
//     is the wrap-around of JAX's int8 shift;
//   * (b >> i) & 1 of the unsigned view is the bit JAX's arithmetic shift
//     gives for i < W.
//
// Plain C ABI, one function per kernel and element type, bound from Python
// with ctypes.  Each launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of its launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// 132 SMs x 16 resident blocks of 256 threads: enough blocks to fill the
// card; the grid-stride loop covers any n.
constexpr long long kMaxBlocks = 132 * 16;

template <typename U>
struct Width {
  static constexpr int value = 8 * static_cast<int>(sizeof(U));
};

// PuD add, a + b wrapped to W bits, as a log-depth (Kogge-Stone) prefix
// adder built from the PuD row operations: AND, OR, XOR and shift.  No
// hardware add touches the data.
//
// The TPU kernel ripples the carry through W rounds of s = x ^ y, c = (x &
// y) << 1: 3W + 1 operations an element (97 for int32).  On an H100 that
// is issue-bound (655358 int32 x 97 operations at the card's INT32 rate
// take ~3.8 us, over the function's 2.35 us of bytes).  The prefix adder
// computes the same sum in log2 W levels:
//   p = a ^ b, g = a & b                    (propagate, generate)
//   for d = 1, 2, ..., W/2:  g |= p & (g << d);  p &= p << d
//                            (the last level skips p)
//   sum = (a ^ b) ^ (g << 1)
// g ends as the carry out of every bit; each "g |= p & t" is one LOP3, so
// int32 takes ~22 instructions an element, ~0.9 us of issue at the
// jacobi1d shape: under the bytes bound, which is what bounds it.
//
// int8 runs SWAR: four lanes a 32-bit word, every shifted term masked with
// the bits at or above d of each byte (0xFE.., 0xFC.., 0xF0..), so no carry
// crosses a byte.
//
// Layout.  A block takes chunks of kThreads * 16 bytes.  Where a, b and out
// are 16-byte aligned, a thread reads its 16 bytes of each operand with one
// 16-byte load (4 int32 or 16 int8 elements, as 4 words) and stores 16
// bytes; the grid covers n in one pass up to kMaxBlocks.  The ragged last
// chunk, and every chunk of operands that are not 16-byte aligned (the
// jacobi1d sweep adds a[1:-1] and a[2:], at +4 and +8 bytes), go an element
// at a time: element k of a thread at chunk + k * kThreads + thread, so
// each load is still coalesced, and the same 16 bytes a thread are packed
// into 4 words (int8: 4 elements a word, in any order: lanes are
// independent) and run through the same circuit.

// What a word shifted left by d keeps so that no bit crosses into the next
// W-bit lane: all of it for W = 32 (the word is the lane), bits d..7 of
// every byte for W = 8.
template <int W>
__device__ __forceinline__ constexpr uint32_t lane_mask(int d) {
  return W == 32 ? ~0u : ((0xffu << d) & 0xffu) * 0x01010101u;
}

template <typename U>
__device__ __forceinline__ uint32_t prefix_add(uint32_t a, uint32_t b) {
  constexpr int W = Width<U>::value;
  uint32_t p = a ^ b;
  uint32_t g = a & b;
#pragma unroll
  for (int d = 1; d < W; d *= 2) {
    g |= p & ((g << d) & lane_mask<W>(d));
    if (2 * d < W) p &= (p << d) & lane_mask<W>(d);
  }
  return (a ^ b) ^ ((g << 1) & lane_mask<W>(1));
}

template <typename U, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    bitserial_add_kernel(const U* __restrict__ a, const U* __restrict__ b,
                         U* __restrict__ out, long long n) {
  constexpr int kVec = 16 / sizeof(U);           // elements a thread
  constexpr int kLanes = 4 / sizeof(U);          // elements a word
  constexpr long long kChunk = static_cast<long long>(kThreads) * kVec;
  const long long whole = kAligned ? n / kChunk : 0;
  long long c = blockIdx.x;
  for (; c < whole; c += gridDim.x) {
    const long long v = c * kThreads + threadIdx.x;
    const uint4 x = reinterpret_cast<const uint4*>(a)[v];
    const uint4 y = reinterpret_cast<const uint4*>(b)[v];
    reinterpret_cast<uint4*>(out)[v] =
        make_uint4(prefix_add<U>(x.x, y.x), prefix_add<U>(x.y, y.y),
                   prefix_add<U>(x.z, y.z), prefix_add<U>(x.w, y.w));
  }
  for (; c * kChunk < n; c += gridDim.x) {
    const long long base = c * kChunk + threadIdx.x;
    uint32_t x[4] = {0, 0, 0, 0}, y[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long i = base + static_cast<long long>(k) * kThreads;
      const int shift = Width<U>::value * (k % kLanes);
      if (i < n) {
        x[k / kLanes] |= static_cast<uint32_t>(a[i]) << shift;
        y[k / kLanes] |= static_cast<uint32_t>(b[i]) << shift;
      }
    }
    uint32_t s[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) s[w] = prefix_add<U>(x[w], y[w]);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long i = base + static_cast<long long>(k) * kThreads;
      const int shift = Width<U>::value * (k % kLanes);
      if (i < n) out[i] = static_cast<U>(s[k / kLanes] >> shift);
    }
  }
}

// PuD multiply on SIMDRAM's vertical bit-planes: a * b wrapped to W bits.
//
// SIMDRAM lays an operand out vertically: row j of a subarray holds bit j
// of every element, so one row operation (AND, OR, XOR, NOT, MAJ) acts on
// that bit of all the elements at once.  Here a 32-bit register word is
// such a row over 32 elements: a lane owns 32 elements and turns each
// operand into W plane words (word j holds bit j of its 32 elements).  The
// product is then the shift-add circuit on planes: partial product i is
// plane b_i ANDed onto the planes of a shifted up by i (a register
// renaming, so free), and it is added into the accumulator planes i..W-1
// by a ripple of full adders, sum = x ^ y ^ c (XOR) and carry =
// MAJ(x, y, c), each one LOP3.  The carry out of plane W-1 is dropped: the
// wrap of the TPU kernel's a << i and its 2W-round add.  W(W+1)/2 full
// adders serve 32 elements (528 for int32, 36 for int8), where the
// element-serial form runs W partial products of 2W ripple rounds for
// every element.
//
// Layout.  A warp owns a tile of 32 * 32 elements.  It reads the tile with
// 16-byte loads, neighbouring lanes on neighbouring chunks, into its own
// slice of shared memory; a lane then reads back its 32 contiguous
// elements as 16-byte loads.  A lane's row is 32 * sizeof(U) bytes, so
// without care the lanes of one load would all hit the same banks; the
// chunk index is XOR-swizzled with the row (PlaneTile::offset), which
// makes both the stores and the loads conflict-free.  In registers the
// words become planes by a butterfly transpose (transpose_bits: 5 stages
// of 16 word pairs for int32, 3 stages of 4 pairs for int8's 8 words of
// four elements each); the stages of 16 and 8 bits are byte permutes.  The
// accumulator goes back the same way.  A tile that runs past n, or
// operands that are not 16-byte aligned, are read and written an element at
// a time through the same swizzled slice, elements past n reading as 0
// and never stored.
//
// Bound on an H100 at the jacobi1d shape (655358 int32): the function's
// bytes, 12 per element, ~2.3 us.  The circuit and transposes issue about
// 95 integer operations an element (chip_smoke.py's gate count), ~3.7 us
// at the card's INT32 rate: this kernel is bound by integer issue, and
// with 640 warp tiles on 528 SM sub-partitions some run two tiles in turn;
// it runs at ~4x the bytes bound, where the element-serial form ran at 33x
// (PERF.md).  A cross-warp transpose with __ballot_sync was not taken: it
// spends one warp-wide ballot per (plane, 32 elements), 32 lane-operations
// an element per operand, twice the butterfly's ~15.
constexpr int kPlaneThreads = 128;
constexpr int kPlaneWarps = kPlaneThreads / 32;
constexpr int kLaneElems = 32;                 // one plane word's elements
constexpr int kTileElems = 32 * kLaneElems;    // a warp's tile

template <typename U>
struct PlaneTile {
  static constexpr int kWords = kLaneElems * sizeof(U) / 4;  // a lane's
  static constexpr int kChunks = kWords / 4;     // 16-byte chunks a lane
  static constexpr int kBytes = kTileElems * sizeof(U);
  // byte offset of chunk q of lane row r in the warp's slice: rows of
  // kChunks chunks, the chunk XOR-swizzled so that the 8 lanes of one
  // 16-byte access phase fall in 8 distinct 16-byte bank groups, both when
  // a lane reads its row and when lanes store consecutive chunks
  static __device__ __forceinline__ int offset(int r, int q) {
    constexpr int kRowsPerPattern = 8 / kChunks;   // 1 (int32), 4 (int8)
    return (r * kChunks + (q ^ ((r / kRowsPerPattern) % kChunks))) * 16;
  }
  // the same for element e of the tile (the ragged path)
  static __device__ __forceinline__ int element_offset(int e) {
    const int byte = (e % kLaneElems) * static_cast<int>(sizeof(U));
    return offset(e / kLaneElems, byte / 16) + byte % 16;
  }
};

// mask of the low s bits of every 2s-bit group
__device__ __forceinline__ constexpr uint32_t butterfly_mask(int s) {
  return s == 16 ? 0x0000ffffu : s == 8 ? 0x00ff00ffu
       : s == 4 ? 0x0f0f0f0fu : s == 2 ? 0x33333333u : 0x55555555u;
}

// Swap bit k of the word index with bit k of the bit position, for every
// k < log2 N.  For N = 32 it is the 32 x 32 bit-matrix transpose (bit e of
// word j becomes bit j of word e); for N = 8 words of four bytes it makes
// word j hold bit j of all 32 bytes, in a fixed order of the bytes that
// the same call undoes.  It is its own inverse.
template <int N>
__device__ __forceinline__ void transpose_bits(uint32_t (&x)[N]) {
#pragma unroll
  for (int s = N / 2; s >= 1; s /= 2) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k & s) continue;
      const uint32_t lo = x[k];
      const uint32_t hi = x[k + s];
      if (s == 16) {
        x[k] = __byte_perm(lo, hi, 0x5410);
        x[k + s] = __byte_perm(lo, hi, 0x7632);
      } else if (s == 8) {
        x[k] = __byte_perm(lo, hi, 0x6240);
        x[k + s] = __byte_perm(lo, hi, 0x7351);
      } else {
        const uint32_t t = ((lo >> s) ^ hi) & butterfly_mask(s);
        x[k] = lo ^ (t << s);
        x[k + s] = hi ^ t;
      }
    }
  }
}

// One LOP3: the 3-input logic function whose truth table is kLut (bit
// 4a + 2b + c of kLut is f(a, b, c) for single bits a, b, c).
template <unsigned int kLut>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b,
                                         uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;\n"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c), "n"(kLut));
  return d;
}
constexpr unsigned int kXor3 = 0x96;   // a ^ b ^ c
constexpr unsigned int kMaj = 0xe8;    // MAJ(a, b, c)

// acc = a * b on W bit-planes: partial product 0 is the first accumulator,
// each later one is added by a ripple of full adders from its own plane up
// to plane W - 1; the last carry is dropped.  The sum and the carry are one
// LOP3 each (written out: the compiler, left to itself, splits them).
template <int W>
__device__ __forceinline__ void multiply_planes(const uint32_t (&a)[W],
                                                const uint32_t (&b)[W],
                                                uint32_t (&acc)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = a[j] & b[0];
#pragma unroll
  for (int i = 1; i < W; ++i) {
    uint32_t carry = 0;
#pragma unroll
    for (int j = i; j < W; ++j) {
      const uint32_t x = acc[j];
      const uint32_t y = a[j - i] & b[i];
      acc[j] = lop3<kXor3>(x, y, carry);         // the sum
      carry = lop3<kMaj>(x, y, carry);           // the carry
    }
  }
}

// The lane's 32 elements of the warp's tile at src, as kWords words, via
// the warp's shared slice.  `whole`: all 32 * 32 elements lie before n and
// the pointer is 16-byte aligned; else only the `left` elements are read.
template <typename U>
__device__ __forceinline__ void load_lane(
    const U* __restrict__ src, long long left, bool whole,
    unsigned char* slice, int lane,
    uint32_t (&words)[PlaneTile<U>::kWords]) {
  using T = PlaneTile<U>;
  if (whole) {
#pragma unroll
    for (int r = 0; r < T::kChunks; ++r) {
      const int c = lane + 32 * r;
      *reinterpret_cast<uint4*>(slice + T::offset(c / T::kChunks,
                                                  c % T::kChunks)) =
          reinterpret_cast<const uint4*>(src)[c];
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < kLaneElems; ++k) {
      const int e = lane + 32 * k;
      *reinterpret_cast<U*>(slice + T::element_offset(e)) =
          e < left ? src[e] : U(0);
    }
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < T::kChunks; ++q) {
    const uint4 v =
        *reinterpret_cast<const uint4*>(slice + T::offset(lane, q));
    words[4 * q + 0] = v.x;
    words[4 * q + 1] = v.y;
    words[4 * q + 2] = v.z;
    words[4 * q + 3] = v.w;
  }
  __syncwarp();
}

// The inverse of load_lane: the lane's words to its 32 elements at dst.
template <typename U>
__device__ __forceinline__ void store_lane(
    U* __restrict__ dst, long long left, bool whole, unsigned char* slice,
    int lane, const uint32_t (&words)[PlaneTile<U>::kWords]) {
  using T = PlaneTile<U>;
#pragma unroll
  for (int q = 0; q < T::kChunks; ++q) {
    *reinterpret_cast<uint4*>(slice + T::offset(lane, q)) =
        make_uint4(words[4 * q + 0], words[4 * q + 1], words[4 * q + 2],
                   words[4 * q + 3]);
  }
  __syncwarp();
  if (whole) {
#pragma unroll
    for (int r = 0; r < T::kChunks; ++r) {
      const int c = lane + 32 * r;
      reinterpret_cast<uint4*>(dst)[c] = *reinterpret_cast<const uint4*>(
          slice + T::offset(c / T::kChunks, c % T::kChunks));
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < kLaneElems; ++k) {
      const int e = lane + 32 * k;
      if (e < left) {
        dst[e] = *reinterpret_cast<const U*>(slice + T::element_offset(e));
      }
    }
  }
  __syncwarp();
}

template <typename U>
__global__ void __launch_bounds__(kPlaneThreads)
    bitserial_mul_planes_kernel(const U* __restrict__ a,
                                const U* __restrict__ b,
                                U* __restrict__ out, long long n,
                                int aligned) {
  using T = PlaneTile<U>;
  constexpr int W = Width<U>::value;
  static_assert(T::kWords == W, "a lane holds one word per plane");
  __shared__ __align__(16) unsigned char stage[kPlaneWarps][T::kBytes];
  const int lane = threadIdx.x % 32;
  unsigned char* slice = stage[threadIdx.x / 32];
  const long long warps = static_cast<long long>(gridDim.x) * kPlaneWarps;
  for (long long tile = static_cast<long long>(blockIdx.x) * kPlaneWarps +
                        threadIdx.x / 32;
       tile * kTileElems < n; tile += warps) {
    const long long base = tile * kTileElems;
    const long long left = n - base;
    const bool whole = aligned && left >= kTileElems;
    uint32_t pa[W], pb[W], acc[W];
    load_lane(a + base, left, whole, slice, lane, pa);
    load_lane(b + base, left, whole, slice, lane, pb);
    transpose_bits(pa);
    transpose_bits(pb);
    multiply_planes(pa, pb, acc);
    transpose_bits(acc);
    store_lane(out + base, left, whole, slice, lane, acc);
  }
}

// Ares-Flash latch rounds (IFP multiply), int32: round k broadcasts bit k
// of the multiplier, ANDs it onto the page shifted by k, and accumulates;
// only the low `bits` bits of b take part, as in the latch datapath.  The
// source has no multiply, and no round is skipped.
//
// Bound on an H100: the bytes, 12 an element.  The 8 rounds every replay
// uses are ~40 integer operations an element as the TPU kernel counts them
// (0.57 us at heat3d's 238328 elements at the card's INT32 rate, against
// 0.85 us of bytes), so the kernel is about keeping loads in flight and
// few instructions a round.  Where a, b and out are 16-byte aligned, a
// thread reads 4 elements of each operand with one 16-byte load, runs the
// rounds on the 4 lanes and stores 16 bytes (kVec); the n % 4 elements
// after the last whole 16 bytes, and every element of unaligned operands
// (a view at +4 B), go one a thread.  kBits = 8, the width the replays
// use, unrolls the rounds; kBits = 0 takes `bits` (0..32) from the
// argument.
//
// A round is a predicated add, as the latch adds the shifted page only
// where the broadcast bit is set (the TPU kernel's where(bit, a << i, 0)).
// Written in C, as a select or an AND with the bit's mask, the compiler
// makes a mask of two shifts out of every bit: ~38 instructions an
// element.  As a predicate on the bit ANDed out of b, ptxas moves b's bits
// into predicates (R2P) and adds each shifted page under its predicate,
// the shift and the add fused into one IMAD by 2^k (the unit it also uses
// for plain shifts, IMAD.SHL): one predicated instruction a round, ~14 an
// element (PERF.md).
__device__ __forceinline__ uint32_t latch_round(uint32_t acc, uint32_t x,
                                                uint32_t y, int k) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.ne.u32 p, %2, 0;\n\t"
      "@p add.u32 %0, %0, %1;\n\t}"
      : "+r"(acc)
      : "r"(x << k), "r"(y & (1u << k)));
  return acc;
}

template <int kBits>
__device__ __forceinline__ uint32_t latch_rounds(uint32_t x, uint32_t y,
                                                 int bits) {
  uint32_t acc = 0;
  if constexpr (kBits > 0) {
#pragma unroll
    for (int k = 0; k < kBits; ++k) acc = latch_round(acc, x, y, k);
  } else {
    for (int k = 0; k < bits; ++k) acc = latch_round(acc, x, y, k);
  }
  return acc;
}

template <int kBits, bool kVec>
__global__ void __launch_bounds__(kThreads)
    shift_add_mul_kernel(const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ b,
                         uint32_t* __restrict__ out, long long n, int bits) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long nv = n / 4;
    for (long long v = i; v < nv; v += stride) {
      const uint4 x = reinterpret_cast<const uint4*>(a)[v];
      const uint4 y = reinterpret_cast<const uint4*>(b)[v];
      reinterpret_cast<uint4*>(out)[v] = make_uint4(
          latch_rounds<kBits>(x.x, y.x, bits),
          latch_rounds<kBits>(x.y, y.y, bits),
          latch_rounds<kBits>(x.z, y.z, bits),
          latch_rounds<kBits>(x.w, y.w, bits));
    }
    done = nv * 4;
  }
  for (i += done; i < n; i += stride) {
    out[i] = latch_rounds<kBits>(a[i], b[i], bits);
  }
}

// The op codes of ndp_mws_*; the order of repro_torch/kernels/mws.py OPS.
enum MwsOp : int { kAnd = 0, kOr = 1, kXor = 2, kNand = 3, kNor = 4 };

// Flash-Cosmos sense of n_ops wordlines: element i of every operand page
// (stack[k * n + i]) is read once and folded (AND for and/nand, OR for
// or/nor, XOR for xor), as the wired-AND (or the OR across blocks) folds
// the cells of a NAND string in one array sense; nand/nor invert the sensed
// value.
//
// Bound on an H100: the bytes, (n_ops + 1) * itemsize an element, against
// n_ops - 1 one-instruction folds.  So the kernel is about keeping loads in
// flight.  A thread senses 16 bytes of the output: a 16-byte load of each
// page at the same offset (the fold is bitwise, so int8 and int32 are the
// same words).  For the page counts the main path uses (kPages 1..4: aes
// senses 1, 2 or 3 pages, xor_filter 3) every page's load is issued before
// the first fold; any other count (kPages 0) goes in groups of 4 loads,
// then their folds.  Indices are 32-bit (I) where n * n_ops fits, else
// 64-bit.  16-byte loads need the stack, the output and every page (a page
// is n elements) 16-byte aligned; else, and for the ragged end, elements go
// one at a time with the same fold.
template <int kOp>
__device__ __forceinline__ uint32_t mws_fold(uint32_t acc, uint32_t x) {
  if (kOp == kAnd || kOp == kNand) return acc & x;
  if (kOp == kOr || kOp == kNor) return acc | x;
  return acc ^ x;
}

template <int kOp>
__device__ __forceinline__ uint4 mws_fold(uint4 acc, uint4 x) {
  return make_uint4(mws_fold<kOp>(acc.x, x.x), mws_fold<kOp>(acc.y, x.y),
                    mws_fold<kOp>(acc.z, x.z), mws_fold<kOp>(acc.w, x.w));
}

template <int kOp>
__device__ __forceinline__ uint32_t mws_sensed(uint32_t acc) {
  return kOp == kNand || kOp == kNor ? ~acc : acc;
}

template <int kOp>
__device__ __forceinline__ uint4 mws_sensed(uint4 acc) {
  return make_uint4(mws_sensed<kOp>(acc.x), mws_sensed<kOp>(acc.y),
                    mws_sensed<kOp>(acc.z), mws_sensed<kOp>(acc.w));
}

// The sense of item i (an element, or 16 bytes as a uint4) over the pages
// src[k * page + i]; A is the accumulator type (uint32_t or uint4).
template <int kOp, int kPages, typename A, typename T, typename I>
__device__ __forceinline__ A mws_sense(const T* __restrict__ src, I page,
                                       I i, int n_ops) {
  A acc;
  if constexpr (kPages > 0) {
    A x[kPages];
#pragma unroll
    for (int k = 0; k < kPages; ++k) x[k] = src[k * page + i];
    acc = x[0];
#pragma unroll
    for (int k = 1; k < kPages; ++k) acc = mws_fold<kOp>(acc, x[k]);
  } else {
    const uint32_t init = kOp == kAnd || kOp == kNand ? ~0u : 0u;
    if constexpr (sizeof(A) == 16) {
      acc = make_uint4(init, init, init, init);
    } else {
      acc = init;
    }
    int k = 0;
    for (; k + 4 <= n_ops; k += 4) {
      A x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = src[(k + j) * page + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc = mws_fold<kOp>(acc, x[j]);
    }
    for (; k < n_ops; ++k) acc = mws_fold<kOp>(acc, A(src[k * page + i]));
  }
  return mws_sensed<kOp>(acc);
}

template <typename U, int kOp, int kPages, typename I>
__global__ void __launch_bounds__(kThreads)
    mws_kernel(const U* __restrict__ stack, U* __restrict__ out, int n_ops,
               I n, int vector) {
  constexpr int kVec = 16 / sizeof(U);
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  I i = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  I done = 0;
  if (vector) {
    const I nv = n / kVec;
    for (I v = i; v < nv; v += stride) {
      reinterpret_cast<uint4*>(out)[v] = mws_sense<kOp, kPages, uint4>(
          reinterpret_cast<const uint4*>(stack), nv, v, n_ops);
    }
    done = nv * kVec;
  }
  for (i += done; i < n; i += stride) {
    out[i] = static_cast<U>(
        mws_sense<kOp, kPages, uint32_t>(stack, n, i, n_ops));
  }
}

// The IFP match line over records of wpr words (records are contiguous:
// record r starts at word r * wpr of the flattened [rows, words] stack).
// The line starts charged (all ones) and every word's XNOR with its query
// word is ANDed onto it (one LOP3); the record matches iff it is still all
// ones.
//
// Bound on an H100: the bytes, 4 * wpr read and 1 written a record.  At the
// replay's [48, 4096] with wpr 4 that is 0.25 us, so the launch and one
// wave's load latency set the time, and the kernel is about few, wide,
// coalesced loads spread over every SM.  Two paths, chosen by the
// launcher:
//   * wpr 4, the replay's record, on a 16-byte aligned stack
//     (search_chunk_kernel): a record is one 16-byte load, sensed against
//     the query held in registers.  One record a thread: at [48, 4096]
//     four records a thread (a 4-byte store) leave 48 blocks for 132 SMs
//     and loads 64 bytes apart, and measured slower (PERF.md).
//   * any other wpr, and a stack not 16-byte aligned (a view at +4 B): one
//     thread a record (search_kernel), the query staged once a block in
//     shared memory where it fits.

// one word onto the match line: line AND XNOR(word, query word)
__device__ __forceinline__ uint32_t sense_word(uint32_t line, uint32_t word,
                                               uint32_t q) {
  return line & ~(word ^ q);
}

__global__ void __launch_bounds__(kThreads)
    search_chunk_kernel(const uint4* __restrict__ stack,
                        const uint32_t* __restrict__ query,
                        unsigned char* __restrict__ out, long long n_recs) {
  const uint32_t q0 = query[0], q1 = query[1], q2 = query[2], q3 = query[3];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long r = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       r < n_recs; r += stride) {
    const uint4 x = stack[r];
    const uint32_t line = sense_word(
        sense_word(sense_word(sense_word(~0u, x.x, q0), x.y, q1), x.z, q2),
        x.w, q3);
    out[r] = line == ~0u ? 1 : 0;
  }
}

// at most this many query words are staged in shared memory (16 KiB)
constexpr int kSearchStagedWords = 4096;

__global__ void __launch_bounds__(kThreads)
    search_kernel(const uint32_t* __restrict__ stack,
                  const uint32_t* __restrict__ query,
                  unsigned char* __restrict__ out, long long n_recs, int wpr,
                  int staged) {
  extern __shared__ uint32_t staged_query[];
  const uint32_t* q = query;
  if (staged) {
    for (int k = threadIdx.x; k < wpr; k += kThreads) {
      staged_query[k] = query[k];
    }
    __syncthreads();
    q = staged_query;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long r = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       r < n_recs; r += stride) {
    const uint32_t* rec = stack + r * wpr;
    uint32_t line = ~0u;
    for (int k = 0; k < wpr; ++k) line = sense_word(line, rec[k], q[k]);
    out[r] = line == ~0u ? 1 : 0;
  }
}

// INT8 GEMM, int8[M,K] @ int8[K,N] -> int32[M,N], row-major, any M, N, K,
// on the tensor cores (mma.sync m16n8k32 .s8.s8.s32).
//
// Replaces repro/kernels/int8_matmul.py _matmul_kernel, which keeps one
// (128, 128) int32 output block resident in VMEM while the sequential K
// grid axis accumulates into it.
//
// Bound on an H100 at the LLM shapes (M = 48 tokens, K and N 1024..8192):
// the bytes of B, the weights, read once (8 MiB at the logits shape, 2.5 us
// at 3.35 TB/s); the 2MNK operations take 0.4 us at the int8 tensor-core
// peak, so the function is bound by its bytes.
//
// Design.
//   * Tensor cores.  A block of 4 warps owns a (16 * MT) x 64 int32 tile
//     (MT m16 tiles, 1..4 from M: 3 at M = 48); each warp owns all its rows
//     and 16 columns, MT x 2 m16n8k32 products a 32-byte step of K.  No
//     .satfinite: the int32 sums wrap, as the TPU kernel's and the plain
//     version's do.
//   * B transposed in registers.  An s8 B fragment word holds 4 consecutive
//     k of one column; B lies [K, N], N contiguous, and ldmatrix .trans
//     moves 16-bit elements only.  So a thread loads 16 columns of 4
//     consecutive k rows (4 x 16 bytes), turns them into 16 words of "4 k
//     of one n" by 4x4 byte transposes (PRMT), and stores them to a
//     Bt[n][k / 4] tile whose rows are padded to 36 words and whose word
//     index is XOR-swizzled by the 16-column chunk, so that both these
//     stores and the fragment loads (single 32-bit LDS) are free of bank
//     conflicts.  A lies [M, K], K contiguous, and goes in as it lies, rows
//     padded the same way.  B is never transposed in device memory.
//   * 16-byte loads wherever a, b, K and N allow (pointers 16-byte aligned,
//     K and N multiples of 16: then every 16-byte chunk lies wholly inside
//     or outside the matrix); else the same tiles are filled a byte at a
//     time.  The ragged edges of M, N and K read as 0.
//   * Split-K.  At M = 48 there are only N / 64 output tiles, 16 at N =
//     1024; K's 128-byte stages are split into S ranges (gridDim.z) so that
//     tiles x S fills the card's SMs in one wave, each range at least two
//     stages, where that shortens each block's walk enough to pay for the
//     memset and the atomics (S = 4 at [48, 1024] x [1024, 1024], 8 at K =
//     2816, 1 at N = 2816 and 8192).  With S > 1 the launcher zeroes `out`
//     (cudaMemsetAsync, on the same stream, part of the call's cost) and
//     each range adds its partial tile with atomicAdd (RED.ADD.S32).  int32 addition modulo 2^32 is associative
//     and commutative, so the result is bit-exact whatever order the
//     partials land in, wrap included.  With S = 1 the tile is stored.
//   * Overlap.  Two stages' 16-byte chunks are in flight in registers
//     while the current stage's products run from one shared buffer; the
//     next stage is then transposed into the other: one __syncthreads a
//     stage.
//
// What holds it back (PERF.md): with one block on an SM, a stage
// costs ~0.5 us of work inside the SM (transposes into shared memory,
// fragment loads, 24 products a warp, the barrier), which neither more
// stages in flight nor more warps shortened; and the memset is a launch
// of its own.
// Left for later: warp-specialised loading into a ring of shared stages
// (cp.async or TMA) beside the products, larger warp tiles or wgmma to
// cut the fragment traffic, persistent blocks, and a split-K reduction
// through a cluster's shared memory in place of the memset and atomics.
constexpr int kMmThreads = 128;             // 4 warps
constexpr int kMmBN = 64;                   // columns a block, 16 a warp
constexpr int kMmBK = 128;                  // bytes of K a stage
constexpr int kMmWords = kMmBK / 4;         // words of 4 k a row and stage
constexpr int kMmPitch = kMmWords + 4;      // 36 words: row r starts at bank
                                            // 4r, so 8 rows x 4 words of a
                                            // fragment load hit 32 banks
constexpr int kMmMinStages = 2;             // stages a split at least
// K is split only where that takes at least this many stages off each
// block's walk: the memset and the atomics cost about as much (PERF.md:
// ~0.5 us a stage, ~2 us the memset on an H100)
constexpr int kMmSplitGain = 6;

// one mma.sync.m16n8k32 .s8.s8.s32, c += a * b, int32 wrapping
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The swizzle of Bt's word index: XOR by the row's 16-column chunk (bits 3
// and 4 of the word index), so that the 4 chunks a warp stores land in 4
// different 8-bank groups.
__device__ __forceinline__ int bt_swizzle(int col) { return (col / 16) << 3; }

// The m16n8k32 .s8 fragments of 32-byte step `s` of a stage (PTX ISA,
// "Matrix Fragments for mma.m16n8k32"; g = lane / 4, t = lane % 4):
//   A: a0 row g, k 4t..4t+3; a1 row g + 8; a2, a3 the same rows at k + 16;
//   B: b0 column g, k 4t..4t+3; b1 the same column at k + 16;
//   C: c0, c1 row g, columns 2t and 2t + 1; c2, c3 row g + 8.
// A word of `as` (rows of the A tile) or `bt` (columns of the B tile) holds
// 4 consecutive k, so each fragment register is one 32-bit shared load.
__device__ __forceinline__ void load_a_frag(const uint32_t* as, int row0,
                                            int s, int lane,
                                            uint32_t (&a)[4]) {
  const uint32_t* p = as + (row0 + lane / 4) * kMmPitch + 8 * s + lane % 4;
  a[0] = p[0];
  a[1] = p[8 * kMmPitch];
  a[2] = p[4];
  a[3] = p[8 * kMmPitch + 4];
}

__device__ __forceinline__ void load_b_frag(const uint32_t* bt, int col0,
                                            int s, int lane,
                                            uint32_t (&b)[2]) {
  const int col = col0 + lane / 4;
  const uint32_t* p = bt + col * kMmPitch;
  b[0] = p[(8 * s + lane % 4) ^ bt_swizzle(col)];
  b[1] = p[(8 * s + 4 + lane % 4) ^ bt_swizzle(col)];
}

// x[i]: 4 bytes (columns j = 0..3) of k row i; y[j]: the 4 k (bytes 0..3)
// of column j
__device__ __forceinline__ void transpose4x4(const uint32_t (&x)[4],
                                             uint32_t (&y)[4]) {
  const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
  const uint32_t t1 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// 16 bytes at p[0..15], those at or past `valid` (ragged edge) as 0
template <bool kVec>
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ p,
                                        long long valid) {
  if (kVec) {
    return valid > 0 ? *reinterpret_cast<const uint4*>(p)
                     : make_uint4(0, 0, 0, 0);
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if (e < valid) {
      w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[e]))
                  << (8 * (e % 4));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One stage of A and B in registers.  Thread t loads A chunk t % 8 (16
// bytes of K) of rows t / 8 + 16 i, and B columns 16 (t % 4)..+15 of k rows
// 4 (t / 4)..+3: neighbouring lanes on neighbouring 16 bytes of one row.
template <int MT, bool kVec>
struct MmStage {
  uint4 ra[MT];
  uint4 rb[4];

  __device__ __forceinline__ void load(const int8_t* __restrict__ a,
                                       const int8_t* __restrict__ b,
                                       long long m, long long n, long long k,
                                       long long row0, long long col0,
                                       long long k0, int tid) {
    const long long ka = k0 + 16 * (tid % 8);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const long long r = row0 + tid / 8 + 16 * i;
      ra[i] = load16<kVec>(a + r * k + ka, r < m ? k - ka : 0);
    }
    const long long c = col0 + 16 * (tid % 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long kk = k0 + 4 * (tid / 4) + i;
      rb[i] = load16<kVec>(b + kk * n + c, kk < k ? n - c : 0);
    }
  }

  __device__ __forceinline__ void store(uint32_t* as, uint32_t* bt,
                                        int tid) const {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      *reinterpret_cast<uint4*>(
          as + (tid / 8 + 16 * i) * kMmPitch + 4 * (tid % 8)) = ra[i];
    }
    const int chunk = 16 * (tid % 4);
    const int word = (tid / 4) ^ bt_swizzle(chunk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t x[4] = {word_of(rb[0], q), word_of(rb[1], q),
                             word_of(rb[2], q), word_of(rb[3], q)};
      uint32_t y[4];
      transpose4x4(x, y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bt[(chunk + 4 * q + j) * kMmPitch + word] = y[j];
      }
    }
  }
};

// The products of one stage: MT x 2 m16n8k32 tiles a 32-byte step of K,
// the warp's 16 columns against all the block's rows.
template <int MT>
__device__ __forceinline__ void mma_stage(const uint32_t* as,
                                          const uint32_t* bt, int warp,
                                          int lane, int (&acc)[MT][2][4]) {
#pragma unroll
  for (int step = 0; step < kMmBK / 32; ++step) {
    uint32_t bf[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      load_b_frag(bt, 16 * warp + 8 * j, step, lane, bf[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t af[4];
      load_a_frag(as, 16 * i, step, lane, af);
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_s8(acc[i][j], af, bf[j]);
    }
  }
}

template <int MT, bool kVec>
__global__ void __launch_bounds__(kMmThreads)
    int8_matmul_mma_kernel(const int8_t* __restrict__ a,
                           const int8_t* __restrict__ b,
                           int32_t* __restrict__ out, long long m,
                           long long n, long long k, long long per_split,
                           int accumulate) {
  __shared__ __align__(16) uint32_t as[2][16 * MT * kMmPitch];
  __shared__ __align__(16) uint32_t bt[2][kMmBN * kMmPitch];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const long long row0 = static_cast<long long>(blockIdx.y) * 16 * MT;
  const long long col0 = static_cast<long long>(blockIdx.x) * kMmBN;
  const long long stages = (k + kMmBK - 1) / kMmBK;
  const long long s0 = static_cast<long long>(blockIdx.z) * per_split;
  const long long count =
      (s0 + per_split < stages ? s0 + per_split : stages) - s0;
  int acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }
  // Two stages in flight.  Step j first moves stage j + 1 (loaded a step
  // ago) from its registers into the other shared buffer, then loads stage
  // j + 2 into the registers that held stage j, then multiplies stage j:
  // nothing after the loads waits for them within the step, so the
  // products run while they are in flight.  The loop runs two steps a turn
  // so that the register sets stay named.
  MmStage<MT, kVec> even, odd;
  auto load = [&](MmStage<MT, kVec>& r, long long j) {
    r.load(a, b, m, n, k, row0, col0, (s0 + j) * kMmBK, tid);
  };
  auto step = [&](long long j, MmStage<MT, kVec>& mine,
                  MmStage<MT, kVec>& other, int buf) {
    if (j + 1 < count) other.store(as[buf ^ 1], bt[buf ^ 1], tid);
    if (j + 2 < count) load(mine, j + 2);
    mma_stage<MT>(as[buf], bt[buf], warp, lane, acc);
    __syncthreads();
  };
  if (count > 0) load(even, 0);
  if (count > 1) load(odd, 1);
  if (count > 0) even.store(as[0], bt[0], tid);
  __syncthreads();
  for (long long j = 0; j < count; j += 2) {
    step(j, even, odd, 0);
    if (j + 1 < count) step(j + 1, odd, even, 1);
  }
  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long col = col0 + 16 * warp + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row0 + 16 * i + lane / 4 + 8 * h;
        if (r >= m || col >= n) continue;
        int32_t* o = out + r * n + col;
        const int v0 = acc[i][j][2 * h];
        const int v1 = acc[i][j][2 * h + 1];
        if (accumulate) {
          atomicAdd(o, v0);
          if (col + 1 < n) atomicAdd(o + 1, v1);
        } else if (n % 2 == 0) {
          *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
        } else {
          o[0] = v0;
          if (col + 1 < n) o[1] = v1;
        }
      }
    }
  }
}

// blocks of kThreads that cover n items, per_block items a block, in one
// pass where n allows it
inline unsigned int grid_for(long long n, long long per_block = kThreads) {
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

template <typename U>
cudaError_t launch_add(const void* a, const void* b, void* out, long long n,
                       void* stream) {
  if (n <= 0) return cudaSuccess;
  constexpr long long kChunk = kThreads * (16 / sizeof(U));
  const unsigned int blocks = grid_for(n, kChunk);
  const auto* x = static_cast<const U*>(a);
  const auto* y = static_cast<const U*>(b);
  auto* o = static_cast<U*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(out)) % 16) == 0) {
    bitserial_add_kernel<U, true><<<blocks, kThreads, 0, st>>>(x, y, o, n);
  } else {
    bitserial_add_kernel<U, false><<<blocks, kThreads, 0, st>>>(x, y, o, n);
  }
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_mul(const void* a, const void* b, void* out, long long n,
                       void* stream) {
  if (n <= 0) return cudaSuccess;
  const long long tiles = (n + kTileElems - 1) / kTileElems;
  long long blocks = (tiles + kPlaneWarps - 1) / kPlaneWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int aligned = ((reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  bitserial_mul_planes_kernel<U><<<static_cast<unsigned int>(blocks),
                                   kPlaneThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(a), static_cast<const U*>(b),
      static_cast<U*>(out), n, aligned);
  return cudaGetLastError();
}

template <int kBits>
void launch_shift_add_rounds(const uint32_t* a, const uint32_t* b,
                             uint32_t* out, long long n, int bits, bool vec,
                             cudaStream_t st) {
  if (vec) {
    shift_add_mul_kernel<kBits, true><<<grid_for(n, kThreads * 4), kThreads,
                                        0, st>>>(a, b, out, n, bits);
  } else {
    shift_add_mul_kernel<kBits, false><<<grid_for(n), kThreads, 0, st>>>(
        a, b, out, n, bits);
  }
}

cudaError_t launch_shift_add(const void* a, const void* b, void* out,
                             long long n, int bits, void* stream) {
  if (bits < 0 || bits > 32) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const auto* x = static_cast<const uint32_t*>(a);
  const auto* y = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(b) |
                     reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (bits == 8) {
    launch_shift_add_rounds<8>(x, y, o, n, bits, vec, st);
  } else {
    launch_shift_add_rounds<0>(x, y, o, n, bits, vec, st);
  }
  return cudaGetLastError();
}

template <typename U, int kOp, int kPages, typename I>
void launch_mws_instance(const void* stack, void* out, int n_ops, I n,
                         bool vector, cudaStream_t st) {
  const long long items = vector ? n / (16 / sizeof(U)) : n;
  mws_kernel<U, kOp, kPages, I><<<grid_for(items > 0 ? items : n),
                                  kThreads, 0, st>>>(
      static_cast<const U*>(stack), static_cast<U*>(out), n_ops, n,
      vector);
}

template <typename U, int kOp, typename I>
void launch_mws_pages(const void* stack, void* out, int n_ops, I n,
                      bool vector, cudaStream_t st) {
  switch (n_ops) {
    case 1:
      return launch_mws_instance<U, kOp, 1>(stack, out, n_ops, n, vector, st);
    case 2:
      return launch_mws_instance<U, kOp, 2>(stack, out, n_ops, n, vector, st);
    case 3:
      return launch_mws_instance<U, kOp, 3>(stack, out, n_ops, n, vector, st);
    case 4:
      return launch_mws_instance<U, kOp, 4>(stack, out, n_ops, n, vector, st);
    default:
      return launch_mws_instance<U, kOp, 0>(stack, out, n_ops, n, vector, st);
  }
}

template <typename U, int kOp>
void launch_mws_op(const void* stack, void* out, int n_ops, long long n,
                   bool vector, cudaStream_t st) {
  // 32-bit indices where every index of the stack, plus a grid's stride,
  // stays below 2**31
  if ((n_ops > 1 ? n_ops : 1) * n <= (1LL << 31) - kMaxBlocks * kThreads) {
    launch_mws_pages<U, kOp, uint32_t>(stack, out, n_ops,
                                       static_cast<uint32_t>(n), vector, st);
  } else {
    launch_mws_pages<U, kOp, long long>(stack, out, n_ops, n, vector, st);
  }
}

template <typename U>
cudaError_t launch_mws(const void* stack, void* out, long long n_ops,
                       long long n, int op, void* stream) {
  if (n_ops < 0 || n_ops > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const int pages = static_cast<int>(n_ops);
  // 16-byte loads: stack and out aligned, and so every page after the first
  const bool vector =
      ((reinterpret_cast<uintptr_t>(stack) |
        reinterpret_cast<uintptr_t>(out)) % 16) == 0 &&
      (pages <= 1 || (n * static_cast<long long>(sizeof(U))) % 16 == 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAnd: launch_mws_op<U, kAnd>(stack, out, pages, n, vector, st); break;
    case kOr: launch_mws_op<U, kOr>(stack, out, pages, n, vector, st); break;
    case kXor: launch_mws_op<U, kXor>(stack, out, pages, n, vector, st); break;
    case kNand:
      launch_mws_op<U, kNand>(stack, out, pages, n, vector, st);
      break;
    case kNor: launch_mws_op<U, kNor>(stack, out, pages, n, vector, st); break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch_search(const void* stack, const void* query, void* out,
                          long long n_recs, int wpr, void* stream) {
  if (wpr < 1) return cudaErrorInvalidValue;
  if (n_recs <= 0) return cudaSuccess;
  const auto* s = static_cast<const uint32_t*>(stack);
  const auto* q = static_cast<const uint32_t*>(query);
  auto* o = static_cast<unsigned char*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wpr == 4 && reinterpret_cast<uintptr_t>(stack) % 16 == 0) {
    search_chunk_kernel<<<grid_for(n_recs), kThreads, 0, st>>>(
        static_cast<const uint4*>(stack), q, o, n_recs);
  } else {
    const int staged = wpr <= kSearchStagedWords;
    search_kernel<<<grid_for(n_recs), kThreads,
                    staged ? wpr * sizeof(uint32_t) : 0, st>>>(
        s, q, o, n_recs, wpr, staged);
  }
  return cudaGetLastError();
}

// The card's SM count, read once per device.
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = sms > 0 ? sms : 132;
  }
  return counts[dev];
}

// How a call is cut: m16 tiles a block (MT), output tiles, K's stages and
// their split into ranges of `per` stages (splits = 0: the launcher's
// choice, below).
struct MmPlan {
  int mt;
  long long row_tiles, col_tiles, stages, per, splits;
};

MmPlan plan_int8_matmul(long long m, long long n, long long k, int splits) {
  MmPlan p;
  p.mt = m >= 64 ? 4 : static_cast<int>((m + 15) / 16);
  if (p.mt < 1) p.mt = 1;
  p.row_tiles = (m + 16 * p.mt - 1) / (16 * p.mt);
  p.col_tiles = (n + kMmBN - 1) / kMmBN;
  p.stages = (k + kMmBK - 1) / kMmBK;
  long long want = splits;
  if (want <= 0) {
    // as many ranges as keep all tiles in one wave, each at least
    // kMmMinStages stages, if that saves kMmSplitGain stages a block
    const long long tiles = p.row_tiles * p.col_tiles;
    want = sm_count() / (tiles > 0 ? tiles : 1);
    const long long most = p.stages / kMmMinStages;
    if (want > most) want = most;
    if (want > 1 &&
        p.stages - (p.stages + want - 1) / want < kMmSplitGain) {
      want = 1;
    }
  }
  if (want > p.stages) want = p.stages;
  if (want < 1) want = 1;
  p.per = (p.stages + want - 1) / want;
  p.splits = p.per > 0 ? (p.stages + p.per - 1) / p.per : 1;
  return p;
}

template <int MT>
void launch_mma(const void* a, const void* b, void* out, long long m,
                long long n, long long k, const MmPlan& p, bool vec,
                cudaStream_t st) {
  const dim3 grid(static_cast<unsigned int>(p.col_tiles),
                  static_cast<unsigned int>(p.row_tiles),
                  static_cast<unsigned int>(p.splits));
  const auto* x = static_cast<const int8_t*>(a);
  const auto* y = static_cast<const int8_t*>(b);
  auto* o = static_cast<int32_t*>(out);
  const int accumulate = p.splits > 1;
  if (vec) {
    int8_matmul_mma_kernel<MT, true><<<grid, kMmThreads, 0, st>>>(
        x, y, o, m, n, k, p.per, accumulate);
  } else {
    int8_matmul_mma_kernel<MT, false><<<grid, kMmThreads, 0, st>>>(
        x, y, o, m, n, k, p.per, accumulate);
  }
}

cudaError_t launch_int8_matmul(const void* a, const void* b, void* out,
                               long long m, long long n, long long k,
                               int splits, void* stream) {
  if (m < 0 || n < 0 || k < 0) return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const MmPlan p = plan_int8_matmul(m, n, k, splits);
  if (p.row_tiles > 65535 || p.col_tiles > 0x7fffffffLL ||
      p.splits > 65535) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.splits > 1) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(m) * static_cast<size_t>(n) * 4, st);
    if (err != cudaSuccess) return err;
  }
  // 16-byte loads: both pointers aligned (a view may start anywhere) and
  // every row pitch a multiple of 16 bytes
  const bool vec = ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(b)) % 16) == 0 &&
                   k % 16 == 0 && n % 16 == 0;
  switch (p.mt) {
    case 1: launch_mma<1>(a, b, out, m, n, k, p, vec, st); break;
    case 2: launch_mma<2>(a, b, out, m, n, k, p, vec, st); break;
    case 3: launch_mma<3>(a, b, out, m, n, k, p, vec, st); break;
    default: launch_mma<4>(a, b, out, m, n, k, p, vec, st); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// splits: K ranges, 0 for the launcher's choice
int ndp_int8_matmul(const void* a, const void* b, void* out, long long m,
                    long long n, long long k, int splits, void* stream) {
  return static_cast<int>(
      launch_int8_matmul(a, b, out, m, n, k, splits, stream));
}

// The plan of a call: plan[0] K ranges, plan[1] x plan[2] the output tile,
// plan[3] bytes of K a stage.  Returns 0.
int ndp_int8_matmul_plan(long long m, long long n, long long k, int splits,
                         int* plan) {
  const MmPlan p = plan_int8_matmul(m, n, k, splits);
  plan[0] = static_cast<int>(p.splits);
  plan[1] = 16 * p.mt;
  plan[2] = kMmBN;
  plan[3] = kMmBK;
  return 0;
}

int ndp_mws_i8(const void* stack, void* out, long long n_ops, long long n,
               int op, void* stream) {
  return static_cast<int>(
      launch_mws<uint8_t>(stack, out, n_ops, n, op, stream));
}

int ndp_mws_i32(const void* stack, void* out, long long n_ops, long long n,
                int op, void* stream) {
  return static_cast<int>(
      launch_mws<uint32_t>(stack, out, n_ops, n, op, stream));
}

int ndp_search_i32(const void* stack, const void* query, void* out,
                   long long n_recs, int wpr, void* stream) {
  return static_cast<int>(
      launch_search(stack, query, out, n_recs, wpr, stream));
}

int ndp_bitserial_add_i8(const void* a, const void* b, void* out,
                         long long n, void* stream) {
  return static_cast<int>(launch_add<uint8_t>(a, b, out, n, stream));
}

int ndp_bitserial_add_i32(const void* a, const void* b, void* out,
                          long long n, void* stream) {
  return static_cast<int>(launch_add<uint32_t>(a, b, out, n, stream));
}

int ndp_bitserial_mul_i8(const void* a, const void* b, void* out,
                         long long n, void* stream) {
  return static_cast<int>(launch_mul<uint8_t>(a, b, out, n, stream));
}

int ndp_bitserial_mul_i32(const void* a, const void* b, void* out,
                          long long n, void* stream) {
  return static_cast<int>(launch_mul<uint32_t>(a, b, out, n, stream));
}

int ndp_shift_add_mul_i32(const void* a, const void* b, void* out,
                          long long n, int bits, void* stream) {
  return static_cast<int>(launch_shift_add(a, b, out, n, bits, stream));
}

}  // extern "C"
