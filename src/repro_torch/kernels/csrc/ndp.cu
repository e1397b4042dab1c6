// Functional models of the SSD's NDP resources, written for Hopper (sm_90a).
//
//   bitserial add / mul  — PuD (SIMDRAM/MIMDRAM) bit-serial arithmetic;
//                          replaces repro/kernels/bitserial.py _add_kernel
//                          and _mul_kernel.
//   shift_add_mul        — IFP (Ares-Flash) latch shift-and-add multiply;
//                          replaces repro/kernels/shift_add.py
//                          _shift_add_kernel.
//   mws                  — IFP (Flash-Cosmos) multi-wordline sensing: a
//                          bulk and/or/xor/nand/nor over n_ops stacked
//                          pages; replaces repro/kernels/mws.py
//                          _mws_kernel.
//   search               — IFP match line: XNOR of every record word with
//                          the query, wired-AND over the record; replaces
//                          repro/kernels/search.py _search_kernel.
//   int8_matmul          — the INT8 GEMM of the quantized LLM workloads
//                          (§5.4), int8[M,K] @ int8[K,N] -> int32[M,N];
//                          replaces repro/kernels/int8_matmul.py
//                          _matmul_kernel.  See its own note below.
//
// Each elementwise kernel (all but int8_matmul) keeps the gate-level loop
// of the TPU kernel, because that
// loop *is* the model of the in-memory circuit: the adder is built only
// from XOR (sum) and AND-then-shift (carry) row operations, the
// multipliers from predicated shifted partial products.  It is not carried
// over block by block: no VMEM tiles and no (8, 128) padding, but one flat
// grid-stride pass over n contiguous elements, neighbouring threads on
// neighbouring addresses, the ragged end masked by the index test.
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

// W-round (or `rounds`) ripple: s = x ^ y (XOR row-op), c = (x & y) << 1
// (MAJ row-op + shift); after W rounds the carry has left the word.
template <typename U, int kRounds>
__device__ __forceinline__ U ripple_add(U x, U y) {
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const U s = static_cast<U>(x ^ y);
    const U c = static_cast<U>(static_cast<U>(x & y) << 1);
    x = s;
    y = c;
  }
  return static_cast<U>(x | y);
}

template <typename U>
__global__ void bitserial_add_kernel(const U* __restrict__ a,
                                     const U* __restrict__ b,
                                     U* __restrict__ out, long long n) {
  constexpr int W = Width<U>::value;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = ripple_add<U, W>(a[i], b[i]);
  }
}

// W predicated partial products (b_i ? a << i : 0), each folded into the
// accumulator by the same XOR/AND ripple over 2W rounds.
template <typename U>
__global__ void bitserial_mul_kernel(const U* __restrict__ a,
                                     const U* __restrict__ b,
                                     U* __restrict__ out, long long n) {
  constexpr int W = Width<U>::value;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const U x = a[i];
    const U y = b[i];
    U acc = 0;
#pragma unroll 1
    for (int k = 0; k < W; ++k) {
      const U pp = ((y >> k) & 1u) ? static_cast<U>(x << k) : U(0);
      acc = ripple_add<U, 2 * W>(acc, pp);
    }
    out[i] = acc;
  }
}

// Ares-Flash latch rounds: the multiplier's bit i is broadcast, ANDed with
// the page shifted by i, and accumulated; only the low `bits` bits of b
// take part, as in the latch datapath.
template <typename U>
__global__ void shift_add_mul_kernel(const U* __restrict__ a,
                                     const U* __restrict__ b,
                                     U* __restrict__ out, long long n,
                                     int bits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const U x = a[i];
    const U y = b[i];
    U acc = 0;
    for (int k = 0; k < bits; ++k) {
      const U pp = ((y >> k) & 1u) ? static_cast<U>(x << k) : U(0);
      acc = static_cast<U>(acc + pp);
    }
    out[i] = acc;
  }
}

// The op codes of ndp_mws_*; the order of repro_torch/kernels/mws.py OPS.
enum MwsOp : int { kAnd = 0, kOr = 1, kXor = 2, kNand = 3, kNor = 4 };

// Flash-Cosmos sense of n_ops wordlines: element i of every operand page
// (stack[k * n + i]) is read once and folded into a register, as the
// wired-AND (or the OR across blocks) folds the cells of a NAND string in
// one array sense; nand/nor invert the sensed value.  For each k the warp
// reads 32 neighbouring elements of page k.
template <typename U, int kOp>
__global__ void mws_kernel(const U* __restrict__ stack, U* __restrict__ out,
                           long long n_ops, long long n) {
  constexpr bool kIsAnd = kOp == kAnd || kOp == kNand;
  constexpr bool kIsOr = kOp == kOr || kOp == kNor;
  constexpr bool kNegate = kOp == kNand || kOp == kNor;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    U acc = kIsAnd ? static_cast<U>(~U(0)) : U(0);
    for (long long k = 0; k < n_ops; ++k) {
      const U page = stack[k * n + i];
      if (kIsAnd) {
        acc = static_cast<U>(acc & page);
      } else if (kIsOr) {
        acc = static_cast<U>(acc | page);
      } else {
        acc = static_cast<U>(acc ^ page);
      }
    }
    out[i] = kNegate ? static_cast<U>(~acc) : acc;
  }
}

// One thread per record of wpr words (records are contiguous: record r
// starts at word r * wpr of the flattened [rows, words] stack).  The match
// line starts charged (all ones) and every word's XNOR with the query is
// ANDed onto it; the record matches iff it is still all ones.
__global__ void search_kernel(const uint32_t* __restrict__ stack,
                              const uint32_t* __restrict__ query,
                              unsigned char* __restrict__ out,
                              long long n_recs, int wpr) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n_recs; r += stride) {
    const uint32_t* rec = stack + r * wpr;
    uint32_t line = ~0u;
    for (int k = 0; k < wpr; ++k) line &= ~(rec[k] ^ query[k]);
    out[r] = line == ~0u ? 1 : 0;
  }
}

// INT8 GEMM, int8[M,K] @ int8[K,N] -> int32[M,N], row-major, any M, N, K.
//
// The TPU kernel keeps one (128, 128) int32 output block resident in VMEM
// while the sequential K grid axis accumulates into it.  Here one block of
// 256 threads owns a kMmBM x kMmBN output tile in registers and walks K
// itself, staging kMmBK bytes of K of A and B in shared memory per step:
//   * A's tile is stored as it lies: 4 consecutive k of one row per word;
//   * B's tile is stored transposed, 4 consecutive k of one column per
//     word, so that __dp4a multiplies four int8 pairs and adds them to an
//     int32 accumulator in one instruction;
//   * every byte is loaded on its own, masked to 0 outside M, N or K, so
//     no shape needs padding and no row needs alignment.
// Thread (ty, tx) computes row ty and columns tx + 16 j (j < 4) of the
// tile; a warp reads 16 distinct B rows of the padded (stride 33 words)
// shared tile, conflict-free, and two A words, each broadcast.  The int32
// sums wrap as int32 arithmetic does, as the TPU kernel's do.
//
// At the LLM shapes (M = 48 tokens, K and N 1024..8192) the function is
// bound by the bytes of B (the weights) read once; this simple form is
// instead bound by its serial stage loop (load, sync, compute) and by
// byte-wide loads: tensor cores (mma.sync s8, then wgmma with TMA) are
// the way to the bound, in a later change.
constexpr int kMmBM = 16;
constexpr int kMmBN = 64;
constexpr int kMmBK = 128;                  // bytes of K per stage
constexpr int kMmWords = kMmBK / 4;         // packed words of K per stage
constexpr int kMmThreads = 256;

__global__ void __launch_bounds__(kMmThreads)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   int32_t* __restrict__ out, long long m, long long n,
                   long long k) {
  __shared__ uint32_t as[kMmBM][kMmWords + 1];
  __shared__ uint32_t bs[kMmBN][kMmWords + 1];
  const int t = threadIdx.x;
  const int ty = t / 16;
  const int tx = t % 16;
  const long long row0 = static_cast<long long>(blockIdx.y) * kMmBM;
  const long long col0 = static_cast<long long>(blockIdx.x) * kMmBN;
  // loaders: two words of one A row, eight words of one B column
  const int a_row = t / 16;
  const int a_word = (t % 16) * 2;
  const int b_col = t % kMmBN;
  const int b_word = (t / kMmBN) * 8;
  int acc[4] = {0, 0, 0, 0};
  for (long long k0 = 0; k0 < k; k0 += kMmBK) {
    const long long r = row0 + a_row;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long kk = k0 + (a_word + w) * 4 + i;
        const uint32_t v =
            (r < m && kk < k) ? static_cast<uint8_t>(a[r * k + kk]) : 0u;
        word |= v << (8 * i);
      }
      as[a_row][a_word + w] = word;
    }
    const long long c = col0 + b_col;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long kk = k0 + (b_word + w) * 4 + i;
        const uint32_t v =
            (c < n && kk < k) ? static_cast<uint8_t>(b[kk * n + c]) : 0u;
        word |= v << (8 * i);
      }
      bs[b_col][b_word + w] = word;
    }
    __syncthreads();
#pragma unroll 8
    for (int w = 0; w < kMmWords; ++w) {
      const int av = static_cast<int>(as[ty][w]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j] = __dp4a(av, static_cast<int>(bs[tx + 16 * j][w]), acc[j]);
      }
    }
    __syncthreads();
  }
  const long long r = row0 + ty;
  if (r >= m) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long c = col0 + tx + 16 * j;
    if (c < n) out[r * n + c] = acc[j];
  }
}

inline unsigned int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

template <typename U>
cudaError_t launch_add(const void* a, const void* b, void* out, long long n,
                       void* stream) {
  if (n <= 0) return cudaSuccess;
  bitserial_add_kernel<U><<<grid_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(a), static_cast<const U*>(b),
      static_cast<U*>(out), n);
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_mul(const void* a, const void* b, void* out, long long n,
                       void* stream) {
  if (n <= 0) return cudaSuccess;
  bitserial_mul_kernel<U><<<grid_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(a), static_cast<const U*>(b),
      static_cast<U*>(out), n);
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_shift_add(const void* a, const void* b, void* out,
                             long long n, int bits, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (bits < 0 || bits > Width<U>::value) return cudaErrorInvalidValue;
  shift_add_mul_kernel<U><<<grid_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(a), static_cast<const U*>(b),
      static_cast<U*>(out), n, bits);
  return cudaGetLastError();
}

template <typename U>
cudaError_t launch_mws(const void* stack, void* out, long long n_ops,
                       long long n, int op, void* stream) {
  if (n_ops < 0) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const auto* s = static_cast<const U*>(stack);
  auto* o = static_cast<U*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kAnd:
      mws_kernel<U, kAnd><<<grid_for(n), kThreads, 0, st>>>(s, o, n_ops, n);
      break;
    case kOr:
      mws_kernel<U, kOr><<<grid_for(n), kThreads, 0, st>>>(s, o, n_ops, n);
      break;
    case kXor:
      mws_kernel<U, kXor><<<grid_for(n), kThreads, 0, st>>>(s, o, n_ops, n);
      break;
    case kNand:
      mws_kernel<U, kNand><<<grid_for(n), kThreads, 0, st>>>(s, o, n_ops, n);
      break;
    case kNor:
      mws_kernel<U, kNor><<<grid_for(n), kThreads, 0, st>>>(s, o, n_ops, n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t launch_search(const void* stack, const void* query, void* out,
                          long long n_recs, int wpr, void* stream) {
  if (wpr < 1) return cudaErrorInvalidValue;
  if (n_recs <= 0) return cudaSuccess;
  search_kernel<<<grid_for(n_recs), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(stack), static_cast<const uint32_t*>(query),
      static_cast<unsigned char*>(out), n_recs, wpr);
  return cudaGetLastError();
}

cudaError_t launch_int8_matmul(const void* a, const void* b, void* out,
                               long long m, long long n, long long k,
                               void* stream) {
  if (m < 0 || n < 0 || k < 0) return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const long long row_tiles = (m + kMmBM - 1) / kMmBM;
  const long long col_tiles = (n + kMmBN - 1) / kMmBN;
  if (row_tiles > 65535 || col_tiles > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned int>(col_tiles),
                  static_cast<unsigned int>(row_tiles));
  int8_matmul_kernel<<<grid, kMmThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int32_t*>(out), m, n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ndp_int8_matmul(const void* a, const void* b, void* out, long long m,
                    long long n, long long k, void* stream) {
  return static_cast<int>(launch_int8_matmul(a, b, out, m, n, k, stream));
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
  return static_cast<int>(
      launch_shift_add<uint32_t>(a, b, out, n, bits, stream));
}

}  // extern "C"
