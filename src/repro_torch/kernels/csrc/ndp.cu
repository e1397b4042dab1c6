// Functional models of the SSD's NDP resources, written for Hopper (sm_90a).
//
//   bitserial add / mul  — PuD (SIMDRAM/MIMDRAM) bit-serial arithmetic;
//                          replaces repro/kernels/bitserial.py _add_kernel
//                          and _mul_kernel.
//   shift_add_mul        — IFP (Ares-Flash) latch shift-and-add multiply;
//                          replaces repro/kernels/shift_add.py
//                          _shift_add_kernel.
//
// Each kernel keeps the gate-level loop of the TPU kernel, because that
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

}  // namespace

extern "C" {

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
