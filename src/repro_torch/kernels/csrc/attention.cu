// Attention with an online softmax, written for Hopper (sm_90a).
//
// Replaces repro/kernels/attention.py _attn_kernel (the Pallas
// FlashAttention-style kernel: grid (heads, q-blocks), one q tile in VMEM,
// k/v tiles streamed with a running (max, normaliser, accumulator)).  Per
// head: out = softmax(q k^T * scale [causal]) v over q [H, Sq, dh] and
// k, v [H, Sk, dh], fp32 arithmetic throughout, the output cast to q's
// type.  The causal mask is q_pos >= k_pos, aligned top-left as the TPU
// kernel aligns it, and k tiles wholly past a block's last row are never
// loaded.  Any Sq and Sk: the ragged q rows are not stored and the ragged
// keys are masked, so nothing is padded.
//
// Design.  A block of 256 threads owns one head and a tile of rows; a row
// is split over R = dh / 16 neighbouring lanes (1, 2, 4 or 8), each holding
// 16 of the row's q values and 16 of its accumulators in registers, so a
// thread needs the same 80 registers at every dh (ptxas; one thread per row
// would need 4 dh for them alone at dh = 128).  Lane l of a row owns the dims
// 4 (l + R i) + c, i, c < 4: for each i the R lanes read 4R consecutive
// floats, one 16-byte shared load each, without bank conflicts, and every
// row of the warp reads the same key (a broadcast).  A row's dot product is
// summed over its lanes with xor shuffles, which leaves the identical sum
// in every lane, so the lanes of a row keep identical (max, normaliser).
// K and V tiles pass through shared memory as fp32 (converted once on the
// load, read by every row of the block), at most 32 KB for the pair, under
// the 48 KB static limit: 64 keys up to dh = 64, 32 at dh = 128.  Keys are
// scored eight at a time before one rescale of the accumulators, so a key
// costs one exponential and not two.  q is scaled by scale * log2(e) on
// load and the exponentials are exp2.
//
// Bound on an H100 at the serving shape (B 4 x H 32, prompt 1024, dh 64,
// bf16, causal): the bytes of q, k, v and out, ~20 us.  This design runs
// on the CUDA cores in fp32, so it is held at >= 257 us by their 67 TFLOP/s
// FMA rate, and further by shared memory: every warp reads each key's K and
// V rows again, eight 16-byte loads a key.  mma.sync / wgmma for the two
// products, which read a fragment once for 16 rows, is its next step
// (PERF.md).
//
// Plain C ABI, one function per element type, bound from Python with
// ctypes.  Each launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of its launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDimsPerLane = 16;  // q values and accumulators per thread
constexpr int kChunk = 8;         // keys scored before one rescale

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DH>
struct Tile {
  static constexpr int kLanes = DH / kDimsPerLane;    // threads per row
  static constexpr int kRows = kThreads / kLanes;     // q rows per block
  static constexpr int kKeys = DH <= 64 ? 64 : 32;    // keys per K/V tile
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      unsigned int q_tiles, long long sq, long long sk,
                      int causal, float scale_log2) {
  constexpr int R = Tile<DH>::kLanes;
  constexpr int BQ = Tile<DH>::kRows;
  constexpr int BK = Tile<DH>::kKeys;
  static_assert(BK % kChunk == 0, "a tile holds whole chunks");
  __shared__ __align__(16) float ks[BK][DH];
  __shared__ __align__(16) float vs[BK][DH];

  // the longest causal blocks (last q tiles) are launched first; 32-bit
  // division (a 64-bit one is a call, with a stack frame and spills)
  const long long head = blockIdx.x / q_tiles;
  const long long q_tile = q_tiles - 1 - blockIdx.x % q_tiles;
  const int lane = threadIdx.x % R;
  const long long row = q_tile * BQ + threadIdx.x / R;
  const bool live = row < sq;
  const T* kh = k + head * sk * DH;
  const T* vh = v + head * sk * DH;

  float qr[kDimsPerLane], acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * (lane + R * i) + c;
      qr[4 * i + c] =
          live ? to_float(q[(head * sq + row) * DH + d]) * scale_log2 : 0.f;
      acc[4 * i + c] = 0.f;
    }
  }
  float m = -CUDART_INF_F;  // running max (log2 units)
  float l = 0.f;            // running normaliser

  // keys [0, k_end): all, or (causal) up to the block's last row
  const long long k_end = causal ? min(sk, (q_tile + 1) * BQ) : sk;
  for (long long k0 = 0; k0 < k_end; k0 += BK) {
    const int n = static_cast<int>(min(static_cast<long long>(BK),
                                       k_end - k0));
    __syncthreads();  // every row is done with the previous tile
    for (int e = threadIdx.x; e < BK * DH; e += kThreads) {
      const int j = e / DH;
      const int d = e % DH;
      const bool in = j < n;
      ks[j][d] = in ? to_float(kh[(k0 + j) * DH + d]) : 0.f;
      vs[j][d] = in ? to_float(vh[(k0 + j) * DH + d]) : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float s[kChunk];
      float chunk_max = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(ks[j0 + j]);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 kk = kr[lane + R * i];
          dot = fmaf(qr[4 * i + 0], kk.x, dot);
          dot = fmaf(qr[4 * i + 1], kk.y, dot);
          dot = fmaf(qr[4 * i + 2], kk.z, dot);
          dot = fmaf(qr[4 * i + 3], kk.w, dot);
        }
#pragma unroll
        for (int off = 1; off < R; off <<= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        const long long k_pos = k0 + j0 + j;
        if (j0 + j >= n || (causal && k_pos > row)) dot = -CUDART_INF_F;
        s[j] = dot;
        chunk_max = fmaxf(chunk_max, dot);
      }
      // Key 0 is in every row's first chunk and never masked (top-left),
      // so m_new is finite from the first chunk on; a later chunk that is
      // wholly masked for a row leaves its state as it was.
      const float m_new = fmaxf(m, chunk_max);
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kDimsPerLane; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = exp2f(s[j] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs[j0 + j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 vv = vr[lane + R * i];
          acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * (lane + R * i) + c;
      store(&out[(head * sq + row) * DH + d], acc[4 * i + c] / l);
    }
  }
}

template <typename T, int DH>
cudaError_t launch_dh(const void* q, const void* k, const void* v, void* out,
                      long long heads, long long sq, long long sk,
                      int causal, float scale_log2, cudaStream_t stream) {
  const long long q_tiles = (sq + Tile<DH>::kRows - 1) / Tile<DH>::kRows;
  const long long blocks = heads * q_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attn_kernel<T, DH>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out),
          static_cast<unsigned int>(q_tiles), sq, sk, causal, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_flash_attn(const void* q, const void* k, const void* v,
                              void* out, long long heads, long long sq,
                              long long sk, int dh, int causal,
                              float scale_log2, void* stream) {
  if (heads < 0 || sq < 0 || sk < 1) return cudaErrorInvalidValue;
  if (heads == 0 || sq == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return launch_dh<T, 16>(q, k, v, out, heads, sq, sk, causal,
                              scale_log2, st);
    case 32:
      return launch_dh<T, 32>(q, k, v, out, heads, sq, sk, causal,
                              scale_log2, st);
    case 64:
      return launch_dh<T, 64>(q, k, v, out, heads, sq, sk, causal,
                              scale_log2, st);
    case 128:
      return launch_dh<T, 128>(q, k, v, out, heads, sq, sk, causal,
                               scale_log2, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int ndp_flash_attn_f32(const void* q, const void* k, const void* v,
                       void* out, long long heads, long long sq, long long sk,
                       int dh, int causal, float scale_log2, void* stream) {
  return static_cast<int>(launch_flash_attn<float>(
      q, k, v, out, heads, sq, sk, dh, causal, scale_log2, stream));
}

int ndp_flash_attn_bf16(const void* q, const void* k, const void* v,
                        void* out, long long heads, long long sq,
                        long long sk, int dh, int causal, float scale_log2,
                        void* stream) {
  return static_cast<int>(launch_flash_attn<__nv_bfloat16>(
      q, k, v, out, heads, sq, sk, dh, causal, scale_log2, stream));
}

}  // extern "C"
