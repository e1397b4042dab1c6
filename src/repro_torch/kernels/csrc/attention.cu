// Attention with an online softmax, written for Hopper (sm_90a).
//
// Replaces repro/kernels/attention.py _attn_kernel (the Pallas
// FlashAttention-style kernel: grid (heads, q-blocks), one q tile in VMEM,
// k/v tiles streamed with a running (max, normaliser, accumulator)).  Per
// head: out = softmax(q k^T * scale [causal]) v over q, k [H, S, dh] and
// v [H, Sk, dv], the output [H, Sq, dv] in q's type (dv = dh but for
// MLA's pair, dh 192 and dv 128, which the bf16 kernel alone takes).  The
// causal mask is q_pos >= k_pos, aligned top-left as the TPU kernel aligns
// it, and k tiles wholly past a block's last row are never loaded.  Any Sq
// and Sk: the ragged q rows are not stored and the ragged keys are masked,
// so nothing is padded.  Two kernels, chosen by the element type:
//
// bf16: flash_attn_mma_kernel, FlashAttention-2 on the tensor cores.  A
// block of 4 warps owns one head and 64 q rows, 16 rows a warp.  q, K and
// V pass through shared memory as bf16, copied with 16-byte cp.async (K/V
// tiles of 64 keys, double-buffered: the next tile's copy runs under this
// tile's products), each row's 16-byte chunks XOR-swizzled with the row so
// that ldmatrix and the copies are free of bank conflicts.  A warp's q
// fragments are loaded once (ldmatrix) and stay in registers.  S = q k^T
// and O += P v are mma.sync m16n8k16 bf16 products with fp32 accumulators
// (K fragments by ldmatrix, V by ldmatrix.trans), so each K/V fragment is
// read once for 16 rows.  S is scaled by scale * log2(e) in fp32 after the
// product; the online softmax runs on the accumulator fragments (a row's
// max and sum over its lane quad, two xor shuffles; exp2f), and P goes from
// the S accumulators to bf16 A fragments in registers (FlashAttention-2's
// layout identity: an m16n8 accumulator pair is an m16k16 A fragment).
// Only a tile on the causal diagonal or past Sk is masked (to -inf).  Key 0
// is unmasked for every row (top-left) and tile 0 is always the first, so
// a row's running max is finite from the first tile on.  The blocks of the
// last q tiles, the longest under the causal mask, launch first.
//
// Precision.  P is rounded to bf16 for P v (relative error 2^-9 a
// weight), and the normaliser l is summed from the same rounded values, so
// the output is an exact weighted mean of v under weights each within
// 2^-9 of the softmax's; the plain version keeps fp32 weights.  The two
// differ by that and by one rounding of the output to bf16 (PERF.md gives
// the largest difference measured).
//
// Bound on an H100 at the serving shape (B 4 x H 32, prompt 1024, dh 64,
// bf16, causal): the bytes of q, k, v and out, ~20 us; the causal products'
// 1.7e10 flops take ~17 us at the bf16 tensor-core peak.  mma.sync reaches
// a fraction of that peak (wgmma with TMA and warp specialisation is the
// way to the rest), and each key costs one exp2 a row on the SFU.
//
// fp32: flash_attn_kernel, on the CUDA cores in fp32 throughout (TF32
// would lose the fp32 tolerance).  A block of 256 threads owns one head and
// a tile of rows; a row is split over R = dh / 16 neighbouring lanes (1, 2,
// 4 or 8), each holding 16 of the row's q values and 16 of its accumulators
// in registers, so a thread needs the same 80 registers at every dh (ptxas;
// one thread per row would need 4 dh for them alone at dh = 128).  Lane l
// of a row owns the dims 4 (l + R i) + c, i, c < 4: for each i the R lanes
// read 4R consecutive floats, one 16-byte shared load each, without bank
// conflicts, and every row of the warp reads the same key (a broadcast).  A
// row's dot product is summed over its lanes with xor shuffles, which
// leaves the identical sum in every lane, so the lanes of a row keep
// identical (max, normaliser).  K and V tiles pass through shared memory
// (at most 32 KB for the pair, under the 48 KB static limit: 64 keys up to
// dh = 64, 32 at dh = 128).  Keys are scored eight at a time before one
// rescale of the accumulators, so a key costs one exponential and not two.
// q is scaled by scale * log2(e) on load and the exponentials are exp2.  It
// is held by the fp32 FMA rate (>= 257 us at the serving shape) and by
// shared-memory loads: every warp reads each key's K and V rows again.
//
// Plain C ABI, one function per element type, bound from Python with
// ctypes.  Each launches on the caller's stream, allocates nothing, does
// not synchronise, and returns the first CUDA error of its set-up or
// launch.  The bf16 kernel needs q, k, v and out 16-byte aligned (the
// wrapper checks).

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDimsPerLane = 16;  // q values and accumulators per thread
constexpr int kChunk = 8;         // keys scored before one rescale

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// -- bf16 on the tensor cores ------------------------------------------------

constexpr int kMmaThreads = 128;   // 4 warps, 16 q rows each
constexpr int kMmaRows = 64;       // q rows a block
constexpr int kMmaKeys = 64;       // keys a K/V tile

template <int DH>
struct MmaTile {
  static constexpr int kChunks = DH / 8;             // 16-byte chunks a row
  static constexpr int kBytes = kMmaKeys * DH * 2;   // one tile of width DH
  // byte offset of chunk c of row r: the chunk XOR-swizzled with the row,
  // so that the 8 rows of an ldmatrix 8x8 (and 8 consecutive chunks of a
  // copy) fall in 8 distinct 16-byte bank groups
  static __device__ __forceinline__ uint32_t offset(int r, int c) {
    constexpr int kRowsPerPattern = kChunks >= 8 ? 1 : 8 / kChunks;
    constexpr int kPattern = kChunks >= 8 ? 8 : kChunks;
    return static_cast<uint32_t>(
        (r * kChunks + (c ^ ((r / kRowsPerPattern) % kPattern))) * 16);
  }
};

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled (nothing read) when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// rows [0, left) of a 64-row tile at src to shared memory at dst; rows past
// `left` are zero-filled (their copies read nothing, from `safe`)
template <int DH>
__device__ __forceinline__ void copy_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long left,
                                          const __nv_bfloat16* safe) {
  constexpr int C = MmaTile<DH>::kChunks;
#pragma unroll
  for (int it = 0; it < kMmaKeys * C / kMmaThreads; ++it) {
    const int i = threadIdx.x + it * kMmaThreads;
    const int r = i / C;
    const int c = i % C;
    const bool in = r < left;
    cp_async16(dst + MmaTile<DH>::offset(r, c),
               in ? static_cast<const void*>(src + r * DH + c * 8) : safe,
               in);
  }
}

// q, then K and V twice (double buffer): q and K tiles of width DQK, V
// tiles of width DV
template <int DQK, int DV>
constexpr int mma_smem_bytes() {
  return 3 * MmaTile<DQK>::kBytes + 2 * MmaTile<DV>::kBytes;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, long long sq,
                          long long sk, int causal, float scale_log2) {
  using T = MmaTile<DQK>;       // q and K tiles
  using TV = MmaTile<DV>;       // V tiles
  constexpr int KS = DQK / 16;  // 16-wide slices of q k^T's depth
  constexpr int ND = DV / 8;    // 8-wide column tiles of the output
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = shared_address(smem);
  const uint32_t ks[2] = {qs + T::kBytes,
                          qs + 2 * T::kBytes + TV::kBytes};
  const uint32_t vs[2] = {qs + 2 * T::kBytes,
                          qs + 3 * T::kBytes + TV::kBytes};

  const long long head = blockIdx.x;
  const long long q0 = static_cast<long long>(gridDim.y - 1 - blockIdx.y) *
                       kMmaRows;   // the last (longest) q tiles first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;         // accumulator rows g and g + 8
  const int t = lane % 4;         // accumulator columns 2t, 2t + 1
  const int mi = lane / 8;        // ldmatrix: the 8x8 matrix this lane
  const int mr = lane % 8;        // addresses, and its row in it
  const long long w0 = q0 + warp * 16;   // the warp's first row
  const __nv_bfloat16* qh = q + head * sq * DQK;
  const __nv_bfloat16* kh = k + head * sk * DQK;
  const __nv_bfloat16* vh = v + head * sk * DV;

  const long long k_end = causal ? min(sk, q0 + kMmaRows) : sk;
  const int n_tiles = static_cast<int>((k_end + kMmaKeys - 1) / kMmaKeys);
  copy_tile<DQK>(qs, qh + q0 * DQK, sq - q0, qh);
  copy_tile<DQK>(ks[0], kh, sk, kh);
  copy_tile<DV>(vs[0], vh, sk, vh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldmatrix_x4(qf[kk], qs + T::offset(warp * 16 + mr + 8 * (mi % 2),
                                       2 * kk + mi / 2));
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max, log2 units
  float l[2] = {0.f, 0.f};   // this lane's part of the running normaliser

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {   // the next tile's copy runs under this tile
      const long long k1 = static_cast<long long>(j + 1) * kMmaKeys;
      copy_tile<DQK>(ks[buf ^ 1], kh + k1 * DQK, sk - k1, kh);
      copy_tile<DV>(vs[buf ^ 1], vh + k1 * DV, sk - k1, vh);
      cp_async_commit();
    }

    // S = q k^T: the warp's 16 rows x 64 keys, eight 16x8 tiles
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ks[buf] + T::offset(16 * np + mr + 8 * (mi / 2),
                                           2 * kk + mi % 2));
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale; mask the causal diagonal and the keys past Sk
    const long long k0 = static_cast<long long>(j) * kMmaKeys;
    const bool edge =
        (causal && k0 + kMmaKeys - 1 > w0) || k0 + kMmaKeys > sk;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const long long kp = k0 + 8 * n + 2 * t + (e & 1);
          const long long qp = w0 + g + 8 * (e >> 1);
          if (kp >= sk || (causal && kp > qp)) x = -CUDART_INF_F;
        }
        s[n][e] = x;
      }
    }

    // online softmax over the quad that shares each row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // P in bf16 as A fragments (keys 16 kk .. 16 kk + 15), l from the same
    // rounded weights
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * kk + h;
        const __nv_bfloat162 top = __floats2bfloat162_rn(
            exp2f(s[n][0] - m[0]), exp2f(s[n][1] - m[0]));
        const __nv_bfloat162 bot = __floats2bfloat162_rn(
            exp2f(s[n][2] - m[1]), exp2f(s[n][3] - m[1]));
        l[0] += __low2float(top) + __high2float(top);
        l[1] += __low2float(bot) + __high2float(bot);
        pf[kk][2 * h] = as_u32(top);
        pf[kk][2 * h + 1] = as_u32(bot);
      }
    }

    // O += P v
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs[buf] + TV::offset(16 * kk + mr + 8 * (mi % 2),
                                                  2 * dp + mi / 2));
        mma_bf16(o[2 * dp], pf[kk], b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], b[2], b[3]);
      }
    }
    cp_async_wait<0>();   // the next tile has landed,
    __syncthreads();      // and every warp is done with this one
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = w0 + g + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* dst = out + (head * sq + row) * DV + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    }
  }
}

template <int DQK, int DV>
cudaError_t launch_mma_dh(const void* q, const void* k, const void* v,
                          void* out, long long heads, long long sq,
                          long long sk, int causal, float scale_log2,
                          cudaStream_t stream) {
  const long long q_tiles = (sq + kMmaRows - 1) / kMmaRows;
  if (heads > 0x7fffffffLL || q_tiles > 65535) return cudaErrorInvalidValue;
  constexpr int bytes = mma_smem_bytes<DQK, DV>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attn_mma_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(heads),
                  static_cast<unsigned int>(q_tiles));
  flash_attn_mma_kernel<DQK, DV><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      sq, sk, causal, scale_log2);
  return cudaGetLastError();
}

template <int N>
using Dim = std::integral_constant<int, N>;

// f(Dim<dh>, Dim<dv>) for a pair of widths the kernels are built for (dh =
// dv of 16, 32, 64 or 128, and MLA's 192 and 128), else `otherwise`
template <typename R, typename F>
R by_head_dims(int dh, int dv, R otherwise, F f) {
  if (dh == 192 && dv == 128) return f(Dim<192>(), Dim<128>());
  if (dh != dv) return otherwise;
  switch (dh) {
    case 16:
      return f(Dim<16>(), Dim<16>());
    case 32:
      return f(Dim<32>(), Dim<32>());
    case 64:
      return f(Dim<64>(), Dim<64>());
    case 128:
      return f(Dim<128>(), Dim<128>());
    default:
      return otherwise;
  }
}

}  // namespace

extern "C" {

// the fp32 kernel takes dh = dv only
int ndp_flash_attn_f32(const void* q, const void* k, const void* v,
                       void* out, long long heads, long long sq, long long sk,
                       int dh, int dv, int causal, float scale_log2,
                       void* stream) {
  if (heads < 0 || sq < 0 || sk < 1 || dh != dv) return cudaErrorInvalidValue;
  if (heads == 0 || sq == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_head_dims(
      dh, dv, cudaErrorInvalidValue, [&](auto d, auto e) -> cudaError_t {
        if constexpr (decltype(d)::value == decltype(e)::value) {
          return launch_dh<float, decltype(d)::value>(
              q, k, v, out, heads, sq, sk, causal, scale_log2, st);
        } else {
          return cudaErrorInvalidValue;
        }
      }));
}

int ndp_flash_attn_bf16(const void* q, const void* k, const void* v,
                        void* out, long long heads, long long sq,
                        long long sk, int dh, int dv, int causal,
                        float scale_log2, void* stream) {
  if (heads < 0 || sq < 0 || sk < 1) return cudaErrorInvalidValue;
  if (heads == 0 || sq == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_head_dims(
      dh, dv, cudaErrorInvalidValue, [&](auto d, auto e) {
        return launch_mma_dh<decltype(d)::value, decltype(e)::value>(
            q, k, v, out, heads, sq, sk, causal, scale_log2, st);
      }));
}

// dynamic shared memory of the bf16 kernel at widths dh, dv (0 if none)
int ndp_flash_attn_bf16_smem_bytes(int dh, int dv) {
  return by_head_dims(dh, dv, 0, [](auto d, auto e) {
    return mma_smem_bytes<decltype(d)::value, decltype(e)::value>();
  });
}

}  // extern "C"
