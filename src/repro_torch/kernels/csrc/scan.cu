// Mamba2's selective scan over a whole sequence, written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this recurrence as
// jax.lax.scan (src/repro/models/ssm.py:87, in mamba_apply), which the port
// ran as a Python loop of eight launches a time step (38,760 steps, about
// 310,000 launches, for one zamba2-1.2b prefill of 32 x 1020 tokens).  One
// launch here computes every step of one call.  For each batch row b,
// channel c and step t, in fp32 as the reference:
//
//   decay  = exp(dt[b,t,c] * a[c])
//   h[n]   = h[n] * decay + (dt[b,t,c] * u[b,t,c]) * B[b,t,n]   (n < N)
//   y[b,t,c] = sum_n h[n] * C[b,t,n]
//
// from h0 [B, di, N]; y [B, S, di] and the last h [B, di, N] are written.
// h may be h0 itself (a decode step's state updated in place): a thread
// reads its channel's N states of h0 before its first step and writes the
// same N words of h after its last, and no other thread touches them, so
// neither pointer is __restrict__.
// The decay is expf (not __expf); h takes one fma a state and step
// (h * decay exact, plus the rounded (dt u) B), and y sums over n in four
// interleaved partial sums: the two differences from the reference's
// order of roundings (the CUDA tests state the tolerance they give).
//
// Design.  A thread owns one (batch row, channel) and that channel's N
// states, in registers, for the whole sequence; a block holds 128
// channels of one batch row (grid: di / 128 x B; a ragged di is masked).
// Tiles of 8 steps pass through shared memory, double-buffered with 4-byte
// cp.async: each thread copies its channel's dt and u (coalesced across
// the block's channels) and the block copies the row's B and C of those
// steps, which every thread then reads as 16-byte broadcasts.  A step is N
// independent fma chains into h and N fmas into y's partial sums, and y is
// stored coalesced.  B and C may carry any batch and step stride (a view
// of the fused [B, S, 2N] projection is read in place); their last stride
// is 1.
//
// Bound on an H100 at zamba2's serving shape ([32, 1020, 4096], N 64): dt
// and u in, y out, B and C in, h in and out once, about 1.69 GB a call,
// 0.50 ms at 3.35 TB/s; and 32 x 1020 x 4096 x 64 x 4 = 34.2 GFLOP of fp32
// (the h update and the y sum), 0.51 ms at 67 TFLOP/s.
//
// Plain C ABI, bound from Python with ctypes.  The launch is on the
// caller's stream, allocates nothing, does not synchronise, and returns the
// first CUDA error of its set-up or launch.  h0 and h need 16-byte
// alignment (the wrapper copies a misaligned h0).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kSteps = 8;      // time steps a tile

template <int N>
struct Tile {
  float dt[kSteps][kThreads];
  float u[kSteps][kThreads];
  float b[kSteps][N];
  float c[kSteps][N];
};

// 4-byte copy from global to shared memory; with ok false the source is
// not read and the word is zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ dt,
                          const float* __restrict__ u,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ a,
                          const float* h0, float* __restrict__ y,
                          float* h_out,
                          long long steps, long long di, long long b_bs,
                          long long b_ts, long long c_bs, long long c_ts) {
  static_assert(N % 4 == 0, "N is read as float4");
  __shared__ __align__(16) Tile<N> tile[2];
  const int tid = threadIdx.x;
  const long long row = blockIdx.y;
  const long long ch = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const bool live = ch < di;
  const long long x0 = row * steps * di + ch;  // dt, u, y at step 0
  const float* brow = bm + row * b_bs;
  const float* crow = cm + row * c_bs;

  auto load = [&](int buf, long long t0) {
    Tile<N>& s = tile[buf];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      const bool ok = live && t0 + t < steps;
      const long long off = ok ? x0 + (t0 + t) * di : 0;
      cp_async4(&s.dt[t][tid], dt + off, ok);
      cp_async4(&s.u[t][tid], u + off, ok);
    }
    for (int e = tid; e < kSteps * N; e += kThreads) {
      const int t = e / N, n = e % N;
      const bool ok = t0 + t < steps;
      cp_async4(&s.b[t][n], ok ? brow + (t0 + t) * b_ts + n : bm, ok);
      cp_async4(&s.c[t][n], ok ? crow + (t0 + t) * c_ts + n : cm, ok);
    }
    cp_async_commit();
  };

  float h[N];
  const float av = live ? a[ch] : 0.f;
  if (live) {
    const float4* src =
        reinterpret_cast<const float4*>(h0 + (row * di + ch) * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = src[q];
      h[4 * q] = v.x;
      h[4 * q + 1] = v.y;
      h[4 * q + 2] = v.z;
      h[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = 0.f;
  }

  const long long tiles = (steps + kSteps - 1) / kSteps;
  load(0, 0);
  for (long long k = 0; k < tiles; ++k) {
    const int buf = static_cast<int>(k & 1);
    if (k + 1 < tiles) {
      load(buf ^ 1, (k + 1) * kSteps);
    } else {
      cp_async_commit();  // an empty group: wait_group 1 waits for tile k
    }
    cp_async_wait_one();
    __syncthreads();
    const Tile<N>& s = tile[buf];
    const long long t0 = k * kSteps;
    const int n_t = static_cast<int>(steps - t0 < kSteps ? steps - t0
                                                         : kSteps);
    for (int t = 0; t < n_t; ++t) {
      const float d = s.dt[t][tid];
      const float decay = expf(d * av);
      const float du = d * s.u[t][tid];
      const float4* bq = reinterpret_cast<const float4*>(s.b[t]);
      const float4* cq = reinterpret_cast<const float4*>(s.c[t]);
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 bb = bq[q];
        const float4 cc = cq[q];
        h[4 * q] = fmaf(h[4 * q], decay, du * bb.x);
        h[4 * q + 1] = fmaf(h[4 * q + 1], decay, du * bb.y);
        h[4 * q + 2] = fmaf(h[4 * q + 2], decay, du * bb.z);
        h[4 * q + 3] = fmaf(h[4 * q + 3], decay, du * bb.w);
        acc0 = fmaf(h[4 * q], cc.x, acc0);
        acc1 = fmaf(h[4 * q + 1], cc.y, acc1);
        acc2 = fmaf(h[4 * q + 2], cc.z, acc2);
        acc3 = fmaf(h[4 * q + 3], cc.w, acc3);
      }
      if (live) y[x0 + (t0 + t) * di] = (acc0 + acc1) + (acc2 + acc3);
    }
    __syncthreads();  // tile[buf] is refilled by the next iteration's load
  }
  if (live) {
    float4* dst = reinterpret_cast<float4*>(h_out + (row * di + ch) * N);
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      dst[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                           h[4 * q + 3]);
    }
  }
}

template <int N>
cudaError_t launch(const float* dt, const float* u, const float* bm,
                   const float* cm, const float* a, const float* h0,
                   float* y, float* h, long long batch, long long steps,
                   long long di, long long b_bs, long long b_ts,
                   long long c_bs, long long c_ts, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((di + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  selective_scan_kernel<N><<<grid, kThreads, 0, stream>>>(
      dt, u, bm, cm, a, h0, y, h, steps, di, b_bs, b_ts, c_bs, c_ts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dt, u [batch, steps, di] and y contiguous; B, C [batch, steps, n] with
// strides (b_bs, b_ts, 1) and (c_bs, c_ts, 1) in elements; a [di]; h0 and
// h [batch, di, n] contiguous, h possibly h0.  n is 16, 32 or 64.
int ndp_selective_scan_f32(const void* dt, const void* u, const void* bm,
                           const void* cm, const void* a, const void* h0,
                           void* y, void* h, long long batch,
                           long long steps, long long di, int n,
                           long long b_bs, long long b_ts, long long c_bs,
                           long long c_ts, void* stream) {
  if (batch < 1 || batch > 65535 || steps < 1 || di < 1 ||
      (di + kThreads - 1) / kThreads > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n) {
    case 16:
      err = launch<16>(f(dt), f(u), f(bm), f(cm), f(a), f(h0),
                       static_cast<float*>(y), static_cast<float*>(h), batch,
                       steps, di, b_bs, b_ts, c_bs, c_ts, st);
      break;
    case 32:
      err = launch<32>(f(dt), f(u), f(bm), f(cm), f(a), f(h0),
                       static_cast<float*>(y), static_cast<float*>(h), batch,
                       steps, di, b_bs, b_ts, c_bs, c_ts, st);
      break;
    case 64:
      err = launch<64>(f(dt), f(u), f(bm), f(cm), f(a), f(h0),
                       static_cast<float*>(y), static_cast<float*>(h), batch,
                       steps, di, b_bs, b_ts, c_bs, c_ts, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
