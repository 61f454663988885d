// RG-LRU linear recurrence forward on Hopper (sm_90a).
//
// Replaces the TPU kernel rglru_scan_pallas of
// src/repro/kernels/rglru_scan/rglru_scan.py (body _rglru_kernel): x, a and
// the input gate i (B, T, W) -> y (B, T, W) in x's dtype, from a zero state,
// with every input upcast to float32:
//   beta_t = sqrt(max(1 - a_t^2, 0))
//   h_t    = a_t * h_{t-1} + beta_t * (i_t * x_t)
//   y_t    = h_t rounded to x's dtype
// A superset of the Pallas kernel: it also writes the float32 states h
// (B, T, W), the residual the reference's _assoc_core_fwd saves, which the
// backward of kernels/rglru_scan/ops.py reads as h_{t-1}.  x, a and i are
// float32 or bfloat16 each on its own: Griffin's recurrent block hands over
// x in the param dtype and a, i in float32 (_rglru_gates).
//
// Numbers.  1 - a^2 is a rounded product and a rounded difference, as the
// reference computes it; sqrtf is IEEE (no fast-math); h_t is one
// __fmaf_rn.  The plain version runs the same recurrence as a log-depth
// scan, which associates the sum another way: the two agree to float32
// rounding of |h|.
//
// What bounds it on this card: bytes.  Per element it reads x, a and i once
// and writes y and h once, 16 bytes at Griffin's dtypes (x, y bf16; a, i, h
// float32), against 8 float32 operations (an FMA counted as two): far below
// the ~20 operations a byte the card needs before arithmetic is the limit.
// At the full-width training shape (B 2, T 2048, W 2560) that is 167.8 MB,
// 0.0501 ms at 3.35 TB/s.  The recurrence is sequential in T, and
// B * W = 5,120 lanes are only 160 warps for 132 SMs: one thread walking
// its lane alone is latency-bound (v0 below).
//
// What the design does about it:
//   * a block owns 32 consecutive channels of one row (160 blocks at the
//     full-width shape) and has 7 warps: one consumer warp, a lane a
//     channel, runs the dependent chain h = fma(a, h, u) and stores y and
//     h; six producer warps load x, a and i and compute a and
//     u = beta * (i * x) in float32 into shared memory;
//   * time goes in rounds of 96 steps, one 16-step tile a producer warp.
//     While the consumer runs round j from one shared-memory stage, the
//     producers fill round j + 1 into the other (48 KB for both), each
//     with its tile's 48 loads a thread in flight at once; one
//     __syncthreads a round hands the stages over.  So the loads, their
//     latency and the square roots leave the consumer's chain, whose step
//     is two shared-memory loads, an FMA and two stores;
//   * loads are coalesced (a warp reads 32 consecutive channels of a step);
//     steps past T read step T - 1 and channels past W read channel W - 1,
//     so the producers never branch on the edge, and the consumer stores
//     only what lies inside.
// v0 (one thread a lane walking T, register groups of 16 steps prefetched
// one group ahead) took 1.0911 ms at the full-width shape: the IEEE sqrtf's
// branch to its slow path cut every step into its own basic block, so each
// step's loads, square root and FMA ran in series on one warp an SM.
// Left for later (ROADMAP Queue 2): a time-chunked scan (chunk-local scans
// in parallel, then a carry fix-up) to put more than 160 consumer warps to
// work.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes.  The entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;      // channels a block: one a consumer lane
constexpr int kTile = 16;       // steps a producer warp prepares a round
constexpr int kProducers = 6;
constexpr int kRound = kTile * kProducers;  // 96 steps a round
constexpr int kThreads = kLanes * (kProducers + 1);

// a and u = beta * (i * x) of one round, float32, [step][channel]
struct Stage {
  float a[kRound][kLanes];
  float u[kRound][kLanes];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One producer warp: load steps t0 .. t0 + kTile - 1 of its lane's channel
// (all loads in flight before any is used), and write a and u to rows
// row0 .. row0 + kTile - 1 of the stage.
template <typename TX, typename TA, typename TI>
__device__ __forceinline__ void prepare(
    Stage& st, const TX* __restrict__ x, const TA* __restrict__ a,
    const TI* __restrict__ gi, int64_t base, int t0, int row0, int T, int W,
    int lane) {
  TX xv[kTile];
  TA av[kTile];
  TI iv[kTile];
#pragma unroll
  for (int s = 0; s < kTile; ++s) {
    const int64_t o = base + static_cast<int64_t>(min(t0 + s, T - 1)) * W;
    xv[s] = x[o];
    av[s] = a[o];
    iv[s] = gi[o];
  }
#pragma unroll
  for (int s = 0; s < kTile; ++s) {
    const float at = to_f32(av[s]);
    const float beta =
        sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(at, at)), 0.0f));
    st.a[row0 + s][lane] = at;
    st.u[row0 + s][lane] =
        __fmul_rn(beta, __fmul_rn(to_f32(iv[s]), to_f32(xv[s])));
  }
}

template <typename TX, typename TA, typename TI>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const TX* __restrict__ x, const TA* __restrict__ a,
             const TI* __restrict__ gi, TX* __restrict__ y,
             float* __restrict__ states, int T, int W) {
  __shared__ Stage stages[2];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int w = blockIdx.x * kLanes + lane;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * T * W;
  // producers read channel W - 1 for lanes past W; every thread stays for
  // the __syncthreads of every round
  const int64_t src = row + min(w, W - 1);
  const int tile = (warp - 1) * kTile;  // a producer's rows in a stage
  const int rounds = (T + kRound - 1) / kRound;
  if (warp > 0) prepare(stages[0], x, a, gi, src, tile, tile, T, W, lane);
  __syncthreads();
  float h = 0.0f;
  for (int j = 0; j < rounds; ++j) {
    if (warp > 0) {
      if (j + 1 < rounds) {
        prepare(stages[(j + 1) & 1], x, a, gi, src, (j + 1) * kRound + tile,
                tile, T, W, lane);
      }
    } else if (w < W) {
      const Stage& st = stages[j & 1];
      const int t0 = j * kRound;
      const int n = min(kRound, T - t0);
      const int64_t dst = row + static_cast<int64_t>(t0) * W + w;
#pragma unroll 16
      for (int s = 0; s < n; ++s) {
        h = __fmaf_rn(st.a[s][lane], h, st.u[s][lane]);
        const int64_t o = dst + static_cast<int64_t>(s) * W;
        store(y + o, h);
        states[o] = h;
      }
    }
    __syncthreads();
  }
}

template <typename TX, typename TA, typename TI>
cudaError_t launch(const void* x, const void* a, const void* gi, void* y,
                   float* states, int B, int T, int W, cudaStream_t stream) {
  const dim3 grid((W + kLanes - 1) / kLanes, B);
  rglru_kernel<TX, TA, TI><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TA*>(a),
      static_cast<const TI*>(gi), static_cast<TX*>(y), states, T, W);
  return cudaGetLastError();
}

template <typename TX, typename TA>
cudaError_t by_i(const void* x, const void* a, const void* gi, void* y,
                 float* states, int B, int T, int W, int i_bf16,
                 cudaStream_t stream) {
  return i_bf16 ? launch<TX, TA, __nv_bfloat16>(x, a, gi, y, states, B, T,
                                                W, stream)
                : launch<TX, TA, float>(x, a, gi, y, states, B, T, W,
                                        stream);
}

template <typename TX>
cudaError_t by_a(const void* x, const void* a, const void* gi, void* y,
                 float* states, int B, int T, int W, int a_bf16, int i_bf16,
                 cudaStream_t stream) {
  return a_bf16 ? by_i<TX, __nv_bfloat16>(x, a, gi, y, states, B, T, W,
                                          i_bf16, stream)
                : by_i<TX, float>(x, a, gi, y, states, B, T, W, i_bf16,
                                  stream);
}

}  // namespace

// x, a, gi: (B, T, W) contiguous, each float32 (flag 0) or bfloat16
// (flag 1); y: (B, T, W) of x's dtype; states: (B, T, W) float32.
extern "C" int rglru_scan_fwd(const void* x, const void* a, const void* gi,
                              void* y, float* states, int B, int T, int W,
                              int x_bf16, int a_bf16, int i_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? by_a<__nv_bfloat16>(x, a, gi, y, states, B, T, W, a_bf16,
                                   i_bf16, s)
             : by_a<float>(x, a, gi, y, states, B, T, W, a_bf16, i_bf16, s);
  return static_cast<int>(err);
}
