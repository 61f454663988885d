// V-trace targets on Hopper (sm_90a): vs and the policy-gradient advantages
// of a (B, T) trajectory batch in one launch.
//
// Replaces the TPU kernel vtrace_pallas of
// src/repro/kernels/vtrace/vtrace.py (body _vtrace_kernel), which keeps a
// (block_b, T) slab of rows in VMEM and runs the reverse recursion over T
// with the rows across the vector lanes.
//
// What bounds it on this card: bytes.  The function reads four (B, T) f32
// inputs and the (B,) bootstrap once and writes two (B, T) outputs,
// 4 * (6 * B * T + B) bytes, against 16 operations per element (an exp, two
// mins, 13 multiplies and adds): under one a byte, far below the ~20 f32
// operations a byte an H100 needs before arithmetic is the limit.  The least
// time is those bytes over 3.35 TB/s.  At the learner's shape (B = 32,
// T = 20) that is a few nanoseconds, so what a launch costs there is its
// latency: the launch itself and one round trip to device memory.
//
// What the design does about it:
//   * one warp a block, one lane a row (kRows = 32 rows a block, rows past B
//     masked), so a large batch spreads over many SMs (B = 4096: 128
//     blocks); the TPU pads B up to its block for the block specs only, and
//     this kernel needs no padding;
//   * the TPU's VMEM block becomes (kRows, kTile) slabs of the four inputs in
//     shared memory.  The block walks T from the end in tiles of kTile steps
//     and copies each tile in with cp.async: lane l copies step l of each
//     row, so a warp's copy reads one row's 128 contiguous bytes, and every
//     copy of a tile is in flight at once without holding registers.  The
//     next tile's copies are issued before the current tile is computed
//     (two slab buffers), so their latency hides behind the recursion;
//   * each lane runs its row's reverse recursion over the tile, carrying
//     acc = vs_{t+1} - V_{t+1}, V_{t+1} and vs_{t+1} (the bootstrap at
//     t = T-1) in registers, so each step yields delta_t, vs_t and adv_t and
//     both outputs come out of one pass.  vs_t and adv_t overwrite the slab
//     slots of V_t and r_t, which the step has read, and the block stores
//     both slabs back row by row, 128 contiguous bytes a warp store;
//   * slab rows are kTile + 1 floats apart, so 32 lanes reading step t of
//     their 32 rows hit 32 different banks;
//   * no fast-math: expf and fminf as the plain version computes them, in
//     the same order of operations.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes.  The entry point returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;           // rows a block: one per lane
constexpr int kTile = 32;           // time steps a slab
constexpr int kStride = kTile + 1;  // padded slab row: no bank conflicts
constexpr int kSlab = kRows * kStride;

struct Slabs {
  float logr[kSlab], disc[kSlab], rew[kSlab], val[kSlab];
};

// Issue the cp.async copies of the tile [t_lo, t_lo + width) of rows
// b0 .. b0 + rows - 1 into ``s`` and commit them as one group.
__device__ __forceinline__ void load_tile(
    Slabs& s, const float* __restrict__ log_rhos,
    const float* __restrict__ discounts, const float* __restrict__ rewards,
    const float* __restrict__ values, int b0, int rows, int T, int t_lo,
    int width, int lane) {
  if (lane < width) {
    for (int row = 0; row < rows; ++row) {
      const int64_t g = static_cast<int64_t>(b0 + row) * T + t_lo + lane;
      const int o = row * kStride + lane;
      __pipeline_memcpy_async(&s.logr[o], log_rhos + g, sizeof(float));
      __pipeline_memcpy_async(&s.disc[o], discounts + g, sizeof(float));
      __pipeline_memcpy_async(&s.rew[o], rewards + g, sizeof(float));
      __pipeline_memcpy_async(&s.val[o], values + g, sizeof(float));
    }
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kRows)
vtrace_kernel(const float* __restrict__ log_rhos,
              const float* __restrict__ discounts,
              const float* __restrict__ rewards,
              const float* __restrict__ values,
              const float* __restrict__ bootstrap,
              float* __restrict__ vs, float* __restrict__ adv, int B, int T,
              float clip_rho, float clip_c, float lambda) {
  __shared__ Slabs slabs[2];
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);
  const int tiles = (T + kTile - 1) / kTile;
  // tile k covers [t_lo(k), t_hi(k)), counted from the end of the row
  auto t_lo = [&](int k) { return max(T - (k + 1) * kTile, 0); };
  auto width = [&](int k) { return T - k * kTile - t_lo(k); };

  load_tile(slabs[0], log_rhos, discounts, rewards, values, b0, rows, T,
            t_lo(0), width(0), lane);
  const float boot = lane < rows ? bootstrap[b0 + lane] : 0.0f;
  float acc = 0.0f;       // vs_{t+1} - V_{t+1}
  float v_next = boot;    // V_{t+1}
  float vs_next = boot;   // vs_{t+1}
  for (int k = 0; k < tiles; ++k) {
    if (k + 1 < tiles) {
      load_tile(slabs[(k + 1) & 1], log_rhos, discounts, rewards, values,
                b0, rows, T, t_lo(k + 1), width(k + 1), lane);
      __pipeline_wait_prior(1);  // tile k has landed, k + 1 may be in flight
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    Slabs& s = slabs[k & 1];
    const int w = width(k);
    if (lane < rows) {
      for (int c = w - 1; c >= 0; --c) {
        const int o = lane * kStride + c;
        const float rho = expf(s.logr[o]);
        const float clipped = fminf(clip_rho, rho);
        const float cc = lambda * fminf(clip_c, rho);
        const float d = s.disc[o];
        const float rw = s.rew[o];
        const float v = s.val[o];
        const float delta = clipped * (rw + d * v_next - v);
        acc = delta + d * cc * acc;
        const float vs_t = v + acc;
        s.val[o] = vs_t;
        s.rew[o] = clipped * (rw + d * vs_next - v);
        v_next = v;
        vs_next = vs_t;
      }
    }
    __syncthreads();
    if (lane < w) {
      const int lo = t_lo(k);
      for (int row = 0; row < rows; ++row) {
        const int64_t g = static_cast<int64_t>(b0 + row) * T + lo + lane;
        const int o = row * kStride + lane;
        vs[g] = s.val[o];
        adv[g] = s.rew[o];
      }
    }
    __syncthreads();  // tile k + 2's copies overwrite these slabs
  }
}

}  // namespace

extern "C" int vtrace_f32(const float* log_rhos, const float* discounts,
                          const float* rewards, const float* values,
                          const float* bootstrap, float* vs, float* adv,
                          int B, int T, float clip_rho, float clip_c,
                          float lambda, void* stream) {
  const int blocks = (B + kRows - 1) / kRows;
  vtrace_kernel<<<blocks, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
      log_rhos, discounts, rewards, values, bootstrap, vs, adv, B, T,
      clip_rho, clip_c, lambda);
  return static_cast<int>(cudaGetLastError());
}
