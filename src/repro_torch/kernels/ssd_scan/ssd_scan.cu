// Mamba-2 SSD chunk scan forward on Hopper (sm_90a).
//
// Replaces the TPU kernel ssd_scan_pallas of
// src/repro/kernels/ssd_scan/ssd_scan.py (body _ssd_kernel): x (B, T, H, P),
// dt (B, T, H), A (H,), B and C (B, T, N) shared by the heads -> y (B, T, H, P)
// in x's dtype and the final state (B, H, P, N) float32, from a zero state,
// over chunks of Q steps (T % Q == 0).  Per chunk, with every input upcast to
// float32:
//   cum_t  = sum_{tau <= t} dt_tau * A                      (inclusive)
//   y_t    = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//          + exp(cum_t) C_t . S_prev
//   S      = exp(cum_{Q-1}) S_prev + sum_s exp(cum_{Q-1} - cum_s) dt_s x_s (x) B_s
//
// A superset of the Pallas kernel: it also writes S_prevs (nc, B, H, P, N)
// float32, the state entering each chunk, which the backward of
// kernels/ssd_scan/ops.py re-runs each chunk from; and it reads x, B and C in
// place through their batch and time strides (the model hands it views of
// the convolution's output), where the Pallas wrapper transposes x to
// (B, H, T, P) first.
//
// Numbers.  Every product is float32 FMA on the CUDA cores, as the Pallas
// kernel computes in float32: nothing is rounded to bf16 or TF32.  The
// decay of a pair is masked before the exponential (s > t, or a padded row,
// takes exp(-inf) = 0), so no exp of a positive delta is ever formed.  cum is
// summed in double and rounded once to float32, the nearest float32 to the
// exact prefix sum of the float32 products dt * A (the CPU's torch.cumsum
// also sums float32 in double).
//
// What bounds it on this card: operations.  At the full-width training
// shape (B 2, T 2048, H 64, P 64, N 128, Q 256; x, B, C in bf16, dt in f32)
// the function needs Q (Q + 1) N flops for the scores C B^T of the causal
// pairs once per (b, chunk), as B and C are shared by the heads, and per
// (b, h, chunk) Q (Q + 1) P for their decayed product with dt x and
// 4 Q P N for the read-out and the state update: 13.0 GFLOP in all, against
// ~74 MB of the Pallas contract's inputs and outputs (~108 MB with
// S_prevs).  The arithmetic is float32 by contract, so the least time is
// those flops over the 67 TFLOP/s float32 rate: ~0.195 ms, against ~0.02 ms
// for the bytes.  This kernel does 21.5 GFLOP: each of a row's 64 head
// blocks forms the scores again, ~40% of its work.
//
// What the design does about it (a first, simple version):
//   * one block of 256 threads per (head, batch row): 128 blocks at the
//     full-width shape on 132 SMs.  The chunk loop runs inside the block,
//     in order, which takes the place of the TPU's sequential chunk grid
//     axis; the (P, N) float32 state (32 KB) stays in shared memory for the
//     whole row;
//   * a (Q, Q) float32 score tile does not fit (256 KB at Q 256), so each
//     chunk walks 64-row query tiles and, for each, the 64-row key tiles at
//     or before it: the scores C B^T of the tile pair, masked and decayed,
//     go through shared memory into the product with dt x;
//   * every product is register-tiled: thread (ty, tx) of a 16 x 16 grid
//     owns 4 query rows (4 ty ..) and P / 16 columns, and the operands sit
//     in shared memory transposed (C, B and the state with N as the row),
//     so one step of a product is two 16-byte loads and 16 FMAs;
//   * the inter-chunk read-out starts each query tile's accumulators, and
//     the state update is a (N, P) register tile over the chunk's keys
//     after every y of the chunk is written.
// Left for later: forming the scores once per (row, chunk) for all heads,
// wgmma (with an error-free split of float32 into bf16 or TF32 parts),
// TMA-fed double-buffered tiles, and splitting a row's chunks over several
// blocks (a state pass, then the chunks in parallel).
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

constexpr int kThreads = 256;
constexpr int kTile = 64;           // rows of a query tile and of a key tile
constexpr int kLdt = kTile + 4;     // row stride of the transposed tiles
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;
constexpr int kMaxM = kMaxN / 16;   // state rows a thread owns

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// kJ consecutive floats from 4 * kJ-byte aligned shared memory.
template <int kJ>
__device__ __forceinline__ void load_vec(float (&v)[kJ], const float* p) {
  if constexpr (kJ == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (kJ == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = *p;
  }
}

// dst[n * kLdt + r] = src[r * ld + n] for r < rows, 0 up to kTile rows.
template <typename T>
__device__ __forceinline__ void load_t(float* dst, const T* __restrict__ src,
                                       int64_t ld, int rows, int N) {
  for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
    const int r = i / N, n = i - r * N;
    dst[n * kLdt + r] = r < rows ? to_f32(src[r * ld + n]) : 0.0f;
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y,
                float* __restrict__ s_final, float* __restrict__ s_prevs,
                int batch, int seq, int heads, int N, int Q, int64_t sxb,
                int64_t sxt, int64_t sbb, int64_t sbt, int64_t scb,
                int64_t sct) {
  constexpr int kJ = P / 16;     // columns p = kJ * tx + j a thread owns
  constexpr int kLdp = P + 4;    // row stride of the transposed state
  extern __shared__ __align__(16) float smem[];
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  float* st = smem;                // (N, kLdp)  state S[p][n] at st[n][p]
  float* cs = st + N * kLdp;       // (N, kLdt)  C of the query tile
  float* bs = cs + N * kLdt;       // (N, kLdt)  B of the key tile
  float* us = bs + N * kLdt;       // (kTile, P) dt x of the key tile
  float* gs = us + kTile * P;      // (kTile, kLdt) G[t][s] at gs[s][t]
  float* cum = gs + kTile * kLdt;  // (Qp)
  float* dts = cum + Qp;           // (Qp)
  float* tails = dts + Qp;         // (Qp) exp(cum_{Q-1} - cum_s)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kM = N >= 16 ? N / 16 : 1;  // state rows n = ty + 16 m
  const float a = A[h];
  const int nc = seq / Q;
  const int PN = P * N;
  const int64_t sy = static_cast<int64_t>(heads) * P;
  const T* xb = x + b * sxb + h * P;
  const float* dtb = dt + static_cast<int64_t>(b) * seq * heads + h;
  const T* bb = bm + b * sbb;
  const T* cb = cm + b * scb;
  T* yb = y + static_cast<int64_t>(b) * seq * sy + h * P;

  for (int i = tid; i < N * kLdp; i += kThreads) st[i] = 0.0f;

  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    __syncthreads();  // the previous chunk's state update is done
    float* sp = s_prevs + ((static_cast<int64_t>(c) * batch + b) * heads + h) * PN;
    for (int i = tid; i < PN; i += kThreads) {
      const int p = i / N, n = i - p * N;
      sp[i] = st[n * kLdp + p];
    }
    for (int i = tid; i < Qp; i += kThreads) {
      dts[i] = i < Q ? dtb[static_cast<int64_t>(c0 + i) * heads] : 0.0f;
    }
    __syncthreads();
    if (tid < 32) {  // cum: each lane sums a segment, then a warp scan
      const int per = (Q + 31) / 32;
      const int lo = min(tid * per, Q), hi = min(lo + per, Q);
      double run = 0.0;
      for (int i = lo; i < hi; ++i) run += static_cast<double>(dts[i] * a);
      double incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      double acc = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) acc = 0.0;
      for (int i = lo; i < hi; ++i) {
        acc += static_cast<double>(dts[i] * a);
        cum[i] = static_cast<float>(acc);
      }
      for (int i = Q + tid; i < Qp; i += 32) cum[i] = 0.0f;
    }
    __syncthreads();
    const float last = cum[Q - 1];
    for (int i = tid; i < Qp; i += kThreads) {
      tails[i] = i < Q ? expf(last - cum[i]) : 0.0f;
    }

    // ---- y, one 64-row query tile at a time
    for (int t0 = 0; t0 < Q; t0 += kTile) {
      __syncthreads();  // earlier reads of cs are done
      load_t(cs, cb + static_cast<int64_t>(c0 + t0) * sct, sct,
             min(kTile, Q - t0), N);
      __syncthreads();
      // inter-chunk read-out: exp(cum_t) C_t . S_prev
      float acc[4][kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(cs + n * kLdt + 4 * ty);
        float sv[kJ];
        load_vec<kJ>(sv, st + n * kLdp + kJ * tx);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kJ; ++j) acc[i][j] = fmaf(cr[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(cum[t0 + 4 * ty + i]);
#pragma unroll
        for (int j = 0; j < kJ; ++j) acc[i][j] *= e;
      }
      // intra-chunk: the key tiles at or before this query tile
      for (int s0 = 0; s0 <= t0; s0 += kTile) {
        const int rows = min(kTile, Q - s0);
        __syncthreads();  // earlier reads of bs, us and gs are done
        load_t(bs, bb + static_cast<int64_t>(c0 + s0) * sbt, sbt, rows, N);
        for (int i = tid; i < kTile * P; i += kThreads) {
          const int r = i / P, p = i - r * P;
          us[i] = r < rows
                      ? to_f32(xb[static_cast<int64_t>(c0 + s0 + r) * sxt + p]) *
                            dts[s0 + r]
                      : 0.0f;
        }
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(cs + n * kLdt + 4 * ty);
          const float4 bv = *reinterpret_cast<const float4*>(bs + n * kLdt + 4 * tx);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cr[i], br[j], g[i][j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + 4 * tx + j;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = t0 + 4 * ty + i;
            // masked before the exponential: exp(-inf) = 0
            const float d = (s <= t && t < Q) ? cum[t] - cum[s] : -INFINITY;
            g[i][j] *= expf(d);
          }
          *reinterpret_cast<float4*>(gs + (4 * tx + j) * kLdt + 4 * ty) =
              make_float4(g[0][j], g[1][j], g[2][j], g[3][j]);
        }
        __syncthreads();
#pragma unroll 4
        for (int s = 0; s < rows; ++s) {
          const float4 gv = *reinterpret_cast<const float4*>(gs + s * kLdt + 4 * ty);
          float u[kJ];
          load_vec<kJ>(u, us + s * P + kJ * tx);
          const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < kJ; ++j) acc[i][j] = fmaf(gr[i], u[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + 4 * ty + i;
        if (t < Q) {
          T* dst = yb + static_cast<int64_t>(c0 + t) * sy + kJ * tx;
#pragma unroll
          for (int j = 0; j < kJ; ++j) store(dst + j, acc[i][j]);
        }
      }
    }

    // ---- state update: S = exp(cum_{Q-1}) S + sum_s tail_s dt_s x_s (x) B_s
    __syncthreads();  // every read of st and cs for this chunk is done
    const float dec = expf(last);
    float sa[kMaxM][kJ];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      const int n = ty + 16 * m;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        sa[m][j] = (m < kM && n < N) ? st[n * kLdp + kJ * tx + j] * dec : 0.0f;
      }
    }
    for (int s0 = 0; s0 < Q; s0 += kTile) {
      const int rows = min(kTile, Q - s0);
      __syncthreads();  // earlier reads of bs and us are done
      load_t(bs, bb + static_cast<int64_t>(c0 + s0) * sbt, sbt, rows, N);
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int r = i / P, p = i - r * P;
        us[i] = r < rows
                    ? to_f32(xb[static_cast<int64_t>(c0 + s0 + r) * sxt + p]) *
                          dts[s0 + r] * tails[s0 + r]
                    : 0.0f;
      }
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        float u[kJ];
        load_vec<kJ>(u, us + r * P + kJ * tx);
#pragma unroll
        for (int m = 0; m < kMaxM; ++m) {
          if (m < kM && ty + 16 * m < N) {
            const float bv = bs[(ty + 16 * m) * kLdt + r];
#pragma unroll
            for (int j = 0; j < kJ; ++j) sa[m][j] = fmaf(u[j], bv, sa[m][j]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      const int n = ty + 16 * m;
      if (m < kM && n < N) {
#pragma unroll
        for (int j = 0; j < kJ; ++j) st[n * kLdp + kJ * tx + j] = sa[m][j];
      }
    }
  }
  __syncthreads();
  float* sf = s_final + (static_cast<int64_t>(b) * heads + h) * PN;
  for (int i = tid; i < PN; i += kThreads) {
    const int p = i / N, n = i - p * N;
    sf[i] = st[n * kLdp + p];
  }
}

size_t smem_bytes(int P, int N, int Q) {
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  return sizeof(float) * (static_cast<size_t>(N) * (P + 4) + 2 * N * kLdt +
                          kTile * P + kTile * kLdt + 3 * Qp);
}

template <typename T, int P>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* bm, const void* cm, void* y, float* s_final,
                   float* s_prevs, int batch, int seq, int heads, int N, int Q,
                   int64_t sxb, int64_t sxt, int64_t sbb, int64_t sbt,
                   int64_t scb, int64_t sct, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, Q);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(heads, batch);
  ssd_scan_kernel<T, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), s_final, s_prevs, batch,
      seq, heads, N, Q, sxb, sxt, sbb, sbt, scb, sct);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int P, const void* x, const float* dt, const float* A,
                     const void* bm, const void* cm, void* y, float* s_final,
                     float* s_prevs, int batch, int seq, int heads, int N,
                     int Q, int64_t sxb, int64_t sxt, int64_t sbb, int64_t sbt,
                     int64_t scb, int64_t sct, cudaStream_t stream) {
  switch (P) {
    case 16:
      return launch<T, 16>(x, dt, A, bm, cm, y, s_final, s_prevs, batch, seq,
                           heads, N, Q, sxb, sxt, sbb, sbt, scb, sct, stream);
    case 32:
      return launch<T, 32>(x, dt, A, bm, cm, y, s_final, s_prevs, batch, seq,
                           heads, N, Q, sxb, sxt, sbb, sbt, scb, sct, stream);
    case 64:
      return launch<T, 64>(x, dt, A, bm, cm, y, s_final, s_prevs, batch, seq,
                           heads, N, Q, sxb, sxt, sbb, sbt, scb, sct, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C and y); dt, A and the states are
// float32.  x is read at x[b * sxb + t * sxt + h * P + p], B and C at
// [b * sb + t * st + n]; dt (B, T, H) and y (B, T, H, P) are contiguous.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* bm, const void* cm, void* y,
                            float* s_final, float* s_prevs, int batch, int seq,
                            int heads, int P, int N, int Q, int64_t sxb,
                            int64_t sxt, int64_t sbb, int64_t sbt, int64_t scb,
                            int64_t sct, int dtype, void* stream) {
  if (N < 1 || N > kMaxN || (N & (N - 1)) || Q < 1 || Q > kMaxQ ||
      seq % Q) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(P, x, dt, A, bm, cm, y, s_final, s_prevs, batch, seq,
                          heads, N, Q, sxb, sxt, sbb, sbt, scb, sct, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(P, x, dt, A, bm, cm, y, s_final, s_prevs,
                                  batch, seq, heads, N, Q, sxb, sxt, sbb, sbt,
                                  scb, sct, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
