// Mamba-2 SSD chunk scan forward on Hopper (sm_90a), chunk-parallel.
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
// Four kernels, launched in order on one stream by ssd_scan_fwd:
//   1. ssd_gram_kernel   the head-free scores G = C B^T of each (row, chunk),
//                        once for all heads, into a (B, nc, Qp, Qp) float32
//                        scratch stored key-major (gram[s][t]); only the
//                        128 x 32 tiles that a query tile reads are formed;
//   2. ssd_state_kernel  one block per (chunk, head, row): cum (into a
//                        (B, H, nc, Q) scratch) and the chunk's own state
//                        S_c = sum_s exp(cum_{Q-1} - cum_s) dt_s x_s (x) B_s
//                        from a zero state, written into S_prevs[c];
//   3. ssd_pass_kernel   the state pass over the chunks, in place in S_prevs:
//                        read S_c[c], write S_prev[c], carry
//                        exp(cum_{Q-1}[c]) S_prev[c] + S_c[c]; the last carry
//                        is S_final;
//   4. ssd_out_kernel    one block per (128-row query tile, chunk, head, row),
//                        the longest tiles first: the read-out
//                        exp(cum_t) C_t . S_prev[c] (skipped in the first
//                        chunk, where S_prev is 0), then the decayed scores
//                        times x over the keys up to the tile's last row.
//
// Numbers.
//   * Every product is float32 FMA on the CUDA cores: no tensor cores, and
//     nothing is rounded to bf16 or TF32.  (Tensor cores would be allowed
//     for G = C B^T in bf16, whose operands are exact in bf16; G is ~1.5% of
//     the flops, so it is FMA here too.)
//   * The decay of a pair is masked before the exponential (s > t, or a
//     padded row, takes exp(-inf) = 0), so no exp of a positive delta is
//     ever formed.  Every exponential is the accurate expf.
//   * cum is summed in double and rounded once to float32, the nearest
//     float32 to the exact prefix sum of the float32 products dt * A (the
//     CPU's torch.cumsum also sums float32 in double).
//   * The first chunk's S_prevs is exactly 0 (the pass writes its zero
//     carry); y is rounded to its dtype once, from the float32 sum.
//   * The terms are rounded as the plain version rounds them, (G_ts
//     exp(d)) (x_s dt_s) and ((x_s dt_s) exp(cum_{Q-1} - cum_s)) B_s; only
//     the sums run in another order.  So a bf16 y rounds to the plain
//     version's value but for a few elements a call that sit within the
//     sums' float32 difference of a rounding midpoint (~25 of 16.8 M at
//     the training shape, as with the one-block-per-(head, row) kernel
//     this source replaced; folding dt_s into the decayed score and taking
//     __expf made that ~720).
//
// What bounds it on this card: operations.  At the full-width training
// shape (B 2, T 2048, H 64, P 64, N 128, Q 256; x, B, C in bf16, dt in f32)
// the function needs Q (Q + 1) N flops for the scores C B^T of the causal
// pairs once per (b, chunk), and per (b, h, chunk) Q (Q + 1) P for their
// decayed product with dt x and 4 Q P N for the read-out and the state
// update: 13.04 GFLOP in all, against ~74 MB of the Pallas contract's
// inputs and outputs (~108 MB with S_prevs).  The arithmetic is float32 by
// contract, so the least time is those flops over the 67 TFLOP/s float32
// rate: ~0.195 ms, against ~0.02 ms for the bytes.  This design does 13.62
// GFLOP: the scores 0.20 (whole 128 x 32 tiles), the chunk states 4.29, the
// read-outs 3.76 (none in the first chunk) and the intra-chunk products
// 5.37 (whole 16-key tiles: of a diagonal tile's masked pairs only the
// upper 64-row half is skipped).  The state pass moves ~70 MB and no flops
// to speak of.
//
// What the design does about it:
//   * every (chunk, head, row) is its own block in the state and output
//     stages (1,024 and 2,048 blocks of 128 threads at the training shape,
//     three to an SM): the chunks run in parallel, and only the elementwise
//     pass walks them in order;
//   * the scores are formed once per (row, chunk) and read by the 64 heads'
//     blocks from L2 (4 MB at the training shape);
//   * one FMA core for every product: a 128-wide operand (query rows, or
//     the state's N) times a P-wide one (the head's P, or 32 keys of a gram
//     tile) over 16-step tiles, each thread an 8 x (P / 8) register tile fed
//     by two float4 loads of each operand a step (64 FMAs for 4 shared loads
//     at P 64);
//   * operand tiles stream through a 3-stage cp.async ring of raw tiles in
//     shared memory: each thread converts the chunks it copied (to float32,
//     transposed where the product needs it, scaled by dt and the decays)
//     into a double-buffered float32 operand tile, so one barrier a tile
//     suffices and tiles k + 1 and k + 2 are in flight during tile k's
//     FMAs.  (Tiles staged through registers instead kept their loads from
//     overlapping the FMAs: 0.94 ms against 0.55 at the training shape.)
//     Where x, B or C are not 16-byte aligned, or N is not a whole number
//     of 16-byte chunks, the same ring is filled element by element.
// At the training shape the output stage takes ~66% of the time and the
// state stage ~25%; its 1,024 blocks fill 2.6 waves of the card's 396
// slots.  Left for later: splitting float32 operands into bf16 parts for
// the tensor cores (read-out, state update, intra-chunk product), and a
// launch that overlaps the four stages' edges.
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

constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kK = 16;          // reduction steps of a tile
constexpr int kStages = 3;      // raw tiles in the cp.async ring
constexpr int kWA = 128;        // width of the A operand (rows of the output)
constexpr int kLdA = kWA + 4;   // row stride of an A tile in shared memory
constexpr int kGramCols = 32;   // keys of a gram tile
constexpr int kRawA = 8192;     // bytes of a raw A tile: (kK, 128) float32
constexpr int kRawB = 4096;     // bytes of a raw B tile: (kK, <= 64) float32
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero() { return T(0.0f); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kJ consecutive floats from 4 * kJ-byte aligned shared memory.
template <int kJ>
__device__ __forceinline__ void load_vec(float* v, const float* p) {
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

// The output rows and columns thread (tg, pg) owns: A rows 4 tg .. 4 tg + 3
// and 64 + 4 tg .., B columns kH pg .. and kWB / 2 + kH pg .. (kH = kWB / 16).
__device__ __forceinline__ int row_of(int i, int tg) {
  return 4 * tg + (i & 3) + 64 * (i >> 2);
}
template <int kWB>
__device__ __forceinline__ int col_of(int j, int pg) {
  constexpr int kH = kWB / 16;
  return j < kH ? kH * pg + j : kWB / 2 + kH * pg + j - kH;
}

// acc[i][j] += sum_{k < kK} as[k][row_of(i)] * bs[k][col_of(j)]: as is
// (kK, kLdA), bs (kK, kWB + 4), both float32 in shared memory.  A step is
// 8 x kWB / 8 FMAs for four shared loads.  kLower: rows 64 .. 127 only.
template <int kWB, bool kLower = false>
__device__ __forceinline__ void fma_tile(float (&acc)[8][kWB / 8],
                                         const float* __restrict__ as,
                                         const float* __restrict__ bs, int tg,
                                         int pg) {
  constexpr int kH = kWB / 16, kLdB = kWB + 4, kI = kLower ? 4 : 0;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    float a[8], b[2 * kH];
    if (!kLower) load_vec<4>(a, as + k * kLdA + 4 * tg);
    load_vec<4>(a + 4, as + k * kLdA + 64 + 4 * tg);
    load_vec<kH>(b, bs + k * kLdB + kH * pg);
    load_vec<kH>(b + kH, bs + k * kLdB + kWB / 2 + kH * pg);
#pragma unroll
    for (int i = kI; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2 * kH; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// A (kR, kC) tile of T in global memory (row stride ld, rows past rmax and
// columns past cmax read as 0) copied densely into shared memory in 16-byte
// chunks: cp.async when the source is 16-byte aligned and cmax a multiple
// of a chunk (async), else element by element.  Chunk e goes to thread
// e % kThreads, which also converts it (convert below), so a thread waits
// only for its own copies before reading them.
template <typename T, int kR, int kC>
struct Raw {
  static constexpr int kE = 16 / sizeof(T);  // elements of a chunk
  static constexpr int kChunks = kR * kC / kE;
  static_assert(kR * kC * sizeof(T) <= kRawA, "raw tile too large");
  static __device__ __forceinline__ void copy(T* raw, const T* __restrict__ src,
                                              int64_t ld, int rmax, int cmax,
                                              bool async) {
#pragma unroll
    for (int e0 = 0; e0 < kChunks; e0 += kThreads) {
      const int e = e0 + threadIdx.x;
      if (kChunks % kThreads == 0 || e < kChunks) {
        const int r = e / (kC / kE), c = e % (kC / kE) * kE;
        if (async) {
          const bool in = r < rmax && c < cmax;
          cp_async16(raw + r * kC + c, in ? src + r * ld + c : src, in);
        } else {
#pragma unroll
          for (int i = 0; i < kE; ++i) {
            raw[r * kC + c + i] = (r < rmax && c + i < cmax)
                                      ? src[r * ld + c + i]
                                      : zero<T>();
          }
        }
      }
    }
  }
  // f(r, c, v) for each of this thread's chunks: v[i] is element
  // (r, c + i) in float32
  template <typename F>
  static __device__ __forceinline__ void convert(const T* raw, F f) {
#pragma unroll
    for (int e0 = 0; e0 < kChunks; e0 += kThreads) {
      const int e = e0 + threadIdx.x;
      if (kChunks % kThreads == 0 || e < kChunks) {
        const int r = e / (kC / kE), c = e % (kC / kE) * kE;
        const uint4 u = *reinterpret_cast<const uint4*>(raw + r * kC + c);
        const T* raw_v = reinterpret_cast<const T*>(&u);
        float v[kE];
#pragma unroll
        for (int i = 0; i < kE; ++i) v[i] = to_f32(raw_v[i]);
        f(r, c, v);
      }
    }
  }
};

// v[0 .. kE) to dst[0 ..] (16-byte aligned) and to dst[0], dst[ld], ...
template <int kE>
__device__ __forceinline__ void put_row(float* dst, const float (&v)[kE]) {
#pragma unroll
  for (int i = 0; i < kE; i += 4) {
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}
template <int kE>
__device__ __forceinline__ void put_col(float* dst, int ld,
                                        const float (&v)[kE]) {
#pragma unroll
  for (int i = 0; i < kE; ++i) dst[i * ld] = v[i];
}

// Shared memory of the three tiled kernels: the raw ring, then the two
// float32 operand buffers (A (kK, kLdA), B (kK, kWB + 4)), then extras.
template <int kWB>
constexpr size_t tile_bytes() {
  return kStages * (kRawA + kRawB) +
         sizeof(float) * 2 * kK * (kLdA + kWB + 4);
}
struct Smem {
  char* raw;
  float* as;
  float* bs;
  float* extra;
  template <int kWB>
  __device__ __forceinline__ static Smem carve(char* base) {
    Smem s;
    s.raw = base;
    s.as = reinterpret_cast<float*>(base + kStages * (kRawA + kRawB));
    s.bs = s.as + 2 * kK * kLdA;
    s.extra = s.bs + 2 * kK * (kWB + 4);
    return s;
  }
  template <typename T>
  __device__ __forceinline__ T* raw_a(int k) const {
    return reinterpret_cast<T*>(raw + k % kStages * (kRawA + kRawB));
  }
  template <typename T>
  __device__ __forceinline__ T* raw_b(int k) const {
    return reinterpret_cast<T*>(raw + k % kStages * (kRawA + kRawB) + kRawA);
  }
};

// The tile loop: issue(k) starts tile k's copies into raw slot k % kStages,
// convert(k) turns this thread's chunks of tile k into the operand buffers
// (k & 1), fma(k) runs the FMA core on them.  One barrier a tile: tiles
// k + 1 and k + 2 are in flight while tile k's FMAs run.  prologue() runs
// once the first copies are in flight, and ends with a barrier if convert
// reads what it writes.
template <typename Issue, typename Convert, typename Fma, typename Prologue>
__device__ __forceinline__ void pipeline(int tiles, Issue issue,
                                         Convert convert, Fma fma,
                                         Prologue prologue) {
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < tiles) issue(k);
    cp_async_commit();
  }
  prologue();
  for (int k = 0; k < tiles; ++k) {
    cp_async_wait<kStages - 2>();
    convert(k);
    __syncthreads();
    if (k + kStages - 1 < tiles) issue(k + kStages - 1);
    cp_async_commit();
    fma(k);
  }
  cp_async_wait<0>();
}

// ---- 1. the head-free scores: gram[b][c][s][t] = C_t . B_s
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
ssd_gram_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
                float* __restrict__ gram, int N, int Q, int Qp, int64_t sbb,
                int64_t sbt, int64_t scb, int64_t sct, int async) {
  constexpr int kWB = kGramCols, kLdB = kWB + 4;
  using RA = Raw<T, kWA, kK>;   // C rows t, columns n
  using RB = Raw<T, kWB, kK>;   // B rows s, columns n
  extern __shared__ __align__(16) char smem[];
  const Smem sm = Smem::carve<kWB>(smem);
  const int cols = Qp / kWB;
  const int t0 = blockIdx.x / cols * kWA, s0 = blockIdx.x % cols * kWB;
  if (s0 >= min(Q, t0 + kWA)) return;  // no query row of the tile reads it
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tg = threadIdx.x / 8, pg = threadIdx.x % 8;
  const int64_t c0 = static_cast<int64_t>(c) * Q;
  const T* cb = cm + b * scb + (c0 + t0) * sct;
  const T* bb = bm + b * sbb + (c0 + s0) * sbt;

  float acc[8][kWB / 8] = {};
  pipeline(
      (N + kK - 1) / kK,
      [&](int k) {
        RA::copy(sm.raw_a<T>(k), cb + k * kK, sct, Q - t0, N - k * kK, async);
        RB::copy(sm.raw_b<T>(k), bb + k * kK, sbt, Q - s0, N - k * kK, async);
      },
      [&](int k) {
        float* a = sm.as + (k & 1) * kK * kLdA;
        float* bq = sm.bs + (k & 1) * kK * kLdB;
        RA::convert(sm.raw_a<T>(k), [&](int t, int n, const auto& v) {
          put_col(a + n * kLdA + t, kLdA, v);
        });
        RB::convert(sm.raw_b<T>(k), [&](int s, int n, const auto& v) {
          put_col(bq + n * kLdB + s, kLdB, v);
        });
      },
      [&](int k) {
        fma_tile<kWB>(acc, sm.as + (k & 1) * kK * kLdA,
                      sm.bs + (k & 1) * kK * kLdB, tg, pg);
      },
      [] {});
  float* g = gram + ((static_cast<int64_t>(b) * nc + c) * Qp + s0) * Qp + t0;
#pragma unroll
  for (int j = 0; j < kWB / 8; ++j) {
    float* row = g + static_cast<int64_t>(col_of<kWB>(j, pg)) * Qp;
    *reinterpret_cast<float4*>(row + 4 * tg) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(row + 64 + 4 * tg) =
        make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
}

// ---- 2. cum and the chunk's own state S_c, into S_prevs[c]
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 3)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ bm,
                 float* __restrict__ s_prevs, float* __restrict__ cum_out,
                 int batch, int seq, int heads, int N, int Q, int64_t sxb,
                 int64_t sxt, int64_t sbb, int64_t sbt, int async) {
  constexpr int kLdB = P + 4;
  using RA = Raw<T, kK, kWA>;  // B rows s, columns n
  using RB = Raw<T, kK, P>;    // x rows s, columns p
  extern __shared__ __align__(16) char smem[];
  const Smem sm = Smem::carve<P>(smem);
  const int Qk = (Q + kK - 1) / kK * kK;
  float* cum = sm.extra;  // [Qk]
  float* w = cum + Qk;     // [Qk] dt_s
  float* tail = w + Qk;    // [Qk] exp(cum_{Q-1} - cum_s)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32;
  const int tg = tid / 8, pg = tid % 8;
  const int64_t c0 = static_cast<int64_t>(c) * Q;
  const T* xb = x + b * sxb + c0 * sxt + h * P;
  const T* bb = bm + b * sbb + c0 * sbt;
  const float* dtb = dt + (static_cast<int64_t>(b) * seq + c0) * heads + h;

  float acc[8][P / 8] = {};
  pipeline(
      Qk / kK,
      [&](int k) {
        RA::copy(sm.raw_a<T>(k), bb + k * kK * sbt, sbt, Q - k * kK, N, async);
        RB::copy(sm.raw_b<T>(k), xb + k * kK * sxt, sxt, Q - k * kK, P, async);
      },
      [&](int k) {
        float* a = sm.as + (k & 1) * kK * kLdA;
        float* bq = sm.bs + (k & 1) * kK * kLdB;
        const float* ws = w + k * kK;
        const float* ts = tail + k * kK;
        RA::convert(sm.raw_a<T>(k), [&](int s, int n, const auto& v) {
          put_row(a + s * kLdA + n, v);
        });
        RB::convert(sm.raw_b<T>(k), [&](int s, int p, auto& v) {
          for (float& e : v) e = e * ws[s] * ts[s];
          put_row(bq + s * kLdB + p, v);
        });
      },
      [&](int k) {
        fma_tile<P>(acc, sm.as + (k & 1) * kK * kLdA,
                    sm.bs + (k & 1) * kK * kLdB, tg, pg);
      },
      [&] {
        for (int i = tid; i < Qk; i += kThreads) {
          w[i] = i < Q ? dtb[static_cast<int64_t>(i) * heads] : 0.0f;
        }
        __syncthreads();
        if (tid < 32) {  // cum: each lane sums a segment, then a warp scan
          const float a = A[h];
          const int per = (Q + 31) / 32;
          const int lo = min(lane * per, Q), hi = min(lo + per, Q);
          double run = 0.0;
          for (int i = lo; i < hi; ++i) run += static_cast<double>(w[i] * a);
          double incl = run;
          for (int off = 1; off < 32; off <<= 1) {
            const double v = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += v;
          }
          double sum = __shfl_up_sync(0xffffffffu, incl, 1);
          if (lane == 0) sum = 0.0;
          for (int i = lo; i < hi; ++i) {
            sum += static_cast<double>(w[i] * a);
            cum[i] = static_cast<float>(sum);
          }
        }
        __syncthreads();
        const float last = cum[Q - 1];
        float* co =
            cum_out + ((static_cast<int64_t>(b) * heads + h) * nc + c) * Q;
        for (int i = tid; i < Qk; i += kThreads) {  // 0 past Q: padded rows
          if (i < Q) co[i] = cum[i];
          tail[i] = i < Q ? expf(last - cum[i]) : 0.0f;
        }
        __syncthreads();
      });
  // acc[i][j] = S_c[p = col_of(j)][n = row_of(i)]
  float* sc = s_prevs +
              ((static_cast<int64_t>(c) * batch + b) * heads + h) * P * N;
#pragma unroll
  for (int j = 0; j < P / 8; ++j) {
    float* row = sc + col_of<P>(j, pg) * N;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int n = 64 * m + 4 * tg;
      if (N >= 4 && n < N) {
        *reinterpret_cast<float4*>(row + n) =
            make_float4(acc[4 * m][j], acc[4 * m + 1][j], acc[4 * m + 2][j],
                        acc[4 * m + 3][j]);
      } else if (N < 4 && m == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (n + i < N) row[n + i] = acc[i][j];
        }
      }
    }
  }
}

// ---- 3. the state pass, in place: S_prevs[c] holds S_c on the way in
__global__ void __launch_bounds__(256)
ssd_pass_kernel(float* __restrict__ s_prevs, float* __restrict__ s_final,
                const float* __restrict__ cum, int nc, int Q, int64_t rows,
                int quads) {
  // one float4 of (B, H, P, N) a thread; rows = B H, quads = P N / 4
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t slice = rows * quads;
  if (i >= slice) return;
  float4* sp = reinterpret_cast<float4*>(s_prevs) + i;
  const float* last = cum + i / quads * nc * Q + Q - 1;
  float4 carry = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c0 = 0; c0 < nc; c0 += 8) {  // eight chunks' loads in flight
    float4 sc[8];
    float d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k < nc) {
        sc[k] = sp[(c0 + k) * slice];
        d[k] = expf(last[static_cast<int64_t>(c0 + k) * Q]);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k < nc) {
        sp[(c0 + k) * slice] = carry;
        carry = make_float4(fmaf(carry.x, d[k], sc[k].x),
                            fmaf(carry.y, d[k], sc[k].y),
                            fmaf(carry.z, d[k], sc[k].z),
                            fmaf(carry.w, d[k], sc[k].w));
      }
    }
  }
  reinterpret_cast<float4*>(s_final)[i] = carry;
}

// ---- 4. y of one 128-row query tile of one (chunk, head, row)
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 3)
ssd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ cm, const float* __restrict__ gram,
               const float* __restrict__ s_prevs,
               const float* __restrict__ cum_in, T* __restrict__ y,
               int batch, int seq, int heads, int N, int Q, int Qp,
               int64_t sxb, int64_t sxt, int64_t scb, int64_t sct,
               int async) {
  constexpr int kLdB = P + 4;
  using CA = Raw<T, kWA, kK>;      // the read-out: C rows t, columns n
  using CB = Raw<float, P, kK>;    //   S_prev rows p, columns n
  using GA = Raw<float, kK, kWA>;  // then the scores: G^T rows s, columns t
  using GB = Raw<T, kK, P>;        //   x rows s, columns p
  static_assert(sizeof(float) * P * kK <= kRawB, "raw B tile too large");
  extern __shared__ __align__(16) char smem[];
  const Smem sm = Smem::carve<P>(smem);
  float* cum = sm.extra;  // [Qp]
  float* dts = cum + Qp;  // [Qp]
  const int nc = seq / Q;
  const int per = nc * heads * batch;
  int idx = blockIdx.x;
  const int q0 = (Qp / kWA - 1 - idx / per) * kWA;  // the longest tiles first
  idx %= per;
  const int h = idx % heads, c = idx / heads % nc, b = idx / heads / nc;
  const int tid = threadIdx.x, tg = tid / 8, pg = tid % 8;
  const int64_t c0 = static_cast<int64_t>(c) * Q;
  const T* xb = x + b * sxb + c0 * sxt + h * P;
  const T* cb = cm + b * scb + (c0 + q0) * sct;
  const float* gb = gram + (static_cast<int64_t>(b) * nc + c) * Qp * Qp + q0;
  const float* sp = s_prevs +
                    ((static_cast<int64_t>(c) * batch + b) * heads + h) * P * N;
  const float* cumb =
      cum_in + ((static_cast<int64_t>(b) * heads + h) * nc + c) * Q;
  const float* dtb = dt + (static_cast<int64_t>(b) * seq + c0) * heads + h;

  const int ro = c > 0 ? (N + kK - 1) / kK : 0;  // read-out tiles
  const int s_end = min(Q, q0 + kWA);             // keys the tile reads
  const int tiles = ro + (s_end + kK - 1) / kK;

  float acc[8][P / 8] = {};
  pipeline(
      tiles,
      [&](int k) {
        if (k < ro) {
          const int n0 = k * kK;
          CA::copy(sm.raw_a<T>(k), cb + n0, sct, Q - q0, N - n0, async);
          CB::copy(sm.raw_b<float>(k), sp + n0, N, P, N - n0, async);
        } else {
          const int s0 = (k - ro) * kK;
          GA::copy(sm.raw_a<float>(k), gb + static_cast<int64_t>(s0) * Qp, Qp,
                   kK, kWA, async);
          GB::copy(sm.raw_b<T>(k), xb + s0 * sxt, sxt, Q - s0, P, async);
        }
      },
      [&](int k) {
        float* a = sm.as + (k & 1) * kK * kLdA;
        float* bq = sm.bs + (k & 1) * kK * kLdB;
        if (k < ro) {
          CA::convert(sm.raw_a<T>(k), [&](int t, int n, const auto& v) {
            put_col(a + n * kLdA + t, kLdA, v);
          });
          CB::convert(sm.raw_b<float>(k), [&](int p, int n, const auto& v) {
            put_col(bq + n * kLdB + p, kLdB, v);
          });
        } else {  // the decayed scores G_ts exp(cum_t - cum_s) dt_s
          const int s0 = (k - ro) * kK;
          GA::convert(sm.raw_a<float>(k), [&](int r, int col, auto& v) {
            if (s0 >= q0 + 64 && col < 64) return;  // rows fma skips
            const int s = s0 + r;
            const float cs = cum[s];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int t = q0 + col + i;
              // masked before the exponential: exp(-inf) = 0
              const float d = (s <= t && t < Q) ? cum[t] - cs : -INFINITY;
              v[i] *= expf(d);
            }
            put_row(a + r * kLdA + col, v);
          });
          GB::convert(sm.raw_b<T>(k), [&](int s, int p, auto& v) {
            for (float& e : v) e *= dts[s0 + s];
            put_row(bq + s * kLdB + p, v);
          });
        }
      },
      [&](int k) {
        if (k == ro && ro > 0) {  // the read-out done: exp(cum_t) C_t . S_prev
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float e = expf(cum[q0 + row_of(i, tg)]);
#pragma unroll
            for (int j = 0; j < P / 8; ++j) acc[i][j] *= e;
          }
        }
        const float* a = sm.as + (k & 1) * kK * kLdA;
        const float* bq = sm.bs + (k & 1) * kK * kLdB;
        if (k >= ro && (k - ro) * kK >= q0 + 64) {  // rows q0 .. q0 + 63 masked
          fma_tile<P, true>(acc, a, bq, tg, pg);
        } else {
          fma_tile<P>(acc, a, bq, tg, pg);
        }
      },
      [&] {
        for (int i = tid; i < Qp; i += kThreads) {
          cum[i] = i < Q ? cumb[i] : 0.0f;
          dts[i] = i < Q ? dtb[static_cast<int64_t>(i) * heads] : 0.0f;
        }
        __syncthreads();
      });
  const int64_t sy = static_cast<int64_t>(heads) * P;
  T* yb = y + (static_cast<int64_t>(b) * seq + c0 + q0) * sy + h * P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = row_of(i, tg);
    if (q0 + t < Q) {
#pragma unroll
      for (int j = 0; j < P / 8; ++j) {
        store(yb + t * sy + col_of<P>(j, pg), acc[i][j]);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int P>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* bm, const void* cm, void* y, float* s_final,
                   float* s_prevs, float* gram, float* cum, int batch, int seq,
                   int heads, int N, int Q, int64_t sxb, int64_t sxt,
                   int64_t sbb, int64_t sbt, int64_t scb, int64_t sct,
                   cudaStream_t stream) {
  const int nc = seq / Q;
  const int Qp = (Q + kWA - 1) / kWA * kWA;
  const int Qk = (Q + kK - 1) / kK * kK;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  // cp.async takes 16-byte chunks: every row of x, B and C must start on a
  // 16-byte boundary and N hold whole chunks; else the tiles are copied
  // element by element
  constexpr int kE = 16 / sizeof(T);
  auto on16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int async = on16(x) && on16(bm) && on16(cm) && N % kE == 0 &&
                    sxb % kE == 0 && sxt % kE == 0 && sbb % kE == 0 &&
                    sbt % kE == 0 && scb % kE == 0 && sct % kE == 0;
  cudaError_t err;

  const size_t gram_smem = tile_bytes<kGramCols>();
  if ((err = allow_smem(ssd_gram_kernel<T>, gram_smem)) != cudaSuccess) {
    return err;
  }
  ssd_gram_kernel<T><<<dim3(Qp / kWA * (Qp / kGramCols), nc, batch), kThreads,
                       gram_smem, stream>>>(bt, ct, gram, N, Q, Qp, sbb, sbt,
                                            scb, sct, async);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t state_smem = tile_bytes<P>() + sizeof(float) * 3 * Qk;
  if ((err = allow_smem(ssd_state_kernel<T, P>, state_smem)) != cudaSuccess) {
    return err;
  }
  ssd_state_kernel<T, P><<<dim3(nc, heads, batch), kThreads, state_smem,
                           stream>>>(xt, dt, A, bt, s_prevs, cum, batch, seq,
                                     heads, N, Q, sxb, sxt, sbb, sbt, async);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int64_t rows = static_cast<int64_t>(batch) * heads;
  const int quads = P * N / 4;
  ssd_pass_kernel<<<static_cast<unsigned>((rows * quads + 255) / 256), 256, 0,
                    stream>>>(s_prevs, s_final, cum, nc, Q, rows, quads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t out_smem = tile_bytes<P>() + sizeof(float) * 2 * Qp;
  if ((err = allow_smem(ssd_out_kernel<T, P>, out_smem)) != cudaSuccess) {
    return err;
  }
  ssd_out_kernel<T, P><<<Qp / kWA * nc * heads * batch, kThreads, out_smem,
                         stream>>>(xt, dt, ct, gram, s_prevs, cum,
                                   static_cast<T*>(y), batch, seq, heads, N, Q,
                                   Qp, sxb, sxt, scb, sct, async);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int P, const void* x, const float* dt, const float* A,
                     const void* bm, const void* cm, void* y, float* s_final,
                     float* s_prevs, float* gram, float* cum, int batch,
                     int seq, int heads, int N, int Q, int64_t sxb,
                     int64_t sxt, int64_t sbb, int64_t sbt, int64_t scb,
                     int64_t sct, cudaStream_t stream) {
  switch (P) {
    case 16:
      return launch<T, 16>(x, dt, A, bm, cm, y, s_final, s_prevs, gram, cum,
                           batch, seq, heads, N, Q, sxb, sxt, sbb, sbt, scb,
                           sct, stream);
    case 32:
      return launch<T, 32>(x, dt, A, bm, cm, y, s_final, s_prevs, gram, cum,
                           batch, seq, heads, N, Q, sxb, sxt, sbb, sbt, scb,
                           sct, stream);
    case 64:
      return launch<T, 64>(x, dt, A, bm, cm, y, s_final, s_prevs, gram, cum,
                           batch, seq, heads, N, Q, sxb, sxt, sbb, sbt, scb,
                           sct, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, B, C and y); dt, A and the states are
// float32.  x is read at x[b * sxb + t * sxt + h * P + p], B and C at
// [b * sb + t * st + n]; dt (B, T, H) and y (B, T, H, P) are contiguous.
// Scratch the caller allocates: gram (B, T / Q, Qp, Qp) float32 with Qp = Q
// rounded up to 128, and cum (B, H, T / Q, Q) float32.
extern "C" int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                            const void* bm, const void* cm, void* y,
                            float* s_final, float* s_prevs, float* gram,
                            float* cum, int batch, int seq, int heads, int P,
                            int N, int Q, int64_t sxb, int64_t sxt,
                            int64_t sbb, int64_t sbt, int64_t scb, int64_t sct,
                            int dtype, void* stream) {
  if (N < 1 || N > kMaxN || (N & (N - 1)) || Q < 1 || Q > kMaxQ ||
      seq % Q) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(P, x, dt, A, bm, cm, y, s_final, s_prevs, gram, cum,
                          batch, seq, heads, N, Q, sxb, sxt, sbb, sbt, scb,
                          sct, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(P, x, dt, A, bm, cm, y, s_final, s_prevs,
                                  gram, cum, batch, seq, heads, N, Q, sxb, sxt,
                                  sbb, sbt, scb, sct, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
