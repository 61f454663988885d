// V-trace targets on Hopper (sm_90a): vs and the policy-gradient advantages
// of a (B, T) trajectory batch in one launch (v3: a two-level scan over
// time).
//
// Replaces the TPU kernel vtrace_pallas of
// src/repro/kernels/vtrace/vtrace.py (body _vtrace_kernel), which keeps a
// (block_b, T) slab of rows in VMEM and runs the reverse recursion over T
// with the rows across the vector lanes.
//
// What bounds it on this card: latency and the dependent chain, not bytes.
// The function reads four (B, T) f32 inputs and the (B,) bootstrap once and
// writes two (B, T) outputs, 4 * (6 * B * T + B) bytes, against 16
// operations an element: the least time is those bytes over 3.35 TB/s,
// nanoseconds at the learners' shapes (B 32, T 20; B 2, T 2047).  What a
// call costs there is its launch, the round trips to device memory and the
// chain acc_t = delta_t + g_t * acc_{t+1}, one step after another.  v2 ran
// that chain over all of T in one lane a row and loaded 32 steps at a time,
// so at (2, 2047) one block paid 64 round trips in a row.  Only a large
// batch, (4096, 100), comes near the byte bound.
//
// What the design does about it.  The recursion is affine: with
// g_t = gamma_t * c_t, the maps acc -> D + G * acc compose as
// (G1, D1) o (G2, D2) = (G1 G2, D1 + G1 D2), so time can be scanned in
// parallel:
//   * a 256-thread block holds R whole rows; each thread owns a segment of
//     L consecutive steps of one row (P = 256 / R threads a row).  The rule,
//     from (B, T) alone (make_plan; vtrace.py's plan() is its twin): a row
//     takes threads, a power of two, until its segments are at most 9 steps
//     or it fills the block; then, while B * P is short of 132 * 256 threads
//     (a block for each SM), P doubles while that shortens the segments.
//     L is odd (below).  (2, 2047): P 256, L 9, a block a row; (4096, 100):
//     P 16, L 7, 16 rows a block, 256 blocks; (32, 20): P 8, L 3, one block;
//   * the block copies its rows' four inputs (and the rows' bootstraps)
//     into shared-memory slabs with 16-byte cp.async, all issued at once:
//     one round trip for the block.
//     A slab row starts (b * T) % 4 floats in, so 16-byte aligned runs of a
//     row land 16-byte aligned; the head and tail of a row that are not a
//     whole 16-byte run (T 2047: three rows in four start unaligned) are
//     copied element by element, as is everything when a pointer is not
//     16-byte aligned;
//   * pass 1: each thread reduces its segment, from its end to its start,
//     to (G, D); the last delta of a segment reads V_{t+1} from the next
//     segment's slab, or the row's carried V at a chunk's end (the
//     bootstrap at t = T - 1);
//   * the scan: within a warp by shuffles (Kogge-Stone over the lanes of a
//     row), then, where a row spans warps, over the warps' totals in shared
//     memory; each segment gets its carry-in, acc at its end;
//   * pass 2: each thread re-runs its segment from the carry in the plain
//     version's order, writing vs_t over V_t and adv_t over r_t in the
//     slab; at a segment's last step vs_{t+1} = V_{t+1} + carry.  The block
//     then stores both slabs with 16-byte stores, as it loaded them;
//   * segments of 1, 3, 5, 7 or 9 steps (every row up to 256 * 9 = 2,304
//     steps) run a kernel instantiated for that length: its loops unroll and
//     each step's terms stay in registers between the passes, so pass 1
//     issues its shared loads and exponentials together and pass 2 is the
//     chain alone (with the bootstrap copied beside the inputs, this took
//     (32, 20) from 0.0074 to 0.0069 ms, timed in turns in one run on an
//     H100 80GB HBM3 at 700 W);
//   * banks: thread i of a row reads step s_i + j = i * L + j; L odd makes
//     the 32 addresses of a warp distinct mod 32 within a row, and with
//     several rows a warp the slab rows are (L * P) mod 32 floats apart,
//     so rows continue the same pattern (when T % 4 == 0; other T shift a
//     row by its head and may pair a few banks);
//   * rows longer than a block's shared memory holds (L above 55, T past
//     256 * 55 = 14,080) are cut into equal chunks of 256 * L steps, walked
//     from the last with the row's acc and V at the chunk's start carried
//     to the chunk before;
//   * rounding: every step rounds as the plain version does (one float32
//     operation at a time, __fmul_rn / __fadd_rn, the accurate expf, fminf),
//     so a segment runs in the plain version's order; across segments the
//     order is the scan's, which ref.vtrace_segmented_ref repeats in plain
//     PyTorch.  The split depends on (B, T) only: a repeated call gives the
//     same bits.
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes.  The entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegTarget = 9;   // a row takes threads until L <= this
constexpr int kSegMax = 55;     // the longest segment (a chunk fits a block)
constexpr int kFill = 132 * kThreads;

struct Plan {
  int P;       // threads a row, one segment each (a power of two)
  int R;       // rows a block
  int L;       // steps a segment (odd)
  int C;       // steps a chunk, P * L
  int chunks;  // chunks a row
  int Ts;      // floats from one slab row to the next
  int smem;    // dynamic shared memory, bytes
  int blocks;
};

int cdiv(int64_t a, int64_t b) { return static_cast<int>((a + b - 1) / b); }
int odd(int n) { return n | 1; }

Plan make_plan(int B, int T) {
  Plan p;
  int P = 1;
  while (P < kThreads && odd(cdiv(T, P)) > kSegTarget) P *= 2;
  while (P < kThreads && static_cast<int64_t>(B) * P < kFill &&
         odd(cdiv(T, 2 * P)) < odd(cdiv(T, P)))
    P *= 2;
  int L = odd(cdiv(T, P));
  if (L > kSegMax)  // only at P == kThreads
    L = odd(cdiv(T, static_cast<int64_t>(kThreads) *
                        cdiv(T, static_cast<int64_t>(kThreads) * kSegMax)));
  p.P = P;
  p.R = kThreads / P;
  p.L = L;
  p.C = P * L;
  p.chunks = cdiv(T, p.C);
  int Ts = cdiv((p.C < T ? p.C : T) + 3, 4) * 4;
  if (p.R > 1 && (L * P) % 4 == 0)
    while (Ts % 32 != (L * P) % 32) Ts += 4;
  p.Ts = Ts;
  p.smem = 4 * (4 * p.R * Ts + 2 * p.R + 2 * kWarps);
  p.blocks = cdiv(B, p.R);
  return p;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// delta_t, and clipped rho_t and g_t = gamma_t * c_t, of step t whose next
// value is vn, rounded as the plain version rounds them.
__device__ __forceinline__ float step_terms(float logr, float d, float rw,
                                           float v, float vn, float clip_rho,
                                           float clip_c, float lambda,
                                           float& clipped, float& g) {
  const float rho = expf(logr);
  clipped = fminf(clip_rho, rho);
  g = mul(d, mul(lambda, fminf(clip_c, rho)));
  return mul(clipped, __fsub_rn(add(rw, mul(d, vn)), v));
}

// Runs f(rr, q, g0, lo, full) over the 4-float runs of the block's rows in
// chunk [t0, t0 + tc): run q of row rr covers the chunk's steps lo .. lo + 3
// (slab floats rr * Ts + 4 q ..; g0 is the row's element t0 in global
// memory); ``full`` when all four are in the chunk and the copy may take 16
// bytes.
template <typename F>
__device__ __forceinline__ void for_runs(const Plan& p, int B, int T, int t0,
                                         int tc, bool vec, F f) {
  const int nq = (tc + 6) / 4;
  for (int u = threadIdx.x; u < p.R * nq; u += kThreads) {
    const int rr = u / nq, q = u % nq;
    const int64_t b = static_cast<int64_t>(blockIdx.x) * p.R + rr;
    if (b >= B) continue;
    const int64_t g0 = b * T + t0;
    const int lo = 4 * q - (vec ? static_cast<int>(g0 & 3) : 0);
    if (lo >= tc) continue;
    f(rr, q, g0, lo, vec && lo >= 0 && lo + 4 <= tc);
  }
}

// A segment's steps between the passes.  kL > 0: segments of exactly kL
// steps, the loops unrolled and each step's terms kept in registers, so
// pass 1 issues all its shared loads and exponentials at once and pass 2 is
// the chain alone; kL == 0 (rows past 256 * 9 steps): p.L steps, and pass 2
// reads the slab again and recomputes them.
template <int kL>
struct Terms {
  float clipped[kL], g[kL], delta[kL], v[kL], r[kL], d[kL];
};
template <>
struct Terms<0> {};

template <int kL>
__global__ void __launch_bounds__(kThreads)
vtrace_kernel(const float* __restrict__ log_rhos,
              const float* __restrict__ discounts,
              const float* __restrict__ rewards,
              const float* __restrict__ values,
              const float* __restrict__ bootstrap, float* __restrict__ vs,
              float* __restrict__ adv, int B, int T, float clip_rho,
              float clip_c, float lambda, Plan p, bool vec) {
  extern __shared__ float4 smem4[];
  const int slab = p.R * p.Ts;
  float* const s_logr = reinterpret_cast<float*>(smem4);
  float* const s_disc = s_logr + slab;
  float* const s_rew = s_disc + slab;  // adv after pass 2
  float* const s_val = s_rew + slab;   // vs after pass 2
  float* const row_acc = s_val + slab;     // acc at the step after a chunk
  float* const row_vnext = row_acc + p.R;  // V at the step after a chunk
  float2* const wmap = reinterpret_cast<float2*>(row_vnext + p.R);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = tid / p.P, i = tid % p.P;  // row in the block, segment
  const int64_t b = static_cast<int64_t>(blockIdx.x) * p.R + r;
  const bool live = b < B;
  const int width = p.P < 32 ? p.P : 32;  // lanes of a row within a warp
  const int gl = lane % width;
  if (live && i == 0) {  // lands with the first chunk's copies
    row_acc[r] = 0.0f;
    cp_async4(row_vnext + r, bootstrap + b);
  }

  for (int c = p.chunks - 1; c >= 0; --c) {
    const int t0 = c * p.C;
    const int tc = min(p.C, T - t0);
    for_runs(p, B, T, t0, tc, vec,
             [&](int rr, int q, int64_t g0, int lo, bool full) {
               const int o = rr * p.Ts + 4 * q;
               if (full) {
                 cp_async16(s_logr + o, log_rhos + g0 + lo);
                 cp_async16(s_disc + o, discounts + g0 + lo);
                 cp_async16(s_rew + o, rewards + g0 + lo);
                 cp_async16(s_val + o, values + g0 + lo);
                 return;
               }
               for (int j = lo < 0 ? -lo : 0; j < 4 && lo + j < tc; ++j) {
                 cp_async4(s_logr + o + j, log_rhos + g0 + lo + j);
                 cp_async4(s_disc + o + j, discounts + g0 + lo + j);
                 cp_async4(s_rew + o + j, rewards + g0 + lo + j);
                 cp_async4(s_val + o + j, values + g0 + lo + j);
               }
             });
    cp_async_wait_all();
    __syncthreads();

    // this row's chunk in the slabs: step tt at [tt]
    const int head = vec ? static_cast<int>((b * T + t0) & 3) : 0;
    const int base = r * p.Ts + head;
    const float* const lr = s_logr + base;
    const float* const dc = s_disc + base;
    float* const rw = s_rew + base;
    float* const val = s_val + base;
    const int L = kL > 0 ? kL : p.L;
    const int s = i * L, e = min(s + L, tc);
    const bool own = live && s < tc;

    // pass 1: the segment's map acc_e -> D + G * acc_e
    float G = 1.0f, D = 0.0f, v_end = 0.0f;
    Terms<kL> terms;
    if (own) {
      v_end = e < tc ? val[e] : row_vnext[r];
      if constexpr (kL > 0) {
#pragma unroll
        for (int j = kL - 1; j >= 0; --j) {
          if (s + j < e) {
            terms.v[j] = val[s + j];
            terms.r[j] = rw[s + j];
            terms.d[j] = dc[s + j];
            const float vn = j + 1 < kL && s + j + 1 < e
                                 ? terms.v[j + 1 < kL ? j + 1 : j]
                                 : v_end;
            terms.delta[j] =
                step_terms(lr[s + j], terms.d[j], terms.r[j], terms.v[j], vn,
                           clip_rho, clip_c, lambda, terms.clipped[j],
                           terms.g[j]);
            D = add(terms.delta[j], mul(terms.g[j], D));
            G = mul(terms.g[j], G);
          }
        }
      } else {
        float vn = v_end;
        for (int t = e - 1; t >= s; --t) {
          const float v = val[t];
          float clipped, g;
          const float delta = step_terms(lr[t], dc[t], rw[t], v, vn,
                                         clip_rho, clip_c, lambda, clipped, g);
          D = add(delta, mul(g, D));
          G = mul(g, G);
          vn = v;
        }
      }
    }

    // the scan: inclusive maps over [i, end of the row's lanes in the warp)
    for (int off = 1; off < width; off <<= 1) {
      const float G2 = __shfl_down_sync(0xffffffffu, G, off);
      const float D2 = __shfl_down_sync(0xffffffffu, D, off);
      if (gl + off < width) {
        D = add(D, mul(G, D2));
        G = mul(G, G2);
      }
    }
    float cw = live ? row_acc[r] : 0.0f;  // acc at the end of this warp's span
    if (p.P > 32) {
      if (lane == 0) wmap[warp] = make_float2(G, D);
      __syncthreads();
      const int w0 = r * (p.P / 32);
      for (int w = p.P / 32 - 1; w > i / 32; --w) {
        const float2 m = wmap[w0 + w];
        cw = add(m.y, mul(m.x, cw));
      }
    }
    const float Gn = __shfl_down_sync(0xffffffffu, G, 1);
    const float Dn = __shfl_down_sync(0xffffffffu, D, 1);
    const float carry = gl + 1 < width ? add(Dn, mul(Gn, cw)) : cw;
    __syncwarp();

    // pass 2: vs and adv of the segment, from its carry
    float acc = carry, v_start = 0.0f;
    if (own) {
      float vs_next = add(v_end, carry);
      if constexpr (kL > 0) {
#pragma unroll
        for (int j = kL - 1; j >= 0; --j) {
          if (s + j < e) {
            acc = add(terms.delta[j], mul(terms.g[j], acc));
            const float vs_t = add(terms.v[j], acc);
            val[s + j] = vs_t;
            rw[s + j] = mul(
                terms.clipped[j],
                __fsub_rn(add(terms.r[j], mul(terms.d[j], vs_next)),
                          terms.v[j]));
            vs_next = vs_t;
          }
        }
        v_start = terms.v[0];
      } else {
        float vn = v_end;
        for (int t = e - 1; t >= s; --t) {
          const float v = val[t], r_t = rw[t], d = dc[t];
          float clipped, g;
          const float delta = step_terms(lr[t], d, r_t, v, vn, clip_rho,
                                         clip_c, lambda, clipped, g);
          acc = add(delta, mul(g, acc));
          const float vs_t = add(v, acc);
          val[t] = vs_t;
          rw[t] = mul(clipped, __fsub_rn(add(r_t, mul(d, vs_next)), v));
          vn = v;
          vs_next = vs_t;
        }
        v_start = vn;
      }
    }
    __syncthreads();
    if (own && i == 0) {  // the carry into the chunk before
      row_acc[r] = acc;
      row_vnext[r] = v_start;
    }

    for_runs(p, B, T, t0, tc, vec,
             [&](int rr, int q, int64_t g0, int lo, bool full) {
               const int o = rr * p.Ts + 4 * q;
               if (full) {
                 *reinterpret_cast<float4*>(vs + g0 + lo) =
                     *reinterpret_cast<const float4*>(s_val + o);
                 *reinterpret_cast<float4*>(adv + g0 + lo) =
                     *reinterpret_cast<const float4*>(s_rew + o);
                 return;
               }
               for (int j = lo < 0 ? -lo : 0; j < 4 && lo + j < tc; ++j) {
                 vs[g0 + lo + j] = s_val[o + j];
                 adv[g0 + lo + j] = s_rew[o + j];
               }
             });
    if (c > 0) __syncthreads();  // the next chunk's copies overwrite the slabs
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <int kL>
int launch(const float* log_rhos, const float* discounts, const float* rewards,
           const float* values, const float* bootstrap, float* vs, float* adv,
           int B, int T, float clip_rho, float clip_c, float lambda,
           const Plan& p, bool vec, void* stream) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vtrace_kernel<kL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  vtrace_kernel<kL><<<p.blocks, kThreads, p.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      log_rhos, discounts, rewards, values, bootstrap, vs, adv, B, T,
      clip_rho, clip_c, lambda, p, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" void vtrace_plan(int B, int T, int* out) {
  const Plan p = make_plan(B, T);
  const int fields[] = {p.P, p.R, p.L, p.C, p.chunks, p.Ts, p.smem, p.blocks};
  for (int k = 0; k < 8; ++k) out[k] = fields[k];
}

extern "C" int vtrace_f32(const float* log_rhos, const float* discounts,
                          const float* rewards, const float* values,
                          const float* bootstrap, float* vs, float* adv,
                          int B, int T, float clip_rho, float clip_c,
                          float lambda, void* stream) {
  if (B <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(B, T);
  const bool vec = aligned16(log_rhos) && aligned16(discounts) &&
                   aligned16(rewards) && aligned16(values) && aligned16(vs) &&
                   aligned16(adv);
  switch (p.L) {
    case 1:
      return launch<1>(log_rhos, discounts, rewards, values, bootstrap, vs,
                       adv, B, T, clip_rho, clip_c, lambda, p, vec, stream);
    case 3:
      return launch<3>(log_rhos, discounts, rewards, values, bootstrap, vs,
                       adv, B, T, clip_rho, clip_c, lambda, p, vec, stream);
    case 5:
      return launch<5>(log_rhos, discounts, rewards, values, bootstrap, vs,
                       adv, B, T, clip_rho, clip_c, lambda, p, vec, stream);
    case 7:
      return launch<7>(log_rhos, discounts, rewards, values, bootstrap, vs,
                       adv, B, T, clip_rho, clip_c, lambda, p, vec, stream);
    case 9:
      return launch<9>(log_rhos, discounts, rewards, values, bootstrap, vs,
                       adv, B, T, clip_rho, clip_c, lambda, p, vec, stream);
    default:
      return launch<0>(log_rhos, discounts, rewards, values, bootstrap, vs,
                       adv, B, T, clip_rho, clip_c, lambda, p, vec, stream);
  }
}
