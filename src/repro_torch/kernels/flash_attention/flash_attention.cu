// GQA flash-attention forward on Hopper (sm_90a), in two variants.
//
// Replaces the TPU kernel flash_attention_pallas of
// src/repro/kernels/flash_attention/flash_attention.py (body _flash_kernel):
// q (B, T, H, h), k and v (B, S, K, h), H = K * G, query head `head` reads kv
// head head / G; causal or not, an optional sliding window, online softmax,
// KV tiles wholly in the causal future or wholly before the window skipped.
//
// A superset of the Pallas kernel: it also returns lse (B, H, T) float32,
// the log-sum-exp of each row's softmax (the same memory as the reference's
// (B, K, G, T) layout), which the backward of models/attention.py needs; it
// takes softcap (each logit x becomes softcap * tanh(x / softcap) before the
// mask, as _fa_forward applies it); and T and S need not be multiples of the
// tile: rows past T are computed on zeros and never stored, keys past S are
// read as zeros and masked.  The Pallas kernel refuses ragged shapes and
// returns no lse.
//
// Arithmetic, as the Pallas kernel's: masked logits are -1e30, the running
// max starts at -inf, so a tile that is all masked for a row before any
// valid key is wiped by exp(m_prev - m_new) = 0 at the first valid one; a
// row whose keys are all masked is not supported (causal rows always read
// key 0).  l is clamped to 1e-30 before out = acc / l and lse = m + log(l).
// bfloat16 inputs: both products run on the tensor cores (bf16 in, f32
// accumulate), the logits are scaled after QK^T, and P is rounded to bf16
// for PV, as _fa_forward casts p to v's dtype; the online softmax is
// float32.  float32 inputs (v1 only): q is scaled in float32 as it is
// stored to shared memory (the Pallas kernel's q.astype(f32) * sm_scale),
// and both products are float32 FMA.
//
// What bounds it on this card: operations.  At the training shape (B 2,
// T = S = 2048, H 12, K 2, h 128, causal, bf16) it does 4 * h flops per
// (query, key) pair the causal mask keeps, ~26 GFLOP, against ~25 MB of q,
// k, v, out and lse: ~1,000 flops a byte, above the ~295 an H100 needs
// before bf16 arithmetic is the limit.  The least time is those flops over
// 989 TFLOP/s.
//
// Which variant runs (flash_attention.py, variant()): v2 for bfloat16 at
// h 64 and 128, v1 for float32 and for h 32 and 256.
//
// v1 (flash_fwd_kernel), a first, simple version on the legacy tensor-core
// path:
//   * one block of four warps per (64-row q tile, q head, batch row); q
//     tiles are taken longest-causal-row first;
//   * a loop over 64-row KV tiles inside the block takes the place of the
//     TPU's sequential kv grid axis; K and V tiles come through shared
//     memory (loads that do not overlap the arithmetic), and only the
//     tiles some row of the q tile can read are loaded (pl.when(run));
//   * warp w owns q rows 16w..16w+15 of the tile; the 16 x 64 logits and the
//     16 x h accumulator stay in registers in the mma.sync m16n8k16
//     accumulator layout, and the bf16 P fragments are built from the
//     logits registers.  The float32 path computes the same register
//     layout with FMA (P goes through a per-warp slab there);
//   * shared-memory rows are padded by 16 bytes against bank conflicts.
//
// v2 (flash_fwd_v2_kernel), the Hopper design for bfloat16 at h 64 and 128:
//   * warp specialisation: a block of three warpgroups covers 128 q rows of
//     one (q head, batch row).  Warpgroup 0 is the producer: it lowers its
//     registers to 24 with setmaxnreg and one of its threads issues every
//     load.  Warpgroups 1 and 2 are consumers of 64 q rows each and raise
//     theirs to 240;
//   * TMA into an mbarrier ring: Q is loaded once; K and V tiles of 128 kv
//     rows pass through a ring of stages (3 at h 128, 4 at h 64: a consumer
//     holds tile i's K and tile i - 1's V while tile i + 1 loads), each
//     stage with a "full" barrier for K, one for V (the TMA's byte count
//     completes them) and an "empty" barrier the 256 consumer threads
//     arrive on when their products have read the stage; the phase parity
//     flips on each pass round the ring.  The tensor maps are 4-D (h,
//     heads, seq, batch), so rows past T or S are outside the map and read
//     as zeros; with the 128-byte swizzle a box is at most 64 bf16 columns,
//     so a row of h 128 comes in as two boxes.  The maps are encoded on the
//     host through cuTensorMapEncodeTiled, looked up at run time through
//     the CUDA runtime, so nothing links libcuda;
//   * wgmma: S = Q K^T is m64n128k16 with Q and K both read from shared
//     memory through K-major 128B-swizzled descriptors; O += P V takes P
//     from registers (the f32 S accumulator rounded to bf16 pairs is the
//     A-fragment layout) and V from shared memory as an MN-major operand
//     (the transpose bit);
//   * the consumers take turns at the tensor cores (two named barriers):
//     in its turn a warpgroup issues tile i's QK^T and tile i - 1's PV
//     back to back, then runs tile i's softmax while its PV and the other
//     warpgroup's products run.  No instruction may write a wgmma's
//     registers, and no branch may sit, between the wgmma and its wait, or
//     ptxas serializes every wgmma of the kernel: the operands are pinned
//     before each fence, P is rounded into its registers only once PV is
//     done, and the mask and softcap are template arguments;
//   * the mask is built only on tiles that cross the causal diagonal, the
//     window edge or the S edge of a consumer's 64 rows; the producer loads
//     only the tiles some row of the block reads, so tiles wholly in the
//     causal future or before the window are skipped; the softmax runs in
//     exp2 with scale * log2(e) folded into one FMA, and lse is returned in
//     natural log; softcap is applied before the mask;
//   * the grid puts the q tile slowest and takes it longest-causal-row
//     first, so the first wave holds the blocks with the most KV tiles.
// Left for later: a persistent tile scheduler (one block an SM walking
// the tiles, one tile's epilogue and the next one's first loads
// overlapped: each block now starts with its loads in flight and nothing
// to compute), a TMA store of out, and a backward kernel
// (models/attention.py _fa_bwd is plain PyTorch, as the reference's
// backward is jnp).
//
// Built by kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes.  The entry points return cudaGetLastError(),
// or a negative CUresult when a tensor map cannot be encoded.

#include <cuda.h>  // CUtensorMap and its enums (types only; libcuda not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64;               // q rows a block
constexpr int kBkv = 64;              // kv rows a tile
constexpr int kWarps = kBq / 16;      // 16 q rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kNt = kBkv / 8;         // 8-column tiles of the logits
constexpr int kLp = kBkv + 4;         // row stride of the float32 P slab
constexpr float kNegInf = -1e30f;     // the reference's mask value

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int kPad = 4;  // 16 bytes
  static constexpr bool kPrescale = true;
  static constexpr size_t kPBytes = sizeof(float) * kWarps * 16 * kLp;
};
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kPad = 8;
  static constexpr bool kPrescale = false;
  static constexpr size_t kPBytes = 0;
};

template <typename T, int kH>
__host__ __device__ constexpr int row_stride() {
  return kH + Traits<T>::kPad;
}

template <typename T, int kH>
constexpr size_t smem_bytes() {
  return sizeof(T) * static_cast<size_t>(kBq + 2 * kBkv) * row_stride<T, kH>() +
         Traits<T>::kPBytes;
}

// Rows [0, rows) of a (64, kH) tile from global memory (row stride `ld`
// elements) into shared memory, 16 bytes a thread at a time; rows past
// `rows` are zero, so a masked key never multiplies a stale value.  With
// kScale (the float32 q tile) every element is multiplied by `scale`.
template <typename T, int kH, bool kScale = false>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int64_t ld, int rows,
                                          float scale = 1.0f) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kH / kVec;
  constexpr int kLd = row_stride<T, kH>();
  for (int i = threadIdx.x; i < kBkv * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * ld + c);
    if constexpr (kScale) {
      static_assert(sizeof(T) == 4, "only the float32 q tile is prescaled");
      float* f = reinterpret_cast<float*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) f[j] *= scale;
    }
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a * b for one m16n8k16 tile: a 16x16 row-major bf16 (4 registers),
// b 16x8 column-major bf16 (2 registers), d 16x8 float32 (4 registers).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The register layout of both paths, that of an m16n8 accumulator: lane
// (g = lane / 4, t4 = lane % 4) holds, of each 8-column tile n, columns
// 8n + 2 t4 and 8n + 2 t4 + 1 of rows g (registers 0, 1) and g + 8 (2, 3).

// s = Q K^T over the warp's 16 rows (qs) and the tile's 64 keys (ks).
template <int kH>
__device__ __forceinline__ void tile_qk(float (&s)[kNt][4],
                                        const __nv_bfloat16* qs,
                                        const __nv_bfloat16* ks, int g,
                                        int t4) {
  constexpr int kLd = row_stride<__nv_bfloat16, kH>();
#pragma unroll
  for (int kk = 0; kk < kH; kk += 16) {
    uint32_t a[4];
    a[0] = ld32(qs + g * kLd + kk + 2 * t4);
    a[1] = ld32(qs + (g + 8) * kLd + kk + 2 * t4);
    a[2] = ld32(qs + g * kLd + kk + 8 + 2 * t4);
    a[3] = ld32(qs + (g + 8) * kLd + kk + 8 + 2 * t4);
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const __nv_bfloat16* kr = ks + (8 * n + g) * kLd + kk + 2 * t4;
      mma(s[n], a, ld32(kr), ld32(kr + 8));
    }
  }
}

template <int kH>
__device__ __forceinline__ void tile_qk(float (&s)[kNt][4], const float* qs,
                                        const float* ks, int g, int t4) {
  constexpr int kLd = row_stride<float, kH>();
#pragma unroll 4
  for (int d = 0; d < kH; ++d) {
    const float q0 = qs[g * kLd + d], q1 = qs[(g + 8) * kLd + d];
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const float k0 = ks[(8 * n + 2 * t4) * kLd + d];
      const float k1 = ks[(8 * n + 2 * t4 + 1) * kLd + d];
      s[n][0] = fmaf(q0, k0, s[n][0]);
      s[n][1] = fmaf(q0, k1, s[n][1]);
      s[n][2] = fmaf(q1, k0, s[n][2]);
      s[n][3] = fmaf(q1, k1, s[n][3]);
    }
  }
}

// o += P V over the tile's 64 keys: P (the warp's 16 rows) in registers.
template <int kH>
__device__ __forceinline__ void tile_pv(float (&o)[kH / 8][4],
                                        const float (&p)[kNt][4],
                                        const __nv_bfloat16* vs, float*, int g,
                                        int t4) {
  constexpr int kLd = row_stride<__nv_bfloat16, kH>();
#pragma unroll
  for (int j = 0; j < kBkv / 16; ++j) {
    // the accumulator layout of tiles 2j and 2j + 1 is the A fragment of
    // k-step j
    const uint32_t a[4] = {pack(p[2 * j][0], p[2 * j][1]),
                           pack(p[2 * j][2], p[2 * j][3]),
                           pack(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int n = 0; n < kH / 8; ++n) {
      const __nv_bfloat16* vc = vs + (16 * j + 2 * t4) * kLd + 8 * n + g;
      mma(o[n], a, pack(vc[0], vc[kLd]), pack(vc[8 * kLd], vc[9 * kLd]));
    }
  }
}

template <int kH>
__device__ __forceinline__ void tile_pv(float (&o)[kH / 8][4],
                                        const float (&p)[kNt][4],
                                        const float* vs, float* ps, int g,
                                        int t4) {
  constexpr int kLd = row_stride<float, kH>();
  __syncwarp();  // the previous tile's reads of the slab are done
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    const int c = 8 * n + 2 * t4;
    ps[g * kLp + c] = p[n][0];
    ps[g * kLp + c + 1] = p[n][1];
    ps[(g + 8) * kLp + c] = p[n][2];
    ps[(g + 8) * kLp + c + 1] = p[n][3];
  }
  __syncwarp();
#pragma unroll 4
  for (int kv = 0; kv < kBkv; ++kv) {
    const float p0 = ps[g * kLp + kv], p1 = ps[(g + 8) * kLp + kv];
#pragma unroll
    for (int n = 0; n < kH / 8; ++n) {
      const float2 v2 =
          *reinterpret_cast<const float2*>(vs + kv * kLd + 8 * n + 2 * t4);
      o[n][0] = fmaf(p0, v2.x, o[n][0]);
      o[n][1] = fmaf(p0, v2.y, o[n][1]);
      o[n][2] = fmaf(p1, v2.x, o[n][2]);
      o[n][3] = fmaf(p1, v2.y, o[n][3]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int kH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int T_, int S, int H, int K,
                     int causal, int window, float sm_scale, float softcap) {
  constexpr int kLd = row_stride<T, kH>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBq * kLd;
  T* vs = ks + kBkv * kLd;
  float* ps = reinterpret_cast<float*>(vs + kBkv * kLd);  // float32 path only

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kh = head / (H / K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t q_ld = static_cast<int64_t>(H) * kH;
  const int64_t kv_ld = static_cast<int64_t>(K) * kH;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_ld + kh * kH;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_ld + kh * kH;

  load_tile<T, kH, Traits<T>::kPrescale>(
      qs, q + (static_cast<int64_t>(b) * T_ + q0) * q_ld + head * kH, q_ld,
      min(kBq, T_ - q0), sm_scale);
  const float s_scale = Traits<T>::kPrescale ? 1.0f : sm_scale;

  const int row[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[kH / 8][4];
#pragma unroll
  for (int n = 0; n < kH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // the KV tiles some row of this q tile can read
  int hi = (S + kBkv - 1) / kBkv;
  if (causal) hi = min(hi, (min(q0 + kBq, T_) - 1) / kBkv + 1);
  const int first_key = q0 - window + 1;  // row q0's first key in the window
  const int lo = (window > 0 && first_key > 0) ? first_key / kBkv : 0;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kBkv;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, kH>(ks, kb + k0 * kv_ld, kv_ld, min(kBkv, S - k0));
    load_tile<T, kH>(vs, vb + k0 * kv_ld, kv_ld, min(kBkv, S - k0));
    __syncthreads();

    float s[kNt][4];
#pragma unroll
    for (int n = 0; n < kNt; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    tile_qk<kH>(s, qs + 16 * warp * kLd, ks, g, t4);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row[i / 2], c = k0 + 8 * n + 2 * t4 + (i % 2);
        float x = s[n][i] * s_scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const bool ok = c < S && (!causal || c <= r) &&
                        (window <= 0 || c > r - window);
        s[n][i] = ok ? x : kNegInf;
        mx[i / 2] = fmaxf(mx[i / 2], s[n][i]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's 64 keys lie on the lane's quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);  // 0 on the first tile: m = -inf
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m[i / 2]);
        l[i / 2] += s[n][i];  // this lane's part of the row sum
      }
    }
#pragma unroll
    for (int n = 0; n < kH / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    tile_pv<kH>(o, s, vs, ps + warp * 16 * kLp, g, t4);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= T_) continue;
    const float ls = fmaxf(l[r], 1e-30f);
    T* dst = out + (static_cast<int64_t>(b) * T_ + row[r]) * q_ld + head * kH;
#pragma unroll
    for (int n = 0; n < kH / 8; ++n) {
      store2(dst + 8 * n + 2 * t4, o[n][2 * r] / ls, o[n][2 * r + 1] / ls);
    }
    if (t4 == 0) {
      lse[(static_cast<int64_t>(b) * H + head) * T_ + row[r]] = m[r] + logf(ls);
    }
  }
}

template <typename T, int kH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int T_, int S, int H, int K, int causal,
                   int window, float sm_scale, float softcap,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, kH>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T_ + kBq - 1) / kBq, H, B);
  flash_fwd_kernel<T, kH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, T_, S, H, K, causal,
      window, sm_scale, softcap);
  return cudaGetLastError();
}

// v1's head dims: all four in float32; in bfloat16 the two v2 does not take
template <typename T>
cudaError_t dispatch(int h, const void* q, const void* k, const void* v,
                     void* out, float* lse, int B, int T_, int S, int H, int K,
                     int causal, int window, float sm_scale, float softcap,
                     cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  switch (h) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, T_, S, H, K, causal, window,
                           sm_scale, softcap, stream);
    case 64:
      if constexpr (kF32) {
        return launch<T, 64>(q, k, v, out, lse, B, T_, S, H, K, causal,
                             window, sm_scale, softcap, stream);
      }
      break;
    case 128:
      if constexpr (kF32) {
        return launch<T, 128>(q, k, v, out, lse, B, T_, S, H, K, causal,
                              window, sm_scale, softcap, stream);
      }
      break;
    case 256:
      return launch<T, 256>(q, k, v, out, lse, B, T_, S, H, K, causal, window,
                            sm_scale, softcap, stream);
  }
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------- v2

namespace v2 {

constexpr int kBq = 128;        // q rows a block: 64 a consumer warpgroup
constexpr int kBkv = 128;       // kv rows a tile
constexpr int kThreads = 384;   // one producer and two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kBox = 64;        // bf16 columns in one 128-byte swizzled box
constexpr int kRowBytes = 128;  // a box row
constexpr float kLog2e = 1.4426950408889634f;

template <int kH>
struct Cfg {
  static constexpr int kHalves = kH / kBox;  // boxes a row
  static constexpr int kStages = kH == 128 ? 3 : 4;
  static constexpr uint32_t kQBox = kBq * kRowBytes;    // one box of Q
  static constexpr uint32_t kKvBox = kBkv * kRowBytes;  // one box of K or V
  static constexpr uint32_t kQBytes = kHalves * kQBox;
  static constexpr uint32_t kTileBytes = kHalves * kKvBox;
  static constexpr int kBarriers = 1 + 3 * kStages;
  // 1 KB of slack to align the swizzled buffers to the 1024-byte pattern
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes +
                                  8 * kBarriers;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box (64 columns, 1 head, 128 rows, 1 batch row) of a 4-D map from
// coordinates (column, head, row, batch) into shared memory at `dst`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A shared-memory matrix descriptor of the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the asm statements that issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
  }
}

// d (64 x 128) (+)= A (64 x 16, shared) * B (128 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int kH>
__device__ __forceinline__ void wgmma_pv(float (&d)[kH / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_n128(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_n64(d, a, b);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Named barriers 1 and 2 hand the tensor cores from one consumer
// warpgroup to the other (0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
}

// S = Q K^T over a warpgroup's 64 q rows (q_w) and a K tile (ks), issued and
// committed as one group.
template <int kH>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_w,
                                         uint32_t ks) {
  using C = Cfg<kH>;
#pragma unroll
  for (int kk = 0; kk < kH / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32u;  // 16 columns a k-step
    wgmma_ss_n128(sc, sw128_desc(q_w + (kk / 4) * C::kQBox + off, 16, 1024),
                  sw128_desc(ks + (kk / 4) * C::kKvBox + off, 16, 1024),
                  kk > 0);
  }
  wgmma_commit();
}

// O += P V over a V tile (vs): 16 kv rows of 128 bytes a k-step, the boxes
// of a row 64 columns apart; issued and committed as one group.
template <int kH>
__device__ __forceinline__ void issue_pv(float (&o)[kH / 2],
                                         const uint32_t (&pf)[8][4],
                                         uint32_t vs) {
#pragma unroll
  for (int kv = 0; kv < kBkv / 16; ++kv) {
    wgmma_pv<kH>(o, pf[kv],
                 sw128_desc(vs + kv * 16 * kRowBytes, Cfg<kH>::kKvBox, 1024));
  }
  wgmma_commit();
}

// The register layout of a wgmma m64nN f32 accumulator: thread t of the
// warpgroup (warp w = t / 32, g = lane / 4, t4 = lane % 4) holds, of each
// 8-column chunk n, columns 8n + 2 t4 and 8n + 2 t4 + 1 of rows 16w + g
// (registers 4n, 4n + 1) and 16w + g + 8 (4n + 2, 4n + 3).  Rounded to bf16
// pairs, chunks 2j and 2j + 1 are the A fragment of k-step j.

// What a consumer thread needs to mask and scale a tile's logits.
struct Rows {
  int r0;            // the warpgroup's first q row
  int row[2];        // the thread's two q rows
  int t4;            // its column pair within each 8-column chunk
  int S, causal, window;
  float softcap, cap_in;  // softcap and sm_scale / softcap
  float scale2;           // f * log2(e): exp(u * f) = exp2(u * scale2)
  float masked;           // the reference's -1e30, in units u

  // some key of the tile at k0 masked for some row of the warpgroup
  __device__ __forceinline__ bool need_mask(int k0) const {
    return k0 + kBkv > S || (causal && k0 + kBkv - 1 > r0) ||
           (window > 0 && k0 <= r0 + 63 - window);
  }
};

// The shared-memory ring: stage s of K and V, and its barriers.
struct Ring {
  uint32_t k_s, v_s, bars;
  int stages;
  uint32_t tile_bytes;
  __device__ __forceinline__ uint32_t k(int s) const {
    return k_s + s * tile_bytes;
  }
  __device__ __forceinline__ uint32_t v(int s) const {
    return v_s + s * tile_bytes;
  }
  __device__ __forceinline__ uint32_t full_q() const { return bars; }
  __device__ __forceinline__ uint32_t full_k(int s) const {
    return bars + 8u * (1 + s);
  }
  __device__ __forceinline__ uint32_t full_v(int s) const {
    return bars + 8u * (1 + stages + s);
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8u * (1 + 2 * stages + s);
  }
};

// One tile of the online softmax for the thread's two rows.  sc holds the
// products of the tile starting at key k0; they become logits in units u
// (natural logit = u * f: the product with f = sm_scale, or softcap *
// tanh(product * sm_scale / softcap) with f = 1), masked if kMask, and
// then the probabilities p, in place; the running max m and this lane's
// part of the row sum l are updated, and corr is the factor by which the
// accumulator of each row must be rescaled.  kMask and kCap are template
// arguments: this runs while a PV product is in flight, and a branch there
// would make ptxas serialize every wgmma of the kernel.
template <bool kMask, bool kCap>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const Rows& rs, int k0) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = sc[4 * n + i];
      if (kCap) x = rs.softcap * tanhf(x * rs.cap_in);
      if (kMask) {
        const int r = rs.row[i / 2], c = k0 + 8 * n + 2 * rs.t4 + (i % 2);
        const bool ok = c < rs.S && (!rs.causal || c <= r) &&
                        (rs.window <= 0 || c > r - rs.window);
        x = ok ? x : rs.masked;
      }
      sc[4 * n + i] = x;
      mx[i / 2] = fmaxf(mx[i / 2], x);
    }
  }
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's 128 keys lie on the lane's quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = fast_exp2((m[r] - mx[r]) * rs.scale2);  // 0 while m = -inf
    m[r] = mx[r];
    // p = exp2(u * scale2 - mb) is one FMA, whose unrounded product
    // misses mb by up to half an ulp of 1e30 where u = m = masked: a row
    // with no valid key yet takes mb = 0, so its p is 0, not inf (the
    // first valid key wipes it either way)
    mb[r] = mx[r] == rs.masked ? 0.0f : mx[r] * rs.scale2;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = fast_exp2(fmaf(sc[i], rs.scale2, -mb[(i % 4) / 2]));
    l[(i % 4) / 2] += sc[i];
  }
}

// P rounded to bf16: chunks 2j and 2j + 1 of the f32 layout are the A
// fragment of k-step j.
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pf)[8][4]) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    pf[n / 2][(n % 2) * 2] = pack(sc[4 * n], sc[4 * n + 1]);
    pf[n / 2][(n % 2) * 2 + 1] = pack(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

// A consumer warpgroup's first tile (it = 0): its QK^T in one turn at the
// tensor cores, then its softmax with nothing in flight.
template <int kH, bool kCap>
__device__ __forceinline__ void first_tile(float (&sc)[64],
                                           uint32_t (&pf)[8][4],
                                           float (&m)[2], float (&l)[2],
                                           const Rows& rs, const Ring& ring,
                                           int lo, uint32_t q_w, int mine,
                                           int theirs) {
  mbar_wait(ring.full_k(0), 0);
  bar_sync(mine);
  fence_regs(sc);
  wgmma_fence();
  issue_qk<kH>(sc, q_w, ring.k(0));
  bar_arrive(theirs);
  wgmma_wait_all();
  fence_regs(sc);
  float corr[2];  // O is still 0
  const int k0 = lo * kBkv;
  if (rs.need_mask(k0)) {
    softmax_tile<true, kCap>(sc, m, l, corr, rs, k0);
  } else {
    softmax_tile<false, kCap>(sc, m, l, corr, rs, k0);
  }
  pack_p(sc, pf);
}

// One turn after the first tile: the warpgroup takes the tensor cores
// (named barrier `mine`), issues tile it's QK^T and tile it - 1's PV (its P
// in pf), hands the tensor cores to the other warpgroup and runs tile it's
// softmax while PV runs; once PV is done it rescales O and rounds tile it's
// P into pf.  Every operand is pinned before the fence: an instruction
// that writes a wgmma's registers between the fence and the wait would
// make ptxas serialize every wgmma of the kernel.
template <int kH, bool kMask, bool kCap>
__device__ __forceinline__ void turn(float (&o)[kH / 2], uint32_t (&pf)[8][4],
                                     float (&sc)[64], float (&m)[2],
                                     float (&l)[2], const Rows& rs,
                                     uint32_t q_w, uint32_t ks, uint32_t vs,
                                     int k0, int mine, int theirs) {
  bar_sync(mine);
  fence_regs(sc);
  fence_regs(o);
  fence_regs(pf);
  wgmma_fence();
  issue_qk<kH>(sc, q_w, ks);
  issue_pv<kH>(o, pf, vs);
  bar_arrive(theirs);
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  fence_regs(sc);  // QK^T done; PV may still run
  float corr[2];
  softmax_tile<kMask, kCap>(sc, m, l, corr, rs, k0);
  wgmma_wait_all();
  fence_regs(o);
  fence_regs(pf);
#pragma unroll
  for (int n = 0; n < kH / 8; ++n) {
    o[4 * n] *= corr[0];
    o[4 * n + 1] *= corr[0];
    o[4 * n + 2] *= corr[1];
    o[4 * n + 3] *= corr[1];
  }
  pack_p(sc, pf);
}

template <int kH, bool kCap>
__device__ __forceinline__ void next_tile(int it, float (&o)[kH / 2],
                                          uint32_t (&pf)[8][4],
                                          float (&sc)[64], float (&m)[2],
                                          float (&l)[2], const Rows& rs,
                                          const Ring& ring, int lo,
                                          uint32_t q_w, int mine, int theirs) {
  const int s = it % ring.stages, ps = (it - 1) % ring.stages;
  mbar_wait(ring.full_k(s), (it / ring.stages) & 1);
  mbar_wait(ring.full_v(ps), ((it - 1) / ring.stages) & 1);
  const int k0 = (lo + it) * kBkv;
  if (rs.need_mask(k0)) {
    turn<kH, true, kCap>(o, pf, sc, m, l, rs, q_w, ring.k(s), ring.v(ps), k0,
                         mine, theirs);
  } else {
    turn<kH, false, kCap>(o, pf, sc, m, l, rs, q_w, ring.k(s), ring.v(ps), k0,
                          mine, theirs);
  }
  mbar_arrive(ring.empty(ps));
}

// The last tile's PV, outside any turn.
template <int kH>
__device__ __forceinline__ void last_pv(int n_tiles, float (&o)[kH / 2],
                                        uint32_t (&pf)[8][4],
                                        const Ring& ring) {
  const int ps = (n_tiles - 1) % ring.stages;
  mbar_wait(ring.full_v(ps), ((n_tiles - 1) / ring.stages) & 1);
  fence_regs(o);
  fence_regs(pf);
  wgmma_fence();
  issue_pv<kH>(o, pf, ring.v(ps));
  wgmma_wait_all();
  fence_regs(o);
  fence_regs(pf);
  mbar_arrive(ring.empty(ps));
}

template <int kH, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_v2_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int T_, int S, int H, int K,
                        int causal, int window, float sm_scale,
                        float softcap) {
  using C = Cfg<kH>;
  constexpr int kSt = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  Ring ring;
  ring.k_s = q_s + C::kQBytes;
  ring.v_s = ring.k_s + kSt * C::kTileBytes;
  ring.bars = ring.v_s + kSt * C::kTileBytes;
  ring.stages = kSt;
  ring.tile_bytes = C::kTileBytes;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;
  const int head = blockIdx.x % H, b = blockIdx.x / H;
  const int kh = head / (H / K);

  // the KV tiles some row of this q tile can read
  int hi = (S + kBkv - 1) / kBkv;
  if (causal) hi = min(hi, (min(q0 + kBq, T_) - 1) / kBkv + 1);
  const int first_key = q0 - window + 1;  // row q0's first key in the window
  const int lo = (window > 0 && first_key > 0) ? first_key / kBkv : 0;
  const int n_tiles = hi - lo;

  if (threadIdx.x == 0) {
    mbar_init(ring.full_q(), 1);
    for (int s = 0; s < kSt; ++s) {
      mbar_init(ring.full_k(s), 1);
      mbar_init(ring.full_v(s), 1);
      mbar_init(ring.empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(ring.full_q(), C::kQBytes);
      for (int c = 0; c < C::kHalves; ++c) {
        tma_load(q_s + c * C::kQBox, &qmap, ring.full_q(), c * kBox, head, q0,
                 b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kSt, row = (lo + it) * kBkv;
        if (it >= kSt) mbar_wait(ring.empty(s), ((it / kSt) & 1) ^ 1);
        mbar_expect_tx(ring.full_k(s), C::kTileBytes);
        for (int c = 0; c < C::kHalves; ++c) {
          tma_load(ring.k(s) + c * C::kKvBox, &kmap, ring.full_k(s), c * kBox,
                   kh, row, b);
        }
        mbar_expect_tx(ring.full_v(s), C::kTileBytes);
        for (int c = 0; c < C::kHalves; ++c) {
          tma_load(ring.v(s) + c * C::kKvBox, &vmap, ring.full_v(s), c * kBox,
                   kh, row, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each.  Tile it's QK^T and tile
    // it - 1's PV are issued back to back in one turn at the tensor cores;
    // the turn then passes to the other warpgroup while this one runs tile
    // it's softmax.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, g = (t % 32) / 4;
    Rows rs;
    rs.r0 = q0 + 64 * w;
    rs.row[0] = rs.r0 + 16 * warp + g;
    rs.row[1] = rs.row[0] + 8;
    rs.t4 = t % 4;
    rs.S = S;
    rs.causal = causal;
    rs.window = window;
    const float f = kCap ? 1.0f : sm_scale;
    rs.softcap = softcap;
    rs.cap_in = kCap ? sm_scale / softcap : 0.0f;
    rs.scale2 = f * kLog2e;
    rs.masked = -1e30f / f;
    const int mine = 1 + w, theirs = 2 - w;

    float o[kH / 2];
#pragma unroll
    for (int i = 0; i < kH / 2; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    uint32_t pf[8][4];  // P of the tile whose PV is next, bf16
    float sc[64];       // S, then P, of the current tile
    const uint32_t q_w = q_s + w * 64 * kRowBytes;

    mbar_wait(ring.full_q(), 0);
    if (n_tiles > 0) {
      // Turns alternate: warpgroup 0 takes the first; each turn ends with
      // an arrival on the other's barrier, and warpgroup 0 takes up
      // warpgroup 1's last one after the loop, so no arrival is left over.
      if (w == 1) bar_arrive(1);
      first_tile<kH, kCap>(sc, pf, m, l, rs, ring, lo, q_w, mine, theirs);
      for (int it = 1; it < n_tiles; ++it) {
        next_tile<kH, kCap>(it, o, pf, sc, m, l, rs, ring, lo, q_w, mine,
                            theirs);
      }
      last_pv<kH>(n_tiles, o, pf, ring);
      if (w == 0) bar_sync(mine);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (rs.row[r] >= T_) continue;
      const float ls = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* dst =
          out + (static_cast<int64_t>(b) * T_ + rs.row[r]) * H * kH +
          head * kH;
#pragma unroll
      for (int n = 0; n < kH / 8; ++n) {
        store2(dst + 8 * n + 2 * rs.t4, o[4 * n + 2 * r] / ls,
               o[4 * n + 2 * r + 1] / ls);
      }
      if (rs.t4 == 0) {
        lse[(static_cast<int64_t>(b) * H + head) * T_ + rs.row[r]] =
            m[r] * f + logf(ls);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so that nothing
// links libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (h, heads, seq, batch) of a contiguous (batch, seq, heads, h)
// bf16 tensor, read in boxes of (64 columns, 1 head, 128 rows, 1 batch row)
// with the 128-byte swizzle; coordinates past seq read as zeros.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int h,
                  int heads, int seq, int batch) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * h * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(h) * 2, row,
                                 row * seq};
  const cuuint32_t box[4] = {kBox, 1, kBq, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int kH>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int T_, int S, int H, int K, int causal, int window,
           float sm_scale, float softcap, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  CUresult res = make_map(encode, &qm, q, kH, H, T_, B);
  if (res == CUDA_SUCCESS) res = make_map(encode, &km, k, kH, K, S, B);
  if (res == CUDA_SUCCESS) res = make_map(encode, &vm, v, kH, K, S, B);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  constexpr size_t smem = Cfg<kH>::kSmem;
  auto kernel = softcap > 0.0f ? flash_fwd_v2_kernel<kH, true>
                               : flash_fwd_v2_kernel<kH, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // the q tile slowest, so that every (head, row) of the longest tiles
  // starts in the first wave
  const dim3 grid(B * H, (T_ + kBq - 1) / kBq);
  kernel<<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), lse, T_, S, H, K, causal,
      window, sm_scale, softcap);
  return cudaGetLastError();
}

}  // namespace v2

}  // namespace


// v1: q (B, T, H, h), k and v (B, S, K, h), out (B, T, H, h), all
// contiguous and of one dtype (0 float32, 1 bfloat16), 16-byte aligned; lse
// (B, H, T) float32.  h is 32, 64, 128 or 256 in float32, 32 or 256 in
// bfloat16 (flash_attention_fwd_v2 takes 64 and 128).  window <= 0 means
// none.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, float* lse, int B, int T, int S,
                                   int H, int K, int h, int causal, int window,
                                   float sm_scale, float softcap, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(h, q, k, v, out, lse, B, T, S, H, K, causal, window,
                           sm_scale, softcap, st);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(h, q, k, v, out, lse, B, T, S, H, K, causal,
                                   window, sm_scale, softcap, st);
  }
  return cudaErrorInvalidValue;
}

// bfloat16 q (B, T, H, h), k and v (B, S, K, h), out (B, T, H, h), all
// contiguous and 16-byte aligned; lse (B, H, T) float32.  h is 64 or 128.
// window <= 0 means none.
extern "C" int flash_attention_fwd_v2(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int T, int S, int H, int K, int h,
                                      int causal, int window, float sm_scale,
                                      float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 64:
      return v2::launch<64>(q, k, v, out, lse, B, T, S, H, K, causal, window,
                            sm_scale, softcap, st);
    case 128:
      return v2::launch<128>(q, k, v, out, lse, B, T, S, H, K, causal, window,
                             sm_scale, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}
