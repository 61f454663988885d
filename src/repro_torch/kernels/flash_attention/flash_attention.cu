// GQA flash-attention forward on Hopper (sm_90a).
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
// loaded as zeros and masked.  The Pallas kernel refuses ragged shapes and
// returns no lse.
//
// Arithmetic, as the Pallas kernel's: masked logits are -1e30, the running
// max starts at -inf, so a tile that is all masked for a row before any
// valid key is wiped by exp(m_prev - m_new) = 0 at the first valid one; a
// row whose keys are all masked is not supported (causal rows always read
// key 0).  l is clamped to 1e-30 before out = acc / l and lse = m + log(l).
// float32 inputs: q is scaled in float32 as it is stored to shared memory
// (the Pallas kernel's q.astype(f32) * sm_scale), and both products are
// float32 FMA.  bfloat16 inputs: both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate), the logits are scaled after
// QK^T, and P is rounded to bf16 for PV, as flash-attention kernels on GPUs
// do; the online softmax is float32 in both.
//
// What bounds it on this card: operations.  At the training shape (B 2,
// T = S = 2048, H 12, K 2, h 128, causal, bf16) it does 4 * h flops per
// (query, key) pair the causal mask keeps, ~26 GFLOP, against ~25 MB of q,
// k, v, out and lse: ~1,000 flops a byte, above the ~295 an H100 needs
// before bf16 arithmetic is the limit.  The least time is those flops over
// 989 TFLOP/s.
//
// What the design does about it (a first, simple version):
//   * one block of four warps per (64-row q tile, q head, batch row); q
//     tiles are taken longest-causal-row first, so the blocks with the most
//     KV tiles start first;
//   * a loop over 64-row KV tiles inside the block takes the place of the
//     TPU's sequential kv grid axis; K and V tiles come through shared
//     memory, and only the tiles some row of the q tile can read are loaded
//     (the Pallas kernel's pl.when(run));
//   * warp w owns q rows 16w..16w+15 of the tile; the 16 x 64 logits and the
//     16 x h accumulator stay in registers in the mma.sync accumulator
//     layout, and the bf16 P fragments are built from the logits registers
//     without going through shared memory.  The float32 path computes the
//     same register layout with FMA (P goes through a per-warp slab there);
//   * shared-memory rows are padded by 16 bytes, so the fragment loads of
//     eight rows hit eight different bank groups.
// Left for later: wgmma, TMA and warp specialisation, double-buffered KV
// tiles (here the loads of a tile do not overlap the previous tile's
// arithmetic), and a backward kernel.
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

template <typename T>
cudaError_t dispatch(int h, const void* q, const void* k, const void* v,
                     void* out, float* lse, int B, int T_, int S, int H, int K,
                     int causal, int window, float sm_scale, float softcap,
                     cudaStream_t stream) {
  switch (h) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, T_, S, H, K, causal, window,
                           sm_scale, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, T_, S, H, K, causal, window,
                           sm_scale, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, T_, S, H, K, causal, window,
                            sm_scale, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, B, T_, S, H, K, causal, window,
                            sm_scale, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, T, H, h), k and v (B, S, K, h), out (B, T, H, h), all contiguous and
// of one dtype (0 float32, 1 bfloat16), 16-byte aligned; lse (B, H, T)
// float32.  h is 32, 64, 128 or 256.  window <= 0 means none.
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
