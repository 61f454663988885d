// Flash-decode on Hopper (sm_90a): one-token GQA attention over a KV cache.
//
// Replaces the TPU kernels of src/repro/kernels/flash_decode/flash_decode.py:
//   flash_decode_pallas        (dense (B, S, K, h) cache, body _decode_kernel)
//   flash_decode_pallas_paged  (a (P, bs, K, h) page pool through a (B, nb)
//                               block table, the same body)
//
// What bounds it on this card: bytes.  Row b reads the K and V rows of its
// live positions (0..pos[b], or the window before pos[b]) once per kv head,
// live * K * h * 2 * itemsize bytes, against 4 * G * h flops per position and
// kv head: about G flops a byte in bf16, far below the ~295 an H100 needs
// before arithmetic is the limit.  The least time is the live K/V bytes over
// 3.35 TB/s.
//
// What the design does about it:
//   * one block per (row b, kv head): the G query heads that share a kv head
//     read each K/V row once;
//   * a loop over kTile-row tiles inside the block takes the place of the
//     TPU's sequential S grid axis; tiles wholly past pos[b], or wholly before
//     the window, are never loaded, so the bytes read follow the live length
//     and not the allocated one;
//   * each thread issues its 16-byte K and V loads for a tile before it uses
//     any of them, so several loads are in flight per thread;
//   * K/V rows are addressed one at a time through a row functor (dense: row s
//     of the (b, kh) slab; paged: page table[b, s / bs], slot s % bs), so the
//     dense and the paged kernel run one routine with the same arithmetic in
//     the same order, and give bit-identical outputs on the same logical
//     cache.  Sums are written with __fmaf_rn / __fadd_rn / __fmul_rn, so no
//     contraction choice of the compiler can differ between the two.
// Left for later: at B = 8, K = 2 only 16 of the 132 SMs are busy, and no
// tile's loads overlap the previous tile's arithmetic.  Split-K over S,
// cp.async/TMA pipelining and tensor cores are the next steps.
//
// Built by kernels/flash_decode/flash_decode.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes.  Every entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;    // cache rows per tile: one per lane of a warp
constexpr int kMaxG = 16;    // query heads per kv head
constexpr int kGPerWarp = kMaxG / kWarps;
constexpr int kMaxCols = 2;  // columns of h per thread: h <= 256
constexpr int kLoads = 4;    // 16-byte loads of K (and of V) in flight a thread
constexpr float kNegInf = -1e30f;
static_assert(kTile == 32, "a tile row per lane");

// 16 bytes of T <-> floats
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(const uint4 u, float* f) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h2[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

// Row s of the (b, kv head) slab of a dense (B, S, K, h) cache.
struct DenseRows {
  int64_t base;        // element offset of (b, 0, kh, 0)
  int64_t row_stride;  // K * h
  __device__ __forceinline__ int64_t offset(int s) const {
    return base + s * row_stride;
  }
};

// Logical row s of one batch row, in a (P, bs, K, h) pool, through that
// row's block-table entries.  Every entry must name a page in [0, P).
struct PagedRows {
  const int* table;    // (nb,) page ids of this batch row
  int64_t head;        // kh * h
  int64_t row_stride;  // K * h
  int bs;
  __device__ __forceinline__ int64_t offset(int s) const {
    const int64_t page = table[s / bs];
    return (page * bs + s % bs) * row_stride + head;
  }
};

// K rows are stored with a stride of h + 1 floats, so the 32 lanes that
// each take one row of the tile read 32 different banks.
size_t smem_bytes(int G, int h) {
  return sizeof(float) * static_cast<size_t>(G * h + kTile * (h + 1) +
                                             kTile * h + G * kTile + 2 * G);
}

// The decode of one (b, kv head): G query rows of h against the live rows.
// Tile loop: (1) every thread issues its 16-byte K and V loads, then
// converts them into shared memory as float32; (2) warp w takes query heads
// w, w + 4, ...: lane r scores tile row r, and the warp's shuffles give the
// tile max and sum for the online softmax, whose running (m, l) stay in
// registers; (3) each thread updates its columns of the (G, h) accumulator.
template <typename T, typename Rows>
__device__ void decode_one(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           const Rows rows, int n_rows, int pos, int window,
                           int G, int h, float sm_scale) {
  extern __shared__ float smem[];
  const int ks_stride = h + 1;
  float* qs = smem;                    // (G, h) query, times sm_scale
  float* ks = qs + G * h;              // (kTile, h + 1) K tile
  float* vs = ks + kTile * ks_stride;  // (kTile, h) V tile, 16-byte aligned
  float* ps = vs + kTile * h;          // (G, kTile) probabilities
  float* rescale = ps + G * kTile;     // (G,) exp(m_prev - m_new), this tile
  float* l_fin = rescale + G;          // (G,) final sums

  constexpr int kVec = Pack<T>::n;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row_chunks = h / kVec;
  const int tile_chunks = kTile * row_chunks;
  for (int i = tid; i < G * h; i += kThreads) {
    qs[i] = __fmul_rn(load_f32(q + i), sm_scale);
  }
  float acc[kMaxG][kMaxCols];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int cc = 0; cc < kMaxCols; ++cc) acc[g][cc] = 0.f;
  }
  float m_run[kGPerWarp], l_run[kGPerWarp];
#pragma unroll
  for (int j = 0; j < kGPerWarp; ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.f;
  }

  // live positions lo..hi; no tile before lo's or after hi's is loaded
  const int hi = min(pos, n_rows - 1);
  const int lo = window > 0 ? max(pos - window + 1, 0) : 0;
  const int t_first = lo / kTile;
  const int t_last = hi >= lo ? hi / kTile : t_first - 1;

  for (int t = t_first; t <= t_last; ++t) {
    const int s0 = t * kTile;
    for (int base = 0; base < tile_chunks; base += kLoads * kThreads) {
      uint4 kr[kLoads], vr[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int i = base + j * kThreads + tid;
        const int r = i / row_chunks;
        kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
        if (i < tile_chunks && s0 + r < n_rows) {
          const int64_t o = rows.offset(s0 + r) + (i - r * row_chunks) * kVec;
          kr[j] = *reinterpret_cast<const uint4*>(k + o);
          vr[j] = *reinterpret_cast<const uint4*>(v + o);
        }
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int i = base + j * kThreads + tid;
        if (i < tile_chunks) {
          const int r = i / row_chunks;
          const int c = (i - r * row_chunks) * kVec;
          float f[kVec];
          Pack<T>::unpack(kr[j], f);
#pragma unroll
          for (int e = 0; e < kVec; ++e) ks[r * ks_stride + c + e] = f[e];
          Pack<T>::unpack(vr[j], f);
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            *reinterpret_cast<float4*>(vs + r * h + c + e) =
                make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
          }
        }
      }
    }
    __syncthreads();

    // scores and online softmax: a warp per query head, a lane per row
    const int s = s0 + lane;
    const bool valid =
        s <= pos && s < n_rows && (window <= 0 || s > pos - window);
#pragma unroll
    for (int j = 0; j < kGPerWarp; ++j) {
      const int g = warp + j * kWarps;
      if (g < G) {
        float sc = 0.f;
        for (int c = 0; c < h; ++c) {
          sc = __fmaf_rn(qs[g * h + c], ks[lane * ks_stride + c], sc);
        }
        sc = valid ? sc : kNegInf;
        const float m_new = fmaxf(m_run[j], warp_max(sc));
        const float p = expf(__fsub_rn(sc, m_new));
        const float resc = expf(__fsub_rn(m_run[j], m_new));
        l_run[j] = __fmaf_rn(l_run[j], resc, warp_sum(p));
        m_run[j] = m_new;
        ps[g * kTile + lane] = p;
        if (lane == 0) rescale[g] = resc;
      }
    }
    __syncthreads();

    // acc = acc * rescale + p @ V: one thread per column of h
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float sc = rescale[g];
#pragma unroll
        for (int cc = 0; cc < kMaxCols; ++cc) {
          const int c = tid + cc * kThreads;
          if (c < h) {
            float a = __fmul_rn(acc[g][cc], sc);
            for (int r = 0; r < kTile; ++r) {
              a = __fmaf_rn(ps[g * kTile + r], vs[r * h + c], a);
            }
            acc[g][cc] = a;
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs and ps
  }

#pragma unroll
  for (int j = 0; j < kGPerWarp; ++j) {
    const int g = warp + j * kWarps;
    if (g < G && lane == 0) l_fin[g] = l_run[j];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      const float l = fmaxf(l_fin[g], 1e-30f);
#pragma unroll
      for (int cc = 0; cc < kMaxCols; ++cc) {
        const int c = tid + cc * kThreads;
        if (c < h) store_f32(out + g * h + c, __fdiv_rn(acc[g][cc], l));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ pos,
                 T* __restrict__ out, int S, int H, int K, int h, int window,
                 float sm_scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int64_t qo = (static_cast<int64_t>(b) * H + kh * G) * h;
  const DenseRows rows{(static_cast<int64_t>(b) * S * K + kh) * h,
                       static_cast<int64_t>(K) * h};
  decode_one(q + qo, k, v, out + qo, rows, S, pos[b], window, G, h, sm_scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ table,
                 const int* __restrict__ pos, T* __restrict__ out, int bs,
                 int nb, int H, int K, int h, float sm_scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int64_t qo = (static_cast<int64_t>(b) * H + kh * G) * h;
  const PagedRows rows{table + static_cast<int64_t>(b) * nb,
                       static_cast<int64_t>(kh) * h,
                       static_cast<int64_t>(K) * h, bs};
  decode_one(q + qo, k, v, out + qo, rows, nb * bs, pos[b], 0, G, h,
             sm_scale);
}

bool shape_ok(int B, int H, int K, int h) {
  return B > 0 && B <= 65535 && K > 0 && H % K == 0 && H / K <= kMaxG &&
         h > 0 && h % 8 == 0 && h <= kMaxCols * kThreads;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_dense(const void* q, const void* k, const void* v, const void* pos,
                 void* out, int B, int S, int H, int K, int h, int window,
                 float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / K, h);
  cudaError_t err = allow_smem(dense_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dense_kernel<T><<<dim3(K, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<T*>(out), S, H, K, h, window, sm_scale);
  return cudaGetLastError();
}

template <typename T>
int launch_paged(const void* q, const void* k, const void* v,
                 const void* table, const void* pos, void* out, int B, int bs,
                 int nb, int H, int K, int h, float sm_scale,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes(H / K, h);
  cudaError_t err = allow_smem(paged_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  paged_kernel<T><<<dim3(K, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<T*>(out), bs, nb, H, K, h,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the cache and out share it).
extern "C" int flash_decode_dense(const void* q, const void* k, const void* v,
                                  const void* pos, void* out, int B, int S,
                                  int H, int K, int h, int window,
                                  float sm_scale, int dtype, void* stream) {
  if (!shape_ok(B, H, K, h) || S <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dense<float>(q, k, v, pos, out, B, S, H, K, h, window,
                               sm_scale, s);
  if (dtype == 1)
    return launch_dense<__nv_bfloat16>(q, k, v, pos, out, B, S, H, K, h,
                                       window, sm_scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int flash_decode_paged(const void* q, const void* k, const void* v,
                                  const void* table, const void* pos,
                                  void* out, int B, int bs, int nb, int H,
                                  int K, int h, float sm_scale, int dtype,
                                  void* stream) {
  if (!shape_ok(B, H, K, h) || bs <= 0 || nb <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_paged<float>(q, k, v, table, pos, out, B, bs, nb, H, K, h,
                               sm_scale, s);
  if (dtype == 1)
    return launch_paged<__nv_bfloat16>(q, k, v, table, pos, out, B, bs, nb,
                                       H, K, h, sm_scale, s);
  return cudaErrorInvalidValue;
}
