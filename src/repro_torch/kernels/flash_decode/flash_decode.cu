// Flash-decode on Hopper (sm_90a): one-token GQA attention over a KV cache,
// split over the cache (flash-decoding) and combined in a fixed order.
//
// Replaces the TPU kernels of src/repro/kernels/flash_decode/flash_decode.py:
//   flash_decode_pallas        (dense (B, S, K, h) cache, body _decode_kernel)
//   flash_decode_pallas_paged  (a (P, bs, K, h) page pool through a (B, nb)
//                               block table, the same body)
//
// What bounds it on this card: bytes.  Row b reads the K and V rows of its
// live positions (lo..hi, hi = min(pos[b], n_rows - 1), lo = 0 or the
// window's first) once per kv head, against 4 * G * h flops a row and kv
// head: about G flops a byte in bf16, far below the ~295 an H100 needs
// before arithmetic is the limit.  The least time is the live K/V bytes
// over 3.35 TB/s, a few microseconds even at S 4096; at the serving shape
// it is below one launch.
//
// What the design does about it:
//   * split-K: the grid is (split, kv head, row) over the ALLOCATED length
//     (S dense, nb * bs paged), never over pos, which stays on the device.
//     A split is `split` logical rows (plan() in flash_decode.py: 64, or
//     longer so that a row has at most 32 splits; the same for the two
//     layouts).  A split that lies wholly outside a row's live range
//     returns at once, so the bytes read follow the live length, and the
//     live splits spread one long row over many SMs (one block per (row,
//     kv head) would keep 16 of 132 SMs busy at the serving shape);
//   * each split writes its partial (m, l, acc[h]) for its G query heads in
//     float32 to scratch that the wrapper allocates; combine_kernel, a
//     second launch on the same stream, merges the live splits of each
//     (row, kv head, query head) with the log-sum-exp rescale in split
//     order, whatever order the blocks ran in: the output does not depend
//     on scheduling.  A second kernel rather than a last-arriving block: it
//     needs no counters that a launch must find zeroed and reset, no state
//     shared between launches or streams, and its G blocks a (row, kv
//     head) sum the splits in parallel.  It is launched as a programmatic
//     dependent of the split kernel, so its launch and its reads of pos
//     overlap the split kernel, and it waits only before the partials;
//   * a ring of kStages K/V tiles in shared memory, kept in the cache's own
//     dtype and filled by cp.async, so tile t + 1 is in flight while tile t
//     is computed.  A tile is 64 rows in bf16 (32 in float32): 16 KB of K
//     and 16 KB of V at h 128.  Rows outside the live range are not read:
//     cp.async zero-fills them.  A paged split reads its block-table
//     entries once, into shared memory, while pos is in flight;
//   * QK^T: lane r of a warp scores rows r and r + 32 (bf16) for the warp's
//     query heads (w, w + 4, ...), so each q value broadcast from shared
//     memory serves two rows; its K rows come 16 bytes at a time into four
//     independent partial sums per head (chains of h / 4, not h).  K
//     rows are stored with an odd number of 16-byte chunks, so the 8 lanes
//     of a quarter-warp read 8 different bank groups.  The loops over heads
//     are unrolled for a bucket kG of 4, 8 or 16 heads with no branch (the
//     heads past G repeat head G - 1 and are not stored): with a guard
//     per head the compiler runs one head's chain after another;
//   * PV: each half of the threads sums half of the tile's rows into 64
//     column pairs, so a float4 of p serves 8 FMAs; the halves are added in
//     a fixed order at the end of the split;
//   * numerics are the Pallas kernel's (flash_decode.py:62-76): q, k, v and
//     p in float32 (P is never rounded to the cache's dtype), masked logits
//     at -1e30, m from -inf, the clamp hi = min(pos, n_rows - 1).  Sums are
//     written with __fmaf_rn / __fadd_rn / __fmul_rn in a fixed order, so
//     the dense and the paged kernel, which run one routine over the same
//     logical tiles, give bit-identical outputs, and a call repeated gives
//     the same bits.
// Left for later: the decode step around it is host-bound (CUDA graphs);
// QK^T and PV still run on the FMA pipe with q and p broadcast from shared
// memory (tensor cores, with P split into bf16 hi + lo, would take both);
// a paged row's address takes an integer division by bs (a shift, for the
// power-of-two page sizes the engine uses, was 3% faster at S 256 on an
// H100 and within the noise at S 4096).
//
// Built by kernels/_build.py with
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
constexpr int kStages = 2;     // K/V tiles in the shared-memory ring
constexpr int kMaxTile = 64;   // cache rows of a bf16 tile (float32: 32)
constexpr int kMaxG = 16;      // query heads per kv head
constexpr int kMaxPairs = 2;   // column pairs a thread owns in PV: h <= 256
constexpr int kParts = 4;      // independent partial sums of a score
constexpr int kUnroll = 16;    // splits the combine loads at once
constexpr int kBlocksPerSM = 3;  // what shared memory allows at h 128 bf16
constexpr float kNegInf = -1e30f;

// 16 bytes of T <-> n floats; rows: the cache rows a lane scores (a tile
// is 32 * rows rows, so that a K tile and a V tile take 16 KB at h 128 in
// either dtype)
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int n = 4;
  static constexpr int rows = 1;
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
  static constexpr int rows = 2;
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
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch: the split kernel lets the combine kernel
// start at once, and the combine kernel waits here, after what does not
// depend on the partials, until the split kernel has finished and its
// writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The live rows of a row's cache: lo..hi (none when lo > hi).
struct Live {
  int lo, hi;
};
__device__ __forceinline__ Live live_rows(int pos, int n_rows, int window) {
  const int hi = min(pos, n_rows - 1);
  const int lo = window > 0 ? max(pos - window + 1, 0) : 0;
  return {lo, hi};
}

// Row s of the (b, kv head) slab of a dense (B, S, K, h) cache.
struct DenseRows {
  int64_t base;        // element offset of (b, 0, kh, 0)
  int64_t row_stride;  // K * h
  __device__ __forceinline__ int64_t offset(int s) const {
    return base + s * row_stride;
  }
};

// Logical row s of one batch row in a (P, bs, K, h) pool, through the
// block-table entries of the split, staged in shared memory: pages[i] is
// the page of logical block first_block + i.  Every entry must name a page
// in [0, P).
struct PagedRows {
  const int* pages;
  int first_block;
  int64_t head;        // kh * h
  int64_t row_stride;  // K * h
  int bs;
  __device__ __forceinline__ int64_t offset(int s) const {
    const int blk = s / bs;
    const int64_t page = pages[blk - first_block];
    return (page * bs + (s - blk * bs)) * row_stride + head;
  }
};

// Shared memory of the split kernels, in bytes from the start:
//   qs     (G, h) float32, q times sm_scale
//   ps     (kMaxG, kMaxTile) float32, this tile's probabilities
//   resc   (kMaxG,) float32, this tile's exp(m_prev - m_new)
//   pages  (n_pages,) int32, the split's block-table entries (paged only)
//   ring   kStages x [K tile (tile, kstride) | V tile (tile, h)] in T
// kstride is h padded to an odd number of 16-byte chunks.  After the tile
// loop the ring holds the (G, h) accumulator of the second half of the
// threads while the first half adds it to its own.
struct Layout {
  int kstride;  // elements of T per K row in shared memory
  size_t ps, resc, pages, ring, stage, v, bytes;
};
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~15ul; }
__host__ __device__ inline int tile_rows(int item) {
  return item == 2 ? 64 : 32;  // 32 * Pack<T>::rows
}
__host__ __device__ inline Layout layout(int G, int h, int item,
                                         int n_pages) {
  Layout L;
  const int vec = 16 / item;
  const int chunks = h / vec;
  const int tile = tile_rows(item);
  L.kstride = (chunks | 1) * vec;
  L.ps = align16(sizeof(float) * G * h);
  L.resc = L.ps + align16(sizeof(float) * kMaxG * kMaxTile);
  L.pages = L.resc + align16(sizeof(float) * kMaxG);
  L.ring = L.pages + align16(sizeof(int) * n_pages);
  L.v = align16(static_cast<size_t>(item) * tile * L.kstride);
  L.stage = L.v + align16(static_cast<size_t>(item) * tile * h);
  L.bytes = L.ring + kStages * L.stage;
  return L;
}

// Block-table entries a split of `split` rows can touch: its rows span at
// most split / bs + 1 blocks when bs divides split, one more otherwise.
__host__ __device__ inline int split_pages(int split, int bs) {
  return split / bs + 2;
}

// One split of one (row, kv head): G query rows of h against the live rows
// a..e of this split (a <= e), tiles of kTile rows through the ring.
// Writes the split's partial: ml[g] = (m, l) and acc[g * h + c], unscaled.
// kG >= G is the head count the loops are unrolled for (4, 8 or 16): heads
// G..kG-1 repeat head G - 1's arithmetic and are never stored, so no loop
// over heads has a branch and the compiler interleaves their chains.
template <int kG, typename T, typename Rows>
__device__ void decode_split(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const Rows rows, int a,
                             int e, int G, int h, float sm_scale,
                             unsigned char* smem, const Layout L,
                             float* __restrict__ part_acc,
                             float2* __restrict__ part_ml) {
  constexpr int kVec = Pack<T>::n;
  constexpr int kR = Pack<T>::rows;  // rows a lane scores
  constexpr int kTile = 32 * kR;
  constexpr int kHalf = kTile / 2;   // rows each half of the threads sums
  constexpr int kGW = kG / kWarps;   // heads a warp scores
  static_assert(kG % kWarps == 0 && kG <= kMaxG, "head bucket");
  static_assert(kTile <= kMaxTile && kHalf % 4 == 0, "tile");
  float* qs = reinterpret_cast<float*>(smem);
  float* ps = reinterpret_cast<float*>(smem + L.ps);
  float* resc = reinterpret_cast<float*>(smem + L.resc);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int chunks = h / kVec;             // 16-byte chunks of a row
  const int tile_chunks = kTile * chunks;  // of K, and of V
  const int t_first = a / kTile;
  const int n_tiles = e / kTile - t_first + 1;

  // K and V of tile t_first + i into stage i % kStages; rows outside a..e
  // are zero-filled and not read.  Thread t copies chunks t, t + kThreads..
  const int r_first = tid / chunks, ch_first = tid - r_first * chunks;
  const int r_step = kThreads / chunks, ch_step = kThreads - r_step * chunks;
  auto load_tile = [&](int i) {
    T* ks = reinterpret_cast<T*>(smem + L.ring + (i % kStages) * L.stage);
    T* vs = reinterpret_cast<T*>(smem + L.ring + (i % kStages) * L.stage +
                                 L.v);
    const int s0 = (t_first + i) * kTile;
    int r = r_first, ch = ch_first;  // chunk j = r * chunks + ch, no division
    for (int j = tid; j < tile_chunks; j += kThreads) {
      const int c = ch * kVec;
      const int s = s0 + r;
      const bool in = s >= a && s <= e;
      const int64_t o = in ? rows.offset(s) + c : 0;
      cp_async16(ks + r * L.kstride + c, k + o, in ? 16 : 0);
      cp_async16(vs + r * h + c, v + o, in ? 16 : 0);
      r += r_step;
      ch += ch_step;
      if (ch >= chunks) {
        ch -= chunks;
        ++r;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  for (int i = tid; i < G * h; i += kThreads) {
    qs[i] = __fmul_rn(load_f32(q + i), sm_scale);
  }

  // warp w scores heads w, w + 4, ...; qrow[j] is head min(g, G - 1)'s q
  const float* qrow[kGW];
#pragma unroll
  for (int j = 0; j < kGW; ++j) {
    qrow[j] = qs + min(warp + j * kWarps, G - 1) * h;
  }
  // PV: thread t sums rows [half * kHalf, +kHalf) of each tile into column
  // pairs cp = t % 64 + 64 * k, columns 2 cp and 2 cp + 1
  const int half = tid / 64;
  const int pair0 = tid % 64;
  float acc[kG][kMaxPairs][2];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int kk = 0; kk < kMaxPairs; ++kk) acc[g][kk][0] = acc[g][kk][1] = 0.f;
  }
  float m_run[kGW], l_run[kGW];
#pragma unroll
  for (int j = 0; j < kGW; ++j) {
    m_run[j] = -INFINITY;
    l_run[j] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; every thread is done with tile i - 1
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();
    const T* ks =
        reinterpret_cast<const T*>(smem + L.ring + (i % kStages) * L.stage);
    const T* vs = reinterpret_cast<const T*>(
        smem + L.ring + (i % kStages) * L.stage + L.v);

    // scores: lane scores rows lane + 32 rr, kParts partial sums a head
    float part[kGW][kR][kParts];
#pragma unroll
    for (int j = 0; j < kGW; ++j) {
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
#pragma unroll
        for (int u = 0; u < kParts; ++u) part[j][rr][u] = 0.f;
      }
    }
    auto score_chunk = [&](int c, int u) {
      float kf[kR][kVec];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        Pack<T>::unpack(*reinterpret_cast<const uint4*>(
                            ks + (lane + 32 * rr) * L.kstride + c * kVec),
                        kf[rr]);
      }
#pragma unroll
      for (int j = 0; j < kGW; ++j) {
#pragma unroll
        for (int f = 0; f < kVec; f += 4) {
          const float4 q4 =
              *reinterpret_cast<const float4*>(qrow[j] + c * kVec + f);
#pragma unroll
          for (int rr = 0; rr < kR; ++rr) {
            float x = part[j][rr][u];
            x = __fmaf_rn(q4.x, kf[rr][f], x);
            x = __fmaf_rn(q4.y, kf[rr][f + 1], x);
            x = __fmaf_rn(q4.z, kf[rr][f + 2], x);
            x = __fmaf_rn(q4.w, kf[rr][f + 3], x);
            part[j][rr][u] = x;
          }
        }
      }
    };
    int c0 = 0;
    for (; c0 + kParts <= chunks; c0 += kParts) {
#pragma unroll
      for (int u = 0; u < kParts; ++u) score_chunk(c0 + u, u);
    }
#pragma unroll
    for (int u = 0; u < kParts - 1; ++u) {
      if (c0 + u < chunks) score_chunk(c0 + u, u);
    }

    // online softmax of each head over the tile (warp shuffles)
    const int s0 = (t_first + i) * kTile;
#pragma unroll
    for (int j = 0; j < kGW; ++j) {
      float sc[kR];
      float mx = kNegInf;
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const int s = s0 + lane + 32 * rr;
        sc[rr] = __fadd_rn(__fadd_rn(part[j][rr][0], part[j][rr][1]),
                           __fadd_rn(part[j][rr][2], part[j][rr][3]));
        sc[rr] = s >= a && s <= e ? sc[rr] : kNegInf;
        mx = fmaxf(mx, sc[rr]);
      }
      const float m_new = fmaxf(m_run[j], warp_max(mx));
      const int g = warp + j * kWarps;
      float psum = 0.f;
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const float p = expf(__fsub_rn(sc[rr], m_new));
        ps[g * kMaxTile + lane + 32 * rr] = p;
        psum = __fadd_rn(psum, p);
      }
      const float r = expf(__fsub_rn(m_run[j], m_new));
      l_run[j] = __fmaf_rn(l_run[j], r, warp_sum(psum));
      m_run[j] = m_new;
      if (lane == 0) resc[g] = r;
    }
    __syncthreads();

    // acc = acc * resc + p @ V over this thread's half of the rows
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float r = resc[g];
#pragma unroll
      for (int kk = 0; kk < kMaxPairs; ++kk) {
        acc[g][kk][0] = __fmul_rn(acc[g][kk][0], r);
        acc[g][kk][1] = __fmul_rn(acc[g][kk][1], r);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kMaxPairs; ++kk) {
      const int c = 2 * (pair0 + 64 * kk);
      if (c < h) {
#pragma unroll 2
        for (int r0 = half * kHalf; r0 < half * kHalf + kHalf; r0 += 4) {
          float2 vr[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) vr[u] = load_pair(vs + (r0 + u) * h + c);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(ps + g * kMaxTile + r0);
            float x = acc[g][kk][0], y = acc[g][kk][1];
            x = __fmaf_rn(p4.x, vr[0].x, x);
            y = __fmaf_rn(p4.x, vr[0].y, y);
            x = __fmaf_rn(p4.y, vr[1].x, x);
            y = __fmaf_rn(p4.y, vr[1].y, y);
            x = __fmaf_rn(p4.z, vr[2].x, x);
            y = __fmaf_rn(p4.z, vr[2].y, y);
            x = __fmaf_rn(p4.w, vr[3].x, x);
            y = __fmaf_rn(p4.w, vr[3].y, y);
            acc[g][kk][0] = x;
            acc[g][kk][1] = y;
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int j = 0; j < kGW; ++j) {
    const int g = warp + j * kWarps;
    if (g < G && lane == 0) part_ml[g] = make_float2(m_run[j], l_run[j]);
  }
  // the two halves' sums, first half + second half, through the ring
  float* other = reinterpret_cast<float*>(smem + L.ring);
  __syncthreads();  // no thread reads the ring any more
  if (half == 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int kk = 0; kk < kMaxPairs; ++kk) {
        const int c = 2 * (pair0 + 64 * kk);
        if (g < G && c < h) {
          *reinterpret_cast<float2*>(other + g * h + c) =
              make_float2(acc[g][kk][0], acc[g][kk][1]);
        }
      }
    }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int kk = 0; kk < kMaxPairs; ++kk) {
        const int c = 2 * (pair0 + 64 * kk);
        if (g < G && c < h) {
          const float2 o = *reinterpret_cast<const float2*>(other + g * h + c);
          *reinterpret_cast<float2*>(part_acc + g * h + c) = make_float2(
              __fadd_rn(acc[g][kk][0], o.x), __fadd_rn(acc[g][kk][1], o.y));
        }
      }
    }
  }
}

// Grid (split, kv head, row).  Partials: part_ml (B, K, n_split, G),
// part_acc (B, K, n_split, G, h).
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    dense_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ pos,
                 float* __restrict__ part_acc, float2* __restrict__ part_ml,
                 int S, int H, int K, int h, int window, int split,
                 float sm_scale) {
  launch_dependents();
  const int sp = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const Live live = live_rows(pos[b], S, window);
  const int a = max(live.lo, sp * split);
  const int e = min(live.hi, sp * split + split - 1);
  if (a > e) return;  // no live row in this split
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / K;
  const int64_t pi = (static_cast<int64_t>(b) * K + kh) * gridDim.x + sp;
  const DenseRows rows{(static_cast<int64_t>(b) * S * K + kh) * h,
                       static_cast<int64_t>(K) * h};
  decode_split<kG>(q + (static_cast<int64_t>(b) * H + kh * G) * h, k, v,
                   rows, a, e, G, h, sm_scale, smem,
                   layout(G, h, sizeof(T), 0), part_acc + pi * G * h,
                   part_ml + pi * G);
}

template <typename T, int kG>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    paged_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ table,
                 const int* __restrict__ pos, float* __restrict__ part_acc,
                 float2* __restrict__ part_ml, int bs, int nb, int H, int K,
                 int h, int split, float sm_scale) {
  launch_dependents();
  const int sp = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / K;
  const Layout L = layout(G, h, sizeof(T), split_pages(split, bs));
  // the block-table entries of the split's rows, read once and while pos
  // is in flight: they do not depend on it
  const int p = pos[b];
  int* pages = reinterpret_cast<int*>(smem + L.pages);
  const int s0 = sp * split;
  const int first_block = s0 / bs;
  const int n_blocks = (min(s0 + split, nb * bs) - 1) / bs - first_block + 1;
  const int* row_table = table + static_cast<int64_t>(b) * nb;
  for (int i = threadIdx.x; i < n_blocks; i += kThreads) {
    pages[i] = row_table[first_block + i];
  }
  const Live live = live_rows(p, nb * bs, 0);
  const int a = max(live.lo, s0);
  const int e = min(live.hi, s0 + split - 1);
  if (a > e) return;
  __syncthreads();
  const int64_t pi = (static_cast<int64_t>(b) * K + kh) * gridDim.x + sp;
  const PagedRows rows{pages, first_block, static_cast<int64_t>(kh) * h,
                       static_cast<int64_t>(K) * h, bs};
  decode_split<kG>(q + (static_cast<int64_t>(b) * H + kh * G) * h, k, v,
                   rows, a, e, G, h, sm_scale, smem, L,
                   part_acc + pi * G * h, part_ml + pi * G);
}

// Grid (query head g, kv head, row): merges the live splits of (b, kh, g)
// in split order.  m = max_s m_s; w_s = exp(m_s - m); out = sum_s w_s
// acc_s / max(sum_s w_s l_s, 1e-30).  A row with no live position gives 0,
// as the Pallas kernel's untouched accumulator does.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ part_acc,
                   const float2* __restrict__ part_ml,
                   const int* __restrict__ pos, T* __restrict__ out,
                   int n_rows, int H, int K, int h, int window, int split) {
  extern __shared__ __align__(16) float w[];  // (n_live,) weights, then l
  const int g = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  T* o = out + (static_cast<int64_t>(b) * H + kh * G + g) * h;
  const Live live = live_rows(pos[b], n_rows, window);
  if (live.lo > live.hi) {
    for (int c = tid; c < h; c += kThreads) store_f32(o + c, 0.f);
    return;
  }
  const int first = live.lo / split;
  const int n = live.hi / split - first + 1;
  const int64_t p0 =
      ((static_cast<int64_t>(b) * K + kh) * ((n_rows + split - 1) / split) +
       first);
  const float2* ml = part_ml + p0 * G + g;  // split first + s at ml[s * G]
  const float* acc = part_acc + p0 * G * h + static_cast<int64_t>(g) * h;
  grid_dependency_wait();  // the split kernel's partials are written

  float m = -INFINITY;
  for (int s = lane; s < n; s += 32) m = fmaxf(m, ml[s * G].x);
  m = warp_max(m);  // every warp holds the same max
  for (int s = tid; s < n; s += kThreads) {
    w[s] = expf(__fsub_rn(ml[s * G].x, m));
  }
  __syncthreads();
  if (tid < 32) {
    float l = 0.f;
    for (int s = lane; s < n; s += 32) l = __fmaf_rn(ml[s * G].y, w[s], l);
    l = warp_sum(l);
    if (lane == 0) w[n] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float l = w[n];
  const int64_t stride = static_cast<int64_t>(G) * h;  // split to split
  for (int c = tid; c < h; c += kThreads) {
    float x = 0.f;
    int s = 0;
    for (; s + kUnroll <= n; s += kUnroll) {  // kUnroll loads in flight
      float a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) a[u] = acc[(s + u) * stride + c];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x = __fmaf_rn(a[u], w[s + u], x);
    }
    for (; s < n; ++s) x = __fmaf_rn(acc[s * stride + c], w[s], x);
    store_f32(o + c, __fdiv_rn(x, l));
  }
}

bool shape_ok(int B, int H, int K, int h, int split) {
  return B > 0 && B <= 65535 && K > 0 && K <= 65535 && H % K == 0 &&
         H / K <= kMaxG && h > 0 && h % 8 == 0 && h <= 2 * 64 * kMaxPairs &&
         split > 0 && split % kMaxTile == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_combine(const float* part_acc, const float2* part_ml,
                   const int* pos, void* out, int B, int n_rows, int H, int K,
                   int h, int window, int split, cudaStream_t stream) {
  const int n_split = (n_rows + split - 1) / split;
  const size_t smem = sizeof(float) * (n_split + 1);
  cudaError_t err = allow_smem(combine_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H / K, K, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, combine_kernel<T>, part_acc, part_ml, pos,
                           static_cast<T*>(out), n_rows, H, K, h, window,
                           split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int kG>
int launch_dense_g(const void* q, const void* k, const void* v,
                   const void* pos, void* part_acc, void* part_ml, int B,
                   int S, int H, int K, int h, int window, int split,
                   float sm_scale, cudaStream_t stream) {
  const int n_split = (S + split - 1) / split;
  const size_t smem = layout(H / K, h, sizeof(T), 0).bytes;
  cudaError_t err = allow_smem(dense_kernel<T, kG>, smem);
  if (err != cudaSuccess) return err;
  dense_kernel<T, kG><<<dim3(n_split, K, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<float*>(part_acc), static_cast<float2*>(part_ml), S, H, K,
      h, window, split, sm_scale);
  return cudaGetLastError();
}

template <typename T, int kG>
int launch_paged_g(const void* q, const void* k, const void* v,
                   const void* table, const void* pos, void* part_acc,
                   void* part_ml, int B, int bs, int nb, int H, int K, int h,
                   int split, float sm_scale, cudaStream_t stream) {
  const int n_split = (nb * bs + split - 1) / split;
  const size_t smem =
      layout(H / K, h, sizeof(T), split_pages(split, bs)).bytes;
  cudaError_t err = allow_smem(paged_kernel<T, kG>, smem);
  if (err != cudaSuccess) return err;
  paged_kernel<T, kG><<<dim3(n_split, K, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<float*>(part_acc),
      static_cast<float2*>(part_ml), bs, nb, H, K, h, split, sm_scale);
  return cudaGetLastError();
}

template <typename T>
int launch_dense(const void* q, const void* k, const void* v, const void* pos,
                 void* part_acc, void* part_ml, void* out, int B, int S,
                 int H, int K, int h, int window, int split, float sm_scale,
                 cudaStream_t stream) {
  const int G = H / K;
  auto launch = G <= 4   ? &launch_dense_g<T, 4>
                : G <= 8 ? &launch_dense_g<T, 8>
                         : &launch_dense_g<T, 16>;
  int err = launch(q, k, v, pos, part_acc, part_ml, B, S, H, K, h, window,
                   split, sm_scale, stream);
  if (err != cudaSuccess) return err;
  return launch_combine<T>(static_cast<const float*>(part_acc),
                           static_cast<const float2*>(part_ml),
                           static_cast<const int*>(pos), out, B, S, H, K, h,
                           window, split, stream);
}

template <typename T>
int launch_paged(const void* q, const void* k, const void* v,
                 const void* table, const void* pos, void* part_acc,
                 void* part_ml, void* out, int B, int bs, int nb, int H,
                 int K, int h, int split, float sm_scale,
                 cudaStream_t stream) {
  const int G = H / K;
  auto launch = G <= 4   ? &launch_paged_g<T, 4>
                : G <= 8 ? &launch_paged_g<T, 8>
                         : &launch_paged_g<T, 16>;
  int err = launch(q, k, v, table, pos, part_acc, part_ml, B, bs, nb, H, K,
                   h, split, sm_scale, stream);
  if (err != cudaSuccess) return err;
  return launch_combine<T>(static_cast<const float*>(part_acc),
                           static_cast<const float2*>(part_ml),
                           static_cast<const int*>(pos), out, B, nb * bs, H,
                           K, h, 0, split, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the cache and out share it).
// part_acc: B * K * n_split * G * h floats, part_ml: B * K * n_split * G
// float pairs, n_split = ceil(n_rows / split); both written before read.
extern "C" int flash_decode_dense(const void* q, const void* k, const void* v,
                                  const void* pos, void* part_acc,
                                  void* part_ml, void* out, int B, int S,
                                  int H, int K, int h, int window, int split,
                                  float sm_scale, int dtype, void* stream) {
  if (!shape_ok(B, H, K, h, split) || S <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dense<float>(q, k, v, pos, part_acc, part_ml, out, B, S, H,
                               K, h, window, split, sm_scale, s);
  if (dtype == 1)
    return launch_dense<__nv_bfloat16>(q, k, v, pos, part_acc, part_ml, out,
                                       B, S, H, K, h, window, split, sm_scale,
                                       s);
  return cudaErrorInvalidValue;
}

extern "C" int flash_decode_paged(const void* q, const void* k, const void* v,
                                  const void* table, const void* pos,
                                  void* part_acc, void* part_ml, void* out,
                                  int B, int bs, int nb, int H, int K, int h,
                                  int split, float sm_scale, int dtype,
                                  void* stream) {
  if (!shape_ok(B, H, K, h, split) || bs <= 0 || nb <= 0)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_paged<float>(q, k, v, table, pos, part_acc, part_ml, out, B,
                               bs, nb, H, K, h, split, sm_scale, s);
  if (dtype == 1)
    return launch_paged<__nv_bfloat16>(q, k, v, table, pos, part_acc, part_ml,
                                       out, B, bs, nb, H, K, h, split,
                                       sm_scale, s);
  return cudaErrorInvalidValue;
}
