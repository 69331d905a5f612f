// Windowed slab-gradient sum for Hopper (sm_90a): the CUDA port of the TPU
// kernel pointcloudsegmentation_tpu/ops/pallas/window_gather.py:dslab_bwd,
// the backward of the window gather (csrc/window_gather.cu).
//
//   dslab[t, s, :] = sum over (i in tile t, k) with lidx[i, k] == s
//                    of g[i, k, :],
//
// summed in float32 in ascending slot order and rounded once to g's dtype;
// an index outside [0, S), S = tile + 2*window, contributes nothing, as a
// one-hot row of zeros does on the TPU.  The caller overlap-adds the slabs
// into point rows.
//
// The TPU kernel builds an [S, T] one-hot per slot and multiplies it on the
// MXU.  Here the same sum is a segmented gather-sum over an inverse map
// (slab row -> the slots that read it), in two launches:
//
//   map  one CTA per tile builds a STABLE CSR of the tile's T*K slab
//        indices: start[t, 0..S] and order[t, 0..T*K), the tile-local slot
//        ids grouped by slab row, ascending inside each row; slots whose
//        index lies outside [0, S) follow start[t, S], also ascending.  It
//        is an LSD radix sort in shared memory of (row << slot bits | slot)
//        by the row's bits, 5 per pass (2 passes at S = 768): each thread
//        counts a run of consecutive keys into its own column of counts,
//        one raking scan over (digit, thread) gives every thread its
//        offsets, and each thread places its run in order.  No atomic and
//        no warp vote decides a position, so the order is a function of
//        lidx alone.
//   sum  one warp per (tile, slab row) sums its bucket's g rows in float32
//        in ascending slot order and stores the row once.  The rows are
//        copied by cp.async into shared memory, a batch of up to 32 rows in
//        flight at once, in pieces of 16 bytes where rows are whole 16-byte
//        words (every load of the warp then is one whole 128-byte piece of
//        a g row), else of 8 or 4; only a bf16 row of odd width is loaded
//        element by element.
//
// Every output element is written by exactly one thread in a fixed order, so
// two runs give bitwise-equal output, equal to the plain PyTorch version's
// (stable sort + segment_reduce, kernels/window_gather.py).
//
// What bounds it on the card: bytes.  At the flagship's level-0 K=32 conv
// it must read 33.5 MB of bf16 g and write 3.1 MB of dslab (0.011 ms at
// 3.35 TB/s).  The map reads the 1 MB of indices once per tile and writes
// 1 MB that the sum reads back from L2.  Where the time goes instead: the
// map is a chain of barrier-separated phases on one SM per tile (32 at
// that shape; spreading a tile over a cluster of CTAs was slower), and
// the sum's loads are random rows of g behind two dependent index loads
// (start, order), so a warp is bound by latency and the card by how many
// buckets are in flight; a bucket read by hundreds of slots is a chain of
// batches in one warp.  All index arithmetic is 32-bit, apart from one
// 64-bit tile base.
//
// The host entry points launch on the caller's stream, never synchronise,
// allocate nothing, and return the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMapThreads = 512;
constexpr int kDigitBits = 5;   // bucket bits sorted per pass of the map
constexpr int kDigits = 1 << kDigitBits;
constexpr int kHeld = 8;        // index loads a map thread keeps in flight
constexpr int kSumWarps = 4;    // buckets per sum CTA, one warp each
constexpr int kBatch = 32;      // slots of a bucket per batch
constexpr int kStages = 2;      // batches in flight per warp
constexpr int kPassBytes = 512; // bytes of a g row summed per pass
constexpr int kSmemMax = 227 * 1024;

// The sum of v over the threads before this one in the CTA (at most 32
// warps).  ws: 32 ints of scratch.
__device__ int block_exclusive_value(int v, int* ws) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();                       // ws is free
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  int off = 0;
  for (int w = 0; w < warp; ++w) off += ws[w];
  return off + incl - v;
}

// cnt[] with one padding word after every kDigits, so that a thread's
// raking run and the threads' columns both fall in distinct banks
__device__ __forceinline__ int cpad(int i) { return i + i / kDigits; }

// A slot's bucket: its slab row, or S for an index outside [0, S).
__device__ __forceinline__ int bucket(int x, int s) {
  return (unsigned)x < (unsigned)s ? x : s;
}

// keys[] with one padding word after every 32, so that the runs of
// consecutive items the threads own fall in distinct banks
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// One CTA per tile: a stable LSD radix sort of the tile's slots by bucket.
// A key is (bucket << slot_bits) | slot, first in slot order.  Each pass
// sorts by kDigitBits of the bucket: thread j owns a run of ipt
// consecutive keys and counts them per digit in its own column of cnt
// (digit-major, so cnt read in order is (digit, thread)); an exclusive
// scan of cnt in that order, each thread raking kDigits consecutive
// counts, gives every thread its offset in every digit's range, and each
// thread places its run in order.  Nothing is shared between the threads'
// runs but the scan, so the sort is stable and the result a function of
// lidx alone.
__global__ void __launch_bounds__(kMapThreads)
window_dslab_map_kernel(const int* __restrict__ lidx, int* __restrict__ start,
                        int* __restrict__ order, int tk, int s, int ipt,
                        int slot_bits, int passes) {
  extern __shared__ int smem[];
  const int nth = blockDim.x;
  const int padded = pad(tk) + 1;
  int* keys = smem;                        // [padded]
  int* tmp = keys + padded;                // [padded]
  int* cnt = tmp + padded;                 // [cpad(kDigits * nth)]
  int* ws = cnt + cpad(kDigits * nth);     // [32]
  const int t = blockIdx.x;
  const int* li = lidx + (size_t)t * tk;
  const int lo = min((int)threadIdx.x * ipt, tk);
  const int hi = min(lo + ipt, tk);
  // this thread's count of digit d: cnt[cpad(d * nth + threadIdx.x)]
  auto mine = [&](int d) -> int& { return cnt[cpad(d * nth + threadIdx.x)]; };

  // the tile's indices, kHeld loads of a thread in flight at once
  for (int e0 = threadIdx.x; e0 < tk; e0 += kHeld * nth) {
    int x[kHeld];
#pragma unroll
    for (int u = 0; u < kHeld; ++u) {
      const int e = e0 + u * nth;
      x[u] = e < tk ? __ldg(li + e) : 0;
    }
#pragma unroll
    for (int u = 0; u < kHeld; ++u) {
      const int e = e0 + u * nth;
      if (e < tk) keys[pad(e)] = (bucket(x[u], s) << slot_bits) | e;
    }
  }
  __syncthreads();

  for (int p = 0; p < passes; ++p) {
    const int shift = slot_bits + p * kDigitBits;
#pragma unroll
    for (int d = 0; d < kDigits; ++d) mine(d) = 0;
    for (int i = lo; i < hi; ++i)
      ++mine((keys[pad(i)] >> shift) & (kDigits - 1));
    __syncthreads();
    // exclusive scan of cnt in (digit, thread) order: thread r rakes the
    // kDigits counts from r * kDigits
    int run[kDigits];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kDigits; ++i) {
      run[i] = cnt[cpad(threadIdx.x * kDigits + i)];
      sum += run[i];
    }
    const int before = block_exclusive_value(sum, ws);
    int acc = before;
#pragma unroll
    for (int i = 0; i < kDigits; ++i) {
      cnt[cpad(threadIdx.x * kDigits + i)] = acc;
      acc += run[i];
    }
    __syncthreads();
    for (int i = lo; i < hi; ++i) {
      const int key = keys[pad(i)];
      tmp[pad(mine((key >> shift) & (kDigits - 1))++)] = key;
    }
    __syncthreads();
    int* swap = keys;
    keys = tmp;
    tmp = swap;
  }

  // order: the slots by (bucket, slot); start[r]: the first position of a
  // bucket >= r, written once each, at the run boundaries
  int* ord = order + (size_t)t * tk;
  int* st = start + (size_t)t * (s + 1);
  const int mask = (1 << slot_bits) - 1;
#pragma unroll 4
  for (int e = threadIdx.x; e < tk; e += nth) {
    const int key = keys[pad(e)];
    ord[e] = key & mask;
    const int r = key >> slot_bits;
    const int prev = e > 0 ? keys[pad(e - 1)] >> slot_bits : -1;
    for (int b = prev + 1; b <= r; ++b) st[b] = e;
    if (e == tk - 1)
      for (int b = r + 1; b <= s; ++b) st[b] = tk;
  }
}

// One word of g's row as float32 elements, and float32 elements rounded
// into one word: a 4-byte word holds 1 float32 or 2 bfloat16 (low half
// first), or a word is one element.
template <typename T, typename Wd>
__device__ __forceinline__ float elem(Wd w, int e);
template <>
__device__ __forceinline__ float elem<float, uint32_t>(uint32_t w, int) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16, uint32_t>(uint32_t w,
                                                               int e) {
  return __uint_as_float(e ? (w & 0xffff0000u) : (w << 16));
}
template <>
__device__ __forceinline__ float elem<float, float>(float w, int) {
  return w;
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16, __nv_bfloat16>(
    __nv_bfloat16 w, int) {
  return __bfloat162float(w);
}

template <typename T, typename Wd>
__device__ __forceinline__ Wd pack(const float* v);
template <>
__device__ __forceinline__ uint32_t pack<float, uint32_t>(const float* v) {
  return __float_as_uint(v[0]);
}
template <>
__device__ __forceinline__ uint32_t pack<__nv_bfloat16, uint32_t>(
    const float* v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16);
}
template <>
__device__ __forceinline__ float pack<float, float>(const float* v) {
  return v[0];
}
template <>
__device__ __forceinline__ __nv_bfloat16 pack<__nv_bfloat16, __nv_bfloat16>(
    const float* v) {
  return __float2bfloat16_rn(v[0]);
}

// One asynchronous copy of B = 16, 8 or 4 bytes from global to shared
// memory (16 bypasses L1; the smaller sizes must go through it).
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(B)
                 : "memory");
}

// One warp per (tile, slab row) bucket.  The bucket's slots go in batches
// of 32, one order entry per lane, loaded two batches ahead; a batch's g
// rows (one pass of up to 512 bytes of each) are copied into the warp's
// ring in shared memory, two batches in flight, and then summed: lane l
// owns the words l, l+32, ... of the pass and adds the batch's rows into
// its float32 sums in ascending slot order.  PIECE > 0: rows are whole
// PIECE-byte pieces (16, 8 or 4: the largest that divides the row and g's
// alignment), so the copies are PIECE-byte cp.async and a word is 4 bytes;
// PIECE 0 (a bf16 row of odd width): plain element loads, one row at a
// time, with nothing in flight.
template <typename T, typename Wd, int PIECE>
__global__ void __launch_bounds__(kSumWarps * 32)
window_dslab_sum_kernel(const T* __restrict__ g, const int* __restrict__ start,
                        const int* __restrict__ order, T* __restrict__ dslab,
                        int tk, int s, int f, int buckets) {
  extern __shared__ __align__(16) unsigned char sum_smem[];
  constexpr int kE = sizeof(Wd) / sizeof(T);      // elements per word
  constexpr int kPass = kPassBytes / sizeof(Wd);  // words per pass
  constexpr int kOwn = kPass / 32;                // words per lane per pass
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bkt = blockIdx.x * kSumWarps + warp;
  if (bkt >= buckets) return;
  const int rw = f / kE;                          // words per row
  const int cmax = min(rw, kPass);
  Wd* ring = reinterpret_cast<Wd*>(sum_smem) + warp * kStages * kBatch * cmax;
  const int t = bkt / s;
  const int a = __ldg(start + bkt + t);           // start[t, r], r = bkt - t*s
  const int b = __ldg(start + bkt + t + 1);
  const int nb = (b - a + kBatch - 1) / kBatch;
  const int* ord = order + (size_t)t * tk;
  const Wd* gt = reinterpret_cast<const Wd*>(g) + (size_t)t * tk * rw;
  Wd* out = reinterpret_cast<Wd*>(dslab) + (size_t)bkt * rw;
  // this lane's order entry of a batch (0 past the bucket)
  auto slot_of = [&](int batch) {
    const int i = a + batch * kBatch + lane;
    return i < b ? __ldg(ord + i) : 0;
  };

  for (int c0 = 0; c0 < rw; c0 += kPass) {
    const int cw = min(kPass, rw - c0);
    auto fetch = [&](int batch, int slot) {
      Wd* dst = ring + (batch % kStages) * kBatch * cmax;
      const int nr = min(kBatch, b - a - batch * kBatch);
      if constexpr (PIECE > 0) {
        // PIECE-byte pieces: lane's (row, piece) steps by constants
        const int pv = cw * (int)sizeof(Wd) / PIECE;
        const int dj = 32 / pv, dc = 32 - dj * pv;
        int j = lane / pv, c = lane - j * pv;
        for (int p = lane; p < kBatch * pv; p += 32) {
          const int sl = __shfl_sync(0xffffffffu, slot, j);
          if (j < nr)
            cp_async<PIECE>(
                reinterpret_cast<char*>(dst + j * cw) + c * PIECE,
                reinterpret_cast<const char*>(gt + sl * rw + c0) + c * PIECE);
          j += dj;
          c += dc;
          if (c >= pv) {
            c -= pv;
            ++j;
          }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      } else {
        for (int j = 0; j < nr; ++j) {
          const int sl = __shfl_sync(0xffffffffu, slot, j);
          for (int c = lane; c < cw; c += 32)
            dst[j * cw + c] = gt[sl * rw + c0 + c];
        }
      }
    };
    float acc[kOwn * kE];
#pragma unroll
    for (int m = 0; m < kOwn * kE; ++m) acc[m] = 0.0f;
    for (int batch = 0; batch < nb && batch < kStages; ++batch)
      fetch(batch, slot_of(batch));
    int next = slot_of(kStages);
    for (int batch = 0; batch < nb; ++batch) {
      if constexpr (PIECE > 0) {
        // the batch's group is done when at most the later ones pend
        if (nb - batch >= kStages)
          asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1)
                       : "memory");
        else
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncwarp();
      const Wd* src = ring + (batch % kStages) * kBatch * cmax;
      const int nr = min(kBatch, b - a - batch * kBatch);
#pragma unroll 4
      for (int j = 0; j < nr; ++j) {
#pragma unroll
        for (int m = 0; m < kOwn; ++m) {
          if (lane + 32 * m < cw) {
            const Wd x = src[j * cw + lane + 32 * m];
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[m * kE + e] += elem<T, Wd>(x, e);
          }
        }
      }
      __syncwarp();
      if (batch + kStages < nb) {
        fetch(batch + kStages, next);
        next = slot_of(batch + kStages + 1);
      }
    }
#pragma unroll
    for (int m = 0; m < kOwn; ++m)
      if (lane + 32 * m < cw) out[c0 + lane + 32 * m] = pack<T, Wd>(acc + m * kE);
  }
}

template <typename T, typename Wd, int PIECE>
int launch_sum(const void* g, const int* start, const int* order, void* dslab,
               int buckets, int tk, int s, int f, cudaStream_t stream) {
  const int rw = f / (int)(sizeof(Wd) / sizeof(T));
  const int pass_words = kPassBytes / (int)sizeof(Wd);
  const size_t smem = (size_t)kSumWarps * kStages * kBatch *
                      (rw < pass_words ? rw : pass_words) * sizeof(Wd);
  const cudaError_t err = cudaFuncSetAttribute(
      window_dslab_sum_kernel<T, Wd, PIECE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (buckets + kSumWarps - 1) / kSumWarps;
  window_dslab_sum_kernel<T, Wd, PIECE><<<blocks, kSumWarps * 32, smem,
                                          stream>>>(
      static_cast<const T*>(g), start, order, static_cast<T*>(dslab), tk, s,
      f, buckets);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_sum(const void* g, const int* start, const int* order,
                 void* dslab, int nt, int tk, int s, int f,
                 cudaStream_t stream) {
  const long long buckets = (long long)nt * s;
  if (buckets * f >= (1ll << 31) || (long long)tk * f >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  // cp.async pieces of 16, 8 or 4 bytes and 4-byte words where rows are
  // whole 4-byte words; plain element loads for odd bf16 rows
  const uintptr_t align = (uintptr_t)g | (uintptr_t)dslab;
  const size_t row = (size_t)f * sizeof(T);
  if (align % 16 == 0 && row % 16 == 0)
    return launch_sum<T, uint32_t, 16>(g, start, order, dslab, (int)buckets,
                                       tk, s, f, stream);
  if (align % 8 == 0 && row % 8 == 0)
    return launch_sum<T, uint32_t, 8>(g, start, order, dslab, (int)buckets,
                                      tk, s, f, stream);
  if (align % 4 == 0 && row % 4 == 0)
    return launch_sum<T, uint32_t, 4>(g, start, order, dslab, (int)buckets,
                                      tk, s, f, stream);
  return launch_sum<T, T, 0>(g, start, order, dslab, (int)buckets, tk, s, f,
                             stream);
}

bool valid_geometry(int n, int k, int tile, int window) {
  return n > 0 && k > 0 && tile > 0 && window >= 0 && n % tile == 0 &&
         (long long)tile * k < (1ll << 31) &&
         (long long)n * k < (1ll << 31);
}

}  // namespace

// The inverse map of each tile's slab indices.  lidx [n, k] int32; start
// [n / tile, S + 1] and order [n / tile, tile * k] int32, S = tile + 2 *
// window, all contiguous.
extern "C" int pcs_window_dslab_map(const void* lidx, void* start,
                                    void* order, int n, int k, int tile,
                                    int window, void* stream) {
  if (!valid_geometry(n, k, tile, window)) return (int)cudaErrorInvalidValue;
  const int s = tile + 2 * window;
  const int tk = tile * k;
  // a key holds the bucket (0..S) above the slot (0..tk-1)
  int slot_bits = 1, row_bits = 1;
  while ((1 << slot_bits) < tk) ++slot_bits;
  while ((1 << row_bits) <= s) ++row_bits;
  if (slot_bits + row_bits > 31) return (int)cudaErrorInvalidValue;
  const int passes = (row_bits + kDigitBits - 1) / kDigitBits;
  // as many threads (up to kMapThreads) as the counts leave room for
  const long long keys = 2ll * (tk + (tk >> 5) + 1);
  auto bytes = [&](int th) {
    return (keys + (long long)(kDigits + 1) * th + 32) *
           (long long)sizeof(int);
  };
  int nth = kMapThreads;
  while (nth > 32 && bytes(nth) > kSmemMax) nth /= 2;
  if (bytes(nth) > kSmemMax) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)bytes(nth);
  const cudaError_t err = cudaFuncSetAttribute(
      window_dslab_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ipt = (tk + nth - 1) / nth;
  window_dslab_map_kernel<<<n / tile, nth, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lidx), static_cast<int*>(start),
      static_cast<int*>(order), tk, s, ipt, slot_bits, passes);
  return (int)cudaGetLastError();
}

// The sums over a map from pcs_window_dslab_map.  dtype: 0 float32, 1
// bfloat16.  g [n, k, f]; start, order as above; dslab [n / tile, S, f].
extern "C" int pcs_window_dslab_sum(const void* g, const void* start,
                                    const void* order, void* dslab, int n,
                                    int k, int f, int tile, int window,
                                    int dtype, void* stream) {
  if (!valid_geometry(n, k, tile, window) || f <= 0)
    return (int)cudaErrorInvalidValue;
  const int s = tile + 2 * window;
  const int nt = n / tile;
  const int tk = tile * k;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(start);
  const int* op = static_cast<const int*>(order);
  switch (dtype) {
    case 0:
      return dispatch_sum<float>(g, sp, op, dslab, nt, tk, s, f, st);
    case 1:
      return dispatch_sum<__nv_bfloat16>(g, sp, op, dslab, nt, tk, s, f, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
