// Windowed slab-gradient sum for Hopper (sm_90a): the CUDA port of the TPU
// kernel pointcloudsegmentation_tpu/ops/pallas/window_gather.py:dslab_bwd,
// the backward of the window gather (csrc/window_gather.cu).
//
//   dslab[t, s, :] = sum over (i in tile t, k) with lidx[i, k] == s
//                    of g[i, k, :],
//
// summed in float32 and rounded once to g's dtype; an index outside
// [0, tile + 2*window) contributes nothing, as a one-hot row of zeros does
// on the TPU.  The caller overlap-adds the slabs into point rows.
//
// The TPU kernel builds an [S, T] one-hot per slot and multiplies it on the
// MXU.  Here the same sum is a segmented gather-sum over an inverse map
// (slab row -> the slots that read it), the CSR form the reference system's
// own CUDA ops use, and it is deterministic without float atomics:
//
//   1. each CTA owns one tile and a range of slab rows; it counts the
//      tile's T*K slab indices per row in shared memory (integer atomics),
//   2. scans the counts into bucket starts (one warp),
//   3. places each slot id into its row's bucket (integer atomics, so the
//      order inside a bucket is arbitrary) and
//   4. sorts every bucket by slot id, which fixes the summation order;
//   5. threads over (slab row, 16-byte column vector) sum their bucket's g
//      rows in ascending slot order in float32 and write the row once.
//
// Every output element is written by exactly one thread, so two runs give
// bitwise-equal output, and the sum order (ascending slot id) is the one
// the plain PyTorch version's stable sort + segment_reduce uses.
//
// What bounds it on the card: the index work, not bytes.  At the flagship's
// level-0 K=32 conv it must read 33.5 MB of bf16 g and write 3.1 MB of
// dslab, yet on an H100 it moves only about 300 GB/s there and its time
// hardly falls with K.  Each tile's slab rows are split over several CTAs
// (about two CTAs on every SM), and every one of them rebuilds the map from
// all T*K of the tile's indices, reading them twice (count, place), with
// shared-memory atomics and a serial sort of each of its buckets; the long
// buckets of rows read by many slots are then summed by one thread each.
// The loads of a bucket are issued four at a time.  The fix to try next:
// build the inverse map once per tile (one pass, or a separate tiny
// kernel) and let the row-split CTAs only sum.
//
// The host entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements moved as one aligned load or store
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
window_dslab_kernel(const T* __restrict__ g, const int* __restrict__ lidx,
                    T* __restrict__ dslab, int tile, int k, int s, int f,
                    int rows_per_cta) {
  using P = Pack<T, VEC>;
  extern __shared__ int smem[];
  const int tk = tile * k;
  const int t = blockIdx.x;
  const int r0 = blockIdx.y * rows_per_cta;
  const int nr = min(rows_per_cta, s - r0);
  if (nr <= 0) return;
  int* start = smem;                 // [nr + 1] bucket starts
  int* cursor = start + nr + 1;      // [nr] counts, then placement cursors
  int* order = cursor + nr;          // [tk] slot ids grouped by bucket
  const int* li = lidx + (long long)t * tk;

  // 1. count the tile's slots per slab row of this CTA's range
  for (int r = threadIdx.x; r < nr; r += kThreads) cursor[r] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < tk; e += kThreads) {
    const unsigned r = (unsigned)li[e] - (unsigned)r0;
    if (r < (unsigned)nr) atomicAdd(&cursor[r], 1);
  }
  __syncthreads();

  // 2. exclusive scan: each lane of warp 0 scans a contiguous run of rows
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (nr + 31) / 32;
    const int a = min(lane * per, nr);
    const int b = min(a + per, nr);
    int sum = 0;
    for (int r = a; r < b; ++r) sum += cursor[r];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - sum;
    for (int r = a; r < b; ++r) {
      const int c = cursor[r];
      start[r] = run;
      cursor[r] = run;
      run += c;
    }
    if (lane == 31) start[nr] = incl;
  }
  __syncthreads();

  // 3. place slot ids into their buckets (order inside a bucket arbitrary)
  for (int e = threadIdx.x; e < tk; e += kThreads) {
    const unsigned r = (unsigned)li[e] - (unsigned)r0;
    if (r < (unsigned)nr) order[atomicAdd(&cursor[r], 1)] = e;
  }
  __syncthreads();

  // 4. sort each bucket by slot id: this fixes the summation order
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    const int a = start[r];
    const int b = start[r + 1];
    for (int i = a + 1; i < b; ++i) {
      const int v = order[i];
      int j = i - 1;
      while (j >= a && order[j] > v) {
        order[j + 1] = order[j];
        --j;
      }
      order[j + 1] = v;
    }
  }
  __syncthreads();

  // 5. per (row, column vector): ascending-slot float32 sum, one store
  const int fv = f / VEC;
  const P* gp = reinterpret_cast<const P*>(g) + (long long)t * tk * fv;
  P* out = reinterpret_cast<P*>(dslab) + ((long long)t * s + r0) * fv;
  for (int item = threadIdx.x; item < nr * fv; item += kThreads) {
    const int r = item / fv;
    const int c = item - r * fv;
    const int a = start[r];
    const int b = start[r + 1];
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    int i = a;
    for (; i + kUnroll <= b; i += kUnroll) {
      P x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        x[u] = gp[(long long)order[i + u] * fv + c];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += to_f32(x[u].v[v]);
    }
    for (; i < b; ++i) {
      const P x = gp[(long long)order[i] * fv + c];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += to_f32(x.v[v]);
    }
    P y;
#pragma unroll
    for (int v = 0; v < VEC; ++v) y.v[v] = from_f32<T>(acc[v]);
    out[(long long)r * fv + c] = y;
  }
}

template <typename T, int VEC>
int launch(const void* g, const int* lidx, void* dslab, int n, int k, int f,
           int tile, int window, cudaStream_t stream) {
  const int s = tile + 2 * window;
  const int nt = n / tile;
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (sm_count <= 0) sm_count = 132;
  }
  // aim for two CTAs per SM; each CTA keeps at least 32 slab rows
  int splits = (2 * sm_count + nt - 1) / nt;
  const int max_splits = s >= 32 ? s / 32 : 1;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  const int rows_per_cta = (s + splits - 1) / splits;
  splits = (s + rows_per_cta - 1) / rows_per_cta;
  const size_t smem =
      (size_t)(2 * rows_per_cta + 1 + (long long)tile * k) * sizeof(int);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_dslab_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(nt, splits);
  window_dslab_kernel<T, VEC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), lidx, static_cast<T*>(dslab), tile, k, s, f,
      rows_per_cta);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* g, const int* lidx, void* dslab, int n, int k,
             int f, int tile, int window, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t align = (uintptr_t)g | (uintptr_t)dslab;
  if (f % kVec == 0 && align % 16 == 0)
    return launch<T, kVec>(g, lidx, dslab, n, k, f, tile, window, stream);
  return launch<T, 1>(g, lidx, dslab, n, k, f, tile, window, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  g [n, k, f], lidx [n, k] int32,
// dslab [n / tile, tile + 2 * window, f], all contiguous.
extern "C" int pcs_window_dslab(const void* g, const void* lidx, void* dslab,
                                int n, int k, int f, int tile, int window,
                                int dtype, void* stream) {
  if (n <= 0 || k <= 0 || f <= 0 || tile <= 0 || window < 0 ||
      n % tile != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* li = static_cast<const int*>(lidx);
  switch (dtype) {
    case 0:
      return dispatch<float>(g, li, dslab, n, k, f, tile, window, st);
    case 1:
      return dispatch<__nv_bfloat16>(g, li, dslab, n, k, f, tile, window,
                                     st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
