// Windowed slab gather for Hopper (sm_90a): the CUDA port of the TPU kernel
// pointcloudsegmentation_tpu/ops/pallas/window_gather.py:gather_fwd.
//
//   out[i, k, :] = slab_t[lidx[i, k], :],   t = i / tile,
//   slab_t[r, :] = feats[t*tile - window + r, :]  (zero outside [0, n)),
//
// with lidx in [0, tile + 2*window); an index outside that range reads zeros,
// as the TPU kernel's one-hot rows do.  The copy is byte-exact for any dtype:
// rows move as opaque 16-, 4-, 2- or 1-byte words.
//
// What bounds it on the card: memory.  The output is N*K*F elements (about
// 33.5 MB per level-0 conv of the flagship in bf16) against a slab read of
// only (tile + 2*window)*F per tile, and there is no arithmetic.  Design: one
// CTA per (tile, column chunk, row split) stages its slab columns in shared
// memory once (zero rows where the slab overhangs the block), then streams
// the T*K output rows out of shared memory with 16-byte stores.  Column
// chunks keep the staged slab within 48 KB, so up to four CTAs share an SM;
// row splits add CTAs where tiles x chunks alone would not fill the card.
// The TPU kernel's 3-way bf16 split of f32 is not carried over: it exists
// only because the TPU moves rows through one-hot matmuls.
//
// The host entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlabBytes = 48 * 1024;

template <typename V>
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const V* __restrict__ feats, const int* __restrict__ lidx,
                     V* __restrict__ out, int n, int k, int tile, int window,
                     int row_vecs, int chunk_vecs, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* slab = reinterpret_cast<V*>(smem_raw);
  const int s = tile + 2 * window;
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * chunk_vecs;
  const int cw = min(chunk_vecs, row_vecs - c0);
  const long long base = (long long)t * tile - window;

  const V zero{};
  for (int e = threadIdx.x; e < s * cw; e += kThreads) {
    const int r = e / cw;
    const int c = e - r * cw;
    const long long g = base + r;
    slab[e] = (g >= 0 && g < n) ? feats[g * row_vecs + c0 + c] : zero;
  }
  __syncthreads();

  const int i0 = t * tile + blockIdx.z * rows_per_cta;
  const int i1 = min(i0 + rows_per_cta, (t + 1) * tile);
  if (i0 >= i1) return;
  const long long first = (long long)i0 * k;  // flattened (i, k) slot index
  const long long total = (long long)(i1 - i0) * k * cw;
  for (long long e = threadIdx.x; e < total; e += kThreads) {
    const long long slot = e / cw;
    const int c = (int)(e - slot * cw);
    const int l = lidx[first + slot];
    out[(first + slot) * row_vecs + c0 + c] =
        ((unsigned)l < (unsigned)s) ? slab[l * cw + c] : zero;
  }
}

template <typename V>
int launch(const void* feats, const int* lidx, void* out, int n, int k,
           int row_bytes, int tile, int window, cudaStream_t stream) {
  const int row_vecs = row_bytes / (int)sizeof(V);
  const int s = tile + 2 * window;
  int chunk_vecs = kSlabBytes / (s * (int)sizeof(V));
  if (chunk_vecs < 1) chunk_vecs = 1;
  if (chunk_vecs > row_vecs) chunk_vecs = row_vecs;
  const size_t smem = (size_t)s * chunk_vecs * sizeof(V);
  if (smem > kSlabBytes) {
    cudaError_t err = cudaFuncSetAttribute(
        window_gather_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (sm_count <= 0) sm_count = 132;
  }
  const int nt = n / tile;
  const int col_chunks = (row_vecs + chunk_vecs - 1) / chunk_vecs;
  // aim for two CTAs per SM; each split keeps at least 32 rows
  const int want = 2 * sm_count;
  int splits = (want + nt * col_chunks - 1) / (nt * col_chunks);
  const int max_splits = tile >= 32 ? tile / 32 : 1;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  const int rows_per_cta = (tile + splits - 1) / splits;
  dim3 grid(nt, col_chunks, splits);
  window_gather_kernel<V><<<grid, kThreads, smem, stream>>>(
      static_cast<const V*>(feats), lidx, static_cast<V*>(out), n, k, tile,
      window, row_vecs, chunk_vecs, rows_per_cta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pcs_window_gather(const void* feats, const void* lidx,
                                 void* out, int n, int k, int row_bytes,
                                 int tile, int window, void* stream) {
  if (n <= 0 || k <= 0 || tile <= 0 || window < 0 || row_bytes <= 0 ||
      n % tile != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* li = static_cast<const int*>(lidx);
  const uintptr_t align = (uintptr_t)feats | (uintptr_t)out;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4>(feats, li, out, n, k, row_bytes, tile, window, st);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch<uint32_t>(feats, li, out, n, k, row_bytes, tile, window, st);
  if (row_bytes % 2 == 0 && align % 2 == 0)
    return launch<uint16_t>(feats, li, out, n, k, row_bytes, tile, window, st);
  return launch<uint8_t>(feats, li, out, n, k, row_bytes, tile, window, st);
}
