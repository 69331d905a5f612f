// Windowed slab gather for Hopper (sm_90a): the CUDA port of the TPU kernel
// pointcloudsegmentation_tpu/ops/pallas/window_gather.py:gather_fwd.
//
//   out[i, k, :] = slab_t[lidx[i, k], :],   t = i / tile,
//   slab_t[r, :] = feats[t*tile - window + r, :]  (zero outside [0, n)),
//
// with lidx in [0, S), S = tile + 2*window; an index outside that range
// reads zeros, as the TPU kernel's one-hot rows do.  The copy is byte-exact
// for any dtype: rows move as opaque 16-, 4-, 2- or 1-byte words.  The TPU
// kernel's 3-way bf16 split of f32 is not carried over: it exists only
// because the TPU moves rows through one-hot matmuls.
//
// What bounds it on the card: memory.  The output is N*K*F elements (33.5 MB
// per level-0 K=32 conv of the flagship in bf16) against a slab read of only
// S*F per tile, and there is no arithmetic.  Design:
//
// - Whole rows: a CTA stages the full rows of its tile's slab, so every
//   output row is written by one CTA, in full sectors.  Two slab buffers
//   where two fit in shared memory (the F=64 bf16 conv's 768 x 128 B = 96
//   KB, the search's 16-byte xyzm rows), one where only one fits (F=96 and
//   F=128 bf16: 144 and 192 KB); only a slab too wide for one buffer is
//   cut into column chunks of whole 128-byte lines.
// - Staging by the Tensor Memory Accelerator: whole rows of a tile's slab
//   are one contiguous range of feats, so one cp.async.bulk global->shared
//   moves it and completes on an mbarrier; threads only fill the zero rows
//   where the slab overhangs the block.  Column chunks and rows that are
//   not whole 16-byte words are staged by the threads.
// - A persistent grid: one CTA per SM slot walks over a contiguous run of
//   (chunk, tile, point) work, split only where the tile or the chunk
//   changes, so a CTA stages each slab once; with two buffers the next
//   slab's copy overlaps the current slab's stores.
// - Streaming: each warp loads the indices of 32 consecutive slots (one
//   coalesced load per slot) and hands each to the lanes that write that
//   slot's row with __shfl_sync; a row goes out as consecutive 16-byte
//   stores.  All index arithmetic in the loop is 32-bit, with no division:
//   a lane's (slot, column) steps by constants, whatever the row's width.
//
// The host entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBuffers = 2;
constexpr int kHeader = 128;        // the mbarriers, padding the slabs' start
constexpr int kSmemMax = 227 * 1024;
constexpr int kLine = 128;
constexpr int kMinPoints = 32;      // fewest points a CTA is given

struct Geometry {
  int n, k, tile, window, s;
  int row_vecs;     // row length in words
  int chunk_vecs;   // column chunk in words (the last chunk may be narrower)
  int chunks;
  int buffers;      // slab buffers per CTA, 1 or 2
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the TMA, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One piece of a CTA's work: points [p0, p1) of tile t, column chunk ch.
struct Item {
  int ch, t, p0, p1;
};

__device__ __forceinline__ Item item_at(const Geometry& g, int lo, int hi,
                                        int j) {
  // the work is (chunk, point) flattened; pieces end where a tile ends
  const int seg = lo / g.tile + j;
  const int a = max(lo, seg * g.tile);
  const int b = min(hi, (seg + 1) * g.tile);
  const int nt = g.n / g.tile;
  Item it;
  it.ch = seg / nt;
  it.t = seg - it.ch * nt;
  it.p0 = a - seg * g.tile;
  it.p1 = b - seg * g.tile;
  return it;
}

// Stage item `it`'s slab chunk into buf; every thread arrives on bar once.
template <typename V>
__device__ void stage(const V* __restrict__ feats, const Geometry& g,
                      const Item& it, V* buf, uint64_t* bar) {
  const int c0 = it.ch * g.chunk_vecs;
  const int cw = min(g.chunk_vecs, g.row_vecs - c0);
  const int g0 = it.t * g.tile - g.window;      // feats row of slab row 0
  const int r_lo = max(0, -g0);
  const int r_hi = min(g.s, g.n - g0);
  const V zero{};
  for (int e = threadIdx.x; e < r_lo * cw; e += blockDim.x) buf[e] = zero;
  for (int e = r_hi * cw + threadIdx.x; e < g.s * cw; e += blockDim.x)
    buf[e] = zero;
  if (sizeof(V) == 16 && cw == g.row_vecs) {
    // whole rows: one contiguous range of feats, one TMA copy
    const uint32_t bytes = (uint32_t)(r_hi - r_lo) * cw * 16u;
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar, bytes);
      bulk_load(buf + r_lo * cw, feats + (g0 + r_lo) * g.row_vecs, bytes,
                bar);
    } else {
      mbar_arrive(bar);
    }
  } else {
    for (int e = threadIdx.x; e < (r_hi - r_lo) * cw; e += blockDim.x) {
      const int r = r_lo + e / cw;
      const int c = e - (r - r_lo) * cw;
      buf[r * cw + c] = feats[(g0 + r) * g.row_vecs + c0 + c];
    }
    mbar_arrive(bar);
  }
}

// Write item `it`'s output rows from the staged slab chunk in buf.
template <typename V>
__device__ void stream(const int* __restrict__ lidx, V* __restrict__ out,
                       const Geometry& g, const Item& it, const V* buf) {
  const int c0 = it.ch * g.chunk_vecs;
  const int cw = min(g.chunk_vecs, g.row_vecs - c0);
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  // lane's (slot, column) for flat word lane of 32 slots x cw words, and
  // the step from one 32-word pass to the next
  const int slot0 = lane / cw;
  const int col0 = lane - slot0 * cw;
  const int dslot = 32 / cw;
  const int dcol = 32 - dslot * cw;
  const int first = (it.t * g.tile + it.p0) * g.k;
  const int last = (it.t * g.tile + it.p1) * g.k;
  const V zero{};
  for (int q0 = first + (threadIdx.x >> 5) * 32; q0 < last; q0 += nw * 32) {
    const int nv = min(32, last - q0);
    const int l = lane < nv ? lidx[q0 + lane] : 0;
    V* o = out + (size_t)q0 * g.row_vecs + c0;
    int slot = slot0, col = col0;
#pragma unroll 4
    for (int j = 0; j < cw; ++j) {
      const int idx = __shfl_sync(0xffffffffu, l, slot);
      if (slot < nv)
        o[slot * g.row_vecs + col] =
            (unsigned)idx < (unsigned)g.s ? buf[idx * cw + col] : zero;
      slot += dslot;
      col += dcol;
      if (col >= cw) {
        col -= cw;
        ++slot;
      }
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const V* __restrict__ feats, const int* __restrict__ lidx,
                     V* __restrict__ out, Geometry g) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  V* bufs = reinterpret_cast<V*>(smem_raw + kHeader);
  const int buf_vecs = g.s * g.chunk_vecs;
  const int total = g.chunks * g.n;
  const int lo = (int)((long long)blockIdx.x * total / gridDim.x);
  const int hi = (int)((long long)(blockIdx.x + 1) * total / gridDim.x);
  if (lo >= hi) return;
  const int items = (hi + g.tile - 1) / g.tile - lo / g.tile;

  if (threadIdx.x == 0) {
    for (int b = 0; b < kMaxBuffers; ++b) mbar_init(&bars[b], blockDim.x);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nb = g.buffers;
  for (int j = 0; j < items && j < nb; ++j)
    stage(feats, g, item_at(g, lo, hi, j), bufs + j * buf_vecs, &bars[j]);
  for (int j = 0; j < items; ++j) {
    const int b = j % nb;
    V* buf = bufs + b * buf_vecs;
    mbar_wait(&bars[b], (j / nb) & 1);
    stream(lidx, out, g, item_at(g, lo, hi, j), buf);
    if (j + nb < items) {
      // every read of buf (and write of its zero rows) is done before the
      // TMA writes it again
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      stage(feats, g, item_at(g, lo, hi, j + nb), buf, &bars[b]);
    }
  }
}

template <typename V>
int launch(const void* feats, const int* lidx, void* out, int n, int k,
           int row_bytes, int tile, int window, cudaStream_t stream) {
  Geometry g;
  g.n = n;
  g.k = k;
  g.tile = tile;
  g.window = window;
  g.s = tile + 2 * window;
  g.row_vecs = row_bytes / (int)sizeof(V);
  if ((long long)n * g.row_vecs >= (1ll << 31) ||
      (long long)n * k >= (1ll << 31) ||
      (long long)g.s * g.row_vecs >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  // whole rows, in two buffers where two slabs fit, else in one; where
  // not even one fits, two buffers of whole 128-byte lines (else of the
  // widest chunk that fits)
  const long long room = kSmemMax - kHeader;
  const long long slab = (long long)g.s * row_bytes;
  const long long vs = sizeof(V);
  g.buffers = kMaxBuffers;
  if (slab * kMaxBuffers <= room) {
    g.chunk_vecs = g.row_vecs;
  } else if (slab <= room) {
    g.chunk_vecs = g.row_vecs;
    g.buffers = 1;
  } else {
    const long long per_buf = room / kMaxBuffers;
    g.chunk_vecs = (int)(per_buf / ((long long)g.s * kLine)) * (kLine / vs);
    if (g.chunk_vecs == 0) g.chunk_vecs = (int)(per_buf / (g.s * vs));
    if (g.chunk_vecs == 0) return (int)cudaErrorInvalidValue;
  }
  g.chunks = (g.row_vecs + g.chunk_vecs - 1) / g.chunk_vecs;
  if ((long long)g.chunks * n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      kHeader + (size_t)g.buffers * g.s * g.chunk_vecs * sizeof(V);
  cudaError_t err = cudaFuncSetAttribute(
      window_gather_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (sm_count <= 0) sm_count = 132;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, window_gather_kernel<V>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int total = g.chunks * n;
  int grid = per_sm * sm_count;
  const int most = (total + kMinPoints - 1) / kMinPoints;
  if (grid > most) grid = most;
  window_gather_kernel<V><<<grid, kThreads, smem, stream>>>(
      static_cast<const V*>(feats), lidx, static_cast<V*>(out), g);
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
