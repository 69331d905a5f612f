// Fused windowed PointNet conv, forward, for Hopper (sm_90a): the CUDA port
// of the TPU kernel
// pointcloudsegmentation_tpu/ops/pallas/fused_conv.py:fused_window_conv_fwd.
//
// For point i of tile t = i / tile and each slot k (slab-local index
// l = lidx[i, k], slab row t*tile + l of the padded stream fpx):
//
//   g     = fpx[t*tile + l]  = [nbr_proj (sumd) | xyz_hi (3) | xyz_mid (3)],
//           a zero row when l is outside [0, tile + 2*window),
//   sx    = T(g_hi + g_mid - xyz_i),
//   base  = (g[:sumd] + cen[i]) + sx . wsx                       (float32),
//   a_0   = base[layer 0],  h_0 = T(relu(a_0)),
//   a_l   = base[layer l] + [h_0 | ... | h_{l-1}] . whid_l,
//   out[i]= T(max over slots with l >= 0 of a_last), -1e30 if there is none,
//
// with T the compute dtype (float32 or bfloat16) and every product summed in
// float32.  The TPU kernel moves each slot's row with an [S, T] one-hot
// matmul on the MXU; here a slot's row is an indexed load.
//
// What bounds it on the card (the bench's two convs, bf16, T = W = 256).
// Level 0 (N = 8192, K = 32, dims 8, 8, 16, 32) moves about 4 MB, 1.2 us at
// 3.35 TB/s; its 126,581 valid slots need 0.41 GFLOP, 0.4 us at the bf16
// tensor cores' 989 TFLOP/s: bytes bound it.  Level 1 (N = 4096, dims 16,
// 16, 32, 64) moves about 3.4 MB (1.0 us) and needs 1.38 GFLOP (1.4 us):
// operations bound it.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 8, CUDA-graph
// replays) the first kernel (one warp per point, one lane per slot, float32
// FMAs on the CUDA cores) took 0.11 ms at level 0 and 0.25 ms at level 1,
// about 1% of the bound; this one takes 0.0166 and 0.0230 ms, 0.07 and 0.06
// of it.  What held the first back, read from its source, not from
// hardware counters:
//   1. staging was latency-bound: each warp copied its 32 slab rows one
//      2-byte element at a time, with an integer division and a dependent
//      shared-memory index load per element, and every point of a tile
//      staged again rows its neighbours had staged;
//   2. every multiply-add ran in float32 on the CUDA cores, three
//      shared-memory loads per 8 FMAs: shared-memory bound;
//   3. every output column paid its own epilogue (weights, base, centre and a
//      5-step shuffle max);
//   4. invalid slots cost as much as valid ones.
//
// The bfloat16 kernel (conv_mma_kernel) does instead:
//   - one CTA per contiguous run of points inside one tile, each tile split
//     into enough runs to fill every SM (levels 0 and 1 have only 32 and 16
//     tiles); one warp per point, its K slots as ceil(K / 16) groups of 16
//     rows, the M of mma.sync.m16n8k16; 32 warps a CTA at the narrow widths
//     and 16 at the wide ones, so latency has other warps to hide it;  (1)
//   - the CTA reduces its valid in-slab indices to [min, max] and stages
//     only those slab rows, once, with one cp.async.bulk on an mbarrier
//     (threads copy in 4- or 2-byte words where the range is not 16-byte
//     aligned); a range too long for the buffer is read from global memory
//     (L2) through the same generic row pointers.  Each warp copies its
//     next point's centre row, indices and xyz into its own shared memory
//     with cp.async while it works on the current point;              (1)
//   - the products run on the tensor cores: the accumulator starts at
//     g + cen (one float32 add), sx . wsx is one m16n8k8 per 8 columns (sx
//     rounded to bf16 as the TPU kernel rounds it, wsx bf16: both exact),
//     and each layer adds [h_0 | ...] . whid_l with mma.sync m16n8k16
//     (m16n8k8 for an odd 8-column tail), float32 sums.  The C fragment of
//     m16n8 is half an A fragment of m16k16, so relu'd hidden states are
//     packed to bf16 in registers and feed the next layers from there; the
//     concatenation is a list of register tiles.  Widths are padded to 8
//     with zero weights; padded columns stay 0 and are never written.  The
//     B fragments are packed once per CTA into shared memory in the order
//     the lanes read them, one 8-byte load per k16 step;               (2)
//   - the layer geometry is compile-time for the flagship's widths (8, 8,
//     16, 32; 16, 16, 32, 64; 16, 16, 16, 48) and the tests' (4, 4, 8), so
//     every column, tile and fragment offset folds and the layer loop
//     unrolls; other widths read it from a table in shared memory (read
//     from runtime-indexed kernel parameters instead, the integer and
//     branch work cost more than the mma: 0.0378 ms at level 0 on the
//     same card);                                                       (2)
//   - the epilogue is per 8-column tile, not per column: the masked max over
//     a thread's two rows, kept across the point's groups, then 3 xor
//     shuffles per value, then one 4-byte store per lane;              (3)
//   - a group of 16 slots whose indices are all negative is skipped after
//     one warp vote: it contributes -1e30, as computing it would.      (4)
//
// The float32 kernel (conv_f32_kernel) keeps the first design: float32 is
// not the bench's or the models' compute dtype.
//
// The host entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kMaxLayers = 8;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSmemMax = 227 * 1024;
constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// float32: one warp per point, one lane per slot, FMAs on the CUDA cores.

constexpr int kChunk = 8;  // output columns a lane accumulates at once

// Passed as a __grid_constant__ kernel parameter, so the per-layer arrays
// are indexed in parameter memory without a local copy.
struct Params {
  const void* fpx;
  const void* cen;
  const float* xyzc;
  const int* lidx;
  const void* wsx;
  const void* whid[kMaxLayers];  // whid[l], l >= 1: [offs[l], dims[l]]
  void* out;
  int n, k, tile, window, nl, sumd;
  int dims[kMaxLayers];
  int offs[kMaxLayers + 1];
  int wofs[kMaxLayers];  // float offset of layer l's kernel in shared memory
  int dpad[kMaxLayers];  // its row length there (dims[l] rounded up to 8)
  int wfloats;           // floats of wsx and the kernels in shared memory
  int rs, hs;            // per-lane row and hidden strides, in floats
  int rows_bytes, hid_bytes, warp_bytes;
};

__global__ void __launch_bounds__(kThreads)
conv_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);

  // weights, once per CTA
  const float* wsx = static_cast<const float*>(p.wsx);
  for (int e = threadIdx.x; e < 3 * p.sumd; e += kThreads) wsm[e] = wsx[e];
  for (int l = 1; l < p.nl; ++l) {
    const float* w = static_cast<const float*>(p.whid[l]);
    const int d = p.dims[l], dp = p.dpad[l];
    float* dst = wsm + p.wofs[l];
    for (int e = threadIdx.x; e < p.offs[l] * dp; e += kThreads) {
      const int j = e / dp, c = e - j * dp;
      dst[e] = c < d ? w[j * d + c] : 0.f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* mine = smem + p.wfloats * 4 + warp * p.warp_bytes;
  float* rows = reinterpret_cast<float*>(mine);
  float* hid = reinterpret_cast<float*>(mine + p.rows_bytes);
  int* lks = reinterpret_cast<int*>(mine + p.rows_bytes + p.hid_bytes);
  float* best = reinterpret_cast<float*>(lks + 32);

  const float* fpx = static_cast<const float*>(p.fpx);
  const float* cen = static_cast<const float*>(p.cen);
  float* out = static_cast<float*>(p.out);
  const int s = p.tile + 2 * p.window;
  const int sumd = p.sumd, row_len = sumd + 6, nl = p.nl;
  const int dout = p.dims[nl - 1];
  const float* wsx0 = wsm;
  const float* wsx1 = wsm + sumd;
  const float* wsx2 = wsm + 2 * sumd;
  const float* row = rows + lane * p.rs;
  float* h = hid + lane * p.hs;

  for (int i = blockIdx.x * kWarps + warp; i < p.n;
       i += gridDim.x * kWarps) {
    const long long slab0 = (long long)(i / p.tile) * p.tile;
    const float xi0 = p.xyzc[4 * i], xi1 = p.xyzc[4 * i + 1],
                xi2 = p.xyzc[4 * i + 2];
    const float* ceni = cen + (long long)i * sumd;
    for (int k0 = 0; k0 < p.k; k0 += 32) {
      const bool active = k0 + lane < p.k;
      const int lk = active ? p.lidx[(long long)i * p.k + k0 + lane] : -1;
      __syncwarp();  // the previous group is done with rows and lks
      lks[lane] = lk;
      __syncwarp();
      for (int e = lane; e < 32 * row_len; e += 32) {
        const int r = e / row_len, c = e - r * row_len;
        const int l = lks[r];
        rows[r * p.rs + c] =
            (unsigned)l < (unsigned)s ? fpx[(slab0 + l) * row_len + c] : 0.f;
      }
      __syncwarp();

      const float sx0 = (row[sumd] + row[sumd + 3]) - xi0;
      const float sx1 = (row[sumd + 1] + row[sumd + 4]) - xi1;
      const float sx2 = (row[sumd + 2] + row[sumd + 5]) - xi2;
      for (int l = 0; l < nl; ++l) {
        const int din = p.offs[l], d = p.dims[l], dp = p.dpad[l];
        const float* w = wsm + p.wofs[l];
        const bool last = l == nl - 1;
        for (int d0 = 0; d0 < d; d0 += kChunk) {
          float acc[kChunk];
#pragma unroll
          for (int c = 0; c < kChunk; ++c) acc[c] = 0.f;
#pragma unroll 4
          for (int j = 0; j < din; ++j) {
            const float hj = h[j];
            const float4 wa = *reinterpret_cast<const float4*>(w + j * dp + d0);
            const float4 wb =
                *reinterpret_cast<const float4*>(w + j * dp + d0 + 4);
            acc[0] = fmaf(hj, wa.x, acc[0]);
            acc[1] = fmaf(hj, wa.y, acc[1]);
            acc[2] = fmaf(hj, wa.z, acc[2]);
            acc[3] = fmaf(hj, wa.w, acc[3]);
            acc[4] = fmaf(hj, wb.x, acc[4]);
            acc[5] = fmaf(hj, wb.y, acc[5]);
            acc[6] = fmaf(hj, wb.z, acc[6]);
            acc[7] = fmaf(hj, wb.w, acc[7]);
          }
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            const int dd = d0 + c;
            if (dd >= d) break;  // the same for every lane
            const int col = p.offs[l] + dd;
            const float sxp = sx0 * wsx0[col] + sx1 * wsx1[col] +
                              sx2 * wsx2[col];
            const float base = (row[col] + ceni[col]) + sxp;
            const float a = l > 0 ? base + acc[c] : base;
            if (!last) {
              h[col] = fmaxf(a, 0.f);
            } else {
              float v = !active ? -INFINITY : lk >= 0 ? a : kNeg;
#pragma unroll
              for (int o = 16; o > 0; o >>= 1)
                v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
              if (lane == 0) best[dd] = k0 == 0 ? v : fmaxf(best[dd], v);
            }
          }
        }
      }
    }
    __syncwarp();
    for (int dd = lane; dd < dout; dd += 32)
      out[(long long)i * dout + dd] = best[dd];
  }
}

// an element stride whose byte length is an odd number of 4-byte words
int odd_words(int elems) { return elems % 2 ? elems : elems + 1; }

int align16(int bytes) { return (bytes + 15) / 16 * 16; }

int launch_f32(Params p, cudaStream_t stream) {
  int wf = (3 * p.sumd + 3) / 4 * 4;
  for (int l = 1; l < p.nl; ++l) {
    p.dpad[l] = (p.dims[l] + kChunk - 1) / kChunk * kChunk;
    p.wofs[l] = wf;
    wf += p.offs[l] * p.dpad[l];
  }
  p.wofs[0] = 0;  // layer 0 has no hidden input
  p.dpad[0] = kChunk;
  p.wfloats = wf;
  p.rs = odd_words(p.sumd + 6);
  p.hs = odd_words(p.offs[p.nl - 1] > 0 ? p.offs[p.nl - 1] : 1);
  p.rows_bytes = align16(32 * p.rs * 4);
  p.hid_bytes = align16(32 * p.hs * 4);
  p.warp_bytes = p.rows_bytes + p.hid_bytes +
                 align16(32 * 4 + p.dims[p.nl - 1] * 4);
  const size_t smem = (size_t)p.wfloats * 4 + (size_t)kWarps * p.warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, conv_f32_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  int grid = (p.n + kWarps - 1) / kWarps;
  if (grid > per_sm * sms) grid = per_sm * sms;
  conv_f32_kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: 16 slots per mma.sync, the tile's slab range staged once per CTA.

// Widths are counted in tiles of 8 columns.  HT caps the hidden tiles
// (every layer but the last, each padded to 8), OT the last layer's; W is
// the warps of a CTA (32 where HT <= 4: registers allow it).
constexpr int kMaxTiles = 16;

// One layer's geometry: compile-time (StaticDims) or, for other widths, read
// from a table in shared memory, which the CTA also packs its weights by.
struct Layer {
  int d;      // width
  int col0;   // first column in sumd
  int j0;     // first tile in the padded columns of all layers; for l >= 1
              // also the hidden tiles its product reads
  int j1;     // one past its last tile
  int bofs;   // uint2 offset of its B fragments
  int npair;  // k16 steps of its hidden product
  int pair;   // its columns load as aligned bf16 pairs
  int pad;
};

struct MmaParams {
  const bf16* fpx;
  const bf16* cen;
  const float* xyzc;
  const int* lidx;
  const bf16* wsx;
  const bf16* whid[kMaxLayers];  // whid[l], l >= 1: [lay[l].col0, lay[l].d]
  bf16* out;
  int n, k, tile, s, nl, sumd, row_len, nrows;
  Layer lay[kMaxLayers];
  int nb;          // uint2 B-fragment entries of all layers
  int parts;       // CTAs per tile
  int row_align;   // fpx rows whose start is 16-byte aligned
  int buf_rows;    // slab rows the shared buffer holds
  int warp_bytes;  // a warp's two point buffers
  int off_b, off_wsx, off_zero, off_warp, off_buf;  // shared-memory offsets
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
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

// one 4-byte word from global to shared memory, asynchronously
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc += A[16 x 16] . B[16 x 8]; a0/a1 rows g/g+8 of k 0-7, a2/a3 of k 8-15
__device__ __forceinline__ void mma16(float acc[4], uint32_t a0, uint32_t a1,
                                      uint32_t a2, uint32_t a3, uint32_t b0,
                                      uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc += A[16 x 8] . B[8 x 8]
__device__ __forceinline__ void mma8(float acc[4], uint32_t a0, uint32_t a1,
                                     uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ uint32_t pack_relu(float x, float y) {
  bf162 v = __floats2bfloat162_rn(fmaxf(x, 0.f), fmaxf(y, 0.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two consecutive columns c, c + 1 of a row: one aligned 4-byte load where
// `pair`, else one 2-byte load each for columns below d (0 above).
__device__ __forceinline__ float2 ld_cols(const bf16* ptr, bool pair, int c,
                                          int d) {
  if (pair) return __bfloat1622float2(*reinterpret_cast<const bf162*>(ptr));
  return make_float2(c < d ? __bfloat162float(ptr[0]) : 0.f,
                     c + 1 < d ? __bfloat162float(ptr[1]) : 0.f);
}

// acc = (g + cen) + sx . wsx for the thread's two rows (slots g, g + 8) and
// two columns (2t, 2t + 1) of tile n of layer L: the two adds on the CUDA
// cores, the K = 3 product as one m16n8k8 (sx in k 0-2 of the A fragment
// asx, wsx in the B fragments wfr, both exact in bf16)
__device__ __forceinline__ void tile_base(
    float acc[4], const Layer& L, int n, int t, int lane, const bf16* row_a,
    const bf16* row_b, const bf16* cen, const uint32_t* wfr,
    const uint32_t asx[2]) {
  const int c = 8 * n + 2 * t;
  const int col = L.col0 + c;
  const bool pair = L.pair && 8 * n + 8 <= L.d;
  const float2 ga = ld_cols(row_a + col, pair, c, L.d);
  const float2 gb = ld_cols(row_b + col, pair, c, L.d);
  const float2 ce = ld_cols(cen + col, pair, c, L.d);
  acc[0] = ga.x + ce.x;
  acc[1] = ga.y + ce.y;
  acc[2] = gb.x + ce.x;
  acc[3] = gb.y + ce.y;
  mma8(acc, asx[0], asx[1], wfr[(L.j0 + n) * 32 + lane]);
}

// acc += [h tiles 0 .. kt) . B, B's fragments at b[q * 32] for k16 step q
template <int HT>
__device__ __forceinline__ void hidden_product(float acc[4],
                                               const uint32_t (&h)[HT][2],
                                               const uint2* b, int kt) {
#pragma unroll
  for (int q = 0; q < HT / 2; ++q) {
    if (2 * q >= kt) break;
    const uint2 w = b[q * 32];
    if (2 * q + 1 < kt)
      mma16(acc, h[2 * q][0], h[2 * q][1], h[2 * q + 1][0], h[2 * q + 1][1],
            w.x, w.y);
    else
      mma8(acc, h[2 * q][0], h[2 * q][1], w.x);
  }
}

// Lane t's half of an A fragment of sx = T(hi + mid - xyz_i) for one slot
// row, as the TPU kernel rounds it: components 2t and 2t + 1 (0 past 2).
__device__ __forceinline__ uint32_t slot_sx(const bf16* row, int sumd,
                                            const float* xi, int t) {
  float v[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = 2 * t + j;
    if (c < 3)
      v[j] = (__bfloat162float(row[sumd + c]) +
              __bfloat162float(row[sumd + 3 + c])) - xi[c];
  }
  bf162 s = __floats2bfloat162_rn(v[0], v[1]);
  return *reinterpret_cast<uint32_t*>(&s);
}

// A warp's copy of one point: its centre row, its K indices and its xyz.
struct PointBuf {
  bf16* cen;
  int* lidx;
  float* xyz;
};

__device__ __forceinline__ PointBuf point_buf(unsigned char* base,
                                              const MmaParams& p) {
  PointBuf b;
  b.xyz = reinterpret_cast<float*>(base);
  b.lidx = reinterpret_cast<int*>(base + 16);
  b.cen = reinterpret_cast<bf16*>(base + 16 + (p.k * 4 + 15) / 16 * 16);
  return b;
}

// Start copying point i into b: 4-byte cp.async where the centre row is
// word-aligned (even sumd), else the centre row by plain 2-byte copies.
__device__ __forceinline__ void fetch_point(const MmaParams& p, int i,
                                            const PointBuf& b, int lane) {
  const int* li = p.lidx + (size_t)i * p.k;
  for (int e = lane; e < p.k; e += 32) copy4(b.lidx + e, li + e);
  if (lane < 3) copy4(b.xyz + lane, p.xyzc + 4 * i + lane);
  const bf16* ci = p.cen + (size_t)i * p.sumd;
  if (p.sumd % 2 == 0) {
    for (int e = lane; e < p.sumd / 2; e += 32)
      copy4(b.cen + 2 * e, ci + 2 * e);
  } else {
    for (int e = lane; e < p.sumd; e += 32) b.cen[e] = ci[e];
  }
  copy_commit();
}

// The layers' geometry: compile-time constants for the widths the flagship
// uses (every index folds, every loop unrolls), else read per layer from
// the table in shared memory.
template <int... D>
struct StaticDims {
  static constexpr bool kStatic = true;
  static constexpr int kLayers = sizeof...(D);
  __host__ __device__ static constexpr Layer layer(int l) {
    const int dims[] = {D...};
    int sumd = 0;
    for (int i = 0; i < kLayers; ++i) sumd += dims[i];
    Layer L = {0, 0, 0, 0, 0, 0, 0, 0};
    int col = 0, j = 0, b = 0;
    for (int i = 0; i <= l; ++i) {
      const int tiles = (dims[i] + 7) / 8;
      const int np = i > 0 ? (j + 1) / 2 : 0;
      L = Layer{dims[i], col, j, j + tiles, b, np,
                sumd % 2 == 0 && col % 2 == 0, 0};
      col += dims[i];
      b += tiles * np * 32;
      j += tiles;
    }
    return L;
  }
};

struct AnyDims {
  static constexpr bool kStatic = false;
};

template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

template <class G, int HT, int OT, int W>
__global__ void __launch_bounds__(32 * W)
conv_mma_kernel(const __grid_constant__ MmaParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* range = reinterpret_cast<int*>(smem + 8);
  Layer* lay = reinterpret_cast<Layer*>(smem + 16);
  uint2* bsm = reinterpret_cast<uint2*>(smem + p.off_b);
  uint32_t* wfr = reinterpret_cast<uint32_t*>(smem + p.off_wsx);
  bf16* zero = reinterpret_cast<bf16*>(smem + p.off_zero);
  bf16* buf = reinterpret_cast<bf16*>(smem + p.off_buf);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t_id = blockIdx.x / p.parts, part = blockIdx.x % p.parts;
  const int q0 = part * p.tile / p.parts;
  const int npts = (part + 1) * p.tile / p.parts - q0;
  const int pt0 = t_id * p.tile + q0;   // the CTA's first point
  const int slab0 = t_id * p.tile;      // fpx row of slab row 0

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    range[0] = 0x7fffffff;
    range[1] = -1;
  }
  if (tid < p.nl * 8)
    reinterpret_cast<int*>(lay)[tid] = reinterpret_cast<const int*>(p.lay)[tid];
  for (int e = tid; e < (p.row_len + 1) / 2; e += 32 * W)
    reinterpret_cast<uint32_t*>(zero)[e] = 0u;
  // each warp starts copying its first point
  unsigned char* wbase = smem + p.off_warp + warp * p.warp_bytes;
  if (warp < npts) fetch_point(p, pt0 + warp, point_buf(wbase, p), lane);

  // the range of slab rows the CTA's valid slots read
  const int* lidx = p.lidx + (size_t)pt0 * p.k;
  int lo = 0x7fffffff, hi = -1;
  for (int e = tid; e < npts * p.k; e += 32 * W) {
    const int l = __ldg(lidx + e);
    if ((unsigned)l < (unsigned)p.s) {
      lo = min(lo, l);
      hi = max(hi, l);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    atomicMin(&range[0], lo);
    atomicMax(&range[1], hi);
  }
  __syncthreads();

  // stage fpx rows [r0, r1) (r0 a multiple of row_align) into buf by the
  // TMA, or by the threads where the copy is not 16-byte aligned; a range
  // longer than the buffer stays in global memory
  const int lmin = range[0], lmax = range[1];
  const bf16* rows = p.fpx + (size_t)slab0 * p.row_len;
  int shift = 0;  // rows[(l + shift) * row_len] is slab row l
  bool tma = false;
  if (lmax >= 0) {
    const int m = p.row_align;
    const int r0 = (slab0 + lmin) / m * m;
    const int r1 = min((slab0 + lmax + m) / m * m, p.nrows);
    if (r1 - r0 <= p.buf_rows) {
      const bf16* src = p.fpx + (size_t)r0 * p.row_len;
      const uint32_t bytes = (uint32_t)(r1 - r0) * p.row_len * 2u;
      tma = ((uintptr_t)src | bytes) % 16 == 0;
      if (tma) {
        if (tid == 0) {
          mbar_arrive_expect_tx(bar, bytes);
          bulk_load(buf, src, bytes, bar);
        }
      } else if (((uintptr_t)src | bytes) % 4 == 0) {
        const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src);
        uint32_t* d4 = reinterpret_cast<uint32_t*>(buf);
        for (uint32_t e = tid; e < bytes / 4; e += 32 * W) d4[e] = s4[e];
      } else {
        for (uint32_t e = tid; e < bytes / 2; e += 32 * W) buf[e] = src[e];
      }
      rows = buf;
      shift = slab0 - r0;
    }
  }

  // while the copy flies: the B fragments of every layer's hidden product,
  // in lane order (entry (l, n, q, lane) = rows 16q + 2t, +1 and 16q + 8 +
  // 2t, +1 of column 8n + g of whid_l in the padded hidden space), and of
  // wsx per tile of 8 padded columns (lane (g, t): rows 2t, 2t + 1 of
  // column 8J + g, rows past 2 zero)
  for (int e = tid; e < p.nb; e += 32 * W) {
    int l = 1;
    while (l + 1 < p.nl && e >= lay[l + 1].bofs) ++l;
    const Layer L = lay[l];
    const int local = e - L.bofs, ln = local & 31;
    const int q = (local >> 5) % L.npair, n = (local >> 5) / L.npair;
    const int col = 8 * n + (ln >> 2);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = 16 * q + 8 * (j >> 1) + 2 * (ln & 3) + (j & 1);
      const int tl = kp >> 3;
      int m = 0;
      while (m + 1 < l && tl >= lay[m].j1) ++m;
      const int c = kp - 8 * lay[m].j0;
      const bool real = tl < L.j0 && col < L.d && c < lay[m].d;
      v[j] = real ? __bfloat162float(
                        __ldg(p.whid[l] + (lay[m].col0 + c) * L.d + col))
                  : 0.f;
    }
    bf162 w0 = __floats2bfloat162_rn(v[0], v[1]);
    bf162 w1 = __floats2bfloat162_rn(v[2], v[3]);
    bsm[e] = make_uint2(*reinterpret_cast<uint32_t*>(&w0),
                        *reinterpret_cast<uint32_t*>(&w1));
  }
  for (int e = tid; e < 32 * lay[p.nl - 1].j1; e += 32 * W) {
    const int tl = e >> 5, ln = e & 31;
    int m = 0;
    while (tl >= lay[m].j1) ++m;
    const int c = 8 * (tl - lay[m].j0) + (ln >> 2);
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = 2 * (ln & 3) + j;
      if (c < lay[m].d && k < 3)
        v[j] = __bfloat162float(__ldg(p.wsx + k * p.sumd + lay[m].col0 + c));
    }
    bf162 w = __floats2bfloat162_rn(v[0], v[1]);
    wfr[e] = *reinterpret_cast<uint32_t*>(&w);
  }
  __syncthreads();
  if (tma) mbar_wait(bar, 0);

  const int g = lane >> 2, t = lane & 3;
  const int last = p.nl - 1, ngroups = (p.k + 15) / 16;
  const int sumd = p.sumd;
  Layer out_l;
  if constexpr (G::kStatic)
    out_l = G::layer(G::kLayers - 1);
  else
    out_l = lay[last];
  for (int pl = warp, it = 0; pl < npts; pl += W, ++it) {
    // the next point's copy overlaps this point's work
    const PointBuf cur = point_buf(wbase + (it & 1) * (p.warp_bytes / 2), p);
    if (pl + W < npts) {
      fetch_point(p, pt0 + pl + W,
                  point_buf(wbase + (~it & 1) * (p.warp_bytes / 2), p), lane);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncwarp();
    const int i = pt0 + pl;
    float best[OT][2];
#pragma unroll
    for (int n = 0; n < OT; ++n) best[n][0] = best[n][1] = -INFINITY;

    for (int grp = 0; grp < ngroups; ++grp) {
      const int ka = grp * 16 + g, kb = ka + 8;
      const int la = ka < p.k ? cur.lidx[ka] : -1;
      const int lb = kb < p.k ? cur.lidx[kb] : -1;
      if (!__any_sync(0xffffffffu, la >= 0 || lb >= 0)) {
        // every slot of the group is masked: each gives -1e30
#pragma unroll
        for (int n = 0; n < OT; ++n) {
          best[n][0] = fmaxf(best[n][0], kNeg);
          best[n][1] = fmaxf(best[n][1], kNeg);
        }
        continue;
      }
      // the slab rows the two slots read (a zero row outside the slab)
      const bf16* row_a = (unsigned)la < (unsigned)p.s
                              ? rows + (la + shift) * p.row_len : zero;
      const bf16* row_b = (unsigned)lb < (unsigned)p.s
                              ? rows + (lb + shift) * p.row_len : zero;
      const uint32_t asx[2] = {slot_sx(row_a, sumd, cur.xyz, t),
                               slot_sx(row_b, sumd, cur.xyz, t)};

      uint32_t h[HT][2];  // tile j: rows g and g + 8, columns 2t, 2t + 1
      auto hidden_layer = [&](const Layer& L) {
#pragma unroll
        for (int j = 0; j < HT; ++j) {
          if (j < L.j0 || j >= L.j1) continue;
          const int n = j - L.j0;
          float acc[4];
          tile_base(acc, L, n, t, lane, row_a, row_b, cur.cen, wfr, asx);
          hidden_product<HT>(acc, h, bsm + L.bofs + n * L.npair * 32 + lane,
                             L.j0);
          h[j][0] = pack_relu(acc[0], acc[1]);
          h[j][1] = pack_relu(acc[2], acc[3]);
        }
      };
      if constexpr (G::kStatic) {
        static_for<0, G::kLayers - 1>([&](auto l) {
          constexpr Layer L = G::layer(decltype(l)::value);
          hidden_layer(L);
        });
      } else {
        for (int l = 0; l < last; ++l) hidden_layer(lay[l]);
      }
      const float mask_a = ka < p.k ? kNeg : -INFINITY;
      const float mask_b = kb < p.k ? kNeg : -INFINITY;
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        if (8 * n >= out_l.d) break;
        float acc[4];
        tile_base(acc, out_l, n, t, lane, row_a, row_b, cur.cen, wfr, asx);
        hidden_product<HT>(acc, h,
                           bsm + out_l.bofs + n * out_l.npair * 32 + lane,
                           out_l.j0);
        const float a0 = la >= 0 ? acc[0] : mask_a;
        const float a1 = la >= 0 ? acc[1] : mask_a;
        const float a2 = lb >= 0 ? acc[2] : mask_b;
        const float a3 = lb >= 0 ? acc[3] : mask_b;
        best[n][0] = fmaxf(best[n][0], fmaxf(a0, a2));
        best[n][1] = fmaxf(best[n][1], fmaxf(a1, a3));
      }
    }
    __syncwarp();  // cur may be overwritten by the copy after next

    // the max over the 8 row pairs, then lane (g, t) stores columns 2t and
    // 2t + 1 of tile g (+ 8r): one 4-byte store per lane
#pragma unroll
    for (int n = 0; n < OT; ++n) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        best[n][0] = fmaxf(best[n][0], __shfl_xor_sync(0xffffffffu,
                                                       best[n][0], o));
        best[n][1] = fmaxf(best[n][1], __shfl_xor_sync(0xffffffffu,
                                                       best[n][1], o));
      }
    }
    const int dout = out_l.d;
    bf16* o = p.out + (size_t)i * dout;
#pragma unroll
    for (int r = 0; r < OT; r += 8) {
      float v0 = best[r][0], v1 = best[r][1];
#pragma unroll
      for (int m = 1; m < 8 && r + m < OT; ++m)
        if (g == m) {
          v0 = best[r + m][0];
          v1 = best[r + m][1];
        }
      const int c = 8 * (r + g) + 2 * t;
      if (dout % 2 == 0 && c + 1 < dout) {
        *reinterpret_cast<bf162*>(o + c) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < dout) o[c] = __float2bfloat16(v0);
        if (c + 1 < dout) o[c + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <class G, int HT, int OT, int W>
int launch_mma_t(MmaParams& p, int row_bytes, cudaStream_t stream) {
  auto kernel = conv_mma_kernel<G, HT, OT, W>;
  p.off_buf = p.off_warp + W * p.warp_bytes;
  if (p.off_buf > kSmemMax) return (int)cudaErrorInvalidValue;
  // the buffer holds the whole slab (plus the rows that align its start)
  // where it fits beside the weights, else what does
  const int want = p.s + 2 * p.row_align;
  const int room = (kSmemMax - p.off_buf) / row_bytes;
  p.buf_rows = want < room ? want : room;
  const size_t smem = (size_t)p.off_buf + (size_t)p.buf_rows * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (sm_count <= 0) sm_count = 132;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      32 * W, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // as many CTAs per tile as fill every SM once
  const int ntiles = p.n / p.tile;
  p.parts = sm_count * per_sm / ntiles;
  if (p.parts < 1) p.parts = 1;
  if (p.parts > p.tile) p.parts = p.tile;
  kernel<<<ntiles * p.parts, 32 * W, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// the flagship's widths: compile-time geometry
template <int... D>
bool is_dims(const int* dims, int nl) {
  const int want[] = {D...};
  if (nl != (int)sizeof...(D)) return false;
  for (int l = 0; l < nl; ++l)
    if (dims[l] != want[l]) return false;
  return true;
}

template <int W, int... D>
int launch_static(MmaParams& p, int row_bytes, cudaStream_t stream) {
  typedef StaticDims<D...> G;
  constexpr Layer last = G::layer(G::kLayers - 1);
  // hidden tiles, rounded up to a whole k16 step, and output tiles
  return launch_mma_t<G, (last.j0 + 1) / 2 * 2, last.j1 - last.j0, W>(
      p, row_bytes, stream);
}

int launch_mma(MmaParams p, const int* dims, cudaStream_t stream) {
  const int nl = p.nl;
  int col = 0, j = 0, b = 0;
  for (int l = 0; l < nl; ++l) {
    Layer& L = p.lay[l];
    L.d = dims[l];
    L.col0 = col;
    L.j0 = j;
    L.j1 = j + (L.d + 7) / 8;
    L.npair = l > 0 ? (j + 1) / 2 : 0;
    L.bofs = b;
    L.pair = p.sumd % 2 == 0 && col % 2 == 0;
    b += (L.j1 - L.j0) * L.npair * 32;
    col += L.d;
    j = L.j1;
  }
  p.nb = b;
  const int ht = p.lay[nl - 1].j0, ot = p.lay[nl - 1].j1 - ht;
  if (ht > kMaxTiles || ot > kMaxTiles) return (int)cudaErrorInvalidValue;
  const int row_bytes = p.row_len * 2;
  int a = 16;
  while (a > 1 && row_bytes % a) a /= 2;  // gcd(row_bytes, 16)
  p.row_align = 16 / a;
  // a warp's point buffer: xyz (16 B), K indices, the centre row; two of
  // them, so the next point's copy overlaps this point's work
  p.warp_bytes = 2 * (16 + align16(p.k * 4) + align16(p.sumd * 2));
  p.off_b = align16(16 + nl * (int)sizeof(Layer));
  p.off_wsx = align16(p.off_b + p.nb * 8);
  p.off_zero = align16(p.off_wsx + 32 * p.lay[nl - 1].j1 * 4);
  p.off_warp = align16(p.off_zero + row_bytes);
  if (is_dims<8, 8, 16, 32>(dims, nl))
    return launch_static<32, 8, 8, 16, 32>(p, row_bytes, stream);
  if (is_dims<16, 16, 32, 64>(dims, nl))
    return launch_static<16, 16, 16, 32, 64>(p, row_bytes, stream);
  if (is_dims<16, 16, 16, 48>(dims, nl))
    return launch_static<16, 16, 16, 16, 48>(p, row_bytes, stream);
  if (is_dims<4, 4, 8>(dims, nl))
    return launch_static<32, 4, 4, 8>(p, row_bytes, stream);
  const int m = ht > ot ? ht : ot;
  if (m <= 4) return launch_mma_t<AnyDims, 4, 4, 32>(p, row_bytes, stream);
  if (m <= 8) return launch_mma_t<AnyDims, 8, 8, 16>(p, row_bytes, stream);
  return launch_mma_t<AnyDims, 16, 16, 16>(p, row_bytes, stream);
}

}  // namespace

extern "C" int pcs_fused_window_conv(
    const void* fpx, const void* cen, const void* xyzc, const void* lidx,
    const void* wsx, const void* const* whids, void* out, const int* dims,
    int n_layers, int n, int k, int tile, int window, int dtype,
    void* stream) {
  if (n <= 0 || k <= 0 || tile <= 0 || window < 0 || n % tile != 0 ||
      n_layers < 1 || n_layers > kMaxLayers ||
      (long long)n * k >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int offs[kMaxLayers + 1] = {0};
  for (int l = 0; l < n_layers; ++l) {
    if (dims[l] <= 0) return (int)cudaErrorInvalidValue;
    offs[l + 1] = offs[l] + dims[l];
  }
  const int sumd = offs[n_layers];
  if ((long long)(n + 2 * window) * (sumd + 6) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Params p = {};
    p.fpx = fpx;
    p.cen = cen;
    p.xyzc = static_cast<const float*>(xyzc);
    p.lidx = static_cast<const int*>(lidx);
    p.wsx = wsx;
    p.out = out;
    p.n = n;
    p.k = k;
    p.tile = tile;
    p.window = window;
    p.nl = n_layers;
    p.sumd = sumd;
    for (int l = 0; l < n_layers; ++l) {
      p.dims[l] = dims[l];
      if (l > 0) p.whid[l] = whids[l - 1];
    }
    for (int l = 0; l <= n_layers; ++l) p.offs[l] = offs[l];
    return launch_f32(p, st);
  }
  if (dtype == 1) {
    MmaParams p = {};
    p.fpx = static_cast<const bf16*>(fpx);
    p.cen = static_cast<const bf16*>(cen);
    p.xyzc = static_cast<const float*>(xyzc);
    p.lidx = static_cast<const int*>(lidx);
    p.wsx = static_cast<const bf16*>(wsx);
    p.out = static_cast<bf16*>(out);
    p.n = n;
    p.k = k;
    p.tile = tile;
    p.s = tile + 2 * window;
    p.nl = n_layers;
    p.sumd = sumd;
    p.row_len = sumd + 6;
    p.nrows = n + 2 * window;
    for (int l = 1; l < n_layers; ++l)
      p.whid[l] = static_cast<const bf16*>(whids[l - 1]);
    return launch_mma(p, dims, st);
  }
  return (int)cudaErrorInvalidValue;
}
