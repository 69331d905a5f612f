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
// What bounds it on the card.  At the bench's level-0 conv (N = 8192, K = 32,
// dims 8, 8, 16, 32, bf16) the function moves about 4 MB: about 1.2 us at
// 3.35 TB/s.  Its valid slots (126,581 of 262,144 there) need 0.41 GFLOP:
// about 0.4 us on the bf16 tensor cores, but about 6 us on the float32 CUDA
// cores this kernel uses (67 TFLOP/s).  Level 1 (N = 4096, dims 16, 16, 32,
// 64) is about 3.4 MB and 1.38 GFLOP.  On an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 8) this kernel took 0.11 ms at level 0 and 0.25 ms at
// level 1: 4-6 TFLOP/s, about 1% of the bound and under a tenth of the
// float32 peak.  What holds it back was not measured (no hardware counters
// there); the likely costs are the work around the FMAs: staging rows,
// lane-private shared-memory reads of the hidden states, and one shuffle
// reduction per output column.  Moving the hidden products onto the tensor
// cores (mma/wgmma over 16 slots at a time) is the next step, not this one's.
//
// Design:
//   - one warp per point, one lane per slot (slot groups of 32 when K > 32),
//     a grid-stride loop over points sized to the card's occupancy, so
//     N = 4096 points keep every SM busy (one CTA per tile would give 16);
//   - the warp stages its 32 slab rows in shared memory with coalesced
//     loads (consecutive lanes read consecutive columns of a row), instead of
//     staging whole slabs (768 rows x 268 B = 206 KB at level 1) or letting
//     each lane walk its own row in global memory;
//   - the weights (wsx and every hidden-growth kernel, under 24 KB at level
//     1) sit in shared memory as float32, each kernel's rows padded to 8
//     columns, so a lane reads 8 weights with two broadcast 16-byte loads;
//   - a lane holds one layer's 8 output columns at a time in registers and
//     keeps its hidden states, already rounded to T, in its own shared-memory
//     row, so the register count does not grow with the widths;
//   - per-lane rows have an odd word stride, so lane-private reads hit 32
//     different banks;
//   - the masked max over slots is a warp shuffle reduction per output
//     column; -1e30 is finite in bf16 and survives the final rounding.
//
// The host entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 8;  // output columns a lane accumulates at once
constexpr float kNeg = -1e30f;

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
  return __float2bfloat16(v);
}

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
  int rs, hs;            // per-lane row and hidden strides, in elements of T
  int rows_bytes, hid_bytes, warp_bytes;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_window_conv_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);

  // weights, once per CTA, as float32
  const T* wsx = static_cast<const T*>(p.wsx);
  for (int e = threadIdx.x; e < 3 * p.sumd; e += kThreads)
    wsm[e] = to_f32(wsx[e]);
  for (int l = 1; l < p.nl; ++l) {
    const T* w = static_cast<const T*>(p.whid[l]);
    const int d = p.dims[l], dp = p.dpad[l];
    float* dst = wsm + p.wofs[l];
    for (int e = threadIdx.x; e < p.offs[l] * dp; e += kThreads) {
      const int j = e / dp, c = e - j * dp;
      dst[e] = c < d ? to_f32(w[j * d + c]) : 0.f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* mine = smem + p.wfloats * 4 + warp * p.warp_bytes;
  T* rows = reinterpret_cast<T*>(mine);
  T* hid = reinterpret_cast<T*>(mine + p.rows_bytes);
  int* lks = reinterpret_cast<int*>(mine + p.rows_bytes + p.hid_bytes);
  float* best = reinterpret_cast<float*>(lks + 32);

  const T* fpx = static_cast<const T*>(p.fpx);
  const T* cen = static_cast<const T*>(p.cen);
  T* out = static_cast<T*>(p.out);
  const int s = p.tile + 2 * p.window;
  const int sumd = p.sumd, row_len = sumd + 6, nl = p.nl;
  const int dout = p.dims[nl - 1];
  const float* wsx0 = wsm;
  const float* wsx1 = wsm + sumd;
  const float* wsx2 = wsm + 2 * sumd;
  const T* row = rows + lane * p.rs;
  T* h = hid + lane * p.hs;
  const T zero = from_f32<T>(0.f);

  for (int i = blockIdx.x * kWarps + warp; i < p.n;
       i += gridDim.x * kWarps) {
    const long long slab0 = (long long)(i / p.tile) * p.tile;
    const float xi0 = p.xyzc[4 * i], xi1 = p.xyzc[4 * i + 1],
                xi2 = p.xyzc[4 * i + 2];
    const T* ceni = cen + (long long)i * sumd;
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
            (unsigned)l < (unsigned)s ? fpx[(slab0 + l) * row_len + c] : zero;
      }
      __syncwarp();

      const float sx0 = to_f32(from_f32<T>(
          (to_f32(row[sumd]) + to_f32(row[sumd + 3])) - xi0));
      const float sx1 = to_f32(from_f32<T>(
          (to_f32(row[sumd + 1]) + to_f32(row[sumd + 4])) - xi1));
      const float sx2 = to_f32(from_f32<T>(
          (to_f32(row[sumd + 2]) + to_f32(row[sumd + 5])) - xi2));
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
            const float hj = to_f32(h[j]);
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
            const float base = (to_f32(row[col]) + to_f32(ceni[col])) + sxp;
            const float a = l > 0 ? base + acc[c] : base;
            if (!last) {
              h[col] = from_f32<T>(fmaxf(a, 0.f));
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
      out[(long long)i * dout + dd] = from_f32<T>(best[dd]);
  }
}

// an element stride whose byte length is an odd number of 4-byte words
int odd_words(int elems, int elem_bytes) {
  int words = (elems * elem_bytes + 3) / 4;
  if (words % 2 == 0) ++words;
  return words * 4 / elem_bytes;
}

int align16(int bytes) { return (bytes + 15) / 16 * 16; }

template <typename T>
int launch(Params p, cudaStream_t stream) {
  const int eb = (int)sizeof(T);
  int wf = (3 * p.sumd + 3) / 4 * 4;
  for (int l = 1; l < p.nl; ++l) {
    p.dpad[l] = (p.dims[l] + kChunk - 1) / kChunk * kChunk;
    p.wofs[l] = wf;
    wf += p.offs[l] * p.dpad[l];
  }
  p.wofs[0] = 0;  // layer 0 has no hidden input
  p.dpad[0] = kChunk;
  p.wfloats = wf;
  p.rs = odd_words(p.sumd + 6, eb);
  p.hs = odd_words(p.offs[p.nl - 1] > 0 ? p.offs[p.nl - 1] : 1, eb);
  p.rows_bytes = align16(32 * p.rs * eb);
  p.hid_bytes = align16(32 * p.hs * eb);
  p.warp_bytes = p.rows_bytes + p.hid_bytes +
                 align16(32 * 4 + p.dims[p.nl - 1] * 4);
  const size_t smem = (size_t)p.wfloats * 4 + (size_t)kWarps * p.warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_window_conv_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_window_conv_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  int grid = (p.n + kWarps - 1) / kWarps;
  if (grid > per_sm * sms) grid = per_sm * sms;
  fused_window_conv_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pcs_fused_window_conv(
    const void* fpx, const void* cen, const void* xyzc, const void* lidx,
    const void* wsx, const void* const* whids, void* out, const int* dims,
    int n_layers, int n, int k, int tile, int window, int dtype,
    void* stream) {
  if (n <= 0 || k <= 0 || tile <= 0 || window < 0 || n % tile != 0 ||
      n_layers < 1 || n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
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
  p.offs[0] = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (dims[l] <= 0) return (int)cudaErrorInvalidValue;
    p.dims[l] = dims[l];
    p.offs[l + 1] = p.offs[l] + dims[l];
    if (l > 0) p.whid[l] = whids[l - 1];
  }
  p.sumd = p.offs[n_layers];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}
