// Dense tile compositor (one payload per image-tile row), forward and
// backward, for sm_90a.
//
// Replaces the TPU Pallas kernel K5 of deblur4dgs_tpu/ops/rasterize.py:
//   forward  -> _fwd_kernel (rasterize.py:160)
//   backward -> _bwd_kernel / _bwd_one_tile (rasterize.py:207, :221)
// The plain PyTorch twins composite_dense_plain / composite_dense_bwd_plain
// (deblur4dgs_tpu_torch/ops/rasterize.py) compute the same numbers with the
// same loop semantics; chip_smoke.py holds each kernel against its twin.
//
// Layout (float32, counts int32, dense row-major; row t is image tile t):
//   data  (T, F, cap)  rows [mx, my, conic_a, conic_b, conic_c, opacity,
//                      radius, channel_0 .. channel_{D-1}], F = 7 + D
//   accum (T, P, D), tfin (T, P, 1)  pixel-major, as K5 writes them
//   gdata like data: [g_mx, g_my, g_a, g_b, g_c, g_op, 0, g_channels]
//
// Design. One 256-thread block per tile row, one thread per pixel. Each
// 128-Gaussian chunk of the row's 7 + D rows is staged in shared memory;
// every thread carries its pixel's T and D accumulators in registers (D <=
// 16). Stop rule: before each chunk, the block stops once all 256 pixels
// have T < 1e-4 (__syncthreads_or), as K5 does (:192-194, :287-289); alpha
// and T use the round-to-nearest helpers of composite_common.cuh, so the
// backward recomputes the forward's T bit for bit and stops at the same
// chunk.
//
// Backward, after _bwd_one_tile: per pixel, Total = sum_d accum * gacc and
// gt_term = gt * tfin from the forward outputs; the prefix of w * (gacc .
// channels) is carried across chunks and the suffix after a Gaussian is
// Total - prefix_incl, so there are no stored residuals and the only
// division is by 1 - alpha >= 0.001. The 6 + D per-Gaussian sums over 256
// pixels use a warp shuffle (skipped when no lane of the warp is live) into
// per-warp shared partials, summed across the 8 warps after each chunk. A
// row belongs to one tile, so every gradient slot is written exactly once,
// without atomics; the radius row and slots past the stop chunk get zeros.
//
// What bounds it on an H100. Per (pixel, Gaussian) pair up to the stop
// chunk it evaluates alpha (~20 FP32 operations); a live pair adds 2D + 3
// (forward) or 4D + 36 (backward). The bytes are the payload slots before
// each row's stop chunk (a row's sentinel tail is never read), every other
// input read once and each output written whole. On the static-reg render
// of the bench scene (1280x720, 60k background Gaussians, cap 1024, D = 4:
// 3600 rows, 276k of the 3.69M slots walked, 70.7M pairs, 11.2M live) the
// forward is bound by operations, 1.54 Gop -> 0.023 ms at 67 TFLOP/s FP32
// (0.031 GB), the backward by bytes, 0.21 GB -> 0.063 ms at 3.35 TB/s (0.16
// GB of it the whole gradient). This first version measures 0.150 / 0.509
// ms there on an H100 80GB HBM3 at 700 W (chip_smoke.py), about 7x / 8x
// those bounds: one block per row with little work (most rows hold under
// one chunk) and the backward's per-Gaussian shuffle reductions.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace d4gs;

constexpr int NPARAM = 7;  // payload rows before the channels

template <int MAXC>
__global__ void __launch_bounds__(P)
dense_fwd_kernel(const int* __restrict__ counts,
                 const float* __restrict__ data, float* __restrict__ accum,
                 float* __restrict__ tfin, int F, int cap, int nchan,
                 int tiles_x) {
  __shared__ float sd[(NPARAM + MAXC) * CHUNK];
  const int t = blockIdx.x, p = threadIdx.x;
  const int count = min(counts[t], cap);
  float px, py;
  pixel_centre(t, tiles_x, p, &px, &py);
  const float* row = data + (size_t)t * F * cap;

  float acc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) acc[c] = 0.0f;
  float T = 1.0f;
  const int nchunks = (count + CHUNK - 1) / CHUNK;
  for (int ci = 0; ci < nchunks; ++ci) {
    // stop rule; also the barrier before shared memory is overwritten
    if (!__syncthreads_or(T >= EARLY_STOP_T)) break;
    const int off = ci * CHUNK;
    stage(sd, row, F, cap, off);
    __syncthreads();
    const int n = min(CHUNK, count - off);
    for (int g = 0; g < n; ++g) {
      const AlphaOut a =
          alpha_at(sd[g], sd[CHUNK + g], sd[2 * CHUNK + g], sd[3 * CHUNK + g],
                   sd[4 * CHUNK + g], sd[6 * CHUNK + g], sd[5 * CHUNK + g],
                   px, py);
      if (!a.live) continue;
      const float w = __fmul_rn(a.alpha, T);
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < nchan) acc[c] += w * sd[(NPARAM + c) * CHUNK + g];
      T = __fmul_rn(T, __fsub_rn(1.0f, a.alpha));
    }
  }
  float* a_out = accum + ((size_t)t * P + p) * nchan;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < nchan) a_out[c] = acc[c];
  tfin[(size_t)t * P + p] = T;
}

template <int MAXC>
__global__ void __launch_bounds__(P)
dense_bwd_kernel(const int* __restrict__ counts,
                 const float* __restrict__ data,
                 const float* __restrict__ accum,
                 const float* __restrict__ tfin,
                 const float* __restrict__ gacc, const float* __restrict__ gt,
                 float* __restrict__ gdata, int F, int cap, int nchan,
                 int tiles_x) {
  extern __shared__ float smem[];
  float* sd = smem;                              // (NPARAM + MAXC, CHUNK)
  float* part = sd + (NPARAM + MAXC) * CHUNK;    // (6 + nchan, NWARPS, CHUNK)
  const int t = blockIdx.x, p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5;
  const int count = min(counts[t], cap);
  float px, py;
  pixel_centre(t, tiles_x, p, &px, &py);
  const int nv = 6 + nchan;  // [mx, my, a, b, c, op, channels]
  const float* row = data + (size_t)t * F * cap;
  float* g_row = gdata + (size_t)t * F * cap;

  float ga[MAXC];
  float total = 0.0f;
  const size_t pix = (size_t)t * P + p;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    ga[c] = 0.0f;
    if (c < nchan) {
      ga[c] = gacc[pix * nchan + c];
      total += accum[pix * nchan + c] * ga[c];
    }
  }
  const float gt_term = gt[pix] * tfin[pix];

  float T = 1.0f, prefix = 0.0f;
  const int nchunks = (count + CHUNK - 1) / CHUNK;
  int ci = 0;
  for (; ci < nchunks; ++ci) {
    // stop rule (same as the forward); barrier before smem reuse
    if (!__syncthreads_or(T >= EARLY_STOP_T)) break;
    const int off = ci * CHUNK;
    stage(sd, row, F, cap, off);
    __syncthreads();
    const int n = min(CHUNK, count - off);
    for (int g = 0; g < n; ++g) {
      const float ca = sd[2 * CHUNK + g], cb = sd[3 * CHUNK + g],
                  cc = sd[4 * CHUNK + g], op = sd[5 * CHUNK + g];
      const AlphaOut a = alpha_at(sd[g], sd[CHUNK + g], ca, cb, cc,
                                  sd[6 * CHUNK + g], op, px, py);
      float v[6 + MAXC];
#pragma unroll
      for (int k = 0; k < 6 + MAXC; ++k) v[k] = 0.0f;
      if (a.live) {
        const float w = __fmul_rn(a.alpha, T);
        float sdot = 0.0f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < nchan) {
            sdot += ga[c] * sd[(NPARAM + c) * CHUNK + g];
            v[6 + c] = ga[c] * w;
          }
        }
        prefix += w * sdot;  // inclusive prefix
        if (a.active) {
          const float suffix = total - prefix;
          const float g_alpha =
              T * sdot - (suffix + gt_term) / (1.0f - a.alpha);
          const float g_sigma = -a.alpha * g_alpha;
          v[0] = -(ca * a.dx + cb * a.dy) * g_sigma;
          v[1] = -(cc * a.dy + cb * a.dx) * g_sigma;
          v[2] = 0.5f * a.dx * a.dx * g_sigma;
          v[3] = a.dx * a.dy * g_sigma;
          v[4] = 0.5f * a.dy * a.dy * g_sigma;
          v[5] = a.alpha / fmaxf(op, 1e-12f) * g_alpha;
        }
        T = __fmul_rn(T, __fsub_rn(1.0f, a.alpha));
      }
      if (__any_sync(0xffffffffu, a.live)) {
#pragma unroll
        for (int k = 0; k < 6 + MAXC; ++k)
          if (k < nv) v[k] = warp_sum(v[k]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 6 + MAXC; ++k)
          if (k < nv) part[(k * NWARPS + warp) * CHUNK + g] = v[k];
      }
    }
    __syncthreads();
    // sum the 8 warp partials per (value, Gaussian) and write the chunk:
    // value k -> payload row k (k < 6: mx..op) or 7 + (k - 6) (channels)
    for (int i = p; i < nv * CHUNK; i += P) {
      const int k = i / CHUNK, g = i % CHUNK;
      float sum = 0.0f;
      if (g < n) {
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) sum += part[(k * NWARPS + w) * CHUNK + g];
      }
      const int f = k < 6 ? k : k + 1;
      g_row[(size_t)f * cap + off + g] = sum;
    }
    for (int g = p; g < CHUNK; g += P) g_row[(size_t)6 * cap + off + g] = 0.0f;
  }
  // slots this row never reached get zero gradients
  for (int f = 0; f < F; ++f)
    for (int i = ci * CHUNK + p; i < cap; i += P) g_row[(size_t)f * cap + i] = 0.0f;
}

template <int MAXC>
size_t bwd_smem_bytes(int nchan) {
  return sizeof(float) * ((size_t)(NPARAM + MAXC) * CHUNK +
                          (size_t)(6 + nchan) * NWARPS * CHUNK);
}

template <int MAXC>
int launch_fwd(const void* counts, const void* data, void* accum, void* tfin,
               int T, int F, int cap, int nchan, int tiles_x,
               cudaStream_t stream) {
  dense_fwd_kernel<MAXC><<<T, P, 0, stream>>>(
      (const int*)counts, (const float*)data, (float*)accum, (float*)tfin, F,
      cap, nchan, tiles_x);
  return (int)cudaGetLastError();
}

template <int MAXC>
int launch_bwd(const void* counts, const void* data, const void* accum,
               const void* tfin, const void* gacc, const void* gt,
               void* gdata, int T, int F, int cap, int nchan, int tiles_x,
               cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<MAXC>(nchan);
  cudaError_t err = cudaFuncSetAttribute(
      dense_bwd_kernel<MAXC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_bwd_kernel<MAXC><<<T, P, smem, stream>>>(
      (const int*)counts, (const float*)data, (const float*)accum,
      (const float*)tfin, (const float*)gacc, (const float*)gt,
      (float*)gdata, F, cap, nchan, tiles_x);
  return (int)cudaGetLastError();
}

bool shape_ok(int T, int F, int cap, int nchan) {
  return T > 0 && cap > 0 && cap % CHUNK == 0 && nchan >= 1 && nchan <= 16 &&
         F == NPARAM + nchan;
}

}  // namespace

// C interface (bound with ctypes by ops/cuda_build.py). Each returns the
// cudaError_t of the launch (0 on success); nothing synchronises.
extern "C" int d4gs_dense_fwd(const void* counts, const void* data,
                              void* accum, void* tfin, int T, int F, int cap,
                              int nchan, int tiles_x, void* stream) {
  if (!shape_ok(T, F, cap, nchan)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (nchan <= 4)
    return launch_fwd<4>(counts, data, accum, tfin, T, F, cap, nchan, tiles_x,
                         s);
  if (nchan <= 8)
    return launch_fwd<8>(counts, data, accum, tfin, T, F, cap, nchan, tiles_x,
                         s);
  return launch_fwd<16>(counts, data, accum, tfin, T, F, cap, nchan, tiles_x,
                        s);
}

extern "C" int d4gs_dense_bwd(const void* counts, const void* data,
                              const void* accum, const void* tfin,
                              const void* gacc, const void* gt, void* gdata,
                              int T, int F, int cap, int nchan, int tiles_x,
                              void* stream) {
  if (!shape_ok(T, F, cap, nchan)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (nchan <= 4)
    return launch_bwd<4>(counts, data, accum, tfin, gacc, gt, gdata, T, F,
                         cap, nchan, tiles_x, s);
  if (nchan <= 8)
    return launch_bwd<8>(counts, data, accum, tfin, gacc, gt, gdata, T, F,
                         cap, nchan, tiles_x, s);
  return launch_bwd<16>(counts, data, accum, tfin, gacc, gt, gdata, T, F,
                        cap, nchan, tiles_x, s);
}
