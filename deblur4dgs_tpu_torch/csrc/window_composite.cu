// Exposure-window tile compositor, forward and backward, for sm_90a.
//
// Replaces the TPU Pallas kernels of deblur4dgs_tpu/ops/rasterize.py:
//   forward  -> K1 _fwd_kernel_window (rasterize.py:989)
//   backward -> K2 _bwd_kernel_window_sgrid (rasterize.py:1220) and
//               K3 _bwd_kernel_window (rasterize.py:1049)
// and, launched with S = 1, the split compositor K4 (_fwd_kernel_split
// :548, _bwd_kernel_split :608), which is K1/K2 with one sub-frame in the
// same layout (ops/rasterize.py::split_fwd_cuda / split_bwd_cuda);
// and, launched with a row map, the scatter-output compositor K6
// (_fwd_kernel_window_scatter :1561 and the backward of
// _composite_bwd_window_scatter :1643), which is K1/K2 with the outputs
// addressed at image-tile row rows[t] of one shared buffer.
// The plain PyTorch twins composite_window_plain / composite_window_bwd_plain
// (deblur4dgs_tpu_torch/ops/rasterize.py) compute the same numbers with the
// same loop semantics; chip_smoke.py holds each kernel against its twin.
//
// Layout (all float32, counts and tile ids int32, dense row-major):
//   dyn   (T, S, Fd, cap)  rows [mx, my, conic_a, conic_b, conic_c, radius
//                          (, depth)]  -- Fd = 6 + depth_in_dyn
//   st    (T, Fs, cap)     rows [opacity, static channels]; Fs = 1 + n_static
//   accum (T, S, nchan, P), tfin (T, S, P)  with P = 256 pixels of a 16x16
//                          tile, nchan = n_static + depth_in_dyn
//   gdyn  like dyn: [g_mx, g_my, g_a, g_b, g_c, 0 (, g_depth)]
//   gst   (T, S, Fs, cap) per (row, sub-frame): [g_op, g_chans]; the
//         wrapper sums it over S into the (T, Fs, cap) gradient of st
//   rows  (T,) int32 or nullptr: the row of accum / tfin (and of gacc / gt
//         in the backward) that bucket row t owns; nullptr means row t.
//
// Scatter output (K6, rows != nullptr). The buckets of a window partition
// the image tiles, so each image row of the shared (T_img + 1, ...) buffer
// is written by exactly one block per sub-frame. Bucket pad rows all map to
// the trash row T_img and have count 0: their forward blocks all write the
// same values there (accum 0, T 1), and the wrapper fills that row with
// those values before the first bucket, so the buffer holds no undefined
// row. The backward returns from a count-0 row before it reads any
// residual or cotangent (it only zeroes its gdyn block), so nothing of the
// trash row enters a gradient. gdyn and gst stay bucket-ordered. Pixel
// centres come from tile_ids, which the K6 entries set to the row map, as
// the reference passes sids as the kernel's tile ids.
//
// Design. One thread block per (bucket row t, sub-frame s), one thread per
// pixel (256 threads). The row's Gaussians are walked front to back in chunks
// of 128: each chunk's dyn[t, s] and st[t] columns are staged in shared
// memory, and every thread carries its pixel's transmittance T and its nchan
// accumulators in registers. (One block per row over all S, as K1 does, would
// hold S * nchan = 121 accumulators per pixel at the bench shape and spill.)
// Blocks are ordered with s fastest, so the S blocks that re-read st[t] run
// together and find it in L2.
//
// Early-stop rule (identical in both kernels and in the plain twins): before
// each chunk, the (row, sub-frame) block stops if every one of its 256 pixels
// has T < 1e-4 (__syncthreads_or). Forward and backward recompute T with the
// same round-to-nearest intrinsics, so they stop at the same chunk. K1/K3
// stop the whole window at once instead; the difference is confined to the
// tail of a sub-frame after its own T fell below 1e-4.
//
// Backward. Per pixel it recomputes alpha and T in forward order and reads
// Total = sum_c accum * gacc from the forward outputs: the suffix sum after a
// Gaussian is Total - prefix_incl, so there are no stored per-Gaussian
// residuals and no division by a small T (only by 1 - alpha >= 0.001). The
// 6 + nchan per-Gaussian gradients are summed over the 256 pixels by a warp
// shuffle reduction (skipped when no lane of the warp is live) into a
// per-warp shared-memory partial, then across the 8 warps after the chunk.
// Each block owns gdyn[t, s] and gst[t, s] and writes all of both (zeros
// past its stop chunk); the wrapper sums gst over the S sub-frames in a
// fixed order, so the backward is deterministic (no atomics: a resumed
// run repeats an uninterrupted one bit for bit).
//
// What bounds it on an H100. At the bench shape (1280x720, S=11, 4 buckets
// of 1.16M slots) a step's forward moves 0.69 GB and the backward 1.59 GB
// (the payload slots before each (row, sub-frame)'s stop chunk, every
// other input read once, each output written once): 0.21 / 0.47 ms at
// 3.35 TB/s. The work is larger: 1.58G (pixel, Gaussian) pairs up to each
// row's stop chunk, 333M of them live, ~20 FP32 ops per pair for alpha plus
// 2*nchan+3 (forward) or 4*nchan+36 (backward) per live pair: 0.60 / 0.87 ms
// at 67 TFLOP/s. So both kernels are bound by operations, not bytes. This
// first version measures 5.04 / 29.65 ms per step on an H100 SXM at 700 W
// (chip_smoke.py): the forward walks every Gaussian in every pixel thread,
// dead pairs included (79% of pairs are outside the 3-sigma box or below
// 1/255); the backward adds a 5-step shuffle reduction of 6 + nchan values
// for every Gaussian that is live in any lane of a warp. Culling dead pairs
// per warp before the alpha math and reducing fewer values per Gaussian are
// the next steps.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace d4gs;

constexpr int MAX_FD = 7;

template <int MAXC>
__global__ void __launch_bounds__(P)
window_fwd_kernel(const int* __restrict__ tile_ids,
                  const int* __restrict__ counts,
                  const int* __restrict__ rows,
                  const float* __restrict__ dyn, const float* __restrict__ st,
                  float* __restrict__ accum, float* __restrict__ tfin, int S,
                  int Fd, int Fs, int cap, int nchan, int depth_in_dyn,
                  int tiles_x) {
  __shared__ float sd[MAX_FD * CHUNK];
  __shared__ float ss[(MAXC + 1) * CHUNK];
  const int s = blockIdx.x, t = blockIdx.y, p = threadIdx.x;
  const int count = min(counts[t], cap);
  const int tile = tile_ids[t];
  float px, py;
  pixel_centre(tile, tiles_x, p, &px, &py);
  const int n_static = nchan - depth_in_dyn;
  const size_t row = (size_t)t * S + s;
  const size_t orow = (size_t)(rows ? rows[t] : t) * S + s;  // output row
  const float* d_row = dyn + row * Fd * cap;
  const float* s_row = st + (size_t)t * Fs * cap;

  float acc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) acc[c] = 0.0f;
  float T = 1.0f;
  const int nchunks = (count + CHUNK - 1) / CHUNK;
  for (int ci = 0; ci < nchunks; ++ci) {
    // stop rule; also the barrier before shared memory is overwritten
    if (!__syncthreads_or(T >= EARLY_STOP_T)) break;
    const int off = ci * CHUNK;
    stage(sd, d_row, Fd, cap, off);
    stage(ss, s_row, Fs, cap, off);
    __syncthreads();
    const int n = min(CHUNK, count - off);
    for (int g = 0; g < n; ++g) {
      const AlphaOut a =
          alpha_at(sd[g], sd[CHUNK + g], sd[2 * CHUNK + g],
                   sd[3 * CHUNK + g], sd[4 * CHUNK + g], sd[5 * CHUNK + g],
                   ss[g], px, py);
      if (!a.live) continue;
      const float w = __fmul_rn(a.alpha, T);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < nchan) {
          const float ch = (depth_in_dyn && c == n_static)
                               ? sd[6 * CHUNK + g]
                               : ss[(1 + c) * CHUNK + g];
          acc[c] += w * ch;
        }
      }
      T = __fmul_rn(T, __fsub_rn(1.0f, a.alpha));
    }
  }
  float* a_out = accum + orow * nchan * P;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < nchan) a_out[c * P + p] = acc[c];
  tfin[orow * P + p] = T;
}

template <int MAXC>
__global__ void __launch_bounds__(P)
window_bwd_kernel(const int* __restrict__ tile_ids,
                  const int* __restrict__ counts,
                  const int* __restrict__ rows,
                  const float* __restrict__ dyn, const float* __restrict__ st,
                  const float* __restrict__ accum,
                  const float* __restrict__ tfin,
                  const float* __restrict__ gacc, const float* __restrict__ gt,
                  float* __restrict__ gdyn, float* __restrict__ gst, int S,
                  int Fd, int Fs, int cap, int nchan, int depth_in_dyn,
                  int tiles_x) {
  extern __shared__ float smem[];
  float* sd = smem;                         // (MAX_FD, CHUNK)
  float* ss = sd + MAX_FD * CHUNK;          // (MAXC + 1, CHUNK)
  float* part = ss + (MAXC + 1) * CHUNK;    // (6 + nchan, NWARPS, CHUNK)
  const int s = blockIdx.x, t = blockIdx.y, p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5;
  const int count = min(counts[t], cap);
  const int tile = tile_ids[t];
  float px, py;
  pixel_centre(tile, tiles_x, p, &px, &py);
  const int n_static = nchan - depth_in_dyn;
  const int nv = 6 + nchan;
  const size_t row = (size_t)t * S + s;
  const float* d_row = dyn + row * Fd * cap;
  const float* s_row = st + (size_t)t * Fs * cap;
  float* gd_row = gdyn + row * Fd * cap;
  float* gs_row = gst + row * Fs * cap;
  if (count == 0) {  // an empty row: zero gradients, residuals never read
    for (int i = p; i < Fd * cap; i += P) gd_row[i] = 0.0f;
    for (int i = p; i < Fs * cap; i += P) gs_row[i] = 0.0f;
    return;
  }
  const size_t orow = (size_t)(rows ? rows[t] : t) * S + s;  // residual row

  float ga[MAXC];
  float total = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    ga[c] = 0.0f;
    if (c < nchan) {
      ga[c] = gacc[(orow * nchan + c) * P + p];
      total += accum[(orow * nchan + c) * P + p] * ga[c];
    }
  }
  const float gt_term = gt[orow * P + p] * tfin[orow * P + p];

  float T = 1.0f, prefix = 0.0f;
  const int nchunks = (count + CHUNK - 1) / CHUNK;
  int ci = 0;
  for (; ci < nchunks; ++ci) {
    // stop rule (same as the forward); barrier before smem reuse
    if (!__syncthreads_or(T >= EARLY_STOP_T)) break;
    const int off = ci * CHUNK;
    stage(sd, d_row, Fd, cap, off);
    stage(ss, s_row, Fs, cap, off);
    __syncthreads();
    const int n = min(CHUNK, count - off);
    for (int g = 0; g < n; ++g) {
      const float ca = sd[2 * CHUNK + g], cb = sd[3 * CHUNK + g],
                  cc = sd[4 * CHUNK + g], op = ss[g];
      const AlphaOut a = alpha_at(sd[g], sd[CHUNK + g], ca, cb, cc,
                                  sd[5 * CHUNK + g], op, px, py);
      float v[6 + MAXC];
#pragma unroll
      for (int k = 0; k < 6 + MAXC; ++k) v[k] = 0.0f;
      if (a.live) {
        const float w = __fmul_rn(a.alpha, T);
        float sdot = 0.0f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < nchan) {
            const float ch = (depth_in_dyn && c == n_static)
                                 ? sd[6 * CHUNK + g]
                                 : ss[(1 + c) * CHUNK + g];
            sdot += ga[c] * ch;
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
    // sum the 8 warp partials per (value, Gaussian) and write the chunk
    for (int i = p; i < nv * CHUNK; i += P) {
      const int k = i / CHUNK, g = i % CHUNK;
      float sum = 0.0f;
      if (g < n) {
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) sum += part[(k * NWARPS + w) * CHUNK + g];
      }
      const int slot = off + g;
      if (k < 5) {
        gd_row[(size_t)k * cap + slot] = sum;
      } else if (k == 5) {
        gs_row[slot] = sum;
      } else if (k - 6 < n_static) {
        gs_row[(size_t)(k - 5) * cap + slot] = sum;
      } else {
        gd_row[(size_t)6 * cap + slot] = sum;  // depth channel -> dyn row 6
      }
    }
    for (int g = p; g < CHUNK; g += P) gd_row[(size_t)5 * cap + off + g] = 0.0f;
  }
  // slots this (row, s) never reached get zero gradients
  for (int f = 0; f < Fd; ++f)
    for (int i = ci * CHUNK + p; i < cap; i += P) gd_row[(size_t)f * cap + i] = 0.0f;
  for (int f = 0; f < Fs; ++f)
    for (int i = ci * CHUNK + p; i < cap; i += P) gs_row[(size_t)f * cap + i] = 0.0f;
}

template <int MAXC>
size_t bwd_smem_bytes(int nchan) {
  return sizeof(float) *
         ((size_t)MAX_FD * CHUNK + (size_t)(MAXC + 1) * CHUNK +
          (size_t)(6 + nchan) * NWARPS * CHUNK);
}

template <int MAXC>
int launch_fwd(const void* tile_ids, const void* counts, const void* rows,
               const void* dyn, const void* st, void* accum, void* tfin,
               int T, int S, int Fd, int Fs, int cap, int nchan,
               int depth_in_dyn, int tiles_x, cudaStream_t stream) {
  window_fwd_kernel<MAXC><<<dim3(S, T), P, 0, stream>>>(
      (const int*)tile_ids, (const int*)counts, (const int*)rows,
      (const float*)dyn,
      (const float*)st, (float*)accum, (float*)tfin, S, Fd, Fs, cap, nchan,
      depth_in_dyn, tiles_x);
  return (int)cudaGetLastError();
}

template <int MAXC>
int launch_bwd(const void* tile_ids, const void* counts, const void* rows,
               const void* dyn, const void* st, const void* accum,
               const void* tfin,
               const void* gacc, const void* gt, void* gdyn, void* gst, int T,
               int S, int Fd, int Fs, int cap, int nchan, int depth_in_dyn,
               int tiles_x, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<MAXC>(nchan);
  cudaError_t err = cudaFuncSetAttribute(
      window_bwd_kernel<MAXC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_bwd_kernel<MAXC><<<dim3(S, T), P, smem, stream>>>(
      (const int*)tile_ids, (const int*)counts, (const int*)rows,
      (const float*)dyn,
      (const float*)st, (const float*)accum, (const float*)tfin,
      (const float*)gacc, (const float*)gt, (float*)gdyn, (float*)gst, S, Fd,
      Fs, cap, nchan, depth_in_dyn, tiles_x);
  return (int)cudaGetLastError();
}

bool shape_ok(int T, int S, int Fd, int Fs, int cap, int nchan,
              int depth_in_dyn) {
  return T > 0 && S > 0 && S <= 65535 && cap > 0 && cap % CHUNK == 0 &&
         Fd == 6 + depth_in_dyn && Fs == 1 + nchan - depth_in_dyn &&
         nchan >= 1;
}

int dispatch_fwd(const void* tile_ids, const void* counts, const void* rows,
                 const void* dyn, const void* st, void* accum, void* tfin,
                 int T, int S, int Fd, int Fs, int cap, int nchan,
                 int depth_in_dyn, int tiles_x, void* stream) {
  if (!shape_ok(T, S, Fd, Fs, cap, nchan, depth_in_dyn))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = (cudaStream_t)stream;
  if (nchan <= 8)
    return launch_fwd<8>(tile_ids, counts, rows, dyn, st, accum, tfin, T, S,
                         Fd, Fs, cap, nchan, depth_in_dyn, tiles_x, st_);
  if (nchan <= 16)
    return launch_fwd<16>(tile_ids, counts, rows, dyn, st, accum, tfin, T, S,
                          Fd, Fs, cap, nchan, depth_in_dyn, tiles_x, st_);
  if (nchan <= 32)
    return launch_fwd<32>(tile_ids, counts, rows, dyn, st, accum, tfin, T, S,
                          Fd, Fs, cap, nchan, depth_in_dyn, tiles_x, st_);
  return (int)cudaErrorInvalidValue;
}

int dispatch_bwd(const void* tile_ids, const void* counts, const void* rows,
                 const void* dyn, const void* st, const void* accum,
                 const void* tfin, const void* gacc, const void* gt,
                 void* gdyn, void* gst, int T, int S, int Fd, int Fs, int cap,
                 int nchan, int depth_in_dyn, int tiles_x, void* stream) {
  if (!shape_ok(T, S, Fd, Fs, cap, nchan, depth_in_dyn))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = (cudaStream_t)stream;
  if (nchan <= 8)
    return launch_bwd<8>(tile_ids, counts, rows, dyn, st, accum, tfin, gacc,
                         gt, gdyn, gst, T, S, Fd, Fs, cap, nchan,
                         depth_in_dyn, tiles_x, st_);
  if (nchan <= 16)
    return launch_bwd<16>(tile_ids, counts, rows, dyn, st, accum, tfin, gacc,
                          gt, gdyn, gst, T, S, Fd, Fs, cap, nchan,
                          depth_in_dyn, tiles_x, st_);
  if (nchan <= 32)
    return launch_bwd<32>(tile_ids, counts, rows, dyn, st, accum, tfin, gacc,
                          gt, gdyn, gst, T, S, Fd, Fs, cap, nchan,
                          depth_in_dyn, tiles_x, st_);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes by ops/cuda_build.py). Each returns the
// cudaError_t of the launch (0 on success); nothing synchronises.
extern "C" int d4gs_window_fwd(const void* tile_ids, const void* counts,
                               const void* dyn, const void* st, void* accum,
                               void* tfin, int T, int S, int Fd, int Fs,
                               int cap, int nchan, int depth_in_dyn,
                               int tiles_x, void* stream) {
  return dispatch_fwd(tile_ids, counts, nullptr, dyn, st, accum, tfin, T, S,
                      Fd, Fs, cap, nchan, depth_in_dyn, tiles_x, stream);
}

extern "C" int d4gs_window_bwd(const void* tile_ids, const void* counts,
                               const void* dyn, const void* st,
                               const void* accum, const void* tfin,
                               const void* gacc, const void* gt, void* gdyn,
                               void* gst, int T, int S, int Fd, int Fs,
                               int cap, int nchan, int depth_in_dyn,
                               int tiles_x, void* stream) {
  return dispatch_bwd(tile_ids, counts, nullptr, dyn, st, accum, tfin, gacc,
                      gt, gdyn, gst, T, S, Fd, Fs, cap, nchan, depth_in_dyn,
                      tiles_x, stream);
}

// K6: sids (T,) are both the tile ids (pixel centres) and the row map into
// the shared (T_img + 1, S, ...) accum / tfin (and gacc / gt) buffers.
extern "C" int d4gs_window_scatter_fwd(const void* sids, const void* counts,
                                       const void* dyn, const void* st,
                                       void* accum, void* tfin, int T, int S,
                                       int Fd, int Fs, int cap, int nchan,
                                       int depth_in_dyn, int tiles_x,
                                       void* stream) {
  return dispatch_fwd(sids, counts, sids, dyn, st, accum, tfin, T, S, Fd, Fs,
                      cap, nchan, depth_in_dyn, tiles_x, stream);
}

extern "C" int d4gs_window_scatter_bwd(const void* sids, const void* counts,
                                       const void* dyn, const void* st,
                                       const void* accum, const void* tfin,
                                       const void* gacc, const void* gt,
                                       void* gdyn, void* gst, int T, int S,
                                       int Fd, int Fs, int cap, int nchan,
                                       int depth_in_dyn, int tiles_x,
                                       void* stream) {
  return dispatch_bwd(sids, counts, sids, dyn, st, accum, tfin, gacc, gt,
                      gdyn, gst, T, S, Fd, Fs, cap, nchan, depth_in_dyn,
                      tiles_x, stream);
}

extern "C" const char* d4gs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
