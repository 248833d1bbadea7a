// Indexed dense tile compositor, forward and backward, for sm_90a: each
// image-tile row reads its Gaussians' rows by index from one per-Gaussian
// table.
//
// Replaces the TPU Pallas kernel K5 of deblur4dgs_tpu/ops/rasterize.py:
//   forward  -> _fwd_kernel (rasterize.py:160)
//   backward -> _bwd_kernel / _bwd_one_tile (rasterize.py:207, :221)
// The plain PyTorch twins composite_dense_plain / composite_dense_bwd_plain
// (deblur4dgs_tpu_torch/ops/rasterize.py) gather table[idx] into K5's dense
// layout and compute the same numbers with the same loop semantics;
// chip_smoke.py holds each kernel against its twin.
//
// Layout (float32; idx and counts int32; dense row-major):
//   idx    (T, cap)    row t is image tile t; slot j < counts[t] holds the
//                      table row of the row's j-th Gaussian in depth order
//   table  (G + 1, Fp) rows [mx, my, conic_a, conic_b, conic_c, opacity,
//                      radius, channel_0 .. channel_{D-1}, 0 ..], Fp = 7 + D
//                      rounded up to a multiple of 4 (a row is Fp / 4
//                      float4s); row G is the zero sentinel
//   accum  (T, P, D), tfin (T, P, 1)  pixel-major, as K5 writes them
//   gslot  (T * cap + 1, Fp) per slot t * cap + j: [g_mx, g_my, g_a, g_b,
//                      g_c, g_op, 0, g_channels, 0 ..], written for the slots
//                      j < counts[t] only (zeros past the row's stop chunk);
//                      the last row is the sink that dropped pairs name,
//                      never written or read. The host sums each Gaussian's
//                      slots in a fixed order (ops/rasterize.py::
//                      dense_table_grad).
// The reference packs (T, 7 + D, cap) by a gather of every slot; here the
// kernels read only the rows the walked slots name, and the table (60k x 12
// floats = 2.9 MB on the bench call) stays in L2.
//
// Design (one 256-thread block per tile row, after the window kernels of
// window_composite.cu). Each 128-slot chunk stages idx[t, off : off + n]'s
// table rows into shared memory as they are, float4 by float4; warp w owns
// the 8x4 pixel block (w & 1, w >> 1) of the tile (warp_block_pixel), a
// thread carries its pixel's T and D accumulators in registers (D <= 16).
// Per 32 staged Gaussians each warp ballots the ones whose box reaches its
// block (warp_reaches: alpha_at's own rounded box test at the block's
// pixel centre nearest the mean) and walks only those, in order; a pair
// outside the box is dead in alpha_at, so the cull moves neither T nor the
// stop chunk. Stop rule: before each chunk, the block stops once all 256
// pixels have T < 1e-4 (__syncthreads_or), as K5 does (:192-194,
// :287-289); alpha and T use the round-to-nearest helpers of
// composite_common.cuh, so the backward recomputes the forward's T bit for
// bit and stops at the same chunk.
//
// Backward, after _bwd_one_tile: per pixel, Total = sum_d accum * gacc and
// gt_term = gt * tfin from the forward outputs; the prefix of w * (gacc .
// channels) is carried across chunks and the suffix after a Gaussian is
// Total - prefix_incl, so there are no stored residuals and the only
// division is by 1 - alpha >= 0.001. A live pixel gives 6 + D values: the
// moments g_sigma * (1, dx, dy, dx^2, dx dy, dy^2) and gacc_d * w; the mean,
// conic and opacity gradients are linear in their sums. Per reached
// Gaussian with a live lane the warp sums them with the transposed
// butterfly (warp_sum_transposed, 16 values at D <= 10) and writes one
// partial per value to shared memory; every 32 Gaussians the block sums the
// 8 warp partials in warp order (skipping warps that wrote none) and writes
// those slots' rows of gslot. The partial buffer is double-buffered over
// the 32-Gaussian sub-chunks (one barrier each). A slot belongs to one row,
// so every gslot row is written once, without atomics.
//
// Instances: D = 4 (the static-reg render: rgb + mask) and D = 5 (the
// sharp render with expected depth) exactly, and a generic one up to 16
// channels with runtime guards; chip_smoke.py prints each instance's
// registers, spill bytes, shared memory and blocks per SM.
//
// What bounds it on an H100. On the static-reg render of the bench scene
// (1280x720, 60k background Gaussians, cap 1024, D = 4: 3600 rows) the
// kernels walk the slots before each row's stop chunk. The forward reads
// those slots' idx entries and (once) the table rows they name and writes
// accum and tfin: 0.022 GB, 0.0066 ms at 3.35 TB/s; the backward reads the
// same plus the forward outputs and the cotangents and writes gslot for
// the slots < count: 0.054 GB, 0.0161 ms. Of the 70.7M (pixel, Gaussian)
// pairs up to the stop chunks, 23.8M lie inside alpha_at's box and 11.2M
// are live; alpha (~20 FP32 operations) inside the box, a box test per
// Gaussian and 8x4 block, and 2D + 3 (forward) or 4D + 36 (backward)
// operations per live pair make 0.61 / 1.07 Gop, 0.0091 / 0.0159 ms at 67
// TFLOP/s. So the forward is bound by operations (0.0091 ms), the backward
// by bytes (0.0161 ms). Measured (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700 W; device time with the launches queued): 0.0725 / 0.2013 ms, 13% /
// 8% of those bounds. The previous dense-layout kernels (one block per row,
// every pair evaluated, a warp_sum per value, the whole (T, 11, cap)
// gradient written) took 0.145 / 0.504 ms on the same call and card, and
// their payload gather's backward 34 ms (scripts/torch_window_ab.py). Ablations
// (the same script): walking no Gaussian 0.014 / 0.034 ms, every count 0
// 0.010 / 0.004 ms (so more rows per block could save at most ~0.01 ms),
// the backward without its lane sums 0.134 ms. As in the window kernels,
// the time goes to alpha and the live lanes' values on the kept
// iterations, then the lane sums.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace d4gs;

constexpr int NPARAM = 7;  // table columns before the channels
constexpr int SUB = 32;    // Gaussians per ballot: one per lane
constexpr int MAX_DENSE_CHANNELS = 16;

// Floats of a table row: 7 + nchan rounded up to a multiple of 4.
__host__ __device__ constexpr int row_floats(int nchan) {
  return (NPARAM + nchan + 3) / 4 * 4;
}

// Stage the table rows named by slots [0, n) of idx_row (q float4s each)
// into sm, one float4 per thread and step.
__device__ __forceinline__ void stage_rows(float4* sm,
                                           const int* __restrict__ idx_row,
                                           const float4* __restrict__ table,
                                           int n, int q) {
  for (int i = threadIdx.x; i < n * q; i += P) {
    const int g = i / q, k = i - g * q;
    sm[i] = table[(size_t)idx_row[g] * q + k];
  }
}

// Ballot of the staged Gaussians [base, base + SUB) of n that reach the
// warp's block (row record 0 = mx, my, a, b; record 1 = c, op, r, ch0).
__device__ __forceinline__ unsigned dense_reach(const float4* sm, int q,
                                                const WarpBox& box, int base,
                                                int n) {
  const int g = base + (threadIdx.x & 31);
  bool reach = false;
  if (g < n && D4GS_ABLATE != 2) {
    const float4 r0 = sm[g * q], r1 = sm[g * q + 1];
    reach = warp_reaches(box, r0.x, r0.y, r1.z);
  }
  return __ballot_sync(FULL_MASK, reach);
}

// alpha_at on a staged row.
__device__ __forceinline__ AlphaOut row_alpha(const float4& r0,
                                              const float4& r1, float px,
                                              float py) {
  return alpha_at(r0.x, r0.y, r0.z, r0.w, r1.x, r1.z, r1.y, px, py);
}

// f(c, value) for each channel c of a staged row: channel 0 shares record
// 1 with c, op and r; channel c >= 1 is element (7 + c) % 4 of record
// (7 + c) / 4.
template <int MAXC, bool EXACT, typename Fn>
__device__ __forceinline__ void for_channels(const float4* row,
                                             const float4& r1, int nchan,
                                             Fn f) {
  f(0, r1.w);
#pragma unroll
  for (int j = 2; j < row_floats(MAXC) / 4; ++j) {
    if (!EXACT && 4 * j >= NPARAM + nchan) break;
    const float4 x = row[j];
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * j + e - NPARAM;
      if (c < MAXC && (EXACT || c < nchan)) f(c, xs[e]);
    }
  }
}

// Blocks per SM the forward instances are compiled for: __launch_bounds__
// caps their registers at 65536 / (256 * this). Without a minimum, ptxas
// gave the exact instances 32 registers and spilled 12-16 bytes; at 6 the
// exact ones take 40 registers and the generic one spills, at 5 it does not
// (ptxas -v, CUDA 12, sm_90a).
template <bool EXACT>
__host__ __device__ constexpr int fwd_min_blocks() {
  return EXACT ? 6 : 5;
}

template <int MAXC, bool EXACT>
__global__ void __launch_bounds__(P, (fwd_min_blocks<EXACT>()))
dense_fwd_kernel(const int* __restrict__ idx, const int* __restrict__ counts,
                 const float4* __restrict__ table, float* __restrict__ accum,
                 float* __restrict__ tfin, int cap, int nchan, int tiles_x) {
  constexpr int QM = row_floats(MAXC) / 4;
  __shared__ float4 sm[CHUNK * QM];
  const int q = EXACT ? QM : row_floats(nchan) / 4;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = warp_block_pixel(warp, lane);
  const int count = min(counts[t], cap);
  float px, py;
  pixel_centre(t, tiles_x, p, &px, &py);
  const WarpBox box = warp_box(t, tiles_x, warp);
  const int* idx_row = idx + (size_t)t * cap;

  float acc[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) acc[c] = 0.0f;
  float T = 1.0f;
  const int nchunks = (count + CHUNK - 1) / CHUNK;
  for (int ci = 0; ci < nchunks; ++ci) {
    // stop rule; also the barrier before shared memory is overwritten
    if (!__syncthreads_or(T >= EARLY_STOP_T)) break;
    const int off = ci * CHUNK;
    const int n = min(CHUNK, count - off);
    stage_rows(sm, idx_row + off, table, n, q);
    __syncthreads();
    for (int base = 0; base < n; base += SUB) {
      unsigned m = dense_reach(sm, q, box, base, n);
      while (m) {
        const int g = base + __ffs(m) - 1;
        m &= m - 1;
        const float4* row = sm + g * q;
        const float4 r0 = row[0], r1 = row[1];
        const AlphaOut a = row_alpha(r0, r1, px, py);
        if (!a.live) continue;
        const float w = __fmul_rn(a.alpha, T);
        for_channels<MAXC, EXACT>(row, r1, nchan,
                                  [&](int c, float x) { acc[c] += w * x; });
        T = __fmul_rn(T, __fsub_rn(1.0f, a.alpha));
      }
    }
  }
  float* a_out = accum + ((size_t)t * P + p) * nchan;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (EXACT || c < nchan) a_out[c] = acc[c];
  tfin[(size_t)t * P + p] = T;
}

// The backward's reduction: values 0..KT-1 by the transposed butterfly,
// the rest (NV_MAX > KT) each by warp_sum.
template <int MAXC>
struct BwdShape {
  static constexpr int NV_MAX = 6 + MAXC;
  static constexpr int KT = NV_MAX <= 20 ? 16 : 32;
  static constexpr int NVR = NV_MAX > KT ? NV_MAX : KT;  // registers
};

// Floats of the partial buffer: 2 sub-chunk buffers x NWARPS x SUB x nvp,
// nvp = 6 + nchan made odd (conflict-free column reads).
__host__ __device__ int part_stride(int nchan) { return (6 + nchan) | 1; }
size_t bwd_smem_bytes(int nchan) {
  return sizeof(float) * 2 * NWARPS * SUB * (size_t)part_stride(nchan);
}

// Sum, in warp order, of value kv of one Gaussian's warp partials (col:
// warp 0's, warp w's at w * stride), over the warps set in `from`.
__device__ __forceinline__ float sum_warps(const float* col, int stride,
                                           unsigned from, int kv) {
  float acc = 0.0f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w)
    if (from & (1u << w)) acc += col[w * stride + kv];
  return acc;
}

// Blocks per SM the backward instances are compiled for: __launch_bounds__
// caps their registers at 65536 / (256 * this).
template <int MAXC, bool EXACT>
__host__ __device__ constexpr int bwd_min_blocks() {
  return EXACT ? 5 : 1;
}

template <int MAXC, bool EXACT>
__global__ void __launch_bounds__(P, (bwd_min_blocks<MAXC, EXACT>()))
dense_bwd_kernel(const int* __restrict__ idx, const int* __restrict__ counts,
                 const float4* __restrict__ table,
                 const float* __restrict__ accum,
                 const float* __restrict__ tfin,
                 const float* __restrict__ gacc, const float* __restrict__ gt,
                 float* __restrict__ gslot, int cap, int nchan, int tiles_x) {
  using B = BwdShape<MAXC>;
  constexpr int QM = row_floats(MAXC) / 4;
  __shared__ float4 sm[CHUNK * QM];
  __shared__ unsigned wrote[2][NWARPS];  // per sub-chunk: Gaussians written
  extern __shared__ float part[];        // (2, NWARPS, SUB, nvp)
  const int q = EXACT ? QM : row_floats(nchan) / 4;
  const int fp = 4 * q;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = warp_block_pixel(warp, lane);
  const int count = min(counts[t], cap);
  const int nv = 6 + nchan, nvp = part_stride(nchan);
  if (count == 0) return;  // no slot to write, residuals never read
  float* g_row = gslot + (size_t)t * cap * fp;
  const int* idx_row = idx + (size_t)t * cap;
  float px, py;
  pixel_centre(t, tiles_x, p, &px, &py);
  const WarpBox box = warp_box(t, tiles_x, warp);

  const size_t pix = (size_t)t * P + p;
  float ga[MAXC];
  float total = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    ga[c] = 0.0f;
    if (EXACT || c < nchan) {
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
    const int n = min(CHUNK, count - off);
    stage_rows(sm, idx_row + off, table, n, q);
    __syncthreads();
    for (int base = 0; base < n; base += SUB) {
      const int buf = (base / SUB) & 1;
      float* pw = part + (size_t)(buf * NWARPS + warp) * SUB * nvp;
      unsigned m = dense_reach(sm, q, box, base, n), done = 0;
      while (m) {
        const int gs = __ffs(m) - 1;
        m &= m - 1;
        const float4* row = sm + (base + gs) * q;
        const float4 r0 = row[0], r1 = row[1];
        const AlphaOut a = row_alpha(r0, r1, px, py);
        float v[B::NVR];
#pragma unroll
        for (int j = 0; j < B::NVR; ++j) v[j] = 0.0f;
        if (a.live) {
          const float w = __fmul_rn(a.alpha, T);
          float sdot = 0.0f;
          for_channels<MAXC, EXACT>(row, r1, nchan, [&](int c, float x) {
            sdot += ga[c] * x;
            v[6 + c] = ga[c] * w;
          });
          prefix += w * sdot;  // inclusive prefix
          if (a.active) {
            const float suffix = total - prefix;
            const float g_alpha =  // 1 - alpha >= 0.001
                T * sdot - __fdividef(suffix + gt_term, 1.0f - a.alpha);
            const float g_sigma = -a.alpha * g_alpha;
            v[0] = g_sigma;
            v[1] = g_sigma * a.dx;
            v[2] = g_sigma * a.dy;
            v[3] = v[1] * a.dx;
            v[4] = v[1] * a.dy;
            v[5] = v[2] * a.dy;
          }
          T = __fmul_rn(T, __fsub_rn(1.0f, a.alpha));
        }
        if (!__any_sync(FULL_MASK, a.live)) continue;  // warp-uniform
        if (D4GS_ABLATE != 1) warp_sum_transposed<B::KT>(v);
        float* pg = pw + gs * nvp;
        const int iv = B::KT == 16 ? lane >> 1 : lane;
        if ((B::KT == 32 || !(lane & 1)) && iv < nv) pg[iv] = v[0];
#pragma unroll
        for (int j = B::KT; j < B::NVR; ++j) {
          if (EXACT || j < nv) {
            const float x = D4GS_ABLATE == 1 ? v[j] : warp_sum(v[j]);
            if (lane == 0) pg[j] = x;
          }
        }
        done |= 1u << gs;
      }
      if (lane == 0) wrote[buf][warp] = done;
      __syncthreads();
      // Sum the 8 warp partials of Gaussians [base, base + SUB) in warp
      // order and write their slots' rows: f = g_mx, g_my, g_a, g_b, g_c,
      // g_op, 0 (radius), the channels, 0 (padding).
      unsigned any = 0;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) any |= wrote[buf][w];
      const int nsub = min(SUB, n - base);
      for (int i = threadIdx.x; i < fp * SUB; i += P) {
        const int f = i / SUB, gs = i % SUB;  // f is warp-uniform
        if (gs >= nsub) continue;
        const unsigned bit = 1u << gs;
        float val = 0.0f;
        if ((any & bit) && f != 6 && f < NPARAM + nchan) {
          const float* col = part + (size_t)buf * NWARPS * SUB * nvp + gs * nvp;
          unsigned from = 0;  // the warps that wrote this Gaussian
#pragma unroll
          for (int w = 0; w < NWARPS; ++w)
            from |= ((wrote[buf][w] & bit) ? 1u : 0u) << w;
          const auto sum = [=](int kv) {
            return sum_warps(col, SUB * nvp, from, kv);
          };
          const float4* row = sm + (base + gs) * q;
          if (f < 2) {
            const float4 r0 = row[0];
            const float cc = row[1].x, sx = sum(1), sy = sum(2);
            val = f == 0 ? -(r0.z * sx + r0.w * sy) : -(cc * sy + r0.w * sx);
          } else if (f < 5) {  // 0.5 Sxx, Sxy, 0.5 Syy
            val = (f == 3 ? 1.0f : 0.5f) * sum(f + 1);
          } else if (f == 5) {
            val = -sum(0) / fmaxf(row[1].y, 1e-12f);
          } else {
            val = sum(f - 1);  // channel f - 7 is value 6 + (f - 7)
          }
        }
        g_row[(size_t)(off + base + gs) * fp + f] = val;
      }
    }
  }
  // slots [ci * CHUNK, count) lie past the stop chunk: zero gradients
  for (int i = ci * CHUNK * fp + threadIdx.x; i < count * fp; i += P)
    g_row[i] = 0.0f;
}

template <int MAXC, bool EXACT>
int launch_fwd(const void* idx, const void* counts, const void* table,
               void* accum, void* tfin, int T, int cap, int nchan,
               int tiles_x, cudaStream_t stream) {
  dense_fwd_kernel<MAXC, EXACT><<<T, P, 0, stream>>>(
      (const int*)idx, (const int*)counts, (const float4*)table,
      (float*)accum, (float*)tfin, cap, nchan, tiles_x);
  return (int)cudaGetLastError();
}

template <int MAXC, bool EXACT>
int launch_bwd(const void* idx, const void* counts, const void* table,
               const void* accum, const void* tfin, const void* gacc,
               const void* gt, void* gslot, int T, int cap, int nchan,
               int tiles_x, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(nchan);
  cudaError_t err = cudaFuncSetAttribute(
      dense_bwd_kernel<MAXC, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dense_bwd_kernel<MAXC, EXACT><<<T, P, smem, stream>>>(
      (const int*)idx, (const int*)counts, (const float4*)table,
      (const float*)accum, (const float*)tfin, (const float*)gacc,
      (const float*)gt, (float*)gslot, cap, nchan, tiles_x);
  return (int)cudaGetLastError();
}

bool shape_ok(int T, int cap, int Fp, int nchan) {
  return T > 0 && cap > 0 && cap % CHUNK == 0 && nchan >= 1 &&
         nchan <= MAX_DENSE_CHANNELS && Fp == row_floats(nchan);
}

// The instance for nchan: exact at 4 and 5, generic up to 16.
#define D4GS_DENSE_BY_NCHAN(nchan, CALL)                      \
  ((nchan) == 4 ? CALL(4, true) : (nchan) == 5 ? CALL(5, true) \
                                               : CALL(MAX_DENSE_CHANNELS, false))

template <int MAXC, bool EXACT>
int info_pair(int nchan, int* out) {
  const int err = kernel_info(dense_fwd_kernel<MAXC, EXACT>, 0, out);
  return err ? err
             : kernel_info(dense_bwd_kernel<MAXC, EXACT>,
                           bwd_smem_bytes(nchan), out + 5);
}

}  // namespace

// C interface (bound with ctypes by ops/cuda_build.py). Each returns the
// cudaError_t of the launch (0 on success); nothing synchronises. The table
// must be 16-byte aligned (its rows are read as float4s).
extern "C" int d4gs_dense_fwd(const void* idx, const void* counts,
                              const void* table, void* accum, void* tfin,
                              int T, int cap, int Fp, int nchan, int tiles_x,
                              void* stream) {
  if (!shape_ok(T, cap, Fp, nchan)) return (int)cudaErrorInvalidValue;
#define D4GS_FWD(MAXC, EXACT)                                        \
  launch_fwd<MAXC, EXACT>(idx, counts, table, accum, tfin, T, cap, nchan, \
                          tiles_x, (cudaStream_t)stream)
  return D4GS_DENSE_BY_NCHAN(nchan, D4GS_FWD);
#undef D4GS_FWD
}

// gslot holds T * cap + 1 rows of Fp floats (see the layout above).
extern "C" int d4gs_dense_bwd(const void* idx, const void* counts,
                              const void* table, const void* accum,
                              const void* tfin, const void* gacc,
                              const void* gt, void* gslot, int T, int cap,
                              int Fp, int nchan, int tiles_x, void* stream) {
  if (!shape_ok(T, cap, Fp, nchan)) return (int)cudaErrorInvalidValue;
#define D4GS_BWD(MAXC, EXACT)                                              \
  launch_bwd<MAXC, EXACT>(idx, counts, table, accum, tfin, gacc, gt, gslot, \
                          T, cap, nchan, tiles_x, (cudaStream_t)stream)
  return D4GS_DENSE_BY_NCHAN(nchan, D4GS_BWD);
#undef D4GS_BWD
}

// Registers, local (spill) bytes, static and dynamic shared memory, and
// the most resident blocks per SM, of the forward (out[0..4]) and backward
// (out[5..9]) instances that a call with nchan channels launches.
extern "C" int d4gs_dense_kernel_info(int nchan, int* out) {
  if (nchan < 1 || nchan > MAX_DENSE_CHANNELS)
    return (int)cudaErrorInvalidValue;
#define D4GS_INFO(MAXC, EXACT) info_pair<MAXC, EXACT>(nchan, out)
  return D4GS_DENSE_BY_NCHAN(nchan, D4GS_INFO);
#undef D4GS_INFO
}
