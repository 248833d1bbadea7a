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
// Design (one thread block per (bucket row t, sub-frame s), 256 threads).
// The row's Gaussians are walked front to back in chunks of 128. Each chunk
// is staged Gaussian-major in shared memory -- (mx, my, r, op) and
// (a, b, c) as float4 records, the nchan channels (static channels, then
// the depth row of dyn) as a padded float4 record -- so a thread reads a
// Gaussian with a few 16-byte broadcast loads. Warp w owns the 8x4 pixel
// block (w & 1, w >> 1) of the tile (warp_block_pixel); a thread carries
// its pixel's transmittance T and nchan accumulators in registers.
// (One block per row over all S, as K1 does, would hold S * nchan = 121
// accumulators per pixel and spill.) Blocks are ordered with s fastest, so
// the S blocks that re-read st[t] run together and find it in L2.
//
// Per-warp cull. For each 32 Gaussians of a chunk, lane i tests Gaussian i
// against its warp's block (warp_reaches: alpha_at's rounded box test at
// the block's pixel centre nearest the mean) and the warp walks only the
// set bits of the ballot, in order. A pair outside the box is dead in
// alpha_at (alpha 0, T and every sum unchanged), so the cull drops no live
// pair and moves neither T nor the stop chunk. An 8x4 block reaches a
// Gaussian of box half-width r over (8 + 2r)(4 + 2r) pixel positions of
// its mean, against (16 + 2r)(2 + 2r) for a 16x2 row pair.
//
// Early-stop rule (identical in both kernels and in the plain twins): before
// each chunk, the (row, sub-frame) block stops if every one of its 256 pixels
// has T < 1e-4 (__syncthreads_or). Forward and backward recompute T with the
// same round-to-nearest intrinsics over the same live pairs, so they stop at
// the same chunk. K1/K3 stop the whole window at once instead; the difference
// is confined to the tail of a sub-frame after its own T fell below 1e-4.
//
// Backward. Per pixel it recomputes alpha and T in forward order and reads
// Total = sum_c accum * gacc from the forward outputs: the suffix sum after a
// Gaussian is Total - prefix_incl, so there are no stored per-Gaussian
// residuals and no division by a small T (only by 1 - alpha >= 0.001). A
// live pixel gives 6 + nchan values: the moments g_sigma * (1, dx, dy, dx^2,
// dx dy, dy^2) and ga_c * w; the mean, conic and opacity gradients are
// linear in those sums (g_mx = -(a Sx + b Sy), g_op = -S1 / op, ...). For
// each reached Gaussian with a live lane, the warp sums them with a
// transposed butterfly (warp_sum_transposed: 16 shuffles at nchan 5, 21 at
// nchan 11, against 55 and 85 for a butterfly per value) and writes one
// partial per value to shared memory. Every 32 Gaussians the block sums the
// 8 warp partials in warp order (skipping warps that wrote none) and writes
// those slots' gradients; the partial buffer is double-buffered over the
// 32-Gaussian sub-chunks (one barrier each), so it holds 2 x 8 x 32 x
// (6 + nchan) floats. Each block owns gdyn[t, s] and gst[t, s] and writes
// all of both (zeros past its stop chunk); the wrapper sums gst over the S
// sub-frames in a fixed order, so the backward is deterministic (no atomics:
// a resumed run repeats an uninterrupted one bit for bit).
//
// Instances: nchan 5 (static windows) and 11 (dynamic window) exactly, and
// a generic one up to 32 channels with runtime guards. None spills (ptxas,
// CUDA 12 on an H100): forward 39 / 42 / 61 registers and 6 / 5 / 4 blocks
// per SM (nchan 5 / 11 / generic); backward 48 / 63 / 126 registers, 31 /
// 45 / up to 100 KB of shared memory, 5 / 4 / 2 blocks per SM.
//
// What bounds it on an H100. On the bench-shape stage-2 step's 16 calls (3
// static windows at nchan 5 and the dynamic window at nchan 11, 1280x720,
// S=11, 4 buckets of 1.16M slots each) the forward moves 1.69 GB and the
// backward 4.47 GB (the payload slots before each (row, sub-frame)'s stop
// chunk, every other input read once, each output written once): 0.51 /
// 1.33 ms at 3.35 TB/s. Of the 3.93G (pixel, Gaussian) pairs up to the stop
// chunks, 1.50G lie inside alpha_at's box and 703M are live. Alpha (~20
// FP32 ops) is needed only inside the box, plus a box test per Gaussian and
// 8x4 block, and 2*nchan+3 (forward) or 4*nchan+36 (backward) ops per live
// pair: 43.6 / 77.8 Gop, 0.65 / 1.16 ms at 67 TFLOP/s. So the forward is
// bound by operations (0.65 ms) and the backward by bytes (1.33 ms).
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 4.776 / 13.828
// ms, 14% / 10% of those bounds; the design before the cull and the
// transposed butterfly took 10.350 / 49.764 ms on the same calls and card
// (scripts/torch_window_ab.py). The cull keeps 53% of the (warp, Gaussian)
// iterations. Ablations of the backward on the same calls (the same
// script, -DD4GS_ABLATE): without the lane sums 10.09 ms; walking no
// Gaussian (staging every chunk up to the count, the combine and the
// writes) 4.41 ms; the forward walking none 1.61 ms of 4.80. So alpha
// and the live lanes' values take most of the backward, the lane sums
// about a quarter. warp_sum_transposed is written as template steps with
// constant indices: written as a loop over the value indices, ptxas kept
// the nchan 11 values on the stack.

#include <cuda_runtime.h>

#include "composite_common.cuh"

namespace {

using namespace d4gs;

constexpr int SUB = 32;  // Gaussians per ballot: one per lane

// Channel slots per staged Gaussian: MAXC rounded up to float4s.
template <int MAXC>
__host__ __device__ constexpr int ncp() {
  return (MAXC + 3) / 4 * 4;
}

// One chunk staged Gaussian-major: geo (mx, my, r, op), con (a, b, c, -),
// ch[g * NCP + c] the channels (static channels, then dyn's depth row).
template <int MAXC>
struct Chunk {
  float4 geo[CHUNK];
  float4 con[CHUNK];
  float4 ch[CHUNK * ncp<MAXC>() / 4];
};

// Shared-memory address of value f (dyn rows, then static rows) of slot g.
template <int MAXC>
__device__ __forceinline__ float* stage_slot(Chunk<MAXC>& c, int f, int g,
                                             int Fd, int n_static) {
  constexpr int NCP = ncp<MAXC>();
  float* geo = reinterpret_cast<float*>(c.geo) + 4 * g;
  float* con = reinterpret_cast<float*>(c.con) + 4 * g;
  float* ch = reinterpret_cast<float*>(c.ch) + g * NCP;
  if (f < Fd)  // dyn rows: mx, my, a, b, c, r (, depth)
    return f < 2 ? geo + f : f < 5 ? con + (f - 2) : f == 5 ? geo + 2
                                                             : ch + n_static;
  return f == Fd ? geo + 3 : ch + (f - Fd - 1);  // opacity, channels
}

// Stage slots [off, off + n) of the (Fd, cap) dyn slab and the (Fs, cap)
// static slab into the chunk records.
template <int MAXC>
__device__ __forceinline__ void stage_chunk(Chunk<MAXC>& c, const float* d_row,
                                            const float* s_row, int Fd, int Fs,
                                            int cap, int off, int n,
                                            int n_static) {
  for (int i = threadIdx.x; i < (Fd + Fs) * CHUNK; i += P) {
    const int f = i / CHUNK, g = i % CHUNK;  // f is warp-uniform
    if (g >= n) continue;
    *stage_slot(c, f, g, Fd, n_static) =
        f < Fd ? d_row[(size_t)f * cap + off + g]
               : s_row[(size_t)(f - Fd) * cap + off + g];
  }
}

// Ballot of the Gaussians [base, base + SUB) of a staged chunk of n that
// reach the warp's block.
template <int MAXC>
__device__ __forceinline__ unsigned reach_ballot(const Chunk<MAXC>& c,
                                                 const WarpBox& box, int base,
                                                 int n) {
  const int g = base + (threadIdx.x & 31);
  bool reach = false;
  if (g < n && D4GS_ABLATE != 2) {
    const float4 q = c.geo[g];
    reach = warp_reaches(box, q.x, q.y, q.z);
  }
  return __ballot_sync(FULL_MASK, reach);
}

template <int MAXC, bool EXACT>
__global__ void __launch_bounds__(P)
window_fwd_kernel(const int* __restrict__ tile_ids,
                  const int* __restrict__ counts,
                  const int* __restrict__ rows,
                  const float* __restrict__ dyn, const float* __restrict__ st,
                  float* __restrict__ accum, float* __restrict__ tfin, int S,
                  int Fd, int Fs, int cap, int nchan, int depth_in_dyn,
                  int tiles_x) {
  __shared__ Chunk<MAXC> sm;
  const int s = blockIdx.x, t = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = warp_block_pixel(warp, lane);
  const int count = min(counts[t], cap);
  const int tile = tile_ids[t];
  float px, py;
  pixel_centre(tile, tiles_x, p, &px, &py);
  const WarpBox box = warp_box(tile, tiles_x, warp);
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
    const int n = min(CHUNK, count - off);
    stage_chunk(sm, d_row, s_row, Fd, Fs, cap, off, n, n_static);
    __syncthreads();
    for (int base = 0; base < n; base += SUB) {
      unsigned m = reach_ballot(sm, box, base, n);
      while (m) {
        const int g = base + __ffs(m) - 1;
        m &= m - 1;
        const float4 q = sm.geo[g], k = sm.con[g];
        const AlphaOut a = alpha_at(q.x, q.y, k.x, k.y, k.z, q.z, q.w, px, py);
        if (!a.live) continue;
        const float w = __fmul_rn(a.alpha, T);
        const float4* chg = sm.ch + g * (ncp<MAXC>() / 4);
#pragma unroll
        for (int j = 0; j < ncp<MAXC>() / 4; ++j) {
          if (!EXACT && 4 * j >= nchan) break;
          const float4 x = chg[j];
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * j + e;
            if (c < MAXC && (EXACT || c < nchan)) acc[c] += w * xs[e];
          }
        }
        T = __fmul_rn(T, __fsub_rn(1.0f, a.alpha));
      }
    }
  }
  float* a_out = accum + orow * nchan * P;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (EXACT || c < nchan) a_out[c * P + p] = acc[c];
  tfin[orow * P + p] = T;
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
// caps their registers at 65536 / (256 * this). 5 (48 registers) fits the
// nchan 5 instance without spilling, 4 (64) the nchan 11 one.
template <int MAXC, bool EXACT>
__host__ __device__ constexpr int bwd_min_blocks() {
  return !EXACT ? 1 : MAXC <= 5 ? 5 : 4;
}

template <int MAXC, bool EXACT>
__global__ void __launch_bounds__(P, (bwd_min_blocks<MAXC, EXACT>()))
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
  using B = BwdShape<MAXC>;
  __shared__ Chunk<MAXC> sm;
  __shared__ unsigned wrote[2][NWARPS];  // per sub-chunk: Gaussians written
  extern __shared__ float part[];        // (2, NWARPS, SUB, nvp)
  const int s = blockIdx.x, t = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = warp_block_pixel(warp, lane);
  const int count = min(counts[t], cap);
  const int tile = tile_ids[t];
  const int n_static = nchan - depth_in_dyn;
  const int nv = 6 + nchan, nvp = part_stride(nchan);
  const size_t row = (size_t)t * S + s;
  const float* d_row = dyn + row * Fd * cap;
  const float* s_row = st + (size_t)t * Fs * cap;
  float* gd_row = gdyn + row * Fd * cap;
  float* gs_row = gst + row * Fs * cap;
  if (count == 0) {  // an empty row: zero gradients, residuals never read
    for (int i = threadIdx.x; i < Fd * cap; i += P) gd_row[i] = 0.0f;
    for (int i = threadIdx.x; i < Fs * cap; i += P) gs_row[i] = 0.0f;
    return;
  }
  float px, py;
  pixel_centre(tile, tiles_x, p, &px, &py);
  const WarpBox box = warp_box(tile, tiles_x, warp);
  const size_t orow = (size_t)(rows ? rows[t] : t) * S + s;  // residual row

  float ga[MAXC];
  float total = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    ga[c] = 0.0f;
    if (EXACT || c < nchan) {
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
    const int n = min(CHUNK, count - off);
    stage_chunk(sm, d_row, s_row, Fd, Fs, cap, off, n, n_static);
    __syncthreads();
    for (int base = 0; base < CHUNK; base += SUB) {
      const int buf = (base / SUB) & 1;
      float* pw = part + (size_t)(buf * NWARPS + warp) * SUB * nvp;
      unsigned m = reach_ballot(sm, box, base, n), done = 0;
      while (m) {
        const int gs = __ffs(m) - 1;
        m &= m - 1;
        const int g = base + gs;
        const float4 q = sm.geo[g], k = sm.con[g];
        const AlphaOut a = alpha_at(q.x, q.y, k.x, k.y, k.z, q.z, q.w, px, py);
        float v[B::NVR];
#pragma unroll
        for (int j = 0; j < B::NVR; ++j) v[j] = 0.0f;
        if (a.live) {
          const float w = __fmul_rn(a.alpha, T);
          const float4* chg = sm.ch + g * (ncp<MAXC>() / 4);
          float sdot = 0.0f;
#pragma unroll
          for (int j = 0; j < ncp<MAXC>() / 4; ++j) {
            if (!EXACT && 4 * j >= nchan) break;
            const float4 x = chg[j];
            const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 4 * j + e;
              if (c < MAXC && (EXACT || c < nchan)) {
                sdot += ga[c] * xs[e];
                v[6 + c] = ga[c] * w;
              }
            }
          }
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
        const int idx = B::KT == 16 ? lane >> 1 : lane;
        if ((B::KT == 32 || !(lane & 1)) && idx < nv) pg[idx] = v[0];
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
      // order and write their gradients: rows f = g_mx, g_my, g_a, g_b,
      // g_c, 0 (radius), g_op, then the channels.
      unsigned any = 0;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) any |= wrote[buf][w];
      for (int i = threadIdx.x; i < (7 + nchan) * SUB; i += P) {
        const int f = i / SUB, gs = i % SUB;  // f is warp-uniform
        const unsigned bit = 1u << gs;
        float val = 0.0f;
        if ((any & bit) && f != 5) {
          const float* col = part + (size_t)buf * NWARPS * SUB * nvp + gs * nvp;
          unsigned from = 0;  // the warps that wrote this Gaussian
#pragma unroll
          for (int w = 0; w < NWARPS; ++w)
            from |= ((wrote[buf][w] & bit) ? 1u : 0u) << w;
          const auto sum = [=](int kv) {
            return sum_warps(col, SUB * nvp, from, kv);
          };
          const int g = base + gs;
          if (f < 2) {
            const float4 k = sm.con[g];
            const float sx = sum(1), sy = sum(2);
            val = f == 0 ? -(k.x * sx + k.y * sy) : -(k.z * sy + k.y * sx);
          } else if (f < 5) {  // 0.5 Sxx, Sxy, 0.5 Syy
            val = (f == 3 ? 1.0f : 0.5f) * sum(f + 1);
          } else if (f == 6) {
            val = -sum(0) / fmaxf(sm.geo[g].w, 1e-12f);
          } else {
            val = sum(f - 1);  // channel f - 7 is value 6 + (f - 7)
          }
        }
        const size_t slot = (size_t)off + base + gs;
        if (f < 6) {
          gd_row[(size_t)f * cap + slot] = val;
        } else if (f == 6) {
          gs_row[slot] = val;
        } else if (f - 7 < n_static) {
          gs_row[(size_t)(f - 6) * cap + slot] = val;
        } else {
          gd_row[(size_t)6 * cap + slot] = val;  // depth channel -> dyn row 6
        }
      }
    }
  }
  // slots this (row, s) never reached get zero gradients
  for (int f = 0; f < Fd; ++f)
    for (int i = ci * CHUNK + threadIdx.x; i < cap; i += P)
      gd_row[(size_t)f * cap + i] = 0.0f;
  for (int f = 0; f < Fs; ++f)
    for (int i = ci * CHUNK + threadIdx.x; i < cap; i += P)
      gs_row[(size_t)f * cap + i] = 0.0f;
}

template <int MAXC, bool EXACT>
int launch_fwd(const void* tile_ids, const void* counts, const void* rows,
               const void* dyn, const void* st, void* accum, void* tfin,
               int T, int S, int Fd, int Fs, int cap, int nchan,
               int depth_in_dyn, int tiles_x, cudaStream_t stream) {
  window_fwd_kernel<MAXC, EXACT><<<dim3(S, T), P, 0, stream>>>(
      (const int*)tile_ids, (const int*)counts, (const int*)rows,
      (const float*)dyn, (const float*)st, (float*)accum, (float*)tfin, S, Fd,
      Fs, cap, nchan, depth_in_dyn, tiles_x);
  return (int)cudaGetLastError();
}

template <int MAXC, bool EXACT>
int launch_bwd(const void* tile_ids, const void* counts, const void* rows,
               const void* dyn, const void* st, const void* accum,
               const void* tfin, const void* gacc, const void* gt, void* gdyn,
               void* gst, int T, int S, int Fd, int Fs, int cap, int nchan,
               int depth_in_dyn, int tiles_x, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(nchan);
  cudaError_t err = cudaFuncSetAttribute(
      window_bwd_kernel<MAXC, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_bwd_kernel<MAXC, EXACT><<<dim3(S, T), P, smem, stream>>>(
      (const int*)tile_ids, (const int*)counts, (const int*)rows,
      (const float*)dyn, (const float*)st, (const float*)accum,
      (const float*)tfin, (const float*)gacc, (const float*)gt, (float*)gdyn,
      (float*)gst, S, Fd, Fs, cap, nchan, depth_in_dyn, tiles_x);
  return (int)cudaGetLastError();
}

constexpr int MAX_NCHAN = 32;  // the generic instance's channels

bool shape_ok(int T, int S, int Fd, int Fs, int cap, int nchan,
              int depth_in_dyn) {
  return T > 0 && S > 0 && S <= 65535 && cap > 0 && cap % CHUNK == 0 &&
         Fd == 6 + depth_in_dyn && Fs == 1 + nchan - depth_in_dyn &&
         nchan >= 1 && nchan <= MAX_NCHAN;
}

// The instance for nchan: exact at 5 (static windows) and 11 (dynamic
// window), generic up to MAX_NCHAN.
#define D4GS_BY_NCHAN(nchan, CALL)                          \
  ((nchan) == 5 ? CALL(5, true) : (nchan) == 11 ? CALL(11, true) \
                                                : CALL(MAX_NCHAN, false))

int dispatch_fwd(const void* tile_ids, const void* counts, const void* rows,
                 const void* dyn, const void* st, void* accum, void* tfin,
                 int T, int S, int Fd, int Fs, int cap, int nchan,
                 int depth_in_dyn, int tiles_x, void* stream) {
  if (!shape_ok(T, S, Fd, Fs, cap, nchan, depth_in_dyn))
    return (int)cudaErrorInvalidValue;
#define D4GS_FWD(MAXC, EXACT)                                              \
  launch_fwd<MAXC, EXACT>(tile_ids, counts, rows, dyn, st, accum, tfin, T, \
                          S, Fd, Fs, cap, nchan, depth_in_dyn, tiles_x,    \
                          (cudaStream_t)stream)
  return D4GS_BY_NCHAN(nchan, D4GS_FWD);
#undef D4GS_FWD
}

int dispatch_bwd(const void* tile_ids, const void* counts, const void* rows,
                 const void* dyn, const void* st, const void* accum,
                 const void* tfin, const void* gacc, const void* gt,
                 void* gdyn, void* gst, int T, int S, int Fd, int Fs, int cap,
                 int nchan, int depth_in_dyn, int tiles_x, void* stream) {
  if (!shape_ok(T, S, Fd, Fs, cap, nchan, depth_in_dyn))
    return (int)cudaErrorInvalidValue;
#define D4GS_BWD(MAXC, EXACT)                                                \
  launch_bwd<MAXC, EXACT>(tile_ids, counts, rows, dyn, st, accum, tfin,      \
                          gacc, gt, gdyn, gst, T, S, Fd, Fs, cap, nchan,     \
                          depth_in_dyn, tiles_x, (cudaStream_t)stream)
  return D4GS_BY_NCHAN(nchan, D4GS_BWD);
#undef D4GS_BWD
}

template <int MAXC, bool EXACT>
int info_pair(int nchan, int* out) {
  const int err = kernel_info(window_fwd_kernel<MAXC, EXACT>, 0, out);
  return err ? err
             : kernel_info(window_bwd_kernel<MAXC, EXACT>,
                           bwd_smem_bytes(nchan), out + 5);
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

// Registers, local (spill) bytes, static and dynamic shared memory, and
// the most resident blocks per SM, of the forward (out[0..4]) and backward
// (out[5..9]) instances that a call with nchan channels launches.
extern "C" int d4gs_window_kernel_info(int nchan, int* out) {
  if (nchan < 1 || nchan > MAX_NCHAN) return (int)cudaErrorInvalidValue;
#define D4GS_INFO(MAXC, EXACT) info_pair<MAXC, EXACT>(nchan, out)
  return D4GS_BY_NCHAN(nchan, D4GS_INFO);
#undef D4GS_INFO
}

extern "C" const char* d4gs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
