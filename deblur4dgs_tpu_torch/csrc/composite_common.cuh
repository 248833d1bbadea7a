// Shared device helpers of the tile compositors (window_composite.cu,
// dense_composite.cu): the constants of the reference's compositing rules,
// the alpha evaluation, warp sums (plain and transposed), the warp-to-pixel
// map and per-warp cull, and the host's per-instance resource query.
#pragma once

#include <cuda_runtime.h>

// Ablations of the compositor kernels for timing and for testing the checks,
// 0 (none) unless built with -DD4GS_ABLATE=<n> (scripts/torch_window_ab.py
// --variants); each changes the kernels' outputs:
//   1 (nosum)  the backward sums no value over the lanes of a warp;
//   2 (nowalk) both kernels walk no Gaussian: staging, combine and writes;
//   3 (strict) the cull tests |d| < r, dropping pairs exactly at the box.
#ifndef D4GS_ABLATE
#define D4GS_ABLATE 0
#endif

namespace d4gs {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;  // pixels of a tile = threads of a block
constexpr int CHUNK = 128;      // Gaussians staged per step (stop-rule unit)
constexpr int NWARPS = P / 32;
constexpr float ALPHA_CLAMP = 0.999f;
constexpr float ALPHA_CUTOFF = 1.0f / 255.0f;
constexpr float EARLY_STOP_T = 1e-4f;

struct AlphaOut {
  float alpha, dx, dy;
  bool live, active;
};

// _alpha_from_split / _alpha_from_packed (deblur4dgs_tpu/ops/rasterize.py
// :513 / :130) with round-to-nearest intrinsics, so that every forward and
// backward kernel computes bit-identical alphas and T (and therefore stops
// at the same chunk).
__device__ __forceinline__ AlphaOut alpha_at(float mx, float my, float ca,
                                             float cb, float cc, float r,
                                             float op, float px, float py) {
  AlphaOut o;
  o.dx = __fsub_rn(px, mx);
  o.dy = __fsub_rn(py, my);
  const float axx = __fmul_rn(__fmul_rn(ca, o.dx), o.dx);
  const float cyy = __fmul_rn(__fmul_rn(cc, o.dy), o.dy);
  const float bxy = __fmul_rn(__fmul_rn(cb, o.dx), o.dy);
  const float sigma = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(axx, cyy)), bxy);
  const float a_raw = __fmul_rn(op, expf(-fmaxf(sigma, 0.0f)));
  const bool inbox = fabsf(o.dx) <= r && fabsf(o.dy) <= r;
  o.live = inbox && sigma >= 0.0f && a_raw >= ALPHA_CUTOFF;
  o.active = o.live && a_raw < ALPHA_CLAMP;
  o.alpha = o.live ? fminf(a_raw, ALPHA_CLAMP) : 0.0f;
  return o;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Centre of pixel p of image tile `tile` on a grid tiles_x tiles wide.
__device__ __forceinline__ void pixel_centre(int tile, int tiles_x, int p,
                                             float* px, float* py) {
  *px = (float)((tile % tiles_x) * TILE) + (float)(p % TILE) + 0.5f;
  *py = (float)((tile / tiles_x) * TILE) + (float)(p / TILE) + 0.5f;
}

// The compositors' pixel-to-warp map: warp w covers the 8x4 pixel block
// (w & 1, w >> 1) of the tile, lane l its pixel (l & 7, l >> 3). Outputs
// stay indexed by p = y * TILE + x. ops/rasterize.py::warp_reach states the
// same map and cull on the CPU.
constexpr int WARP_W = 8;
constexpr int WARP_H = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ int warp_block_pixel(int warp, int lane) {
  return ((warp >> 1) * WARP_H + (lane >> 3)) * TILE + (warp & 1) * WARP_W +
         (lane & 7);
}

// The pixel centres of a warp's block: x in [xlo, xhi], y in [ylo, yhi].
struct WarpBox {
  float xlo, xhi, ylo, yhi;
};

__device__ __forceinline__ WarpBox warp_box(int tile, int tiles_x, int warp) {
  WarpBox b;
  b.xlo = (float)((tile % tiles_x) * TILE + (warp & 1) * WARP_W) + 0.5f;
  b.ylo = (float)((tile / tiles_x) * TILE + (warp >> 1) * WARP_H) + 0.5f;
  b.xhi = b.xlo + (float)(WARP_W - 1);
  b.yhi = b.ylo + (float)(WARP_H - 1);
  return b;
}

// Whether alpha_at's box test |px - mx| <= r, |py - my| <= r holds at any
// pixel centre of the warp's block. It is tested at the centre nearest the
// mean in x and in y, with the same rounded subtraction: rounding is
// monotone and odd, so that centre has the smallest |dx| (|dy|) of the
// block. A false therefore means alpha_at finds the pair dead at every
// pixel of the warp (and a true that some pixel passes the box test).
__device__ __forceinline__ bool warp_reaches(const WarpBox& b, float mx,
                                             float my, float r) {
  const float cx = fminf(fmaxf(floorf(mx) + 0.5f, b.xlo), b.xhi);
  const float cy = fminf(fmaxf(floorf(my) + 0.5f, b.ylo), b.yhi);
  if (D4GS_ABLATE == 3)
    return fabsf(__fsub_rn(cx, mx)) < r && fabsf(__fsub_rn(cy, my)) < r;
  return fabsf(__fsub_rn(cx, mx)) <= r && fabsf(__fsub_rn(cy, my)) <= r;
}

// One step of warp_sum_transposed: lanes with bit O set keep values
// [H, 2H) and send [0, H), the others keep [0, H) and send [H, 2H); each
// adds what its partner lane O away sent into v[0, H).
template <int H, int O, int N>
__device__ __forceinline__ void transpose_step(float (&v)[N], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL_MASK, send, O);
  }
}

// Transposed butterfly over the first K (16 or 32) values of v: each xor
// step keeps half the values a lane holds and sends the other half, K - 1
// shuffles in all (then 5 - log2 K plain steps), against 5 per value for
// warp_sum. On return v[0] of lane l holds the warp's sum of value
// l >> (5 - log2 K); every lane ends with the same sums for any inputs, in
// a fixed order.
template <int K, int N>
__device__ __forceinline__ void warp_sum_transposed(float (&v)[N]) {
  static_assert(K == 16 || K == 32, "K is 16 or 32");
  static_assert(N >= K, "v holds K values");
  const int lane = threadIdx.x & 31;
  transpose_step<K / 2, 16>(v, lane);
  transpose_step<K / 4, 8>(v, lane);
  transpose_step<K / 8, 4>(v, lane);
  transpose_step<K / 16, 2>(v, lane);
  if (K == 32)
    transpose_step<1, 1>(v, lane);
  else
    v[0] += __shfl_xor_sync(FULL_MASK, v[0], 1);
}

// Registers, local (spill) bytes, static and dynamic shared memory and
// the most resident blocks per SM of one kernel instance launched with P
// threads, into out[0..4].
template <typename K>
int kernel_info(K kernel, size_t dyn_smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn_smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, P,
                                                        dyn_smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)dyn_smem;
  out[4] = blocks;
  return (int)err;
}

}  // namespace d4gs
