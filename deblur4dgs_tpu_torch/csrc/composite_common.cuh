// Shared device helpers of the tile compositors (window_composite.cu,
// dense_composite.cu): the constants of the reference's compositing rules,
// the alpha evaluation, a warp sum and the chunk staging.
#pragma once

#include <cuda_runtime.h>

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

// Stage chunk columns [off, off + CHUNK) of `rows` rows of a (rows, cap)
// slab into shared memory laid out (rows, CHUNK).
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int cap, int off) {
  for (int i = threadIdx.x; i < rows * CHUNK; i += P) {
    const int f = i / CHUNK, g = i % CHUNK;
    dst[i] = src[(size_t)f * cap + off + g];
  }
}

// Centre of pixel p of image tile `tile` on a grid tiles_x tiles wide.
__device__ __forceinline__ void pixel_centre(int tile, int tiles_x, int p,
                                             float* px, float* py) {
  *px = (float)((tile % tiles_x) * TILE) + (float)(p % TILE) + 0.5f;
  *py = (float)((tile / tiles_x) * TILE) + (float)(p / TILE) + 0.5f;
}

}  // namespace d4gs
