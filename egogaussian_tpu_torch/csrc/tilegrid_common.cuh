// Shared definitions of the compositor kernels (tilegrid_{fwd,bwd}.cu,
// chunked_pair.cuh for stream_{fwd,bwd}.cu and window_chunked_{fwd,bwd}.cu,
// window_split.cuh for window_{fwd,bwd}.cu).
// Every kernel evaluates a
// pair's alpha through the same inline function, so a backward's replayed
// transmittance sweep sees its forward's values operation for operation.
//
// Tile-grid pair layout: vals [n_slots, ch16, 128] float32, one 128-pair
// chunk per slot, stored transposed (row r of a chunk holds field r of its
// 128 pairs): rows mu_x, mu_y, a, b, c, op, col[0..D), z, zero padding up
// to ch16. meta [3, n_tiles] int32: (first chunk slot, pair count, fit-slot
// count). The stream layout is described in stream_fwd.cu.
#pragma once

#include <cuda_runtime.h>

namespace egogs {

constexpr int kChunk = 128;    // pairs per chunk
constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
// A tile skips its remaining chunks once every pixel has T < 1e-7: the
// rule of the TPU kernels (_SAT_SKIP_EPS), kept exactly so outputs match.
constexpr float kSatSkipEps = 1e-7f;

__host__ __device__ constexpr int ch16_of(int d) { return ((7 + d) + 7) / 8 * 8; }

struct PairAlpha {
  float alpha;  // gated alpha
  float raw;    // op * e, before the gates
  float power;  // min(-Q, 0)
  float e;      // exp(power)
  float dx, dy;
};

// alpha = min(op * exp(min(power, 0)), 0.99), zeroed below 1/255, with
// every rounding pinned in the plain twins' order
// (render/cuda_raster.py:_chunk_alphas: power = -0.5 * (a*dx*dx + c*dy*dy)
// - b*dx*dy, one rounding per operation, no contraction into FMAs). Every
// kernel's alpha is then the twins' float, so a pair whose alpha lands at
// the 1/255 gate falls on the same side in every kernel and twin;
// contracted, an ulp of power flips such gates (~4e-3 of alpha each) on a
// 1920x1080 frame of the kNN model.
__device__ __forceinline__ PairAlpha pair_alpha(float px, float py, float mx,
                                                float my, float a, float b,
                                                float c, float op) {
  PairAlpha r;
  r.dx = __fsub_rn(px, mx);
  r.dy = __fsub_rn(py, my);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, r.dx), r.dx),
                               __fmul_rn(__fmul_rn(c, r.dy), r.dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(b, r.dx), r.dy));
  r.power = fminf(power, 0.0f);
  r.e = expf(r.power);
  r.raw = __fmul_rn(op, r.e);
  const float alpha = fminf(r.raw, kAlphaMax);
  r.alpha = alpha < kAlphaEps ? 0.0f : alpha;
  return r;
}

}  // namespace egogs
