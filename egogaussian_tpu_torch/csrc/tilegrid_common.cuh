// Shared definitions of the tile-grid compositor kernels (tilegrid_fwd.cu,
// tilegrid_bwd.cu). Both kernels evaluate a pair's alpha through the same
// inline function, so the backward's replayed transmittance sweep sees the
// forward's values operation for operation.
//
// Pair layout: vals [n_slots, ch16, 128] float32, one 128-pair chunk per
// slot, stored transposed (row r of a chunk holds field r of its 128 pairs):
//   rows mu_x, mu_y, a, b, c, op, col[0..D), z, zero padding up to ch16.
// meta [3, n_tiles] int32: (first chunk slot, pair count, fit-slot count).
#pragma once

#include <cuda_runtime.h>

namespace egogs {

constexpr int kChunk = 128;    // pairs per chunk
constexpr int kThreads = 256;  // threads per block (one block per tile)
constexpr int kWarps = kThreads / 32;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
// A tile skips its remaining chunks once every pixel has T < 1e-7: the
// rule of the TPU kernels (_SAT_SKIP_EPS), kept exactly so outputs match.
constexpr float kSatSkipEps = 1e-7f;

__host__ __device__ constexpr int ch16_of(int d) { return ((7 + d) + 7) / 8 * 8; }

struct PairAlpha {
  float alpha;  // gated alpha
  float raw;    // op * exp(power), before the gates
  float power;  // min(-Q, 0)
  float dx, dy;
};

// alpha = min(op * exp(min(power, 0)), 0.99), zeroed below 1/255
__device__ __forceinline__ PairAlpha pair_alpha(float px, float py, float mx,
                                                float my, float a, float b,
                                                float c, float op) {
  PairAlpha r;
  r.dx = px - mx;
  r.dy = py - my;
  const float power = -0.5f * (a * r.dx * r.dx + c * r.dy * r.dy) - b * r.dx * r.dy;
  r.power = fminf(power, 0.0f);
  r.raw = op * expf(r.power);
  const float alpha = fminf(r.raw, kAlphaMax);
  r.alpha = alpha < kAlphaEps ? 0.0f : alpha;
  return r;
}

// Copy one chunk (ch * 128 floats, 16-byte aligned) into shared memory.
__device__ __forceinline__ void load_chunk(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int n_floats) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n_floats / 4; i += kThreads) d4[i] = s4[i];
}

}  // namespace egogs
