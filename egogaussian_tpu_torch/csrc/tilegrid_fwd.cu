// Tile-grid compositor, forward.
//
// Replaces: egogaussian_tpu/render/pallas_raster.py, _tilegrid_fwd_kernel
// (built by make_tilegrid_compositor, reached from render/tiled.py
// composite_pallas).
//
// What it computes: for each tile, its depth-sorted pairs in 128-pair
// chunks; alpha = min(op * exp(min(power, 0)), 0.99), zeroed below 1/255;
// transmittance carried in linear space; img = sum w*col + T_final*bg,
// alpha = sum w, depth = sum w*z. Once every pixel of the tile has
// T < 1e-7 the remaining chunks are skipped (the TPU kernel's rule).
//
// What bounds it on the card: the per-pixel, per-pair arithmetic (one expf
// and ~20 FMAs per pair and pixel); pair data is ~64 bytes per pair and is
// read once per tile, so device-memory traffic is small next to it.
//
// Design: one block of 256 threads per tile. Each thread owns ts*ts/256
// pixels (1 at ts=16, 4 at ts=32) and keeps their transmittance and sums
// in registers. The block stages each chunk in shared memory with one
// cooperative, 16-byte-per-thread load; every thread then walks the chunk
// in order with T *= (1 - alpha), reading pair fields as shared-memory
// broadcasts. The saturation test is tile-wide (__syncthreads_or) before
// each chunk, never per pixel, so outputs equal the TPU kernel's. The
// TPU kernel's mxu_accum flag routed the per-chunk accumulation through a
// matmul; here both settings accumulate with float32 FMAs, because tensor
// cores in TF32 would break the error bounds.
#include "tilegrid_common.cuh"

namespace egogs {

template <int D, int TS>
__global__ void __launch_bounds__(kThreads)
    tilegrid_fwd_kernel(const int* __restrict__ meta,
                        const float* __restrict__ vals,
                        const float* __restrict__ bg, float* __restrict__ img,
                        float* __restrict__ alpha_out,
                        float* __restrict__ depth_out, int n_tiles, int n_tx) {
  constexpr int P = TS * TS;
  static_assert(P % kThreads == 0, "tile pixels must split evenly");
  constexpr int PPT = P / kThreads;
  constexpr int CH = ch16_of(D);
  __shared__ __align__(16) float blk[CH * kChunk];

  const int t = blockIdx.x;
  const int start = meta[t];
  const int cnt = meta[n_tiles + t];
  const int n_chunks = (cnt + kChunk - 1) / kChunk;
  const int tx = t % n_tx;
  const int ty = t / n_tx;

  float px[PPT], py[PPT], T[PPT], acc[PPT][D], acc_a[PPT], acc_z[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * kThreads;
    px[k] = static_cast<float>(tx * TS + pix % TS) + 0.5f;
    py[k] = static_cast<float>(ty * TS + pix / TS) + 0.5f;
    T[k] = 1.0f;
    acc_a[k] = 0.0f;
    acc_z[k] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[k][d] = 0.0f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    // tile-wide saturation test; also the barrier that keeps the previous
    // chunk's readers ahead of this chunk's load
    bool live = false;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= T[k] >= kSatSkipEps;
    if (!__syncthreads_or(live)) break;
    load_chunk(blk, vals + static_cast<size_t>(start + c) * CH * kChunk, CH * kChunk);
    __syncthreads();

    const int n_valid = min(kChunk, cnt - c * kChunk);
    for (int j = 0; j < n_valid; ++j) {
      const float mx = blk[0 * kChunk + j];
      const float my = blk[1 * kChunk + j];
      const float a = blk[2 * kChunk + j];
      const float b = blk[3 * kChunk + j];
      const float cc = blk[4 * kChunk + j];
      const float op = blk[5 * kChunk + j];
      float col[D];
#pragma unroll
      for (int d = 0; d < D; ++d) col[d] = blk[(6 + d) * kChunk + j];
      const float z = blk[(6 + D) * kChunk + j];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const PairAlpha r = pair_alpha(px[k], py[k], mx, my, a, b, cc, op);
        const float w = r.alpha * T[k];
#pragma unroll
        for (int d = 0; d < D; ++d) acc[k][d] += w * col[d];
        acc_a[k] += w;
        acc_z[k] += w * z;
        T[k] *= 1.0f - r.alpha;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const size_t idx = static_cast<size_t>(t) * P + threadIdx.x + k * kThreads;
#pragma unroll
    for (int d = 0; d < D; ++d) img[idx * D + d] = acc[k][d] + T[k] * bg[d];
    alpha_out[idx] = acc_a[k];
    depth_out[idx] = acc_z[k];
  }
}

template <int D, int TS>
int launch_fwd(const int* meta, const float* vals, const float* bg, float* img,
               float* alpha, float* depth, int n_tiles, int n_tx,
               cudaStream_t stream) {
  tilegrid_fwd_kernel<D, TS><<<n_tiles, kThreads, 0, stream>>>(
      meta, vals, bg, img, alpha, depth, n_tiles, n_tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for.
extern "C" int egogs_tilegrid_fwd(const int* meta, const float* vals,
                                  const float* bg, float* img, float* alpha,
                                  float* depth, int n_tiles, int n_tx, int ts,
                                  int d, void* stream) {
  using namespace egogs;
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 3 && ts == 16) return launch_fwd<3, 16>(meta, vals, bg, img, alpha, depth, n_tiles, n_tx, s);
  if (d == 3 && ts == 32) return launch_fwd<3, 32>(meta, vals, bg, img, alpha, depth, n_tiles, n_tx, s);
  if (d == 1 && ts == 16) return launch_fwd<1, 16>(meta, vals, bg, img, alpha, depth, n_tiles, n_tx, s);
  if (d == 1 && ts == 32) return launch_fwd<1, 32>(meta, vals, bg, img, alpha, depth, n_tiles, n_tx, s);
  return -1;
}
