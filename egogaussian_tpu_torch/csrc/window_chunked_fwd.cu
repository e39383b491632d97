// Windowed compositor (chunked), forward.
//
// Replaces: egogaussian_tpu/render/pallas_raster.py, _fwd_kernel_chunked
// (built by make_tile_compositor_chunked); the Pallas form of the per-tile
// loop of render/tiled.py composite_tiled, reached in the port from
// render/tiled.py composite_tiled (backend "tiled", which evaluation runs).
//
// What it computes: per tile, over the first ceil(count/128) chunks of its
// gather window, with rows at or past the count masked (op = 0), the
// transmittance in LOG space: per chunk and pixel
//   log1m_i = log1p(-alpha_i),  incl_i = (prefix_i of log1m in the chunk)
//   + logT_carry,  w_i = alpha_i * exp(incl_i - log1m_i),
// img = sum w*col + exp(logT_final)*bg, alpha = sum w, depth = sum w*z, and
// the final logT per pixel ([T, 1, P]) that the backward starts from.
// alpha = min(op * exp(min(power, 0)), 0.99), zeroed below 1/255. There is
// no saturation skip (the TPU kernel has none). Every tile is written: a
// tile with count 0 comes out as bg with alpha and depth 0.
//
// Interface (the TPU kernel's): counts [T] int32 (clamped to [0, M] here),
// data [T, M, 7+D] row-major (mu_x, mu_y, a, b, c, op, col x D, z), M a
// multiple of 128; bg [1, D].
//
// What bounds it on the card: per pair and pixel one expf, one log1pf and
// ~20 FMAs; each needed window row (~40 bytes) is read once per tile, so
// device-memory traffic is small next to the arithmetic.
//
// Design: the TPU kernel's grid step per tile becomes one block per tile,
// 256 threads, ts*ts/256 pixels per thread, state in registers. Its
// fori_loop over chunks is a loop in the block; each 128-row chunk is
// staged in shared memory with one cooperative 16-byte load and read as
// broadcasts. The log-space prefix is kept per chunk and added to the
// carry, as the TPU kernel does (prefix matmul + carry).
#include "tilegrid_common.cuh"

namespace egogs {

template <int D, int TS>
__global__ void __launch_bounds__(kThreads)
    window_chunked_fwd_kernel(const int* __restrict__ counts,
                              const float* __restrict__ data,
                              const float* __restrict__ bg,
                              float* __restrict__ img,
                              float* __restrict__ alpha_out,
                              float* __restrict__ depth_out,
                              float* __restrict__ logt_out, int m, int n_tx) {
  constexpr int P = TS * TS;
  static_assert(P % kThreads == 0, "tile pixels must split evenly");
  constexpr int PPT = P / kThreads;
  constexpr int CH = 7 + D;
  __shared__ __align__(16) float blk[kChunk * CH];

  const int t = blockIdx.x;
  const int cnt = min(max(counts[t], 0), m);
  const float* window = data + static_cast<size_t>(t) * m * CH;
  const int tx = t % n_tx;
  const int ty = t / n_tx;

  float px[PPT], py[PPT], logT[PPT], acc[PPT][D], acc_a[PPT], acc_z[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * kThreads;
    px[k] = static_cast<float>(tx * TS + pix % TS) + 0.5f;
    py[k] = static_cast<float>(ty * TS + pix / TS) + 0.5f;
    logT[k] = 0.0f;
    acc_a[k] = 0.0f;
    acc_z[k] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[k][d] = 0.0f;
  }

  for (int off = 0; off < cnt; off += kChunk) {
    __syncthreads();  // the previous chunk's readers are done with blk
    load_chunk(blk, window + static_cast<size_t>(off) * CH, kChunk * CH);
    __syncthreads();

    float prefix[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) prefix[k] = 0.0f;
    const int n_valid = min(kChunk, cnt - off);  // rows past the count: op = 0
    for (int j = 0; j < n_valid; ++j) {
      const float* pr = blk + j * CH;
      const float mx = pr[0], my = pr[1], a = pr[2], b = pr[3], cc = pr[4], op = pr[5];
      const float z = pr[6 + D];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const PairAlpha r = pair_alpha(px[k], py[k], mx, my, a, b, cc, op);
        // alpha == 0: log1m == 0 and w == 0, nothing moves
        if (r.alpha == 0.0f) continue;
        const float log1m = log1pf(-r.alpha);
        prefix[k] += log1m;
        const float incl = prefix[k] + logT[k];
        const float w = r.alpha * expf(incl - log1m);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[k][d] += w * pr[6 + d];
        acc_a[k] += w;
        acc_z[k] += w * z;
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) logT[k] = prefix[k] + logT[k];
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * kThreads;
    const size_t idx = static_cast<size_t>(t) * P + pix;
    const float t_final = expf(logT[k]);
#pragma unroll
    for (int d = 0; d < D; ++d) img[idx * D + d] = acc[k][d] + t_final * bg[d];
    alpha_out[idx] = acc_a[k];
    depth_out[idx] = acc_z[k];
    logt_out[idx] = logT[k];
  }
}

template <int D, int TS>
int launch_window_chunked_fwd(const int* counts, const float* data, const float* bg,
                              float* img, float* alpha, float* depth, float* logt,
                              int n_tiles, int m, int n_tx, cudaStream_t stream) {
  window_chunked_fwd_kernel<D, TS><<<n_tiles, kThreads, 0, stream>>>(
      counts, data, bg, img, alpha, depth, logt, m, n_tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes every tile.
extern "C" int egogs_window_chunked_fwd(const int* counts, const float* data,
                                        const float* bg, float* img, float* alpha,
                                        float* depth, float* logt, int n_tiles, int m,
                                        int n_tx, int ts, int d, void* stream) {
  using namespace egogs;
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EGOGS_WCFWD(D_, TS_)                                                   \
  if (d == D_ && ts == TS_)                                                    \
    return launch_window_chunked_fwd<D_, TS_>(counts, data, bg, img, alpha,    \
                                              depth, logt, n_tiles, m, n_tx, s);
  EGOGS_WCFWD(3, 16)
  EGOGS_WCFWD(3, 32)
  EGOGS_WCFWD(1, 16)
  EGOGS_WCFWD(1, 32)
#undef EGOGS_WCFWD
  return -1;
}
