// Windowed compositor (simple), forward.
//
// Replaces: egogaussian_tpu/render/pallas_raster.py, _fwd_kernel (built by
// make_tile_compositor), reached in the port through
// render/window_raster.py make_tile_compositor.
//
// What it computes: per tile, over ALL M rows of its window (the caller
// gives masked rows op = 0), the transmittance in LOG space:
//   log1m_i = log1p(-alpha_i),  incl_i = sum_{j<=i} log1m_j,
//   w_i = alpha_i * exp(incl_i - log1m_i),
// img = sum w*col + exp(incl_last)*bg, alpha = sum w, depth = sum w*z.
// alpha = min(op * exp(min(power, 0)), 0.99), zeroed below 1/255. There is
// no saturation skip (the TPU kernel has none). The TPU kernel takes the
// row prefix as lower-triangular matmuls (_cumsum_rows); here each pixel's
// thread sums sequentially, which needs no matrix.
//
// Interface (the TPU kernel's): mu [T, M, 2], con [T, M, 3], op [T, M, 1],
// col [T, M, D], z [T, M, 1], bg [1, D] -> img [T, P, D], alpha, depth
// [T, P, 1]. M is any size.
//
// What bounds it on the card: per pair and pixel one expf, one log1pf and
// ~20 FMAs; the window (~40 bytes a row) is read once per tile. Rows with
// op == 0 (the masked ones) are skipped whole: every term of such a row is
// exactly 0.
//
// Design: one block per tile (the TPU kernel's grid step), 256 threads,
// ts*ts/256 pixels per thread, state in registers; 128-row chunks of the
// five inputs are staged in shared memory as packed rows and read as
// broadcasts.
#include "tilegrid_common.cuh"

namespace egogs {

template <int D, int TS>
__global__ void __launch_bounds__(kThreads)
    window_fwd_kernel(const float* __restrict__ mu, const float* __restrict__ con,
                      const float* __restrict__ op_in, const float* __restrict__ col,
                      const float* __restrict__ z_in, const float* __restrict__ bg,
                      float* __restrict__ img, float* __restrict__ alpha_out,
                      float* __restrict__ depth_out, int m, int n_tx) {
  constexpr int P = TS * TS;
  static_assert(P % kThreads == 0, "tile pixels must split evenly");
  constexpr int PPT = P / kThreads;
  constexpr int CH = 7 + D;
  __shared__ float blk[kChunk * CH];

  const int t = blockIdx.x;
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

  for (int off = 0; off < m; off += kChunk) {
    const int n_rows = min(kChunk, m - off);
    __syncthreads();  // the previous chunk's readers are done with blk
    load_split_rows<D>(blk, mu, con, op_in, col, z_in, static_cast<size_t>(t) * m + off,
                       n_rows);
    __syncthreads();
    for (int j = 0; j < n_rows; ++j) {
      const float* pr = blk + j * CH;
      const float mx = pr[0], my = pr[1], a = pr[2], b = pr[3], cc = pr[4], op = pr[5];
      if (op == 0.0f) continue;  // masked row: alpha 0 at every pixel
      const float z = pr[6 + D];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const PairAlpha r = pair_alpha(px[k], py[k], mx, my, a, b, cc, op);
        // alpha == 0: log1m == 0 and w == 0, nothing moves
        if (r.alpha == 0.0f) continue;
        const float log1m = log1pf(-r.alpha);
        logT[k] += log1m;
        const float w = r.alpha * expf(logT[k] - log1m);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[k][d] += w * pr[6 + d];
        acc_a[k] += w;
        acc_z[k] += w * z;
      }
    }
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
  }
}

template <int D, int TS>
int launch_window_fwd(const float* mu, const float* con, const float* op, const float* col,
                      const float* z, const float* bg, float* img, float* alpha,
                      float* depth, int n_tiles, int m, int n_tx, cudaStream_t stream) {
  window_fwd_kernel<D, TS><<<n_tiles, kThreads, 0, stream>>>(
      mu, con, op, col, z, bg, img, alpha, depth, m, n_tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes every tile.
extern "C" int egogs_window_fwd(const float* mu, const float* con, const float* op,
                                const float* col, const float* z, const float* bg,
                                float* img, float* alpha, float* depth, int n_tiles,
                                int m, int n_tx, int ts, int d, void* stream) {
  using namespace egogs;
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EGOGS_WFWD(D_, TS_)                                                   \
  if (d == D_ && ts == TS_)                                                   \
    return launch_window_fwd<D_, TS_>(mu, con, op, col, z, bg, img, alpha,    \
                                      depth, n_tiles, m, n_tx, s);
  EGOGS_WFWD(3, 16)
  EGOGS_WFWD(3, 32)
  EGOGS_WFWD(1, 16)
  EGOGS_WFWD(1, 32)
#undef EGOGS_WFWD
  return -1;
}
