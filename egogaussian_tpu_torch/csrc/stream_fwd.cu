// Stream compositor, forward.
//
// Replaces: egogaussian_tpu/render/pallas_raster.py, _stream_fwd_kernel
// (built by make_stream_compositor, reached from render/tiled.py
// composite_pallas with TileConfig.compositor="stream").
//
// What it computes: each tile's depth-sorted pairs, chunk by chunk, with
// the transmittance carried in LOG space: per chunk and pixel
//   log1m_i = log1p(-alpha_i),  incl_i = (prefix_i of log1m in the chunk)
//   + logT_carry,  w_i = alpha_i * exp(incl_i - log1m_i),
// img = sum w*col + exp(logT_final)*bg, alpha = sum w, depth = sum w*z, and
// the final logT per pixel ([T, 1, P]) that the backward starts from.
// alpha = min(op * exp(min(power, 0)), 0.99), zeroed below 1/255. There is
// no saturation skip (the TPU stream kernel has none).
//
// Interface (the TPU kernel's): meta [4, n_slots] int32 per chunk slot:
// owning tile, rank of the chunk's first pair within the tile, the tile's
// pair count, last occupied slot (unused here); vals [n_slots*128, 7+D]
// row-major (mu_x, mu_y, a, b, c, op, col x D, z).
//
// The TPU kernel runs one grid step per chunk slot IN ORDER and carries a
// tile's state between steps in scratch. A CUDA grid has no order, so
// here one block is launched per slot, every block but the one at its
// tile's first slot returns at once, and that block walks the tile's
// chunks forward in a loop, keeping the state in registers. Tiles that own
// no slot are not written (the caller masks them, as JAX does).
//
// What bounds it on the card: per pair and pixel one expf, one log1pf and
// ~20 FMAs; pair data (~40 bytes per pair) is read once per tile, so
// device-memory traffic is small next to the arithmetic.
//
// Design: 256 threads per block, ts*ts/256 pixels per thread; each chunk
// is staged in shared memory with one cooperative 16-byte load and read
// as broadcasts. The log-space prefix is kept per chunk and added to the
// carry, as the TPU kernel does (prefix scan + carry).
#include "tilegrid_common.cuh"

namespace egogs {

template <int D, int TS>
__global__ void __launch_bounds__(kThreads)
    stream_fwd_kernel(const int* __restrict__ meta,
                      const float* __restrict__ vals,
                      const float* __restrict__ bg, float* __restrict__ img,
                      float* __restrict__ alpha_out,
                      float* __restrict__ depth_out,
                      float* __restrict__ logt_out, int n_slots, int n_tx) {
  constexpr int P = TS * TS;
  static_assert(P % kThreads == 0, "tile pixels must split evenly");
  constexpr int PPT = P / kThreads;
  constexpr int CH = 7 + D;
  __shared__ __align__(16) float blk[kChunk * CH];

  const int c0 = blockIdx.x;
  const int t = meta[c0];
  // only the tile's first slot works; it walks the tile's whole run
  if (c0 > 0 && meta[c0 - 1] == t) return;
  const int* rank = meta + n_slots;
  const int* count = meta + 2 * n_slots;
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

  for (int c = c0; c < n_slots && meta[c] == t; ++c) {
    const int rank_off = rank[c];
    const int cnt = count[c];
    if (rank_off >= cnt) break;  // pure padding from here on
    __syncthreads();  // the previous chunk's readers are done with blk
    load_chunk(blk, vals + static_cast<size_t>(c) * kChunk * CH, kChunk * CH);
    __syncthreads();

    float prefix[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) prefix[k] = 0.0f;
    const int n_valid = min(kChunk, cnt - rank_off);
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
int launch_stream_fwd(const int* meta, const float* vals, const float* bg,
                      float* img, float* alpha, float* depth, float* logt,
                      int n_slots, int n_tx, cudaStream_t stream) {
  stream_fwd_kernel<D, TS><<<n_slots, kThreads, 0, stream>>>(
      meta, vals, bg, img, alpha, depth, logt, n_slots, n_tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes only the tiles that own a
// chunk slot.
extern "C" int egogs_stream_fwd(const int* meta, const float* vals,
                                const float* bg, float* img, float* alpha,
                                float* depth, float* logt, int n_slots,
                                int n_tx, int ts, int d, void* stream) {
  using namespace egogs;
  if (n_slots == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EGOGS_SFWD(D_, TS_)                                                   \
  if (d == D_ && ts == TS_)                                                   \
    return launch_stream_fwd<D_, TS_>(meta, vals, bg, img, alpha, depth, logt, \
                                      n_slots, n_tx, s);
  EGOGS_SFWD(3, 16)
  EGOGS_SFWD(3, 32)
  EGOGS_SFWD(1, 16)
  EGOGS_SFWD(1, 32)
#undef EGOGS_SFWD
  return -1;
}
