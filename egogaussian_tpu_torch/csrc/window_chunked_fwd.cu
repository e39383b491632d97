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
// What bounds it on the card: per covered pair and pixel (gated alpha > 0)
// one expf for alpha, one log1pf, one expf for the weight and ~20 other
// instructions; each needed window row (40 bytes at D = 3) is read once
// per CTA, so device-memory traffic is small next to the arithmetic. The
// first version (one 256-thread block per tile, four pixels per thread in
// 32x1 row strips) evaluated every row at every pixel: 58.0M evaluations
// on the 640x480 timing frame, of which 9.7M are covered, and the deepest
// tile (711 rows x 1,024 pixels) held one SM for the whole launch.
//
// Design (tilegrid_cluster.cuh, the tile-grid pair's layout):
//   * A tile is split into 16x16 quadrants, one CTA of 256 threads each
//     (ts 32: four CTAs of a plain grid, ts 16: one), one pixel per thread.
//     Pixels are independent in the forward, so the CTAs share nothing.
//   * Warp w owns an 8x4 patch. Per chunk, 128 threads compute each row's
//     conservative reach box; each warp ballots the rows whose box meets
//     its patch and walks only those, in order. A skipped row has
//     alpha == 0 at every pixel of the patch, where it moves nothing, so
//     the result equals the CULL = false instantiation bit for bit.
//   * Each 128-row chunk (contiguous, 128 * (7+D) floats) arrives by a bulk
//     copy into a two-stage ring (tg::Ring); chunk c + 1 is in flight while
//     chunk c is composited.
//   * The log-space prefix is kept per chunk and added to the carry, as
//     the TPU kernel does (prefix matmul + carry).
#include "tilegrid_cluster.cuh"

namespace egogs {

namespace {

constexpr int kFwdHead = 64 + kChunk * 16;  // barriers | reach boxes

template <int D>
constexpr int wc_fwd_smem_bytes() {
  // head | two chunk stages
  return kFwdHead + 2 * kChunk * (7 + D) * 4;
}

}  // namespace

template <int D, int TS, bool CULL>
__global__ void __launch_bounds__(kThreads, 4)
    window_chunked_fwd_kernel(const int* __restrict__ counts,
                              const float* __restrict__ data,
                              const float* __restrict__ bg,
                              float* __restrict__ img,
                              float* __restrict__ alpha_out,
                              float* __restrict__ depth_out,
                              float* __restrict__ logt_out, int m, int n_tx) {
  constexpr int NCTA = tg::ctas_per_tile<TS>();
  constexpr int P = TS * TS;
  constexpr int CH = 7 + D;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float4* box = reinterpret_cast<float4*>(smem + 64);
  float* stage0 = reinterpret_cast<float*>(smem + kFwdHead);
  float* stage1 = stage0 + kChunk * CH;

  const int t = blockIdx.x / NCTA;
  const int rank = blockIdx.x % NCTA;
  const int cnt = min(max(counts[t], 0), m);
  const int n_chunks = (cnt + kChunk - 1) / kChunk;
  const float* window = data + static_cast<size_t>(t) * m * CH;
  const tg::Pixel pix = tg::pixel_of<TS>(t, n_tx, rank);

  tg::Ring ring;
  ring.init(stage0, stage1, bar, kChunk * CH * 4);
  __syncthreads();

  float logT = 0.0f, acc_a = 0.0f, acc_z = 0.0f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;

  if (n_chunks > 0) ring.issue(window);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the readers of the stage chunk c + 1 lands in, and of the boxes, are done
    if (c + 1 < n_chunks) ring.issue(window + static_cast<size_t>(c + 1) * kChunk * CH);
    ring.wait(c);
    const float* blk = (c & 1) ? stage1 : stage0;
    const int n_valid = min(kChunk, cnt - c * kChunk);  // rows past the count: op = 0
    if (CULL && static_cast<int>(threadIdx.x) < n_valid) {
      const float* pr = blk + threadIdx.x * CH;
      box[threadIdx.x] = tg::reach_box(pr[0], pr[1], pr[2], pr[3], pr[4], pr[5]);
    }
    __syncthreads();
    unsigned mk[tg::kWords];
    tg::patch_pairs<CULL>(box, n_valid, pix, mk);
    float prefix = 0.0f;
    tg::walk_pairs(
        mk,
        [&](int j) {
          const float* pr = blk + j * CH;
          const PairAlpha r = pair_alpha(pix.px, pix.py, pr[0], pr[1], pr[2], pr[3], pr[4], pr[5]);
          // alpha == 0: log1m == 0 and w == 0, nothing moves
          if (r.alpha == 0.0f) return false;
          const float log1m = log1pf(-r.alpha);
          prefix += log1m;
          const float incl = prefix + logT;
          const float w = r.alpha * expf(incl - log1m);
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] += w * pr[6 + d];
          acc_a += w;
          acc_z += w * pr[6 + D];
          return false;
        },
        [](int, unsigned) {});
    logT = prefix + logT;
  }

  const size_t idx = static_cast<size_t>(t) * P + pix.local;
  const float t_final = expf(logT);
#pragma unroll
  for (int d = 0; d < D; ++d) img[idx * D + d] = acc[d] + t_final * bg[d];
  alpha_out[idx] = acc_a;
  depth_out[idx] = acc_z;
  logt_out[idx] = logT;
}

namespace {

template <int D, int TS, bool CULL>
int wc_launch_fwd(const int* counts, const float* data, const float* bg, float* img,
                  float* alpha, float* depth, float* logt, int n_tiles, int m, int n_tx,
                  cudaStream_t stream) {
  // a plain grid of ctas_per_tile CTAs per tile: no cluster, the forward's
  // CTAs share nothing
  return static_cast<int>(tg::launch_tiles<1>(
      window_chunked_fwd_kernel<D, TS, CULL>, n_tiles * tg::ctas_per_tile<TS>(),
      wc_fwd_smem_bytes<D>(), stream, counts, data, bg, img, alpha, depth, logt, m, n_tx));
}

template <bool CULL>
int wc_dispatch_fwd(const int* counts, const float* data, const float* bg, float* img,
                    float* alpha, float* depth, float* logt, int n_tiles, int m, int n_tx,
                    int ts, int d, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EGOGS_WCFWD(D_, TS_)                                                          \
  if (d == D_ && ts == TS_)                                                           \
    return wc_launch_fwd<D_, TS_, CULL>(counts, data, bg, img, alpha, depth, logt,    \
                                        n_tiles, m, n_tx, s);
  EGOGS_WCFWD(3, 16)
  EGOGS_WCFWD(3, 32)
  EGOGS_WCFWD(1, 16)
  EGOGS_WCFWD(1, 32)
#undef EGOGS_WCFWD
  return -1;
}

}  // namespace

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes every tile. data must be
// 16-byte aligned.
extern "C" int egogs_window_chunked_fwd(const int* counts, const float* data,
                                        const float* bg, float* img, float* alpha,
                                        float* depth, float* logt, int n_tiles, int m,
                                        int n_tx, int ts, int d, void* stream) {
  return egogs::wc_dispatch_fwd<true>(counts, data, bg, img, alpha, depth, logt, n_tiles, m,
                                      n_tx, ts, d, stream);
}

// The same kernel with the per-warp cull compiled out: a check instance,
// whose outputs must equal egogs_window_chunked_fwd's bit for bit.
extern "C" int egogs_window_chunked_fwd_nocull(const int* counts, const float* data,
                                               const float* bg, float* img, float* alpha,
                                               float* depth, float* logt, int n_tiles, int m,
                                               int n_tx, int ts, int d, void* stream) {
  return egogs::wc_dispatch_fwd<false>(counts, data, bg, img, alpha, depth, logt, n_tiles, m,
                                       n_tx, ts, d, stream);
}
