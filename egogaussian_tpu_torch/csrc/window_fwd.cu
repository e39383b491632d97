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
// thread sums it sequentially over the rows it sees.
//
// Interface (the TPU kernel's): mu [T, M, 2], con [T, M, 3], op [T, M, 1],
// col [T, M, D], z [T, M, 1], bg [1, D] -> img [T, P, D], alpha, depth
// [T, P, 1]. M is any size.
//
// What bounds it on the card: per covered pair and pixel (gated alpha > 0)
// one expf for alpha, one log1pf, one expf for the weight and ~20 other
// instructions; each needed window row (40 bytes at D = 3) is read once
// per CTA, and the op column of every row once. The first version (one
// 256-thread block per tile, four pixels per thread spread over the tile,
// every row but the masked ones evaluated at every pixel, each chunk
// gathered by scalar loads between two barriers over the whole 2,048-row
// window) took 0.50 ms on the 640x480 timing frame, 1.5% of its bound.
//
// Design: the Hopper layout of the other compositors
// (tilegrid_cluster.cuh): a 16x16 quadrant per 256-thread CTA, one pixel
// per thread (ts 32: a plain grid of four CTAs per tile, ts 16: one), an
// 8x4 patch per warp; each CTA first scans its tile's op column for live
// chunks (window_split.cuh) and walks only those, each staged by bulk
// copies into a two-stage ring (plain loads when M % 4 != 0); per chunk,
// 128 threads repack the rows row-major and compute each row's
// conservative reach box (empty for op below 1/255, so masked rows cost
// no evaluation), and each warp walks only the rows whose box meets its
// patch. A row culled there has alpha == 0 at every pixel of the patch,
// so CULL = true equals the CULL = false check instance bit for bit.
#include "window_split.cuh"

namespace egogs {

namespace {

constexpr int kFwdHead = 256 + kChunk * 16;  // barriers | live mask | reach boxes

template <int D>
constexpr int fwd_smem_bytes() {
  // head | packed rows | two chunk stages
  return kFwdHead + kChunk * ws::row_width<D>() * 4 + 2 * kChunk * (7 + D) * 4;
}

}  // namespace

template <int D, int TS, bool CULL>
__global__ void __launch_bounds__(kThreads, 4)
    window_fwd_kernel(const ws::Split<D, const float> win, const float* __restrict__ bg,
                      float* __restrict__ img, float* __restrict__ alpha_out,
                      float* __restrict__ depth_out, int n_tx) {
  constexpr int NCTA = tg::ctas_per_tile<TS>();
  constexpr int P = TS * TS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned* mask = reinterpret_cast<unsigned*>(smem + 16);  // [kMaskWords]
  float4* box = reinterpret_cast<float4*>(smem + 256);      // [kChunk]
  float* rows = reinterpret_cast<float*>(smem + kFwdHead);  // [kChunk][row_width]
  float* stage0 = rows + kChunk * ws::row_width<D>();       // [kChunk * (7 + D)] each
  static_assert(16 + 4 * ws::kMaskWords <= 256, "shared-memory head");

  const int t = blockIdx.x / NCTA;
  const int rank = blockIdx.x % NCTA;
  const tg::Pixel pix = tg::pixel_of<TS>(t, n_tx, rank);
  const int n = win.n_chunks();

  tg::Ring ring;
  ring.init(stage0, stage0 + kChunk * (7 + D), bar, 0);
  win.scan_live(t, mask);  // its barriers also publish the ring's barriers

  float logT = 0.0f, acc_a = 0.0f, acc_z = 0.0f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;

  int c = ws::next_live(mask, -1, n);
  if (c < n) win.issue(ring, t, c);
  for (int L = 0; c < n; ++L) {
    // the readers of the stage the next chunk lands in, of the packed rows
    // and of the boxes are done
    __syncthreads();
    const int next = ws::next_live(mask, c, n);
    if (next < n) win.issue(ring, t, next);
    const int n_valid = win.rows(c);
    ws::pack_chunk<D, CULL>(win.ready(ring, L, t, c), n_valid, rows, box);
    __syncthreads();
    unsigned mk[tg::kWords];
    tg::patch_pairs<CULL>(box, n_valid, pix, mk);
    tg::walk_pairs(
        mk,
        [&](int j) {
          ws::Row<D> r;
          r.head(rows, j);
          const PairAlpha a =
              pair_alpha(pix.px, pix.py, r.v[0], r.v[1], r.v[2], r.v[3], r.v[4], r.v[5]);
          // alpha == 0: log1m == 0 and w == 0, nothing moves
          if (a.alpha == 0.0f) return false;
          r.tail(rows, j);
          const float log1m = log1pf(-a.alpha);
          logT += log1m;
          const float w = a.alpha * expf(logT - log1m);
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] += w * r.v[6 + d];
          acc_a += w;
          acc_z += w * r.v[6 + D];
          return false;
        },
        [](int, unsigned) {});
    c = next;
  }

  const size_t idx = static_cast<size_t>(t) * P + pix.local;
  const float t_final = expf(logT);
#pragma unroll
  for (int d = 0; d < D; ++d) img[idx * D + d] = acc[d] + t_final * bg[d];
  alpha_out[idx] = acc_a;
  depth_out[idx] = acc_z;
}

template <bool CULL>
int dispatch_window_fwd(const float* mu, const float* con, const float* op, const float* col,
                        const float* z, const float* bg, float* img, float* alpha,
                        float* depth, int n_tiles, int m, int n_tx, int ts, int d,
                        void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[ws::kFields] = {mu, con, op, col, z};
  bool bulk = m % 4 == 0;
  for (const float* p : f) bulk = bulk && reinterpret_cast<uintptr_t>(p) % 16 == 0;
#define EGOGS_WFWD(D_, TS_)                                                               \
  if (d == D_ && ts == TS_)                                                               \
    return static_cast<int>(tg::launch_tiles<1>(                                          \
        window_fwd_kernel<D_, TS_, CULL>, n_tiles * tg::ctas_per_tile<TS_>(),             \
        fwd_smem_bytes<D_>(), s, ws::Split<D_, const float>{{mu, con, op, col, z}, m, bulk}, \
        bg, img, alpha, depth, n_tx));
  EGOGS_WFWD(3, 16)
  EGOGS_WFWD(3, 32)
  EGOGS_WFWD(1, 16)
  EGOGS_WFWD(1, 32)
#undef EGOGS_WFWD
  return -1;
}

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes every tile.
extern "C" int egogs_window_fwd(const float* mu, const float* con, const float* op,
                                const float* col, const float* z, const float* bg,
                                float* img, float* alpha, float* depth, int n_tiles,
                                int m, int n_tx, int ts, int d, void* stream) {
  return egogs::dispatch_window_fwd<true>(mu, con, op, col, z, bg, img, alpha, depth,
                                          n_tiles, m, n_tx, ts, d, stream);
}

// The same kernel with the per-warp cull compiled out: a check instance,
// whose outputs must equal egogs_window_fwd's bit for bit.
extern "C" int egogs_window_fwd_nocull(const float* mu, const float* con, const float* op,
                                       const float* col, const float* z, const float* bg,
                                       float* img, float* alpha, float* depth, int n_tiles,
                                       int m, int n_tx, int ts, int d, void* stream) {
  return egogs::dispatch_window_fwd<false>(mu, con, op, col, z, bg, img, alpha, depth,
                                           n_tiles, m, n_tx, ts, d, stream);
}
