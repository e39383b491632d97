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
// multiple of 128; bg [S, D]. The scene axis (vmap over the pallas_call on
// the TPU): the T tiles are S scenes' tiles, scene-major, tps per scene;
// tile t draws its pixel origin from t % tps and its bg from row t / tps.
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
// Design: the shared log-space chunked pair (chunked_pair.cuh, the body
// the stream kernels run too) with the WindowRows source: tile t's rows
// are data[t], its count counts[t]. A 16x16 quadrant per 256-thread CTA
// (ts 32: a plain grid of four CTAs per tile, ts 16: one), one pixel per
// thread; the per-warp reach-box cull; each 128-row chunk by bulk copy
// into a two-stage ring; the log-space prefix kept per chunk and added to
// the carry, as the TPU kernel does (prefix matmul + carry).
#include "chunked_pair.cuh"

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes every tile. data must be
// 16-byte aligned.
extern "C" int egogs_window_chunked_fwd(const int* counts, const float* data,
                                        const float* bg, float* img, float* alpha,
                                        float* depth, float* logt, int n_tiles, int m,
                                        int n_tx, int tps, int ts, int d, void* stream) {
  using namespace egogs::cp;
  return launch_fwd<true>(WindowRows{counts, m}, data, bg, img, alpha, depth, logt, n_tiles,
                          n_tx, tps, ts, d, stream);
}

// The same kernel with the per-warp cull compiled out: a check instance,
// whose outputs must equal egogs_window_chunked_fwd's bit for bit.
extern "C" int egogs_window_chunked_fwd_nocull(const int* counts, const float* data,
                                               const float* bg, float* img, float* alpha,
                                               float* depth, float* logt, int n_tiles, int m,
                                               int n_tx, int tps, int ts, int d, void* stream) {
  using namespace egogs::cp;
  return launch_fwd<false>(WindowRows{counts, m}, data, bg, img, alpha, depth, logt, n_tiles,
                           n_tx, tps, ts, d, stream);
}
