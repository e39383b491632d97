// Windowed compositor (chunked), backward.
//
// Replaces: egogaussian_tpu/render/pallas_raster.py, _bwd_kernel_chunked
// (the VJP of make_tile_compositor_chunked), reached in the port from
// render/tiled.py composite_tiled (backend "tiled").
//
// What it computes: one REVERSE sweep over the first ceil(count/128)
// chunks of each tile's window, last to first, from the forward's saved
// final log-transmittance logT_total [T, 1, P]. Per row and pixel, with U
// the inclusive suffix of log(1 - alpha) plus the carry of the later
// chunks:
//   T_excl_i = exp(logT_total - U_i),  w_i = alpha_i * T_excl_i,
//   dL/dw_i  = z_i*gdepth + galpha + col_i . gimg,  wd_i = w_i * dL/dw_i,
//   S_i      = (inclusive suffix of wd - wd_i) + suffix carry + base_S,
//   base_S   = exp(logT_total) * (gimg . bg),
//   dalpha_i = T_excl_i dL/dw_i - S_i / max(1 - alpha_i, 1e-6),
//              gated to eps <= raw < 0.99,
// and emits per row the 7 + D values (dmu_x, dmu_y, da, db, dc, dop,
// dcol x D, dz) summed over the tile's pixels. No clamp mask on power (the
// TPU kernel has none). Every row of ddata is written: rows at or past the
// tile's count (masked, op = 0: all their terms are 0) and rows past the
// tile's last chunk are zeros, as the TPU kernel's zeroed block.
//
// Interface (the TPU kernel's): counts [T] int32 (clamped to [0, M]), data
// [T, M, 7+D] row-major, M a multiple of 128; bg [S, D] (T = S x tps
// tiles, scene-major, as in the forward); logt [T, 1, P];
// gimg [T, P, D], galpha, gdepth [T, P, 1] -> ddata [T, M, 7+D].
//
// What bounds it on the card: per covered pair and pixel two expf, one
// log1pf, ~50 other instructions and a division, plus the per-row
// reduction of 7 + D values over the tile's pixels, which costs more than
// the arithmetic where few pixels of a warp are covered. Device-memory
// traffic (the window read once per CTA, the gradient window written
// once) is small next to both. The first version evaluated every row at
// every pixel (58.0M evaluations, 9.7M covered on the 640x480 timing
// frame), reduced every row with one 5-shuffle tree per field in every
// warp whose strip it touched, and ran the deepest tile on one SM.
//
// Design: the shared log-space chunked pair (chunked_pair.cuh, the body
// the stream kernels run too) with the WindowRows source. One cluster per
// tile (ts 32: four CTAs of 256 threads, a 16x16 quadrant each, one pixel
// per thread; ts 16: one CTA); the per-warp reach-box cull, rows walked
// last to first; each row's gradient reduced in a fixed order (warp
// exchange, warps in order, CTAs in rank order over distributed shared
// memory), no float atomics; chunks last to first by bulk copy into a
// two-stage ring.
#include "chunked_pair.cuh"

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes every row of ddata. data
// must be 16-byte aligned.
extern "C" int egogs_window_chunked_bwd(const int* counts, const float* data,
                                        const float* bg, const float* logt,
                                        const float* gimg, const float* galpha,
                                        const float* gdepth, float* ddata, int n_tiles,
                                        int m, int n_tx, int tps, int ts, int d, void* stream) {
  using namespace egogs::cp;
  return launch_bwd<true>(WindowRows{counts, m}, data, bg, logt, gimg, galpha, gdepth, ddata,
                          n_tiles, n_tx, tps, ts, d, stream);
}

// The same kernel with the per-warp cull compiled out: a check instance,
// whose gradients must equal egogs_window_chunked_bwd's bit for bit.
extern "C" int egogs_window_chunked_bwd_nocull(const int* counts, const float* data,
                                               const float* bg, const float* logt,
                                               const float* gimg, const float* galpha,
                                               const float* gdepth, float* ddata,
                                               int n_tiles, int m, int n_tx, int tps, int ts, int d,
                                               void* stream) {
  using namespace egogs::cp;
  return launch_bwd<false>(WindowRows{counts, m}, data, bg, logt, gimg, galpha, gdepth, ddata,
                           n_tiles, n_tx, tps, ts, d, stream);
}
