// Stream compositor, backward.
//
// Replaces: egogaussian_tpu/render/pallas_raster.py, _stream_bwd_kernel
// (the VJP of make_stream_compositor).
//
// What it computes: one REVERSE sweep over each tile's chunks, starting
// from the forward's saved final log-transmittance logT_total [T, 1, P].
// Per chunk and pixel, with U the inclusive suffix of log(1 - alpha) plus
// the carry of the later chunks:
//   T_excl_i = exp(logT_total - U_i),  w_i = alpha_i * T_excl_i,
//   dL/dw_i  = z_i*gdepth + galpha + col_i . gimg,  wd_i = w_i * dL/dw_i,
//   S_i      = (inclusive suffix of wd - wd_i) + suffix carry + base_S,
//   base_S   = exp(logT_total) * (gimg . bg),
//   dalpha_i = T_excl_i dL/dw_i - S_i / max(1 - alpha_i, 1e-6),
//              gated to eps <= raw < 0.99,
// and emits per pair the 7 + D rows (dmu_x, dmu_y, da, db, dc, dop,
// dcol x D, dz) summed over the tile's pixels: the function of the chunked
// windowed backward (window_chunked_bwd.cu). Every slot of dvals is
// written: pure-padding chunks (rank >= count, the tail after the last run
// included) and rows past the count are zeros, as in the TPU kernel.
//
// What bounds it on the card: per covered pair and pixel two expf, one
// log1pf, ~50 other instructions and a division, plus the per-pair
// reduction of 7 + D values over the tile's pixels. Device-memory traffic
// is small next to both. The first version launched one block per slot;
// the block at a tile's first slot walked the tile's chunks alone at four
// pixels per thread with no cull, and reduced every pair with one shuffle
// tree per field in every warp.
//
// Design: the shared log-space chunked pair (chunked_pair.cuh, the body of
// the chunked windowed backward) with the StreamRows source: one cluster
// per tile (ts 32: four CTAs, a 16x16 quadrant each, one pixel per thread;
// ts 16: one CTA) that finds its run of slots by a warp search of meta
// row 0 and walks its real chunks last to first with the per-warp
// reach-box cull; each pair's gradient reduced in a fixed order (warp
// exchange, warps in order, CTAs in rank order over distributed shared
// memory), no float atomics, so repeats are bit for bit. The pure-padding
// slots (rank >= count) are zeroed by the whole grid, slot q by CTA
// q mod gridDim: the last tile owns the tail past the last run, 96% of the
// slots at the default capacity, which its own CTAs took 2.7 ms to zero.
#include "chunked_pair.cuh"

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes every slot of dvals. vals
// must be 16-byte aligned. The n_tiles tiles are scenes of tps tiles each,
// scene-major (bg [n_tiles / tps, d]), as in egogs_stream_fwd.
extern "C" int egogs_stream_bwd(const int* meta, const float* vals, const float* bg,
                                const float* logt, const float* gimg, const float* galpha,
                                const float* gdepth, float* dvals, int n_slots, int n_tiles,
                                int n_tx, int tps, int ts, int d, void* stream) {
  using namespace egogs::cp;
  if (n_slots == 0) return 0;
  return launch_bwd<true>(StreamRows{meta, n_slots}, vals, bg, logt, gimg, galpha, gdepth,
                          dvals, n_tiles, n_tx, tps, ts, d, stream);
}

// The same kernel with the per-warp cull compiled out: a check instance,
// whose gradients must equal egogs_stream_bwd's bit for bit.
extern "C" int egogs_stream_bwd_nocull(const int* meta, const float* vals, const float* bg,
                                       const float* logt, const float* gimg,
                                       const float* galpha, const float* gdepth,
                                       float* dvals, int n_slots, int n_tiles, int n_tx,
                                       int tps, int ts, int d, void* stream) {
  using namespace egogs::cp;
  if (n_slots == 0) return 0;
  return launch_bwd<false>(StreamRows{meta, n_slots}, vals, bg, logt, gimg, galpha, gdepth,
                           dvals, n_tiles, n_tx, tps, ts, d, stream);
}
