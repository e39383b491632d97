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
// no saturation skip (the TPU stream kernel has none). This is the
// function of the chunked windowed forward (window_chunked_fwd.cu); only
// where a tile's chunks live differs.
//
// Interface (the TPU kernel's): meta [4, n_slots] int32 per chunk slot:
// owning tile (nondecreasing; slots past the last run carry the last tile
// id), rank of the chunk's first pair within the tile, the tile's pair
// count, last occupied slot (unused here); vals [n_slots*128, 7+D]
// row-major (mu_x, mu_y, a, b, c, op, col x D, z). A tile's real chunks are
// the prefix of its run with rank < count. Tiles that own no slot are not
// written (the caller masks them, as JAX does); a tile whose run holds no
// real chunk (the last tile over the pure-padding tail) comes out as bg.
//
// What bounds it on the card: per covered pair and pixel (gated alpha > 0)
// one expf for alpha, one log1pf, one expf for the weight and ~20 other
// instructions; each pair row (40 bytes at D = 3) is read once per CTA.
// The first version launched one block per chunk slot; every block but the
// one at its tile's first slot returned at once, and that block walked the
// tile's whole run alone at four pixels per thread with no cull: 58.0M
// evaluations on the 640x480 timing frame, of which 9.7M are covered, and
// the deepest tile (711 pairs) held one SM for the whole launch.
//
// Design: the shared log-space chunked pair (chunked_pair.cuh, the body of
// the chunked windowed forward) with the StreamRows source: a grid over
// tiles, not slots. Each CTA finds its tile's run of slots by a warp
// search of meta row 0 (both ends at once, a 16-ary search per half
// warp) and composites the run's real chunks. A 16x16
// quadrant per 256-thread CTA (ts 32: a plain grid of four CTAs per tile,
// ts 16: one), one pixel per thread; the per-warp reach-box cull; each
// chunk (128 * (7+D) floats at a 16-byte-aligned slot offset) by bulk copy
// into a two-stage ring.
#include "chunked_pair.cuh"

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes only the tiles that own a
// chunk slot. vals must be 16-byte aligned. The n_tiles tiles are scenes
// of tps tiles each, scene-major (bg [n_tiles / tps, d]); meta row 0 holds
// global tile ids, nondecreasing over the scenes' slots.
extern "C" int egogs_stream_fwd(const int* meta, const float* vals, const float* bg,
                                float* img, float* alpha, float* depth, float* logt,
                                int n_slots, int n_tiles, int n_tx, int tps, int ts, int d,
                                void* stream) {
  using namespace egogs::cp;
  if (n_slots == 0) return 0;
  return launch_fwd<true>(StreamRows{meta, n_slots}, vals, bg, img, alpha, depth, logt,
                          n_tiles, n_tx, tps, ts, d, stream);
}

// The same kernel with the per-warp cull compiled out: a check instance,
// whose outputs must equal egogs_stream_fwd's bit for bit.
extern "C" int egogs_stream_fwd_nocull(const int* meta, const float* vals, const float* bg,
                                       float* img, float* alpha, float* depth, float* logt,
                                       int n_slots, int n_tiles, int n_tx, int tps, int ts,
                                       int d, void* stream) {
  using namespace egogs::cp;
  if (n_slots == 0) return 0;
  return launch_fwd<false>(StreamRows{meta, n_slots}, vals, bg, img, alpha, depth, logt,
                           n_tiles, n_tx, tps, ts, d, stream);
}
