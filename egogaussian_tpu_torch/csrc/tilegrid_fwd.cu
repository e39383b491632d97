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
// and ~20 other instructions per covered pair and pixel); pair data is
// ~64 bytes per pair, read once per CTA, so device-memory traffic is small
// next to it. With one block per tile the deepest tile alone (711 pairs x
// 1,024 pixels at the 640x480 timing frame) held one SM for longer than
// the whole card's bound.
//
// Design (tilegrid_cluster.cuh):
//   * One cluster per tile: at ts 32 four CTAs of 256 threads, a 16x16
//     quadrant each, one pixel per thread (ts 16: one CTA). A deep tile
//     spreads over four SMs and the grid has four times the CTAs.
//   * The tile-wide saturation vote before each chunk runs across the
//     cluster (flags in distributed shared memory, one cluster barrier),
//     so the skip rule stays the TPU kernel's.
//   * Each chunk (one contiguous ch16 x 128 float block) arrives by a
//     bulk copy into a two-stage ring; chunk c + 1 is in flight while
//     chunk c is composited.
//   * Per chunk, 128 threads compute each pair's conservative reach box;
//     each warp (an 8x4 pixel patch) ballots the pairs whose box meets its
//     patch and walks only those, in order. A skipped pair has alpha == 0
//     at every pixel of the patch, where it would change nothing, so the
//     result is bit-identical to the CULL = false instantiation.
// The TPU kernel's mxu_accum flag routed the per-chunk accumulation
// through a matmul; here both settings accumulate with float32 FMAs,
// because tensor cores in TF32 would break the error bounds.
#include "tilegrid_cluster.cuh"

namespace egogs {

namespace {

template <int D>
constexpr int fwd_smem_bytes() {
  // barriers | flags | reach boxes | two chunk stages
  return 64 + kChunk * 16 + 2 * ch16_of(D) * kChunk * 4;
}

}  // namespace

template <int D, int TS, bool CULL>
__global__ void __launch_bounds__(kThreads, 4)
    tilegrid_fwd_kernel(const int* __restrict__ meta,
                        const float* __restrict__ vals,
                        const float* __restrict__ bg, float* __restrict__ img,
                        float* __restrict__ alpha_out,
                        float* __restrict__ depth_out, int n_tiles, int n_tx) {
  constexpr int NCTA = tg::ctas_per_tile<TS>();
  constexpr int P = TS * TS;
  constexpr int CH = ch16_of(D);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned* flags = reinterpret_cast<unsigned*>(smem + 16);
  float4* box = reinterpret_cast<float4*>(smem + 64);
  float* stage0 = reinterpret_cast<float*>(smem + 64 + kChunk * 16);
  float* stage1 = stage0 + CH * kChunk;

  const int t = blockIdx.x / NCTA;
  const int rank = blockIdx.x % NCTA;
  const int start = meta[t];
  const int cnt = meta[n_tiles + t];
  const int n_chunks = (cnt + kChunk - 1) / kChunk;
  const tg::Pixel pix = tg::pixel_of<TS>(t, n_tx, rank);

  tg::Ring ring;
  ring.init(stage0, stage1, bar, CH * kChunk * 4);
  __syncthreads();
  tg::cluster_sync<NCTA>();  // the cluster's CTAs run before flags are written

  float T = 1.0f, acc_a = 0.0f, acc_z = 0.0f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;

  const float* chunk0 = vals + static_cast<size_t>(start) * CH * kChunk;
  if (n_chunks > 0) ring.issue(chunk0);
  int c = 0;
  for (; c < n_chunks; ++c) {
    if (!tg::tile_vote<NCTA>(T >= kSatSkipEps, flags, c)) break;
    if (c + 1 < n_chunks) ring.issue(chunk0 + static_cast<size_t>(c + 1) * CH * kChunk);
    ring.wait(c);
    const float* blk = (c & 1) ? stage1 : stage0;
    const int n_valid = min(kChunk, cnt - c * kChunk);
    if (CULL && static_cast<int>(threadIdx.x) < n_valid) {
      const int j = threadIdx.x;
      box[j] = tg::reach_box(blk[j], blk[kChunk + j], blk[2 * kChunk + j],
                             blk[3 * kChunk + j], blk[4 * kChunk + j], blk[5 * kChunk + j]);
    }
    __syncthreads();
    unsigned m[tg::kWords];
    tg::patch_pairs<CULL>(box, n_valid, pix, m);
    tg::walk_pairs(
        m,
        [&](int j) {
          const PairAlpha r =
              pair_alpha(pix.px, pix.py, blk[j], blk[kChunk + j], blk[2 * kChunk + j],
                         blk[3 * kChunk + j], blk[4 * kChunk + j], blk[5 * kChunk + j]);
          const float w = r.alpha * T;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] += w * blk[(6 + d) * kChunk + j];
          acc_a += w;
          acc_z += w * blk[(6 + D) * kChunk + j];
          T *= 1.0f - r.alpha;
          return false;
        },
        [](int, unsigned) {});
  }
  if (c < n_chunks) ring.wait(c);  // prefetched behind a saturated tile

  const size_t idx = static_cast<size_t>(t) * P + pix.local;
#pragma unroll
  for (int d = 0; d < D; ++d) img[idx * D + d] = acc[d] + T * bg[d];
  alpha_out[idx] = acc_a;
  depth_out[idx] = acc_z;
}

template <int D, int TS, bool CULL>
int launch_fwd(const int* meta, const float* vals, const float* bg, float* img,
               float* alpha, float* depth, int n_tiles, int n_tx,
               cudaStream_t stream) {
  return static_cast<int>(tg::launch_tiles<tg::ctas_per_tile<TS>()>(
      tilegrid_fwd_kernel<D, TS, CULL>, n_tiles, fwd_smem_bytes<D>(), stream, meta, vals,
      bg, img, alpha, depth, n_tiles, n_tx));
}

template <bool CULL>
int dispatch_fwd(const int* meta, const float* vals, const float* bg, float* img,
                 float* alpha, float* depth, int n_tiles, int n_tx, int ts, int d,
                 void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 3 && ts == 16) return launch_fwd<3, 16, CULL>(meta, vals, bg, img, alpha, depth, n_tiles, n_tx, s);
  if (d == 3 && ts == 32) return launch_fwd<3, 32, CULL>(meta, vals, bg, img, alpha, depth, n_tiles, n_tx, s);
  if (d == 1 && ts == 16) return launch_fwd<1, 16, CULL>(meta, vals, bg, img, alpha, depth, n_tiles, n_tx, s);
  if (d == 1 && ts == 32) return launch_fwd<1, 32, CULL>(meta, vals, bg, img, alpha, depth, n_tiles, n_tx, s);
  return -1;
}

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. vals must be 16-byte aligned.
extern "C" int egogs_tilegrid_fwd(const int* meta, const float* vals,
                                  const float* bg, float* img, float* alpha,
                                  float* depth, int n_tiles, int n_tx, int ts,
                                  int d, void* stream) {
  return egogs::dispatch_fwd<true>(meta, vals, bg, img, alpha, depth, n_tiles, n_tx, ts, d,
                                   stream);
}

// The same kernel with the per-warp cull compiled out: a check instance,
// whose outputs must equal egogs_tilegrid_fwd's bit for bit.
extern "C" int egogs_tilegrid_fwd_nocull(const int* meta, const float* vals,
                                         const float* bg, float* img, float* alpha,
                                         float* depth, int n_tiles, int n_tx, int ts,
                                         int d, void* stream) {
  return egogs::dispatch_fwd<false>(meta, vals, bg, img, alpha, depth, n_tiles, n_tx, ts, d,
                                    stream);
}
