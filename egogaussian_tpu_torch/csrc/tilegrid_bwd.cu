// Tile-grid compositor, backward (forward-sweep form), in both flavors.
//
// Replaces: egogaussian_tpu/render/pallas_raster.py, _tilegrid_bwd_kernel
// (built by make_tilegrid_compositor; its VJP), with exact_total=False
// (EXACT = false) and exact_total=True (EXACT = true, :1073-1113).
//
// What it computes: one FORWARD sweep over each tile's chunks, replaying
// the forward's transmittance. The back-to-front weighted suffix
// S_i = sum_{j>i} w_j dL/dw_j is rewritten as total - inclusive prefix:
//   S_i      = (total - prefix_i) + base_S
//   dalpha_i = T_i dL/dw_i - S_i / (1 - alpha_i),  gated to eps <= raw < 0.99
// and emits, per pair, the 7 + D gradient rows (dmu_x, dmu_y, da, db, dc,
// dop, dcol x D, dz) reduced over the tile's pixels. Chunks skipped by the
// saturation rule write zeros, like the TPU kernel.
//   EXACT = false: total and base_S are rebuilt from the saved outputs,
//     T_total = 1 - alpha_out,
//     total   = sum_d (img_d - T_total*bg_d) gimg_d + depth*gdepth + alpha*galpha,
//     base_S  = T_total * (gimg . bg).
//   EXACT = true: a value-only pre-sweep runs the gradient sweep's own value
//     path (the same inline function, saturation votes included, so T and
//     the prefix follow the same trajectory bit for bit); total is its final
//     prefix and base_S = T_final * (gimg . bg). The suffix subtraction then
//     telescopes to exactly 0 at a tile's last pair. State is reset and the
//     gradient sweep runs. The pre-sweep costs one more pass over the chunks.
//
// What bounds it on the card: per covered pair and pixel ~50 instructions
// and one expf, plus the per-pair reduction of 7 + D values over the
// tile's pixels, which costs more than the arithmetic where few pixels of
// a warp are covered. Device-memory traffic (pair chunk in, gradient chunk
// out) is small next to both.
//
// Design: the forward's (tilegrid_fwd.cu): one cluster per tile, one pixel
// per thread, 8x4 warp patches, the cluster-wide vote, the bulk-copy
// ring, and the per-warp cull by reach box (bit-identical to CULL =
// false). Each pair's gradient rows are reduced in a FIXED order:
//   1. per warp, over its 32 pixels, by a halving exchange that leaves
//      lane f with field f (warp_sum_fields); a warp in which no pixel sees
//      the pair skips it and marks it absent;
//   2. per CTA, the present warps' partials in warp order, into a
//      double-buffered chunk partial [7 + D][128] in shared memory;
//   3. per cluster, the CTAs' partials in rank order, read from
//      distributed shared memory after the next vote's cluster barrier;
//      each CTA writes a quarter of the chunk's rows.
// No float atomics, so runs repeat bit for bit.
#include "tilegrid_cluster.cuh"

namespace egogs {

// The value path both sweeps share: dL/dw of a pair at one pixel, and the
// advance of that pixel's prefix and transmittance. Explicit fmaf calls
// pin the rounding, so the EXACT pre-sweep and the gradient sweep compute
// the same values operation for operation.
template <int D>
__device__ __forceinline__ float pair_dld(float z, const float* col, float gz,
                                          float ga, const float* gi) {
  float dld = __fmaf_rn(z, gz, ga);
#pragma unroll
  for (int d = 0; d < D; ++d) dld = __fmaf_rn(col[d], gi[d], dld);
  return dld;
}

__device__ __forceinline__ void advance(float alpha, float w, float dld,
                                        float& pre, float& T) {
  pre = __fmaf_rn(w, dld, pre);
  T = __fmul_rn(T, 1.0f - alpha);
}

namespace {

constexpr int kBwdHead = 2240;  // barriers | flags | warp masks | reach boxes

template <int D>
constexpr int bwd_smem_bytes() {
  // head | two chunk stages | warp partials | two CTA chunk partials
  return kBwdHead + 2 * ch16_of(D) * kChunk * 4 + kWarps * (7 + D) * kChunk * 4 +
         2 * (7 + D) * kChunk * 4;
}

}  // namespace

template <int D, int TS, bool EXACT, bool CULL>
__global__ void __launch_bounds__(kThreads, 2)
    tilegrid_bwd_kernel(const int* __restrict__ meta,
                        const float* __restrict__ vals,
                        const float* __restrict__ bg,
                        const float* __restrict__ img,
                        const float* __restrict__ alpha_out,
                        const float* __restrict__ depth_out,
                        const float* __restrict__ gimg,
                        const float* __restrict__ galpha,
                        const float* __restrict__ gdepth,
                        float* __restrict__ dvals, int n_tiles, int n_tx) {
  constexpr int NCTA = tg::ctas_per_tile<TS>();
  constexpr int P = TS * TS;
  constexpr int CH = ch16_of(D);
  constexpr int NV = 7 + D;  // gradient rows per pair
  constexpr int kShare = CH * kChunk / NCTA;  // output floats of a chunk per CTA
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned* flags = reinterpret_cast<unsigned*>(smem + 16);          // [2][NCTA]
  unsigned* present = reinterpret_cast<unsigned*>(smem + 48);        // [kWarps][kWords]
  float4* box = reinterpret_cast<float4*>(smem + 192);               // [kChunk]
  float* stage0 = reinterpret_cast<float*>(smem + kBwdHead);         // [CH][kChunk]
  float* stage1 = stage0 + CH * kChunk;
  float* part = stage1 + CH * kChunk;                                // [kWarps][NV][kChunk]
  float* cpart = part + kWarps * NV * kChunk;                        // [2][NV][kChunk]
  static_assert(192 + kChunk * 16 <= kBwdHead, "shared-memory head");

  const int t = blockIdx.x / NCTA;
  const int rank = blockIdx.x % NCTA;
  const int start = meta[t];
  const int cnt = meta[n_tiles + t];
  const int n_chunks = (cnt + kChunk - 1) / kChunk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const tg::Pixel pix = tg::pixel_of<TS>(t, n_tx, rank);
  const size_t idx = static_cast<size_t>(t) * P + pix.local;

  float bgv[D], gi[D];
  float g_dot_bg = 0.0f, total = 0.0f, base_s = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    bgv[d] = bg[d];
    gi[d] = gimg[idx * D + d];
    g_dot_bg += gi[d] * bgv[d];
  }
  const float ga = galpha[idx];
  const float gz = gdepth[idx];
  if (!EXACT) {
    const float a_out = alpha_out[idx];
    const float t_total = 1.0f - a_out;
    float tot = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) tot += (img[idx * D + d] - t_total * bgv[d]) * gi[d];
    total = tot + depth_out[idx] * gz + a_out * ga;
    base_s = t_total * g_dot_bg;
  }
  float T = 1.0f, pre = 0.0f;

  tg::Ring ring;
  ring.init(stage0, stage1, bar, CH * kChunk * 4);
  __syncthreads();
  tg::cluster_sync<NCTA>();  // the cluster's CTAs run before flags are written
  const float* src_part[NCTA];
  if constexpr (NCTA > 1) {
    tg::cg::cluster_group cl = tg::cg::this_cluster();
#pragma unroll
    for (int r = 0; r < NCTA; ++r) src_part[r] = cl.map_shared_rank(cpart, r);
  } else {
    src_part[0] = cpart;
  }

  const float* chunk0 = vals + static_cast<size_t>(start) * CH * kChunk;
  int votes = 0;
  // the staged chunk of load L, its reach boxes, and the warp's pair masks
  auto stage_chunk = [&](int L, int c, unsigned (&m)[tg::kWords]) -> const float* {
    ring.wait(L);
    const float* blk = (L & 1) ? stage1 : stage0;
    const int n_valid = min(kChunk, cnt - c * kChunk);
    if (CULL && static_cast<int>(threadIdx.x) < n_valid) {
      const int j = threadIdx.x;
      box[j] = tg::reach_box(blk[j], blk[kChunk + j], blk[2 * kChunk + j],
                             blk[3 * kChunk + j], blk[4 * kChunk + j], blk[5 * kChunk + j]);
    }
    __syncthreads();
    tg::patch_pairs<CULL>(box, n_valid, pix, m);
    return blk;
  };

  const float* blk = stage0;  // the staged chunk being walked
  auto alpha_of = [&](int j) {
    return pair_alpha(pix.px, pix.py, blk[j], blk[kChunk + j], blk[2 * kChunk + j],
                      blk[3 * kChunk + j], blk[4 * kChunk + j], blk[5 * kChunk + j]);
  };
  auto col_of = [&](int j, float (&col)[D]) {
#pragma unroll
    for (int d = 0; d < D; ++d) col[d] = blk[(6 + d) * kChunk + j];
  };

  if (EXACT) {
    // value-only pre-sweep: the gradient sweep's value path and votes
    const int base = ring.issued;
    if (n_chunks > 0) ring.issue(chunk0);
    int c = 0;
    for (; c < n_chunks; ++c) {
      if (!tg::tile_vote<NCTA>(T >= kSatSkipEps, flags, votes++)) break;
      if (c + 1 < n_chunks) ring.issue(chunk0 + static_cast<size_t>(c + 1) * CH * kChunk);
      unsigned m[tg::kWords];
      blk = stage_chunk(base + c, c, m);
      tg::walk_pairs(
          m,
          [&](int j) {
            const PairAlpha r = alpha_of(j);
            if (r.alpha == 0.0f) return false;
            float col[D];
            col_of(j, col);
            const float w = __fmul_rn(r.alpha, T);
            advance(r.alpha, w, pair_dld<D>(blk[(6 + D) * kChunk + j], col, gz, ga, gi), pre, T);
            return false;
          },
          [](int, unsigned) {});
    }
    if (c < n_chunks) ring.wait(base + c);  // prefetched behind a saturated tile
    total = pre;
    base_s = T * g_dot_bg;
    T = 1.0f;
    pre = 0.0f;
  }

  // chunk cc's rows of this CTA's share: the CTAs' partials summed in rank
  // order (zeros in the padding rows)
  auto write_chunk = [&](int cc) {
    float* out = dvals + static_cast<size_t>(start + cc) * CH * kChunk;
    const int off = (cc & 1) * NV * kChunk;
    for (int i = rank * kShare + threadIdx.x; i < (rank + 1) * kShare; i += kThreads) {
      float acc = 0.0f;
      if (i < NV * kChunk) {
#pragma unroll
        for (int r = 0; r < NCTA; ++r) acc += src_part[r][off + i];
      }
      out[i] = acc;
    }
  };

  const int base = ring.issued;
  if (n_chunks > 0) ring.issue(chunk0);
  int c = 0;
  for (;; ++c) {
    // the vote for chunk c; its barrier also orders every CTA's partial of
    // chunk c - 1 before the reads that sum it
    const bool go = tg::tile_vote<NCTA>(c < n_chunks && T >= kSatSkipEps, flags, votes++);
    if (c > 0) write_chunk(c - 1);
    if (!go) break;
    if (c + 1 < n_chunks) ring.issue(chunk0 + static_cast<size_t>(c + 1) * CH * kChunk);
    unsigned m[tg::kWords];
    blk = stage_chunk(base + c, c, m);
    tg::walk_pairs(
        m,
        [&](int j) {
          const PairAlpha r = alpha_of(j);
          float s[NV];
#pragma unroll
          for (int v = 0; v < NV; ++v) s[v] = 0.0f;
          // alpha == 0 leaves T and the prefix unchanged and every term zero
          const bool touched = r.alpha != 0.0f;
          if (touched) {
            const float a = blk[2 * kChunk + j];
            const float b = blk[3 * kChunk + j];
            const float cc = blk[4 * kChunk + j];
            float col[D];
            col_of(j, col);
            const float t_excl = T;
            const float w = __fmul_rn(r.alpha, t_excl);
            const float dld = pair_dld<D>(blk[(6 + D) * kChunk + j], col, gz, ga, gi);
            advance(r.alpha, w, dld, pre, T);
            const float S = (total - pre) + base_s;
            const float one_minus = 1.0f - r.alpha;
            float dalpha = t_excl * dld - S / one_minus;
            if (!(r.raw >= kAlphaEps && r.raw < kAlphaMax)) dalpha = 0.0f;
            const float dpower = r.raw * dalpha;
            s[0] = (a * r.dx + b * r.dy) * dpower;
            s[1] = (cc * r.dy + b * r.dx) * dpower;
            s[2] = -0.5f * r.dx * r.dx * dpower;
            s[3] = -r.dx * r.dy * dpower;
            s[4] = -0.5f * r.dy * r.dy * dpower;
            s[5] = r.e * dalpha;
#pragma unroll
            for (int d = 0; d < D; ++d) s[6 + d] = w * gi[d];
            s[6 + D] = w * gz;
          }
          if (!__any_sync(0xffffffffu, touched)) return false;
          const float sum = tg::warp_sum_fields<NV>(s);
          if (lane < NV) part[(warp * NV + lane) * kChunk + j] = sum;
          return true;
        },
        [&](int k, unsigned seen) {
          if (lane == 0) present[warp * tg::kWords + k] = seen;
        });
    __syncthreads();
    // the CTA's partial of chunk c: present warps in warp order
    float* cp = cpart + (c & 1) * NV * kChunk;
    for (int i = threadIdx.x; i < NV * kChunk; i += kThreads) {
      const int v = i / kChunk, j = i % kChunk;
      const unsigned bit = 1u << (j & 31);
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (present[w * tg::kWords + (j >> 5)] & bit) acc += part[(w * NV + v) * kChunk + j];
      cp[i] = acc;
    }
  }
  if (c < n_chunks) ring.wait(base + c);  // prefetched behind a saturated tile
  // chunks behind a saturated tile were skipped: their gradients are zeros
  for (int cz = c; cz < n_chunks; ++cz) {
    float* out = dvals + static_cast<size_t>(start + cz) * CH * kChunk;
    for (int i = rank * kShare + threadIdx.x; i < (rank + 1) * kShare; i += kThreads)
      out[i] = 0.0f;
  }
  tg::cluster_sync<NCTA>();  // no CTA leaves while another reads its partials
}

template <int D, int TS, bool EXACT, bool CULL>
int launch_bwd(const int* meta, const float* vals, const float* bg,
               const float* img, const float* alpha, const float* depth,
               const float* gimg, const float* galpha, const float* gdepth,
               float* dvals, int n_tiles, int n_tx, cudaStream_t stream) {
  return static_cast<int>(tg::launch_tiles<tg::ctas_per_tile<TS>()>(
      tilegrid_bwd_kernel<D, TS, EXACT, CULL>, n_tiles, bwd_smem_bytes<D>(), stream, meta,
      vals, bg, img, alpha, depth, gimg, galpha, gdepth, dvals, n_tiles, n_tx));
}

template <bool CULL>
int dispatch_bwd(const int* meta, const float* vals, const float* bg, const float* img,
                 const float* alpha, const float* depth, const float* gimg,
                 const float* galpha, const float* gdepth, float* dvals, int n_tiles,
                 int n_tx, int ts, int d, int exact_total, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EGOGS_BWD(D_, TS_, EX_)                                                      \
  if (d == D_ && ts == TS_ && (exact_total != 0) == EX_)                             \
    return launch_bwd<D_, TS_, EX_, CULL>(meta, vals, bg, img, alpha, depth, gimg,   \
                                          galpha, gdepth, dvals, n_tiles, n_tx, s);
  EGOGS_BWD(3, 16, false)
  EGOGS_BWD(3, 32, false)
  EGOGS_BWD(1, 16, false)
  EGOGS_BWD(1, 32, false)
  EGOGS_BWD(3, 16, true)
  EGOGS_BWD(3, 32, true)
  EGOGS_BWD(1, 16, true)
  EGOGS_BWD(1, 32, true)
#undef EGOGS_BWD
  return -1;
}

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes only the chunk slots of the
// tiles in meta; the caller zeroes the rest. exact_total selects the flavor.
// vals must be 16-byte aligned.
extern "C" int egogs_tilegrid_bwd(const int* meta, const float* vals,
                                  const float* bg, const float* img,
                                  const float* alpha, const float* depth,
                                  const float* gimg, const float* galpha,
                                  const float* gdepth, float* dvals,
                                  int n_tiles, int n_tx, int ts, int d,
                                  int exact_total, void* stream) {
  return egogs::dispatch_bwd<true>(meta, vals, bg, img, alpha, depth, gimg, galpha, gdepth,
                                   dvals, n_tiles, n_tx, ts, d, exact_total, stream);
}

// The same kernels with the per-warp cull compiled out: check instances,
// whose gradients must equal egogs_tilegrid_bwd's bit for bit.
extern "C" int egogs_tilegrid_bwd_nocull(const int* meta, const float* vals,
                                         const float* bg, const float* img,
                                         const float* alpha, const float* depth,
                                         const float* gimg, const float* galpha,
                                         const float* gdepth, float* dvals,
                                         int n_tiles, int n_tx, int ts, int d,
                                         int exact_total, void* stream) {
  return egogs::dispatch_bwd<false>(meta, vals, bg, img, alpha, depth, gimg, galpha, gdepth,
                                    dvals, n_tiles, n_tx, ts, d, exact_total, stream);
}
