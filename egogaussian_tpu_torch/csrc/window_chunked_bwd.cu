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
// [T, M, 7+D] row-major, M a multiple of 128; bg [1, D]; logt [T, 1, P];
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
// Design (tilegrid_cluster.cuh, as the tile-grid backward):
//   * One cluster per tile: at ts 32 four CTAs of 256 threads, a 16x16
//     quadrant each, one pixel per thread (ts 16: one CTA, no cluster).
//   * Per chunk, the rows' conservative reach boxes; each warp (an 8x4
//     patch) ballots the rows whose box meets its patch and walks only
//     those, last to first. A skipped row has alpha == 0 at every pixel of
//     the patch: it moves no suffix and adds nothing, so the gradients
//     equal the CULL = false instantiation bit for bit.
//   * Each row's gradient values are reduced in a FIXED order:
//       1. per warp, over its 32 pixels, by a halving exchange that leaves
//          lane f with field f (warp_sum_fields, 12 shuffles at D = 3); a
//          warp in which no pixel sees the row skips it and marks it
//          absent;
//       2. per CTA, the present warps' partials in warp order, into a
//          double-buffered chunk partial [128][7 + D] in shared memory;
//       3. per cluster, the CTAs' partials in rank order, read from
//          distributed shared memory after the next chunk's cluster
//          barrier; each CTA writes a quarter of the chunk's rows.
//     No float atomics, so runs repeat bit for bit.
//   * Chunks arrive last to first by bulk copy into a two-stage ring
//     (tg::Ring): chunk c - 1 is in flight while chunk c is walked.
#include "tilegrid_cluster.cuh"

namespace egogs {

namespace {

constexpr int kBwdHead = 2240;  // barriers | warp masks | reach boxes

template <int D>
constexpr int wc_bwd_smem_bytes() {
  // head | two chunk stages | warp partials | two CTA chunk partials
  return kBwdHead + 2 * kChunk * (7 + D) * 4 + kWarps * kChunk * (7 + D) * 4 +
         2 * kChunk * (7 + D) * 4;
}

}  // namespace

template <int D, int TS, bool CULL>
__global__ void __launch_bounds__(kThreads, 2)
    window_chunked_bwd_kernel(const int* __restrict__ counts,
                              const float* __restrict__ data,
                              const float* __restrict__ bg,
                              const float* __restrict__ logt,
                              const float* __restrict__ gimg,
                              const float* __restrict__ galpha,
                              const float* __restrict__ gdepth,
                              float* __restrict__ ddata, int m, int n_tx) {
  constexpr int NCTA = tg::ctas_per_tile<TS>();
  constexpr int P = TS * TS;
  constexpr int NV = 7 + D;            // fields per row == gradient values per row
  constexpr int kRows = kChunk * NV;   // floats of one chunk, in and out
  constexpr int kShare = kRows / NCTA;  // output floats of a chunk per CTA
  static_assert(kRows % NCTA == 0, "a chunk splits evenly over the cluster");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned* present = reinterpret_cast<unsigned*>(smem + 48);   // [kWarps][kWords]
  float4* box = reinterpret_cast<float4*>(smem + 192);          // [kChunk]
  float* stage0 = reinterpret_cast<float*>(smem + kBwdHead);    // [kChunk][NV]
  float* stage1 = stage0 + kRows;
  float* part = stage1 + kRows;                                 // [kWarps][kChunk][NV]
  float* cpart = part + kWarps * kRows;                         // [2][kChunk][NV]
  static_assert(192 + kChunk * 16 <= kBwdHead, "shared-memory head");

  const int t = blockIdx.x / NCTA;
  const int rank = blockIdx.x % NCTA;
  const int cnt = min(max(counts[t], 0), m);
  const int n_chunks = (cnt + kChunk - 1) / kChunk;
  const float* window = data + static_cast<size_t>(t) * m * NV;
  float* dwindow = ddata + static_cast<size_t>(t) * m * NV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const tg::Pixel pix = tg::pixel_of<TS>(t, n_tx, rank);
  const size_t idx = static_cast<size_t>(t) * P + pix.local;

  // rows past the tile's last chunk: zero gradient (each CTA a share)
  for (int i = n_chunks * kRows + rank * kThreads + static_cast<int>(threadIdx.x); i < m * NV;
       i += NCTA * kThreads)
    dwindow[i] = 0.0f;

  const float logT_total = logt[idx];
  float gi[D], g_dot_bg = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    gi[d] = gimg[idx * D + d];
    g_dot_bg += gi[d] * bg[d];
  }
  const float ga = galpha[idx];
  const float gz = gdepth[idx];
  const float base_S = expf(logT_total) * g_dot_bg;
  float suf_log = 0.0f, suf_S = 0.0f;  // carries of the later chunks

  tg::Ring ring;
  ring.init(stage0, stage1, bar, kRows * 4);
  __syncthreads();
  tg::cluster_sync<NCTA>();  // the cluster's CTAs run before their partials are read
  const float* src_part[NCTA];
  if constexpr (NCTA > 1) {
    tg::cg::cluster_group cl = tg::cg::this_cluster();
#pragma unroll
    for (int r = 0; r < NCTA; ++r) src_part[r] = cl.map_shared_rank(cpart, r);
  } else {
    src_part[0] = cpart;
  }

  // chunk c's rows of this CTA's share, whose partials sit in slot `slot`:
  // the CTAs' partials summed in rank order
  auto write_chunk = [&](int c, int slot) {
    float* out = dwindow + static_cast<size_t>(c) * kRows;
    const int off = slot * kRows;
    for (int i = rank * kShare + static_cast<int>(threadIdx.x); i < (rank + 1) * kShare;
         i += kThreads) {
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < NCTA; ++r) acc += src_part[r][off + i];
      out[i] = acc;
    }
  };

  if (n_chunks > 0) ring.issue(window + static_cast<size_t>(n_chunks - 1) * kRows);
  for (int k = 0;; ++k) {  // the k-th chunk walked is chunk n_chunks - 1 - k
    // orders every CTA's partial of the previous chunk before the reads
    // that sum it, and ends the readers of the ring stage and the boxes
    tg::tile_sync<NCTA>();
    if (k > 0) write_chunk(n_chunks - k, (k - 1) & 1);
    if (k == n_chunks) break;
    const int c = n_chunks - 1 - k;
    if (c > 0) ring.issue(window + static_cast<size_t>(c - 1) * kRows);
    ring.wait(k);
    const float* blk = (k & 1) ? stage1 : stage0;
    const int n_valid = min(kChunk, cnt - c * kChunk);  // rows past the count: op = 0
    if (CULL && static_cast<int>(threadIdx.x) < n_valid) {
      const float* pr = blk + threadIdx.x * NV;
      box[threadIdx.x] = tg::reach_box(pr[0], pr[1], pr[2], pr[3], pr[4], pr[5]);
    }
    __syncthreads();
    unsigned mk[tg::kWords];
    tg::patch_pairs<CULL>(box, n_valid, pix, mk);

    float ls = 0.0f, lS = 0.0f;  // in-chunk suffix sums of log1m and wd
    tg::walk_pairs<true>(
        mk,
        [&](int j) {
          const float* pr = blk + j * NV;
          const float a = pr[2], b = pr[3], cc = pr[4];
          const PairAlpha r = pair_alpha(pix.px, pix.py, pr[0], pr[1], a, b, cc, pr[5]);
          float s[NV];
#pragma unroll
          for (int v = 0; v < NV; ++v) s[v] = 0.0f;
          // alpha == 0: log1m == 0, w == 0, dalpha gated to 0: every term zero
          const bool touched = r.alpha != 0.0f;
          if (touched) {
            const float log1m = log1pf(-r.alpha);
            ls += log1m;
            const float U = ls + suf_log;
            const float t_excl = expf(logT_total - U);
            const float w = r.alpha * t_excl;
            float dld = pr[6 + D] * gz + ga;
#pragma unroll
            for (int d = 0; d < D; ++d) dld += pr[6 + d] * gi[d];
            const float wd = w * dld;
            lS += wd;
            const float S = ((lS - wd) + suf_S) + base_S;
            const float one_minus = fmaxf(1.0f - r.alpha, 1e-6f);
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
          if (lane < NV) part[(warp * kChunk + j) * NV + lane] = sum;
          return true;
        },
        [&](int w, unsigned seen) {
          if (lane == 0) present[warp * tg::kWords + w] = seen;
        });
    suf_log += ls;
    suf_S += lS;
    __syncthreads();
    // the CTA's partial of chunk c: present warps in warp order; rows no
    // warp saw (at or past the count among them) are zeros
    float* cp = cpart + (k & 1) * kRows;
    for (int i = threadIdx.x; i < kRows; i += kThreads) {
      const int j = i / NV;
      const unsigned bit = 1u << (j & 31);
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (present[w * tg::kWords + (j >> 5)] & bit) acc += part[w * kRows + i];
      cp[i] = acc;
    }
  }
  tg::cluster_sync<NCTA>();  // no CTA leaves while another reads its partials
}

namespace {

template <int D, int TS, bool CULL>
int wc_launch_bwd(const int* counts, const float* data, const float* bg, const float* logt,
                  const float* gimg, const float* galpha, const float* gdepth, float* ddata,
                  int n_tiles, int m, int n_tx, cudaStream_t stream) {
  return static_cast<int>(tg::launch_tiles<tg::ctas_per_tile<TS>()>(
      window_chunked_bwd_kernel<D, TS, CULL>, n_tiles, wc_bwd_smem_bytes<D>(), stream, counts,
      data, bg, logt, gimg, galpha, gdepth, ddata, m, n_tx));
}

template <bool CULL>
int wc_dispatch_bwd(const int* counts, const float* data, const float* bg, const float* logt,
                    const float* gimg, const float* galpha, const float* gdepth,
                    float* ddata, int n_tiles, int m, int n_tx, int ts, int d, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EGOGS_WCBWD(D_, TS_)                                                           \
  if (d == D_ && ts == TS_)                                                            \
    return wc_launch_bwd<D_, TS_, CULL>(counts, data, bg, logt, gimg, galpha, gdepth,  \
                                        ddata, n_tiles, m, n_tx, s);
  EGOGS_WCBWD(3, 16)
  EGOGS_WCBWD(3, 32)
  EGOGS_WCBWD(1, 16)
  EGOGS_WCBWD(1, 32)
#undef EGOGS_WCBWD
  return -1;
}

}  // namespace

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes every row of ddata. data
// must be 16-byte aligned.
extern "C" int egogs_window_chunked_bwd(const int* counts, const float* data,
                                        const float* bg, const float* logt,
                                        const float* gimg, const float* galpha,
                                        const float* gdepth, float* ddata, int n_tiles,
                                        int m, int n_tx, int ts, int d, void* stream) {
  return egogs::wc_dispatch_bwd<true>(counts, data, bg, logt, gimg, galpha, gdepth, ddata,
                                      n_tiles, m, n_tx, ts, d, stream);
}

// The same kernel with the per-warp cull compiled out: a check instance,
// whose gradients must equal egogs_window_chunked_bwd's bit for bit.
extern "C" int egogs_window_chunked_bwd_nocull(const int* counts, const float* data,
                                               const float* bg, const float* logt,
                                               const float* gimg, const float* galpha,
                                               const float* gdepth, float* ddata,
                                               int n_tiles, int m, int n_tx, int ts, int d,
                                               void* stream) {
  return egogs::wc_dispatch_bwd<false>(counts, data, bg, logt, gimg, galpha, gdepth, ddata,
                                       n_tiles, m, n_tx, ts, d, stream);
}
