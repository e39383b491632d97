// Windowed compositor (simple), backward.
//
// Replaces: egogaussian_tpu/render/pallas_raster.py, _bwd_kernel (the VJP
// of make_tile_compositor), reached in the port through
// render/window_raster.py make_tile_compositor.
//
// What it computes: the TPU kernel recomputes the forward over all M rows
// and takes the weighted suffix as total - inclusive prefix:
//   incl_i   = sum_{j<=i} log(1 - alpha_j),  T_excl_i = exp(incl_i - log1m_i),
//   w_i      = alpha_i * T_excl_i,
//   dL/dw_i  = col_i . gimg + z_i*gdepth + galpha,
//   incl_wd_i = sum_{j<=i} w_j dL/dw_j,  total_wd = incl_wd_last,
//   S_i      = (total_wd - incl_wd_i) + exp(incl_last) * (gimg . bg),
//   dalpha_i = T_excl_i dL/dw_i - S_i / max(1 - alpha_i, 1e-6),
//              gated to eps <= raw < 0.99,
// and emits per row dmu [2], dcon [3], dop, dcol [D], dz summed over the
// tile's pixels. As in the TPU kernel there is NO clamp mask on power (its
// `jnp.where(power < 0, dpower, dpower)` is a no-op).
//
// Ordering: the total must be known before the first row's S, so each tile
// makes two forward sweeps over its live chunks: a value-only pre-sweep
// that yields each pixel's total_wd and final log-transmittance, then the
// gradient sweep. Both walk the same rows in the same order through one
// inline value path with pinned roundings (__fadd_rn, __fmul_rn,
// __fmaf_rn), so the gradient sweep's prefix reaches exactly the
// pre-sweep's total at the last row, as the TPU kernel's cumsum does (the
// tile-grid exact-total backward's scheme, tilegrid_bwd.cu, in log space).
//
// Interface (the TPU kernel's): mu [T, M, 2], con [T, M, 3], op [T, M, 1]
// (0 on masked rows), col [T, M, D], z [T, M, 1], bg [1, D], gimg [T, P, D],
// galpha, gdepth [T, P, 1] -> dmu, dcon, dop, dcol, dz of the input shapes,
// M any size. Every row is written: rows no pixel sees, and every row of
// a skipped all-masked chunk, are zeros.
//
// What bounds it on the card: per covered pair and pixel two expf and two
// log1pf (one of each per sweep), ~60 other instructions and a division,
// plus the per-row reduction of 7 + D values over the tile's pixels, which
// costs more than the arithmetic where few pixels of a warp are covered.
// Device-memory traffic (the needed rows read twice, the op column once,
// the gradient window written once) is small next to both. The first
// version (one block per tile, four pixels per thread spread over the
// tile, every unmasked row evaluated at every pixel in both sweeps and
// reduced through every warp, all eight warp partials summed by one
// block for every row of every chunk) took 1.56 ms on the 640x480 timing
// frame, 1.7% of its bound.
//
// Design: the forward's layout (window_fwd.cu): a 16x16 quadrant per
// 256-thread CTA, one pixel per thread, 8x4 warp patches, the live-chunk
// scan, the staging and the packed rows of window_split.cuh, the per-warp
// reach-box cull (bit-identical to CULL = false). ts 32: one cluster of
// four CTAs per tile, ts 16: one CTA. Each row's gradient is reduced in a FIXED order:
//   1. per warp, over its 32 pixels, by a halving exchange that leaves
//      lane f with field f (warp_sum_fields); a warp in which no pixel sees
//      the row skips it and marks it absent;
//   2. per CTA, the present warps' partials in warp order, into a
//      double-buffered chunk partial (a staged chunk's field-major layout)
//      in shared memory;
//   3. per cluster, the CTAs' partials in rank order, read from
//      distributed shared memory after the next chunk's cluster barrier;
//      each CTA writes a quarter of each field's values of the chunk.
// No float atomics, so runs repeat bit for bit.
#include "window_split.cuh"

namespace egogs {

namespace {

// One row's value path at one pixel, shared by both sweeps: advances the
// log-transmittance prefix and the weighted-gradient prefix.
template <int D>
__device__ __forceinline__ void window_value(float alpha, const float (&col)[D], float z,
                                             float gz, float ga, const float (&gi)[D],
                                             float& logT, float& incl_wd, float& t_excl,
                                             float& w, float& dld) {
  const float log1m = log1pf(-alpha);
  logT = __fadd_rn(logT, log1m);
  t_excl = expf(__fsub_rn(logT, log1m));
  w = __fmul_rn(alpha, t_excl);
  dld = __fmaf_rn(z, gz, ga);
#pragma unroll
  for (int d = 0; d < D; ++d) dld = __fmaf_rn(col[d], gi[d], dld);
  incl_wd = __fmaf_rn(w, dld, incl_wd);
}

constexpr int kBwdHead = 512 + kChunk * 16;  // barriers | live mask | warp masks | reach boxes

template <int D>
constexpr int bwd_smem_bytes() {
  // head | packed rows | two chunk stages | warp partials | two CTA chunk partials
  return kBwdHead + kChunk * ws::row_width<D>() * 4 + 2 * kChunk * (7 + D) * 4 +
         kWarps * kChunk * (7 + D) * 4 + 2 * kChunk * (7 + D) * 4;
}

}  // namespace

template <int D, int TS, bool CULL>
__global__ void __launch_bounds__(kThreads, 3)
    window_bwd_kernel(const ws::Split<D, const float> win, const float* __restrict__ bg,
                      const float* __restrict__ gimg, const float* __restrict__ galpha,
                      const float* __restrict__ gdepth, const ws::Split<D, float> grad,
                      int n_tx) {
  constexpr int NCTA = tg::ctas_per_tile<TS>();
  constexpr int P = TS * TS;
  constexpr int NV = 7 + D;            // fields per row == gradient values per row
  constexpr int kRows = kChunk * NV;   // floats of one chunk, in and out
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned* mask = reinterpret_cast<unsigned*>(smem + 16);      // [kMaskWords]
  unsigned* present = reinterpret_cast<unsigned*>(smem + 256);  // [kWarps][kWords]
  float4* box = reinterpret_cast<float4*>(smem + 512);          // [kChunk]
  float* rows = reinterpret_cast<float*>(smem + kBwdHead);      // [kChunk][row_width]
  float* stage0 = rows + kChunk * ws::row_width<D>();           // [kRows] each
  float* part = stage0 + 2 * kRows;                             // [kWarps][kRows]
  float* cpart = part + kWarps * kRows;                         // [2][kRows]
  static_assert(16 + 4 * ws::kMaskWords <= 256, "shared-memory head");
  static_assert(256 + 4 * kWarps * tg::kWords <= 512, "shared-memory head");

  const int t = blockIdx.x / NCTA;
  const int rank = blockIdx.x % NCTA;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const tg::Pixel pix = tg::pixel_of<TS>(t, n_tx, rank);
  const size_t idx = static_cast<size_t>(t) * P + pix.local;
  const int n = win.n_chunks();

  tg::Ring ring;
  ring.init(stage0, stage0 + kRows, bar, 0);
  win.scan_live(t, mask);  // its barriers also publish the ring's barriers

  // the rows of skipped chunks: zero gradient (each CTA a share)
  for (int c = 0; c < min(n, ws::kMaskChunks); ++c) {
    if (!ws::is_live(mask, c))
      grad.visit(t, c, rank, NCTA, [](int, int, float* p) { *p = 0.0f; });
  }

  float gi[D], g_dot_bg = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    gi[d] = gimg[idx * D + d];
    g_dot_bg += gi[d] * bg[d];
  }
  const float ga = galpha[idx];
  const float gz = gdepth[idx];
  float logT = 0.0f, incl_wd = 0.0f;  // the sweeps' prefixes

  tg::cluster_sync<NCTA>();  // the cluster's CTAs run before their partials are read
  const float* src_part[NCTA];
  if constexpr (NCTA > 1) {
    tg::cg::cluster_group cl = tg::cg::this_cluster();
#pragma unroll
    for (int r = 0; r < NCTA; ++r) src_part[r] = cl.map_shared_rank(cpart, r);
  } else {
    src_part[0] = cpart;
  }

  // chunk c staged as load L: its packed rows, reach boxes and the warp's row masks
  auto stage_chunk = [&](int L, int c, unsigned (&mk)[tg::kWords]) {
    const int n_valid = win.rows(c);
    ws::pack_chunk<D, CULL>(win.ready(ring, L, t, c), n_valid, rows, box);
    __syncthreads();
    tg::patch_pairs<CULL>(box, n_valid, pix, mk);
  };
  // packed row j's alpha at the pixel (r holds fields 0-7; all of them
  // after r.tail)
  auto alpha_of = [&](int j, ws::Row<D>& r) {
    r.head(rows, j);
    return pair_alpha(pix.px, pix.py, r.v[0], r.v[1], r.v[2], r.v[3], r.v[4], r.v[5]);
  };
  auto value = [&](const PairAlpha& a, ws::Row<D>& r, int j, float& t_excl, float& w,
                   float& dld) {
    r.tail(rows, j);
    float col[D];
#pragma unroll
    for (int d = 0; d < D; ++d) col[d] = r.v[6 + d];
    window_value<D>(a.alpha, col, r.v[6 + D], gz, ga, gi, logT, incl_wd, t_excl, w, dld);
  };

  const int first = ws::next_live(mask, -1, n);
  int L = 0;  // loads so far

  // value-only pre-sweep; its last chunk prefetches the gradient sweep's first
  if (first < n) win.issue(ring, t, first);
  for (int c = first; c < n; ++L) {
    // the readers of the stage the next chunk lands in, of the packed rows
    // and of the boxes are done
    __syncthreads();
    const int next = ws::next_live(mask, c, n);
    win.issue(ring, t, next < n ? next : first);
    unsigned mk[tg::kWords];
    stage_chunk(L, c, mk);
    tg::walk_pairs(
        mk,
        [&](int j) {
          ws::Row<D> r;
          const PairAlpha a = alpha_of(j, r);
          if (a.alpha == 0.0f) return false;
          float t_excl, w, dld;
          value(a, r, j, t_excl, w, dld);
          return false;
        },
        [](int, unsigned) {});
    c = next;
  }
  const float total_wd = incl_wd;
  const float base_S = expf(logT) * g_dot_bg;
  logT = 0.0f;
  incl_wd = 0.0f;

  // chunk c's values of this CTA's share, whose partials sit in slot `slot`:
  // the CTAs' partials summed in rank order
  auto write_chunk = [&](int c, int slot) {
    grad.visit(t, c, rank, NCTA, [&](int s, int k, float* p) {
      const int i = slot * kRows + ws::seg<D>(s) + k;
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < NCTA; ++r) acc += src_part[r][i];
      *p = acc;
    });
  };

  // gradient sweep
  int prev = -1;
  for (int c = first, k = 0;; ++k, ++L) {
    // orders every CTA's partial of the previous chunk before the reads
    // that sum it, and ends the readers of the ring stage, the packed rows
    // and the boxes
    tg::tile_sync<NCTA>();
    if (prev >= 0) write_chunk(prev, (k - 1) & 1);
    if (c >= n) break;
    const int next = ws::next_live(mask, c, n);
    if (next < n) win.issue(ring, t, next);
    unsigned mk[tg::kWords];
    stage_chunk(L, c, mk);
    tg::walk_pairs(
        mk,
        [&](int j) {
          ws::Row<D> r;
          const PairAlpha e = alpha_of(j, r);
          float s[NV];
#pragma unroll
          for (int v = 0; v < NV; ++v) s[v] = 0.0f;
          // alpha == 0: log1m == 0, w == 0, dalpha gated to 0: every term zero
          const bool touched = e.alpha != 0.0f;
          if (touched) {
            const float a = r.v[2], b = r.v[3], cc = r.v[4];
            float t_excl, w, dld;
            value(e, r, j, t_excl, w, dld);
            const float S = (total_wd - incl_wd) + base_S;
            const float one_minus = fmaxf(1.0f - e.alpha, 1e-6f);
            float dalpha = t_excl * dld - S / one_minus;
            if (!(e.raw >= kAlphaEps && e.raw < kAlphaMax)) dalpha = 0.0f;
            const float dpower = e.raw * dalpha;
            s[0] = (a * e.dx + b * e.dy) * dpower;
            s[1] = (cc * e.dy + b * e.dx) * dpower;
            s[2] = -0.5f * e.dx * e.dx * dpower;
            s[3] = -e.dx * e.dy * dpower;
            s[4] = -0.5f * e.dy * e.dy * dpower;
            s[5] = e.e * dalpha;
#pragma unroll
            for (int d = 0; d < D; ++d) s[6 + d] = w * gi[d];
            s[6 + D] = w * gz;
          }
          if (!__any_sync(0xffffffffu, touched)) return false;
          const float sum = tg::warp_sum_fields<NV>(s);
          if (lane < NV) part[warp * kRows + ws::at<D>(j, lane)] = sum;
          return true;
        },
        [&](int w, unsigned seen) {
          if (lane == 0) present[warp * tg::kWords + w] = seen;
        });
    __syncthreads();
    // the CTA's partial of chunk c: present warps in warp order; rows no
    // warp saw are zeros
    float* cp = cpart + (k & 1) * kRows;
#pragma unroll
    for (int s = 0; s < ws::kFields; ++s) {
      const int wd = ws::width<D>(s);
      for (int q = threadIdx.x; q < kChunk * wd; q += kThreads) {
        const int i = ws::seg<D>(s) + q, j = q / wd;
        const unsigned bit = 1u << (j & 31);
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          if (present[w * tg::kWords + (j >> 5)] & bit) acc += part[w * kRows + i];
        cp[i] = acc;
      }
    }
    prev = c;
    c = next;
  }
  tg::cluster_sync<NCTA>();  // no CTA leaves while another reads its partials
}

template <bool CULL>
int dispatch_window_bwd(const float* mu, const float* con, const float* op, const float* col,
                        const float* z, const float* bg, const float* gimg,
                        const float* galpha, const float* gdepth, float* dmu, float* dcon,
                        float* dop, float* dcol, float* dz, int n_tiles, int m, int n_tx,
                        int ts, int d, void* stream) {
  if (n_tiles == 0 || m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[ws::kFields] = {mu, con, op, col, z};
  bool bulk = m % 4 == 0;
  for (const float* p : f) bulk = bulk && reinterpret_cast<uintptr_t>(p) % 16 == 0;
#define EGOGS_WBWD(D_, TS_)                                                                \
  if (d == D_ && ts == TS_)                                                                \
    return static_cast<int>(tg::launch_tiles<tg::ctas_per_tile<TS_>()>(                    \
        window_bwd_kernel<D_, TS_, CULL>, n_tiles, bwd_smem_bytes<D_>(), s,                \
        ws::Split<D_, const float>{{mu, con, op, col, z}, m, bulk}, bg, gimg, galpha,      \
        gdepth, ws::Split<D_, float>{{dmu, dcon, dop, dcol, dz}, m, false}, n_tx));
  EGOGS_WBWD(3, 16)
  EGOGS_WBWD(3, 32)
  EGOGS_WBWD(1, 16)
  EGOGS_WBWD(1, 32)
#undef EGOGS_WBWD
  return -1;
}

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes every row of the five
// gradients.
extern "C" int egogs_window_bwd(const float* mu, const float* con, const float* op,
                                const float* col, const float* z, const float* bg,
                                const float* gimg, const float* galpha, const float* gdepth,
                                float* dmu, float* dcon, float* dop, float* dcol, float* dz,
                                int n_tiles, int m, int n_tx, int ts, int d, void* stream) {
  return egogs::dispatch_window_bwd<true>(mu, con, op, col, z, bg, gimg, galpha, gdepth, dmu,
                                          dcon, dop, dcol, dz, n_tiles, m, n_tx, ts, d, stream);
}

// The same kernel with the per-warp cull compiled out: a check instance,
// whose gradients must equal egogs_window_bwd's bit for bit.
extern "C" int egogs_window_bwd_nocull(const float* mu, const float* con, const float* op,
                                       const float* col, const float* z, const float* bg,
                                       const float* gimg, const float* galpha,
                                       const float* gdepth, float* dmu, float* dcon,
                                       float* dop, float* dcol, float* dz, int n_tiles, int m,
                                       int n_tx, int ts, int d, void* stream) {
  return egogs::dispatch_window_bwd<false>(mu, con, op, col, z, bg, gimg, galpha, gdepth, dmu,
                                           dcon, dop, dcol, dz, n_tiles, m, n_tx, ts, d,
                                           stream);
}
