// The log-space chunked compositor pair shared by the chunked windowed
// kernels (window_chunked_{fwd,bwd}.cu) and the stream kernels
// (stream_{fwd,bwd}.cu). Both TPU kernel pairs compute the same function
// per tile: the tile's depth-sorted pairs in row-major 128 x (7 + D)
// chunks, the transmittance carried in log space (log1p, in-chunk prefix
// plus carry), the backward one reverse sweep from the saved final log T.
// They differ only in where a tile's rows live and how many are real,
// which a chunk-source policy (WindowRows, StreamRows) answers per tile:
//   TileRows{row0, cnt, m, owned}: the tile's rows start at data[row0], the
//   first cnt of them real; its own CTAs write gradient rows [row0,
//   row0 + m) (m a multiple of 128); owned is false for a tile that has no
//   rows at all, which the forward leaves unwritten;
//   zero_padding(): the backward's gradient rows of no tile's share,
//   zeroed by the whole grid.
//
// Layout (tilegrid_cluster.cuh): a 16x16 quadrant per 256-thread CTA, one
// pixel per thread (ts 32: four CTAs per tile, ts 16: one), an 8x4 patch
// per warp. The forward is a plain grid (pixels are independent); the
// backward one cluster per tile, for its cross-CTA reduction.
//
// Per chunk, 128 threads compute each row's conservative reach box; each
// warp ballots the rows whose box meets its patch and walks only those. A
// skipped row has alpha == 0 at every pixel of the patch, where it moves
// nothing, so CULL = true equals the CULL = false instantiation bit for
// bit. Chunks arrive by bulk copy into a two-stage ring (tg::Ring); the
// backward reads them last to first.
//
// The backward reduces each row's gradient values in a FIXED order:
//   1. per warp, over its 32 pixels, by a halving exchange that leaves
//      lane f with field f (warp_sum_fields); a warp in which no pixel sees
//      the row skips it and marks it absent;
//   2. per CTA, the present warps' partials in warp order, into a
//      double-buffered chunk partial [128][7 + D] in shared memory;
//   3. per cluster, the CTAs' partials in rank order, read from
//      distributed shared memory after the next chunk's cluster barrier;
//      each CTA writes a quarter of the chunk's rows.
// No float atomics, so runs repeat bit for bit. Every one of the tile's m
// rows is written: rows at or past cnt and chunks past the last real one
// are zeros, and so are the padding's.
#pragma once

#include "tilegrid_cluster.cuh"

namespace egogs {
namespace cp {

struct TileRows {
  size_t row0;  // first row of the tile in the row-major [rows, 7 + D] input
  int cnt;      // real rows (a prefix of the tile's rows)
  int m;        // rows the tile's own CTAs write in the backward, a multiple of kChunk
  bool owned;   // false: the tile holds no row and is not written
};

// The chunked windowed layout: data [T, m, 7 + D], counts [T] (clamped to
// [0, m]). Every tile is written, rows past its count by its own CTAs.
struct WindowRows {
  const int* counts;
  int m;
  __device__ __forceinline__ TileRows operator()(int t) const {
    return {static_cast<size_t>(t) * m, min(max(counts[t], 0), m), m, true};
  }
  __device__ __forceinline__ void zero_padding(float*, int) const {}
};

// The stream layout: vals [n_slots * 128, 7 + D], meta [4, n_slots] per
// chunk slot (owning tile, rank of the chunk's first row in its tile, the
// tile's count). Row 0 is nondecreasing and a tile's slots are contiguous,
// so a warp's search finds the tile's run [lo, hi) of slots. Its real
// chunks are the prefix with rank < count; a run that the slot capacity
// cut holds fewer chunks than the count needs, so cnt is clamped to the
// run. A tile that owns no slot is not written (the caller masks it). The
// pure-padding slots (rank >= count: the tail after the last run, up to
// all n_slots when no tile has a pair) are zeroed by the whole grid, slot
// q by CTA q mod gridDim (zero_padding()), not by the tile that owns them:
// the last tile owns the tail, most of the layout at the default slot
// capacity.
struct StreamRows {
  const int* meta;
  int n_slots;

  // First slot whose owner is >= key, by a 16-ary search of one half warp
  // (every lane of the warp active, each half with its own key): each round
  // the half's lanes probe 16 evenly spaced slots of the range [lo, lo + n]
  // that holds the answer, and the count of probes below the key (a prefix
  // of the lanes: row 0 is nondecreasing) narrows it 16-fold. Three rounds
  // up to 4,368 slots (3,200 at 1920x1080), four up to 69,904.
  __device__ __forceinline__ int first_slot(int key) const {
    const int lane = threadIdx.x & 31, l = lane & 15;
    const unsigned half = 0xffffu << (lane & 16);
    int lo = 0, n = n_slots;
    while (__any_sync(0xffffffffu, n > 0)) {
      const int step = (n + 15) / 16;
      const int pos = lo + (l + 1) * step - 1;
      const bool below = n > 0 && pos < lo + n && __ldg(meta + pos) < key;
      const int c = __popc(__ballot_sync(0xffffffffu, below) & half);
      if (n > 0) {
        n = min(step - 1, n - c * step);
        lo += c * step;
      }
    }
    return lo;
  }

  __device__ __forceinline__ TileRows operator()(int t) const {
    // the run's two ends at once: half warp 0 searches for t, 1 for t + 1
    const int end = first_slot(t + ((threadIdx.x >> 4) & 1));
    const int lo = __shfl_sync(0xffffffffu, end, 0), hi = __shfl_sync(0xffffffffu, end, 16);
    if (lo == hi) return {0, 0, 0, false};
    const int real = max(__ldg(meta + 2 * n_slots + lo) - __ldg(meta + n_slots + lo), 0);
    const int n_real = min((real + kChunk - 1) / kChunk, hi - lo);
    // the run's pure-padding slots past n_real belong to zero_padding()
    return {static_cast<size_t>(lo) * kChunk, min(real, n_real * kChunk), n_real * kChunk, true};
  }

  // The CTA's slots q = blockIdx.x + i * gridDim.x: thread (i % 8) * 32 +
  // i / 8 tests slot i (one round of loads for up to 256 slots), and each
  // warp zeroes the padding slots its lanes found.
  __device__ __forceinline__ void zero_padding(float* ddata, int nv) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i0 = 0; blockIdx.x + i0 * gridDim.x < n_slots; i0 += kThreads) {
      const int q = blockIdx.x + (i0 + lane * kWarps + warp) * gridDim.x;
      const bool pad = q < n_slots && __ldg(meta + n_slots + q) >= __ldg(meta + 2 * n_slots + q);
      for (unsigned m = __ballot_sync(0xffffffffu, pad); m; m &= m - 1) {
        const int slot = __shfl_sync(0xffffffffu, q, __ffs(m) - 1);
        float4* out = reinterpret_cast<float4*>(ddata + static_cast<size_t>(slot) * kChunk * nv);
        for (int k = lane; k < kChunk * nv / 4; k += 32)
          out[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
};

constexpr int kFwdHead = 64 + kChunk * 16;  // barriers | reach boxes
constexpr int kBwdHead = 2240;              // barriers | warp masks | reach boxes

template <int D>
constexpr int fwd_smem_bytes() {
  // head | two chunk stages
  return kFwdHead + 2 * kChunk * (7 + D) * 4;
}

template <int D>
constexpr int bwd_smem_bytes() {
  // head | two chunk stages | warp partials | two CTA chunk partials
  return kBwdHead + 2 * kChunk * (7 + D) * 4 + kWarps * kChunk * (7 + D) * 4 +
         2 * kChunk * (7 + D) * 4;
}

// Forward: per tile, its real chunks, rows at or past cnt masked; img =
// sum w*col + exp(logT_final)*bg, alpha = sum w, depth = sum w*z, and the
// final logT per pixel ([T, 1, P]) that the backward starts from.
template <class Rows, int D, int TS, bool CULL>
__global__ void __launch_bounds__(kThreads, 4)
    chunked_fwd_kernel(const Rows rows, const float* __restrict__ data,
                       const float* __restrict__ bg, float* __restrict__ img,
                       float* __restrict__ alpha_out, float* __restrict__ depth_out,
                       float* __restrict__ logt_out, int n_tx, int tps) {
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
  const TileRows run = rows(t);
  if (!run.owned) return;
  const int cnt = run.cnt;
  const int n_chunks = (cnt + kChunk - 1) / kChunk;
  const float* window = data + run.row0 * CH;
  const int scene = t / tps;  // scene-major tiles: tps tiles per scene
  const tg::Pixel pix = tg::pixel_of<TS>(t - scene * tps, n_tx, rank);

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
  for (int d = 0; d < D; ++d) img[idx * D + d] = acc[d] + t_final * bg[scene * D + d];
  alpha_out[idx] = acc_a;
  depth_out[idx] = acc_z;
  logt_out[idx] = logT;
}

// Backward: one reverse sweep over the tile's real chunks, last to first,
// from the saved final logT. Per row and pixel, with U the inclusive suffix
// of log(1 - alpha) plus the carry of the later chunks:
//   T_excl_i = exp(logT_total - U_i),  w_i = alpha_i * T_excl_i,
//   dL/dw_i  = z_i*gdepth + galpha + col_i . gimg,  wd_i = w_i * dL/dw_i,
//   S_i      = (inclusive suffix of wd - wd_i) + suffix carry + base_S,
//   base_S   = exp(logT_total) * (gimg . bg),
//   dalpha_i = T_excl_i dL/dw_i - S_i / max(1 - alpha_i, 1e-6),
//              gated to eps <= raw < 0.99,
// and per row the 7 + D values (dmu_x, dmu_y, da, db, dc, dop, dcol x D,
// dz) summed over the tile's pixels.
template <class Rows, int D, int TS, bool CULL>
__global__ void __launch_bounds__(kThreads, 2)
    chunked_bwd_kernel(const Rows rows, const float* __restrict__ data,
                       const float* __restrict__ bg, const float* __restrict__ logt,
                       const float* __restrict__ gimg, const float* __restrict__ galpha,
                       const float* __restrict__ gdepth, float* __restrict__ ddata,
                       int n_tx, int tps) {
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

  rows.zero_padding(ddata, NV);  // rows of no tile's own share, by every CTA

  const int t = blockIdx.x / NCTA;
  const int rank = blockIdx.x % NCTA;
  const TileRows run = rows(t);
  if (!run.owned) return;  // the whole cluster returns: no barrier is left waiting
  const int cnt = run.cnt;
  const int n_chunks = (cnt + kChunk - 1) / kChunk;
  const float* window = data + run.row0 * NV;
  float* dwindow = ddata + run.row0 * NV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int scene = t / tps;  // scene-major tiles: tps tiles per scene
  const tg::Pixel pix = tg::pixel_of<TS>(t - scene * tps, n_tx, rank);
  const size_t idx = static_cast<size_t>(t) * P + pix.local;

  // rows past the tile's last real chunk: zero gradient (each CTA a share)
  for (int i = n_chunks * kRows + rank * kThreads + static_cast<int>(threadIdx.x);
       i < run.m * NV; i += NCTA * kThreads)
    dwindow[i] = 0.0f;

  const float logT_total = logt[idx];
  float gi[D], g_dot_bg = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    gi[d] = gimg[idx * D + d];
    g_dot_bg += gi[d] * bg[scene * D + d];
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

// Launch the forward over n_tiles tiles: a plain grid of ctas_per_tile CTAs
// per tile (no cluster: the forward's CTAs share nothing). Returns
// cudaGetLastError() after the launch, or -1 for a (d, ts) not built.
template <bool CULL, class Rows>
int launch_fwd(Rows rows, const float* data, const float* bg, float* img, float* alpha,
               float* depth, float* logt, int n_tiles, int n_tx, int tps, int ts,
               int d, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EGOGS_CPFWD(D_, TS_)                                                              \
  if (d == D_ && ts == TS_)                                                               \
    return static_cast<int>(tg::launch_tiles<1>(                                          \
        chunked_fwd_kernel<Rows, D_, TS_, CULL>, n_tiles * tg::ctas_per_tile<TS_>(),      \
        fwd_smem_bytes<D_>(), s, rows, data, bg, img, alpha, depth, logt, n_tx, tps));
  EGOGS_CPFWD(3, 16)
  EGOGS_CPFWD(3, 32)
  EGOGS_CPFWD(1, 16)
  EGOGS_CPFWD(1, 32)
#undef EGOGS_CPFWD
  return -1;
}

// Launch the backward: one cluster of ctas_per_tile CTAs per tile.
template <bool CULL, class Rows>
int launch_bwd(Rows rows, const float* data, const float* bg, const float* logt,
               const float* gimg, const float* galpha, const float* gdepth, float* ddata,
               int n_tiles, int n_tx, int tps, int ts, int d, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EGOGS_CPBWD(D_, TS_)                                                               \
  if (d == D_ && ts == TS_)                                                                \
    return static_cast<int>(tg::launch_tiles<tg::ctas_per_tile<TS_>()>(                    \
        chunked_bwd_kernel<Rows, D_, TS_, CULL>, n_tiles, bwd_smem_bytes<D_>(), s, rows,   \
        data, bg, logt, gimg, galpha, gdepth, ddata, n_tx, tps));
  EGOGS_CPBWD(3, 16)
  EGOGS_CPBWD(3, 32)
  EGOGS_CPBWD(1, 16)
  EGOGS_CPBWD(1, 32)
#undef EGOGS_CPBWD
  return -1;
}

}  // namespace cp
}  // namespace egogs
