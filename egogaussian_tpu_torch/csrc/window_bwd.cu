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
// Ordering: the total must be known before the first row's S, so the block
// makes two sweeps over the window: a value-only pre-sweep that yields each
// pixel's total_wd and final log-transmittance, then the gradient sweep.
// Both run one inline value path with pinned roundings (__fadd_rn,
// __fmul_rn, __fmaf_rn), so the gradient sweep's prefix reaches exactly the
// pre-sweep's total at the last row, as the TPU kernel's cumsum does.
//
// Interface (the TPU kernel's): mu [T, M, 2], con [T, M, 3], op [T, M, 1]
// (0 on masked rows), col [T, M, D], z [T, M, 1], bg [1, D], gimg [T, P, D],
// galpha, gdepth [T, P, 1] -> dmu, dcon, dop, dcol, dz of the input shapes.
// Every row is written; rows with op == 0 are skipped whole (all their
// terms are exactly 0) and written as zeros.
//
// What bounds it on the card: per pair and pixel two expf and two log1pf
// (one of each per sweep), ~60 FMAs and a division, plus the per-row
// reduction of 7 + D values over the tile's pixels. Device-memory traffic
// (the window read twice, its gradient written once) is small next to
// both.
//
// Design: one block per tile, 256 threads, ts*ts/256 pixels each; chunks of
// 128 rows staged in shared memory; per-row sums reduced in a FIXED order
// (own pixels, warp shuffle tree, the 8 warp partials summed in warp order
// by one thread per value), no float atomics, so runs repeat bit for bit.
#include "tilegrid_common.cuh"

namespace egogs {

// One row's value path at one pixel, shared by both sweeps: advances the
// log-transmittance prefix and the weighted-gradient prefix.
template <int D>
__device__ __forceinline__ void window_value(float alpha, const float* pr, float gz, float ga,
                                             const float* gi, float& logT, float& incl_wd,
                                             float& log1m, float& t_excl, float& w,
                                             float& dld) {
  log1m = log1pf(-alpha);
  logT = __fadd_rn(logT, log1m);
  t_excl = expf(__fsub_rn(logT, log1m));
  w = __fmul_rn(alpha, t_excl);
  dld = __fmaf_rn(pr[6 + D], gz, ga);
#pragma unroll
  for (int d = 0; d < D; ++d) dld = __fmaf_rn(pr[6 + d], gi[d], dld);
  incl_wd = __fmaf_rn(w, dld, incl_wd);
}

template <int D, int TS>
__global__ void __launch_bounds__(kThreads)
    window_bwd_kernel(const float* __restrict__ mu, const float* __restrict__ con,
                      const float* __restrict__ op_in, const float* __restrict__ col,
                      const float* __restrict__ z_in, const float* __restrict__ bg,
                      const float* __restrict__ gimg, const float* __restrict__ galpha,
                      const float* __restrict__ gdepth, float* __restrict__ dmu,
                      float* __restrict__ dcon, float* __restrict__ dop,
                      float* __restrict__ dcol, float* __restrict__ dz, int m, int n_tx) {
  constexpr int P = TS * TS;
  static_assert(P % kThreads == 0, "tile pixels must split evenly");
  constexpr int PPT = P / kThreads;
  constexpr int CH = 7 + D;
  extern __shared__ float smem[];
  float* blk = smem;                 // [kChunk][CH] staged rows
  float* part = smem + kChunk * CH;  // [kWarps][CH][kChunk] warp partials

  const int t = blockIdx.x;
  const int tx = t % n_tx;
  const int ty = t / n_tx;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row0 = static_cast<size_t>(t) * m;

  float px[PPT], py[PPT], gi[PPT][D], ga[PPT], gz[PPT], g_dot_bg[PPT];
  float logT[PPT], incl_wd[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * kThreads;
    const size_t idx = static_cast<size_t>(t) * P + pix;
    px[k] = static_cast<float>(tx * TS + pix % TS) + 0.5f;
    py[k] = static_cast<float>(ty * TS + pix / TS) + 0.5f;
    g_dot_bg[k] = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      gi[k][d] = gimg[idx * D + d];
      g_dot_bg[k] += gi[k][d] * bg[d];
    }
    ga[k] = galpha[idx];
    gz[k] = gdepth[idx];
    logT[k] = 0.0f;
    incl_wd[k] = 0.0f;
  }

  // pre-sweep: each pixel's total_wd and final log-transmittance
  for (int off = 0; off < m; off += kChunk) {
    const int n_rows = min(kChunk, m - off);
    __syncthreads();
    load_split_rows<D>(blk, mu, con, op_in, col, z_in, row0 + off, n_rows);
    __syncthreads();
    for (int j = 0; j < n_rows; ++j) {
      const float* pr = blk + j * CH;
      if (pr[5] == 0.0f) continue;  // masked row
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const PairAlpha r = pair_alpha(px[k], py[k], pr[0], pr[1], pr[2], pr[3], pr[4], pr[5]);
        if (r.alpha == 0.0f) continue;
        float log1m, t_excl, w, dld;
        window_value<D>(r.alpha, pr, gz[k], ga[k], gi[k], logT[k], incl_wd[k], log1m, t_excl,
                        w, dld);
      }
    }
  }
  float total_wd[PPT], base_S[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    total_wd[k] = incl_wd[k];
    base_S[k] = expf(logT[k]) * g_dot_bg[k];
    logT[k] = 0.0f;
    incl_wd[k] = 0.0f;
  }

  // gradient sweep
  for (int off = 0; off < m; off += kChunk) {
    const int n_rows = min(kChunk, m - off);
    __syncthreads();  // the previous chunk's readers of blk/part are done
    load_split_rows<D>(blk, mu, con, op_in, col, z_in, row0 + off, n_rows);
    __syncthreads();
    for (int j = 0; j < n_rows; ++j) {
      const float* pr = blk + j * CH;
      const float mx = pr[0], my = pr[1], a = pr[2], b = pr[3], cc = pr[4], op = pr[5];
      float s[CH];
#pragma unroll
      for (int v = 0; v < CH; ++v) s[v] = 0.0f;
      bool touched = false;
      if (op != 0.0f) {
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const PairAlpha r = pair_alpha(px[k], py[k], mx, my, a, b, cc, op);
          // alpha == 0: log1m == 0, w == 0, dalpha gated to 0: every term 0
          if (r.alpha == 0.0f) continue;
          touched = true;
          float log1m, t_excl, w, dld;
          window_value<D>(r.alpha, pr, gz[k], ga[k], gi[k], logT[k], incl_wd[k], log1m,
                          t_excl, w, dld);
          const float S = (total_wd[k] - incl_wd[k]) + base_S[k];
          const float one_minus = fmaxf(1.0f - r.alpha, 1e-6f);
          float dalpha = t_excl * dld - S / one_minus;
          if (!(r.raw >= kAlphaEps && r.raw < kAlphaMax)) dalpha = 0.0f;
          const float dpower = r.raw * dalpha;
          s[0] += (a * r.dx + b * r.dy) * dpower;
          s[1] += (cc * r.dy + b * r.dx) * dpower;
          s[2] += -0.5f * r.dx * r.dx * dpower;
          s[3] += -r.dx * r.dy * dpower;
          s[4] += -0.5f * r.dy * r.dy * dpower;
          s[5] += expf(r.power) * dalpha;
#pragma unroll
          for (int d = 0; d < D; ++d) s[6 + d] += w * gi[k][d];
          s[6 + D] += w * gz[k];
        }
      }
      if (__any_sync(0xffffffffu, touched)) {
#pragma unroll
        for (int v = 0; v < CH; ++v) s[v] = warp_sum(s[v]);
      }
      if (lane == 0) {
#pragma unroll
        for (int v = 0; v < CH; ++v) part[(warp * CH + v) * kChunk + j] = s[v];
      }
    }
    __syncthreads();

    // fixed-order sum of the warp partials, scattered to the five outputs
    for (int i = threadIdx.x; i < n_rows * CH; i += kThreads) {
      const int j = i / CH;
      const int v = i % CH;
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += part[(w * CH + v) * kChunk + j];
      const size_t r = row0 + off + j;
      if (v < 2) dmu[r * 2 + v] = acc;
      else if (v < 5) dcon[r * 3 + (v - 2)] = acc;
      else if (v == 5) dop[r] = acc;
      else if (v < 6 + D) dcol[r * D + (v - 6)] = acc;
      else dz[r] = acc;
    }
  }
}

template <int D, int TS>
int launch_window_bwd(const float* mu, const float* con, const float* op, const float* col,
                      const float* z, const float* bg, const float* gimg,
                      const float* galpha, const float* gdepth, float* dmu, float* dcon,
                      float* dop, float* dcol, float* dz, int n_tiles, int m, int n_tx,
                      cudaStream_t stream) {
  constexpr int smem = (kChunk * (7 + D) + kWarps * (7 + D) * kChunk) *
                       static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(window_bwd_kernel<D, TS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_bwd_kernel<D, TS><<<n_tiles, kThreads, smem, stream>>>(
      mu, con, op, col, z, bg, gimg, galpha, gdepth, dmu, dcon, dop, dcol, dz, m, n_tx);
  return static_cast<int>(cudaGetLastError());
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
  using namespace egogs;
  if (n_tiles == 0 || m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EGOGS_WBWD(D_, TS_)                                                       \
  if (d == D_ && ts == TS_)                                                       \
    return launch_window_bwd<D_, TS_>(mu, con, op, col, z, bg, gimg, galpha,      \
                                      gdepth, dmu, dcon, dop, dcol, dz, n_tiles, m, \
                                      n_tx, s);
  EGOGS_WBWD(3, 16)
  EGOGS_WBWD(3, 32)
  EGOGS_WBWD(1, 16)
  EGOGS_WBWD(1, 32)
#undef EGOGS_WBWD
  return -1;
}
