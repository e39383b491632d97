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
// What bounds it on the card: per pair and pixel one expf, one log1pf,
// ~50 FMAs and a division, plus the per-row reduction of 7 + D values over
// the tile's pixels. Device-memory traffic (the window read once, the
// gradient window written once) is small next to both.
//
// Design: the TPU kernel's grid step per tile becomes one block per tile
// (256 threads, ts*ts/256 pixels each); its reversed fori_loop over chunks
// is a loop in the block with the suffix state in registers. Each chunk is
// staged in shared memory; each row's gradient values are reduced in a
// FIXED order (own pixels, warp shuffle tree, the 8 warp partials summed in
// warp order by one thread per value), with no float atomics, so runs
// repeat bit for bit. Each tile's window is its own, so no reduction
// crosses blocks.
#include "tilegrid_common.cuh"

namespace egogs {

template <int D, int TS>
__global__ void __launch_bounds__(kThreads)
    window_chunked_bwd_kernel(const int* __restrict__ counts,
                              const float* __restrict__ data,
                              const float* __restrict__ bg,
                              const float* __restrict__ logt,
                              const float* __restrict__ gimg,
                              const float* __restrict__ galpha,
                              const float* __restrict__ gdepth,
                              float* __restrict__ ddata, int m, int n_tx) {
  constexpr int P = TS * TS;
  static_assert(P % kThreads == 0, "tile pixels must split evenly");
  constexpr int PPT = P / kThreads;
  constexpr int CH = 7 + D;  // fields per row == gradient values per row
  extern __shared__ __align__(16) float smem[];
  float* blk = smem;                 // [kChunk][CH] staged window chunk
  float* part = smem + kChunk * CH;  // [kWarps][CH][kChunk] warp partials

  const int t = blockIdx.x;
  const int cnt = min(max(counts[t], 0), m);
  const int n_chunks = (cnt + kChunk - 1) / kChunk;
  const float* window = data + static_cast<size_t>(t) * m * CH;
  float* dwindow = ddata + static_cast<size_t>(t) * m * CH;
  const int tx = t % n_tx;
  const int ty = t / n_tx;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // rows past the tile's last chunk: zero gradient
  for (int i = n_chunks * kChunk * CH + threadIdx.x; i < m * CH; i += kThreads)
    dwindow[i] = 0.0f;

  float px[PPT], py[PPT], logT_total[PPT], base_S[PPT], suf_log[PPT], suf_S[PPT];
  float gi[PPT][D], ga[PPT], gz[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * kThreads;
    const size_t idx = static_cast<size_t>(t) * P + pix;
    px[k] = static_cast<float>(tx * TS + pix % TS) + 0.5f;
    py[k] = static_cast<float>(ty * TS + pix / TS) + 0.5f;
    logT_total[k] = logt[idx];
    float g_dot_bg = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      gi[k][d] = gimg[idx * D + d];
      g_dot_bg += gi[k][d] * bg[d];
    }
    ga[k] = galpha[idx];
    gz[k] = gdepth[idx];
    base_S[k] = expf(logT_total[k]) * g_dot_bg;
    suf_log[k] = 0.0f;
    suf_S[k] = 0.0f;
  }

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int off = c * kChunk;
    const int n_valid = min(kChunk, cnt - off);  // rows past the count: op = 0
    __syncthreads();  // the previous chunk's readers of blk/part are done
    load_chunk(blk, window + static_cast<size_t>(off) * CH, kChunk * CH);
    __syncthreads();

    float ls[PPT], lS[PPT];  // in-chunk suffix sums of log1m and wd
#pragma unroll
    for (int k = 0; k < PPT; ++k) ls[k] = lS[k] = 0.0f;
    for (int j = n_valid - 1; j >= 0; --j) {
      const float* pr = blk + j * CH;
      const float mx = pr[0], my = pr[1], a = pr[2], b = pr[3], cc = pr[4], op = pr[5];
      const float z = pr[6 + D];
      float s[CH];
#pragma unroll
      for (int v = 0; v < CH; ++v) s[v] = 0.0f;
      bool touched = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const PairAlpha r = pair_alpha(px[k], py[k], mx, my, a, b, cc, op);
        // alpha == 0: log1m == 0, w == 0, dalpha gated to 0: every term zero
        if (r.alpha == 0.0f) continue;
        touched = true;
        const float log1m = log1pf(-r.alpha);
        ls[k] += log1m;
        const float U = ls[k] + suf_log[k];
        const float t_excl = expf(logT_total[k] - U);
        const float w = r.alpha * t_excl;
        float dld = z * gz[k] + ga[k];
#pragma unroll
        for (int d = 0; d < D; ++d) dld += pr[6 + d] * gi[k][d];
        const float wd = w * dld;
        lS[k] += wd;
        const float S = ((lS[k] - wd) + suf_S[k]) + base_S[k];
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
      if (__any_sync(0xffffffffu, touched)) {
#pragma unroll
        for (int v = 0; v < CH; ++v) s[v] = warp_sum(s[v]);
      }
      if (lane == 0) {
#pragma unroll
        for (int v = 0; v < CH; ++v) part[(warp * CH + v) * kChunk + j] = s[v];
      }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      suf_log[k] += ls[k];
      suf_S[k] += lS[k];
    }
    __syncthreads();

    // fixed-order sum of the warp partials into the row-major chunk; rows
    // at or past the tile's count are zeros
    float* out = dwindow + static_cast<size_t>(off) * CH;
    for (int i = threadIdx.x; i < kChunk * CH; i += kThreads) {
      const int j = i / CH;
      const int v = i % CH;
      float acc = 0.0f;
      if (j < n_valid) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += part[(w * CH + v) * kChunk + j];
      }
      out[i] = acc;
    }
  }
}

template <int D, int TS>
int launch_window_chunked_bwd(const int* counts, const float* data, const float* bg,
                              const float* logt, const float* gimg, const float* galpha,
                              const float* gdepth, float* ddata, int n_tiles, int m,
                              int n_tx, cudaStream_t stream) {
  constexpr int smem = (kChunk * (7 + D) + kWarps * (7 + D) * kChunk) *
                       static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(window_chunked_bwd_kernel<D, TS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_chunked_bwd_kernel<D, TS><<<n_tiles, kThreads, smem, stream>>>(
      counts, data, bg, logt, gimg, galpha, gdepth, ddata, m, n_tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes every row of ddata.
extern "C" int egogs_window_chunked_bwd(const int* counts, const float* data,
                                        const float* bg, const float* logt,
                                        const float* gimg, const float* galpha,
                                        const float* gdepth, float* ddata, int n_tiles,
                                        int m, int n_tx, int ts, int d, void* stream) {
  using namespace egogs;
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EGOGS_WCBWD(D_, TS_)                                                    \
  if (d == D_ && ts == TS_)                                                     \
    return launch_window_chunked_bwd<D_, TS_>(counts, data, bg, logt, gimg,     \
                                              galpha, gdepth, ddata, n_tiles, m, \
                                              n_tx, s);
  EGOGS_WCBWD(3, 16)
  EGOGS_WCBWD(3, 32)
  EGOGS_WCBWD(1, 16)
  EGOGS_WCBWD(1, 32)
#undef EGOGS_WCBWD
  return -1;
}
