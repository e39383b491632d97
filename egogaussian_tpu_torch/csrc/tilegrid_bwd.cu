// Tile-grid compositor, backward (forward-sweep form).
//
// Replaces: egogaussian_tpu/render/pallas_raster.py, _tilegrid_bwd_kernel
// with exact_total=False (built by make_tilegrid_compositor; its VJP).
//
// What it computes: one FORWARD sweep over each tile's chunks, replaying
// the forward's transmittance. The back-to-front weighted suffix
// S_i = sum_{j>i} w_j dL/dw_j is rewritten as total - inclusive prefix,
// with the per-pixel total rebuilt from the saved outputs:
//   T_total  = 1 - alpha_out
//   total    = sum_d (img_d - T_total*bg_d) gimg_d + depth*gdepth + alpha*galpha
//   S_i      = (total - prefix_i) + T_total * (gimg . bg)
//   dalpha_i = T_i dL/dw_i - S_i / (1 - alpha_i),  gated to eps <= raw < 0.99
// and emits, per pair, the 7 + D gradient rows (dmu_x, dmu_y, da, db, dc,
// dop, dcol x D, dz) reduced over the tile's pixels. Chunks skipped by the
// saturation rule write zeros, like the TPU kernel.
//
// What bounds it on the card: per pair and pixel ~50 FMAs and one expf,
// plus the per-pair reduction of 7 + D values over the tile's pixels,
// which costs more than the arithmetic when few pixels of a warp are
// covered. Device-memory traffic (pair chunk in, gradient chunk out) is
// small next to both.
//
// Design: the forward's block and pixel mapping (one block per tile, 256
// threads, ts*ts/256 pixels per thread, chunks staged in shared memory).
// Each pair's gradient values are reduced in a FIXED order: first over a
// thread's own pixels, then a warp shuffle tree, then the 8 per-warp
// partials land in shared memory and one thread per output value adds them
// in warp order. No float atomics, so runs repeat bit for bit. A warp in
// which no pixel sees the pair (alpha == 0 everywhere, so every term is an
// exact zero) skips the shuffles. The chunk-padded layout gives each tile
// its own slots, so no reduction crosses blocks.
#include "tilegrid_common.cuh"

namespace egogs {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int D, int TS>
__global__ void __launch_bounds__(kThreads)
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
  constexpr int P = TS * TS;
  static_assert(P % kThreads == 0, "tile pixels must split evenly");
  constexpr int PPT = P / kThreads;
  constexpr int CH = ch16_of(D);
  constexpr int NV = 7 + D;  // gradient rows per pair
  extern __shared__ __align__(16) float smem[];
  float* blk = smem;                // [CH][kChunk] staged pair chunk
  float* part = smem + CH * kChunk; // [kWarps][NV][kChunk] warp partials

  const int t = blockIdx.x;
  const int start = meta[t];
  const int cnt = meta[n_tiles + t];
  const int n_chunks = (cnt + kChunk - 1) / kChunk;
  const int tx = t % n_tx;
  const int ty = t / n_tx;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float bgv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) bgv[d] = bg[d];

  float px[PPT], py[PPT], T[PPT], pre[PPT], total[PPT], base_s[PPT];
  float gi[PPT][D], ga[PPT], gz[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = threadIdx.x + k * kThreads;
    const size_t idx = static_cast<size_t>(t) * P + pix;
    px[k] = static_cast<float>(tx * TS + pix % TS) + 0.5f;
    py[k] = static_cast<float>(ty * TS + pix / TS) + 0.5f;
    T[k] = 1.0f;
    pre[k] = 0.0f;
    const float a_out = alpha_out[idx];
    const float t_total = 1.0f - a_out;
    float g_dot_bg = 0.0f;
    float tot = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      gi[k][d] = gimg[idx * D + d];
      g_dot_bg += gi[k][d] * bgv[d];
      tot += (img[idx * D + d] - t_total * bgv[d]) * gi[k][d];
    }
    ga[k] = galpha[idx];
    gz[k] = gdepth[idx];
    total[k] = tot + depth_out[idx] * gz[k] + a_out * ga[k];
    base_s[k] = t_total * g_dot_bg;
  }

  int c = 0;
  for (; c < n_chunks; ++c) {
    // same tile-wide saturation test as the forward; also the barrier that
    // keeps the previous chunk's readers of blk/part ahead of this chunk
    bool live = false;
#pragma unroll
    for (int k = 0; k < PPT; ++k) live |= T[k] >= kSatSkipEps;
    if (!__syncthreads_or(live)) break;
    load_chunk(blk, vals + static_cast<size_t>(start + c) * CH * kChunk, CH * kChunk);
    __syncthreads();

    const int n_valid = min(kChunk, cnt - c * kChunk);
    for (int j = 0; j < n_valid; ++j) {
      const float mx = blk[0 * kChunk + j];
      const float my = blk[1 * kChunk + j];
      const float a = blk[2 * kChunk + j];
      const float b = blk[3 * kChunk + j];
      const float cc = blk[4 * kChunk + j];
      const float op = blk[5 * kChunk + j];
      float col[D];
#pragma unroll
      for (int d = 0; d < D; ++d) col[d] = blk[(6 + d) * kChunk + j];
      const float z = blk[(6 + D) * kChunk + j];

      float s[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) s[v] = 0.0f;
      bool touched = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const PairAlpha r = pair_alpha(px[k], py[k], mx, my, a, b, cc, op);
        // alpha == 0 leaves T and the prefix unchanged and every term zero
        if (r.alpha == 0.0f) continue;
        touched = true;
        const float t_excl = T[k];
        const float w = r.alpha * t_excl;
        float dld = z * gz[k] + ga[k];
#pragma unroll
        for (int d = 0; d < D; ++d) dld += col[d] * gi[k][d];
        pre[k] += w * dld;
        const float S = (total[k] - pre[k]) + base_s[k];
        const float one_minus = 1.0f - r.alpha;
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
        T[k] *= one_minus;
      }
      if (__any_sync(0xffffffffu, touched)) {
#pragma unroll
        for (int v = 0; v < NV; ++v) s[v] = warp_sum(s[v]);
      }
      if (lane == 0) {
#pragma unroll
        for (int v = 0; v < NV; ++v) part[(warp * NV + v) * kChunk + j] = s[v];
      }
    }
    __syncthreads();

    // fixed-order sum of the warp partials; lanes past the tile's count and
    // the padding rows are zeros
    float* out = dvals + static_cast<size_t>(start + c) * CH * kChunk;
    for (int i = threadIdx.x; i < CH * kChunk; i += kThreads) {
      const int v = i / kChunk;
      const int j = i % kChunk;
      float acc = 0.0f;
      if (v < NV && j < n_valid) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += part[(w * NV + v) * kChunk + j];
      }
      out[i] = acc;
    }
  }
  // chunks behind a saturated tile were skipped: their gradients are zeros
  for (; c < n_chunks; ++c) {
    float* out = dvals + static_cast<size_t>(start + c) * CH * kChunk;
    for (int i = threadIdx.x; i < CH * kChunk; i += kThreads) out[i] = 0.0f;
  }
}

template <int D, int TS>
int launch_bwd(const int* meta, const float* vals, const float* bg,
               const float* img, const float* alpha, const float* depth,
               const float* gimg, const float* galpha, const float* gdepth,
               float* dvals, int n_tiles, int n_tx, cudaStream_t stream) {
  constexpr int smem =
      (ch16_of(D) * kChunk + kWarps * (7 + D) * kChunk) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      tilegrid_bwd_kernel<D, TS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tilegrid_bwd_kernel<D, TS><<<n_tiles, kThreads, smem, stream>>>(
      meta, vals, bg, img, alpha, depth, gimg, galpha, gdepth, dvals, n_tiles, n_tx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// (d, ts) the library was not built for. Writes only the chunk slots of the
// tiles in meta; the caller zeroes the rest.
extern "C" int egogs_tilegrid_bwd(const int* meta, const float* vals,
                                  const float* bg, const float* img,
                                  const float* alpha, const float* depth,
                                  const float* gimg, const float* galpha,
                                  const float* gdepth, float* dvals,
                                  int n_tiles, int n_tx, int ts, int d,
                                  void* stream) {
  using namespace egogs;
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EGOGS_BWD(D_, TS_)                                                   \
  if (d == D_ && ts == TS_)                                                  \
    return launch_bwd<D_, TS_>(meta, vals, bg, img, alpha, depth, gimg,      \
                               galpha, gdepth, dvals, n_tiles, n_tx, s);
  EGOGS_BWD(3, 16)
  EGOGS_BWD(3, 32)
  EGOGS_BWD(1, 16)
  EGOGS_BWD(1, 32)
#undef EGOGS_BWD
  return -1;
}
