// Shared parts of the tile-grid pair (tilegrid_fwd.cu, tilegrid_bwd.cu),
// the log-space chunked pair that the chunked windowed and stream kernels
// run (chunked_pair.cuh) and the simple windowed pair (window_fwd.cu,
// window_bwd.cu):
// one thread-block cluster per tile, one pixel per thread, a warp per
// 8x4 pixel patch, a conservative reach box per pair, the tile-wide
// saturation vote across the cluster, and the chunk ring fed by bulk
// copies.
//
// Layout of a tile's pixels: a CTA of 256 threads owns a 16x16 quadrant
// (ts 32: four CTAs, cluster rank r owns quadrant (r % 2, r / 2); ts 16:
// one CTA, no cluster). Warp w of a CTA owns the 8x4 patch at
// ((w % 2) * 8, (w / 2) * 4) of its quadrant, lane l its pixel
// (l % 8, l / 8). A compact patch is what makes the per-pair cull and the
// per-warp skip of the gradient reduction fire: a pair's footprint misses
// most patches of a 32x32 tile.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "tilegrid_common.cuh"

namespace egogs {
namespace tg {

namespace cg = cooperative_groups;

constexpr int kQuad = 16;  // pixels on a side of one CTA's quadrant
constexpr int kPatchW = 8;
constexpr int kPatchH = 4;
constexpr int kWords = kChunk / 32;  // 32-bit mask words per chunk
static_assert(kQuad * kQuad == kThreads, "one pixel per thread");
static_assert(kPatchW * kPatchH == 32, "one pixel per lane");

template <int TS>
__host__ __device__ constexpr int ctas_per_tile() {
  return (TS / kQuad) * (TS / kQuad);
}

struct Pixel {
  int local;                         // index of the pixel in its tile (row-major)
  float px, py;                      // pixel center
  float x0, x1, y0, y1;              // the warp patch's pixel centers, extremes
};

template <int TS>
__device__ __forceinline__ Pixel pixel_of(int tile, int n_tx, int rank) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kAcross = TS / kQuad;
  const int wx = (rank % kAcross) * kQuad + (warp % (kQuad / kPatchW)) * kPatchW;
  const int wy = (rank / kAcross) * kQuad + (warp / (kQuad / kPatchW)) * kPatchH;
  const int lx = wx + lane % kPatchW, ly = wy + lane / kPatchW;
  const int ox = (tile % n_tx) * TS, oy = (tile / n_tx) * TS;
  Pixel p;
  p.local = ly * TS + lx;
  p.px = static_cast<float>(ox + lx) + 0.5f;
  p.py = static_cast<float>(oy + ly) + 0.5f;
  p.x0 = static_cast<float>(ox + wx) + 0.5f;
  p.x1 = p.x0 + static_cast<float>(kPatchW - 1);
  p.y0 = static_cast<float>(oy + wy) + 0.5f;
  p.y1 = p.y0 + static_cast<float>(kPatchH - 1);
  return p;
}

// Reach box (x_lo, x_hi, y_lo, y_hi) of one pair: at every pixel center
// outside it, pair_alpha returns alpha == 0 exactly. Why it is
// conservative:
//   * raw >= 1/255 needs q = a dx^2 + 2b dx dy + c dy^2 <= 2 ln(255 op).
//     tau adds 2e-3, so a pixel with computed q above tau has
//     raw <= e^-1e-3 / 255 * (1 + 2^-21) < 1.0f/255 (expf within 2 ulp).
//   * float32 evaluation of q (seven roundings) errs by at most
//     ~8 * 2^-24 * (a + c)|x|^2
//     (|M| <= trace for a positive definite conic). The box is that of
//     the deflated conic M - eta I, eta = 2^-18 (a + c), 8x that error,
//     so outside it even the computed q exceeds tau.
//   * det, the extents and the centre offset are taken in double: the
//     products of float inputs are exact there; 1/16 px more covers the
//     rounding of the float bounds.
//   * Anything non-finite, or a conic that is not positive definite after
//     deflation, gives the unbounded box (never culled); op below the
//     threshold gives the empty box (raw <= op < 1/255 everywhere).
__device__ __forceinline__ float4 reach_box(float mx, float my, float a, float b,
                                            float c, float op) {
  const float inf = __int_as_float(0x7f800000);
  const float4 all = make_float4(-inf, inf, -inf, inf);
  if (!(isfinite(mx) && isfinite(my) && isfinite(a) && isfinite(b) && isfinite(c) &&
        isfinite(op)))
    return all;
  const float4 none = make_float4(inf, -inf, inf, -inf);
  if (!(op > 0.0f)) return none;
  const double tau = 2.0 * static_cast<double>(logf(255.0f * op)) + 2e-3;
  if (tau < 0.0) return none;
  const double eta = (static_cast<double>(a) + static_cast<double>(c)) * 0x1p-18;
  const double A = static_cast<double>(a) - eta, C = static_cast<double>(c) - eta;
  const double B = static_cast<double>(b);
  const double det = A * C - B * B;
  if (!(A > 0.0 && C > 0.0 && det > 0.0)) return all;
  const double rx = sqrt(tau * C / det) + 0.0625, ry = sqrt(tau * A / det) + 0.0625;
  return make_float4(static_cast<float>(mx - rx), static_cast<float>(mx + rx),
                     static_cast<float>(my - ry), static_cast<float>(my + ry));
}

// Pairs of the staged chunk (rows mu_x, mu_y at 0, 128) the warp's patch
// may see, as kWords bit masks (bit j of word k: pair 32k + j). CULL =
// false keeps every pair below n_valid: the check instantiation that must
// give bit-identical results.
template <bool CULL>
__device__ __forceinline__ void patch_pairs(const float4* __restrict__ box, int n_valid,
                                            const Pixel& p, unsigned (&m)[kWords]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int j = k * 32 + lane;
    bool hit = j < n_valid;
    if (CULL && hit) {
      const float4 bx = box[j];
      // NaN bounds compare false: the pair is kept
      hit = !(bx.y < p.x0 || bx.x > p.x1 || bx.w < p.y0 || bx.z > p.y1);
    }
    m[k] = __ballot_sync(0xffffffffu, hit);
  }
}

// Walk the pairs of the warp's masks in order (REVERSE: last to first):
// step(j) for each; step returns whether it marked the pair (the
// backward's reduced pairs), and end_word(k, marks) gets each mask word's
// marks.
template <bool REVERSE = false, class StepF, class EndF>
__device__ __forceinline__ void walk_pairs(const unsigned (&m)[kWords], StepF step,
                                           EndF end_word) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int k = REVERSE ? kWords - 1 - i : i;
    unsigned bits = m[k], marks = 0;
    while (bits) {
      int bit;
      if constexpr (REVERSE) {
        bit = 31 - __clz(bits);
        bits ^= 1u << bit;
      } else {
        bit = __ffs(bits) - 1;
        bits &= bits - 1;
      }
      if (step(k * 32 + bit)) marks |= 1u << bit;
    }
    end_word(k, marks);
  }
}

// Sum of NV per-lane values over the warp in a fixed order: halving
// exchanges (each lane keeps one of two fields and sends the other) leave
// lane l with field l % NP (NP = NV rounded up to a power of two), then
// plain exchanges finish the sum. 12 shuffles at NV = 10 and 9 at NV = 8,
// against 5 * NV for one shuffle tree per field. Lane f < NV returns the
// warp's sum of field f.
template <int NV>
__device__ __forceinline__ float warp_sum_fields(const float (&v)[NV]) {
  const int lane = threadIdx.x & 31;
  constexpr int kMax = 16;
  static_assert(NV <= kMax, "at most 16 fields");
  float x[kMax];
#pragma unroll
  for (int i = 0; i < kMax; ++i) x[i] = i < NV ? v[i] : 0.0f;
  int n = NV;  // fields still held (compile-time after unrolling)
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (n > 1) {
      const bool up = (lane & off) != 0;
#pragma unroll
      for (int i = 0; i < kMax / 2; ++i) {
        if (2 * i < n) {
          const float lo = x[2 * i];
          const float hi = 2 * i + 1 < n ? x[2 * i + 1] : 0.0f;
          const float keep = up ? hi : lo;
          const float send = up ? lo : hi;
          x[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
      n = (n + 1) / 2;
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], off);
    }
  }
  return x[0];
}

// ---------------------------------------------------------------------------
// Bulk-copy chunk ring (two stages) and the cluster vote
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Chunks of a CTA stream through two shared-memory stages. Load number L
// (counted over the whole kernel, the same on every thread) lands in stage
// L % 2 and completes phase L / 2 of that stage's mbarrier. Stage L % 2 is
// refilled only after every thread has passed the barrier that ends its
// readers (the vote), so a barrier is never two phases ahead of a waiter.
struct Ring {
  float* stage[2];
  uint64_t* bar;  // [2]
  int bytes;
  int issued;     // loads issued so far

  __device__ __forceinline__ void init(float* s0, float* s1, uint64_t* b, int nbytes) {
    stage[0] = s0;
    stage[1] = s1;
    bar = b;
    bytes = nbytes;
    issued = 0;
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[0])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[1])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }

  // Every thread calls it (the count stays uniform); thread 0 copies the N
  // parts (source, byte offset in the stage, bytes: each a multiple of 16
  // bytes at 16-byte aligned addresses) onto the stage's barrier, which
  // expects their sum.
  template <int N>
  __device__ __forceinline__ void issue_parts(const float* const (&src)[N],
                                              const int (&off)[N], const int (&nbytes)[N]) {
    const int s = issued & 1;
    if (threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int i = 0; i < N; ++i) total += nbytes[i];
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                       smem_addr(&bar[s])),
                   "r"(total)
                   : "memory");
#pragma unroll
      for (int i = 0; i < N; ++i)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(smem_addr(stage[s]) + static_cast<uint32_t>(off[i])),
            "l"(src[i]), "r"(nbytes[i]), "r"(smem_addr(&bar[s]))
            : "memory");
    }
    ++issued;
  }

  // One whole stage (`bytes`) from src.
  __device__ __forceinline__ void issue(const float* src) {
    const float* const part[1] = {src};
    const int off[1] = {0}, nbytes[1] = {bytes};
    issue_parts<1>(part, off, nbytes);
  }

  // Wait for load L; a fault that keeps it from completing traps after
  // ~2^32 cycles instead of hanging the card.
  __device__ __forceinline__ void wait(int L) const {
    const uint32_t addr = smem_addr(&bar[L & 1]);
    const uint32_t parity = (L >> 1) & 1;
    const long long t0 = clock64();
    for (;;) {
      uint32_t done;
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(addr), "r"(parity) : "memory");
      if (done) break;
      if (clock64() - t0 > (1ll << 32)) __trap();
    }
  }
};

// The tile-wide saturation vote before a chunk: true while any pixel of
// the tile has T >= kSatSkipEps (the TPU kernel's rule). Each CTA reduces
// its quadrant with __syncthreads_or (also the barrier that ends the
// previous chunk's readers), writes its flag into slot `seq % 2` of every
// CTA of the cluster, and a cluster barrier makes all flags visible.
// Every CTA of a cluster casts the same number of votes.
template <int NCTA>
__device__ __forceinline__ bool tile_vote(bool live, unsigned* flags, int seq) {
  const int any = __syncthreads_or(live);
  if constexpr (NCTA == 1) {
    return any != 0;
  } else {
    cg::cluster_group cl = cg::this_cluster();
    const int slot = (seq & 1) * NCTA;
    if (threadIdx.x < NCTA) {
      unsigned* dst = cl.map_shared_rank(flags, static_cast<int>(threadIdx.x));
      dst[slot + static_cast<int>(cl.block_rank())] = static_cast<unsigned>(any);
    }
    cl.sync();
    unsigned all = 0;
#pragma unroll
    for (int r = 0; r < NCTA; ++r) all |= flags[slot + r];
    return all != 0;
  }
}

template <int NCTA>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (NCTA > 1) cg::this_cluster().sync();
}

// A barrier over every thread of the tile: the cluster's (which also
// orders shared-memory writes before other CTAs' reads of them), or the
// CTA's when the tile has one CTA.
template <int NCTA>
__device__ __forceinline__ void tile_sync() {
  if constexpr (NCTA > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Launch `kernel` with one cluster of NCTA CTAs per tile.
template <int NCTA, typename... KArgs, typename... Args>
cudaError_t launch_tiles(void (*kernel)(KArgs...), int n_tiles, int smem,
                         cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_tiles * NCTA));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NCTA;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = NCTA > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace tg
}  // namespace egogs
