// The simple windowed pair's chunk source (window_fwd.cu, window_bwd.cu):
// each tile's window as five separate field arrays, mu [T, M, 2], con
// [T, M, 3], op [T, M, 1] (0 on masked rows), col [T, M, D] and z
// [T, M, 1], M any size, walked in 128-row chunks.
//
// Why the pair does not run chunked_pair.cuh's bodies: those stage a chunk
// as one row-major [128][7 + D] block by one bulk copy and index it as
// such. Here a chunk is five contiguous pieces, one per field array, so a
// staged chunk is five segments (field-major within the chunk, below), its
// tail chunk is short when M % 128 != 0, and bulk copies cannot be used at
// all when M % 4 != 0 (a piece of a field array then starts off a 16-byte
// boundary). Fitting them would put a staging hook, a field accessor and
// a live-chunk walk into the body that rows 4-7 run; and the backward
// could not share that pair's body anyway (two forward sweeps against its
// one reverse sweep from a saved log T, which this pair does not save).
//
// A staged chunk (ring stage, 128 * (7 + D) floats) is field-major:
//   mu [128][2] | con [128][3] | op [128] | col [128][D] | z [128]
// which is what one bulk copy per field array lands. Rows past a short
// tail chunk's end hold stale values and are never read. Before the walk,
// thread j repacks row j row-major (Row, pack_chunk): read in place, the
// field-major chunk took nine 4- or 8-byte loads per row and pixel where
// a packed row takes two or three 16-byte ones.
//
// Staging: with M % 4 == 0 and every field array 16-byte aligned (`bulk`),
// each chunk arrives by five bulk copies onto one ring barrier, whose byte
// counts (1,024 / 1,536 / 512 / 512 D / 512 for a full chunk, n / 128 of
// that for a tail of n rows) sum to what it expects; otherwise every
// thread stages the chunk with plain loads, after the barrier that ends
// the stage's readers.
//
// Live chunks: a chunk whose 128 op values are all 0 changes nothing (a
// row with op == 0 has alpha 0 at every pixel: log1m, w and every gradient
// term are exactly 0), so it is skipped whole after its op column alone is
// read: each CTA scans the op column of its tile into a mask of live
// chunks first. In the windows the port builds the masked rows are each
// tile's suffix, so most of the window is skipped. Chunks past the mask's
// reach (kMaskChunks) are walked; walking a masked chunk gives the same
// bits, so that is exact too.
#pragma once

#include "tilegrid_cluster.cuh"

namespace egogs {
namespace ws {

constexpr int kFields = 5;       // mu, con, op, col, z
constexpr int kMaskWords = 32;   // live-chunk mask words
constexpr int kMaskChunks = kMaskWords * 32;

// Width of field array s and the start of its segment in a staged chunk.
template <int D>
__host__ __device__ constexpr int width(int s) {
  return s == 0 ? 2 : s == 1 ? 3 : s == 3 ? D : 1;
}
template <int D>
__host__ __device__ constexpr int seg(int s) {
  return (s == 0 ? 0 : s == 1 ? 2 : s == 2 ? 5 : s == 3 ? 6 : 6 + D) * kChunk;
}

// Position in a staged chunk of value v of row j (v: mu_x, mu_y, a, b, c,
// op, col x D, z); constant-folded where v is.
template <int D>
__device__ __forceinline__ int at(int j, int v) {
  return v < 2 ? 2 * j + v
         : v < 5 ? seg<D>(1) + 3 * j + (v - 2)
         : v == 5 ? seg<D>(2) + j
         : v < 6 + D ? seg<D>(3) + D * j + (v - 6)
         : seg<D>(4) + j;
}

// Floats of a packed row (mu_x, mu_y, a, b, c, op, col x D, z, zero
// padding to a multiple of four).
template <int D>
__host__ __device__ constexpr int row_width() {
  return (7 + D + 3) / 4 * 4;
}

// Row j of a staged chunk, packed: its fields read from the chunk's
// segments (v), written row-major at rows + j * row_width by 16-byte
// stores. A warp walking the packed rows reads a row by 16-byte broadcast
// loads: two for the eight fields that alpha needs (every field at
// D = 1), one more for the rest at D = 3.
template <int D>
struct Row {
  static constexpr int W = row_width<D>();
  float v[W];

  __device__ __forceinline__ void unpack(const float* blk, int j) {
#pragma unroll
    for (int q = 0; q < W; ++q) v[q] = q < 7 + D ? blk[at<D>(j, q)] : 0.0f;
  }
  __device__ __forceinline__ void store(float* rows, int j) const {
    float4* dst = reinterpret_cast<float4*>(rows + j * W);
#pragma unroll
    for (int q = 0; q < W / 4; ++q)
      dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  // fields 0-7 of packed row j
  __device__ __forceinline__ void head(const float* rows, int j) { load(rows, j, 0, 2); }
  // the rest
  __device__ __forceinline__ void tail(const float* rows, int j) { load(rows, j, 2, W / 4); }

 private:
  __device__ __forceinline__ void load(const float* rows, int j, int q0, int q1) {
    const float4* src = reinterpret_cast<const float4*>(rows + j * W);
#pragma unroll
    for (int q = q0; q < q1; ++q) {
      const float4 x = src[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  }
};

// First live chunk after c (of n), or n.
__device__ __forceinline__ int next_live(const unsigned* mask, int c, int n) {
  for (int k = c + 1; k < n;) {
    if (k >= kMaskChunks) return k;
    const unsigned w = mask[k >> 5] >> (k & 31);
    if (w) return k + __ffs(w) - 1;
    k = (k | 31) + 1;
  }
  return n;
}

__device__ __forceinline__ bool is_live(const unsigned* mask, int c) {
  return c >= kMaskChunks || ((mask[c >> 5] >> (c & 31)) & 1u);
}

// The five field arrays of a window (inputs, or the backward's gradients
// of the same shapes).
template <int D, class F>
struct Split {
  F* f[kFields];
  int m;      // rows per tile
  bool bulk;  // M % 4 == 0 and every array 16-byte aligned: chunks by bulk copy

  __device__ __forceinline__ int n_chunks() const { return (m + kChunk - 1) / kChunk; }
  __device__ __forceinline__ int rows(int c) const { return min(kChunk, m - c * kChunk); }
  __device__ __forceinline__ size_t row0(int t, int c) const {
    return static_cast<size_t>(t) * m + static_cast<size_t>(c) * kChunk;
  }

  // fn(s, k, p) for each position k of field s's segment of chunk c of
  // tile t that holds a row (k < rows(c) * width), p its element in the
  // field array; each segment split into `parts` equal shares, of which
  // this call takes share `part`. Every thread calls it.
  template <class Fn>
  __device__ __forceinline__ void visit(int t, int c, int part, int parts, Fn fn) const {
#pragma unroll
    for (int s = 0; s < kFields; ++s) {
      const int w = width<D>(s), share = kChunk * w / parts;
      const int hi = min((part + 1) * share, rows(c) * w);
      F* base = f[s] + row0(t, c) * w;
      for (int k = part * share + static_cast<int>(threadIdx.x); k < hi; k += kThreads)
        fn(s, k, base + k);
    }
  }

  // The live-chunk mask of tile t (every thread calls it; two barriers):
  // chunk c by warp c % kWarps, its op column read once.
  __device__ __forceinline__ void scan_live(int t, unsigned* mask) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x < kMaskWords) mask[threadIdx.x] = 0u;
    __syncthreads();
    const int n = min(n_chunks(), kMaskChunks);
    for (int c = warp; c < n; c += kWarps) {
      const F* op = f[2] + row0(t, c);
      const int nr = rows(c);
      bool live = false;
#pragma unroll
      for (int k = 0; k < kChunk / 32; ++k) {
        const int r = lane + 32 * k;
        live |= r < nr && __ldg(op + r) != 0.0f;
      }
      if (__any_sync(0xffffffffu, live) && lane == 0) atomicOr(&mask[c >> 5], 1u << (c & 31));
    }
    __syncthreads();
  }

  // Chunk c of tile t into the ring's next stage (bulk only; every thread
  // calls it).
  __device__ __forceinline__ void issue(tg::Ring& ring, int t, int c) const {
    if (!bulk) return;
    const float* src[kFields];
    int off[kFields], nbytes[kFields];
#pragma unroll
    for (int s = 0; s < kFields; ++s) {
      src[s] = f[s] + row0(t, c) * width<D>(s);
      off[s] = seg<D>(s) * 4;
      nbytes[s] = rows(c) * width<D>(s) * 4;
    }
    ring.issue_parts<kFields>(src, off, nbytes);
  }

  // Chunk c of tile t staged as load L: waits for its bulk copies, or
  // stages it with plain loads (the stage's readers must be done: the
  // caller's barrier). Every thread calls it.
  __device__ __forceinline__ const float* ready(const tg::Ring& ring, int L, int t,
                                                int c) const {
    float* blk = ring.stage[L & 1];
    if (bulk) {
      ring.wait(L);
      return blk;
    }
    visit(t, c, 0, 1, [&](int s, int k, const F* p) { blk[seg<D>(s) + k] = *p; });
    __syncthreads();
    return blk;
  }
};

// After a chunk is staged (blk, n_valid rows): thread j < n_valid packs
// row j into `rows` and, with CULL, writes its reach box. The caller's
// barrier follows.
template <int D, bool CULL>
__device__ __forceinline__ void pack_chunk(const float* blk, int n_valid, float* rows,
                                           float4* box) {
  const int j = threadIdx.x;
  if (j >= n_valid) return;
  Row<D> r;
  r.unpack(blk, j);
  r.store(rows, j);
  if (CULL) box[j] = tg::reach_box(r.v[0], r.v[1], r.v[2], r.v[3], r.v[4], r.v[5]);
}

}  // namespace ws
}  // namespace egogs
