// The pair gather of the chunk-padded and windowed layouts, and its
// backward.
//
// Replaces: no Pallas kernel. The JAX package gathers the pair rows with
// XLA (egogaussian_tpu/render/tiled.py, composite_pallas: vals =
// packed[g_sorted[p_q]]; bin_gaussians' tile_gather for the window) and
// leaves the gradient to XLA's scatter-add. The port did the same with
// `rows[src]`, whose backward (PyTorch's index backward) sorts the slots'
// row indices and then sums each run of equal indices serially in one
// warp. Every slot past the last tile's run is clamped to one pair, so a
// third of the slots name one Gaussian row and that warp walks a million
// or more dependent loads: ~43 ms of a ~64 ms training step at 1600x900
// with 500k Gaussians, adding up zeros.
//
// What it computes:
//   gather: out[q] = rows[src[q]] for every slot q, written straight into
//     the layout: transposed chunks [n_slots / 128, ch, 128] (the tile-grid
//     layout) or rows [n_slots, ch] (the stream and window layouts).
//   reduce: drows[s * n + order[s, g]] = the sum, over Gaussian g's pairs
//     p in [offsets[s, g], offsets[s, g] + counts[s, g]) (cut at mp) whose
//     slot pair_slot[s, p] is >= 0, of dvals[pair_slot[s, p]], in
//     increasing p, from 0. A Gaussian's pairs come out of the binning in
//     increasing tile id, so in increasing slot: the order in which
//     PyTorch's index backward sums a row (its radix sort is stable, its
//     sum serial). The slots it leaves out (padding, the clamped tail,
//     tiles that overflowed or were cut at max_per_tile) hold exact zeros
//     of the compositor backward, so the two sums agree bit for bit up to
//     the sign of a zero. No float atomics, no sort.
//
// What bounds it on the card: bytes. gather writes n_slots * ch floats and
// reads the src column and each row (rows stay in L2); reduce reads the
// pair slots (8 bytes a pair), three int64 per Gaussian, ch floats per
// laid-out pair and writes ch floats per Gaussian.
//
// Design: one thread per output float in both. gather's threads walk the
// output in memory order, so the writes coalesce; a row is re-read by the
// ch threads of its slot from L1/L2. reduce gives one group of ch threads
// to each Gaussian (thread = field); the group alone writes its row, once.
// Its loop issues the pair slots and the dvals loads of UNROLL pairs before
// adding them in order, so a Gaussian over many tiles keeps several loads
// in flight. Groups run in depth order, and a tile's run is in depth
// order, so concurrent groups touch each tile's run near one frontier:
// the transposed layout's 512-byte field stride costs L2 hits, not DRAM
// reads.
#include <cuda_runtime.h>

namespace egogs {

constexpr int GATHER_THREADS = 256;
constexpr int REDUCE_THREADS = 256;
constexpr int UNROLL = 8;
constexpr int CHUNK = 128;

__device__ __forceinline__ long long field_addr(long long q, int f, int ch, bool transposed) {
  return transposed ? (q / CHUNK) * ch * CHUNK + (long long)f * CHUNK + (q % CHUNK)
                    : q * ch + f;
}

template <bool TRANSPOSED>
__global__ void __launch_bounds__(GATHER_THREADS)
    pair_gather_kernel(const float* __restrict__ rows, const long long* __restrict__ src,
                       float* __restrict__ out, long long n_out, int ch) {
  const long long j = (long long)blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (j >= n_out) return;
  long long q;
  int f;
  if (TRANSPOSED) {
    const long long per_chunk = (long long)ch * CHUNK;
    const long long c = j / per_chunk;
    const int r = (int)(j - c * per_chunk);
    f = r / CHUNK;
    q = c * CHUNK + (r % CHUNK);
  } else {
    q = j / ch;
    f = (int)(j - q * ch);
  }
  out[j] = rows[src[q] * ch + f];
}

template <bool TRANSPOSED>
__global__ void __launch_bounds__(REDUCE_THREADS)
    pair_reduce_kernel(const float* __restrict__ dvals, const long long* __restrict__ pair_slot,
                       const long long* __restrict__ offsets,
                       const long long* __restrict__ counts,
                       const long long* __restrict__ order, float* __restrict__ drows,
                       long long n_threads, int n, int mp, int ch) {
  const long long j = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (j >= n_threads) return;
  const long long i = j / ch;  // Gaussian s * n + g
  const int f = (int)(j - i * ch);
  const long long s = i / n;
  const long long* slots = pair_slot + s * mp;
  long long p = offsets[i];
  const long long end = min(p + counts[i], (long long)mp);
  float acc = 0.0f;
  for (; p + UNROLL <= end; p += UNROLL) {
    long long q[UNROLL];
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) q[u] = slots[p + u];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      v[u] = q[u] >= 0 ? dvals[field_addr(q[u], f, ch, TRANSPOSED)] : 0.0f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (q[u] >= 0) acc += v[u];
  }
  for (; p < end; ++p) {
    const long long q = slots[p];
    if (q >= 0) acc += dvals[field_addr(q, f, ch, TRANSPOSED)];
  }
  drows[(s * n + order[i]) * ch + f] = acc;
}

}  // namespace egogs

// out [n_slots * ch] from rows [*, ch] at src [n_slots]; transposed != 0
// writes [n_slots / 128, ch, 128] (n_slots a multiple of 128). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int egogs_pair_gather(const float* rows, const long long* src, float* out,
                                 long long n_slots, int ch, int transposed, void* stream) {
  using namespace egogs;
  const long long n_out = n_slots * ch;
  if (n_out == 0) return 0;
  const unsigned blocks = (unsigned)((n_out + GATHER_THREADS - 1) / GATHER_THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (transposed)
    pair_gather_kernel<true><<<blocks, GATHER_THREADS, 0, st>>>(rows, src, out, n_out, ch);
  else
    pair_gather_kernel<false><<<blocks, GATHER_THREADS, 0, st>>>(rows, src, out, n_out, ch);
  return static_cast<int>(cudaGetLastError());
}

// drows [s_n * n, ch], every row written once, from dvals (the gather's
// output layout) over pair_slot [s_n, mp] and offsets, counts, order
// [s_n, n]. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int egogs_pair_reduce(const float* dvals, const long long* pair_slot,
                                 const long long* offsets, const long long* counts,
                                 const long long* order, float* drows, int s_n, int n, int mp,
                                 int ch, int transposed, void* stream) {
  using namespace egogs;
  const long long n_threads = (long long)s_n * n * ch;
  if (n_threads == 0) return 0;
  const unsigned blocks = (unsigned)((n_threads + REDUCE_THREADS - 1) / REDUCE_THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (transposed)
    pair_reduce_kernel<true><<<blocks, REDUCE_THREADS, 0, st>>>(
        dvals, pair_slot, offsets, counts, order, drows, n_threads, n, mp, ch);
  else
    pair_reduce_kernel<false><<<blocks, REDUCE_THREADS, 0, st>>>(
        dvals, pair_slot, offsets, counts, order, drows, n_threads, n, mp, ch);
  return static_cast<int>(cudaGetLastError());
}
