// Float32 FMA-peak probe.
//
// Replaces: bench.py, `kern` in _vpu_peak_gflops (:273, its pallas_call
// :280): the empirical float32 peak that the JAX bench measures the
// compositor's compute utilization against.
//
// What it computes: x [rows, 128] float32, each element stepped n_loop
// times by x = fmaf(x, 1.0000001f, 1e-9f), the TPU kernel's body
// x * 1.0000001 + 1e-9 as one fused multiply-add. Reported as GFLOP/s with
// FMA = 2 flops, as the TPU bench does.
//
// What bounds it on the card: float32 FMA issue only (132 SMs x 128 lanes
// x the clock; 33.5e12 instructions/s at the datasheet's 1.98 GHz); each
// element moves 8 bytes against n_loop FMAs.
//
// Design: one thread per element, one 128-thread block per row, each
// thread one dependent chain. rows = 256 was one TPU core's VMEM block;
// the wrapper's default instead fills every SM with resident threads
// (SMs x 2,048 / 128 rows: 2,112 on an H100 SXM), so each of an SM's four
// schedulers holds 16 warps of chains, four times the FMA's ~4-cycle
// dependent latency, without relying on instruction-level parallelism
// inside a chain. The chain runs in fully unrolled blocks of UNROLL steps:
// the loop's counter, compare and branch (3 instructions) then take
// 3 / (UNROLL + 3) = 1.2% of the issue slots, not the 16% of a 16-step
// unroll; a remainder loop takes n_loop % UNROLL.
#include <cuda_runtime.h>

namespace egogs {

constexpr int UNROLL = 256;

__global__ void __launch_bounds__(128) fma_chain_kernel(const float* __restrict__ x,
                                                        float* __restrict__ out, int n,
                                                        int n_loop) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  int k = 0;
  for (; k + UNROLL <= n_loop; k += UNROLL) {
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) v = __fmaf_rn(v, 1.0000001f, 1e-9f);
  }
#pragma unroll 1
  for (; k < n_loop; ++k) v = __fmaf_rn(v, 1.0000001f, 1e-9f);
  out[i] = v;
}

}  // namespace egogs

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int egogs_fma_chain(const float* x, float* out, int n, int n_loop, void* stream) {
  if (n == 0) return 0;
  egogs::fma_chain_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, n_loop);
  return static_cast<int>(cudaGetLastError());
}
