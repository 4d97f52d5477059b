// Tau Gibbs sweep over all strains with each cell's candidate logs taken at
// its at most two observed bases, one warp per position.
//
// Replaces desman_tpu/ops/tau_topk.py::_kernel (reached through
// _sweep_topk's pallas_call), the JAX package's observed-base-compressed tau
// sweep. It is exact only on counts whose every (v, s) cell observes at most
// two bases; the wrapper's layout (ops/tau_topk.py) refuses other counts.
// The function is desman::tau_position_terms (position.cuh) with the
// TwoBases terms: the tau kernel's sweep, the same lane stride over samples
// and the same warp_sum butterfly, so on such counts it is bitwise equal to
// the tau kernel (tau_kernel.cu) on the same inputs.
//
// What bounds it on an H100: the logs, as in the tau kernel, but half of
// them: 8 per (v, s, g) instead of 16 (41 M a sweep at V=1e4, S=64, G=8).
// The counts come as n_val [V,S,2] f32 and b_idx [V,S,2] i32, one 8-byte
// float2 and one int2 load per (v, s), the same 16 bytes as the tau kernel's
// float4 of n; the mixture is still read and written as [V,S,4], since the
// rest mixture at the two selected bases needs all four of its entries.
//
// Design: a lane evaluates the two slots in ascending base order, each term
// with the tau kernel's own expression (q[b] by the same multiply-add chain,
// then n * log(max(q[b] + gamma[s,g] * eta[c,b], 1e-12))). nvcc contracts
// `acc += n * log(...)` into fma, so the order of the terms decides the
// rounding: in base order the nonzero terms meet in the same fma chain as in
// the tau kernel, whose zero-count terms each add an exact zero. Slot order
// by count, as the JAX package keeps it, would round differently. No
// --use_fast_math: logf stays the IEEE logf. No atomics, no shared memory:
// a sweep is bitwise the same from run to run.
#include <cuda_runtime.h>

#include "position.cuh"

namespace desman {
namespace {

// mix_in and mix_out are not __restrict__: from the second strain on, the
// kernel reads back the row it wrote to mix_out.
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
tau_topk_kernel(const float2* __restrict__ n_val, const int2* __restrict__ b_idx,
                const int* __restrict__ tau_in, const float4* mix_in,
                const float* __restrict__ gamma, const float* __restrict__ eta,
                const float4* __restrict__ gz, int* __restrict__ tau_out, float4* mix_out,
                int V, int S, int G) {
  const long v = warp_position(V);
  if (v < 0) return;
  float e[4][4];
  load_eta(eta, e);
  tau_position_terms(TwoBases{n_val + v * S, b_idx + v * S}, tau_in, mix_in + v * S,
                     GammaSG{gamma, G}, e, gz, tau_out, mix_out + v * S, v, S, G, threadIdx.x % kWarp);
}

}  // namespace
}  // namespace desman

// n_val: [V,S,2] f32 slot counts; b_idx: [V,S,2] i32 slot bases in ascending
// order (unused slot: count 0, base 0); mix_in, mix_out: [V,S,4] f32;
// tau_in, tau_out: [V,G] i32; gamma: [S,G] f32; eta: [4,4] f32; gz: [V,G,4]
// f32 (already * temperature). Launches on `stream`, does not synchronise,
// allocates nothing; returns the launch's cudaError_t.
extern "C" int desman_tau_sweep_topk(const void* n_val, const void* b_idx, const void* tau_in,
                                     const void* mix_in, const void* gamma, const void* eta,
                                     const void* gz, void* tau_out, void* mix_out, int V,
                                     int S, int G, void* stream) {
  if (V <= 0) return static_cast<int>(cudaSuccess);
  desman::tau_topk_kernel<<<desman::launch_blocks(V), desman::kWarpsPerBlock * desman::kWarp,
                            0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(n_val), static_cast<const int2*>(b_idx),
      static_cast<const int*>(tau_in), static_cast<const float4*>(mix_in),
      static_cast<const float*>(gamma), static_cast<const float*>(eta),
      static_cast<const float4*>(gz), static_cast<int*>(tau_out),
      static_cast<float4*>(mix_out), V, S, G);
  return static_cast<int>(cudaGetLastError());
}
