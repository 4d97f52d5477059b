// The front half of a resident sweep in one kernel: the tau Gibbs sweep,
// then the strain-pair swap with its post-swap per-sample loglik, then the
// gamma proposal's per-sample loglik, one warp per position.
//
// Replaces desman_tpu/ops/fused_sweep.py::_kernel (fused_sweep_bmajor's
// pallas_call). Per position it runs desman::tau_position, then
// desman::swap_position<true> on the warp's own post-sweep row (the swap
// pair is drawn before the kernel), then desman::proposal_loglik on the
// post-swap tau (the gamma proposal does not depend on the sweep's output,
// so it is drawn before the kernel too). Outputs: tau, mix, and ll [2,S]:
// row 0 the swap's t_fin sum (the gamma MH's ll_old), row 1 the proposal's
// loglik (ll_new). These are the staged kernels' own device functions and
// reduction, so the result is bitwise equal to
// tau_sweep -> swap(emit_ll) -> gamma_ll(with_old=False).
//
// What bounds it on an H100: the logs, (16G + 8 + 4) * V * S of them a
// sweep (about 90 M at V=1e4, S=64, G=8). The design takes them all in one
// visit to each position: it reads n and mix once and writes tau and mix
// once, where the staged chain reads n three times and the mixture twice.
// The per-lane state is the 4x4 eta and a few scalars, bounded by neither
// S nor G; the [S] sums go through warp.cuh's per-block slots.
#include <cuda_runtime.h>

#include "position.cuh"

namespace desman {
namespace {

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
fused_sweep_kernel(const float4* __restrict__ n, const int* __restrict__ tau_in,
                   const float4* __restrict__ mix_in, const float* __restrict__ gamma,
                   const float* __restrict__ eta, const float4* __restrict__ gz,
                   const int* __restrict__ g_ptr, const int* __restrict__ h_ptr,
                   const float* __restrict__ logu, const float* __restrict__ gamma_prop,
                   int* tau_out, float4* mix_out, float* __restrict__ partial, int V, int S,
                   int G) {
  extern __shared__ float slots[];
  const long v = warp_position(V);
  const int lane = threadIdx.x % kWarp;
  float* slot_old = warp_slot(slots, 0, S);
  float* slot_new = warp_slot(slots, 1, S);
  if (v >= 0) {
    float e[4][4];
    load_eta(eta, e);
    const float4* n_row = n + v * S;
    float4* out_row = mix_out + v * S;
    tau_position(n_row, tau_in, mix_in + v * S, gamma, e, gz, tau_out, out_row, v, S, G,
                 lane);
    __syncwarp();  // lane 0 wrote the new tau row
    // in place on the post-sweep row; slot_new holds the swap's
    // with-swap sums until the proposal loglik overwrites it
    swap_position<true>(n_row, tau_out, out_row, gamma, e, *g_ptr, *h_ptr, logu[v], tau_out,
                        out_row, v, S, G, lane, slot_old, slot_new);
    __syncwarp();  // lanes < G wrote the post-swap tau row
    proposal_loglik(n_row, tau_out + v * G, gamma_prop, e, S, G, lane, slot_new);
  } else {
    zero_slot(slot_old, S);
    zero_slot(slot_new, S);
  }
  write_block_partial(slots, 2, S, partial);
}

}  // namespace
}  // namespace desman

// n, mix_in, mix_out: [V,S,4] f32; tau_in, tau_out: [V,G] i32; gamma,
// gamma_prop: [S,G] f32; eta: [4,4] f32; gz: [V,G,4] f32 (already *
// temperature); g, h: device int32 scalars; logu: [V] f32; ll: [2,S] f32;
// partial: the [desman_partial_rows(V), 2, S] f32 scratch of its reduction.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// first failing call's cudaError_t.
extern "C" int desman_fused_sweep(const void* n, const void* tau_in, const void* mix_in,
                                  const void* gamma, const void* eta, const void* gz,
                                  const void* g, const void* h, const void* logu,
                                  const void* gamma_prop, void* tau_out, void* mix_out,
                                  void* partial, void* ll, int V, int S, int G, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V <= 0) return static_cast<int>(cudaMemsetAsync(ll, 0, sizeof(float) * 2 * S, st));
  cudaError_t err = desman::allow_slots(desman::fused_sweep_kernel, S);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = desman::launch_blocks(V);
  desman::fused_sweep_kernel<<<blocks, desman::kWarpsPerBlock * desman::kWarp,
                               desman::slot_bytes(S), st>>>(
      static_cast<const float4*>(n), static_cast<const int*>(tau_in),
      static_cast<const float4*>(mix_in), static_cast<const float*>(gamma),
      static_cast<const float*>(eta), static_cast<const float4*>(gz),
      static_cast<const int*>(g), static_cast<const int*>(h),
      static_cast<const float*>(logu), static_cast<const float*>(gamma_prop),
      static_cast<int*>(tau_out), static_cast<float4*>(mix_out),
      static_cast<float*>(partial), V, S, G);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = desman::launch_reduce(static_cast<const float*>(partial), static_cast<float*>(ll),
                                blocks, 2 * S, st);
  return static_cast<int>(err);
}
