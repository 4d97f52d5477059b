// Tau Gibbs sweep over all strains, one warp per position.
//
// Replaces desman_tpu/ops/tau_pallas.py::_kernel (reached through
// _sweep_bmajor's pallas_call), the JAX package's port of DESMAN's
// `sampletau` Cython+GSL loop. The function, stated at the [V,S,4] layout,
// is desman::tau_position (position.cuh), which the fused front-half kernel
// runs too.
//
// What bounds it on an H100: the logs. A sweep evaluates 16*G*V*S of them
// (82 M at V=1e4, S=64, G=8) against one read of n and a few L1/L2-resident
// passes over the position's mixture row; the bytes (about 20 MB a sweep
// from device memory) are small next to the IEEE logf work.
//
// Design: a warp owns one position, so the strain loop's data-dependent
// one-hot update needs no synchronisation beyond the warp. Lanes stride over
// samples with one 16-byte float4 load of n[v,s,:] and mix[v,s,:] each. The
// four candidate sums are reduced with a shuffle butterfly, after which every
// lane holds the same sums and takes the same argmax (strict '>', so the
// first maximum wins, as jnp.argmax does). The position's mixture row is
// written back after every strain by the lanes that own it, so there are no
// races and no atomics, and a sweep is bitwise the same from run to run.
// Warps past the ragged edge return before touching memory: no pad rows.
#include <cuda_runtime.h>

#include "position.cuh"

namespace desman {
namespace {

// mix_in and mix_out are not __restrict__: from the second strain on, the
// kernel reads back the row it wrote to mix_out.
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
tau_sweep_kernel(const float4* __restrict__ n, const int* __restrict__ tau_in,
                 const float4* mix_in, const float* __restrict__ gamma,
                 const float* __restrict__ eta, const float4* __restrict__ gz,
                 int* __restrict__ tau_out, float4* mix_out, int V, int S, int G) {
  const long v = warp_position(V);
  if (v < 0) return;
  float e[4][4];
  load_eta(eta, e);
  tau_position(n + v * S, tau_in, mix_in + v * S, gamma, e, gz, tau_out, mix_out + v * S, v,
               S, G, threadIdx.x % kWarp);
}

}  // namespace
}  // namespace desman

// n, mix, mix_out: [V,S,4] f32; tau_in, tau_out: [V,G] i32; gamma: [S,G]
// f32 (a few KB, cache-resident); eta: [4,4] f32; gz: [V,G,4] f32.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// the launch's cudaError_t.
extern "C" int desman_tau_sweep(const void* n, const void* tau_in, const void* mix_in,
                                const void* gamma, const void* eta, const void* gz,
                                void* tau_out, void* mix_out, int V, int S, int G,
                                void* stream) {
  if (V <= 0) return static_cast<int>(cudaSuccess);
  desman::tau_sweep_kernel<<<desman::launch_blocks(V), desman::kWarpsPerBlock * desman::kWarp,
                             0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(n), static_cast<const int*>(tau_in),
      static_cast<const float4*>(mix_in), static_cast<const float*>(gamma),
      static_cast<const float*>(eta), static_cast<const float4*>(gz),
      static_cast<int*>(tau_out), static_cast<float4*>(mix_out), V, S, G);
  return static_cast<int>(cudaGetLastError());
}
