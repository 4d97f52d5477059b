// Tau Gibbs sweep over all strains, one warp per position.
//
// Replaces desman_tpu/ops/tau_pallas.py::_kernel (reached through
// _sweep_bmajor's pallas_call), the JAX package's port of DESMAN's
// `sampletau` Cython+GSL loop. Same function, stated at the [V,S,4] layout:
// for each strain g in order,
//   rest = mix - gamma[:,g] (x) onehot(tau[:,g])
//   q    = rest @ eta
//   cand[v,c] = sum_{s,b} n * log(max(q + gamma[s,g] * eta[c,b], 1e-12))
//   new  = first argmax_c (cand + gz[v,g,:])        (gz already * temperature)
//   mix  = rest + gamma[:,g] (x) onehot(new)
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

#include "warp.cuh"

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
  const int lane = threadIdx.x % kWarp;

  float e[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) e[a][b] = eta[a * 4 + b];

  const float4* n_row = n + v * S;
  float4* out_row = mix_out + v * S;
  const float4* src = mix_in + v * S;

  for (int g = 0; g < G; ++g) {
    const float* gam = gamma + g;  // gamma[s,g] = gam[s * G]
    const int old = tau_in[v * G + g];

    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
    for (int s = lane; s < S; s += kWarp) {
      const float gs = gam[s * G];
      const float4 m = src[s];
      const float4 cnt = n_row[s];
      const float r0 = m.x - (old == 0 ? gs : 0.f);
      const float r1 = m.y - (old == 1 ? gs : 0.f);
      const float r2 = m.z - (old == 2 ? gs : 0.f);
      const float r3 = m.w - (old == 3 ? gs : 0.f);
      float q[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        q[b] = r0 * e[0][b] + r1 * e[1][b] + r2 * e[2][b] + r3 * e[3][b];
      const float nb[4] = {cnt.x, cnt.y, cnt.z, cnt.w};
      float t[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < 4; ++b) acc += nb[b] * safe_log(q[b] + gs * e[c][b]);
        t[c] = acc;
      }
      c0 += t[0];
      c1 += t[1];
      c2 += t[2];
      c3 += t[3];
    }
    c0 = warp_sum(c0);
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
    c3 = warp_sum(c3);

    const float4 z = gz[v * G + g];
    float best = c0 + z.x;
    int pick = 0;
    const float s1 = c1 + z.y, s2 = c2 + z.z, s3 = c3 + z.w;
    if (s1 > best) { best = s1; pick = 1; }
    if (s2 > best) { best = s2; pick = 2; }
    if (s3 > best) { best = s3; pick = 3; }

    for (int s = lane; s < S; s += kWarp) {
      const float gs = gam[s * G];
      const float4 m = src[s];
      float4 r;
      r.x = (m.x - (old == 0 ? gs : 0.f)) + (pick == 0 ? gs : 0.f);
      r.y = (m.y - (old == 1 ? gs : 0.f)) + (pick == 1 ? gs : 0.f);
      r.z = (m.z - (old == 2 ? gs : 0.f)) + (pick == 2 ? gs : 0.f);
      r.w = (m.w - (old == 3 ? gs : 0.f)) + (pick == 3 ? gs : 0.f);
      out_row[s] = r;
    }
    if (lane == 0) tau_out[v * G + g] = pick;
    src = out_row;
  }
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
