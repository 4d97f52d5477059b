// Per-position strain-pair swap move (Metropolis-Hastings), one warp per
// position.
//
// Replaces desman_tpu/ops/swap_pallas.py::_kernel (reached through
// _swap_bmajor's pallas_call) with emit_ll=False. Same function, stated at
// the [V,S,4] layout, for one proposed pair (g, h):
//   dgam = gamma[:,g] - gamma[:,h]
//   doh  = onehot(tau[:,h]) - onehot(tau[:,g])
//   p    = mix @ eta,   p' = p + dgam (x) (doh @ eta)
//   dll  = sum_{s,b} n * (log max(p',1e-12) - log max(p,1e-12))
//   accept where logu < dll (logu already divided by the tempering beta)
// and where accepted, swap tau columns g <-> h and set mix += dgam (x) doh.
// g == h (a one-strain model) never accepts.
//
// What bounds it on an H100: bytes. It reads n and mix once and writes mix
// and tau once (about 30 MB a call at V=1e4, S=64, G=8), against 8*V*S logs.
//
// Design: the same warp-per-position shape as the tau kernel. The pair
// (g, h) arrives as two device int32 scalars read by every thread, so the
// sampler never synchronises with the host to pass it. The rank-1 form of
// the proposal means p' is never stored: each lane evaluates both logs of
// its samples in registers, the warp reduces dll with a shuffle butterfly,
// and every lane then applies the same decision to the samples it owns.
#include <cuda_runtime.h>

#include "warp.cuh"

namespace desman {
namespace {

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
swap_kernel(const float4* __restrict__ n, const int* __restrict__ tau_in,
            const float4* __restrict__ mix_in, const float* __restrict__ gamma,
            const float* __restrict__ eta, const int* __restrict__ g_ptr,
            const int* __restrict__ h_ptr, const float* __restrict__ logu,
            int* __restrict__ tau_out, float4* __restrict__ mix_out, int V, int S,
            int G) {
  const long v = warp_position(V);
  if (v < 0) return;
  const int lane = threadIdx.x % kWarp;
  const int g = *g_ptr;
  const int h = *h_ptr;

  float e[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) e[a][b] = eta[a * 4 + b];

  const int tg = tau_in[v * G + g];
  const int th = tau_in[v * G + h];
  float doh[4], w[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) doh[a] = (a == th ? 1.f : 0.f) - (a == tg ? 1.f : 0.f);
#pragma unroll
  for (int b = 0; b < 4; ++b)
    w[b] = doh[0] * e[0][b] + doh[1] * e[1][b] + doh[2] * e[2][b] + doh[3] * e[3][b];

  const float4* n_row = n + v * S;
  const float4* mix_row = mix_in + v * S;
  // gamma[s,g] = gam_g[s * G]
  const float* gam_g = gamma + g;
  const float* gam_h = gamma + h;

  float part = 0.f;
  for (int s = lane; s < S; s += kWarp) {
    const float dg = gam_g[s * G] - gam_h[s * G];
    const float4 m = mix_row[s];
    const float4 cnt = n_row[s];
    const float nb[4] = {cnt.x, cnt.y, cnt.z, cnt.w};
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float p = m.x * e[0][b] + m.y * e[1][b] + m.z * e[2][b] + m.w * e[3][b];
      part += nb[b] * (safe_log(p + dg * w[b]) - safe_log(p));
    }
  }
  const float dll = warp_sum(part);
  const bool accept = (g != h) && (logu[v] < dll);

  float4* out_row = mix_out + v * S;
  for (int s = lane; s < S; s += kWarp) {
    float4 m = mix_row[s];
    if (accept) {
      const float dg = gam_g[s * G] - gam_h[s * G];
      m.x += dg * doh[0];
      m.y += dg * doh[1];
      m.z += dg * doh[2];
      m.w += dg * doh[3];
    }
    out_row[s] = m;
  }
  for (int k = lane; k < G; k += kWarp) {
    int t = tau_in[v * G + k];
    if (accept && k == g) t = th;
    else if (accept && k == h) t = tg;
    tau_out[v * G + k] = t;
  }
}

}  // namespace
}  // namespace desman

// n, mix_in, mix_out: [V,S,4] f32; tau_in, tau_out: [V,G] i32; gamma:
// [S,G] f32; eta: [4,4] f32; g, h: device int32 scalars; logu: [V] f32.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// launch's cudaError_t.
extern "C" int desman_swap(const void* n, const void* tau_in, const void* mix_in,
                           const void* gamma, const void* eta, const void* g,
                           const void* h, const void* logu, void* tau_out, void* mix_out,
                           int V, int S, int G, void* stream) {
  if (V <= 0) return static_cast<int>(cudaSuccess);
  desman::swap_kernel<<<desman::launch_blocks(V), desman::kWarpsPerBlock * desman::kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(n), static_cast<const int*>(tau_in),
      static_cast<const float4*>(mix_in), static_cast<const float*>(gamma),
      static_cast<const float*>(eta), static_cast<const int*>(g),
      static_cast<const int*>(h), static_cast<const float*>(logu),
      static_cast<int*>(tau_out), static_cast<float4*>(mix_out), V, S, G);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* desman_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
