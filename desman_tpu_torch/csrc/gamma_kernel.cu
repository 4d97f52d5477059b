// The gamma-MH likelihood pair, and the accepted-gamma apply fused with the
// joint-eta likelihood: the resident sweep's two [V]-sized passes around the
// [S]-sized MH decisions. One warp per position.
//
// Replaces desman_tpu/ops/gamma_pallas.py:
//
// - _gamma_ll_kernel (gamma_ll_bmajor's pallas_call): per-sample loglik
//   [2,S]. Row 1 is sum_{v,b} n * log max(mp @ eta, 1e-12) of the proposal
//   mixture mp[v,s,a] = sum_g [tau[v,g]==a] * gamma_prop[s,g], rebuilt in
//   registers and never stored; row 0 is the same on the carried mixture
//   (with_old), else zeros.
// - _apply_eta_kernel (gamma_apply_eta_bmajor's pallas_call):
//   mix_new = mix + accept[s] * (mp - mix), the Pallas formula (accepted
//   samples take the mixture the MH ratio was evaluated on), and, with
//   with_eta, ll_eta[s] = sum_{v,b} n * log max(mix_new @ eta_prop, 1e-12).
//   Without with_eta (fixed eta) it takes no logs and reduces nothing.
//
// What bounds them on an H100: bytes. Each reads n, mix and tau once (the
// apply also writes mix once), about 20-30 MB a call at V=1e4, S=64, G=8,
// against 4 or 8 logs per (v,s). The design reads n[v,s,:] and mix[v,s,:]
// as one float4 each, keeps gamma_prop (a few KB) in cache, rebuilds mp in
// registers, and writes nothing [V]-sized but the apply's new mixture. The [S] sums go through the
// deterministic per-block reduction of warp.cuh, the one the swap's emit_ll
// and the fused kernel use (one partial row per 8 positions, summed by a
// second, fixed-order launch), so the fused kernel's ll_new stays bitwise
// gamma_ll's row 1. Past S = 3632 a block's reduction slots live in a
// device-memory scratch (warp.cuh). A row-resident gamma_ll on a
// persistent grid was no faster at the shapes the resident path launches
// it at (G=1, V up to about 1e4; PERF.md).
//
// Chains: the JAX package vmaps the resident sweep over chains, and the
// pallas_call gains a leading grid axis. Here one launch takes C chains,
// chain c in grid row blockIdx.y (as the tau and swap kernels): mix, tau,
// gamma_prop, eta (eta_prop), accept and the outputs at chain c's offset,
// the counts n_stride cells a chain (0 where the chains share them). The
// [S] sums keep every column's order: a block writes its partial row into
// chain c's columns of one [blocks, C, k, S] scratch (warp.cuh), and one
// reduction launch over C*k*S columns adds each column over the same blocks
// in the same fixed tree as a launch of chain c alone; past S = 3632 the
// device-memory slots are [C * blocks] blocks' rows. So chain c of a launch
// is bitwise the launch on chain c's inputs alone. A launch of one chain
// takes the instantiation without the offsets (kChains false), the parent's
// code, as the swap kernel does.
#include <cuda_runtime.h>

#include "position.cuh"

namespace desman {
namespace {

template <bool kDeviceSlots, bool kChains>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
gamma_ll_kernel(const float4* __restrict__ n, const float4* __restrict__ mix,
                const int* __restrict__ tau, const float* __restrict__ gamma_prop,
                const float* __restrict__ eta, float* __restrict__ partial, float* slot_scratch,
                int V, int S, int G, int with_old, long n_stride) {
  extern __shared__ float smem_slots[];
  const long v = warp_position(V);
  const int lane = threadIdx.x % kWarp;
  if (kChains) {  // this block's chain
    const long c = blockIdx.y;
    n += c * n_stride;
    mix += c * V * S;
    tau += c * V * G;
    gamma_prop += c * S * G;
    eta += 16 * c;
    partial += c * 2 * S;
  }
  float* slots = block_slots<kDeviceSlots>(slot_scratch, smem_slots, S, chain_block<kChains>());
  float* slot_old = warp_slot(slots, 0, S);
  float* slot_new = warp_slot(slots, 1, S);
  if (v >= 0) {
    float e[4][4];
    load_eta(eta, e);
    const float4* n_row = n + v * S;
    const float4* mix_row = mix + v * S;
    for (int s = lane; s < S; s += kWarp)
      slot_old[s] = with_old ? cell_loglik(n_row[s], mix_row[s], e) : 0.f;
    proposal_loglik(n_row, tau + v * G, gamma_prop, e, S, G, lane, slot_new);
  } else {
    zero_slot(slot_old, S);
    zero_slot(slot_new, S);
  }
  write_block_partial(slots, 2, S, partial, blockIdx.x, partial_stride<kChains>(2, S));
}

template <bool kDeviceSlots, bool kChains>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
apply_eta_kernel(const float4* __restrict__ n, const float4* __restrict__ mix,
                 const int* __restrict__ tau, const float* __restrict__ gamma_prop,
                 const bool* __restrict__ accept, const float* __restrict__ eta_prop,
                 float4* __restrict__ mix_out, float* __restrict__ partial,
                 float* slot_scratch, int V, int S, int G, int with_eta, long n_stride) {
  extern __shared__ float smem_slots[];
  const long v = warp_position(V);
  if (!with_eta && v < 0) return;
  const int lane = threadIdx.x % kWarp;
  if (kChains) {  // this block's chain
    const long c = blockIdx.y;
    n += c * n_stride;
    mix += c * V * S;
    mix_out += c * V * S;
    tau += c * V * G;
    gamma_prop += c * S * G;
    accept += c * S;
    eta_prop += 16 * c;
    if (with_eta) partial += c * S;
  }
  float* slots = block_slots<kDeviceSlots>(slot_scratch, smem_slots, S, chain_block<kChains>());
  float* slot = warp_slot(slots, 0, S);
  if (v >= 0) {
    float e[4][4];
    load_eta(eta_prop, e);
    const float4* n_row = n + v * S;
    const float4* mix_row = mix + v * S;
    float4* out_row = mix_out + v * S;
    const int* tau_row = tau + v * G;
    for (int s = lane; s < S; s += kWarp) {
      const float acc = accept[s] ? 1.f : 0.f;
      const float4 m = mix_row[s];
      const float4 mp = proposal_mix(tau_row, gamma_prop, s, G);
      float4 r;
      r.x = m.x + acc * (mp.x - m.x);
      r.y = m.y + acc * (mp.y - m.y);
      r.z = m.z + acc * (mp.z - m.z);
      r.w = m.w + acc * (mp.w - m.w);
      out_row[s] = r;
      if (with_eta) slot[s] = cell_loglik(n_row[s], r, e);
    }
  } else {
    zero_slot(slot, S);
  }
  if (with_eta)
    write_block_partial(slots, 1, S, partial, blockIdx.x, partial_stride<kChains>(1, S));
}

}  // namespace
}  // namespace desman

// `chains` chains, C >= 1: n: [V,S,4] f32 shared by the chains (n_stride
// 0), or [C,V,S,4] (n_stride V*S cells); mix: [C,V,S,4] f32; tau: [C,V,G]
// i32; gamma_prop: [C,S,G] f32; eta: [C,4,4] f32; ll: [C,2,S] f32 (row 0
// zeros unless with_old); partial: the [desman_partial_rows(V), C, 2, S] f32
// scratch of its reduction; slots: null, or past S = 3632 the
// [C * desman_partial_rows(V), 2, 8, S] f32 scratch of the blocks' slots
// (one chain: the same without the chain axis). Launches on `stream`, does
// not synchronise, allocates nothing; returns the first failing call's
// cudaError_t.
extern "C" int desman_gamma_ll(const void* n, const void* mix, const void* tau,
                               const void* gamma_prop, const void* eta, void* partial,
                               void* slots, void* ll, int V, int S, int G, int with_old,
                               int chains, long long n_stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!desman::chains_ok(chains) || n_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (V <= 0)
    return static_cast<int>(cudaMemsetAsync(ll, 0, sizeof(float) * 2 * S * chains, st));
  if (!desman::slot_scratch_ok(S, slots)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = chains > 1 ? (slots ? desman::gamma_ll_kernel<true, true>
                                    : desman::gamma_ll_kernel<false, true>)
                           : (slots ? desman::gamma_ll_kernel<true, false>
                                    : desman::gamma_ll_kernel<false, false>);
  cudaError_t err = desman::allow_slots(kernel, S);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = desman::launch_blocks(V);
  kernel<<<dim3(blocks, chains), desman::kWarpsPerBlock * desman::kWarp,
           desman::smem_slot_bytes(S), st>>>(
      static_cast<const float4*>(n), static_cast<const float4*>(mix),
      static_cast<const int*>(tau), static_cast<const float*>(gamma_prop),
      static_cast<const float*>(eta), static_cast<float*>(partial),
      static_cast<float*>(slots), V, S, G, with_old, static_cast<long>(n_stride));
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = desman::launch_reduce(static_cast<const float*>(partial), static_cast<float*>(ll),
                                blocks, 2 * S * chains, st);
  return static_cast<int>(err);
}

// `chains` chains as desman_gamma_ll's, with mix_out: [C,V,S,4] f32; accept:
// [C,S] bool; eta_prop: [C,4,4] f32. With with_eta, ll: [C,S] f32, partial:
// the [desman_partial_rows(V), C, 1, S] f32 scratch and slots: null, or past
// S = 3632 the [C * desman_partial_rows(V), 2, 8, S] f32 scratch of the
// blocks' slots; without, all three are ignored (the wrapper returns
// zeros). Launches on `stream`, does not synchronise, allocates nothing;
// returns the first failing call's cudaError_t.
extern "C" int desman_gamma_apply_eta(const void* n, const void* mix, const void* tau,
                                      const void* gamma_prop, const void* accept,
                                      const void* eta_prop, void* mix_out, void* partial,
                                      void* slots, void* ll, int V, int S, int G, int with_eta,
                                      int chains, long long n_stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!desman::chains_ok(chains) || n_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (V <= 0) {
    return with_eta
               ? static_cast<int>(cudaMemsetAsync(ll, 0, sizeof(float) * S * chains, st))
               : static_cast<int>(cudaSuccess);
  }
  if (with_eta && !desman::slot_scratch_ok(S, slots))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool device_slots = with_eta && slots;
  auto kernel = chains > 1 ? (device_slots ? desman::apply_eta_kernel<true, true>
                                           : desman::apply_eta_kernel<false, true>)
                           : (device_slots ? desman::apply_eta_kernel<true, false>
                                           : desman::apply_eta_kernel<false, false>);
  cudaError_t err = with_eta ? desman::allow_slots(kernel, S) : cudaSuccess;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = desman::launch_blocks(V);
  kernel<<<dim3(blocks, chains), desman::kWarpsPerBlock * desman::kWarp,
           with_eta ? desman::smem_slot_bytes(S) : 0, st>>>(
      static_cast<const float4*>(n), static_cast<const float4*>(mix),
      static_cast<const int*>(tau), static_cast<const float*>(gamma_prop),
      static_cast<const bool*>(accept), static_cast<const float*>(eta_prop),
      static_cast<float4*>(mix_out), static_cast<float*>(partial),
      with_eta ? static_cast<float*>(slots) : nullptr, V, S, G, with_eta,
      static_cast<long>(n_stride));
  err = cudaGetLastError();
  if (err == cudaSuccess && with_eta)
    err = desman::launch_reduce(static_cast<const float*>(partial), static_cast<float*>(ll),
                                blocks, S * chains, st);
  return static_cast<int>(err);
}
