// Per-position strain-pair swap move (Metropolis-Hastings), one warp per
// position.
//
// Replaces desman_tpu/ops/swap_pallas.py::_kernel (reached through
// _swap_bmajor's pallas_call), both of its modes. The move, stated at the
// [V,S,4] layout, is desman::swap_position (position.cuh): for one proposed
// pair (g, h), an MH log-ratio per position from the rank-1 proposal
// p' = p + dgam (x) (doh @ eta), and where accepted, tau columns g <-> h
// swapped and mix += dgam (x) doh. g == h (a one-strain model) never
// accepts. With emit_ll it also returns the post-swap per-sample loglik
// ll[S] (the resident sweep's gamma-MH ll_old), through the deterministic
// per-block reduction of warp.cuh.
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
// Without emit_ll a warp past the ragged edge returns at once; with it, it
// writes zeros into its block's reduction slot (in shared memory, or past
// S = 3632 in the block's rows of a device-memory scratch: warp.cuh).
// Chains (without emit_ll): chain c in grid row blockIdx.y, its tau, mix,
// gamma, eta, logu and outputs at c times their size, its pair g[c], h[c],
// and the counts n_stride cells a chain (0 where the chains share them).
// Each position's arithmetic is the one-chain kernel's, so chain c of a
// launch is bitwise the launch on chain c's inputs alone. A launch of one
// chain takes the instantiation without the offsets (kChains false): with
// them the one-chain launch took 10% more device time on an H100 at V=1e4,
// S=64, G=8 (kernel_bench, PERF.md).
#include <cuda_runtime.h>

#include "position.cuh"

namespace desman {
namespace {

template <bool kEmit, bool kDeviceSlots, bool kChains>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
swap_kernel(const float4* __restrict__ n, const int* __restrict__ tau_in,
            const float4* __restrict__ mix_in, const float* __restrict__ gamma,
            const float* __restrict__ eta, const int* __restrict__ g_ptr,
            const int* __restrict__ h_ptr, const float* __restrict__ logu,
            int* __restrict__ tau_out, float4* __restrict__ mix_out, float* partial,
            float* slot_scratch, int V, int S, int G, long n_stride) {
  extern __shared__ float smem_slots[];
  const long v = warp_position(V);
  if (!kEmit && v < 0) return;
  const int lane = threadIdx.x % kWarp;
  if (kChains) {  // this block's chain
    const long c = blockIdx.y;
    n += c * n_stride;
    tau_in += c * V * G;
    tau_out += c * V * G;
    mix_in += c * V * S;
    mix_out += c * V * S;
    gamma += c * S * G;
    eta += 16 * c;
    g_ptr += c;
    h_ptr += c;
    logu += c * V;
  }
  float* slots = block_slots<kDeviceSlots>(slot_scratch, smem_slots, S);
  float* slot_a = kEmit ? warp_slot(slots, 0, S) : nullptr;
  float* slot_c = kEmit ? warp_slot(slots, 1, S) : nullptr;
  if (v >= 0) {
    float e[4][4];
    load_eta(eta, e);
    swap_position<kEmit>(n + v * S, tau_in, mix_in + v * S, GammaSG{gamma, G}, e, *g_ptr, *h_ptr,
                         logu[v], tau_out, mix_out + v * S, v, S, G, lane, slot_a, slot_c);
  } else if (kEmit) {
    zero_slot(slot_a, S);
  }
  if (kEmit) write_block_partial(slots, 1, S, partial);
}

}  // namespace
}  // namespace desman

// `chains` chains, C >= 1: n: [V,S,4] f32 shared by the chains (n_stride
// 0), or [C,V,S,4] (n_stride V*S cells); mix_in, mix_out: [C,V,S,4] f32;
// tau_in, tau_out: [C,V,G] i32; gamma: [C,S,G] f32; eta: [C,4,4] f32; g, h:
// [C] device int32; logu: [C,V] f32 (one chain: the same without the
// leading axis). ll: null, or (one chain only) the [S] f32 post-swap
// per-sample loglik, with partial the [desman_partial_rows(V), 1, S] f32
// scratch of its reduction and slots null, or past S = 3632 the
// [desman_partial_rows(V), 2, 8, S] f32 scratch of the blocks' slots.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// the first failing call's cudaError_t.
extern "C" int desman_swap(const void* n, const void* tau_in, const void* mix_in,
                           const void* gamma, const void* eta, const void* g,
                           const void* h, const void* logu, void* tau_out, void* mix_out,
                           void* partial, void* slots, void* ll, int V, int S, int G,
                           int chains, long long n_stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V <= 0) {
    return ll ? static_cast<int>(cudaMemsetAsync(ll, 0, sizeof(float) * S, st))
              : static_cast<int>(cudaSuccess);
  }
  const int blocks = desman::launch_blocks(V);
  const int threads = desman::kWarpsPerBlock * desman::kWarp;
  const bool emit = ll != nullptr;
  if ((emit ? !desman::slot_scratch_ok(S, slots) || chains != 1 : slots != nullptr) ||
      chains < 1 || chains > 65535 || n_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = !emit        ? (chains > 1 ? desman::swap_kernel<false, false, true>
                                           : desman::swap_kernel<false, false, false>)
                : slots ? desman::swap_kernel<true, true, false>
                        : desman::swap_kernel<true, false, false>;
  cudaError_t err = emit ? desman::allow_slots(kernel, S) : cudaSuccess;
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(blocks, chains), threads, emit ? desman::smem_slot_bytes(S) : 0, st>>>(
      static_cast<const float4*>(n), static_cast<const int*>(tau_in),
      static_cast<const float4*>(mix_in), static_cast<const float*>(gamma),
      static_cast<const float*>(eta), static_cast<const int*>(g), static_cast<const int*>(h),
      static_cast<const float*>(logu), static_cast<int*>(tau_out),
      static_cast<float4*>(mix_out), static_cast<float*>(partial), static_cast<float*>(slots),
      V, S, G, static_cast<long>(n_stride));
  err = cudaGetLastError();
  if (err == cudaSuccess && emit)
    err = desman::launch_reduce(static_cast<const float*>(partial), static_cast<float*>(ll),
                                blocks, S, st);
  return static_cast<int>(err);
}

// Rows of the per-block partial scratch of every kernel with an [S] output.
extern "C" int desman_partial_rows(int V) { return desman::launch_blocks(V); }

extern "C" const char* desman_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
