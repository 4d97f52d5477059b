// The front half of a resident sweep in one kernel: the tau Gibbs sweep,
// then the strain-pair swap with its post-swap per-sample loglik, then the
// gamma proposal's per-sample loglik; row-resident tiles, persistent blocks.
//
// Replaces desman_tpu/ops/fused_sweep.py::_kernel (fused_sweep_bmajor's
// pallas_call). Per position it runs desman::tau_position, then
// desman::swap_position<true> on the warp's own post-sweep row (the swap
// pair is drawn before the kernel), then desman::proposal_loglik on the
// post-swap tau (the gamma proposal does not depend on the sweep's output,
// so it is drawn before the kernel too). Outputs: tau, mix, and ll [2,S]:
// row 0 the swap's t_fin sum (the gamma MH's ll_old), row 1 the proposal's
// loglik (ll_new). These are the staged kernels' own device functions and
// reduction (warp.cuh: per-warp slots, one partial row per 8 positions, a
// fixed-tree second kernel), so the result is bitwise equal to
// tau_sweep -> swap(emit_ll) -> gamma_ll(with_old=False).
//
// What bounds it on an H100: the logs, (16G + 8 + 4) * V * S of them a
// sweep (about 90 M at V=1e4, S=64, G=8), each warp.cuh's log_normal,
// bitwise the IEEE logf in 17 SASS instructions where logf takes 27, on the
// FMA and ALU pipes: the SM's instruction issue, not the bytes (about 33 MB
// a sweep).
//
// Design: the tau kernel's (tau_kernel.cu, tile.cuh). A block owns
// 8-position tiles, one warp a position; the tile's n, mix, gz and tau rows
// arrive in shared memory by asynchronous bulk copies on an mbarrier, gamma
// is staged once per block as [G][S]; the sweep, the swap and the proposal
// loglik all run on the staged rows, and the tile's mix and tau rows go to
// device memory once, where the staged chain reads n three times and
// writes the mixture twice. A tile is what a block of the one-warp-per-
// position launch covered, so write_block_partial writes partial[tile]
// once per tile and the reduction is unchanged. Persistent grid from the
// occupancy API (ops/tau_kernel.py's resident_grid) with 5 resident blocks
// (48 registers; the compiler's own 77 allowed 3), one staged tile at a
// time where it fits (tile_plan), the rows in device memory where even one
// tile's do not, and past S = 3632, where even the [2,8,S] slots do not fit
// in shared memory, the slots in the block's rows of a device-memory scratch
// (warp.cuh). logf's bits, no atomics.
//
// Chains: one launch sweeps C chains, chain c in grid row blockIdx.y, each
// row an even share of the persistent grid (ops/tau_kernel.py's
// resident_grid), as in the tau kernel: tau, mix, gz, logu, gamma_prop and
// the outputs at chain c's offset, gamma [C,S,G] (staged once a block from
// its chain's slice) and eta [C,4,4], the pair g[c], h[c], the counts
// n_stride cells a chain (0 where the chains share them). A tile's partial
// row goes into chain c's columns of one [tiles, C, 2, S] scratch, and one
// reduction launch over C*2*S columns adds each column over the same tiles
// in the same fixed tree as a launch of chain c alone (warp.cuh); past S =
// 3632 the device-memory slots are [C * grid] blocks' rows. A [V,G] tau
// slice that does not start on 16 bytes is loaded by the warps (tile.cuh's
// tau_bulk_bytes). So chain c of a launch is bitwise the launch on chain c's
// inputs alone; one chain takes the instantiation without the offsets
// (kChains false), the parent's code.
#include <cuda_runtime.h>

#include "position.cuh"
#include "tile.cuh"

namespace desman {
namespace {

// As in tau_kernel.cu, the staged path takes its layout from the launch's
// `staged` argument: folded into constants it was slower on an H100.
// kDeviceSlots (only with rows in device memory): the slots in the block's
// rows of the device-memory scratch. kChains: a launch of more than one
// chain (grid rows), with the chains' offsets.
template <bool kStaged, bool kDeviceSlots = false, bool kChains = false>
__global__ void __launch_bounds__(kThreads, kResidentBlocks)
fused_sweep_kernel(const float4* __restrict__ n, const int* __restrict__ tau_in,
                   const float4* __restrict__ mix_in, const float* __restrict__ gamma,
                   const float* __restrict__ eta, const float4* __restrict__ gz,
                   const int* __restrict__ g_ptr, const int* __restrict__ h_ptr,
                   const float* __restrict__ logu, const float* __restrict__ gamma_prop,
                   int* tau_out, float4* mix_out, float* __restrict__ partial,
                   float* slot_scratch, int V, int S, int G, int staged, long n_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TileLayout L(S, G, kStaged && staged != 0, TileKind::kFused);
  if (kChains) {  // this block's chain
    const long c = blockIdx.y;
    n += c * n_stride;
    tau_in += c * V * G;
    tau_out += c * V * G;
    gz += c * V * G;
    mix_in += c * V * S;
    mix_out += c * V * S;
    gamma += c * S * G;
    gamma_prop += c * S * G;
    eta += 16 * c;
    g_ptr += c;
    h_ptr += c;
    logu += c * V;
    partial += c * 2 * S;
  }
  float* slots = block_slots<kDeviceSlots>(
      slot_scratch, reinterpret_cast<float*>(smem + L.slots), S, chain_block<kChains>());
  float* slot_old = warp_slot(slots, 0, S);
  float* slot_new = warp_slot(slots, 1, S);
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int tiles = (V + kTile - 1) / kTile;
  const int g = *g_ptr, h = *h_ptr;
  float e[4][4];
  load_eta(eta, e);

  if (!kStaged) {
    const GammaSG gam{gamma, G};
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long v = static_cast<long>(t) * kTile + w;
      if (v < V) {
        const float4* n_row = n + v * S;
        float4* out_row = mix_out + v * S;
        tau_position(n_row, tau_in, mix_in + v * S, gam, e, gz, tau_out, out_row, v, S, G,
                     lane);
        __syncwarp();  // lane 0 wrote the new tau row
        // in place on the post-sweep row; slot_new holds the swap's
        // with-swap sums until the proposal loglik overwrites it
        swap_position<true>(n_row, tau_out, out_row, gam, e, g, h, logu[v], tau_out,
                            out_row, v, S, G, lane, slot_old, slot_new);
        __syncwarp();  // lanes < G wrote the post-swap tau row
        proposal_loglik(n_row, tau_out + v * G, gamma_prop, e, S, G, lane, slot_new);
      } else {
        zero_slot(slot_old, S);
        zero_slot(slot_new, S);
      }
      write_block_partial(slots, 2, S, partial, t, partial_stride<kChains>(2, S));
      __syncthreads();  // the slots are free for the next tile
    }
    return;
  }

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* gamma_t = reinterpret_cast<float*>(smem + L.gamma_t);
  int* tau_new = reinterpret_cast<int*>(smem + L.tau_new);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    issue_tile(smem, L, bar, blockIdx.x, V, S, G, n, mix_in, gz, tau_in);  // grid <= tiles
  }
  stage_gamma_t(gamma_t, gamma, S, G);
  __syncthreads();
  const GammaGS gam{gamma_t, S};

  uint32_t parity = 0;  // the barrier's phase: one per tile this block walks
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, parity ^= 1) {
    const TileRows r = tile_rows(smem, L);
    mbar_wait(bar, parity);
    const int rows = tile_rows_in(t, V);
    if (w < rows) {
      const long v = static_cast<long>(t) * kTile + w;
      tau_tail(r.tau, tau_in, t, rows, G, w, lane);
      const float4* n_row = r.n + w * S;
      float4* row = r.mix + w * S;
      int* tau_row = tau_new + w * G;
      tau_position(n_row, r.tau, row, gam, e, r.gz, tau_new, row, w, S, G, lane);
      __syncwarp();  // lane 0 wrote the new tau row
      swap_position<true>(n_row, tau_new, row, gam, e, g, h, logu[v], tau_new, row, w, S, G,
                          lane, slot_old, slot_new);
      __syncwarp();  // lanes < G wrote the post-swap tau row
      proposal_loglik(n_row, tau_row, gamma_prop, e, S, G, lane, slot_new);
      for (int s = lane; s < S; s += kWarp) mix_out[v * S + s] = row[s];
      for (int j = lane; j < G; j += kWarp) tau_out[v * G + j] = tau_row[j];
    } else {
      zero_slot(slot_old, S);
      zero_slot(slot_new, S);
    }
    write_block_partial(slots, 2, S, partial, t, partial_stride<kChains>(2, S));
    fence_proxy_async();  // this thread's writes to the buffer, before the next copy
    __syncthreads();      // the buffer, tau_new and the slots are free
    const int next = t + gridDim.x;
    if (threadIdx.x == 0 && next < tiles)
      issue_tile(smem, L, bar, next, V, S, G, n, mix_in, gz, tau_in);
  }
}

}  // namespace
}  // namespace desman

// `chains` chains, C >= 1: n: [V,S,4] f32 shared by the chains (n_stride
// 0), or [C,V,S,4] (n_stride V*S cells); mix_in, mix_out: [C,V,S,4] f32;
// tau_in, tau_out: [C,V,G] i32; gamma, gamma_prop: [C,S,G] f32; eta:
// [C,4,4] f32; gz: [C,V,G,4] f32 (already * temperature); g, h: [C] device
// int32; logu: [C,V] f32; ll: [C,2,S] f32; partial: the
// [desman_partial_rows(V), C, 2, S] f32 scratch of its reduction; slots:
// null, or where the plan puts them in device memory (S > 3632) the
// [C * grid, 2, 8, S] f32 scratch of the blocks' slots (one chain: the same
// without the chain axis). staged and smem_bytes: ops/tau_kernel.py's
// tile_plan(S, G, fused=True); grid: its resident_grid, blocks a chain
// (after desman_fused_sweep_info has opted the kernel in to its shared
// memory on this device). Launches on `stream`, does not synchronise,
// allocates nothing; returns the first failing call's cudaError_t.
extern "C" int desman_fused_sweep(const void* n, const void* tau_in, const void* mix_in,
                                  const void* gamma, const void* eta, const void* gz,
                                  const void* g, const void* h, const void* logu,
                                  const void* gamma_prop, void* tau_out, void* mix_out,
                                  void* partial, void* slots, void* ll, int V, int S, int G,
                                  int staged, int smem_bytes, int grid, int chains,
                                  long long n_stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!desman::chains_ok(chains) || n_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (V <= 0)
    return static_cast<int>(cudaMemsetAsync(ll, 0, sizeof(float) * 2 * S * chains, st));
  const desman::TileLayout L(S, G, staged != 0, desman::TileKind::kFused);
  const int tiles = desman::launch_blocks(V);
  if (!desman::plan_ok(L, staged, smem_bytes, grid) || grid > tiles ||
      !desman::slot_scratch_ok(S, slots))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = chains > 1 ? (staged  ? desman::fused_sweep_kernel<true, false, true>
                              : slots ? desman::fused_sweep_kernel<false, true, true>
                                      : desman::fused_sweep_kernel<false, false, true>)
                           : (staged  ? desman::fused_sweep_kernel<true>
                              : slots ? desman::fused_sweep_kernel<false, true>
                                      : desman::fused_sweep_kernel<false>);
  kernel<<<dim3(grid, chains), desman::kThreads, L.bytes, st>>>(
      static_cast<const float4*>(n), static_cast<const int*>(tau_in),
      static_cast<const float4*>(mix_in), static_cast<const float*>(gamma),
      static_cast<const float*>(eta), static_cast<const float4*>(gz),
      static_cast<const int*>(g), static_cast<const int*>(h),
      static_cast<const float*>(logu), static_cast<const float*>(gamma_prop),
      static_cast<int*>(tau_out), static_cast<float4*>(mix_out),
      static_cast<float*>(partial), static_cast<float*>(slots), V, S, G, staged,
      static_cast<long>(n_stride));
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = desman::launch_reduce(static_cast<const float*>(partial), static_cast<float*>(ll),
                                tiles, 2 * S * chains, st);
  return static_cast<int>(err);
}

// out[0..3]: registers, local (spill) bytes, resident blocks a SM and SMs
// of the fused kernel, staged or not, at smem_bytes on the current device
// (the one-chain instantiation's); opts both the one-chain and the
// chain-axis instantiations in to the shared memory every plan may ask for.
extern "C" int desman_fused_sweep_info(int staged, int smem_bytes, int* out) {
  auto chained = staged ? desman::fused_sweep_kernel<true, false, true>
                        : desman::fused_sweep_kernel<false, false, true>;
  int theirs[4];
  cudaError_t err = desman::kernel_info(chained, smem_bytes, theirs);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = staged ? desman::fused_sweep_kernel<true> : desman::fused_sweep_kernel<false>;
  return static_cast<int>(desman::kernel_info(kernel, smem_bytes, out));
}
