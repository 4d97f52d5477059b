// Tau Gibbs sweep over all strains: row-resident tiles, persistent blocks.
//
// Replaces desman_tpu/ops/tau_pallas.py::_kernel (reached through
// _sweep_bmajor's pallas_call), the JAX package's port of DESMAN's
// `sampletau` Cython+GSL loop. The function, stated at the [V,S,4] layout,
// is desman::tau_position (position.cuh), which the fused front-half kernel
// runs too.
//
// What bounds it on an H100: the logs, 16*G*V*S a sweep (82 M at V=1e4,
// S=64, G=8). Each is warp.cuh's log_normal, bitwise the IEEE logf on the
// logs' range in 17 SASS instructions where logf takes 27, on the FMA and
// ALU pipes and no SFU op (kernel_bench's probes), so the floor is the
// SM's instruction issue, not the bytes (about 32 MB a sweep).
//
// Design: one warp owns one position, and its lanes take samples s = lane,
// lane + 32, ...; the strain loop, its shuffle butterfly and the strict '>'
// argmax (the first maximum wins, as jnp.argmax) are tau_position's, so the
// bits are those of the one-warp-per-position kernel. What the design
// changes is where the rows live and how blocks walk the positions
// (tile.cuh):
//   - a block owns 8-position tiles; the tile's n, mix, gz and tau rows
//     come into shared memory by asynchronous bulk copies completing on an
//     mbarrier, and gamma is staged once per block as [G][S];
//   - the strain loop rewrites the mix row in shared memory, in place, so
//     the 8 store -> load round trips a position made through device memory
//     at G=8 are gone; each lane writes its entries of the final row, and
//     the warp the new tau row, to device memory once per tile;
//   - the grid is persistent: SMs x resident blocks (the occupancy API at
//     this shared memory), no more than the tiles; blocks walk the tiles
//     with a grid stride, and the compiler is held to 48 registers so that
//     5 blocks (40 warps) stay resident to hide the copies and the shuffle
//     and argmax chains (tile.cuh's kResidentBlocks).
// Chains: the JAX package vmaps its chains, and under that vmap the
// pallas_call gains a leading grid axis. Here one launch sweeps C chains,
// chain c in grid row blockIdx.y: tau, mix, gz and the outputs are [C,...]
// with chain c's slice at c times its size, gamma [C,S,G] and eta [C,4,4]
// likewise (staged and loaded once a block, as for one chain), and the counts
// n_stride cells a chain (0 where the chains share them). A block's tiles are
// its chain's, so none straddles two chains; the grid's rows split the
// persistent blocks evenly (ops/tau_kernel.py's resident_grid). Each
// position's arithmetic is the one-chain kernel's, so chain c of a launch is
// bitwise the launch on chain c's inputs alone, and C = 1 is that launch.
// ops/tau_kernel.py's tile_plan stages one tile at a time where its rows fit
// in 227 KB: with 5 blocks a SM the copy of one block's next tile overlaps
// the others' work (a second buffer, the next tile's copy in flight while
// one computes, cost resident blocks and time on an H100 at S=64 and S=96;
// PERF.md). Where one tile's rows do not fit, the strain loop reads its row
// from device memory as the one-warp-per-position kernel did (the same
// kernel template, kStaged = false).
// logf's bits (no --use_fast_math), no atomics: a sweep is bitwise the same
// from run to run, for every grid and every tile plan.
#include <cuda_runtime.h>

#include "position.cuh"
#include "tile.cuh"

namespace desman {
namespace {

// mix_in and mix_out are not __restrict__: on the device-memory path the
// strain loop reads back the row it wrote to mix_out.
// The device-memory path asks for the one-warp-per-position kernel's 4
// resident blocks (at most 64 registers; 64, no spills, on an H100).
// The staged path takes its shared-memory layout from the launch's
// `staged` argument (always 1 there), not from kStaged: where the compiler
// could fold the layout into constants, its register allocation under the
// 48-register cap made this kernel slower than the parent's on an H100
// (PERF.md).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kStaged ? kResidentBlocks : 4)
tau_sweep_kernel(const float4* __restrict__ n, const int* __restrict__ tau_in,
                 const float4* mix_in, const float* __restrict__ gamma,
                 const float* __restrict__ eta, const float4* __restrict__ gz,
                 int* __restrict__ tau_out, float4* mix_out, int V, int S, int G,
                 int staged, long n_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int tiles = (V + kTile - 1) / kTile;
  const long c = blockIdx.y;  // this block's chain
  n += c * n_stride;
  tau_in += c * V * G;
  tau_out += c * V * G;
  gz += c * V * G;
  mix_in += c * V * S;
  mix_out += c * V * S;
  gamma += c * S * G;
  float e[4][4];
  load_eta(eta + 16 * c, e);

  if (!kStaged) {
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long v = static_cast<long>(t) * kTile + w;
      if (v < V)
        tau_position(n + v * S, tau_in, mix_in + v * S, GammaSG{gamma, G}, e, gz, tau_out,
                     mix_out + v * S, v, S, G, lane);
    }
    return;
  }

  const TileLayout L(S, G, staged != 0, TileKind::kTau);
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
      float4* row = r.mix + w * S;
      tau_position(r.n + w * S, r.tau, row, gam, e, r.gz, tau_new, row, w, S, G, lane);
      for (int s = lane; s < S; s += kWarp) mix_out[v * S + s] = row[s];
      __syncwarp();  // lane 0 wrote the new tau row
      for (int j = lane; j < G; j += kWarp) tau_out[v * G + j] = tau_new[w * G + j];
    }
    fence_proxy_async();  // this thread's writes to the buffer, before the next copy
    __syncthreads();      // every warp is done with the buffer and tau_new
    const int next = t + gridDim.x;
    if (threadIdx.x == 0 && next < tiles)
      issue_tile(smem, L, bar, next, V, S, G, n, mix_in, gz, tau_in);
  }
}

}  // namespace
}  // namespace desman

// `chains` chains, C >= 1: n: [V,S,4] f32 shared by the chains (n_stride
// 0), or [C,V,S,4] (n_stride V*S cells); mix, mix_out: [C,V,S,4] f32;
// tau_in, tau_out: [C,V,G] i32; gamma: [C,S,G] f32; eta: [C,4,4] f32; gz:
// [C,V,G,4] f32 (one chain: the same without the leading axis). staged (0
// or 1) and smem_bytes: ops/tau_kernel.py's tile_plan(S, G), which must
// agree with tile.cuh's TileLayout; grid: its resident_grid, blocks a chain
// that walk the chain's tiles (after desman_tau_sweep_info has opted the
// kernel in to its shared memory on this device). Launches on `stream`,
// does not synchronise, allocates nothing; returns the launch's cudaError_t.
extern "C" int desman_tau_sweep(const void* n, const void* tau_in, const void* mix_in,
                                const void* gamma, const void* eta, const void* gz,
                                void* tau_out, void* mix_out, int V, int S, int G, int staged,
                                int smem_bytes, int grid, int chains, long long n_stride,
                                void* stream) {
  if (V <= 0) return static_cast<int>(cudaSuccess);
  const desman::TileLayout L(S, G, staged != 0, desman::TileKind::kTau);
  if (!desman::plan_ok(L, staged, smem_bytes, grid) || grid > desman::launch_blocks(V) ||
      !desman::chains_ok(chains) || n_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = staged ? desman::tau_sweep_kernel<true> : desman::tau_sweep_kernel<false>;
  kernel<<<dim3(grid, chains), desman::kThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(n), static_cast<const int*>(tau_in),
      static_cast<const float4*>(mix_in), static_cast<const float*>(gamma),
      static_cast<const float*>(eta), static_cast<const float4*>(gz),
      static_cast<int*>(tau_out), static_cast<float4*>(mix_out), V, S, G, staged,
      static_cast<long>(n_stride));
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers, local (spill) bytes, resident blocks a SM and SMs
// of the tau kernel, staged or not, at smem_bytes on the current device;
// opts the kernel in to the shared memory every plan may ask for.
extern "C" int desman_tau_sweep_info(int staged, int smem_bytes, int* out) {
  auto kernel = staged ? desman::tau_sweep_kernel<true> : desman::tau_sweep_kernel<false>;
  return static_cast<int>(desman::kernel_info(kernel, smem_bytes, out));
}
