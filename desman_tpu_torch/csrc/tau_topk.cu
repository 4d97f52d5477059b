// Tau Gibbs sweep over all strains with each cell's candidate logs taken at
// its at most two observed bases: row-resident tiles, persistent blocks.
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
// them: 8 per (v, s, g) instead of 16 (41 M a sweep at V=1e4, S=64, G=8),
// each warp.cuh's log_normal of 17 SASS instructions on the FMA and ALU
// pipes, so the floor is the SM's instruction issue (about 0.021 ms for the
// logs alone at V=1e4), not the bytes (about 33 MB a sweep). The counts
// come as n_val [V,S,2] f32 and b_idx [V,S,2] i32, 16 bytes a cell as the
// tau kernel's float4 of n; the mixture is still read and written as
// [V,S,4], since the rest mixture at the two selected bases needs all four
// of its entries.
//
// Design: the tau kernel's (tau_kernel.cu, tile.cuh). A block owns
// 8-position tiles, one warp a position; the tile's n_val, b_idx, mix, gz
// and tau rows arrive in shared memory by asynchronous bulk copies on an
// mbarrier, gamma is staged once per block as [G][S] (GammaGS: the lanes
// read neighbouring words, where [S,G] made them read with a stride of G
// words), and the strain loop rewrites the mix row in shared memory in place
// (the one-warp-per-position kernel made 8 store -> load round trips a
// position through device memory at G=8); each tile's mix and tau rows go to
// device memory once. eta's four columns are staged once per block as a
// [4] float4 table: each cell's eta[:, b] at its two bases is one
// shared-memory load each, where the one-warp-per-position kernel selected
// them from 16 eta registers with 24 selects a (cell, strain). A ragged last
// tile whose rows * S is odd has an n_val/b_idx span that is not a multiple
// of 16 bytes: the bulk copies take its 16-byte prefix and the warps load
// the last cell (pair_tail). Persistent grid from the occupancy API
// (ops/tau_kernel.py's resident_grid), 5 resident blocks a SM (48
// registers); where one tile's rows do not fit in 227 KB (S > 900 or so),
// the same kernel template reads them from device memory.
// Chains: the tau kernel's chain axis (tau_kernel.cu): chain c in grid row
// blockIdx.y, its tau, mix, gz, gamma, eta and outputs at c times their size,
// and n_val/b_idx n_stride cells a chain (0 where the chains share them; an
// even stride, so every chain's rows start on 16 bytes for the bulk copies).
//
// A lane evaluates the two slots in ascending base order, each term with the
// tau kernel's own expression (q[b] by the same multiply-add chain, then
// n * log(max(q[b] + gamma[s,g] * eta[c,b], 1e-12))). nvcc contracts
// `acc += n * log(...)` into fma, so the order of the terms decides the
// rounding: in base order the nonzero terms meet in the same fma chain as in
// the tau kernel, whose zero-count terms each add an exact zero. Slot order
// by count, as the JAX package keeps it, would round differently. No
// --use_fast_math: the logs keep logf's bits. No atomics: a sweep is bitwise
// the same from run to run, for every grid and every tile plan.
#include <cuda_runtime.h>

#include "position.cuh"
#include "tile.cuh"

namespace desman {
namespace {

// The tile's staged top-2 rows: n_val [8][S] float2, then b_idx [8][S]
// int2, in the buffer's n region (16 bytes a cell, as n's float4).
struct PairRows {
  float2* n_val;
  int2* b_idx;
};

__device__ __forceinline__ PairRows pair_rows(unsigned char* smem, const TileLayout& L, int S) {
  unsigned char* p = smem + L.buf + L.n;
  return PairRows{reinterpret_cast<float2*>(p),
                  reinterpret_cast<int2*>(p + static_cast<size_t>(kTile) * 8 * S)};
}

// One thread: start the copies of tile t's rows into the buffer.
__device__ __forceinline__ void issue_topk_tile(unsigned char* smem, const TileLayout& L,
                                                uint64_t* bar, long t, int V, int S, int G,
                                                const float2* n_val, const int2* b_idx,
                                                const float4* mix, const float4* gz,
                                                const int* tau) {
  const int rows = tile_rows_in(t, V);
  const long v0 = t * kTile;
  const uint32_t pair_bytes = pair_bulk_bytes(rows, S);
  const uint32_t row_bytes = static_cast<uint32_t>(rows) * S * 16;
  const uint32_t gz_bytes = static_cast<uint32_t>(rows) * G * 16;
  const uint32_t tau_bytes = tau_bulk_bytes(tau + v0 * G, rows, G);
  const TileRows r = tile_rows(smem, L);
  const PairRows p = pair_rows(smem, L, S);
  mbar_expect_tx(bar, 2 * pair_bytes + row_bytes + gz_bytes + tau_bytes);
  if (pair_bytes) {
    bulk_load(p.n_val, n_val + v0 * S, pair_bytes, bar);
    bulk_load(p.b_idx, b_idx + v0 * S, pair_bytes, bar);
  }
  bulk_load(r.mix, mix + v0 * S, row_bytes, bar);
  bulk_load(const_cast<float4*>(r.gz), gz + v0 * G, gz_bytes, bar);
  if (tau_bytes) bulk_load(r.tau, tau + v0 * G, tau_bytes, bar);
}

// mix_in and mix_out are not __restrict__: on the device-memory path the
// strain loop reads back the row it wrote to mix_out. As in tau_kernel.cu,
// the device-memory path asks for 4 resident blocks (at most 64 registers)
// and the staged path takes its layout from the launch's `staged` argument.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kStaged ? kResidentBlocks : 4)
tau_topk_kernel(const float2* __restrict__ n_val, const int2* __restrict__ b_idx,
                const int* __restrict__ tau_in, const float4* mix_in,
                const float* __restrict__ gamma, const float* __restrict__ eta,
                const float4* __restrict__ gz, int* __restrict__ tau_out, float4* mix_out,
                int V, int S, int G, int staged, long n_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int tiles = (V + kTile - 1) / kTile;
  const long c = blockIdx.y;  // this block's chain
  n_val += c * n_stride;
  b_idx += c * n_stride;
  tau_in += c * V * G;
  tau_out += c * V * G;
  gz += c * V * G;
  mix_in += c * V * S;
  mix_out += c * V * S;
  gamma += c * S * G;
  eta += 16 * c;
  const TileLayout L(S, G, kStaged && staged != 0, TileKind::kTopk);
  float4* eta_col = reinterpret_cast<float4*>(smem + L.eta_cols);
  if (threadIdx.x < 4) {
    const int b = threadIdx.x;
    eta_col[b] = make_float4(eta[b], eta[4 + b], eta[8 + b], eta[12 + b]);
  }

  if (!kStaged) {
    __syncthreads();  // the eta columns
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long v = static_cast<long>(t) * kTile + w;
      if (v < V)
        tau_position_terms(TwoBases{n_val + v * S, b_idx + v * S, eta_col}, tau_in,
                           mix_in + v * S, GammaSG{gamma, G}, nullptr, gz, tau_out,
                           mix_out + v * S, v, S, G, lane);
    }
    return;
  }

  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* gamma_t = reinterpret_cast<float*>(smem + L.gamma_t);
  int* tau_new = reinterpret_cast<int*>(smem + L.tau_new);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    issue_topk_tile(smem, L, bar, blockIdx.x, V, S, G, n_val, b_idx, mix_in, gz,
                    tau_in);  // grid <= tiles
  }
  stage_gamma_t(gamma_t, gamma, S, G);
  __syncthreads();
  const GammaGS gam{gamma_t, S};

  uint32_t parity = 0;  // the barrier's phase: one per tile this block walks
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, parity ^= 1) {
    const TileRows r = tile_rows(smem, L);
    const PairRows p = pair_rows(smem, L, S);
    mbar_wait(bar, parity);
    const int rows = tile_rows_in(t, V);
    if (w < rows) {
      const long v = static_cast<long>(t) * kTile + w;
      pair_tail(p.n_val, p.b_idx, n_val, b_idx, t, rows, S, w, lane);
      tau_tail(r.tau, tau_in, t, rows, G, w, lane);
      float4* row = r.mix + w * S;
      tau_position_terms(TwoBases{p.n_val + w * S, p.b_idx + w * S, eta_col}, r.tau, row, gam,
                         nullptr, r.gz, tau_new, row, w, S, G, lane);
      for (int s = lane; s < S; s += kWarp) mix_out[v * S + s] = row[s];
      __syncwarp();  // lane 0 wrote the new tau row
      for (int j = lane; j < G; j += kWarp) tau_out[v * G + j] = tau_new[w * G + j];
    }
    fence_proxy_async();  // this thread's writes to the buffer, before the next copy
    __syncthreads();      // every warp is done with the buffer and tau_new
    const int next = t + gridDim.x;
    if (threadIdx.x == 0 && next < tiles)
      issue_topk_tile(smem, L, bar, next, V, S, G, n_val, b_idx, mix_in, gz, tau_in);
  }
}

}  // namespace
}  // namespace desman

// `chains` chains, C >= 1: n_val: [V,S,2] f32 slot counts and b_idx:
// [V,S,2] i32 slot bases in ascending order (unused slot: count 0, base 0),
// shared by the chains (n_stride 0) or [C,V,S,2] (n_stride V*S cells, even);
// mix_in, mix_out: [C,V,S,4] f32; tau_in, tau_out: [C,V,G] i32; gamma:
// [C,S,G] f32; eta: [C,4,4] f32; gz: [C,V,G,4] f32 (already * temperature;
// one chain: the same without the leading axis). staged (0 or 1) and
// smem_bytes: ops/tau_kernel.py's tile_plan(S, G, topk=True), which must
// agree with tile.cuh's TileLayout; grid: its resident_grid, blocks a chain
// (after desman_tau_sweep_topk_info has opted the kernel in to its shared
// memory on this device). Launches on `stream`, does not synchronise,
// allocates nothing; returns the launch's cudaError_t.
extern "C" int desman_tau_sweep_topk(const void* n_val, const void* b_idx, const void* tau_in,
                                     const void* mix_in, const void* gamma, const void* eta,
                                     const void* gz, void* tau_out, void* mix_out, int V,
                                     int S, int G, int staged, int smem_bytes, int grid,
                                     int chains, long long n_stride, void* stream) {
  if (V <= 0) return static_cast<int>(cudaSuccess);
  const desman::TileLayout L(S, G, staged != 0, desman::TileKind::kTopk);
  if (!desman::plan_ok(L, staged, smem_bytes, grid) || grid > desman::launch_blocks(V) ||
      !desman::chains_ok(chains) || n_stride < 0 || n_stride % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = staged ? desman::tau_topk_kernel<true> : desman::tau_topk_kernel<false>;
  kernel<<<dim3(grid, chains), desman::kThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(n_val), static_cast<const int2*>(b_idx),
      static_cast<const int*>(tau_in), static_cast<const float4*>(mix_in),
      static_cast<const float*>(gamma), static_cast<const float*>(eta),
      static_cast<const float4*>(gz), static_cast<int*>(tau_out),
      static_cast<float4*>(mix_out), V, S, G, staged, static_cast<long>(n_stride));
  return static_cast<int>(cudaGetLastError());
}

// out[0..3]: registers, local (spill) bytes, resident blocks a SM and SMs
// of the top-2 kernel, staged or not, at smem_bytes on the current device;
// opts the kernel in to the shared memory every plan may ask for.
extern "C" int desman_tau_sweep_topk_info(int staged, int smem_bytes, int* out) {
  auto kernel = staged ? desman::tau_topk_kernel<true> : desman::tau_topk_kernel<false>;
  return static_cast<int>(desman::kernel_info(kernel, smem_bytes, out));
}
