// Row-resident tiles and persistent blocks: the shared pieces of the tau
// kernel (tau_kernel.cu), the fused front-half kernel (fused_sweep.cu) and
// the top-2 tau kernel (tau_topk.cu).
//
// A tile is kTile = kWarpsPerBlock = 8 consecutive positions, one warp
// each, so a tile is what a block of the one-warp-per-position launch
// covered and the [S] partial rows stay one per 8 positions. Its n rows and
// mix rows are each one contiguous 8*S*16-byte span of the [V,S,4] arrays
// (the top-2 kernel's n_val and b_idx rows one 8*S*8-byte span each of its
// [V,S,2] arrays), its gz rows one 8*G*16-byte span of [V,G,4] and its tau
// rows one 8*G*4-byte span of [V,G]: each comes into shared memory with one
// asynchronous bulk copy (cp.async.bulk, the Tensor Memory Accelerator's
// 1-D form) that completes on the block's mbarrier.
//
// Shared memory of a block of the sweep kernels, in bytes (ops/tau_kernel.py's
// tile_plan computes the same total and the wrapper passes it in):
//   [0, 16)           the mbarrier
//   eta columns       [4] float4, eta[:, b] (top-2 kernel only)
//   gamma^T           [G][S] f32, staged once per block, rounded up to 16
//   tau_new           [8][G] i32: the tile's new tau rows
//   slots             [2][8][S] f32 (fused kernel only; warp.cuh)
//   buffer            n [8][S] float4 (top-2: n_val [8][S] float2, then
//                     b_idx [8][S] int2), mix [8][S] float4, gz [8][G]
//                     float4, tau [8][G] i32
// Unstaged (a tile's rows do not fit) nothing is staged: the rows are read
// from device memory as by the one-warp-per-position kernels (only the eta
// columns and the slots remain, the slots only where they fit: warp.cuh).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "warp.cuh"

namespace desman {

constexpr int kTile = kWarpsPerBlock;
constexpr int kThreads = kWarpsPerBlock * kWarp;
// Resident blocks a SM the row-resident kernels ask the compiler for
// (__launch_bounds__ minimum): 5 allows at most 48 registers a thread. On
// an H100 5 beat 4, 6 and 8 for the tau and fused kernels at S=64 and S=96
// (PERF.md).
constexpr int kResidentBlocks = 5;

__host__ __device__ constexpr size_t round16(size_t x) { return (x + 15) / 16 * 16; }

enum class TileKind { kTau, kFused, kTopk };

struct TileLayout {
  size_t eta_cols, gamma_t, tau_new, slots, buf, n, mix, gz, tau, bytes;

  __host__ __device__ TileLayout(int S, int G, bool staged, TileKind kind) {
    const size_t s = static_cast<size_t>(S), g = static_cast<size_t>(G);
    const bool fused = kind == TileKind::kFused;
    const size_t head = kind == TileKind::kTopk ? 64 : 0;  // the eta columns
    n = mix = gz = tau = 0;
    if (!staged) {  // rows in device memory: the eta columns and the slots alone
      eta_cols = gamma_t = tau_new = buf = 0;
      slots = head;
      bytes = head + (fused && slot_bytes(S) <= kSmemLimit ? slot_bytes(S) : 0);
      return;
    }
    eta_cols = 16;
    gamma_t = 16 + head;
    tau_new = gamma_t + round16(4 * s * g);
    slots = tau_new + kTile * 4 * g;
    buf = slots + (fused ? 2 * kTile * 4 * s : 0);
    mix = n + kTile * 16 * s;
    gz = mix + kTile * 16 * s;
    tau = gz + kTile * 16 * g;
    bytes = buf + tau + kTile * 4 * g;
  }
};

// ---- mbarrier and bulk-copy primitives (PTX, sm_90) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory into shared memory; completion counts against `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Order this thread's generic-proxy accesses of shared memory before later
// bulk copies into it (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- the tile's staged rows ----

struct TileRows {
  const float4* n;    // [8][S]
  float4* mix;        // [8][S], updated in place
  const float4* gz;   // [8][G]
  int* tau;           // [8][G] (tau_in)
};

__device__ __forceinline__ TileRows tile_rows(unsigned char* smem, const TileLayout& L) {
  unsigned char* b = smem + L.buf;
  return TileRows{reinterpret_cast<const float4*>(b + L.n),
                  reinterpret_cast<float4*>(b + L.mix),
                  reinterpret_cast<const float4*>(b + L.gz), reinterpret_cast<int*>(b + L.tau)};
}

// Positions of tile t that exist (the last tile may be ragged).
__device__ __forceinline__ int tile_rows_in(long t, int V) {
  const long left = static_cast<long>(V) - t * kTile;
  return left < kTile ? static_cast<int>(left) : kTile;
}

// Bytes of the tile's tau rows (starting at `src`) the bulk copy takes: all
// of them unless the ragged last tile's are not a multiple of 16, and none
// where the rows do not start on 16 bytes (a chain's [V,G] slice past chain
// 0 of a chain-axis launch when V*G is not a multiple of 4). The warps load
// the rest (tau_tail).
__device__ __forceinline__ uint32_t tau_bulk_bytes(const int* src, int rows, int G) {
  return (reinterpret_cast<uintptr_t>(src) & 15) ? 0u
                                                 : static_cast<uint32_t>(rows * G * 4) & ~15u;
}

// The same for the top-2 kernel's n_val (float2) or b_idx (int2) rows of a
// tile: 8 bytes a cell, so short of a multiple of 16 where rows * S is odd.
__device__ __forceinline__ uint32_t pair_bulk_bytes(int rows, int S) {
  return static_cast<uint32_t>(rows * S * 8) & ~15u;
}

// One thread: start the copies of tile t's rows into the buffer.
__device__ __forceinline__ void issue_tile(unsigned char* smem, const TileLayout& L,
                                           uint64_t* bar, long t, int V, int S, int G,
                                           const float4* n, const float4* mix, const float4* gz,
                                           const int* tau) {
  const int rows = tile_rows_in(t, V);
  const long v0 = t * kTile;
  const uint32_t row_bytes = static_cast<uint32_t>(rows) * S * 16;
  const uint32_t gz_bytes = static_cast<uint32_t>(rows) * G * 16;
  const uint32_t tau_bytes = tau_bulk_bytes(tau + v0 * G, rows, G);
  TileRows r = tile_rows(smem, L);
  mbar_expect_tx(bar, 2 * row_bytes + gz_bytes + tau_bytes);
  bulk_load(const_cast<float4*>(r.n), n + v0 * S, row_bytes, bar);
  bulk_load(r.mix, mix + v0 * S, row_bytes, bar);
  bulk_load(const_cast<float4*>(r.gz), gz + v0 * G, gz_bytes, bar);
  if (tau_bytes) bulk_load(r.tau, tau + v0 * G, tau_bytes, bar);
}

// After the wait: warp w loads the words of its tau row the bulk copy left
// out (only on a ragged last tile), then syncs the warp.
__device__ __forceinline__ void tau_tail(int* tau_s, const int* tau, long t, int rows, int G,
                                         int w, int lane) {
  const int bulk_words = static_cast<int>(tau_bulk_bytes(tau + t * kTile * G, rows, G) / 4);
  if (bulk_words < rows * G) {
    for (int k = lane; k < G; k += kWarp) {
      const int i = w * G + k;
      if (i >= bulk_words) tau_s[i] = tau[t * kTile * G + i];
    }
  }
  __syncwarp();
}

// After the wait: warp w loads the cells of its n_val and b_idx rows the
// bulk copies left out (only on a ragged last tile where rows * S is odd:
// the tile's last cell), then syncs the warp.
__device__ __forceinline__ void pair_tail(float2* n_val_s, int2* b_idx_s, const float2* n_val,
                                          const int2* b_idx, long t, int rows, int S, int w,
                                          int lane) {
  const int bulk_cells = static_cast<int>(pair_bulk_bytes(rows, S) / 8);
  if (bulk_cells < rows * S) {
    for (int s = lane; s < S; s += kWarp) {
      const int i = w * S + s;
      if (i >= bulk_cells) {
        n_val_s[i] = n_val[t * kTile * S + i];
        b_idx_s[i] = b_idx[t * kTile * S + i];
      }
    }
  }
  __syncwarp();
}

// gamma [S,G] from device memory into shared memory as [G][S]: the lanes
// of a warp then read neighbouring words of one strain's column.
__device__ __forceinline__ void stage_gamma_t(float* gamma_t, const float* gamma, int S,
                                              int G) {
  for (int i = threadIdx.x; i < S * G; i += blockDim.x) {
    const int s = i / G;
    gamma_t[(i - s * G) * S + s] = gamma[i];
  }
}

// Registers, local (spill) bytes, resident blocks a SM and SMs of a kernel
// at this dynamic shared memory on the current device: out[0..3]. First it
// opts the kernel in to kSmemLimit bytes of dynamic shared memory (above
// 48 KB a launch needs it), once for every size a plan may ask for, so the
// launches that follow need no attribute call of their own.
template <typename Kernel>
inline cudaError_t kernel_info(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[3], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}

// The launch's checks: the plan is TileLayout's, within the card's shared
// memory, and the grid (ops/tau_kernel.py's resident_grid: SMs x resident
// blocks from kernel_info, no more than the tiles) is at least one block.
inline bool plan_ok(const TileLayout& L, int staged, int smem_bytes, int grid) {
  return (staged == 0 || staged == 1) && L.bytes == static_cast<size_t>(smem_bytes) &&
         L.bytes <= kSmemLimit && grid > 0;
}

}  // namespace desman
