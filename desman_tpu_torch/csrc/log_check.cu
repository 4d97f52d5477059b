// The check of warp.cuh's log_normal against the IEEE logf: every float
// whose bits lie in [lo, hi] goes through both, and the launch counts the
// floats where the two differ in any bit (and keeps the smallest such bit
// pattern). Only kernel_bench calls it; atomics are fine here, the count
// does not depend on their order.
#include <cstdint>

#include <cuda_runtime.h>

#include "warp.cuh"

namespace desman {
namespace {

__global__ void __launch_bounds__(256)
log_mismatch_kernel(uint32_t lo, uint32_t hi, unsigned long long* count, uint32_t* first) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  unsigned long long mine = 0;
  uint32_t least = 0xffffffffu;
  for (uint64_t b = lo + static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x; b <= hi;
       b += stride) {
    const float x = __uint_as_float(static_cast<uint32_t>(b));
    if (__float_as_uint(log_normal(x)) != __float_as_uint(logf(x))) {
      ++mine;
      least = min(least, static_cast<uint32_t>(b));
    }
  }
  if (mine) {
    atomicAdd(count, mine);
    atomicMin(first, least);
  }
}

}  // namespace
}  // namespace desman

// out: a device buffer of one u64 (the count of mismatching floats) and one
// u32 (the least mismatching bit pattern, 0xffffffff if none), which the
// caller zeroes / fills first. Launches on `stream`; returns the launch's
// cudaError_t.
extern "C" int desman_log_mismatches(unsigned lo, unsigned hi, void* out, void* stream) {
  auto* count = static_cast<unsigned long long*>(out);
  auto* first = reinterpret_cast<uint32_t*>(count + 1);
  desman::log_mismatch_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi, count, first);
  return static_cast<int>(cudaGetLastError());
}
