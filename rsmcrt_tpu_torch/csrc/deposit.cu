// Voxel deposit kernel for Hopper (sm_90a): tally[idx[i]] += val[i] for
// every val[i] > 0, in place.
//
// Replaces rsmcrt_tpu/transport/deposit.py::_deposit_kernel (reached through
// deposit_delta), which accumulates per-chunk deposits into a VMEM-resident
// delta grid with one-hot matmuls.  Here the contract is the same sum, but
// added straight into the running tally instead of into a fresh delta grid:
// that saves zeroing and re-adding the whole grid (32 MB at 200^3) on every
// call.  The transport engine uses it for all three voxel tallies (fluence,
// absorption, emission).
//
// Design: one thread per deposit in a grid-stride loop, skipping val <= 0
// (dead and padded lanes, and NaN), with a float atomicAdd into global
// memory.  A 200^3 float tally (32 MB) stays resident in the 50 MB L2, so
// the kernel is bound by L2 atomic throughput on colliding voxels (a photon
// cloud around the source sends many lanes to the same cells).
// Later work could try warp-level aggregation of equal indices before the
// atomic, or shared-memory accumulation of axis-aligned supertiles in the
// spirit of the TPU kernel, flushed with one atomic per touched cell.
//
// An index outside [0, size) with val > 0 is a caller bug: it is never
// written, and is counted into *bad so the host can assert it stays 0.
// round_bf16 rounds each value to bfloat16 (nearest even) before the float
// sum, as deposit_delta's dot_dtype=bfloat16 does in the TPU kernel; the
// val > 0 test is made on the float32 value, as there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void deposit_add_kernel(float* __restrict__ tally,
                                   const int32_t* __restrict__ idx,
                                   const float* __restrict__ val,
                                   int64_t n, int64_t size,
                                   int round_bf16,
                                   int32_t* __restrict__ bad) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = val[i];
    if (!(v > 0.0f)) continue;
    const int32_t j = idx[i];
    if (j < 0 || (int64_t)j >= size) {
      atomicAdd(bad, 1);
      continue;
    }
    atomicAdd(tally + j,
              round_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v);
  }
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int rsmcrt_deposit_add(void* tally, const void* idx,
                                  const void* val, int64_t n, int64_t size,
                                  int round_bf16, void* bad, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // enough resident blocks to fill 132 SMs; the loop strides over the rest
  const int64_t max_blocks = 132 * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  deposit_add_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
      (float*)tally, (const int32_t*)idx, (const float*)val, n, size,
      round_bf16, (int32_t*)bad);
  return (int)cudaGetLastError();
}
