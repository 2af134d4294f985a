// Voxel deposit kernel for Hopper (sm_90a): tally[idx[i]] += val[i] for
// every val[i] > 0, in place; with SIGNED for every finite val[i] != 0.
//
// Replaces rsmcrt_tpu/transport/deposit.py::_deposit_kernel (reached through
// deposit_delta), which accumulates per-chunk deposits into a VMEM-resident
// delta grid with one-hot matmuls.  Here the contract is the same sum, but
// added straight into the running tally instead of into a fresh delta grid:
// that saves zeroing and re-adding the whole grid (32 MB at 200^3) on every
// call.  The transport engine uses it for all three voxel tallies (fluence,
// absorption, emission).
//
// What bounds it on this card: a 200^3 float tally (32 MB) stays resident
// in the 50 MB L2, so the floor is the bytes (each row's index and value
// read once, each touched cell read and written once), but the float
// atomics (RED) come first: spread rows run at the L2's atomic throughput,
// and REDs on one address serialise in one L2 slice.  The main path has
// both shapes: the fluence walk's rows are spread (about one row a cell in
// a warp), and with a point source every live emission row goes to the
// source voxel.
//
// Design, one warp per window of 128 rows:
// - each lane reads 4 consecutive rows with one 16-byte int4 and one float4
//   load (4-byte loads for a short last window or unaligned pointers), and
//   the warp transposes the window through 1 KB of shared memory so that
//   each of the 4 slots holds 32 consecutive rows: one RED instruction then
//   covers neighbouring rows (with rows 4 apart an instruction, the
//   fluence walk's rows took longer on an H100);
// - rows with !(val > 0) (dead and padded lanes, NaN) drop out; a warp
//   whose slot keeps no row issues nothing for it.  SIGNED (the phasor
//   tally's w cos and w sin) keeps every finite val != 0 instead; the
//   merging below depends only on which rows are kept and their indices,
//   never on a value's sign, so a group whose values cancel still issues
//   its RED (of the sum, possibly 0), as the plain twin adds every kept
//   row;
// - equal indices merge inside the thread, then across the warp
//   (warp_combine.cuh): a slot whose kept rows share one index issues one
//   RED (the one-voxel case costs one RED per window instead of 128);
//   a slot whose 32-bucket sketch shows many repeats is grouped with
//   __match_any_sync, one RED per group; any other slot issues one RED per
//   kept row, since MATCH.ANY costs more than the few REDs it would save.
//
// An index outside [0, size) on a kept row is a caller bug: it is never
// written, and is counted into *bad (once per row) so the host can assert it
// stays 0.  round_bf16 rounds each value to bfloat16 (nearest even) before
// any sum, as deposit_delta's dot_dtype=bfloat16 does in the TPU kernel; the
// keep test is made on the float32 value, as there.

#include "warp_combine.cuh"

#define THREADS 256

template <bool SIGNED>
__global__ void __launch_bounds__(THREADS)
    deposit_add_kernel(float* __restrict__ tally,
                       const int32_t* __restrict__ idx,
                       const float* __restrict__ val, int64_t n, int64_t size,
                       int round_bf16, int vec, int32_t* __restrict__ bad) {
  __shared__ __align__(16) int32_t stage_j[THREADS / 32][128];
  __shared__ __align__(16) float stage_v[THREADS / 32][128];
  const int warp = threadIdx.x >> 5;
  const int64_t base = ((int64_t)blockIdx.x * (THREADS / 32) + warp) * 128;
  if (base >= n) return;  // the whole warp
  int32_t j[4];
  float v[4];
  bool ok[4];
  load_slot_rows(idx, val, base, n, vec != 0, 0, stage_j[warp],
                 stage_v[warp], j, v);
  int nbad = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool live =
        SIGNED ? (v[s] != 0.0f && isfinite(v[s])) : v[s] > 0.0f;
    ok[s] = live && j[s] >= 0 && (int64_t)j[s] < size;
    nbad += live && !ok[s];
    if (round_bf16) v[s] = round_to_bf16(v[s]);
  }
  count_bad(nbad, bad);
  combine4(j, v, ok);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    float sum;
    if (warp_combine(j[s], v[s], ok[s], &sum)) atomicAdd(tally + j[s], sum);
  }
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
// is_signed selects the SIGNED instantiation.
extern "C" int rsmcrt_deposit_add(void* tally, const void* idx,
                                  const void* val, int64_t n, int64_t size,
                                  int round_bf16, int is_signed, void* bad,
                                  void* stream) {
  if (n <= 0) return 0;
  // one warp a window: every window is in flight at once
  const int64_t rows_per_block = 128 * (THREADS / 32);
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  const int vec = (((uintptr_t)idx | (uintptr_t)val) & 15u) == 0;
  auto kernel =
      is_signed ? deposit_add_kernel<true> : deposit_add_kernel<false>;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)tally, (const int32_t*)idx, (const float*)val, n, size,
      round_bf16, vec, (int32_t*)bad);
  return (int)cudaGetLastError();
}
