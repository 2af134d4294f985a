// Windowed voxel deposit kernel for Hopper (sm_90a): N packed deposits
// (ix << 20 | iy << 10 | iz, 1 << 30 = dead) summed into a zeroed
// [nx, ny, nz] grid.
//
// Replaces rsmcrt_tpu/transport/deposit.py::_window_kernel (reached through
// deposit_window_packed).  The TPU kernel walks each chunk's deposits in
// rounds: a round anchors a wx x wy x wz window on the smallest remaining
// key, accumulates every in-window deposit with two one-hot MXU
// contractions into the VMEM-resident grid, and retires them.  The point
// of it is that colliding deposits of a chunk reach the grid once.
//
// What bounds it on this card: the bytes (each key and value read once, the
// fresh grid zeroed by the caller and written once), and before them the
// global float atomics (RED): one per deposit if nothing is merged, and
// REDs on one address serialise in one L2 slice.  A dense window in shared
// memory (32^3 floats = 128 KB) would keep one block an SM, spend most of
// its time zeroing cells no deposit touches, and need rounds with block-wide
// barriers; unsorted input would run every round.  The caller's zeroing of
// the fresh grid (32 MB at 200^3, ~0.01 ms on an H100) is a fixed part of
// every call.
//
// Design: one block per chunk of `chunk` keys aggregates the chunk in one
// pass through a shared-memory open-addressing hash table keyed by the flat
// cell (`slots` = a power of two, about 2x the chunk, at most 4096 slots =
// 32 KB, so four blocks of 512 threads fit an SM):
// - each lane takes 4 consecutive keys and values of a warp's window of
//   128 (one 16-byte int4 and one float4 load when aligned), decodes them,
//   and merges equal cells inside the thread (runs of a sorted chunk) and
//   across the warp (warp_combine.cuh), as deposit.cu does;
// - each group's lowest lane inserts its sum: atomicCAS claims the key
//   slot (linear probing), atomicAdd adds the value;
// - a row that finds no slot within PROBES probes (a chunk with more
//   distinct cells than the table holds) goes straight to the grid with one
//   RED, so no input needs more than the one pass;
// - after one barrier, each occupied slot is flushed with one RED.
//
// Every non-dead key's value is added, val <= 0 included (the JAX
// contract: only deposit_window_delta masks val <= 0).  A live key that
// decodes outside the grid is never written and is counted into *bad (the
// TPU kernel loops forever on such a key, or drops it when it lies in the
// y padding).  round_bf16 rounds each value to bfloat16 (nearest even)
// before any sum, as dot_dtype=bfloat16 does in the TPU kernel.

#include "warp_combine.cuh"

#define WINDOW_DEAD (1 << 30)
#define EMPTY_SLOT (-1)
#define PROBES 32

// Adds s into the table slot of cell f; false when PROBES probes found
// neither f nor a free slot.
__device__ __forceinline__ bool table_add(int* tkey, float* tval,
                                          int slot_bits, int f, float s) {
  const unsigned mask = (1u << slot_bits) - 1u;
  // consecutive cells take consecutive slots, so the flush's REDs from 32
  // neighbouring slots hit neighbouring cells; each run of 2^slot_bits
  // cells starts at a scrambled offset
  const unsigned h = (unsigned)f + ((unsigned)f >> slot_bits) * 2654435761u;
  for (int p = 0; p < PROBES; ++p) {
    const unsigned slot = (h + p) & mask;
    int cur = ((volatile int*)tkey)[slot];
    if (cur == EMPTY_SLOT) cur = atomicCAS(tkey + slot, EMPTY_SLOT, f);
    if (cur == EMPTY_SLOT || cur == f) {
      atomicAdd(tval + slot, s);
      return true;
    }
  }
  return false;
}

// Shared memory: `1 << slot_bits` int keys, then as many float sums.
__global__ void __launch_bounds__(512)
    deposit_window_kernel(float* __restrict__ out,
                          const int32_t* __restrict__ keys,
                          const float* __restrict__ val, int64_t n, int nx,
                          int ny, int nz, int chunk, int slot_bits,
                          int round_bf16, int vec, int32_t* __restrict__ bad) {
  extern __shared__ int smem[];
  const int slots = 1 << slot_bits;
  int* tkey = smem;
  float* tval = (float*)(smem + slots);
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    tkey[s] = EMPTY_SLOT;
    tval[s] = 0.0f;
  }
  __syncthreads();

  const int64_t base = (int64_t)blockIdx.x * chunk;
  const int64_t lim = base + chunk < n ? base + chunk : n;
  // each warp takes windows of 128 rows (chunk is a multiple of 128)
  for (int w = threadIdx.x >> 5; w < chunk / 128; w += blockDim.x >> 5) {
    int32_t f[4];
    float v[4];
    bool ok[4];
    load_lane_rows(keys, val, base + 128 * w, lim, vec != 0, WINDOW_DEAD, f,
                   v);
    int nbad = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const unsigned u = (unsigned)f[s];
      const int ix = (int)(u >> 20), iy = (int)((u >> 10) & 1023u),
                iz = (int)(u & 1023u);
      const bool live = f[s] != WINDOW_DEAD;
      ok[s] = live && ix < nx && iy < ny && iz < nz;
      nbad += live && !ok[s];
      f[s] = ok[s] ? (ix * ny + iy) * nz + iz : 0;
      if (round_bf16) v[s] = round_to_bf16(v[s]);
    }
    count_bad(nbad, bad);
    combine4(f, v, ok);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float sum;
      if (warp_combine(f[s], v[s], ok[s], &sum) &&
          !table_add(tkey, tval, slot_bits, f[s], sum))
        atomicAdd(out + f[s], sum);
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < slots; s += blockDim.x) {
    const int c = tkey[s];
    if (c != EMPTY_SLOT) atomicAdd(out + c, tval[s]);
  }
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `chunk` is a multiple of 128; the table has 1 << slot_bits slots.
extern "C" int rsmcrt_deposit_window(void* out, const void* keys,
                                     const void* val, int64_t n, int nx,
                                     int ny, int nz, int chunk, int slot_bits,
                                     int round_bf16, void* bad,
                                     void* stream) {
  if (n <= 0) return 0;
  const int threads = chunk / 4 < 512 ? chunk / 4 : 512;
  const int64_t blocks = (n + chunk - 1) / chunk;
  const size_t smem = (size_t)8 << slot_bits;
  const int vec = (((uintptr_t)keys | (uintptr_t)val) & 15u) == 0;
  deposit_window_kernel<<<(unsigned)blocks, threads, smem,
                          (cudaStream_t)stream>>>(
      (float*)out, (const int32_t*)keys, (const float*)val, n, nx, ny, nz,
      chunk, slot_bits, round_bf16, vec, (int32_t*)bad);
  return (int)cudaGetLastError();
}
