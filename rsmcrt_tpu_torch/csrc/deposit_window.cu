// Windowed voxel deposit kernel for Hopper (sm_90a): N packed deposits
// (ix << 20 | iy << 10 | iz, 1 << 30 = dead) summed into a zeroed
// [nx, ny, nz] grid.
//
// Replaces rsmcrt_tpu/transport/deposit.py::_window_kernel (reached through
// deposit_window_packed).  The TPU kernel walks the chunk's deposits in
// rounds: each round anchors a wx x wy x wz window on the smallest remaining
// key, accumulates every in-window deposit with two one-hot MXU
// contractions into the VMEM-resident grid, and retires them.  Here the
// rounds are kept, but the window is a float array in shared memory and
// the contraction becomes shared-memory atomics:
//
// - one block per chunk of `chunk` keys; blocks run in parallel and meet
//   only in the global float atomics of their flushes;
// - a round's anchor is the block's min remaining key (block reduction);
//   the window origin is clamped into the grid as the TPU kernel does;
// - every remaining deposit inside the window is added into the window
//   with a shared atomicAdd and retired;
// - the flush: each retired deposit's thread takes its window cell with
//   atomicExch(cell, 0); the one that finds it nonzero adds the cell's sum
//   to the grid with one global atomicAdd.  Colliding deposits of a chunk
//   (a photon cloud around the source sends many lanes to the same cells)
//   thus cost one global atomic per distinct cell and round, and the flush
//   touches only the cells the round used, not the whole window;
// - after `max_rounds` rounds the deposits still left (a chunk spread over
//   many windows, e.g. unsorted input) are added by direct global atomics
//   in the same kernel, so the work per block is bounded.
//
// What bounds it: the keys and values are read once (8 bytes a deposit)
// and the grid, zeroed by the caller, is written once; with Morton-sorted
// input a chunk needs one or two rounds, so the kernel moves little more
// than those bytes plus one global atomic per distinct cell of a chunk.
//
// Every non-dead key's value is added, val <= 0 included (the JAX
// contract: only deposit_window_delta masks val <= 0).  A live key that
// decodes outside the grid is never written and is counted into *bad (the
// TPU kernel loops forever on such a key, or drops it when it lies in the
// y padding).  round_bf16 rounds each value to bfloat16 (nearest even)
// before the float sum, as dot_dtype=bfloat16 does in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define WINDOW_DEAD (1 << 30)

__device__ __forceinline__ int block_min(int v, int* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = __reduce_min_sync(0xffffffffu, v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? red[lane] : WINDOW_DEAD;
    w = __reduce_min_sync(0xffffffffu, w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  const int out = red[32];
  __syncthreads();  // red is reused by the next reduction
  return out;
}

// Shared memory layout: window [wx*wy*wz] floats, then per-deposit
// remaining key, value, grid cell and this round's window cell.
__global__ void deposit_window_kernel(float* __restrict__ out,
                                      const int32_t* __restrict__ keys,
                                      const float* __restrict__ val,
                                      int64_t n, int nx, int ny, int nz,
                                      int wx, int wy, int wz, int chunk,
                                      int round_bf16, int max_rounds,
                                      int32_t* __restrict__ bad) {
  extern __shared__ float smem[];
  __shared__ int red[33];
  const int wcells = wx * wy * wz;
  float* win = smem;
  int* key_s = (int*)(win + wcells);
  float* val_s = (float*)(key_s + chunk);
  int* flat_s = (int*)(val_s + chunk);
  int* loc_s = flat_s + chunk;

  const int64_t base = (int64_t)blockIdx.x * chunk;
  for (int c = threadIdx.x; c < wcells; c += blockDim.x) win[c] = 0.0f;
  int local_min = WINDOW_DEAD;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    int k = WINDOW_DEAD;
    float v = 0.0f;
    int f = 0;
    if (base + i < n) {
      k = keys[base + i];
      v = val[base + i];
      if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
      if (k != WINDOW_DEAD) {
        const unsigned u = (unsigned)k;
        const int ix = (int)(u >> 20), iy = (int)((u >> 10) & 1023u),
                  iz = (int)(u & 1023u);
        if (ix >= nx || iy >= ny || iz >= nz) {
          atomicAdd(bad, 1);
          k = WINDOW_DEAD;
        } else {
          f = (ix * ny + iy) * nz + iz;
        }
      }
    }
    key_s[i] = k;
    val_s[i] = v;
    flat_s[i] = f;
    loc_s[i] = -1;
    local_min = min(local_min, k);
  }
  __syncthreads();

  for (int round = 0; round < max_rounds; ++round) {
    const int k0 = block_min(local_min, red);
    if (k0 == WINDOW_DEAD) return;
    const int rx = k0 >> 20, ry = (k0 >> 10) & 1023, rz = k0 & 1023;
    const int bx = max(0, min(rx - wx / 2, nx - wx));
    const int by = max(0, min(ry - wy / 2, ny - wy));
    const int bz = max(0, min(rz - wz / 2, nz - wz));
    local_min = WINDOW_DEAD;
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      const int k = key_s[i];
      if (k == WINDOW_DEAD) continue;
      const int dx = (k >> 20) - bx, dy = ((k >> 10) & 1023) - by,
                dz = (k & 1023) - bz;
      if (dx >= 0 && dx < wx && dy >= 0 && dy < wy && dz >= 0 && dz < wz) {
        const int c = (dx * wy + dy) * wz + dz;
        atomicAdd(win + c, val_s[i]);
        loc_s[i] = c;
        key_s[i] = WINDOW_DEAD;
      } else {
        local_min = min(local_min, k);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      const int c = loc_s[i];
      if (c < 0) continue;
      loc_s[i] = -1;
      const float s = atomicExch(win + c, 0.0f);
      if (s != 0.0f) atomicAdd(out + flat_s[i], s);
    }
    __syncthreads();
  }
  // round cap reached: the rest go straight to the grid
  for (int i = threadIdx.x; i < chunk; i += blockDim.x)
    if (key_s[i] != WINDOW_DEAD) atomicAdd(out + flat_s[i], val_s[i]);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (or
// the error of raising the kernel's dynamic shared-memory limit).
extern "C" int rsmcrt_deposit_window(void* out, const void* keys,
                                     const void* val, int64_t n, int nx,
                                     int ny, int nz, int wx, int wy, int wz,
                                     int chunk, int round_bf16,
                                     int max_rounds, void* bad,
                                     void* stream) {
  if (n <= 0) return 0;
  // the window's floats and four words per deposit of the chunk
  const int64_t smem = (int64_t)wx * wy * wz * 4 + (int64_t)chunk * 16;
  cudaError_t err = cudaFuncSetAttribute(
      deposit_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 512;
  const int64_t blocks = (n + chunk - 1) / chunk;
  deposit_window_kernel<<<(unsigned)blocks, threads, (size_t)smem,
                          (cudaStream_t)stream>>>(
      (float*)out, (const int32_t*)keys, (const float*)val, n, nx, ny, nz,
      wx, wy, wz, chunk, round_bf16, max_rounds, (int32_t*)bad);
  return (int)cudaGetLastError();
}
