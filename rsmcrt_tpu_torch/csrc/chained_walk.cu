// The chained walk of a megastep for Hopper (sm_90a): all K rounds of
// transport/engine.py::_torch_rounds in one kernel, one thread a lane, the
// lane's state in registers (the round's arithmetic: chained_walk.cuh).
//
// Replaces no TPU kernel: the JAX package's chained walk
// (rsmcrt_tpu/transport/engine.py::_chained_dda) is a lax.fori_loop of
// array operations that XLA fuses on the TPU.  The port ran the same rounds
// as PyTorch operations, about 600-750 kernels a round at K = 64, so some
// 36,000-41,000 kernels of about 1.6 us each made up 98% of a megastep's
// device time even when replayed from a CUDA graph.
//
// What bounds it on this card (an H100: 3.35 TB/s, 67 TFLOP/s in float32):
// not the bytes.  At 32,768 lanes and K = 64 a megastep reads the uniforms
// (32 MiB), writes the fluence rows (16 MiB) and reads and writes the lane
// state once (~3 MB): ~15 us at 3.35 TB/s, and ~35 us with a detector
// bank's segment rows (48 MiB more).  A round is a few hundred dependent
// float32 operations per lane (divisions, square roots, a log, a sine and
// a cosine), so the walk is bound by the latency of each lane's serial
// chain at the few warps a lane width gives each SM (32,768 lanes are 7.75
// warps an SM; the 4,096-lane tail under one), and by branch divergence
// between lanes that scatter and lanes at a surface.  Measured on an H100
// 80GB HBM3 at 700 W: 0.25-0.43 ms a walk at 32,768 lanes (4-7% of the
// byte bound), 96 registers a thread.
//
// Design: a lane never leaves its thread, so nothing of its state goes to
// memory between rounds; the three event counts are reduced in the block
// (warp shuffles, then shared memory) and added with one atomic a count and
// block.  A surface's normal, nudge probe and Fresnel branch, and a
// scatter's new direction, are computed only in the lanes that have one.
// The file is built with -fmad=false (_build.FILE_FLAGS), so that no
// multiply-add is fused where the PyTorch rounds round twice: the kernel's
// lanes can be compared with theirs lane by lane.

#include <cuda_runtime.h>

#include "chained_walk.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    chained_walk_kernel(const rsmcrt_walk::WalkArgs a) {
  const int64_t b = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  rsmcrt_walk::LaneCounts c{0, 0, 0};
  if (b < a.B) rsmcrt_walk::walk_lane(a, b, c);
  for (int off = 16; off > 0; off >>= 1) {
    c.scat += __shfl_down_sync(0xffffffffu, c.scat, off);
    c.inter += __shfl_down_sync(0xffffffffu, c.inter, off);
    c.resp += __shfl_down_sync(0xffffffffu, c.resp, off);
  }
  __shared__ int32_t part[THREADS / 32][3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[warp][0] = c.scat;
    part[warp][1] = c.inter;
    part[warp][2] = c.resp;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int32_t s = 0;
    for (int w = 0; w < THREADS / 32; ++w) s += part[w][threadIdx.x];
    if (s != 0) atomicAdd(a.o_counts + threadIdx.x, s);
  }
}

__global__ void arith_kernel(const float* x, int64_t n, float s,
                             float* sums, float* quots) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  sums[i] = rsmcrt_walk::sum3(x[3 * i], x[3 * i + 1], x[3 * i + 2]);
  quots[i] = rsmcrt_walk::div_scalar(x[3 * i], s);
}

}  // namespace

// sizeof(WalkArgs), for the wrapper to check its ctypes layout against.
extern "C" int64_t rsmcrt_chained_walk_args_size() {
  return (int64_t)sizeof(rsmcrt_walk::WalkArgs);
}

// Loads the kernel's module, so that a CUDA graph capture never has to.
// Returns the CUDA error.
extern "C" int rsmcrt_chained_walk_prepare() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, chained_walk_kernel);
}

// One walk of a.B lanes on `stream`; a.o_counts must hold zeros (the
// kernel adds to it).  Returns cudaGetLastError() after the launch.
extern "C" int rsmcrt_chained_walk(const rsmcrt_walk::WalkArgs* a,
                                   void* stream) {
  if (a->B <= 0) return 0;
  const unsigned blocks = (unsigned)((a->B + THREADS - 1) / THREADS);
  chained_walk_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// The two operations whose order follows PyTorch's CUDA kernels, for the
// test that holds them against the installed PyTorch: for i < n,
// sums[i] = sum3(x[3i], x[3i+1], x[3i+2]) and quots[i] = div_scalar(x[3i], s).
extern "C" int rsmcrt_chained_walk_arith(const float* x, int64_t n, float s,
                                         float* sums, float* quots,
                                         void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  arith_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(x, n, s, sums,
                                                             quots);
  return (int)cudaGetLastError();
}
