// Voxel deposit kernel for Hopper (sm_90a): tally[idx[i]] += val[i] for
// every val[i] > 0, in place; with SIGNED for every finite val[i] != 0.
// One template over the value type: float (every run's tallies) and double
// (a float64 run's).  Beside it, deposit_gather_kernel, its backward.
//
// Replaces rsmcrt_tpu/transport/deposit.py::_deposit_kernel (reached through
// deposit_delta), which accumulates per-chunk deposits into a VMEM-resident
// delta grid with one-hot matmuls.  Here the contract is the same sum, but
// added straight into the running tally instead of into a fresh delta grid:
// that saves zeroing and re-adding the whole grid (32 MB at 200^3) on every
// call.  The transport engine uses it for all three voxel tallies (fluence,
// absorption, emission).
//
// What bounds it on this card (an H100: 50 MB L2, 3.35 TB/s).  The floor
// is the bytes (each row's index and value read once, each touched cell
// read and written once), but memory moves in 32-byte sectors, and what
// sets the time is how many distinct sectors the rows touch and whether
// they are still in the L2 when their REDs arrive.  The float atomics
// (RED) come first where the tally stays resident: spread rows then run at
// the L2's atomic throughput, and REDs on one address serialise in one L2
// slice.  The main path has both shapes: the fluence walk's rows are
// spread (about one row a cell in a warp), and with a point source every
// live emission row goes to the source voxel.
// - float: the fluence walk's 2,097,152 captured rows touch 562,398
//   sectors (18 MB) of the 200^3 tally (32 MB); launched back to back
//   they stay in the L2 (0.025 ms), but behind 128 MB of other traffic
//   the same launch takes 0.049 ms, as a megastep's other kernels leave
//   the L2.
// - double: the 200^3 float64 tally (64 MB) does not fit the L2, and the
//   same rows touch 796,834 sectors (25.5 MB), 1.42x the float's.  The
//   RED is a native REDG.E.ADD.F64 (the SASS), and the type does not
//   matter: the float kernel with the indices doubled into a 64 MB span
//   takes as long (0.0505 ms), while the double rows folded into 100^3
//   (8 MB, 229,961 sectors) take the float's 0.025 ms.  Shuffled rows
//   (the same sectors, no order) take 0.061.  So the double deposit is
//   bound by the random read-modify-write of its touched sectors in
//   device memory: 0.067 ms with the L2 cold, where the float takes 0.049
//   (about the ratio of their sectors).  Passes over slices of the tally
//   (each fitting the L2) do not help: 2-4 passes take 0.066-0.089 ms
//   when each re-reads the rows, 0.057-0.067 even when each is handed
//   only its slice's rows.
//   (Numbers: rsmcrt_tpu_torch/profile_deposit.py, H100 80GB HBM3, 700 W.)
//
// Design, one warp per window of 128 rows:
// - each lane reads 4 consecutive rows with one 16-byte int4 and one float4
//   load (two double2 in double; scalar loads for a short last window or
//   unaligned pointers), and the warp transposes the window through 1 KB
//   (1.5 KB in double) of shared memory so that
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
// - double only (the float path keeps the design above): the rows are
//   read with streaming loads (evict-first), so that the 25 MB of rows,
//   read once, do not push the tally's sectors out of the L2; and a slot
//   whose kept rows share one index hands its sum to the block, whose 32
//   such sums (8 warps x 4 slots) warp 0 merges as one warp's rows: a hot
//   cell takes one RED a block of 1,024 rows, not one a window (the
//   one-voxel input 0.0095 ms against 0.0320, the captured rows 0.0514
//   against 0.0555, in turns with the earlier double kernel; with the L2
//   cold both take 0.067).
//
// An index outside [0, size) on a kept row is a caller bug: it is never
// written, and is counted into *bad so the host can assert it stays 0.
// round_bf16 rounds each value to bfloat16 (nearest even) before any sum,
// as deposit_delta's dot_dtype=bfloat16 does in the TPU kernel; the keep
// test is made on the float32 value, as there.  The double instantiation
// never rounds (the wrapper refuses bfloat16 with a float64 tally).
//
// The backward, deposit_gather_kernel: the transpose of the deposit's sum
// (what XLA's scatter-add gives the reference's gradient): grad_val[i] =
// grad_tally[idx[i]] for every row the forward keeps, 0 for every other row
// and for a row whose index is out of range.  A gather sums nothing, so it
// equals its plain twin exactly.  What bounds it: the rows stream in and
// the gradients out (12 or 20 bytes a row), and each kept row reads one
// random cell of grad_tally, a 32-byte sector of its own unless a
// neighbouring row shares it (562,398 or 796,834 sectors for the captured
// rows, f32 or f64).  The design reads the rows as the deposit does (one
// warp a window, 16-byte loads, the transpose), so that a grad_tally load
// instruction covers 32 consecutive rows of one ray, and each lane keeps
// four independent loads in flight; rows and gradients take streaming
// loads and stores.  The backward of a sum hands an expanded gradient
// (stride 0): the kernel reads grad_tally[j * stride], so it is read as
// its one value, never materialised (the earlier kernel's wrapper first
// wrote the whole 32-64 MB grid).  On the captured rows the gather takes
// 0.0201 ms (f32; 0.0346 f64) against 0.0207 (0.0362) for one thread a
// row and 0.0220 (0.0350) for one index_select; on the backward's own
// 262,144 rows with their expanded gradient 0.0031 (0.0033) against
// 0.0254 (0.0274) (profile_deposit.py, H100 80GB HBM3, 700 W).

#include "warp_combine.cuh"

#define THREADS 256

template <typename T, bool SIGNED>
__device__ __forceinline__ bool kept(T v) {
  return SIGNED ? (v != T(0) && isfinite(v)) : v > T(0);
}

template <typename T, bool SIGNED>
__global__ void __launch_bounds__(THREADS)
    deposit_add_kernel(T* __restrict__ tally,
                       const int32_t* __restrict__ idx,
                       const T* __restrict__ val, int64_t n, int64_t size,
                       int round_bf16, int vec, int32_t* __restrict__ bad) {
  // the double path: streaming row loads, and one-index slots merged
  // across the block (below)
  constexpr bool WIDE = sizeof(T) == 8;
  __shared__ __align__(16) int32_t stage_j[THREADS / 32][128];
  __shared__ __align__(16) T stage_v[THREADS / 32][128];
  __shared__ int32_t block_j[THREADS / 32 * 4];
  __shared__ T block_v[THREADS / 32 * 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base = ((int64_t)blockIdx.x * (THREADS / 32) + warp) * 128;
  if constexpr (!WIDE) {
    if (base >= n) return;  // the whole warp
  }
  int32_t j[4];
  T v[4];
  bool ok[4];
  load_slot_rows<T, WIDE>(idx, val, base, n, vec != 0, 0, stage_j[warp],
                          stage_v[warp], j, v);
  int nbad = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool live = kept<T, SIGNED>(v[s]);
    ok[s] = live && j[s] >= 0 && (int64_t)j[s] < size;
    nbad += live && !ok[s];
    if (round_bf16) v[s] = (T)round_to_bf16((float)v[s]);
  }
  count_bad(nbad, bad);
  combine4(j, v, ok);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    T sum;
    if constexpr (WIDE) {
      // a slot whose kept rows share one index hands its sum to the block
      const int32_t one = warp_one_index(j[s], ok[s]);
      if (lane == 0) block_j[4 * warp + s] = one;
      if (one >= 0) {
        sum = warp_sum(ok[s] ? v[s] : T(0));
        if (lane == 0) block_v[4 * warp + s] = sum;
        continue;
      }
    }
    if (warp_combine(j[s], v[s], ok[s], &sum)) atomicAdd(tally + j[s], sum);
  }
  if constexpr (WIDE) {
    // the block's 32 one-index slot sums, merged by warp 0 as one warp's
    // rows: a hot cell takes one RED a block, not one a slot
    __syncthreads();
    if (warp == 0) {
      const int32_t bj = block_j[lane];
      T sum;
      if (warp_combine(bj, block_v[lane], bj >= 0, &sum))
        atomicAdd(tally + bj, sum);
    }
  }
}

// One warp a window of 128 rows, read as the deposit reads them
// (load_slot_rows, streaming): slot s of lane t is row base + 32 s + t, so
// each grad_tally load instruction covers 32 consecutive rows (neighbouring
// cells of one ray share their sectors) and the four loads of a lane are
// independent, all in flight together; the gradients go out as coalesced
// streaming stores.  With stride 0 (the backward of a sum hands an expanded
// gradient) every load reads grad_tally[0].
template <typename T, bool SIGNED>
__global__ void __launch_bounds__(THREADS)
    deposit_gather_kernel(T* __restrict__ grad_val,
                          const T* __restrict__ grad_tally, int64_t stride,
                          const int32_t* __restrict__ idx,
                          const T* __restrict__ val, int64_t n,
                          int64_t size, int vec) {
  __shared__ __align__(16) int32_t stage_j[THREADS / 32][128];
  __shared__ __align__(16) T stage_v[THREADS / 32][128];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t base = ((int64_t)blockIdx.x * (THREADS / 32) + warp) * 128;
  if (base >= n) return;  // the whole warp
  int32_t j[4];
  T v[4], out[4];
  load_slot_rows<T, true>(idx, val, base, n, vec != 0, -1, stage_j[warp],
                          stage_v[warp], j, v);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool ok =
        kept<T, SIGNED>(v[s]) && j[s] >= 0 && (int64_t)j[s] < size;
    out[s] = ok ? grad_tally[(int64_t)j[s] * stride] : T(0);
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int64_t row = base + 32 * s + lane;
    if (row < n) __stcs(grad_val + row, out[s]);
  }
}

template <typename T>
static int launch_add(void* tally, const void* idx, const void* val,
                      int64_t n, int64_t size, int round_bf16,
                      int is_signed, void* bad, void* stream) {
  // one warp a window: every window is in flight at once
  const int64_t rows_per_block = 128 * (THREADS / 32);
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  const int vec = (((uintptr_t)idx | (uintptr_t)val) & 15u) == 0;
  auto kernel = is_signed ? deposit_add_kernel<T, true>
                          : deposit_add_kernel<T, false>;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (T*)tally, (const int32_t*)idx, (const T*)val, n, size, round_bf16,
      vec, (int32_t*)bad);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_gather(void* grad_val, const void* grad_tally,
                         int64_t stride, const void* idx, const void* val,
                         int64_t n, int64_t size, int is_signed,
                         void* stream) {
  const int64_t rows_per_block = 128 * (THREADS / 32);
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  const int vec = (((uintptr_t)idx | (uintptr_t)val) & 15u) == 0;
  auto kernel = is_signed ? deposit_gather_kernel<T, true>
                          : deposit_gather_kernel<T, false>;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (T*)grad_val, (const T*)grad_tally, stride, (const int32_t*)idx,
      (const T*)val, n, size, vec);
  return (int)cudaGetLastError();
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
// is_signed selects the SIGNED instantiation, is_double the double one
// (tally and val both double; round_bf16 must then be 0).
extern "C" int rsmcrt_deposit_add(void* tally, const void* idx,
                                  const void* val, int64_t n, int64_t size,
                                  int round_bf16, int is_signed,
                                  int is_double, void* bad, void* stream) {
  if (n <= 0) return 0;
  if (is_double) {
    if (round_bf16) return (int)cudaErrorInvalidValue;
    return launch_add<double>(tally, idx, val, n, size, 0, is_signed, bad,
                              stream);
  }
  return launch_add<float>(tally, idx, val, n, size, round_bf16, is_signed,
                           bad, stream);
}

// The backward of rsmcrt_deposit_add: grad_val[i] = grad_tally[idx[i] *
// grad_stride] on the rows the forward keeps (the same is_signed test), 0
// elsewhere.  grad_stride is 1 (a contiguous gradient) or 0 (one value for
// every cell).  Launches on `stream`; returns cudaGetLastError() after the
// launch.
extern "C" int rsmcrt_deposit_gather(void* grad_val, const void* grad_tally,
                                     int64_t grad_stride, const void* idx,
                                     const void* val, int64_t n, int64_t size,
                                     int is_signed, int is_double,
                                     void* stream) {
  if (n <= 0) return 0;
  if (grad_stride != 0 && grad_stride != 1)
    return (int)cudaErrorInvalidValue;
  if (is_double)
    return launch_gather<double>(grad_val, grad_tally, grad_stride, idx, val,
                                 n, size, is_signed, stream);
  return launch_gather<float>(grad_val, grad_tally, grad_stride, idx, val, n,
                              size, is_signed, stream);
}
