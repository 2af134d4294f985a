// Warp-level helpers shared by the deposit kernels (deposit.cu,
// deposit_window.cu): loading a warp's window of 128 deposit rows, the
// merge of equal indices inside a thread and across a warp, and the
// per-warp count of out-of-range rows.
//
// Every helper is called by all 32 lanes of the warp together: the kernels
// keep their control flow warp-uniform up to the atomics.  The value type T
// is float or double (deposit.cu's double instantiation); the window
// kernel takes float only.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FULL_WARP 0xffffffffu

// Rows r .. r + 3 of (idx, val), r = base + 4 * lane, in j[0..3], v[0..3]:
// the warp's window of rows base .. base + 127.  A row at or past `lim`
// reads as (absent_idx, 0).  With `vec` (both pointers 16-byte aligned;
// base is a multiple of 4) a whole window comes in as one int4 load a lane
// and one float4 (float) or two double2 (double) loads, else as scalar
// loads.
__device__ __forceinline__ void load_vals4(const float* __restrict__ val,
                                           int64_t r, float (&v)[4]) {
  const float4 b = *reinterpret_cast<const float4*>(val + r);
  v[0] = b.x; v[1] = b.y; v[2] = b.z; v[3] = b.w;
}

__device__ __forceinline__ void load_vals4(const double* __restrict__ val,
                                           int64_t r, double (&v)[4]) {
  const double2 b0 = *reinterpret_cast<const double2*>(val + r);
  const double2 b1 = *reinterpret_cast<const double2*>(val + r + 2);
  v[0] = b0.x; v[1] = b0.y; v[2] = b1.x; v[3] = b1.y;
}

// Values v[0..3] into stage[4 * t .. 4 * t + 3] with 16-byte stores.
__device__ __forceinline__ void store_vals4(float* stage, int t,
                                            const float (&v)[4]) {
  reinterpret_cast<float4*>(stage)[t] = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_vals4(double* stage, int t,
                                            const double (&v)[4]) {
  reinterpret_cast<double2*>(stage)[2 * t] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(stage)[2 * t + 1] = make_double2(v[2], v[3]);
}

template <typename T>
__device__ __forceinline__ void load_lane_rows(
    const int32_t* __restrict__ idx, const T* __restrict__ val,
    int64_t base, int64_t lim, bool vec, int32_t absent_idx,
    int32_t (&j)[4], T (&v)[4]) {
  const int64_t r = base + 4 * (threadIdx.x & 31);
  if (vec && base + 128 <= lim) {
    const int4 a = *reinterpret_cast<const int4*>(idx + r);
    j[0] = a.x; j[1] = a.y; j[2] = a.z; j[3] = a.w;
    load_vals4(val, r, v);
    return;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool in = r + s < lim;
    j[s] = in ? idx[r + s] : absent_idx;
    v[s] = in ? val[r + s] : T(0);
  }
}

// The warp's window with row base + 32 * s + lane in slot s: each slot
// holds 32 consecutive rows across the warp, so one RED instruction covers
// neighbouring rows.  A full aligned window is read with load_lane_rows's
// 16-byte loads and transposed through the warp's `stage` (128 ints and
// 128 values of shared memory, 16-byte aligned); otherwise each slot is
// one coalesced scalar load.
template <typename T>
__device__ __forceinline__ void load_slot_rows(
    const int32_t* __restrict__ idx, const T* __restrict__ val,
    int64_t base, int64_t lim, bool vec, int32_t absent_idx,
    int32_t* stage_j, T* stage_v, int32_t (&j)[4], T (&v)[4]) {
  const int t = threadIdx.x & 31;
  if (vec && base + 128 <= lim) {
    load_lane_rows(idx, val, base, lim, true, absent_idx, j, v);
    reinterpret_cast<int4*>(stage_j)[t] = make_int4(j[0], j[1], j[2], j[3]);
    store_vals4(stage_v, t, v);
    __syncwarp();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      j[s] = stage_j[32 * s + t];
      v[s] = stage_v[32 * s + t];
    }
    __syncwarp();  // the stage may be refilled after this
    return;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int64_t row = base + 32 * s + t;
    const bool in = row < lim;
    j[s] = in ? idx[row] : absent_idx;
    v[s] = in ? val[row] : T(0);
  }
}

__device__ __forceinline__ float round_to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Adds the warp's sum of `nbad` into *bad, with one atomic from lane 0.
__device__ __forceinline__ void count_bad(int nbad, int32_t* bad) {
  const int n = __reduce_add_sync(FULL_WARP, (unsigned)nbad);
  if (n != 0 && (threadIdx.x & 31) == 0) atomicAdd(bad, n);
}

// Within one thread: a kept row whose index equals an earlier kept row's
// adds its value there and is dropped.
template <typename T>
__device__ __forceinline__ void combine4(const int32_t (&j)[4], T (&v)[4],
                                         bool (&ok)[4]) {
#pragma unroll
  for (int a = 1; a < 4; ++a) {
    bool merged = false;
#pragma unroll
    for (int b = 0; b < a; ++b) {
      if (!merged && ok[a] && ok[b] && j[a] == j[b]) {
        v[b] += v[a];
        merged = true;
      }
    }
    if (merged) ok[a] = false;
  }
}

// The sum of `v` over the lanes of `grp` (a __match_any_sync group that
// holds the calling lane), in lane order; every lane of the group calls it.
template <typename T>
__device__ __forceinline__ T group_sum(unsigned grp, T v) {
  if ((grp & (grp - 1u)) == 0u) return v;
  T s = T(0);
  for (unsigned m = grp; m != 0u; m &= m - 1u)
    s += __shfl_sync(grp, v, __ffs(m) - 1);
  return s;
}

// Warp combining of equal indices: the lanes with `ok` set and equal `j`
// form a group; the group's lowest lane gets the group's sum in *sum and
// returns true, every other lane false.  Three tiers, cheapest first:
// - every kept lane holds one index (__reduce_min_sync and
//   __reduce_max_sync agree): one group, summed by a shuffle tree;
// - a 32-bucket sketch of the kept indices (__reduce_or_sync) shows more
//   than a quarter as many distinct cells as kept rows: the groups are
//   small, and MATCH.ANY would cost more than the atomics it saves (the
//   fluence walk's rows have one row a group), so every kept lane is a
//   group of its own;
// - else __match_any_sync groups the lanes and each group sums with
//   shuffles.
template <typename T>
__device__ __forceinline__ bool warp_combine(int32_t j, T v, bool ok,
                                             T* sum) {
  const int lane = threadIdx.x & 31;
  const unsigned kept = __ballot_sync(FULL_WARP, ok);
  if (kept == 0u) return false;
  const int lo = __reduce_min_sync(FULL_WARP, ok ? j : INT_MAX);
  const int hi = __reduce_max_sync(FULL_WARP, ok ? j : INT_MIN);
  if (lo == hi) {
    T s = ok ? v : T(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_WARP, s, o);
    *sum = s;
    return lane == __ffs(kept) - 1;
  }
  const unsigned bucket = ((unsigned)j * 2654435761u) >> 27;
  const unsigned seen = __reduce_or_sync(FULL_WARP, ok ? 1u << bucket : 0u);
  if (4 * __popc(seen) > __popc(kept)) {
    *sum = v;
    return ok;
  }
  // kept indices are >= 0, so -1 gathers the rest into a group of its own
  const unsigned grp = __match_any_sync(FULL_WARP, ok ? j : -1);
  if (!ok) return false;
  *sum = group_sum(grp, v);
  return lane == __ffs(grp) - 1;
}
