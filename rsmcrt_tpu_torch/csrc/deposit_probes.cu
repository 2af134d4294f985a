// The two deposit design probes of the TPU tools, as kernels for Hopper
// (sm_90a):
//
// - serial_deposit_kernel replaces tools/profile_deposit_pallas_serial.py::
//   _kernel (reached through serial_deposit): a zeroed [ceil(G/128), 128]
//   float grid to which row j of the first (N // block) * block rows adds
//   val[j] at flat cell idx[j].  On the TPU each row is a read-modify-write
//   of one (1, 128) VMEM row with a one-hot add, one row after another, to
//   measure the serial cost of dependent dynamic VMEM accesses.
// - onehot_tile_kernel replaces tools/profile_deposit_design.py::kern: the
//   [H, 128] tile sum over chunks of (onehot(hi, H) * v)^T @ onehot(lo, 128),
//   that is tile[hi, lo] += v for every row, a row with hi outside [0, H) or
//   lo outside [0, 128) adding nothing.  On the TPU the chunk's two one-hot
//   matrices go through the MXU and the tile is carried in VMEM scratch
//   from one grid step to the next.
//
// Neither kernel copies its TPU design.  The one-hot matrices exist to give
// the TPU's vector and matrix units a dense form of a scatter; on this card
// the scatter is native: a float RED (atomicAdd whose result is unused)
// adds one value at one address in the L2.  The TPU's one-hot product of a
// chunk of C rows spends C * H * 128 multiply-adds (26.8 G for the tool's
// 524,288 rows into a 400 x 128 tile); the kernel spends one RED a row.
//
// What bounds them on this card (an H100: 50 MB L2, 3.35 TB/s): the bytes,
// each row read once (8 bytes a row for serial_deposit, 12 for the tile) and
// the output written once (the 200^3 grid of the serial tool is 32 MB, the
// tile 204,800 bytes).  Both outputs fit in the L2, so the REDs of random
// rows land there; the zeroing of the output (cudaMemsetAsync, before the
// rows) writes it once.
//
// Design: one thread takes 4 consecutive rows with 16-byte loads (scalar
// loads for the ragged end or unaligned pointers), streaming, since each row
// is read once and should not push the output out of the L2; each row that
// adds a non-zero value issues one RED.  A row whose value is 0 adds
// nothing (the output starts at +0.0, and +0.0 + -0.0 is +0.0), so it
// issues none.  A non-finite value reaches only its own cell: the one-hot
// product of a row with v = inf or NaN spreads NaN (v * 0) along the row's
// tile row hi, while the serial row add puts it in its cell only, as here.
//
// The tile could instead be summed in one block's shared memory (204,800
// bytes fit the 227 KB a block may take) and merged into device memory
// once.  At the tool's size that saves nothing: a block's share of the rows
// (about 4,000 of 524,288 over the 132 SMs) touches about as many distinct
// cells of the 51,200, so the merge issues as many REDs as the rows do,
// after zeroing and reading back 51,200 shared cells a block, with one
// block an SM.  It pays only when a block's rows outnumber the tile's cells
// many times over.
//
// serial_deposit counts a row whose cell lies outside [0, size) (the padded
// grid) into the int32 word after the grid and never writes it: on the TPU
// such a row reads and writes outside its VMEM buffer.  The tile drops its
// out-of-range rows without counting them, as the one-hot product does.

#include "warp_combine.cuh"

#define PROBE_THREADS 256

// Rows r .. r + 3 of a with one 16-byte streaming load when `vec` (the
// pointer is 16-byte aligned; r is a multiple of 4) and all four are below
// `lim`, else scalar loads; a row at or past `lim` reads as `absent`.
template <typename T, typename V>
__device__ __forceinline__ void load4(const T* __restrict__ a, int64_t r,
                                      int64_t lim, bool vec, T absent,
                                      T (&x)[4]) {
  if (vec && r + 4 <= lim) {
    const V b = __ldcs(reinterpret_cast<const V*>(a + r));
    x[0] = b.x; x[1] = b.y; x[2] = b.z; x[3] = b.w;
    return;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) x[s] = r + s < lim ? __ldcs(a + r + s) : absent;
}

// out[idx[j]] += val[j] for every j < n whose index lies in [0, size);
// each other row adds one to *bad.
__global__ void __launch_bounds__(PROBE_THREADS)
    serial_deposit_kernel(float* __restrict__ out,
                          const int32_t* __restrict__ idx,
                          const float* __restrict__ val, int64_t n,
                          int64_t size, int vec, int32_t* __restrict__ bad) {
  const int64_t r = 4 * ((int64_t)blockIdx.x * PROBE_THREADS + threadIdx.x);
  int32_t j[4];
  float v[4];
  load4<int32_t, int4>(idx, r, n, vec != 0, 0, j);
  load4<float, float4>(val, r, n, vec != 0, 0.0f, v);
  int nbad = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (r + s >= n) continue;
    if (j[s] < 0 || (int64_t)j[s] >= size) {
      ++nbad;
    } else if (v[s] != 0.0f) {
      atomicAdd(out + j[s], v[s]);
    }
  }
  // every lane of the warp is here: the grid has whole blocks
  count_bad(nbad, bad);
}

// tile[hi[j] * 128 + lo[j]] += v[j] for every j < n with 0 <= hi[j] < h and
// 0 <= lo[j] < 128.
__global__ void __launch_bounds__(PROBE_THREADS)
    onehot_tile_kernel(float* __restrict__ tile,
                       const int32_t* __restrict__ hi,
                       const int32_t* __restrict__ lo,
                       const float* __restrict__ v, int64_t n, int h,
                       int vec) {
  const int64_t r = 4 * ((int64_t)blockIdx.x * PROBE_THREADS + threadIdx.x);
  if (r >= n) return;
  int32_t a[4], b[4];
  float x[4];
  load4<int32_t, int4>(hi, r, n, vec != 0, -1, a);
  load4<int32_t, int4>(lo, r, n, vec != 0, -1, b);
  load4<float, float4>(v, r, n, vec != 0, 0.0f, x);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool in = a[s] >= 0 && a[s] < h && b[s] >= 0 && b[s] < 128;
    if (in && x[s] != 0.0f) atomicAdd(tile + a[s] * 128 + b[s], x[s]);
  }
}

static unsigned probe_blocks(int64_t n) {
  const int64_t rows_per_block = 4 * PROBE_THREADS;
  return (unsigned)((n + rows_per_block - 1) / rows_per_block);
}

static int aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// serial_deposit: `out` holds `size` floats (the padded grid, a multiple of
// 128) followed by one int32, the count of rows whose index lies outside
// [0, size).  Zeroes all of it, then adds rows 0 .. n - 1 (the caller's
// whole blocks of rows).  Launches on `stream`; returns cudaGetLastError()
// after the launch.
extern "C" int rsmcrt_serial_deposit(void* out, int64_t size, const void* idx,
                                     const void* val, int64_t n,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc =
      cudaMemsetAsync(out, 0, (size_t)(size + 1) * sizeof(float), s);
  if (rc != cudaSuccess) return (int)rc;
  if (n <= 0) return 0;
  float* grid = (float*)out;
  serial_deposit_kernel<<<probe_blocks(n), PROBE_THREADS, 0, s>>>(
      grid, (const int32_t*)idx, (const float*)val, n, size,
      aligned16(idx) && aligned16(val), (int32_t*)(grid + size));
  return (int)cudaGetLastError();
}

// onehot_tile_accumulate: zeroes the [h, 128] float `tile`, then adds the n
// rows of (hi, lo, v).  Launches on `stream`; returns cudaGetLastError()
// after the launch.
extern "C" int rsmcrt_onehot_tile(void* tile, int h, const void* hi,
                                  const void* lo, const void* v, int64_t n,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc =
      cudaMemsetAsync(tile, 0, (size_t)h * 128 * sizeof(float), s);
  if (rc != cudaSuccess) return (int)rc;
  if (n <= 0) return 0;
  onehot_tile_kernel<<<probe_blocks(n), PROBE_THREADS, 0, s>>>(
      (float*)tile, (const int32_t*)hi, (const int32_t*)lo, (const float*)v,
      n, h, aligned16(hi) && aligned16(lo) && aligned16(v));
  return (int)cudaGetLastError();
}
