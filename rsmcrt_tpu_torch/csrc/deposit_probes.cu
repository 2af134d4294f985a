// The two deposit design probes of the TPU tools, as kernels for Hopper
// (sm_90a):
//
// - serial_deposit replaces tools/profile_deposit_pallas_serial.py::_kernel
//   (reached through serial_deposit): a zeroed [ceil(G/128), 128] float
//   grid to which row j of the first (N // block) * block rows adds val[j]
//   at flat cell idx[j].  On the TPU each row is a read-modify-write of one
//   (1, 128) VMEM row with a one-hot add, one row after another, to measure
//   the serial cost of dependent dynamic VMEM accesses.
// - onehot_tile_accumulate replaces tools/profile_deposit_design.py::kern:
//   the [H, 128] tile sum over chunks of (onehot(hi, H) * v)^T @
//   onehot(lo, 128), that is tile[hi, lo] += v for every row, a row with hi
//   outside [0, H) or lo outside [0, 128) adding nothing.  On the TPU the
//   chunk's two one-hot matrices go through the MXU and the tile is carried
//   in VMEM scratch from one grid step to the next.
//
// Neither kernel copies its TPU design: the one-hot matrices give the TPU's
// vector and matrix units a dense form of a scatter (26.8 G multiply-adds
// for the tool's 524,288 rows into a 400 x 128 tile), and on this card the
// scatter is native.  What bounds both on an H100 (50 MB L2, 3.35 TB/s) is
// the bytes: each row read once (8 bytes a row for serial_deposit, 12 for
// the tile) and the output written once (the serial tool's 200^3 grid is
// 32 MB, the tile 204,800 bytes).
//
// The first designs (*_red_kernel) zero the output with cudaMemsetAsync
// and then add each row with one float RED (an atomicAdd whose result is
// unused) into the L2.  Taken apart on an H100 80GB HBM3 at 700 W
// (tools/profile_deposit_probes.py --split): the 32 MB memset alone takes
// about as long as the serial REDs alone into an L2-resident grid, and the
// two together take longer than both, since the REDs then read-modify-write
// sectors the memset has just dirtied; the tile's two launches (memset,
// REDs) cost about a third of its time, and its REDs on the tool's 51,200
// addresses about a quarter more than on as many distinct ones.
//
// serial_deposit binned by slab (rsmcrt_serial_deposit_slab, which the
// wrapper launches) removes the memset and the REDs into the grid.  The
// grid is cut into slabs of `slab` cells (a multiple of 128) that fit one
// block's shared memory.  Pass 1 (slab_sort_kernel): block b
// counting-sorts its chunk of SORT_ROWS rows by slab in shared memory and
// writes them, as (cell in its slab, value), to its own region of the
// scratch with 16-byte stores, with each slab's first place in a table;
// nothing global is zeroed or added atomically.  Pass 2 (slab_add_kernel),
// one block a slab: zeroes the slab in shared memory, adds the slab's run
// of every chunk there and writes the whole slab to the grid with 16-byte
// stores, so every cell is written once, cells no row touches as zeros,
// and the grid needs no memset.  Pass 3 (slab_spill_kernel) is for skewed
// rows, where one slab holds most of them (all rows in one cell, or all in
// the ragged last slab) and its block would be one SM adding them all: a
// slab's block stops before the batch of SLAB_THREADS chunks that would
// take it past `heavy` rows, and pass 3's block b adds chunk b's run of
// each slab so left with warp-merged REDs into the slab, which pass 2 has
// written.  With no heavy slab pass 3 reads one word a block and ends.
//
// onehot_tile_accumulate keeps the RED kernel.  Its redesign in thread
// block clusters (each block of an 8-block cluster summing its rows into a
// copy of the tile in shared memory, the copies combined through
// distributed shared memory) lost to it in turns on the card and is not
// kept (PERF.md, section 6, has the times and why).
//
// On this card a float atomic add on shared memory compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN in the SASS), not to a native add
// as in the L2.  So pass 2 adds into shared memory with cas_add4: up to
// four compare-and-swaps in flight a thread, each first guessing that the
// cell holds 0 (true of most cells a slab's rows touch).
//
// The edge rules, the same in every design: only the caller's whole blocks
// of rows are passed in (n); a serial row whose cell lies outside
// [0, size) (the padded grid) is never written and is counted into the
// int32 word after the grid (on the TPU such a row reads and writes outside
// its VMEM buffer); a tile row out of range adds nothing, uncounted, as the
// one-hot product; a row whose value is 0 adds nothing and issues no write
// (the output starts at +0.0, and +0.0 + -0.0 is +0.0); a non-finite value
// reaches only its own cell (the one-hot product spreads NaN, v * 0, along
// the row's tile row hi; the serial row add puts it in its cell only, as
// here).

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

// *p[s] += x[s] for each s with use[s], p[s] in the block's shared memory:
// compare-and-swap loops run side by side, each first guessing the cell holds +0.0.  The swap
// compares bits, so a NaN cell does not loop.
__device__ __forceinline__ void cas_add4(float* const (&p)[4],
                                         const float (&x)[4],
                                         const bool (&use)[4]) {
  int seen[4];
  bool pending[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    seen[s] = 0;
    pending[s] = use[s];
  }
  while (pending[0] || pending[1] || pending[2] || pending[3]) {
    int want[4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (pending[s])
        want[s] = atomicCAS(reinterpret_cast<int*>(p[s]), seen[s],
                            __float_as_int(__int_as_float(seen[s]) + x[s]));
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (pending[s]) {
        pending[s] = want[s] != seen[s];
        seen[s] = want[s];
      }
    }
  }
}

// Where every kept lane of the warp holds one index (a hot cell), the
// lowest kept lane gets the warp's sum in *sum and the others drop out;
// else each kept lane keeps its own row (all 32 lanes call it).
__device__ __forceinline__ bool warp_merge_one(int32_t j, float v, bool ok,
                                               float* sum) {
  const unsigned kept = __ballot_sync(FULL_WARP, ok);
  if (kept == 0u) return false;
  if (warp_one_index(j, ok) >= 0) {
    *sum = warp_sum(ok ? v : 0.0f);
    return (int)(threadIdx.x & 31) == __ffs(kept) - 1;
  }
  *sum = v;
  return ok;
}

// --- the first designs: zero the output, then one RED a row ---------------

// out[idx[j]] += val[j] for every j < n whose index lies in [0, size);
// each other row adds one to *bad.
__global__ void __launch_bounds__(PROBE_THREADS)
    serial_deposit_red_kernel(float* __restrict__ out,
                              const int32_t* __restrict__ idx,
                              const float* __restrict__ val, int64_t n,
                              int64_t size, int vec,
                              int32_t* __restrict__ bad) {
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
    onehot_tile_red_kernel(float* __restrict__ tile,
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

// --- serial_deposit binned by slab ------------------------------------------

// The three passes are launched back to back with Programmatic Dependent
// Launch: each lets the next grid start launching once all its blocks run
// (launch_next_grid), and the next waits in wait_prior_grid until the one
// before it has ended and its writes are visible, so the launch gaps
// overlap the work.  Without the launch attribute the wait returns at once.
__device__ __forceinline__ void launch_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

#define SORT_THREADS 512
// rows a sorting block takes: two 16-byte vectors of 4 a thread
#define SORT_ROWS (8 * SORT_THREADS)
#define SLAB_THREADS 1024

// The slab of a row: -1 for a row at or past n (`present` false), outside
// [0, size) (counted into nbad) or with a zero value (no write).
__device__ __forceinline__ int slab_of(int32_t j, float v, bool present,
                                       int64_t size, int slab, int& nbad) {
  if (!present) return -1;
  if (j < 0 || (int64_t)j >= size) {
    ++nbad;
    return -1;
  }
  return v != 0.0f ? j / slab : -1;
}

// hist[k] += 1 for every lane with k >= 0 (all 32 lanes call it); returns
// the lane's rank among the block's rows of slab k (hist[k] before its own
// add), -1 for k < 0.  A warp whose rows share one slab adds once.
__device__ __forceinline__ int warp_hist_add(int* hist, int k) {
  const bool ok = k >= 0;
  const unsigned kept = __ballot_sync(FULL_WARP, ok);
  if (kept == 0u) return -1;
  const int lane = threadIdx.x & 31;
  const int one = warp_one_index(k, ok);
  if (one >= 0) {
    const int leader = __ffs(kept) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(hist + one, __popc(kept));
    base = __shfl_sync(FULL_WARP, base, leader);
    return ok ? base + __popc(kept & ((1u << lane) - 1u)) : -1;
  }
  return ok ? atomicAdd(hist + k, 1) : -1;
}

// a[k] = a[0] + ... + a[k - 1] (before the call) for k < count, in place
// in shared memory, by one block of THREADS threads; returns the sum of
// all count.
template <int THREADS>
__device__ int block_exclusive_scan(int* a, int count) {
  __shared__ int warp_sums[THREADS / 32];
  __shared__ int carry;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) carry = 0;
  __syncthreads();
  for (int b = 0; b < count; b += THREADS) {
    const int k = b + t;
    const int x = k < count ? a[k] : 0;
    int y = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL_WARP, y, o);
      if (lane >= o) y += u;
    }
    if (lane == 31) warp_sums[warp] = y;
    __syncthreads();
    if (warp == 0) {
      int w = lane < THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL_WARP, w, o);
        if (lane >= o) w += u;
      }
      if (lane < THREADS / 32) warp_sums[lane] = w;
    }
    __syncthreads();
    const int excl = carry + (warp ? warp_sums[warp - 1] : 0) + y - x;
    if (k < count) a[k] = excl;
    __syncthreads();
    if (t == THREADS - 1) carry = excl + x;
    __syncthreads();
  }
  return carry;
}

// Pass 1: block b sorts its chunk of SORT_ROWS rows by slab in shared
// memory (a counting sort: each row's rank in its slab, then the block's
// scan of the slab counts) and writes the kept rows, as (cell in its
// slab, value bits), to its own region of the scratch with 16-byte
// stores.  table[k * parts + b] gets the first place of slab k in that
// region (k = slabs: the rows kept), bad[b] the chunk's out-of-range rows.
// No global atomic, nothing to zero beforehand; block 0 zeroes pass 3's
// count of heavy slabs.
__global__ void __launch_bounds__(SORT_THREADS)
    slab_sort_kernel(const int32_t* __restrict__ idx,
                     const float* __restrict__ val, int64_t n, int64_t size,
                     int slab, int slabs, int vec, int2* __restrict__ scratch,
                     int32_t* __restrict__ table, int32_t* __restrict__ bad,
                     int32_t* __restrict__ n_heavy) {
  extern __shared__ int4 smem4[];
  int2* stage = reinterpret_cast<int2*>(smem4);
  int* hist = reinterpret_cast<int*>(stage + SORT_ROWS);  // slabs + 1
  __shared__ int block_bad;
  const int b = blockIdx.x, parts = gridDim.x;
  launch_next_grid();  // every sorting block is resident
  for (int k = threadIdx.x; k <= slabs; k += SORT_THREADS) hist[k] = 0;
  if (threadIdx.x == 0) {
    block_bad = 0;
    if (b == 0) *n_heavy = 0;
  }
  __syncthreads();
  int32_t c[8], k[8], rank[8];
  float v[8];
  int nbad = 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t r = (int64_t)b * SORT_ROWS + half * (SORT_ROWS / 2) +
                      4 * threadIdx.x;
    int32_t jh[4];
    float vh[4];
    load4<int32_t, int4>(idx, r, n, vec != 0, 0, jh);
    load4<float, float4>(val, r, n, vec != 0, 0.0f, vh);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int q = 4 * half + s;
      k[q] = slab_of(jh[s], vh[s], r + s < n, size, slab, nbad);
      c[q] = jh[s] - k[q] * slab;
      v[q] = vh[s];
      rank[q] = warp_hist_add(hist, k[q]);
    }
  }
  const int wbad = __reduce_add_sync(FULL_WARP, (unsigned)nbad);
  if (wbad != 0 && (threadIdx.x & 31) == 0) atomicAdd(&block_bad, wbad);
  block_exclusive_scan<SORT_THREADS>(hist, slabs + 1);  // syncs first
  for (int q = threadIdx.x; q <= slabs; q += SORT_THREADS)
    table[(int64_t)q * parts + b] = hist[q];
  if (threadIdx.x == 0) bad[b] = block_bad;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (k[q] >= 0)
      stage[hist[k[q]] + rank[q]] = make_int2(c[q], __float_as_int(v[q]));
  __syncthreads();
  const int kept = hist[slabs];
  int2* dst = scratch + (int64_t)b * SORT_ROWS;
  for (int i = threadIdx.x; i < kept / 2; i += SORT_THREADS)
    reinterpret_cast<int4*>(dst)[i] = smem4[i];
  if ((kept & 1) && threadIdx.x == 0) dst[kept - 1] = stage[kept - 1];
}

// Pass 2: one block a slab zeroes the slab in shared memory, adds the
// slab's runs of every chunk there and writes the whole slab to the grid
// with 16-byte stores: every cell is written once, cells no row touches as
// zeros, so the grid needs no memset.  The runs are taken SLAB_THREADS
// chunks at a time: their bounds go to shared memory and are scanned, and
// the threads walk the runs' rows laid end to end (a binary search finds a
// row's run), four rows a thread at a time, each load coalesced across the
// warp; equal cells are merged inside the thread, a warp whose rows all
// hold one cell (a hot cell) sums them first, and cas_add4 adds them.
// Where the chunks taken so far and the next SLAB_THREADS would come to
// more than `heavy` rows, the block stops and lists the slab, with that
// first chunk it left, in `heavy_list` for pass 3 (counted in *n_heavy).
// Block 0 also writes the out-of-range count to the word after the grid.
__global__ void __launch_bounds__(SLAB_THREADS)
    slab_add_kernel(float* __restrict__ out, int64_t size, int slab,
                    int parts, const int2* __restrict__ scratch,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ bad, int heavy,
                    int2* __restrict__ heavy_list,
                    int32_t* __restrict__ n_heavy) {
  extern __shared__ float4 cells4[];
  float* cells = reinterpret_cast<float*>(cells4);
  __shared__ int run_off[SLAB_THREADS];
  __shared__ int run_start[SLAB_THREADS];
  const int kb = blockIdx.x, t = threadIdx.x;
  const int64_t lo = (int64_t)kb * slab;
  const int64_t left = size - lo;  // the last slab may be ragged
  const int n4 = (int)((left < slab ? left : slab) / 4);
  launch_next_grid();  // every add block is resident
  for (int i = t; i < n4; i += SLAB_THREADS)
    cells4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  wait_prior_grid();  // the sorted chunks and the table are written
  if (kb == 0 && t < 32) {
    int nbad = 0;
    for (int q = t; q < parts; q += 32) nbad += bad[q];
    nbad = __reduce_add_sync(FULL_WARP, (unsigned)nbad);
    if (t == 0) *reinterpret_cast<int32_t*>(out + size) = nbad;
  }
  int added = 0;  // rows of the chunks taken so far
  for (int p0 = 0; p0 < parts; p0 += SLAB_THREADS) {
    const int m = min(SLAB_THREADS, parts - p0);
    int len = 0;
    if (t < m) {
      const int start = table[(int64_t)kb * parts + p0 + t];
      len = table[(int64_t)(kb + 1) * parts + p0 + t] - start;
      run_start[t] = start;
    }
    run_off[t] = len;
    const int total = block_exclusive_scan<SLAB_THREADS>(run_off,
                                                         SLAB_THREADS);
    if (added + total > heavy) {  // block-uniform: total is shared
      if (t == 0) heavy_list[atomicAdd(n_heavy, 1)] = make_int2(kb, p0);
      break;
    }
    added += total;
    for (int i0 = 0; i0 < total; i0 += 4 * SLAB_THREADS) {
      int32_t c[4];
      float x[4];
      bool ok[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = i0 + s * SLAB_THREADS + t;
        ok[s] = i < total;
        int2 row = make_int2(0, 0);
        if (ok[s]) {
          int l = 0, h = m;  // the last run starting at or before i
          while (l < h) {
            const int mid = (l + h) >> 1;
            if (run_off[mid] <= i) l = mid + 1; else h = mid;
          }
          const int r = l - 1;
          row = __ldcs(scratch + (int64_t)(p0 + r) * SORT_ROWS +
                       run_start[r] + (i - run_off[r]));
        }
        c[s] = row.x;
        x[s] = __int_as_float(row.y);
      }
      combine4(c, x, ok);
      float* p[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        ok[s] = warp_merge_one(c[s], x[s], ok[s], &x[s]);
        p[s] = cells + c[s];
      }
      cas_add4(p, x, ok);
    }
    __syncthreads();  // the next chunks' bounds overwrite these
  }
  float4* dst = reinterpret_cast<float4*>(out + lo);
  for (int i = t; i < n4; i += SLAB_THREADS) dst[i] = cells4[i];
}

#define SPILL_THREADS 256

// Pass 3: block b adds, for each heavy slab k that pass 2 listed with
// first chunk p <= b, chunk b's run of slab k to the grid, which pass 2
// has written: four rows a thread at a time, coalesced; equal cells
// merged inside the thread and a hot cell across the warp, then one RED a
// row left.  Every bound is block-uniform, so whole warps merge.
__global__ void __launch_bounds__(SPILL_THREADS)
    slab_spill_kernel(float* __restrict__ out, int slab, int parts,
                      const int2* __restrict__ scratch,
                      const int32_t* __restrict__ table,
                      const int2* __restrict__ heavy_list,
                      const int32_t* __restrict__ n_heavy) {
  const int b = blockIdx.x, t = threadIdx.x;
  wait_prior_grid();  // pass 2 has written every slab and the list
  const int count = *n_heavy;
  for (int q = 0; q < count; ++q) {
    const int2 hk = heavy_list[q];
    if (b < hk.y) continue;
    const int k = hk.x;
    const int start = table[(int64_t)k * parts + b];
    const int len = table[(int64_t)(k + 1) * parts + b] - start;
    const int2* rows = scratch + (int64_t)b * SORT_ROWS + start;
    float* cells = out + (int64_t)k * slab;
    for (int i0 = 0; i0 < len; i0 += 4 * SPILL_THREADS) {
      int32_t c[4];
      float x[4];
      bool ok[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = i0 + s * SPILL_THREADS + t;
        ok[s] = i < len;
        const int2 row = ok[s] ? __ldcs(rows + i) : make_int2(0, 0);
        c[s] = row.x;
        x[s] = __int_as_float(row.y);
      }
      combine4(c, x, ok);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (warp_merge_one(c[s], x[s], ok[s], &x[s]))
          atomicAdd(cells + c[s], x[s]);
    }
  }
}

// --- the C interface ---------------------------------------------------------

static unsigned probe_blocks(int64_t n) {
  const int64_t rows_per_block = 4 * PROBE_THREADS;
  return (unsigned)((n + rows_per_block - 1) / rows_per_block);
}

static int aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The launch of `grid` blocks of `threads` on `s` that may start while the
// grid before it ends (Programmatic Dependent Launch); the kernel calls
// wait_prior_grid before it reads what that grid wrote.
static cudaLaunchConfig_t overlapped(unsigned grid, unsigned threads,
                                     size_t smem, cudaStream_t s,
                                     cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr->val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Opts `fn` in to `bytes` of dynamic shared memory where that is above the
// default 48 KB.
static int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// serial_deposit binned by slab: `out` holds `size` floats (the padded
// grid, a multiple of 128) followed by one int32, the count of rows whose
// index lies outside [0, size), all written by the kernels.  Adds rows
// 0 .. n - 1 (the caller's whole blocks of rows, n < 2^31).  `slab` cells a
// slab (a multiple of 128 that fits a block's shared memory beside 8.3 KB
// of the add pass's own), `slabs` = ceil(size / slab), `heavy` the rows a
// slab's block adds at most before it leaves the rest to pass 3; with
// parts = ceil(n / 4096) chunks (SORT_ROWS), `scratch` holds parts * 4096
// int2 rows and `table` (an 8-byte aligned buffer) 2 * slabs + 1 +
// (slabs + 2) * parts int32 words (the heavy slabs' list and count, the
// slab starts, the out-of-range counts), written before they are read.  Three launches on `stream`;
// returns the first error.
extern "C" int rsmcrt_serial_deposit_slab(void* out, int64_t size,
                                          const void* idx, const void* val,
                                          int64_t n, int slab, int slabs,
                                          int heavy, void* scratch,
                                          void* table, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int parts = (int)(n > 0 ? (n + SORT_ROWS - 1) / SORT_ROWS : 1);
  int2* heavy_list = (int2*)table;  // 8-byte aligned first
  int32_t* n_heavy = (int32_t*)(heavy_list + slabs);
  int32_t* starts = n_heavy + 1;
  int32_t* bad = starts + (int64_t)(slabs + 1) * parts;
  const size_t sort_smem =
      (size_t)SORT_ROWS * sizeof(int2) + (size_t)(slabs + 1) * sizeof(int);
  int rc = set_smem((const void*)slab_sort_kernel, sort_smem);
  if (rc == 0)
    rc = set_smem((const void*)slab_add_kernel, (size_t)slab * sizeof(float));
  if (rc != 0) return rc;
  slab_sort_kernel<<<(unsigned)parts, SORT_THREADS, sort_smem, s>>>(
      (const int32_t*)idx, (const float*)val, n, size, slab, slabs,
      aligned16(idx) && aligned16(val), (int2*)scratch, starts, bad,
      n_heavy);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = overlapped((unsigned)slabs, SLAB_THREADS,
                                      (size_t)slab * sizeof(float), s, &attr);
  rc = (int)cudaLaunchKernelEx(&cfg, slab_add_kernel, (float*)out, size, slab,
                               parts, (const int2*)scratch,
                               (const int32_t*)starts, (const int32_t*)bad,
                               heavy, heavy_list, n_heavy);
  if (rc != 0) return rc;
  cfg = overlapped((unsigned)parts, SPILL_THREADS, 0, s, &attr);
  rc = (int)cudaLaunchKernelEx(&cfg, slab_spill_kernel, (float*)out, slab,
                               parts, (const int2*)scratch,
                               (const int32_t*)starts,
                               (const int2*)heavy_list,
                               (const int32_t*)n_heavy);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// The card's SMs and the shared memory a block may opt in to, in bytes,
// into *sms and *block_smem (the slab plan's inputs).
extern "C" int rsmcrt_card_shape(int* sms, int* block_smem) {
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc == 0)
    rc = (int)cudaDeviceGetAttribute(
        block_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return rc;
}

// The serial REDs alone: rows 0 .. n - 1 into the `size` floats of
// `out`, the out-of-range ones counted into the int32 word after them;
// nothing is zeroed.
extern "C" int rsmcrt_serial_red_only(void* out, int64_t size,
                                      const void* idx, const void* val,
                                      int64_t n, void* stream) {
  if (n <= 0) return 0;
  float* grid = (float*)out;
  serial_deposit_red_kernel<<<probe_blocks(n), PROBE_THREADS, 0,
                              (cudaStream_t)stream>>>(
      grid, (const int32_t*)idx, (const float*)val, n, size,
      aligned16(idx) && aligned16(val), (int32_t*)(grid + size));
  return (int)cudaGetLastError();
}

// serial_deposit by REDs: zeroes `out` (`size` floats and the count word)
// with cudaMemsetAsync, then adds rows 0 .. n - 1 with one RED each.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int rsmcrt_serial_deposit(void* out, int64_t size, const void* idx,
                                     const void* val, int64_t n,
                                     void* stream) {
  cudaError_t rc = cudaMemsetAsync(out, 0, (size_t)(size + 1) * sizeof(float),
                                   (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return rsmcrt_serial_red_only(out, size, idx, val, n, stream);
}

// The tile REDs alone: the n rows of (hi, lo, v) added into the [h, 128]
// float `tile`, which is not zeroed.
extern "C" int rsmcrt_onehot_tile_red_only(void* tile, int h, const void* hi,
                                           const void* lo, const void* v,
                                           int64_t n, void* stream) {
  if (n <= 0) return 0;
  onehot_tile_red_kernel<<<probe_blocks(n), PROBE_THREADS, 0,
                           (cudaStream_t)stream>>>(
      (float*)tile, (const int32_t*)hi, (const int32_t*)lo, (const float*)v,
      n, h, aligned16(hi) && aligned16(lo) && aligned16(v));
  return (int)cudaGetLastError();
}

// onehot_tile_accumulate by REDs: zeroes the [h, 128] float `tile` with
// cudaMemsetAsync, then adds the n rows of (hi, lo, v) with one RED each.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int rsmcrt_onehot_tile(void* tile, int h, const void* hi,
                                  const void* lo, const void* v, int64_t n,
                                  void* stream) {
  cudaError_t rc = cudaMemsetAsync(tile, 0, (size_t)h * 128 * sizeof(float),
                                   (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return rsmcrt_onehot_tile_red_only(tile, h, hi, lo, v, n, stream);
}

// --- the diagnostics' yardsticks ---------------------------------------------

__global__ void empty_kernel() {}

// One cudaMemsetAsync of `bytes` zero bytes at `p`.
extern "C" int rsmcrt_probe_memset(void* p, int64_t bytes, void* stream) {
  return (int)cudaMemsetAsync(p, 0, (size_t)bytes, (cudaStream_t)stream);
}

// One launch of an empty kernel (one block of 32 threads).
extern "C" int rsmcrt_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
