// The CPU twin of chained_walk.cu: the same walk_lane (chained_walk.cuh)
// run lane after lane.  Built by transport/walk_kernel.py with
// g++ -O3 -ffp-contract=off for the tests that hold the kernel's arithmetic
// against the PyTorch rounds on the CPU; no transport path loads it.

#include "chained_walk.cuh"

extern "C" int64_t rsmcrt_chained_walk_args_size() {
  return (int64_t)sizeof(rsmcrt_walk::WalkArgs);
}

// One walk of a->B lanes; adds the event counts to a->o_counts.
extern "C" int rsmcrt_chained_walk_host(const rsmcrt_walk::WalkArgs* a) {
  rsmcrt_walk::LaneCounts total{0, 0, 0};
  for (int64_t b = 0; b < a->B; ++b) rsmcrt_walk::walk_lane(*a, b, total);
  a->o_counts[0] += total.scat;
  a->o_counts[1] += total.inter;
  a->o_counts[2] += total.resp;
  return 0;
}

// sum3 and div_scalar as the CPU twin computes them (chained_walk.cu's
// rsmcrt_chained_walk_arith, lane after lane).
extern "C" int rsmcrt_chained_walk_arith_host(const float* x, int64_t n,
                                              float s, float* sums,
                                              float* quots) {
  for (int64_t i = 0; i < n; ++i) {
    sums[i] = rsmcrt_walk::sum3(x[3 * i], x[3 * i + 1], x[3 * i + 2]);
    quots[i] = rsmcrt_walk::div_scalar(x[3 * i], s);
  }
  return 0;
}
