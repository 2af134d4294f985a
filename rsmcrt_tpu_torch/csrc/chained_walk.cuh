// The chained walk's arithmetic, one lane at a time: all K rounds of
// transport/engine.py::_torch_rounds for a scene of spheres and boxes, one
// monochromatic optical table and float32 lanes.  Every function here is
// __host__ __device__: chained_walk.cu runs walk_lane in a thread a lane on
// the card, and chained_walk_host.cpp runs it in a loop over the lanes on
// the CPU (built by g++, for the tests that hold it against the PyTorch
// rounds).
//
// Each operation follows the PyTorch expression it replaces, in the same
// order of operations (a + b + c is (a + b) + c, as the row-vector
// transform of maths/transforms.py adds; torch.sum's order is sum3's), with no
// fused multiply-add (nvcc -fmad=false, g++ -ffp-contract=off), IEEE
// division and square root, and logf, sinf and cosf as PyTorch calls them.
// So on the card the kernel's lanes follow the PyTorch rounds' to the last
// bit wherever the libraries agree.  Two operations differ between
// PyTorch's CPU and CUDA kernels, and each platform's is kept: a tensor over
// a Python number is a true division on the CPU but a product with the
// number's reciprocal on the card (div_scalar), and torch.sum adds three
// values in another order (sum3).  Neither is a contract of PyTorch's, so
// tests/test_torch_walk_kernel.py holds both against the installed PyTorch
// on each platform (walk_kernel.arith).
//
// What the rounds do, per lane, in _torch_rounds' order: the voxel DDA over
// the wall streams (or, without the fluence estimator, a whole segment a
// round), the grid-exit death, analog absorption into the lane's record
// slots or the survival-bias row and its roulette, the surface normal and
// the nudge probe's layer, the Fresnel branch, the bounce cap and bounce
// roulette, HG scatter, reflection and refraction, in-chain respawn, the
// new optical depth, the next segment from the closed-form sphere and box
// crossings (in concatenated-group order), and the scatter-order cap.
#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define RSMCRT_HD __host__ __device__ __forceinline__
#else
#define RSMCRT_HD inline
#endif

namespace rsmcrt_walk {

// The launch's arguments, passed by value to the kernel and by pointer to
// the host loop.  Every field takes 8 bytes, so the ctypes.Structure of
// transport/walk_kernel.py lays it out alike; rsmcrt_chained_walk_args_size
// lets the wrapper check that.  Lane arrays are contiguous, [B] or [B, 3];
// candidates [C, B] or [C, B, 3]; bools one byte each.
struct WalkArgs {
  // the lanes as the walk takes them
  const float* uc;  // [B, K, 4] uniforms
  const float* pos;
  const float* direction;
  const float* weight;
  const float* tau;
  const float* seg_rem;
  const uint8_t* seg_interact;
  const uint8_t* seg_srf;
  const uint8_t* seg_cont;
  const int32_t* seg_prim;
  const int32_t* layer;
  const uint8_t* alive;
  const int32_t* steps;
  const int32_t* bounces;
  const float* wavelength;
  const float* phase;
  // in-chain respawn candidates (C = 0: none)
  const float* rc_pos;
  const float* rc_dir;
  const float* rc_tau;
  const int32_t* rc_layer;
  const float* rc_phase;
  const float* rc_wl;
  const uint8_t* rc_good;
  const uint8_t* rc_allow;
  // the scene: per prim in concatenated-group order its inverse transform
  // (4x4, row-major) and radius or half lengths (PRIM_FLOATS a row); its
  // kind (KIND_*) and user-order prim, then each user-order prim's column
  // (3 N ints); the optical table [N + 1, 4] (kappa, albedo, g, n) by layer
  const float* prim_f;
  const int32_t* prim_i;
  const float* opt;
  // the lanes after the walk
  float* o_pos;
  float* o_dir;
  float* o_weight;
  float* o_tau;
  float* o_seg_rem;
  uint8_t* o_seg_interact;
  uint8_t* o_seg_srf;
  uint8_t* o_seg_cont;
  int32_t* o_seg_prim;
  int32_t* o_layer;
  uint8_t* o_alive;
  int32_t* o_steps;
  int32_t* o_bounces;
  float* o_wavelength;
  float* o_phase;
  // the rounds' records: fluence [B, K] (or null), absorption [B, slots]
  // (analog) or [B, K] (survival bias), the candidates each lane consumed
  int32_t* o_flat_k;
  float* o_deps_k;
  float* o_absorb_w;
  int32_t* o_absorb_flat;
  int32_t* o_cand_k;
  int32_t* o_counts;  // [3]: scatters, interactions, respawn tries (added)
  // each round's new segment for a detector bank [B, K, 3] / [B, K] (or
  // null): origin, direction, length and weight (0 where no segment began)
  float* o_row_pos;
  float* o_row_dir;
  float* o_row_len;
  float* o_row_w;
  // sizes and options
  int64_t B, K, C, n_prims, n_slots;
  int64_t survival, fluence, max_bounces, roulette_bounces, max_scatter_order;
  int64_t nyg, nzg;
  int64_t counts[3];
  // the grid and the walk's constants, each a float32 value
  double half[3], dv[3], counts_f[3], two_half[3];
  double delta_cross, land_eps, seg_cap, thr, ch, roulette_chance;
};

constexpr int PRIM_FLOATS = 20;
constexpr int KIND_SPHERE = 0;
constexpr int KIND_BOX = 1;

struct LaneCounts {
  int32_t scat, inter, resp;
};

struct V3 {
  float x, y, z;
};

// the constants of the PyTorch rounds, rounded to float32 as PyTorch rounds
// a Python number in a float32 operation
constexpr float BIG = 3.4e38f;         // engine._BIG
constexpr float TWOPI_F = 6.28318530717958647692f;
constexpr float TINY = 1e-30f;         // the clamps and the +1e-30 norms
constexpr float KAPPA_MIN = 1e-12f;
// scatter_direction's near-perpendicular thresholds, 1 -/+ its float32 tol
constexpr float UP_TH = 0.999999f;
constexpr float DOWN_TH = -0.999999f;

RSMCRT_HD float inf_f() { return __builtin_inff(); }

RSMCRT_HD V3 v3(float x, float y, float z) { return V3{x, y, z}; }
RSMCRT_HD V3 load3(const float* p) { return V3{p[0], p[1], p[2]}; }
RSMCRT_HD void store3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}
RSMCRT_HD float comp(V3 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : v.z);
}
// torch.sum over a last axis of three values: (a + b) + c on the CPU;
// PyTorch's CUDA reduction gives each row two threads, (a + c) + b
RSMCRT_HD float sum3(float a, float b, float c) {
#if defined(__CUDA_ARCH__)
  return (a + c) + b;
#else
  return (a + b) + c;
#endif
}
RSMCRT_HD float dot3(V3 a, V3 b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}
// a + s b, a lane row plus a [B] column times a [B, 3] row
RSMCRT_HD V3 axpy(V3 a, float s, V3 b) {
  return v3(a.x + s * b.x, a.y + s * b.y, a.z + s * b.z);
}
// torch.clamp(x, min=lo) and (max=hi): NaN stays NaN
RSMCRT_HD float clamp_min(float x, float lo) { return x < lo ? lo : x; }
RSMCRT_HD float clamp_max(float x, float hi) { return x > hi ? hi : x; }
RSMCRT_HD float min2(float a, float b) { return b < a ? b : a; }
RSMCRT_HD float max2(float a, float b) { return b > a ? b : a; }

// w / s for a Python number s, as PyTorch computes it on each platform
RSMCRT_HD float div_scalar(float w, float s) {
#if defined(__CUDA_ARCH__)
  return w * (1.0f / s);
#else
  return w / s;
#endif
}

// maths/transforms.py: [p, 1] @ M and v @ M[:3, :3], row-vector convention
RSMCRT_HD V3 apply_transform(const float* T, V3 p) {
  return v3(p.x * T[0] + p.y * T[4] + p.z * T[8] + T[12],
            p.x * T[1] + p.y * T[5] + p.z * T[9] + T[13],
            p.x * T[2] + p.y * T[6] + p.z * T[10] + T[14]);
}
RSMCRT_HD V3 apply_rotation(const float* T, V3 v) {
  return v3(v.x * T[0] + v.y * T[4] + v.z * T[8],
            v.x * T[1] + v.y * T[5] + v.z * T[9],
            v.x * T[2] + v.y * T[6] + v.z * T[10]);
}

// sdfs/primitives.py: sd_sphere and sd_box in the prim's frame
RSMCRT_HD float sd_prim(int kind, const float* row, V3 p) {
  const float* s = row + 16;
  if (kind == KIND_SPHERE) return sqrtf(dot3(p, p)) - s[0];
  V3 q = v3(fabsf(p.x) - s[0], fabsf(p.y) - s[1], fabsf(p.z) - s[2]);
  V3 m = v3(clamp_min(q.x, 0.0f), clamp_min(q.y, 0.0f), clamp_min(q.z, 0.0f));
  float ss = dot3(m, m);
  float outside = ss > 0.0f ? sqrtf(ss) : 0.0f;
  float mx = max2(max2(q.x, q.y), q.z);
  float inside = mx < 0.0f ? mx : -0.0f;  // -relu(-max(q))
  return outside + inside;
}

// sdfs/scene.scene_layer(eval_scene(scene, p)): 1 + the user-order prim of
// the largest negative distance (the first on a tie), 0 outside them all
RSMCRT_HD int32_t scene_layer(const WalkArgs& a, V3 p) {
  const int32_t* col_of_user = a.prim_i + 2 * a.n_prims;
  int32_t best = -1;
  float best_d = 0.0f;
  for (int64_t u = 0; u < a.n_prims; ++u) {
    int32_t c = col_of_user[u];
    const float* row = a.prim_f + (int64_t)c * PRIM_FLOATS;
    float d = sd_prim(a.prim_i[2 * c], row, apply_transform(row, p));
    if (d < 0.0f && (best < 0 || d > best_d)) {
      best = (int32_t)u;
      best_d = d;
    }
  }
  return best + 1;
}

// sdfs/raycast.py: the smallest strictly positive of two crossings
RSMCRT_HD float first_pos(float t1, float t2) {
  float a = t1 > 0.0f ? t1 : inf_f();
  float b = t2 > 0.0f ? t2 : inf_f();
  return min2(a, b);
}

RSMCRT_HD float ray_sphere(V3 p, V3 d, float radius) {
  float b = dot3(p, d);
  float c = dot3(p, p) - radius * radius;
  float disc = b * b - c;
  float sq = sqrtf(clamp_min(disc, TINY));
  float t1 = -b - sq;
  float t2 = -b + sq;
  return disc < 0.0f ? inf_f() : first_pos(t1, t2);
}

RSMCRT_HD float ray_box(V3 p, V3 d, const float* h) {
  float tn = -inf_f(), tf = inf_f();
  for (int i = 0; i < 3; ++i) {
    float pi = comp(p, i), di = comp(d, i);
    bool d0 = di == 0.0f;
    float safe = d0 ? 1.0f : di;
    float ta = (-h[i] - pi) / safe;
    float tb = (h[i] - pi) / safe;
    bool inside = fabsf(pi) <= h[i];
    float lo = d0 ? (inside ? -inf_f() : inf_f()) : min2(ta, tb);
    float hi = d0 ? (inside ? inf_f() : -inf_f()) : max2(ta, tb);
    tn = i == 0 ? lo : max2(tn, lo);
    tf = i == 0 ? hi : min2(tf, hi);
  }
  return tn > tf ? inf_f() : first_pos(tn, tf);
}

// raycast.ray_bound_idx: the first crossing over every prim and its column
RSMCRT_HD float ray_bound_idx(const WalkArgs& a, V3 pos, V3 dirn,
                              int32_t* idx) {
  float best = inf_f();
  int32_t bidx = 0;
  for (int64_t c = 0; c < a.n_prims; ++c) {
    const float* row = a.prim_f + c * PRIM_FLOATS;
    V3 p = apply_transform(row, pos);
    V3 d = apply_rotation(row, dirn);
    float t = a.prim_i[2 * c] == KIND_SPHERE ? ray_sphere(p, d, row[16])
                                             : ray_box(p, d, row + 16);
    if (t < best) {
      best = t;
      bidx = (int32_t)c;
    }
  }
  *idx = bidx;
  return best;
}

// the jax.grad slope of max(x, 0): 1 above, 1/2 at the tie
RSMCRT_HD float tie_slope(float x) {
  return x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
}
RSMCRT_HD float sign_f(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// raycast.surface_normal of column c: the closed-form gradient in the
// prim's frame, rotated to the world, normalised with +1e-30
RSMCRT_HD V3 surface_normal(const WalkArgs& a, V3 pos, int32_t c) {
  if (c < 0 || c >= a.n_prims) return v3(0.0f, 0.0f, 0.0f);
  const float* row = a.prim_f + (int64_t)c * PRIM_FLOATS;
  const float* s = row + 16;
  V3 p = apply_transform(row, pos);
  V3 g;
  if (a.prim_i[2 * c] == KIND_SPHERE) {
    float len = sqrtf(dot3(p, p));
    g = v3(p.x / len, p.y / len, p.z / len);
  } else {
    float q[3] = {fabsf(p.x) - s[0], fabsf(p.y) - s[1], fabsf(p.z) - s[2]};
    float m[3] = {clamp_min(q[0], 0.0f), clamp_min(q[1], 0.0f),
                  clamp_min(q[2], 0.0f)};
    float ss = sum3(m[0] * m[0], m[1] * m[1], m[2] * m[2]);
    float root = sqrtf(ss > 0.0f ? ss : 1.0f);
    float mx = max2(max2(q[0], q[1]), q[2]);
    float ties[3], nt;
    for (int i = 0; i < 3; ++i) ties[i] = q[i] == mx ? 1.0f : 0.0f;
    nt = sum3(ties[0], ties[1], ties[2]);
    float out[3];
    for (int i = 0; i < 3; ++i) {
      float g_out = (ss > 0.0f ? m[i] / root : 0.0f) * tie_slope(q[i]);
      float g_in = tie_slope(-mx) * ties[i] / nt;
      out[i] = (g_out + g_in) * sign_f(comp(p, i));
    }
    g = v3(out[0], out[1], out[2]);
  }
  V3 n = v3(sum3(g.x * row[0], g.y * row[1], g.z * row[2]),
            sum3(g.x * row[4], g.y * row[5], g.z * row[6]),
            sum3(g.x * row[8], g.y * row[9], g.z * row[10]));
  float norm = sqrtf(dot3(n, n) + TINY);
  return v3(n.x / norm, n.y / norm, n.z / norm);
}

// transport/fresnel.py
RSMCRT_HD float fresnel_coeff(V3 inc, V3 nrm, float n1, float n2) {
  float costt = fabsf(dot3(inc, nrm));
  costt = clamp_max(clamp_min(costt, 0.0f), 1.0f);
  float sintt = sqrtf(clamp_min(1.0f - costt * costt, TINY));
  float sint2 = (n1 / n2) * sintt;
  bool tir = sint2 > 1.0f;
  float sint2c = clamp_max(sint2, 1.0f);
  float cost2 = sqrtf(clamp_min(1.0f - sint2c * sint2c, TINY));
  float denom1 = n1 * costt + n2 * cost2;
  float denom2 = n1 * cost2 + n2 * costt;
  denom1 = denom1 == 0.0f ? 1.0f : denom1;
  denom2 = denom2 == 0.0f ? 1.0f : denom2;
  float f1 = fabsf((n1 * costt - n2 * cost2) / denom1);
  float f2 = fabsf((n1 * cost2 - n2 * costt) / denom2);
  float coeff = 0.5f * (f1 * f1 + f2 * f2);
  coeff = costt == 1.0f ? 0.0f : coeff;
  return tir ? 1.0f : coeff;
}

RSMCRT_HD V3 reflect(V3 inc, V3 nrm) {
  float t = 2.0f * dot3(nrm, inc);
  return v3(inc.x - t * nrm.x, inc.y - t * nrm.y, inc.z - t * nrm.z);
}

RSMCRT_HD V3 refract(V3 inc, V3 nrm, float eta) {
  float c1 = dot3(nrm, inc);
  V3 nt = c1 < 0.0f ? nrm : v3(-nrm.x, -nrm.y, -nrm.z);
  c1 = fabsf(c1);
  float c2 = sqrtf(clamp_min(1.0f - eta * eta * (1.0f - c1 * c1), TINY));
  float k = eta * c1 - c2;
  return v3(eta * inc.x + k * nt.x, eta * inc.y + k * nt.y,
            eta * inc.z + k * nt.z);
}

// transport/scatter.py
RSMCRT_HD float sample_hg_cost(float u, float g) {
  if (g == 0.0f) return 2.0f * u - 1.0f;
  float temp = (1.0f - g * g) / (1.0f - g + 2.0f * g * u);
  float cost = (1.0f + g * g - temp * temp) / (2.0f * g);
  return clamp_max(clamp_min(cost, -1.0f), 1.0f);
}

RSMCRT_HD V3 scatter_direction(V3 n, float cost, float phi) {
  float sint = sqrtf(clamp_min(1.0f - cost * cost, TINY));
  float cosp = cosf(phi);
  float sinp = sinf(phi);
  float temp = sqrtf(clamp_min(1.0f - n.z * n.z, TINY));
  float safe_t = temp > 0.0f ? temp : 1.0f;
  float uxx = sint * ((n.x * n.z * cosp - n.y * sinp) / safe_t) + n.x * cost;
  float uyy = sint * ((n.y * n.z * cosp + n.x * sinp) / safe_t) + n.y * cost;
  float uzz = -sint * cosp * safe_t + n.z * cost;
  bool up = n.z > UP_TH;
  bool down = n.z < DOWN_TH;
  if (up || down) {
    uxx = sint * cosp;
    uyy = sint * sinp;
  }
  uzz = up ? cost : (down ? -cost : uzz);
  V3 out = v3(uxx, uyy, uzz);
  float norm = sqrtf(dot3(out, out) + TINY);
  norm = norm > 0.0f ? norm : 1.0f;
  return v3(out.x / norm, out.y / norm, out.z / norm);
}

// engine._wall_streams on one axis: distance to the next wall and spacing
RSMCRT_HD void wall_stream(float p, float d, float cellf, float half,
                           float dv, float* t0, float* dt) {
  float pc = p + half;
  float safe = d == 0.0f ? 1.0f : d;
  float t_up = ((cellf + 1.0f) * dv - pc) / safe;
  float t_dn = (cellf * dv - pc) / safe;
  float t = d > 0.0f ? t_up : (d < 0.0f ? t_dn : BIG);
  *t0 = clamp_min(t, 0.0f);
  *dt = d == 0.0f ? BIG : dv / fabsf(safe);
}

// One lane's K rounds: reads lane b of the inputs, writes lane b of the
// outputs, and adds its event counts to `cnt`.
RSMCRT_HD void walk_lane(const WalkArgs& a, int64_t b, LaneCounts& cnt) {
  const int64_t K = a.K, B = a.B;
  const bool fluence = a.fluence != 0, survival = a.survival != 0;
  float half[3], dv[3];
  for (int i = 0; i < 3; ++i) {
    half[i] = (float)a.half[i];
    dv[i] = (float)a.dv[i];
  }
  const float delta_cross = (float)a.delta_cross;
  const float land_eps = (float)a.land_eps;
  const float seg_cap = (float)a.seg_cap;
  const float thr = (float)a.thr, ch = (float)a.ch;
  const float chance = (float)a.roulette_chance;
  const int32_t n_slots = (int32_t)a.n_slots;

  V3 p0 = load3(a.pos + 3 * b);
  V3 dirc = load3(a.direction + 3 * b);
  float w = a.weight[b];
  float tau = a.tau[b];
  const bool alive = a.alive[b] != 0;
  bool walking = alive && a.seg_rem[b] > 0.0f;
  float rem = walking ? a.seg_rem[b] : 0.0f;
  bool seg_int = a.seg_interact[b] != 0;
  bool srf_f = a.seg_srf[b] != 0;
  bool cont_f = a.seg_cont[b] != 0;
  int32_t prim = a.seg_prim[b];
  int32_t layer = a.layer[b];
  int32_t steps = a.steps[b];
  int32_t bounces = a.bounces[b];
  float wl = a.wavelength[b];
  float phase = a.phase[b];

  int32_t cell[3] = {0, 0, 0};
  float t_next[3] = {BIG, BIG, BIG}, dt_ax[3] = {0.0f, 0.0f, 0.0f};
  if (fluence) {
    for (int i = 0; i < 3; ++i) {
      float cf = floorf((comp(p0, i) + half[i]) / dv[i]);
      cell[i] = (int32_t)cf;
      wall_stream(comp(p0, i), comp(dirc, i), cf, half[i], dv[i],
                  &t_next[i], &dt_ax[i]);
    }
  }
  float s_prev = 0.0f;
  bool died = false;
  int32_t n_ab = 0;
  int32_t cand_k = 0;
  if (!survival) {
    for (int32_t s = 0; s < n_slots; ++s) {
      a.o_absorb_w[b * n_slots + s] = 0.0f;
      a.o_absorb_flat[b * n_slots + s] = 0;
    }
  }

  for (int64_t r = 0; r < K; ++r) {
    const float* u = a.uc + (b * K + r) * 4;
    const float u0 = u[0], u1 = u[1], u2 = u[2], u3 = u[3];
    float c = min2(min2(t_next[0], t_next[1]), t_next[2]);
    bool ends = rem <= c;
    float hi = ends ? rem : c;
    float length = clamp_min(hi - s_prev, 0.0f);
    V3 p_end = axpy(p0, rem, dirc);
    bool valid;
    int32_t flat;
    bool exit_now;
    if (fluence) {
      valid = true;
      int32_t sf[3];
      for (int i = 0; i < 3; ++i) {
        int32_t n = (int32_t)a.counts[i];
        valid = valid && cell[i] >= 0 && cell[i] < n;
        int32_t s = cell[i] < 0 ? 0 : cell[i];
        sf[i] = s < n - 1 ? s : n - 1;
      }
      flat = (sf[0] * (int32_t)a.nyg + sf[1]) * (int32_t)a.nzg + sf[2];
      exit_now = walking && !valid && length > 0.0f;
    } else {
      // grid.get_voxel and voxel_flat_index of the segment's end
      int32_t idx[3];
      valid = true;
      for (int i = 0; i < 3; ++i) {
        float f = floorf((float)a.counts_f[i] * (comp(p_end, i) + half[i])
                         / (float)a.two_half[i]);
        int32_t v = (int32_t)f;
        if (v < 0 || v >= (int32_t)a.counts[i]) v = -1;
        idx[i] = v;
        valid = valid && v >= 0;
      }
      flat = valid ? (idx[0] * (int32_t)a.nyg + idx[1]) * (int32_t)a.nzg
                         + idx[2]
                   : 0;
      exit_now = walking && !valid;
    }
    died = died || exit_now;
    const bool base = walking && !exit_now;
    const bool ends_b = base && ends;
    const bool inter = ends_b && seg_int;
    const bool not_int = ends_b && !seg_int;
    const bool srf = not_int && srf_f;
    const bool cont_ev = not_int && cont_f && !srf_f;
    const bool plainx = not_int && !srf_f && !cont_f;
    const float w_dep = w;
    const float* o_cur = a.opt + (int64_t)layer * 4;
    const float albedo_l = o_cur[1], g_l = o_cur[2], n1 = o_cur[3];

    // --- interaction events
    bool do_sc, do_ab;
    if (!survival) {
      do_sc = inter && u0 < albedo_l;
      do_ab = inter && !do_sc;
      bool ab_ok = do_ab && valid;
      if (ab_ok && n_ab < n_slots) {
        a.o_absorb_w[b * n_slots + n_ab] = w;
        a.o_absorb_flat[b * n_slots + n_ab] = flat;
      }
      n_ab += ab_ok ? 1 : 0;
    } else {
      float w_abs = inter ? w * (1.0f - albedo_l) : 0.0f;
      w = w - w_abs;
      a.o_absorb_flat[b * K + r] = flat;
      a.o_absorb_w[b * K + r] = valid ? w_abs : 0.0f;
      bool roul = inter && w < thr;
      bool surv = roul && u0 < ch;
      w = surv ? div_scalar(w, ch) : w;
      do_ab = roul && !surv;
      do_sc = inter && !do_ab;
    }
    died = died || do_ab;

    // --- surface events: nudge-across probe + Fresnel branch (only a
    // surface lane reads the normal, the probe and the new layer)
    V3 nvec = v3(0.0f, 0.0f, 0.0f), probe = p_end;
    int32_t new_layer = layer;
    float n2 = n1;
    bool crossing = false, refl = false, trans = false, needf = false;
    bool srf_die = false;
    if (srf) {
      nvec = surface_normal(a, p_end, prim);
      probe = axpy(p_end, delta_cross, dirc);
      new_layer = scene_layer(a, probe);
      bool outside = new_layer == 0;
      bool samel = new_layer == layer;
      crossing = !samel && !outside;
      n2 = a.opt[(int64_t)new_layer * 4 + 3];
      needf = crossing && n1 != n2;
      float ri = fresnel_coeff(dirc, nvec, n1, n2);
      refl = needf && u0 <= ri;
      trans = (crossing && !refl) || samel;
      int32_t bounces2 = bounces + (refl ? 1 : 0);
      bool overb = refl && bounces2 > a.max_bounces;
      srf_die = outside || overb;
      if (a.roulette_bounces > 0) {
        bool trapped = refl && bounces2 > a.roulette_bounces;
        bool survive = trapped && u1 < chance;
        w = survive ? div_scalar(w, chance) : w;
        srf_die = srf_die || (trapped && !survive);
      }
      bounces = refl ? bounces2 : bounces;
    }
    const bool srf_cont = srf && !srf_die;
    died = died || srf_die;

    // --- deposits: the interval plus, for transmitting lanes, the nudge
    float dep_len = length + (trans ? delta_cross : 0.0f);
    if (fluence) {
      a.o_flat_k[b * K + r] = flat;
      a.o_deps_k[b * K + r] = (walking && valid) ? dep_len * w_dep : 0.0f;
    }
    phase = phase + (walking ? dep_len : 0.0f);

    // --- continuation: scatter and surviving surface lanes
    V3 np_dir = dirc;
    if (do_sc) {
      float cost = sample_hg_cost(u1, g_l);
      float phi = TWOPI_F * u2;
      np_dir = scatter_direction(dirc, cost, phi);
    } else if (refl) {
      np_dir = reflect(dirc, nvec);
    } else if (crossing && needf) {
      float eta = n1 / (n2 > 0.0f ? n2 : 1.0f);
      np_dir = refract(dirc, nvec, eta);
    }
    V3 np_pos = trans ? probe : p_end;
    int32_t nlayer = (crossing && !refl) ? new_layer : layer;

    // --- in-chain respawn of a lane whose photon died this megastep
    bool resp = false;
    float rc_tau = 0.0f;
    if (a.C > 0) {
      int64_t k = cand_k < a.C - 1 ? cand_k : a.C - 1;
      int64_t kb = k * B + b;
      bool resp_try = died && a.rc_allow[kb] != 0 && cand_k < a.C;
      if (!survival) resp_try = resp_try && n_ab < n_slots;
      resp = resp_try && a.rc_good[kb] != 0;
      cand_k += resp_try ? 1 : 0;
      died = died && !resp;
      cnt.resp += resp_try ? 1 : 0;
      if (resp) {
        np_dir = load3(a.rc_dir + 3 * kb);
        np_pos = load3(a.rc_pos + 3 * kb);
        nlayer = a.rc_layer[kb];
        w = 1.0f;
        bounces = 0;
        steps = 0;
        wl = a.rc_wl[kb];
        phase = a.rc_phase[kb];
        rc_tau = a.rc_tau[kb];
      }
    }

    // --- the new optical depth (the crossing nudge at the NEW kappa)
    float kappa2 = a.opt[(int64_t)nlayer * 4];
    float tau_ev = do_sc ? -logf(u3)
                         : (trans ? clamp_min(tau - delta_cross * kappa2, 0.0f)
                                  : tau);
    if (resp) tau_ev = rc_tau;
    float tau_dist2 = kappa2 > 0.0f ? tau_ev / clamp_min(kappa2, KAPPA_MIN)
                                    : inf_f();
    // engine._segment_probe on an all-analytic scene
    int32_t hidx;
    float t_ana = ray_bound_idx(a, np_pos, np_dir, &hidx);
    bool fin_t = isfinite(t_ana);
    float avail = fin_t ? t_ana - land_eps : inf_f();
    float rem2 = clamp_min(clamp_max(min2(tau_dist2, avail), seg_cap), 0.0f);
    bool int2 = tau_dist2 <= avail && isfinite(tau_dist2);
    bool srf2 = !int2 && avail <= seg_cap && fin_t;
    float tau2 = clamp_min(tau_ev - rem2 * kappa2, 0.0f);
    int32_t steps2 = steps + (do_sc ? 1 : 0);
    cnt.scat += do_sc ? 1 : 0;
    cnt.inter += inter ? 1 : 0;

    bool over = false;
    if (a.max_scatter_order > 0) {
      over = do_sc && steps2 > a.max_scatter_order;
      died = died || over;
    }
    const bool ev = ((do_sc || srf_cont || cont_ev) && !over) || resp;
    if (a.o_row_pos != nullptr) {
      store3(a.o_row_pos + 3 * (b * K + r), np_pos);
      store3(a.o_row_dir + 3 * (b * K + r), np_dir);
      a.o_row_len[b * K + r] = ev ? rem2 : 0.0f;
      a.o_row_w[b * K + r] = ev ? w : 0.0f;
    }
    if (ev) {
      dirc = np_dir;
      p0 = np_pos;
    }
    if (fluence) {
      // re-anchor the wall streams at the event point; a respawned lane
      // teleports, so its cell comes from the candidate's position
      for (int i = 0; i < 3; ++i) {
        float cf = (float)cell[i];
        if (resp) {
          cf = floorf((comp(np_pos, i) + half[i]) / dv[i]);
          cell[i] = (int32_t)cf;
        }
        if (ev)
          wall_stream(comp(np_pos, i), comp(np_dir, i), cf, half[i], dv[i],
                      &t_next[i], &dt_ax[i]);
      }
    }
    if (ev) {
      rem = rem2;
      seg_int = int2;
      srf_f = srf2;
      cont_f = false;
      prim = hidx;
      layer = nlayer;
      tau = tau2;
      s_prev = 0.0f;
    }
    if (do_sc) steps = steps2;
    const bool fin = (plainx || do_ab || over || srf_die) && !resp;
    if (fin) s_prev = rem;
    walking = (base && (!ends || ev)) || resp;

    if (fluence) {
      // the wall crossing of a lane whose segment continues past it
      bool adv = walking && !ends && !resp;
      int am = -1;
      if (adv) {
        for (int i = 0; i < 3 && am < 0; ++i)
          if (t_next[i] == c) am = i;
        if (am >= 0) cell[am] += comp(dirc, am) > 0.0f ? 1 : -1;
        s_prev = c;
      }
      for (int i = 0; i < 3; ++i)
        t_next[i] = clamp_max(t_next[i] + (i == am ? dt_ax[i] : 0.0f), BIG);
    }
  }

  store3(a.o_pos + 3 * b, axpy(p0, s_prev, dirc));
  store3(a.o_dir + 3 * b, dirc);
  a.o_weight[b] = w;
  a.o_tau[b] = tau;
  a.o_seg_rem[b] = clamp_min(rem - s_prev, 0.0f);
  a.o_seg_interact[b] = seg_int;
  a.o_seg_srf[b] = srf_f;
  a.o_seg_cont[b] = cont_f;
  a.o_seg_prim[b] = prim;
  a.o_layer[b] = layer;
  a.o_alive[b] = alive && !died;
  a.o_steps[b] = steps;
  a.o_bounces[b] = bounces;
  a.o_wavelength[b] = wl;
  a.o_phase[b] = phase;
  a.o_cand_k[b] = cand_k;
}

}  // namespace rsmcrt_walk
