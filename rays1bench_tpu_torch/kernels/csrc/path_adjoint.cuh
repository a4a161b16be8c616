// Reverse-mode adjoints of the per-ray math in path_math.cuh, derived by
// hand: the fixed-topology replay bounce of the gradient path
// (rays1bench_tpu_torch/kernels/mega_backward.py `bounce_core`, hard and
// soft mode).
// The Pallas kernel got this transpose from an in-kernel jax.vjp; CUDA has
// none, so every step of the chain is written out below, in reverse.
//
// Each function takes the cotangents of a step's outputs and adds the
// cotangents of its inputs. The forward values a step needs are recomputed
// from its inputs with the same float ops as the forward (so the replay and
// the plain version see the same floats); the reverse ops themselves follow
// torch.autograd's formulas but not its summation order, so cotangents agree
// with autograd to rounding, not bit for bit.
//
// Conventions that autograd fixes and the adjoint keeps:
// - max(x, eps) passes the cotangent where x >= eps and blocks it below
//   (torch.clamp_min); so safe_sqrt and normalize3 have a zero derivative
//   under their eps floor instead of an infinite one;
// - discrete choices carry no cotangent: the material, the dielectric's
//   exiting / can_refract / reflect draw, metal_ok, the continue mask and
//   (soft mode) the two-branch draw take = u < cover, which the replay
//   records in its forward pass; the branch weights' denominators
//   max(sg(cover), 1e-20) are detached.
#pragma once

#include <stdint.h>

#include "path_math.cuh"

namespace r1b {

constexpr float kEps = 0x1.197998p-40f;  // float32(1e-12)

// Columns of the (11, S) exact table of mega_backward.pack_exact, in
// GRAD_ROWS order, then the material code as a float.
enum ExactRow {
  kECX = 0, kECY, kECZ, kERSQ, kEINVR, kEALBX, kEALBY, kEALBZ, kEFUZZ,
  kEREF, kEMAT, kNumExactRows
};
constexpr int kNumGrad = 10;

// Replayed hit record of row j (render/intersect.hit_record_from_index):
// t from the row's columns with safe_sqrt, the point, the normal
// (p - c) * inv_r, and the exact material columns.
__device__ __forceinline__ Hit replay_hit(const float* tab, int S, int j,
                                          float t_min, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz) {
  const float cx = tab[kECX * S + j], cy = tab[kECY * S + j],
              cz = tab[kECZ * S + j];
  const float gx = cx - ox, gy = cy - oy, gz = cz - oz;
  const float nb = gx * dx + gy * dy + gz * dz;
  const float c = gx * gx + gy * gy + gz * gz - tab[kERSQ * S + j];
  const float sq = sqrtf(clamp_min_nan(nb * nb - c, kEps));
  const float t1 = nb - sq;
  const float t = t1 > t_min ? t1 : nb + sq;
  const float ivr = tab[kEINVR * S + j];
  Hit h;
  h.px = ox + t * dx;
  h.py = oy + t * dy;
  h.pz = oz + t * dz;
  h.nx = (h.px - cx) * ivr;
  h.ny = (h.py - cy) * ivr;
  h.nz = (h.pz - cz) * ivr;
  h.mat_type = (int)tab[kEMAT * S + j];
  h.albedo_x = tab[kEALBX * S + j];
  h.albedo_y = tab[kEALBY * S + j];
  h.albedo_z = tab[kEALBZ * S + j];
  h.fuzz = tab[kEFUZZ * S + j];
  h.ref_idx = tab[kEREF * S + j];
  return h;
}

// normalize3: s = x / sqrt(max(|x|^2, eps)). g: cotangent of s; returns the
// cotangent of x in (ax, ay, az). eps is 1e-12 (vecmath.normalize3) or, for
// the soft record's renormalized normal, 1e-20.
__device__ __forceinline__ void normalize3_adj(float x, float y, float z,
                                               float gx, float gy, float gz,
                                               float& ax, float& ay,
                                               float& az, float eps = kEps) {
  const float m = x * x + y * y + z * z;
  const float q = sqrtf(clamp_min_nan(m, eps));
  const float inv = 1.0f / q;
  const float g_inv = gx * x + gy * y + gz * z;
  // inv = 1/q, q = sqrt(m): d inv / d m = -0.5 * inv^3 (0 under the floor).
  const float g_m = m >= eps ? -0.5f * g_inv * inv * inv * inv : 0.0f;
  ax = gx * inv + 2.0f * x * g_m;
  ay = gy * inv + 2.0f * y * g_m;
  az = gz * inv + 2.0f * z * g_m;
}

// reflect3: r = v - 2 (v.n) n. g: cotangent of r; adds into gv and gn.
__device__ __forceinline__ void reflect3_adj(const float v[3],
                                             const float n[3],
                                             const float g[3], float gv[3],
                                             float gn[3]) {
  const float d2 = 2.0f * dot3(v[0], v[1], v[2], n[0], n[1], n[2]);
  const float g_dot = -2.0f * dot3(g[0], g[1], g[2], n[0], n[1], n[2]);
  for (int k = 0; k < 3; ++k) {
    gv[k] += g[k] + g_dot * n[k];
    gn[k] += -d2 * g[k] + g_dot * v[k];
  }
}

// sky_color(dy) scaled by the attenuation a and added to the radiance:
// the miss step. crad: cotangent of the ray's radiance; adds into ga, gdy.
__device__ __forceinline__ void sky_adj(const float a[3], float dy,
                                        const float crad[3], float ga[3],
                                        float& gdy) {
  float sky[3];
  sky_color(dy, sky[0], sky[1], sky[2]);
  const float gsr = crad[0] * a[0], gsg = crad[1] * a[1],
              gsb = crad[2] * a[2];
  for (int k = 0; k < 3; ++k) ga[k] += crad[k] * sky[k];
  // t = 0.5 (dy + 1), s = 1 - t, sky = s + t * (0.5, 0.7, 1.0).
  const float g_t = gsr * 0.5f + gsg * 0x1.666666p-1f + gsb -
                    (gsr + gsg + gsb);
  gdy += 0.5f * g_t;
}

// Scatter: s(d, n, fuzz, ref_idx) of a hit with material mt. gs: cotangent
// of s; adds the cotangents of d into gdd and of n into gn, and sets those
// of fuzz and ref_idx. reflected: the dielectric's recorded mirror choice.
__device__ __forceinline__ void scatter_adj(
    int mt, const float d[3], const float n[3], float fz, float ri,
    bool reflected, uint32_t seed, uint32_t rid, uint32_t bounce,
    const float gs[3], float gdd[3], float gn[3], float& g_fuzz,
    float& g_ref) {
  g_fuzz = 0.0f;
  g_ref = 0.0f;
  if (mt == 2) {
    if (reflected) {
      reflect3_adj(d, n, gs, gdd, gn);
    } else {
      const float d_dot_n = dot3(d[0], d[1], d[2], n[0], n[1], n[2]);
      const bool exiting = d_dot_n > 0.0f;
      const float on[3] = {exiting ? -n[0] : n[0], exiting ? -n[1] : n[1],
                           exiting ? -n[2] : n[2]};
      const float nio = exiting ? ri : 1.0f / ri;
      const float dt = dot3(d[0], d[1], d[2], on[0], on[1], on[2]);
      const float omd = 1.0f - dt * dt;
      const float nn = nio * nio;
      const float rdisc = 1.0f - nn * omd;
      const float rd = sqrtf(clamp_min_nan(rdisc, kEps));
      const float w[3] = {d[0] - on[0] * dt, d[1] - on[1] * dt,
                          d[2] - on[2] * dt};
      const float f[3] = {nio * w[0] - on[0] * rd, nio * w[1] - on[1] * rd,
                          nio * w[2] - on[2] * rd};
      float gf[3];
      normalize3_adj(f[0], f[1], f[2], gs[0], gs[1], gs[2], gf[0], gf[1],
                     gf[2]);
      // f = nio * w - on * rd
      float g_nio = dot3(gf[0], gf[1], gf[2], w[0], w[1], w[2]);
      const float g_rd = -dot3(gf[0], gf[1], gf[2], on[0], on[1], on[2]);
      float gon[3], gw[3];
      for (int k = 0; k < 3; ++k) {
        gw[k] = nio * gf[k];
        gon[k] = -rd * gf[k];
      }
      // w = d - on * dt
      float g_dt = -dot3(gw[0], gw[1], gw[2], on[0], on[1], on[2]);
      for (int k = 0; k < 3; ++k) {
        gdd[k] += gw[k];
        gon[k] += -dt * gw[k];
      }
      // rd = sqrt(max(rdisc, eps)), rdisc = 1 - nio^2 (1 - dt^2)
      const float g_rdisc = rdisc >= kEps ? 0.5f * g_rd / rd : 0.0f;
      g_nio += 2.0f * nio * (-g_rdisc * omd);
      g_dt += -2.0f * dt * (-g_rdisc * nn);
      // dt = d . on
      for (int k = 0; k < 3; ++k) {
        gdd[k] += g_dt * on[k];
        gon[k] += g_dt * d[k];
        gn[k] += exiting ? -gon[k] : gon[k];
      }
      // nio = ri (exiting) or 1 / ri
      g_ref = exiting ? g_nio : -g_nio / (ri * ri);
    }
    return;
  }
  float bx, by, bz;
  in_unit_ball(seed, rid, bounce, kSlotScatterBall, bx, by, bz);
  const float ball[3] = {bx, by, bz};
  if (mt == 1) {  // metal: normalize(reflect(d, n) + fuzz * ball)
    const float d2 = 2.0f * dot3(d[0], d[1], d[2], n[0], n[1], n[2]);
    float x[3];
    for (int k = 0; k < 3; ++k) x[k] = (d[k] - d2 * n[k]) + fz * ball[k];
    float gx[3];
    normalize3_adj(x[0], x[1], x[2], gs[0], gs[1], gs[2], gx[0], gx[1],
                   gx[2]);
    g_fuzz = dot3(gx[0], gx[1], gx[2], bx, by, bz);
    reflect3_adj(d, n, gx, gdd, gn);
  } else {  // lambertian: normalize(n + ball)
    float gl[3];
    normalize3_adj(n[0] + bx, n[1] + by, n[2] + bz, gs[0], gs[1], gs[2],
                   gl[0], gl[1], gl[2]);
    for (int k = 0; k < 3; ++k) gn[k] += gl[k];
  }
}

// One replayed bounce that hit row j and continued: o' = p, d' = scatter
// direction, a' = a * albedo. On entry go, gd, ga hold the cotangents of
// o', d', a'; on exit those of o, d, a. gcol receives the cotangents of
// the row's ten GRAD_ROWS columns. reflected: the dielectric's recorded
// mirror choice.
__device__ __forceinline__ void hit_bounce_adj(
    const float* tab, int S, int j, float t_min, const float o[3],
    const float d[3], const float a[3], bool reflected, uint32_t seed,
    uint32_t rid, uint32_t bounce, float go[3], float gd[3], float ga[3],
    float gcol[kNumGrad]) {
  // ---- forward recompute (replay_hit's ops) -----------------------------
  const float c[3] = {tab[kECX * S + j], tab[kECY * S + j],
                      tab[kECZ * S + j]};
  const float ivr = tab[kEINVR * S + j];
  const float alb[3] = {tab[kEALBX * S + j], tab[kEALBY * S + j],
                        tab[kEALBZ * S + j]};
  const float g[3] = {c[0] - o[0], c[1] - o[1], c[2] - o[2]};
  const float nb = g[0] * d[0] + g[1] * d[1] + g[2] * d[2];
  const float cc = g[0] * g[0] + g[1] * g[1] + g[2] * g[2] -
                   tab[kERSQ * S + j];
  const float disc = nb * nb - cc;
  const float sq = sqrtf(clamp_min_nan(disc, kEps));
  const float t1 = nb - sq;
  const bool near = t1 > t_min;
  const float t = near ? t1 : nb + sq;
  const float p[3] = {o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]};
  const float pc[3] = {p[0] - c[0], p[1] - c[1], p[2] - c[2]};
  const float n[3] = {pc[0] * ivr, pc[1] * ivr, pc[2] * ivr};

  // ---- attenuation: a' = a * albedo -------------------------------------
  for (int k = 0; k < 3; ++k) {
    gcol[kEALBX + k] = ga[k] * a[k];
    ga[k] = ga[k] * alb[k];
  }

  // ---- scatter: d' = s(d, n, fuzz, ref_idx) -----------------------------
  float gdd[3] = {0.0f, 0.0f, 0.0f};  // cotangent of d through scatter
  float gn[3] = {0.0f, 0.0f, 0.0f};
  scatter_adj((int)tab[kEMAT * S + j], d, n, tab[kEFUZZ * S + j],
              tab[kEREF * S + j], reflected, seed, rid, bounce, gd, gdd, gn,
              gcol[kEFUZZ], gcol[kEREF]);

  // ---- normal: n = (p - c) * inv_r --------------------------------------
  float gp[3];
  for (int k = 0; k < 3; ++k) {
    gp[k] = go[k] + gn[k] * ivr;
    gcol[kECX + k] = -gn[k] * ivr;
  }
  gcol[kEINVR] = dot3(gn[0], gn[1], gn[2], pc[0], pc[1], pc[2]);

  // ---- point: p = o + t * d ---------------------------------------------
  const float g_t = dot3(gp[0], gp[1], gp[2], d[0], d[1], d[2]);
  for (int k = 0; k < 3; ++k) {
    go[k] = gp[k];
    gd[k] = gdd[k] + gp[k] * t;
  }

  // ---- t: near root nb - sq, else nb + sq, sq = sqrt(max(disc, eps)) ------
  const float g_sq = near ? -g_t : g_t;
  const float g_disc = disc >= kEps ? 0.5f * g_sq / sq : 0.0f;
  const float g_nb = g_t + 2.0f * nb * g_disc;
  const float g_cc = -g_disc;  // disc = nb^2 - cc
  gcol[kERSQ] = -g_cc;         // cc = |g|^2 - rsq
  for (int k = 0; k < 3; ++k) {
    // nb = g . d, g = c - o
    const float gg = 2.0f * g[k] * g_cc + g_nb * d[k];
    gd[k] += g_nb * g[k];
    gcol[kECX + k] += gg;
    go[k] -= gg;
  }
}

// ---- soft mode ----------------------------------------------------------

// Replayed soft hit record of row j (render/intersect.hit_record_from_index
// with promote=False): r1b::soft_geometry on the exact table, with the
// exact material columns.
__device__ __forceinline__ SoftHit replay_soft_hit(const float* tab, int S,
                                                   int j, float t_min,
                                                   float inv_eps, float ox,
                                                   float oy, float oz,
                                                   float dx, float dy,
                                                   float dz) {
  SoftHit r;
  soft_geometry(tab[kECX * S + j], tab[kECY * S + j], tab[kECZ * S + j],
                tab[kERSQ * S + j], tab[kEINVR * S + j], t_min, inv_eps, ox,
                oy, oz, dx, dy, dz, r);
  r.h.mat_type = (int)tab[kEMAT * S + j];
  r.h.albedo_x = tab[kEALBX * S + j];
  r.h.albedo_y = tab[kEALBY * S + j];
  r.h.albedo_z = tab[kEALBZ * S + j];
  r.h.fuzz = tab[kEFUZZ * S + j];
  r.h.ref_idx = tab[kEREF * S + j];
  return r;
}

// One replayed soft bounce that hit row j and continued, in either branch
// of the two-branch draw (take: bounced off the sphere; else passed through
// from the far exit). Same contract as hit_bounce_adj. The chain, forward:
//   g = c - o, nb = g.d, cc = |g|^2 - rsq, disc = nb^2 - cc,
//   sq = sqrt(max(disc, 1e-12)), t = nb -/+ sq, p = o + t d,
//   n = normalize((p - c) * inv_r) (eps 1e-20),
//   edge = sqrt(max(rsq, 0)) - sqrt(max(cc + rsq - nb^2, 1e-20)),
//   cover = sigmoid(edge * inv_eps), t2 = nb + sq;
//   take: o' = p, d' = scatter(d, n), a' = a * (albedo * w_b),
//         w_b = cover / max(sg(cover), 1e-20);
//   pass: o' = o + t2 d, d' = d, a' = a * w_t,
//         w_t = (1 - cover) / max(1 - sg(cover), 1e-20).
// A promoted lane has disc < 0: the floor of sq blocks its cotangent, as
// torch.clamp_min does (it passes where x >= eps).
__device__ __forceinline__ void soft_bounce_adj(
    const float* tab, int S, int j, float t_min, float inv_eps,
    const float o[3], const float d[3], const float a[3], bool take,
    bool reflected, uint32_t seed, uint32_t rid, uint32_t bounce,
    float go[3], float gd[3], float ga[3], float gcol[kNumGrad]) {
  // ---- forward recompute (replay_soft_hit's ops) -------------------------
  const float c[3] = {tab[kECX * S + j], tab[kECY * S + j],
                      tab[kECZ * S + j]};
  const float rsq = tab[kERSQ * S + j];
  const float ivr = tab[kEINVR * S + j];
  const float alb[3] = {tab[kEALBX * S + j], tab[kEALBY * S + j],
                        tab[kEALBZ * S + j]};
  const float g[3] = {c[0] - o[0], c[1] - o[1], c[2] - o[2]};
  const float nb = g[0] * d[0] + g[1] * d[1] + g[2] * d[2];
  const float cc = g[0] * g[0] + g[1] * g[1] + g[2] * g[2] - rsq;
  const float disc = nb * nb - cc;
  const float sq = sqrtf(clamp_min_nan(disc, kEps));
  const float t1 = nb - sq;
  const bool near = t1 > t_min;
  const float t = near ? t1 : nb + sq;
  const float t2 = nb + sq;
  const float bsq = cc + rsq - nb * nb;
  const float b_imp = sqrtf(clamp_min_nan(bsq, kTiny));
  const float sr = sqrtf(clamp_min_nan(rsq, 0.0f));
  const float x = (sr - b_imp) * inv_eps;
  const float cover = sigmoid(x);

  float g_cover, g_t = 0.0f, g_t2 = 0.0f;
  float gp[3] = {0.0f, 0.0f, 0.0f};   // cotangent of p (take)
  float gp2[3] = {0.0f, 0.0f, 0.0f};  // cotangent of p2 (pass)
  float gdd[3] = {0.0f, 0.0f, 0.0f};  // cotangent of d through d'
  if (take) {
    const float p[3] = {o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]};
    const float pc[3] = {p[0] - c[0], p[1] - c[1], p[2] - c[2]};
    const float nr[3] = {pc[0] * ivr, pc[1] * ivr, pc[2] * ivr};
    const float inv_len = 1.0f / sqrtf(clamp_min_nan(
        nr[0] * nr[0] + nr[1] * nr[1] + nr[2] * nr[2], kTiny));
    const float n[3] = {nr[0] * inv_len, nr[1] * inv_len, nr[2] * inv_len};
    // a' = a * (albedo * w_b)
    const float w_b = bounce_weight(cover);
    float g_wb = 0.0f;
    for (int k = 0; k < 3; ++k) {
      const float g_m = ga[k] * a[k];
      gcol[kEALBX + k] = g_m * w_b;
      g_wb += g_m * alb[k];
      ga[k] = ga[k] * (alb[k] * w_b);
    }
    g_cover = g_wb / clamp_min_nan(cover, kTiny);
    // d' = scatter(d, n)
    float gn[3] = {0.0f, 0.0f, 0.0f};
    scatter_adj((int)tab[kEMAT * S + j], d, n, tab[kEFUZZ * S + j],
                tab[kEREF * S + j], reflected, seed, rid, bounce, gd, gdd,
                gn, gcol[kEFUZZ], gcol[kEREF]);
    // n = normalize(nr), nr = (p - c) * inv_r
    float gnr[3];
    normalize3_adj(nr[0], nr[1], nr[2], gn[0], gn[1], gn[2], gnr[0], gnr[1],
                   gnr[2], kTiny);
    for (int k = 0; k < 3; ++k) {
      gp[k] = go[k] + gnr[k] * ivr;
      gcol[kECX + k] = -gnr[k] * ivr;
    }
    gcol[kEINVR] = dot3(gnr[0], gnr[1], gnr[2], pc[0], pc[1], pc[2]);
    g_t = dot3(gp[0], gp[1], gp[2], d[0], d[1], d[2]);  // p = o + t d
  } else {
    // a' = a * w_t, d' = d, o' = p2
    const float w_t = pass_weight(cover);
    float g_wt = 0.0f;
    for (int k = 0; k < 3; ++k) {
      g_wt += ga[k] * a[k];
      ga[k] = ga[k] * w_t;
      gcol[kEALBX + k] = 0.0f;
      gcol[kECX + k] = 0.0f;
      gdd[k] = gd[k];
      gp2[k] = go[k];
    }
    gcol[kEFUZZ] = 0.0f;
    gcol[kEREF] = 0.0f;
    gcol[kEINVR] = 0.0f;
    g_cover = -g_wt / clamp_min_nan(1.0f - cover, kTiny);
    g_t2 = dot3(gp2[0], gp2[1], gp2[2], d[0], d[1], d[2]);  // p2 = o + t2 d
  }
  for (int k = 0; k < 3; ++k) {
    go[k] = gp[k] + gp2[k];
    gd[k] = gdd[k] + gp[k] * t + gp2[k] * t2;
  }

  // ---- cover = sigmoid(x), x = edge * inv_eps ------------------------------
  // vecmath.sigmoid's derivative: g * (y * (1 - y)), as lax.logistic's.
  const float g_edge = g_cover * (cover * (1.0f - cover)) * inv_eps;
  // edge = sr - b_imp, sr = sqrt(max(rsq, 0)), b_imp = sqrt(max(bsq, 1e-20))
  float g_rsq = rsq >= 0.0f ? 0.5f * g_edge / sr : 0.0f;
  const float g_bsq = bsq >= kTiny ? 0.5f * -g_edge / b_imp : 0.0f;
  // bsq = cc + rsq - nb^2
  float g_cc = g_bsq;
  g_rsq += g_bsq;
  float g_nb = -2.0f * nb * g_bsq;

  // ---- t = nb -/+ sq, t2 = nb + sq, sq = sqrt(max(disc, 1e-12)) ------------
  const float g_sq = (near ? -g_t : g_t) + g_t2;
  g_nb += g_t + g_t2;
  const float g_disc = disc >= kEps ? 0.5f * g_sq / sq : 0.0f;
  g_nb += 2.0f * nb * g_disc;
  g_cc += -g_disc;              // disc = nb^2 - cc
  gcol[kERSQ] = g_rsq - g_cc;   // cc = |g|^2 - rsq
  for (int k = 0; k < 3; ++k) {
    // nb = g . d, g = c - o
    const float gg = 2.0f * g[k] * g_cc + g_nb * d[k];
    gd[k] += g_nb * g[k];
    gcol[kECX + k] += gg;
    go[k] -= gg;
  }
}

// ---- the fused backward's lane (mega_backward.cu) --------------------------

// One primary ray of the fixed-topology replay, forward then reverse
// (mega_backward.backward_reference for one ray).
//
// Forward: the ray re-advances (o, d, a) bounce by bounce through its
// recorded rows topo_i[b * N] with the replay's exact math and checkpoints
// each live bounce's 9 floats, with the continue, dielectric-mirror and
// (kSoft) take bits. kCap is the checkpoint array's depth cap: max_bounces
// must not exceed it. alive: the ray is not padding.
//
// Reverse: steps = steps_of(live) iterations, live the ray's live bounces;
// iteration k pulls the cotangents back through bounce live - 1 - k, or
// does nothing once that is below 0. Each iteration ends with
// acc(has, j, gcol): has is true where the bounce hit row j and continued,
// and gcol then holds the row's ten GRAD_ROWS column cotangents (zeros
// otherwise). On the card steps_of is the warp's largest live, so that
// every lane of a warp calls acc together and it can sum over the warp; on
// the host it is the identity. On exit go, gd hold the cotangents of the
// primary ray's origin and direction; crad is its radiance cotangent.
template <bool kSoft, int kCap, class StepsOf, class Acc>
__device__ __forceinline__ void backward_ray(
    const float* tab, int S, const int* topo_i, int N, bool alive,
    uint32_t rid, const float o0[3], const float d0[3], const float crad[3],
    int max_bounces, float t_min, uint32_t seed, float inv_eps, float go[3],
    float gd[3], StepsOf steps_of, Acc acc) {
  float o[3] = {o0[0], o0[1], o0[2]};
  float d[3] = {d0[0], d0[1], d0[2]};
  float a[3] = {1.0f, 1.0f, 1.0f};
  float st[kCap + 1][9];
  uint64_t cont_bits = 0, mirror_bits = 0, take_bits = 0;
  int live = 0;

  // ---- forward replay: advance and checkpoint -----------------------------
  for (int b = 0; b <= max_bounces && alive; ++b) {
    for (int k = 0; k < 3; ++k) {
      st[b][k] = o[k];
      st[b][3 + k] = d[k];
      st[b][6 + k] = a[k];
    }
    live = b + 1;
    const int j = topo_i[(size_t)b * N];
    bool cont = false;
    if (j >= 0 && kSoft) {
      const SoftHit sh = replay_soft_hit(tab, S, j, t_min, inv_eps, o[0],
                                         o[1], o[2], d[0], d[1], d[2]);
      float s3[3];
      bool mirror = false;
      bool ok = scatter(sh.h, d[0], d[1], d[2], seed, rid, (uint32_t)b,
                        s3[0], s3[1], s3[2], &mirror);
      const bool take =
          uniform01(seed, rid, (uint32_t)b, kSlotSilhouetteP) < sh.cover;
      float m[3], h3[3];
      if (take) {
        const float w = bounce_weight(sh.cover);
        m[0] = sh.h.albedo_x * w;
        m[1] = sh.h.albedo_y * w;
        m[2] = sh.h.albedo_z * w;
        h3[0] = sh.h.px;
        h3[1] = sh.h.py;
        h3[2] = sh.h.pz;
      } else {
        m[0] = m[1] = m[2] = pass_weight(sh.cover);
        for (int k = 0; k < 3; ++k) s3[k] = d[k];
        h3[0] = sh.p2x;
        h3[1] = sh.p2y;
        h3[2] = sh.p2z;
        ok = true;
      }
      cont = ok && b < max_bounces;
      if (cont) {
        cont_bits |= 1ull << b;
        if (take) take_bits |= 1ull << b;
        if (take && mirror) mirror_bits |= 1ull << b;
        for (int k = 0; k < 3; ++k) {
          o[k] = h3[k];
          d[k] = s3[k];
          a[k] = a[k] * m[k];
        }
      }
    } else if (j >= 0) {
      const Hit h = replay_hit(tab, S, j, t_min, o[0], o[1], o[2], d[0], d[1],
                               d[2]);
      float sx, sy, sz;
      bool mirror = false;
      const bool ok = scatter(h, d[0], d[1], d[2], seed, rid, (uint32_t)b,
                              sx, sy, sz, &mirror);
      cont = ok && b < max_bounces;
      if (cont) {
        cont_bits |= 1ull << b;
        if (mirror) mirror_bits |= 1ull << b;
        o[0] = h.px;
        o[1] = h.py;
        o[2] = h.pz;
        d[0] = sx;
        d[1] = sy;
        d[2] = sz;
        a[0] = a[0] * h.albedo_x;
        a[1] = a[1] * h.albedo_y;
        a[2] = a[2] * h.albedo_z;
      }
    }
    alive = cont;
  }

  // ---- reverse --------------------------------------------------------------
  for (int k = 0; k < 3; ++k) go[k] = gd[k] = 0.0f;
  float ga[3] = {0.0f, 0.0f, 0.0f};
  const int steps = steps_of(live);
  for (int k = 0; k < steps; ++k) {
    const int b = live - 1 - k;
    float gcol[kNumGrad] = {};
    int j = -1;
    bool has = false;
    if (b >= 0) {
      j = topo_i[(size_t)b * N];
      const float so[3] = {st[b][0], st[b][1], st[b][2]};
      const float sd[3] = {st[b][3], st[b][4], st[b][5]};
      const float sa[3] = {st[b][6], st[b][7], st[b][8]};
      if (j < 0) {
        // Miss: radiance += a * sky(d); the state passes through.
        sky_adj(sa, sd[1], crad, ga, gd[1]);
      } else if (cont_bits >> b & 1ull) {
        has = true;
        const bool mirror = (mirror_bits >> b & 1ull) != 0;
        if (kSoft) {
          soft_bounce_adj(tab, S, j, t_min, inv_eps, so, sd, sa,
                          (take_bits >> b & 1ull) != 0, mirror, seed, rid,
                          (uint32_t)b, go, gd, ga, gcol);
        } else {
          hit_bounce_adj(tab, S, j, t_min, so, sd, sa, mirror, seed, rid,
                         (uint32_t)b, go, gd, ga, gcol);
        }
      }
      // A hit that did not continue (absorbed, depth cap) adds no radiance
      // and leaves the state as it was: its cotangents pass through.
    }
    acc(has, j, gcol);
  }
}

}  // namespace r1b
