// Reverse-mode adjoints of the per-ray math in path_math.cuh, derived by
// hand: the fixed-topology replay bounce of the gradient path
// (rays1bench_tpu_torch/kernels/mega_backward.py `bounce_core`, hard mode).
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
//   exiting / can_refract / reflect draw, metal_ok, and the continue mask,
//   which the replay records in its forward pass.
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
// cotangent of x in (ax, ay, az).
__device__ __forceinline__ void normalize3_adj(float x, float y, float z,
                                               float gx, float gy, float gz,
                                               float& ax, float& ay,
                                               float& az) {
  const float m = x * x + y * y + z * z;
  const float q = sqrtf(clamp_min_nan(m, kEps));
  const float inv = 1.0f / q;
  const float g_inv = gx * x + gy * y + gz * z;
  // inv = 1/q, q = sqrt(m): d inv / d m = -0.5 * inv^3 (0 under the floor).
  const float g_m = m >= kEps ? -0.5f * g_inv * inv * inv * inv : 0.0f;
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
  const float fz = tab[kEFUZZ * S + j];
  const float ri = tab[kEREF * S + j];
  const int mt = (int)tab[kEMAT * S + j];
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
  const float gs[3] = {gd[0], gd[1], gd[2]};
  float gdd[3] = {0.0f, 0.0f, 0.0f};  // cotangent of d through scatter
  float gn[3] = {0.0f, 0.0f, 0.0f};
  gcol[kEFUZZ] = 0.0f;
  gcol[kEREF] = 0.0f;
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
      gcol[kEREF] = exiting ? g_nio : -g_nio / (ri * ri);
    }
  } else {
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
      gcol[kEFUZZ] = dot3(gx[0], gx[1], gx[2], bx, by, bz);
      reflect3_adj(d, n, gx, gdd, gn);
    } else {  // lambertian: normalize(n + ball)
      normalize3_adj(n[0] + bx, n[1] + by, n[2] + bz, gs[0], gs[1], gs[2],
                     gn[0], gn[1], gn[2]);
    }
  }

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

}  // namespace r1b
