// Per-ray math shared by the port's path-tracing kernels: the counter-hash
// RNG lattice, the samplers, thin-lens raygen, the dense closest-hit sweep
// over the packed sphere table, its unpack, material scatter and the sky.
//
// Each function computes exactly what its plain PyTorch counterpart computes
// (rays1bench_tpu_torch/core/rng.py, render/camera.py, render/materials.py,
// render/integrator.py, kernels/megakernel.py), op for op and in the same
// order. That equality holds only when the file is compiled with
// --fmad=false and without --use_fast_math (kernels/build.py): no
// multiply-add is contracted, division and sqrtf are IEEE, and sqrtf of a
// negative number is NaN. Float constants are written as the hexadecimal
// float32 values the Python side rounds its literals to.
#pragma once

#include <stdint.h>

namespace r1b {

// ---- RNG lattice (core/rng.py) ---------------------------------------------

constexpr uint32_t kStreamRay = 0x9E3779B9u;
constexpr uint32_t kStreamBounce = 0x85EBCA77u;
constexpr uint32_t kStreamSlot = 0xC2B2AE3Du;

constexpr uint32_t kSlotPixelJitter = 0;
constexpr uint32_t kSlotLens = 2;
constexpr uint32_t kSlotScatterBall = 8;
constexpr uint32_t kSlotDielectricP = 13;
constexpr uint32_t kBounceRaygen = 0xFFFFFFFFu;  // bounce == -1 lattice row

__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t ray_id,
                                              uint32_t bounce, uint32_t slot) {
  uint32_t h = pcg_hash(seed + ray_id * kStreamRay);
  return pcg_hash(h + bounce * kStreamBounce + slot * kStreamSlot);
}

__device__ __forceinline__ float uniform01(uint32_t seed, uint32_t ray_id,
                                           uint32_t bounce, uint32_t slot) {
  return (float)(int)(hash_bits(seed, ray_id, bounce, slot) & 0xFFFFFFu) *
         0x1p-24f;
}

__device__ __forceinline__ void uniform_pair16(uint32_t seed, uint32_t ray_id,
                                               uint32_t bounce, uint32_t slot,
                                               float& u, float& v) {
  uint32_t bits = hash_bits(seed, ray_id, bounce, slot);
  u = (float)(int)(bits & 0xFFFFu) * 0x1p-16f;
  v = (float)(int)(bits >> 16) * 0x1p-16f;
}

// (sin(2 pi t), cos(2 pi t)) for t in [0, 1): rng.sincos2pi.
__device__ __forceinline__ void sincos2pi(float t, float& sn, float& cs) {
  const float c0 = 0x1p+0f, c1 = -0x1.3bd3aep+0f, c2 = 0x1.03bd86p-2f,
              c3 = -0x1.550192p-6f, c4 = 0x1.c29b9p-11f;
  const float s0 = 0x1.921fb4p+0f, s1 = -0x1.4abbb8p-1f, s2 = 0x1.4667b2p-4f,
              s3 = -0x1.323858p-8f, s4 = 0x1.3c93eap-13f;
  float x = t * 4.0f;
  float q = floorf(x);
  float f = x - q;
  float f2 = f * f;
  float c = c0 + f2 * (c1 + f2 * (c2 + f2 * (c3 + f2 * c4)));
  float s = f * (s0 + f2 * (s1 + f2 * (s2 + f2 * (s3 + f2 * s4))));
  if (q == 1.0f) {
    sn = c; cs = -s;
  } else if (q == 2.0f) {
    sn = -s; cs = -c;
  } else if (q == 3.0f) {
    sn = -c; cs = s;
  } else {
    sn = s; cs = c;
  }
}

// max(x, lo) that keeps a NaN x, as torch.clamp_min and jnp.maximum do.
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ void in_unit_ball(uint32_t seed, uint32_t ray_id,
                                             uint32_t bounce, uint32_t slot0,
                                             float& bx, float& by, float& bz) {
  float u, v;
  uniform_pair16(seed, ray_id, bounce, slot0, u, v);
  uint32_t bits = hash_bits(seed, ray_id, bounce, slot0 + 1u);
  uint32_t w1 = bits & 0x3FFu;
  uint32_t w2 = (bits >> 10) & 0x3FFu;
  uint32_t w3 = (bits >> 20) & 0x3FFu;
  uint32_t w = w1 > w2 ? w1 : w2;
  w = w > w3 ? w : w3;
  float r = (float)(int)w * 0x1p-10f;
  float z = 2.0f * u - 1.0f;
  float s = sqrtf(clamp_min_nan(1.0f - z * z, 0.0f));
  float sp, cp;
  sincos2pi(v, sp, cp);
  bx = r * s * cp;
  by = r * s * sp;
  bz = r * z;
}

__device__ __forceinline__ void in_unit_disk(uint32_t seed, uint32_t ray_id,
                                             uint32_t bounce, uint32_t slot0,
                                             float& x, float& y) {
  float u, v;
  uniform_pair16(seed, ray_id, bounce, slot0, u, v);
  float r = sqrtf(u);
  float st, ct;
  sincos2pi(v, st, ct);
  x = r * ct;
  y = r * st;
}

// ---- vector helpers (core/vecmath.py) --------------------------------------

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// IEEE 1/sqrt, never rsqrtf.
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float eps = 0x1.197998p-40f;  // float32(1e-12)
  float inv = 1.0f / sqrtf(clamp_min_nan(x * x + y * y + z * z, eps));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// ---- camera (render/camera.py, packed by megakernel.pack_camera) -----------

// cam[19] = origin(3), lower_left(3), horizontal(3), vertical(3), u(3), v(3),
// lens_radius. s, t: film coordinates; rid: the ray id.
__device__ __forceinline__ void generate_ray(const float* cam, float s,
                                             float t, uint32_t seed,
                                             uint32_t rid, float& ox,
                                             float& oy, float& oz, float& dx,
                                             float& dy, float& dz) {
  float rdx, rdy;
  in_unit_disk(seed, rid, kBounceRaygen, kSlotLens, rdx, rdy);
  rdx = rdx * cam[18];
  rdy = rdy * cam[18];
  ox = cam[0] + cam[12] * rdx + cam[15] * rdy;
  oy = cam[1] + cam[13] * rdx + cam[16] * rdy;
  oz = cam[2] + cam[14] * rdx + cam[17] * rdy;
  dx = cam[3] + s * cam[6] + t * cam[9] - ox;
  dy = cam[4] + s * cam[7] + t * cam[10] - oy;
  dz = cam[5] + s * cam[8] + t * cam[11] - oz;
  float inv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx * inv;
  dy = dy * inv;
  dz = dz * inv;
}

// ---- packed sphere table (megakernel.pack_spheres) -------------------------

// Rows of the (7, S) float32 table; row-major, S floats per row.
enum Row { kCX = 0, kCY, kCZ, kRSQ, kINVR, kALB, kMTP, kNumRows };

// Dense closest-hit sweep over all S rows, first minimum wins
// (megakernel._make_intersect, hard mode). Returns the winning row, or -1;
// bt is the winning root (+inf with no candidate). A miss needs no mask:
// placeholder rows carry radius_sq = -1e30, so their discriminant is
// negative, sqrtf gives NaN and every comparison with NaN is false. Rows
// with a negative discriminant are skipped before the square root; that
// changes no result, since they could not win.
__device__ __forceinline__ int sweep(const float* sph, int S, float t_min,
                                     float ox, float oy, float oz, float dx,
                                     float dy, float dz, float& bt) {
  bt = __int_as_float(0x7f800000);  // +inf
  int best = -1;
  for (int s = 0; s < S; ++s) {
    float cox = sph[kCX * S + s] - ox;
    float coy = sph[kCY * S + s] - oy;
    float coz = sph[kCZ * S + s] - oz;
    float nb = cox * dx + coy * dy + coz * dz;
    float c = cox * cox + coy * coy + coz * coz - sph[kRSQ * S + s];
    float disc = nb * nb - c;
    if (disc < 0.0f) continue;
    float sq = sqrtf(disc);
    float t1 = nb - sq;
    float t2 = nb + sq;
    float t = t1 > t_min ? t1 : t2;
    if (t < bt && t > t_min) {
      bt = t;
      best = s;
    }
  }
  return best;
}

struct Hit {
  float px, py, pz, nx, ny, nz;
  int mat_type;
  float albedo_x, albedo_y, albedo_z, fuzz, ref_idx;
};

// Unpack the winner's payload (megakernel._closest_hit_record): hit point,
// normal (p - c) * inv_radius, albedo decoded from r*65536 + g*256 + b times
// float32(1/255), and mt*32 + param split by floor.
__device__ __forceinline__ Hit unpack_hit(const float* sph, int S, int best,
                                          float t, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz) {
  Hit h;
  float cx = sph[kCX * S + best], cy = sph[kCY * S + best],
        cz = sph[kCZ * S + best];
  float ivr = sph[kINVR * S + best];
  float albp = sph[kALB * S + best], mtp = sph[kMTP * S + best];
  h.px = ox + t * dx;
  h.py = oy + t * dy;
  h.pz = oz + t * dz;
  h.nx = (h.px - cx) * ivr;
  h.ny = (h.py - cy) * ivr;
  h.nz = (h.pz - cz) * ivr;
  float mt_f = floorf(mtp * (1.0f / 32.0f));
  h.mat_type = (int)mt_f;
  float mparam = mtp - mt_f * 32.0f;
  float a_r = floorf(albp * (1.0f / 65536.0f));
  float rem = albp - a_r * 65536.0f;
  float a_g = floorf(rem * (1.0f / 256.0f));
  float a_b = rem - a_g * 256.0f;
  const float inv255 = 0x1.010102p-8f;  // float32(1/255)
  h.albedo_x = a_r * inv255;
  h.albedo_y = a_g * inv255;
  h.albedo_z = a_b * inv255;
  h.fuzz = mparam;
  h.ref_idx = h.mat_type == 2 ? mparam : 1.0f;
  return h;
}

// ---- scatter (render/materials.py) and sky (render/integrator.py) ----------

// Scattered unit direction and whether the ray survives (only metals absorb).
// The attenuation is the hit's albedo (dielectrics store 1). If `reflected`
// is given, a dielectric stores there whether it took the mirror branch.
__device__ __forceinline__ bool scatter(const Hit& h, float dx, float dy,
                                        float dz, uint32_t seed, uint32_t rid,
                                        uint32_t bounce, float& sx, float& sy,
                                        float& sz,
                                        bool* reflected = nullptr) {
  const float eps = 0x1.197998p-40f;  // float32(1e-12)
  if (h.mat_type == 2) {  // dielectric (rayweek1.cpp:461-512)
    float rx, ry, rz;
    float d2 = 2.0f * dot3(dx, dy, dz, h.nx, h.ny, h.nz);
    rx = dx - d2 * h.nx;
    ry = dy - d2 * h.ny;
    rz = dz - d2 * h.nz;
    float d_dot_n = dot3(dx, dy, dz, h.nx, h.ny, h.nz);
    bool exiting = d_dot_n > 0.0f;
    float onx = exiting ? -h.nx : h.nx;
    float ony = exiting ? -h.ny : h.ny;
    float onz = exiting ? -h.nz : h.nz;
    float ri = h.ref_idx;
    float ni_over_nt = exiting ? ri : 1.0f / ri;
    float cosine = exiting ? ri * d_dot_n : -d_dot_n;
    float dt = dot3(dx, dy, dz, onx, ony, onz);
    float refr_disc = 1.0f - ni_over_nt * ni_over_nt * (1.0f - dt * dt);
    bool can_refract = refr_disc > 0.0f;
    float rd = sqrtf(clamp_min_nan(refr_disc, eps));
    float fx = ni_over_nt * (dx - onx * dt) - onx * rd;
    float fy = ni_over_nt * (dy - ony * dt) - ony * rd;
    float fz = ni_over_nt * (dz - onz * dt) - onz * rd;
    normalize3(fx, fy, fz);
    float r0 = (1.0f - ri) / (1.0f + ri);
    r0 = r0 * r0;
    float one_c = 1.0f - cosine;
    float one_c2 = one_c * one_c;
    float schlick_p = r0 + (1.0f - r0) * one_c2 * one_c2 * one_c;
    float reflect_prob = can_refract ? schlick_p : 1.0f;
    float u = uniform01(seed, rid, bounce, kSlotDielectricP);
    bool take_reflect = u < reflect_prob;
    if (reflected) *reflected = take_reflect;
    sx = take_reflect ? rx : fx;
    sy = take_reflect ? ry : fy;
    sz = take_reflect ? rz : fz;
    return true;
  }
  float bx, by, bz;
  in_unit_ball(seed, rid, bounce, kSlotScatterBall, bx, by, bz);
  if (h.mat_type == 1) {  // metal (rayweek1.cpp:419-437)
    float d2 = 2.0f * dot3(dx, dy, dz, h.nx, h.ny, h.nz);
    float rx = dx - d2 * h.nx;
    float ry = dy - d2 * h.ny;
    float rz = dz - d2 * h.nz;
    sx = rx + h.fuzz * bx;
    sy = ry + h.fuzz * by;
    sz = rz + h.fuzz * bz;
    normalize3(sx, sy, sz);
    return dot3(sx, sy, sz, h.nx, h.ny, h.nz) > 0.0f;
  }
  // lambertian (rayweek1.cpp:396-412)
  sx = h.nx + bx;
  sy = h.ny + by;
  sz = h.nz + bz;
  normalize3(sx, sy, sz);
  return true;
}

__device__ __forceinline__ void sky_color(float dy, float& r, float& g,
                                          float& b) {
  float t = 0.5f * (dy + 1.0f);
  float s = 1.0f - t;
  r = s + t * 0.5f;
  g = s + t * 0x1.666666p-1f;  // float32(0.7)
  b = s + t * 1.0f;
}

}  // namespace r1b
