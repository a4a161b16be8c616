// Per-ray math shared by the port's path-tracing kernels: the counter-hash
// RNG lattice, the samplers, thin-lens raygen, the dense closest-hit sweep
// over the broadcast layout of the sphere table (float4 hot rows), its
// unpack, the soft-silhouette mode's graze sweep and soft record, material
// scatter, the sky, the respawn, one-shot and phase kernels' whole lanes
// (respawn_pixel, oneshot_lane, phase_lane), the raygen kernel's (id_ray)
// and the index kernel's tiled sweep (index_tiles).
//
// Each function computes exactly what its plain PyTorch counterpart computes
// (rays1bench_tpu_torch/core/rng.py, core/vecmath.py, render/camera.py,
// render/intersect.py, render/materials.py, render/integrator.py,
// kernels/megakernel.py), op for op and in the same
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
// (megakernel._make_intersect, hard mode), over the broadcast layout of
// stage_row: the hot rows interleaved as float4 {cx, cy, cz, radius_sq}, one
// 128-bit shared load per sphere that every lane of a warp reads at once,
// unrolled kSweepUnroll times. Returns the winning row, or -1; bt is the
// winning root (+inf with no candidate). A miss needs no mask: placeholder
// rows carry radius_sq = -1e30, so their discriminant is negative, sqrtf
// gives NaN and every comparison with NaN is false. Rows with a negative
// discriminant are skipped before the square root; that changes no result,
// since they could not win.
constexpr int kSweepUnroll = 8;

__device__ __forceinline__ int sweep4(const float4* hot, int S, float t_min,
                                      float ox, float oy, float oz, float dx,
                                      float dy, float dz, float& bt) {
  bt = __int_as_float(0x7f800000);  // +inf
  int best = -1;
#pragma unroll kSweepUnroll
  for (int s = 0; s < S; ++s) {
    const float4 h = hot[s];
    float cox = h.x - ox;
    float coy = h.y - oy;
    float coz = h.z - oz;
    float nb = cox * dx + coy * dy + coz * dz;
    float c = cox * cox + coy * coy + coz * coz - h.w;
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

// Row s of the row-major (7, S) table into the broadcast layout: hot[s],
// and inv_radius, packed albedo and mt*32 + param at pay[k * S + s].
__device__ __forceinline__ void stage_row(const float* sph, int S, int s,
                                          float4* hot, float* pay) {
  hot[s].x = sph[kCX * S + s];
  hot[s].y = sph[kCY * S + s];
  hot[s].z = sph[kCZ * S + s];
  hot[s].w = sph[kRSQ * S + s];
  for (int k = 0; k < 3; ++k) pay[k * S + s] = sph[(kINVR + k) * S + s];
}

struct Hit {
  float px, py, pz, nx, ny, nz;
  int mat_type;
  float albedo_x, albedo_y, albedo_z, fuzz, ref_idx;
};

// Decode the packed payload into h's material fields: albedo from
// r*65536 + g*256 + b times float32(1/255), mt*32 + param split by floor.
__device__ __forceinline__ void decode_material(float albp, float mtp,
                                                Hit& h) {
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
}

// The winner's hit record (megakernel._closest_hit_record): hit point,
// normal (p - c) * inv_radius and the decoded payload.
__device__ __forceinline__ Hit decode_hit(float cx, float cy, float cz,
                                          float ivr, float albp, float mtp,
                                          float t, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz) {
  Hit h;
  h.px = ox + t * dx;
  h.py = oy + t * dy;
  h.pz = oz + t * dz;
  h.nx = (h.px - cx) * ivr;
  h.ny = (h.py - cy) * ivr;
  h.nz = (h.pz - cz) * ivr;
  decode_material(albp, mtp, h);
  return h;
}

// decode_hit of row `best` of the broadcast layout (stage_row).
__device__ __forceinline__ Hit unpack_hit4(const float4* hot,
                                           const float* pay, int S, int best,
                                           float t, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz) {
  const float4 c = hot[best];
  return decode_hit(c.x, c.y, c.z, pay[best], pay[S + best],
                    pay[2 * S + best], t, ox, oy, oz, dx, dy, dz);
}

// ---- soft-silhouette mode (megakernel.graze_sweep, soft_sweep,
// soft_hit_record; render/integrator.two_branch) ------------------------------

constexpr uint32_t kSlotSilhouetteP = 14;
constexpr float kTiny = 0x1.79ca1p-67f;    // float32(1e-20)
constexpr float kEps12 = 0x1.197998p-40f;  // float32(1e-12)

// 1 / (1 + exp(-x)) in double, rounded to float: core/vecmath.sigmoid.
__device__ __forceinline__ float sigmoid(float x) {
  return (float)(1.0 / (1.0 + exp(-(double)x)));
}

// The graze sweep over the broadcast layout (stage_row), unrolled as
// sweep4: among rows with radius_sq > -1e29 whose closest approach nb lies
// in (t_min, bt) and that the ray misses (edge <= 0), the first row with the
// largest edge = sr[s] - sqrt(max(|co|^2 - nb^2, 1e-20)), where sr[s] =
// sqrt(max(radius_sq, 0)) is staged per block (the same float op, so the
// same bits). The cheap tests run before the second square root. Returns
// the row, or -1; be is its edge (-inf without one), gnb its nb.
__device__ __forceinline__ int graze_sweep4(const float4* hot,
                                            const float* sr, int S,
                                            float t_min, float ox, float oy,
                                            float oz, float dx, float dy,
                                            float dz, float bt, float& be,
                                            float& gnb) {
  be = -__int_as_float(0x7f800000);  // -inf
  gnb = 0.0f;
  int row = -1;
#pragma unroll kSweepUnroll
  for (int s = 0; s < S; ++s) {
    const float4 h = hot[s];
    const float cox = h.x - ox;
    const float coy = h.y - oy;
    const float coz = h.z - oz;
    const float nb = cox * dx + coy * dy + coz * dz;
    if (!(nb > t_min && nb < bt && h.w > -0x1.431e1p+96f)) continue;
    const float co2 = cox * cox + coy * coy + coz * coz;
    const float edge = sr[s] - sqrtf(clamp_min_nan(co2 - nb * nb, kTiny));
    if (edge <= 0.0f && edge > be) {
      be = edge;
      gnb = nb;
      row = s;
    }
  }
  return row;
}

struct SoftHit {
  Hit h;
  float cover, p2x, p2y, p2z;
};

// Geometry of a soft hit on the sphere (c, rsq, ivr) (render/intersect.
// soft_fields): t recomputed with safe_sqrt, the point, the normal
// renormalized with IEEE 1/sqrt, cover = sigmoid(edge * inv_eps) and the far
// exit o + (nb + sq) d. Leaves the material fields of r.h unset.
__device__ __forceinline__ void soft_geometry(float cx, float cy, float cz,
                                              float rsq, float ivr,
                                              float t_min, float inv_eps,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              SoftHit& r) {
  const float gx = cx - ox, gy = cy - oy, gz = cz - oz;
  const float nb = gx * dx + gy * dy + gz * dz;
  const float c = gx * gx + gy * gy + gz * gz - rsq;
  const float sq = sqrtf(clamp_min_nan(nb * nb - c, kEps12));
  const float t1 = nb - sq;
  const float t = t1 > t_min ? t1 : nb + sq;
  Hit& h = r.h;
  h.px = ox + t * dx;
  h.py = oy + t * dy;
  h.pz = oz + t * dz;
  float nx = (h.px - cx) * ivr, ny = (h.py - cy) * ivr, nz = (h.pz - cz) * ivr;
  const float inv_len =
      1.0f / sqrtf(clamp_min_nan(nx * nx + ny * ny + nz * nz, kTiny));
  h.nx = nx * inv_len;
  h.ny = ny * inv_len;
  h.nz = nz * inv_len;
  const float b_imp = sqrtf(clamp_min_nan(c + rsq - nb * nb, kTiny));
  const float edge = sqrtf(clamp_min_nan(rsq, 0.0f)) - b_imp;
  r.cover = sigmoid(edge * inv_eps);
  const float t2 = nb + sq;
  r.p2x = ox + t2 * dx;
  r.p2y = oy + t2 * dy;
  r.p2z = oz + t2 * dz;
}

// Soft hit record of row j of the broadcast layout (stage_row;
// megakernel.soft_hit_record): soft_geometry and the payload decoded as
// unpack_hit4 decodes it.
__device__ __forceinline__ SoftHit soft_hit4(const float4* hot,
                                             const float* pay, int S, int j,
                                             float t_min, float inv_eps,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz) {
  SoftHit r;
  const float4 c = hot[j];
  soft_geometry(c.x, c.y, c.z, c.w, pay[j], t_min, inv_eps, ox, oy, oz, dx,
                dy, dz, r);
  decode_material(pay[S + j], pay[2 * S + j], r.h);
  return r;
}

// Branch weights of the two-branch draw: w_b = cover / max(cover, 1e-20)
// for the bounce, w_t = (1 - cover) / max(1 - cover, 1e-20) for the
// pass-through (both 1 in value, as the plain version computes them).
__device__ __forceinline__ float bounce_weight(float cover) {
  return cover / clamp_min_nan(cover, kTiny);
}
__device__ __forceinline__ float pass_weight(float cover) {
  return (1.0f - cover) / clamp_min_nan(1.0f - cover, kTiny);
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

// ---- the respawn kernel's lane (respawn.cu) --------------------------------

// Primary ray of sample s of pixel pid at (xf, yf): the jittered film point
// and the thin-lens ray of rid = pid * spp + s. Returns rid.
__device__ __forceinline__ uint32_t pixel_ray(const float* cam, int pid,
                                              int s, int spp, float xf,
                                              float yf, uint32_t seed,
                                              float inv_w, float inv_h,
                                              float& ox, float& oy, float& oz,
                                              float& dx, float& dy,
                                              float& dz) {
  const uint32_t rid = (uint32_t)(pid * spp + s);
  float ju, jv;
  uniform_pair16(seed, rid, kBounceRaygen, kSlotPixelJitter, ju, jv);
  generate_ray(cam, (xf + ju) * inv_w, (yf + jv) * inv_h, seed, rid, ox, oy,
               oz, dx, dy, dz);
  return rid;
}

// ---- the raygen kernel's lane (raygen.cu) ----------------------------------

// Primary ray of ray id `id` (render/pipeline.primary_rays_from_ids): sample
// id % spp of pixel id / spp, at x = pixel % width, y = pixel / width, ids
// past the frame included.
__device__ __forceinline__ void id_ray(const float* cam, int id, int width,
                                       int spp, uint32_t seed, float inv_w,
                                       float inv_h, float& ox, float& oy,
                                       float& oz, float& dx, float& dy,
                                       float& dz) {
  const int pid = id / spp;
  pixel_ray(cam, pid, id - pid * spp, spp, (float)(pid % width),
            (float)(pid / width), seed, inv_w, inv_h, ox, oy, oz, dx, dy, dz);
}

// Every sample s_lo..s_hi-1 of one pixel, as one flat loop of segments
// (megakernel._respawn_kernel's step): count the segment, sweep, add the sky
// on a miss, scatter, then continue while hit & ok & b < max_bounces. A path
// that ends respawns the pixel's next sample in registers, so a lane leaves
// the loop only when its span is used up, and a warp runs as long as its
// busiest pixel, not as long as the sum of each sample's deepest path.
// Each sample's radiance is added to rr, rg, rb in sample order. Returns the
// segments traced (0 for an empty span).
//
// The loop body has one path to its back-edge: every lane unpacks and
// scatters (a miss unpacks row 0 and discards it) and generates the next
// sample's primary ray, and selects pick what the lane keeps. Written with
// a branch around the respawn, the body has two paths back to the loop
// head, and nvcc splits such a loop into a loop nest whose inner loop (the
// bounces) ends in a reconvergence barrier: a warp then waits for its
// deepest path on every sample. The extra unpack, scatter and raygen cost
// a few percent of one 512-row sweep.
__device__ __forceinline__ int respawn_pixel(
    const float4* hot, const float* pay, int S, const float* cam, int pid,
    float xf, float yf, int spp, int s_lo, int s_hi, int max_bounces,
    float t_min, uint32_t seed, float inv_w, float inv_h, float& rr,
    float& rg, float& rb) {
  if (s_lo >= s_hi) return 0;
  float ox, oy, oz, dx, dy, dz;
  int s = s_lo;
  uint32_t rid = pixel_ray(cam, pid, s, spp, xf, yf, seed, inv_w, inv_h, ox,
                           oy, oz, dx, dy, dz);
  float ar = 1.0f, ag = 1.0f, ab = 1.0f;
  int b = 0, cnt = 0;
  for (;;) {
    ++cnt;
    float bt;
    const int best = sweep4(hot, S, t_min, ox, oy, oz, dx, dy, dz, bt);
    // hit = bt < float32(3e38), megakernel._closest_hit_record
    const bool hit = bt < 0x1.c363ccp+127f;
    float skr, skg, skb;
    sky_color(dy, skr, skg, skb);
    rr = hit ? rr : rr + ar * skr;
    rg = hit ? rg : rg + ag * skg;
    rb = hit ? rb : rb + ab * skb;
    const Hit h = unpack_hit4(hot, pay, S, hit ? best : 0, bt, ox, oy, oz,
                              dx, dy, dz);
    float sx, sy, sz;
    const bool ok = scatter(h, dx, dy, dz, seed, rid, (uint32_t)b, sx, sy,
                            sz);
    const bool cont = hit && ok && b < max_bounces;
    s += cont ? 0 : 1;
    if (s >= s_hi) break;
    float nox, noy, noz, ndx, ndy, ndz;
    const uint32_t nrid = pixel_ray(cam, pid, s, spp, xf, yf, seed, inv_w,
                                    inv_h, nox, noy, noz, ndx, ndy, ndz);
    ox = cont ? h.px : nox;
    oy = cont ? h.py : noy;
    oz = cont ? h.pz : noz;
    dx = cont ? sx : ndx;
    dy = cont ? sy : ndy;
    dz = cont ? sz : ndz;
    ar = cont ? ar * h.albedo_x : 1.0f;
    ag = cont ? ag * h.albedo_y : 1.0f;
    ab = cont ? ab * h.albedo_z : 1.0f;
    rid = cont ? rid : nrid;
    b = cont ? b + 1 : 0;
  }
  return cnt;
}

// ---- the one-shot kernel's lane (oneshot.cu) --------------------------------

// Tables of fewer rows take a thread per ray (oneshot_ray, phase_ray), in
// the one-shot and phase kernels alike; from kNestRows rows up, the flat
// loop (oneshot_lane, phase_lane). The flat loop won from 48 rows up and
// lost at 8 (bench.variants).
constexpr int kNestRows = 16;

// Every ray a lane is handed, as one flat loop of segments
// (megakernel._kernel's per-bounce step): count the segment, sweep (in soft
// mode also the graze sweep and the promotion), record the topology plane,
// add the sky on a miss, scatter (in soft mode the two-branch draw), then
// continue while hit & ok & b < max_bounces. A ray that ends writes its
// radiance, its count and -1 into the topology planes past its end; the
// lane then takes its next ray index from take(need, i) and loads that
// ray, so that it is not left idle while the rest of its warp traces
// deeper rays.
//
// take(need, i): every lane of the warp calls it together, each segment;
// it returns the next ray index of each lane with `need` (any index >= N
// when none is left; the value is unused where need is false). i is the
// lane's current index (-1 before its first). any(p): whether p holds on
// any lane of the warp; the loop ends when no lane holds a ray. Both are
// warp-collective on the card and plain on the host.
//
// Rays are read from ox_in..ray_id[i] and written at [i] (topology at
// [b * N + i]), so outputs land in the caller's order whatever order the
// lanes take the rays in. Ids >= n_rays are padding: one segment that
// counts nothing and writes zeros, count 0 and -1 planes. Per-ray
// arithmetic and its order are the plain version's, so the outputs are
// equal to it bit for bit under any schedule. Returns the segments the
// lane counted.
//
// The body keeps one path to the back-edge, as respawn_pixel does: every
// lane unpacks and scatters (a miss unpacks row 0 and discards it), and
// selects, not a branch, merge the refilled ray into the lane's state. The
// refill's loads and the finished ray's stores are predicated.
template <bool kSoft, class Take, class Any>
__device__ __forceinline__ unsigned long long oneshot_lane(
    const float4* hot, const float* pay, int S, const float* ox_in,
    const float* oy_in, const float* oz_in, const float* dx_in,
    const float* dy_in, const float* dz_in, const int* ray_id, int N,
    int n_rays, int max_bounces, float t_min, uint32_t seed, float inv_eps,
    float near_cut, float* rr_out, float* rg_out, float* rb_out,
    int* cnt_out, int* topo, Take take, Any any) {
  int i = -1, b = 0, cnt = 0;
  bool cont = false, live = false;
  uint32_t rid = 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float ar = 1.0f, ag = 1.0f, ab = 1.0f, rr = 0.0f, rg = 0.0f, rb = 0.0f;
  unsigned long long total = 0;
  for (;;) {
    const bool need = !cont && i < N;
    const int next = take(need, i);
    i = need ? next : i;
    const bool fresh = need && i < N;
    float nox = 0.0f, noy = 0.0f, noz = 0.0f;
    float ndx = 0.0f, ndy = 0.0f, ndz = 0.0f;
    int nrid = 0;
    if (fresh) {
      nox = ox_in[i];
      noy = oy_in[i];
      noz = oz_in[i];
      ndx = dx_in[i];
      ndy = dy_in[i];
      ndz = dz_in[i];
      nrid = ray_id[i];
    }
    ox = cont ? ox : nox;
    oy = cont ? oy : noy;
    oz = cont ? oz : noz;
    dx = cont ? dx : ndx;
    dy = cont ? dy : ndy;
    dz = cont ? dz : ndz;
    rid = cont ? rid : (uint32_t)nrid;
    live = cont ? live : fresh && nrid < n_rays;
    ar = cont ? ar : 1.0f;
    ag = cont ? ag : 1.0f;
    ab = cont ? ab : 1.0f;
    rr = cont ? rr : 0.0f;
    rg = cont ? rg : 0.0f;
    rb = cont ? rb : 0.0f;
    cnt = cont ? cnt : 0;
    b = cont ? b : 0;
    if (!any(i < N)) break;

    cnt += live ? 1 : 0;
    total += live ? 1u : 0u;
    float bt;
    int best = sweep4(hot, S, t_min, ox, oy, oz, dx, dy, dz, bt);
    if (kSoft) {
      float be, gnb;
      const int row = graze_sweep4(hot, pay + 3 * S, S, t_min, ox, oy, oz,
                                   dx, dy, dz, bt, be, gnb);
      const bool near = be > near_cut;  // promotion: the graze wins, at nb
      best = near ? row : best;
      bt = near ? gnb : bt;
    }
    // hit = bt < float32(3e38), megakernel._closest_hit_record
    const bool hit = live && bt < 0x1.c363ccp+127f;
    const bool sky = live && !hit;
    float skr, skg, skb;
    sky_color(dy, skr, skg, skb);
    rr = sky ? rr + ar * skr : rr;
    rg = sky ? rg + ag * skg : rg;
    rb = sky ? rb + ab * skb : rb;
    const int row = hit ? best : 0;
    float mr, mg, mb, hx, hy, hz, sx, sy, sz;
    bool ok;
    if (kSoft) {
      const SoftHit sh = soft_hit4(hot, pay, S, row, t_min, inv_eps, ox, oy,
                                   oz, dx, dy, dz);
      ok = scatter(sh.h, dx, dy, dz, seed, rid, (uint32_t)b, sx, sy, sz);
      const float u = uniform01(seed, rid, (uint32_t)b, kSlotSilhouetteP);
      // Bounce off the sphere, or pass through from the far exit with the
      // direction kept.
      const bool bounce = u < sh.cover;
      const float w = bounce_weight(sh.cover);
      const float wt = pass_weight(sh.cover);
      mr = bounce ? sh.h.albedo_x * w : wt;
      mg = bounce ? sh.h.albedo_y * w : wt;
      mb = bounce ? sh.h.albedo_z * w : wt;
      sx = bounce ? sx : dx;
      sy = bounce ? sy : dy;
      sz = bounce ? sz : dz;
      hx = bounce ? sh.h.px : sh.p2x;
      hy = bounce ? sh.h.py : sh.p2y;
      hz = bounce ? sh.h.pz : sh.p2z;
      ok = ok || !bounce;
    } else {
      const Hit h = unpack_hit4(hot, pay, S, row, bt, ox, oy, oz, dx, dy,
                                dz);
      ok = scatter(h, dx, dy, dz, seed, rid, (uint32_t)b, sx, sy, sz);
      mr = h.albedo_x;
      mg = h.albedo_y;
      mb = h.albedo_z;
      hx = h.px;
      hy = h.py;
      hz = h.pz;
    }
    cont = hit && ok && b < max_bounces;
    const bool mine = i < N;
    if (topo && mine) topo[(size_t)b * N + i] = hit ? best : -1;
    if (!cont && mine) {
      rr_out[i] = rr;
      rg_out[i] = rg;
      rb_out[i] = rb;
      cnt_out[i] = cnt;
      if (topo)
        for (int k = b + 1; k <= max_bounces; ++k)
          topo[(size_t)k * N + i] = -1;
    }
    ox = hx;
    oy = hy;
    oz = hz;
    dx = sx;
    dy = sy;
    dz = sz;
    ar = ar * mr;
    ag = ag * mg;
    ab = ab * mb;
    b = b + 1;
  }
  return total;
}

// Ray i traced to its end a bounce at a time (megakernel._kernel's loop
// nest), with the per-ray arithmetic of oneshot_lane: the one-shot
// kernel's path for tables of fewer than kNestRows rows. There a segment's
// sweep is short, and the flat loop's refill and its unconditional record
// and scatter cost more than the lanes it keeps busy; here a warp whose
// lanes all missed or ended skips them. Writes every topology plane of the
// ray, radiance and count at [i]; returns the count.
template <bool kSoft>
__device__ __forceinline__ int oneshot_ray(
    const float4* hot, const float* pay, int S, int i, const float* ox_in,
    const float* oy_in, const float* oz_in, const float* dx_in,
    const float* dy_in, const float* dz_in, const int* ray_id, int N,
    int n_rays, int max_bounces, float t_min, uint32_t seed, float inv_eps,
    float near_cut, float* rr_out, float* rg_out, float* rb_out,
    int* cnt_out, int* topo) {
  const int rid_i = ray_id[i];
  const uint32_t rid = (uint32_t)rid_i;
  bool alive = rid_i < n_rays;
  float ox = ox_in[i], oy = oy_in[i], oz = oz_in[i];
  float dx = dx_in[i], dy = dy_in[i], dz = dz_in[i];
  float ar = 1.0f, ag = 1.0f, ab = 1.0f, rr = 0.0f, rg = 0.0f, rb = 0.0f;
  int cnt = 0;
  for (int b = 0; b <= max_bounces; ++b) {
    int plane = -1;
    if (alive) {
      ++cnt;
      float bt;
      int best = sweep4(hot, S, t_min, ox, oy, oz, dx, dy, dz, bt);
      if (kSoft) {
        float be, gnb;
        const int row = graze_sweep4(hot, pay + 3 * S, S, t_min, ox, oy, oz,
                                     dx, dy, dz, bt, be, gnb);
        if (be > near_cut) {
          best = row;
          bt = gnb;
        }
      }
      if (!(bt < 0x1.c363ccp+127f)) {
        float skr, skg, skb;
        sky_color(dy, skr, skg, skb);
        rr = rr + ar * skr;
        rg = rg + ag * skg;
        rb = rb + ab * skb;
        alive = false;
      } else {
        float mr, mg, mb, hx, hy, hz, sx, sy, sz;
        bool ok;
        if (kSoft) {
          const SoftHit sh = soft_hit4(hot, pay, S, best, t_min, inv_eps, ox,
                                       oy, oz, dx, dy, dz);
          ok = scatter(sh.h, dx, dy, dz, seed, rid, (uint32_t)b, sx, sy, sz);
          const float u =
              uniform01(seed, rid, (uint32_t)b, kSlotSilhouetteP);
          if (u < sh.cover) {  // bounce off the sphere
            const float w = bounce_weight(sh.cover);
            mr = sh.h.albedo_x * w;
            mg = sh.h.albedo_y * w;
            mb = sh.h.albedo_z * w;
            hx = sh.h.px;
            hy = sh.h.py;
            hz = sh.h.pz;
          } else {  // pass through from the far exit
            mr = mg = mb = pass_weight(sh.cover);
            sx = dx;
            sy = dy;
            sz = dz;
            hx = sh.p2x;
            hy = sh.p2y;
            hz = sh.p2z;
            ok = true;
          }
        } else {
          const Hit h = unpack_hit4(hot, pay, S, best, bt, ox, oy, oz, dx, dy,
                                    dz);
          ok = scatter(h, dx, dy, dz, seed, rid, (uint32_t)b, sx, sy, sz);
          mr = h.albedo_x;
          mg = h.albedo_y;
          mb = h.albedo_z;
          hx = h.px;
          hy = h.py;
          hz = h.pz;
        }
        plane = best;
        if (ok && b < max_bounces) {
          ox = hx;
          oy = hy;
          oz = hz;
          dx = sx;
          dy = sy;
          dz = sz;
          ar = ar * mr;
          ag = ag * mg;
          ab = ab * mb;
        } else {
          alive = false;
        }
      }
    }
    if (topo) topo[(size_t)b * N + i] = plane;
  }
  rr_out[i] = rr;
  rg_out[i] = rg;
  rb_out[i] = rb;
  cnt_out[i] = cnt;
  return cnt;
}

// ---- the phase kernel's lane (phase.cu) ------------------------------------

// Float planes of the wavefront state, (12, N) row-major: ox oy oz dx dy dz
// ar ag ab rr rg rb.
constexpr int kStatePlanes = 12;

// Every list entry a lane is handed, as one flat loop of segments
// (megakernel._phase_kernel's per-bounce step from absolute bounce b0):
// count the bounce, sweep, add the sky on a miss, scatter, then continue
// while hit & ok & b < max_bounces and b + 1 < lim = min(bend,
// max_bounces + 1). List entry j names the ray at slot r = slots[j] (r = j
// without a slot list); the lane reads that ray's state, alive flag and id
// at r. A ray that ends in this phase, dead or alive at its span's end,
// writes its 12 state floats and its alive flag back at r and adds the
// bounces it counted to cnt_io[r]; the lane then takes its next list index
// from take(need, j) and loads that ray, so that it is not left idle while
// the rest of its warp traces deeper rays. take and any are oneshot_lane's
// (any index >= M when the list is used up).
//
// A taken ray starts at bounce b0 with a count of 0: b is reset on every
// refill, not carried, and the RNG is keyed on the absolute bounce, so a
// ray's state does not depend on the schedule. A listed ray that is dead on
// arrival (or a span that the budget has used up) takes one segment that
// counts nothing and writes nothing. Per-ray arithmetic and its order are
// those of wavefront_phase_reference, so the state is equal to it bit for
// bit whichever lane takes which entry.
//
// The body keeps one path to the back-edge, as oneshot_lane does: every
// lane unpacks and scatters (a miss unpacks row 0 and discards it), and
// selects merge the refilled ray and the bounce's result into the lane's
// state. The refill's loads and the ended ray's stores are predicated.
template <class Take, class Any>
__device__ __forceinline__ void phase_lane(
    const float4* hot, const float* pay, int S, float* state,
    uint8_t* alive_io, const int* ray_id, int* cnt_io, const int* slots,
    int M, int N, int b0, int bend, int max_bounces, float t_min,
    uint32_t seed, Take take, Any any) {
  const int lim = bend < max_bounces + 1 ? bend : max_bounces + 1;
  int j = -1, r = 0, b = b0, cnt = 0;
  bool cont = false, live = false;
  uint32_t rid = 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, rr = 0.0f, rg = 0.0f, rb = 0.0f;
  for (;;) {
    const bool need = !cont && j < M;
    const int next = take(need, j);
    j = need ? next : j;
    const bool fresh = need && j < M;
    int nr = 0, nrid = 0;
    bool nlive = false;
    float nox = 0.0f, noy = 0.0f, noz = 0.0f;
    float ndx = 0.0f, ndy = 0.0f, ndz = 0.0f;
    float nar = 0.0f, nag = 0.0f, nab = 0.0f;
    float nrr = 0.0f, nrg = 0.0f, nrb = 0.0f;
    if (fresh) {
      nr = slots ? slots[j] : j;
      nox = state[0 * (size_t)N + nr];
      noy = state[1 * (size_t)N + nr];
      noz = state[2 * (size_t)N + nr];
      ndx = state[3 * (size_t)N + nr];
      ndy = state[4 * (size_t)N + nr];
      ndz = state[5 * (size_t)N + nr];
      nar = state[6 * (size_t)N + nr];
      nag = state[7 * (size_t)N + nr];
      nab = state[8 * (size_t)N + nr];
      nrr = state[9 * (size_t)N + nr];
      nrg = state[10 * (size_t)N + nr];
      nrb = state[11 * (size_t)N + nr];
      nlive = alive_io[nr] != 0;
      nrid = ray_id[nr];
    }
    r = cont ? r : nr;
    ox = cont ? ox : nox;
    oy = cont ? oy : noy;
    oz = cont ? oz : noz;
    dx = cont ? dx : ndx;
    dy = cont ? dy : ndy;
    dz = cont ? dz : ndz;
    ar = cont ? ar : nar;
    ag = cont ? ag : nag;
    ab = cont ? ab : nab;
    rr = cont ? rr : nrr;
    rg = cont ? rg : nrg;
    rb = cont ? rb : nrb;
    rid = cont ? rid : (uint32_t)nrid;
    live = cont ? live : nlive;
    cnt = cont ? cnt : 0;
    b = cont ? b : b0;
    if (!any(j < M)) break;

    const bool run = live && b < lim;
    cnt += run ? 1 : 0;
    float bt;
    const int best = sweep4(hot, S, t_min, ox, oy, oz, dx, dy, dz, bt);
    // hit = bt < float32(3e38), megakernel._closest_hit_record
    const bool hit = run && bt < 0x1.c363ccp+127f;
    const bool sky = run && !hit;
    float skr, skg, skb;
    sky_color(dy, skr, skg, skb);
    rr = sky ? rr + ar * skr : rr;
    rg = sky ? rg + ag * skg : rg;
    rb = sky ? rb + ab * skb : rb;
    const Hit h = unpack_hit4(hot, pay, S, hit ? best : 0, bt, ox, oy, oz, dx,
                              dy, dz);
    float sx, sy, sz;
    const bool ok = scatter(h, dx, dy, dz, seed, rid, (uint32_t)b, sx, sy,
                            sz);
    const bool adv = hit && ok && b < max_bounces;
    ox = adv ? h.px : ox;
    oy = adv ? h.py : oy;
    oz = adv ? h.pz : oz;
    dx = adv ? sx : dx;
    dy = adv ? sy : dy;
    dz = adv ? sz : dz;
    ar = adv ? ar * h.albedo_x : ar;
    ag = adv ? ag * h.albedo_y : ag;
    ab = adv ? ab * h.albedo_z : ab;
    live = run ? adv : live;
    b = b + 1;
    cont = adv && b < lim;
    if (!cont && j < M && cnt > 0) {
      state[0 * (size_t)N + r] = ox;
      state[1 * (size_t)N + r] = oy;
      state[2 * (size_t)N + r] = oz;
      state[3 * (size_t)N + r] = dx;
      state[4 * (size_t)N + r] = dy;
      state[5 * (size_t)N + r] = dz;
      state[6 * (size_t)N + r] = ar;
      state[7 * (size_t)N + r] = ag;
      state[8 * (size_t)N + r] = ab;
      state[9 * (size_t)N + r] = rr;
      state[10 * (size_t)N + r] = rg;
      state[11 * (size_t)N + r] = rb;
      alive_io[r] = live ? 1 : 0;
      cnt_io[r] += cnt;
    }
  }
}

// The ray at slot r advanced through the phase a bounce at a time, a thread
// per listed ray, with the per-ray arithmetic of phase_lane: the phase
// kernel's path for tables of fewer than kNestRows rows, as oneshot_ray is
// the one-shot kernel's. A ray dead on arrival is not written.
__device__ __forceinline__ void phase_ray(
    const float4* hot, const float* pay, int S, int r, float* state,
    uint8_t* alive_io, const int* ray_id, int* cnt_io, int N, int b0,
    int bend, int max_bounces, float t_min, uint32_t seed) {
  bool alive = alive_io[r] != 0;
  if (!alive) return;
  const uint32_t rid = (uint32_t)ray_id[r];
  float ox = state[0 * (size_t)N + r], oy = state[1 * (size_t)N + r],
        oz = state[2 * (size_t)N + r];
  float dx = state[3 * (size_t)N + r], dy = state[4 * (size_t)N + r],
        dz = state[5 * (size_t)N + r];
  float ar = state[6 * (size_t)N + r], ag = state[7 * (size_t)N + r],
        ab = state[8 * (size_t)N + r];
  float rr = state[9 * (size_t)N + r], rg = state[10 * (size_t)N + r],
        rb = state[11 * (size_t)N + r];
  int cnt = 0;
  for (int b = b0; b <= max_bounces && b < bend && alive; ++b) {
    ++cnt;
    float bt;
    const int best = sweep4(hot, S, t_min, ox, oy, oz, dx, dy, dz, bt);
    if (!(bt < 0x1.c363ccp+127f)) {
      float skr, skg, skb;
      sky_color(dy, skr, skg, skb);
      rr = rr + ar * skr;
      rg = rg + ag * skg;
      rb = rb + ab * skb;
      alive = false;
    } else {
      const Hit h = unpack_hit4(hot, pay, S, best, bt, ox, oy, oz, dx, dy,
                                dz);
      float sx, sy, sz;
      const bool ok = scatter(h, dx, dy, dz, seed, rid, (uint32_t)b, sx, sy,
                              sz);
      if (ok && b < max_bounces) {
        ox = h.px;
        oy = h.py;
        oz = h.pz;
        dx = sx;
        dy = sy;
        dz = sz;
        ar = ar * h.albedo_x;
        ag = ag * h.albedo_y;
        ab = ab * h.albedo_z;
      } else {
        alive = false;
      }
    }
  }
  const float out[kStatePlanes] = {ox, oy, oz, dx, dy, dz,
                                   ar, ag, ab, rr, rg, rb};
  for (int k = 0; k < kStatePlanes; ++k) state[k * (size_t)N + r] = out[k];
  alive_io[r] = alive ? 1 : 0;
  cnt_io[r] += cnt;
}

// ---- the closest-hit index sweep (intersect_index.cu) -----------------------

// Rows of the sphere table a block holds in shared memory at once: 16 KB of
// float4 rows.
constexpr int kIndexTile = 1024;

// Row s of the index table of intersect_index.pack, built from the prepared
// columns: {cx, cy, cz, valid > 0 ? radius_sq : float32(-1e30)}.
__device__ __forceinline__ float4 index_row(const float* cx, const float* cy,
                                            const float* cz, const float* rsq,
                                            const float* valid, int s) {
  return float4{cx[s], cy[s], cz[s],
                valid[s] > 0.0f ? rsq[s] : -0x1.93e594p+99f};
}

// The index sweep's test of n staged rows, which are table rows base..
// base+n-1, in row order (intersect_pallas._kernel's form): a row counts
// only where disc > 0, t = t1 > t_min ? t1 : t2 must exceed t_min, and a
// strict < keeps the first row among equal roots. No t_max test. Unrolled
// as sweep4.
__device__ __forceinline__ void index_sweep4(const float4* tile, int n,
                                             int base, float t_min, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float& bt,
                                             int& bi) {
#pragma unroll kSweepUnroll
  for (int s = 0; s < n; ++s) {
    const float4 h = tile[s];
    const float cox = h.x - ox;
    const float coy = h.y - oy;
    const float coz = h.z - oz;
    const float nb = cox * dx + coy * dy + coz * dz;
    const float c = cox * cox + coy * coy + coz * coz - h.w;
    const float disc = nb * nb - c;
    if (disc > 0.0f) {
      const float sq = sqrtf(disc);
      const float t1 = nb - sq;
      const float t2 = nb + sq;
      const float t = t1 > t_min ? t1 : t2;
      if (t > t_min && t < bt) {
        bt = t;
        bi = base + s;
      }
    }
  }
}

// One ray against all S rows, a tile of kIndexTile rows at a time: the
// threads of the block (tid of `threads`) stage each tile into `tile`
// together, between calls of sync(), and every thread sweeps it. Every
// thread of the block calls it, with a ray or not. Returns the winning row
// (0 on a miss); bt its root (+inf without one).
template <class Sync>
__device__ __forceinline__ int index_tiles(
    const float* cx, const float* cy, const float* cz, const float* rsq,
    const float* valid, int S, int tid, int threads, float4* tile,
    float t_min, float ox, float oy, float oz, float dx, float dy, float dz,
    float& bt, Sync sync) {
  bt = __int_as_float(0x7f800000);  // +inf
  int bi = 0;
  for (int base = 0; base < S; base += kIndexTile) {
    const int n = S - base < kIndexTile ? S - base : kIndexTile;
    if (base) sync();  // every thread is done with the previous tile
    for (int k = tid; k < n; k += threads)
      tile[k] = index_row(cx, cy, cz, rsq, valid, base + k);
    sync();
    index_sweep4(tile, n, base, t_min, ox, oy, oz, dx, dy, dz, bt, bi);
  }
  return bi;
}

}  // namespace r1b
