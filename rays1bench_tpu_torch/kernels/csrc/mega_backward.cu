// Fused backward of the fixed-topology replay, for Hopper (sm_90a).
//
// Replaces the Pallas kernel rays1bench_tpu/kernels/mega_backward.py
// `_bwd_kernel` (launched by `backward_pallas`), hard mode. Given N primary
// rays, their ids, the per-ray cotangents of the traced radiance and the
// forward's hit topology, it returns the cotangents of the ten GRAD_ROWS
// sphere columns, summed per row into grads[10, S], and the cotangents of
// the six primary-ray planes. Plain version and wrapper:
// rays1bench_tpu_torch/kernels/mega_backward.py (`backward_reference`,
// `backward`).
//
// Design. One thread owns one ray.
// - Forward replay: the ray re-advances (o, d, a, alive) bounce by bounce
//   through the recorded rows with the replay's exact math (replay_hit and
//   r1b::scatter on the exact (11, S) table), and checkpoints each live
//   bounce's 9-float state in a per-thread array, with the continue and
//   dielectric-mirror decisions as bits. The array is capped at
//   kMaxBounces + 1 entries at compile time; the wrapper refuses deeper
//   configs. Checkpointing costs 36 B of local memory per live bounce and
//   keeps the reverse pass linear in the depth; recomputing the state from
//   the primary ray for each reverse step would cost O(depth^2) bounces.
// - Reverse: from the last live bounce down, the hand-derived adjoint of
//   one bounce (path_adjoint.cuh) pulls the cotangents of (o, d, a) back
//   and yields the ten column cotangents of the bounce's row. The winning
//   row is one shared-memory load by index: the Pallas kernel's S-select
//   sweep over the table was a TPU workaround.
// - Accumulation: blocks run in parallel and in no order, so the TPU's
//   one-hot planes carried across a serial grid do not translate. Each
//   block keeps a (10, S) accumulator in shared memory, adds into it with
//   shared atomics, and flushes each non-zero entry with one global
//   atomicAdd. The order of those float sums changes from run to run.
//
// What bounds it: FP32 issue in the replay and the adjoint (a few hundred
// operations per live bounce, with no sweep), plus shared-atomic conflicts
// where a warp's rays hit the same row (the ground sphere). Shared memory:
// 84 B per table row (44 table + 40 accumulator), 43,008 B at 512 rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "path_adjoint.cuh"
#include "path_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBounces = 50;  // mega_backward.MAX_BOUNCES

__global__ void __launch_bounds__(kThreads)
backward_kernel(const float* __restrict__ table, int S,
                const float* __restrict__ ox_in,
                const float* __restrict__ oy_in,
                const float* __restrict__ oz_in,
                const float* __restrict__ dx_in,
                const float* __restrict__ dy_in,
                const float* __restrict__ dz_in,
                const int* __restrict__ ray_id,
                const float* __restrict__ ct_r, const float* __restrict__ ct_g,
                const float* __restrict__ ct_b, const int* __restrict__ topo,
                int N, int n_rays, int max_bounces, float t_min,
                uint32_t seed, float* __restrict__ grads,
                float* __restrict__ g_ox, float* __restrict__ g_oy,
                float* __restrict__ g_oz, float* __restrict__ g_dx,
                float* __restrict__ g_dy, float* __restrict__ g_dz) {
  extern __shared__ float smem[];
  float* tab = smem;                               // (11, S)
  float* acc = smem + r1b::kNumExactRows * S;      // (10, S)

  const int tid = threadIdx.x;
  for (int k = tid; k < r1b::kNumExactRows * S; k += kThreads)
    tab[k] = table[k];
  for (int k = tid; k < r1b::kNumGrad * S; k += kThreads) acc[k] = 0.0f;
  __syncthreads();

  const int i = blockIdx.x * kThreads + tid;
  if (i < N) {
    const int rid_i = ray_id[i];
    const uint32_t rid = (uint32_t)rid_i;
    bool alive = rid_i < n_rays;
    float o[3] = {ox_in[i], oy_in[i], oz_in[i]};
    float d[3] = {dx_in[i], dy_in[i], dz_in[i]};
    float a[3] = {1.0f, 1.0f, 1.0f};
    float st[kMaxBounces + 1][9];
    uint64_t cont_bits = 0, mirror_bits = 0;
    int live = 0;

    // ---- forward replay: advance and checkpoint ---------------------------
    for (int b = 0; b <= max_bounces && alive; ++b) {
      for (int k = 0; k < 3; ++k) {
        st[b][k] = o[k];
        st[b][3 + k] = d[k];
        st[b][6 + k] = a[k];
      }
      live = b + 1;
      const int j = topo[(size_t)b * N + i];
      bool cont = false;
      if (j >= 0) {
        const r1b::Hit h = r1b::replay_hit(tab, S, j, t_min, o[0], o[1],
                                           o[2], d[0], d[1], d[2]);
        float sx, sy, sz;
        bool mirror = false;
        const bool ok = r1b::scatter(h, d[0], d[1], d[2], seed, rid,
                                     (uint32_t)b, sx, sy, sz, &mirror);
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

    // ---- reverse ------------------------------------------------------------
    const float crad[3] = {ct_r[i], ct_g[i], ct_b[i]};
    float go[3] = {0.0f, 0.0f, 0.0f};
    float gd[3] = {0.0f, 0.0f, 0.0f};
    float ga[3] = {0.0f, 0.0f, 0.0f};
    for (int b = live - 1; b >= 0; --b) {
      const int j = topo[(size_t)b * N + i];
      const float so[3] = {st[b][0], st[b][1], st[b][2]};
      const float sd[3] = {st[b][3], st[b][4], st[b][5]};
      const float sa[3] = {st[b][6], st[b][7], st[b][8]};
      if (j < 0) {
        // Miss: radiance += a * sky(d); the state passes through.
        r1b::sky_adj(sa, sd[1], crad, ga, gd[1]);
      } else if (cont_bits >> b & 1ull) {
        float gcol[r1b::kNumGrad];
        r1b::hit_bounce_adj(tab, S, j, t_min, so, sd, sa,
                            (mirror_bits >> b & 1ull) != 0, seed, rid,
                            (uint32_t)b, go, gd, ga, gcol);
        for (int g = 0; g < r1b::kNumGrad; ++g)
          atomicAdd(&acc[g * S + j], gcol[g]);
      }
      // A hit that did not continue (absorbed, depth cap) adds no radiance
      // and leaves the state as it was: its cotangents pass through.
    }
    g_ox[i] = go[0];
    g_oy[i] = go[1];
    g_oz[i] = go[2];
    g_dx[i] = gd[0];
    g_dy[i] = gd[1];
    g_dz[i] = gd[2];
  }

  __syncthreads();
  for (int k = tid; k < r1b::kNumGrad * S; k += kThreads) {
    const float v = acc[k];
    if (v != 0.0f) atomicAdd(&grads[k], v);
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the attribute call or the
// launch (0 on success). grads (10, S) must be zero on entry; the six
// cotangent planes are written for every ray. N > 0, max_bounces <=
// kMaxBounces.
extern "C" int rays1_backward_launch(
    const float* table, int S, const float* ox, const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const int* ray_id, const float* ct_r, const float* ct_g,
    const float* ct_b, const int* topo, int N, int n_rays, int max_bounces,
    float t_min, uint32_t seed, float* grads, float* g_ox, float* g_oy,
    float* g_oz, float* g_dx, float* g_dy, float* g_dz, void* stream) {
  if (max_bounces > kMaxBounces) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
                      (r1b::kNumExactRows + r1b::kNumGrad) * (size_t)S;
  cudaError_t err = cudaFuncSetAttribute(
      backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + kThreads - 1) / kThreads;
  backward_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      table, S, ox, oy, oz, dx, dy, dz, ray_id, ct_r, ct_g, ct_b, topo, N,
      n_rays, max_bounces, t_min, seed, grads, g_ox, g_oy, g_oz, g_dx, g_dy,
      g_dz);
  return (int)cudaGetLastError();
}
