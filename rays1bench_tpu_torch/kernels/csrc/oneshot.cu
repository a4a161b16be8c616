// One-shot path tracer with hit topology, for Hopper (sm_90a): the forward
// of the gradient path.
//
// Replaces the Pallas kernel rays1bench_tpu/kernels/megakernel.py `_kernel`
// with emit_topology=True (launched by `trace_pallas`), hard mode. Given N
// primary rays and their global ids, it traces each ray to completion and
// writes per-ray radiance, per-ray counts of traced rays, and for every
// bounce b the winning sphere row of a live lane that hit (-1 otherwise).
// Plain version and wrapper: rays1bench_tpu_torch/kernels/megakernel.py
// (`trace_topology_reference`, `trace_topology`).
//
// Design. One thread owns one ray and runs the Pallas kernel's per-bounce
// order: count the step, sweep, record the topology plane, add sky on a
// miss, scatter, continue while alive & hit & ok & b < max_bounces. A TPU
// tile stops when all its lanes are dead and the kernel pre-fills the
// topology block with -1; here each thread writes all max_bounces+1 planes
// itself (-1 once its ray is dead), so the wrapper allocates the topology
// with torch.empty. Planes are written at [b * N + i]: neighbouring threads
// write neighbouring words. No slot permutation exists: rays come in and go
// out in the caller's order.
//
// What bounds it: FP32 issue in the S-long closest-hit sweep, as in
// respawn.cu (same `r1b::sweep`, 27 SASS instructions per sphere on the miss
// path). The (7, S) table sits in dynamic shared memory and every load is a
// broadcast. A warp runs until its longest path ends; the one-shot layout
// has no respawn to refill dead lanes, which is what the Pallas kernel's
// per-tile early exit approximates too.
//
// Counting: each thread's count is reduced over its warp, then over the
// block in shared memory, and added to the 64-bit total with one atomicAdd
// per block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "path_math.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
oneshot_kernel(const float* __restrict__ spheres, int S,
               const float* __restrict__ ox_in, const float* __restrict__ oy_in,
               const float* __restrict__ oz_in, const float* __restrict__ dx_in,
               const float* __restrict__ dy_in, const float* __restrict__ dz_in,
               const int* __restrict__ ray_id, int N, int n_rays,
               int max_bounces, float t_min, uint32_t seed,
               float* __restrict__ rr_out, float* __restrict__ rg_out,
               float* __restrict__ rb_out, int* __restrict__ cnt_out,
               int* __restrict__ topo, unsigned long long* __restrict__ total) {
  extern __shared__ float sph[];
  __shared__ unsigned long long warp_sums[kThreads / 32];

  const int tid = threadIdx.x;
  for (int i = tid; i < r1b::kNumRows * S; i += kThreads) sph[i] = spheres[i];
  __syncthreads();

  const int i = blockIdx.x * kThreads + tid;
  int cnt = 0;
  if (i < N) {
    const int rid_i = ray_id[i];
    const uint32_t rid = (uint32_t)rid_i;
    bool alive = rid_i < n_rays;
    float ox = ox_in[i], oy = oy_in[i], oz = oz_in[i];
    float dx = dx_in[i], dy = dy_in[i], dz = dz_in[i];
    float ar = 1.0f, ag = 1.0f, ab = 1.0f;
    float rr = 0.0f, rg = 0.0f, rb = 0.0f;
    for (int b = 0; b <= max_bounces; ++b) {
      int plane = -1;
      if (alive) {
        ++cnt;
        float bt;
        const int best = r1b::sweep(sph, S, t_min, ox, oy, oz, dx, dy, dz, bt);
        // hit = bt < float32(3e38), megakernel._closest_hit_record
        if (!(bt < 0x1.c363ccp+127f)) {
          float skr, skg, skb;
          r1b::sky_color(dy, skr, skg, skb);
          rr = rr + ar * skr;
          rg = rg + ag * skg;
          rb = rb + ab * skb;
          alive = false;
        } else {
          plane = best;
          const r1b::Hit h =
              r1b::unpack_hit(sph, S, best, bt, ox, oy, oz, dx, dy, dz);
          float sx, sy, sz;
          const bool ok =
              r1b::scatter(h, dx, dy, dz, seed, rid, (uint32_t)b, sx, sy, sz);
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
      topo[(size_t)b * N + i] = plane;
    }
    rr_out[i] = rr;
    rg_out[i] = rg;
    rb_out[i] = rb;
    cnt_out[i] = cnt;
  }

  unsigned long long c = (unsigned long long)cnt;
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = c;
  __syncthreads();
  if (tid == 0) {
    unsigned long long block = 0;
    for (int w = 0; w < kThreads / 32; ++w) block += warp_sums[w];
    atomicAdd(total, block);
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the attribute call or the
// launch (0 on success). Outputs are per ray in input order; topo is
// (max_bounces+1, N) row-major; *total must be zero on entry; N > 0.
extern "C" int rays1_oneshot_launch(
    const float* spheres, int S, const float* ox, const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const int* ray_id, int N, int n_rays, int max_bounces, float t_min,
    uint32_t seed, float* rr, float* rg, float* rb, int* cnt, int* topo,
    unsigned long long* total, void* stream) {
  const size_t smem = sizeof(float) * r1b::kNumRows * (size_t)S;
  cudaError_t err = cudaFuncSetAttribute(
      oneshot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + kThreads - 1) / kThreads;
  oneshot_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      spheres, S, ox, oy, oz, dx, dy, dz, ray_id, N, n_rays, max_bounces,
      t_min, seed, rr, rg, rb, cnt, topo, total);
  return (int)cudaGetLastError();
}
