// Resumable wavefront phase for Hopper (sm_90a): the wavefront render
// engine's kernel.
//
// Replaces the Pallas kernel rays1bench_tpu/kernels/megakernel.py
// `_phase_kernel` (launched by `trace_pallas_wavefront`), hard mode. Each
// thread takes one ray of the slot list, reads its carried state (origin,
// direction, attenuation, radiance: 12 float planes), its alive flag and
// its global id, and advances it from absolute bounce b0 while b <=
// max_bounces, b < bend and the ray is alive. It writes the state and the
// alive flag back in place and adds the bounces it counted to the ray's
// count. Plain version and wrapper: rays1bench_tpu_torch/kernels/
// megakernel.py (`wavefront_phase_reference`, `wavefront_phase`).
//
// Bit identity with the one-shot kernel (oneshot.cu): the per-bounce body is
// the same `r1b` helpers in the same order; the RNG is keyed on the absolute
// bounce b; a bounce is counted at its top, for a live ray only; the state
// crosses the phase boundary as plain float32 in device memory. So a ray's
// radiance and count do not depend on the schedule.
//
// Design. The slot list is the compaction: between phases the wrapper lists
// the live rays (a stable partition, slot order kept), and the next phase
// launches one thread per listed ray, which reads and writes that ray's
// state where it lies. The state never moves, so the output is in input
// slot order with no unpermute. The Pallas kernel compacts whole 128-lane
// rows by argsort because per-ray compaction was too slow on the TPU; a
// GPU thread retires on its own, and a warp then holds only live rays at
// the start of a phase. A null slot list means every ray, slot i = i.
//
// What bounds it: FP32 issue in the S-long sweep, as in oneshot.cu; per
// phase each listed ray also moves its 12-float state in and out (104 B with
// the id, flag and count).
#include <cuda_runtime.h>
#include <stdint.h>

#include "path_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStatePlanes = 12;  // ox oy oz dx dy dz ar ag ab rr rg rb

__global__ void __launch_bounds__(kThreads)
phase_kernel(const float* __restrict__ spheres, int S,
             float* __restrict__ state, uint8_t* __restrict__ alive_io,
             const int* __restrict__ ray_id, int* __restrict__ cnt_io,
             const int* __restrict__ slots, int M, int N, int b0, int bend,
             int max_bounces, float t_min, uint32_t seed) {
  extern __shared__ float sph[];
  for (int i = threadIdx.x; i < r1b::kNumRows * S; i += kThreads)
    sph[i] = spheres[i];
  __syncthreads();

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= M) return;
  const int r = slots ? slots[i] : i;
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
  const float out[kStatePlanes] = {ox, oy, oz, dx, dy, dz,
                                   ar, ag, ab, rr, rg, rb};
  for (int k = 0; k < kStatePlanes; ++k) state[k * (size_t)N + r] = out[k];
  alive_io[r] = alive ? 1 : 0;
  cnt_io[r] += cnt;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the attribute call or the
// launch (0 on success). state is (12, N) row-major, alive uint8[N], ray_id
// and cnt int32[N], all updated in place for the M rays of `slots` (int32
// slot indices, or null for slots 0..M-1 with M == N); M > 0.
extern "C" int rays1_phase_launch(const float* spheres, int S, float* state,
                                  uint8_t* alive, const int* ray_id, int* cnt,
                                  const int* slots, int M, int N, int b0,
                                  int bend, int max_bounces, float t_min,
                                  uint32_t seed, void* stream) {
  const size_t smem = sizeof(float) * r1b::kNumRows * (size_t)S;
  cudaError_t err = cudaFuncSetAttribute(
      phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (M + kThreads - 1) / kThreads;
  phase_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      spheres, S, state, alive, ray_id, cnt, slots, M, N, b0, bend,
      max_bounces, t_min, seed);
  return (int)cudaGetLastError();
}
