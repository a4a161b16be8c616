// Resumable wavefront phase for Hopper (sm_90a): the wavefront render
// engine's kernel.
//
// Replaces the Pallas kernel rays1bench_tpu/kernels/megakernel.py
// `_phase_kernel` (launched by `trace_pallas_wavefront`), hard mode. Every
// ray of the slot list has its carried state (origin, direction,
// attenuation, radiance: 12 float planes), its alive flag and its global id
// read at its slot, and advances from absolute bounce b0 while b <=
// max_bounces, b < bend and the ray is alive. The state and the alive flag
// are written back in place and the bounces counted are added to the ray's
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
// the live rays (a stable partition, slot order kept), and each ray's state
// is read and written where it lies, so no state moves and the output
// needs no unpermute. (The Pallas kernel compacts whole 128-lane rows by
// argsort because per-ray compaction was too slow on the TPU.) A null slot
// list means every ray, slot j = j.
//
// Each thread runs r1b::phase_lane (path_math.cuh): one flat loop of
// segments in which a ray that ends (dies, or reaches bend alive) hands its
// lane the next list entry, so that a warp runs as long as its busiest
// lane's share of bounces, not, as a thread per listed ray does, as long as
// the deepest of its 32 rays (the CLI frame's last span, bounces 5 to 50,
// holds its deep glass and metal paths). The next entry comes from
// a counter in device memory that the wrapper zeroes: the warp's lanes that
// need a ray vote, one lane adds their number to the counter, and each
// takes the old value plus its rank among them (oneshot.cu). The body keeps
// one path to the back-edge, with selects and predicated loads and stores:
// with a branch around the refill, nvcc splits such a loop back into a
// nest (respawn.cu). The launch runs as many blocks as the card holds at
// once, so each block stages the table once per phase, not once per 128
// listed rays. Tables of fewer than r1b::kNestRows rows take
// r1b::phase_ray instead, a thread per listed ray and a block per 128
// entries, as the one-shot kernel does (there the flat loop's refill and
// its unconditional unpack and scatter cost more than the idle lanes they
// save).
//
// What bounds it: FP32 issue in the S-long closest-hit sweep, as in
// oneshot.cu. The (7, S) table is staged in dynamic shared memory in the
// broadcast layout of r1b::stage_row (float4 {cx, cy, cz, radius_sq} rows,
// one LDS.128 per sphere that every lane of the warp reads at once, and the
// payload rows apart) and swept by r1b::sweep4, unrolled 8 times. Per phase
// each listed ray also moves its 12-float state in and out (104 B with the
// id, slot, flag and count).
#include <cuda_runtime.h>
#include <stdint.h>

#include "path_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
phase_kernel(const float* __restrict__ spheres, int S,
             float* __restrict__ state, uint8_t* __restrict__ alive_io,
             const int* __restrict__ ray_id, int* __restrict__ cnt_io,
             const int* __restrict__ slots, int M, int N, int b0, int bend,
             int max_bounces, float t_min, uint32_t seed,
             int* __restrict__ work) {
  extern __shared__ float4 hot[];  // (S) float4, then (3, S) payload
  float* pay = reinterpret_cast<float*>(hot + S);

  const int tid = threadIdx.x, lane = tid & 31;
  for (int s = tid; s < S; s += kThreads)
    r1b::stage_row(spheres, S, s, hot, pay);
  __syncthreads();

  if (S < r1b::kNestRows) {
    const int i = blockIdx.x * kThreads + tid;
    if (i < M)
      r1b::phase_ray(hot, pay, S, slots ? slots[i] : i, state, alive_io,
                     ray_id, cnt_io, N, b0, bend, max_bounces, t_min, seed);
    return;
  }
  auto take = [&](bool need, int) {
    const unsigned m = __ballot_sync(kFull, need);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(work, __popc(m));
    base = __shfl_sync(kFull, base, 0);
    return base + __popc(m & ((1u << lane) - 1u));
  };
  auto any = [](bool p) { return __any_sync(kFull, p) != 0; };
  r1b::phase_lane(hot, pay, S, state, alive_io, ray_id, cnt_io, slots, M, N,
                  b0, bend, max_bounces, t_min, seed, take, any);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the attribute or occupancy
// query or of the launch (0 on success). state is (12, N) row-major, alive
// uint8[N], ray_id and cnt int32[N], all updated in place for the M rays of
// `slots` (int32 slot indices, or null for slots 0..M-1 with M == N);
// the list counter *work must be zero on entry; M > 0.
extern "C" int rays1_phase_launch(const float* spheres, int S, float* state,
                                  uint8_t* alive, const int* ray_id, int* cnt,
                                  const int* slots, int M, int N, int b0,
                                  int bend, int max_bounces, float t_min,
                                  uint32_t seed, int* work, void* stream) {
  const size_t smem = sizeof(float) * r1b::kNumRows * (size_t)S;
  cudaError_t err = cudaFuncSetAttribute(
      phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, phase_kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + kThreads - 1) / kThreads;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int grid =
      S < r1b::kNestRows || blocks < resident ? blocks : resident;
  phase_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      spheres, S, state, alive, ray_id, cnt, slots, M, N, b0, bend,
      max_bounces, t_min, seed, work);
  return (int)cudaGetLastError();
}
