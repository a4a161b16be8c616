// One-shot path tracer, optionally with hit topology, for Hopper (sm_90a):
// the one-shot render engine and the forward of the gradient path.
//
// Replaces the Pallas kernel rays1bench_tpu/kernels/megakernel.py `_kernel`
// (launched by `trace_pallas`), hard and soft mode. Given N primary rays and their
// global ids, it traces each ray to completion and writes per-ray radiance,
// per-ray counts of traced rays and, when `topo` is not null
// (emit_topology=True), for every bounce b the winning sphere row of a live
// lane that hit (-1 otherwise). A null `topo` skips the plane writes: the
// one-shot render engine. Plain version and wrappers:
// rays1bench_tpu_torch/kernels/megakernel.py (`trace_topology_reference`,
// `trace_topology`, `trace_oneshot`).
//
// Design. Each thread runs r1b::oneshot_lane (path_math.cuh): one flat loop
// of segments in which a ray that ends hands its lane the next ray index,
// so that a warp runs as long as its busiest lane's share of segments,
// not, as a thread-per-ray loop nest does, as long as the deepest of its 32
// rays (the depths of the large scene's rays vary from 1 to 51 segments:
// the nest keeps ~0.4 of its lanes busy there). The body keeps one path to the
// back-edge, with selects and predicated loads and stores: with a branch
// around the refill, nvcc splits such a loop back into a nest (respawn.cu).
// Tables of fewer than r1b::kNestRows rows (the small scene's 8) take
// r1b::oneshot_ray instead, a thread per ray and a block per 128 rays:
// there a segment's sweep is short, and the flat loop's refill and its
// unconditional record and scatter, run by every lane every round, cost
// more than the idle lanes they save (bench.variants: 0.36 against 0.31
// ms on the soft fit's frame, 0.68 against 0.61 on the small CLI frame).
// The next ray comes from a counter in device memory that the wrapper
// zeroes: the warp's lanes that need a ray vote, one lane adds their number
// to the counter, and each takes the old value plus its rank among them, so
// refilled lanes read neighbouring rays. (Claims of 32 to 128 rays a warp,
// and static shares of rays a lane or of 32-ray chunks a warp, were
// slower: bench.variants.) The launch runs as many blocks as the card
// holds at once, so each block stages the table once.
//
// A ray that ends writes its radiance and count at its own index i, and -1
// into its topology planes past its end, [b * N + i] for b up to
// max_bounces: every entry is written exactly once, so the wrapper
// allocates the topology with torch.empty. (Filling the planes with -1
// ahead of the kernel instead was slower on the topology frames:
// bench.variants.) Ids >= n_rays are padding, never traced or counted.
//
// What bounds it: FP32 issue in the S-long closest-hit sweep. The (7, S)
// table is staged once per block in dynamic shared memory in the broadcast
// layout of r1b::stage_row (float4 {cx, cy, cz, radius_sq} rows, one
// LDS.128 per sphere that every lane of the warp reads at once, and the
// payload rows apart) and swept by r1b::sweep4, unrolled 8 times.
//
// Counting: each thread's count is reduced over its warp, then over the
// block in shared memory, and added to the 64-bit total with one atomicAdd
// per block.
//
// Soft mode (soft_eps != 0, the kernel's kSoft instantiation): after the
// hard sweep a second, graze sweep over the same hot rows finds the ray's
// best near miss in front of its hit (r1b::graze_sweep4); an edge above
// near_cut = float32(-9.2 * soft_eps) promotes the ray to that row at t =
// nb, which the topology records. The hit record then comes from
// r1b::soft_hit4 (cover, far exit, renormalized normal) and the bounce takes
// the two-branch draw of the SILHOUETTE_P slot: bounce with weight cover /
// max(cover, 1e-20), or pass through from the far exit with the direction
// kept and weight (1 - cover) / max(1 - cover, 1e-20). sqrt(max(radius_sq,
// 0)) depends on the row only, so each block stages it as a fourth payload
// row. Plain version: megakernel.soft_sweep and soft_hit_record under
// render.integrator.two_branch.
//
// Trips (kIters, the Pallas kernel's debug_iters): a warp's serial work is
// the trips of its loop. The flat loop counts, on every lane alike, the
// rounds in which its warp still held a ray (the `any` at the loop's head);
// the thread-per-ray path, whose warp runs a bounce while any lane's ray
// lives, counts the largest count of its lanes. Each warp adds its trips to
// a 64-bit total with one atomicAdd. The flat loop's trips depend on the
// order in which the lanes take the rays, so only their bounds are fixed:
// 32 x trips >= the segments traced. The kIters = false instantiations
// compile to the kernel without it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "path_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <bool kSoft, bool kIters>
__global__ void __launch_bounds__(kThreads)
oneshot_kernel(const float* __restrict__ spheres, int S,
               const float* __restrict__ ox_in, const float* __restrict__ oy_in,
               const float* __restrict__ oz_in, const float* __restrict__ dx_in,
               const float* __restrict__ dy_in, const float* __restrict__ dz_in,
               const int* __restrict__ ray_id, int N, int n_rays,
               int max_bounces, float t_min, uint32_t seed, float inv_eps,
               float near_cut, float* __restrict__ rr_out,
               float* __restrict__ rg_out, float* __restrict__ rb_out,
               int* __restrict__ cnt_out, int* __restrict__ topo,
               unsigned long long* __restrict__ total,
               int* __restrict__ work,
               unsigned long long* __restrict__ iters) {
  extern __shared__ float4 hot[];  // (S) float4, then (3, S) payload
  float* pay = reinterpret_cast<float*>(hot + S);  // soft: a 4th row, sr
  __shared__ unsigned long long warp_sums[kThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31;
  for (int s = tid; s < S; s += kThreads) {
    r1b::stage_row(spheres, S, s, hot, pay);
    if (kSoft)
      pay[3 * S + s] =
          sqrtf(r1b::clamp_min_nan(spheres[r1b::kRSQ * S + s], 0.0f));
  }
  __syncthreads();

  unsigned long long c = 0;
  int trips = 0;
  if (S < r1b::kNestRows) {
    const int i = blockIdx.x * kThreads + tid;
    if (i < N)
      c = r1b::oneshot_ray<kSoft>(hot, pay, S, i, ox_in, oy_in, oz_in, dx_in,
                                  dy_in, dz_in, ray_id, N, n_rays,
                                  max_bounces, t_min, seed, inv_eps,
                                  near_cut, rr_out, rg_out, rb_out, cnt_out,
                                  topo);
    if (kIters) trips = __reduce_max_sync(kFull, (unsigned)c);
  } else {
    auto take = [&](bool need, int) {
      const unsigned m = __ballot_sync(kFull, need);
      int base = 0;
      if (lane == 0 && m) base = atomicAdd(work, __popc(m));
      base = __shfl_sync(kFull, base, 0);
      return base + __popc(m & ((1u << lane) - 1u));
    };
    auto any = [&](bool p) {
      const bool r = __any_sync(kFull, p) != 0;
      if (kIters) trips += r ? 1 : 0;
      return r;
    };
    c = r1b::oneshot_lane<kSoft>(hot, pay, S, ox_in, oy_in, oz_in, dx_in,
                                 dy_in, dz_in, ray_id, N, n_rays,
                                 max_bounces, t_min, seed, inv_eps, near_cut,
                                 rr_out, rg_out, rb_out, cnt_out, topo, take,
                                 any);
  }

  if (kIters && lane == 0) atomicAdd(iters, (unsigned long long)trips);
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(kFull, c, off);
  if (lane == 0) warp_sums[tid >> 5] = c;
  __syncthreads();
  if (tid == 0) {
    unsigned long long block = 0;
    for (int w = 0; w < kThreads / 32; ++w) block += warp_sums[w];
    atomicAdd(total, block);
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the attribute or occupancy
// query or of the launch (0 on success). Outputs are per ray in
// input order; topo is (max_bounces+1, N) row-major, or null for no
// topology; *total and the ray counter *work must be zero on entry; N > 0.
// soft_eps != 0 runs the soft mode with inv_eps = float32(1 / soft_eps) and
// near_cut = float32(-9.2 * soft_eps). iters: null, or a zeroed 64-bit word
// that receives the warps' loop trips (the kIters instantiations).
extern "C" int rays1_oneshot_launch(
    const float* spheres, int S, const float* ox, const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const int* ray_id, int N, int n_rays, int max_bounces, float t_min,
    uint32_t seed, float soft_eps, float inv_eps, float near_cut, float* rr,
    float* rg, float* rb, int* cnt, int* topo, unsigned long long* total,
    int* work, unsigned long long* iters, void* stream) {
  const bool soft = soft_eps != 0.0f;
  auto kernel = soft ? (iters ? oneshot_kernel<true, true>
                              : oneshot_kernel<true, false>)
                     : (iters ? oneshot_kernel<false, true>
                              : oneshot_kernel<false, false>);
  const size_t smem =
      sizeof(float) * (r1b::kNumRows + (soft ? 1 : 0)) * (size_t)S;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kThreads - 1) / kThreads;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int grid =
      S < r1b::kNestRows || blocks < resident ? blocks : resident;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      spheres, S, ox, oy, oz, dx, dy, dz, ray_id, N, n_rays, max_bounces,
      t_min, seed, inv_eps, near_cut, rr, rg, rb, cnt, topo, total, work,
      iters);
  return (int)cudaGetLastError();
}
