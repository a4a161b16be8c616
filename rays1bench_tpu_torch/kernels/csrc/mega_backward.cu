// Fused backward of the fixed-topology replay, for Hopper (sm_90a).
//
// Replaces the Pallas kernel rays1bench_tpu/kernels/mega_backward.py
// `_bwd_kernel` (launched by `backward_pallas`), hard and soft mode. Given N primary
// rays, their ids, the per-ray cotangents of the traced radiance and the
// forward's hit topology, it returns the cotangents of the ten GRAD_ROWS
// sphere columns, summed per row into grads[10, S], and the cotangents of
// the six primary-ray planes. Plain version and wrapper:
// rays1bench_tpu_torch/kernels/mega_backward.py (`backward_reference`,
// `backward`).
//
// Design. One thread owns one ray and runs r1b::backward_ray
// (path_adjoint.cuh).
// - Forward replay: the ray re-advances (o, d, a) bounce by bounce through
//   the recorded rows with the replay's exact math (replay_hit and
//   r1b::scatter on the exact (11, S) table), and checkpoints each live
//   bounce's 9-float state in a per-thread array, with the continue,
//   dielectric-mirror and take decisions as bits. The array's depth is a
//   template parameter: the launch picks the instantiation for a cap of
//   10 bounces (every gradient recipe) or of kMaxBounces, the smallest that
//   holds the config; deeper configs are refused. Checkpointing keeps the
//   reverse pass linear in the depth; recomputing the state from the
//   primary ray for each reverse step would cost O(depth^2) bounces.
// - Reverse: from the last live bounce down, the hand-derived adjoint of
//   one bounce (path_adjoint.cuh) pulls the cotangents of (o, d, a) back
//   and yields the ten column cotangents of the bounce's row. The winning
//   row is one shared-memory load by index: the Pallas kernel's S-select
//   sweep over the table was a TPU workaround.
// - Accumulation, warp-aggregated (warp_add): the lanes of a warp run the
//   reverse loop together for the warp's deepest ray, each at its own
//   bounce; at each step the lanes holding a continuing hit group by row
//   (__match_any_sync), each group sums its ten cotangents over its lanes
//   with a tree of shuffles, and the group's first lane adds the sums into
//   the block's (10, S) accumulator in shared memory. Most lanes of a warp
//   hit one row (the ground of a small scene), so this replaces up to 32
//   conflicting shared atomics per address with one.
// - Resident blocks: the launch runs as many blocks as the card holds at
//   once, so a block stages the table, zeroes its accumulator and flushes
//   each non-zero entry with one global atomicAdd once per launch, not
//   once per 128 rays. Their warps take 32-ray chunks from a counter in
//   device memory, so that none is left with a fixed share of deep rays
//   while the others idle. The order of the float sums changes from run
//   to run.
//
// Soft mode (soft_eps != 0, the kSoft instantiation): the replay rebuilds
// each bounce's soft record from the recorded, already promoted row
// (r1b::replay_soft_hit: cover, far exit, renormalized normal), redraws
// take = u < cover from the SILHOUETTE_P slot and records it as a bit beside
// the continue and mirror bits, so that the reverse pass follows the branch
// the forward took (r1b::soft_bounce_adj). The table is the same; soft adds
// no shared memory.
//
// What bounds it: FP32 issue in the replay and the adjoint (a few hundred
// operations per live bounce, with no sweep), and the row sums. sm_90 has
// no native float add to shared memory: atomicAdd compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN), which 32 lanes adding to one
// address retry up to 32 times. Measured on the soft geometry fit's frame
// (1280x720 @ 4 spp @ 10 b, 8 rows; NVIDIA H100 80GB HBM3, 700 W): one
// atomic per column and lane took 1.354 ms, of which 0.91 ms went to the
// adds (0.446 ms without them); warp-aggregated, 0.689 ms, of which ~0.25
// ms is still the row sums. The bytes bound is 0.119 ms. Shared memory:
// 84 B per table row (44 table + 40 accumulator), 43,008 B at 512 rows.
#include <cuda_runtime.h>
#include <stdint.h>

#include "path_adjoint.cuh"
#include "path_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBounces = 50;   // mega_backward.MAX_BOUNCES
constexpr int kShallowCap = 10;   // the gradient recipes' max_bounces
constexpr unsigned kFull = 0xFFFFFFFFu;

// Add each lane's ten column cotangents gcol of row j (where has) into
// acc[g * S + j], summed over the warp's lanes by row first. Every lane of
// the warp calls it together.
__device__ __forceinline__ void warp_add(float* acc, int S, int lane,
                                         bool has, int j, const float* gcol) {
  const unsigned m = __ballot_sync(kFull, has);
  if (!has) return;
  // A tree over each group of lanes sharing a row. At round r the lanes
  // whose rank in the group is a multiple of 2^(r+1) add the partial sum
  // of rank + 2^r; rank 0 ends with the group's sum. A warp whose lanes
  // all hold one row takes 5 rounds, as a butterfly would.
  const unsigned peers = __match_any_sync(m, j);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int rounds = 32 - __clz(__reduce_max_sync(m, __popc(peers)) - 1);
  float v[r1b::kNumGrad];
#pragma unroll
  for (int g = 0; g < r1b::kNumGrad; ++g) v[g] = gcol[g];
  unsigned above = peers & ~((2u << lane) - 1u);  // the group's lanes above
  int cleared = 0;
  for (int r = 0; r < rounds; ++r) {
    for (; cleared < (1 << r) - 1; ++cleared) above &= above - 1u;
    const int src = above ? __ffs(above) - 1 : lane;  // rank + 2^r
    const bool take = above != 0 && (rank & ((2 << r) - 1)) == 0;
#pragma unroll
    for (int g = 0; g < r1b::kNumGrad; ++g) {
      const float x = __shfl_sync(m, v[g], src);
      if (take) v[g] += x;
    }
  }
  if (rank == 0) {
#pragma unroll
    for (int g = 0; g < r1b::kNumGrad; ++g) atomicAdd(&acc[g * S + j], v[g]);
  }
}

template <bool kSoft, int kCap>
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
                uint32_t seed, float inv_eps, float* __restrict__ grads,
                float* __restrict__ g_ox, float* __restrict__ g_oy,
                float* __restrict__ g_oz, float* __restrict__ g_dx,
                float* __restrict__ g_dy, float* __restrict__ g_dz,
                int* __restrict__ work) {
  extern __shared__ float smem[];
  float* tab = smem;                               // (11, S)
  float* acc = smem + r1b::kNumExactRows * S;      // (10, S)

  const int tid = threadIdx.x, lane = tid & 31;
  for (int k = tid; k < r1b::kNumExactRows * S; k += kThreads)
    tab[k] = table[k];
  for (int k = tid; k < r1b::kNumGrad * S; k += kThreads) acc[k] = 0.0f;
  __syncthreads();

  // Each warp takes the next 32-ray chunk from the launch's counter until
  // none is left, so that the warps finish together however the depth of
  // the rays varies; every lane runs every chunk, in range or not, so that
  // the warp's shuffles see all 32 lanes.
  for (;;) {
    int chunk = 0;
    if (lane == 0) chunk = atomicAdd(work, 1);
    const int base = __shfl_sync(kFull, chunk, 0) * 32;
    if (base >= N) break;
    const int i = base + lane;
    const bool valid = i < N;
    const int rid_i = valid ? ray_id[i] : n_rays;
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
    float crad[3] = {0.0f, 0.0f, 0.0f};
    if (valid) {
      o[0] = ox_in[i]; o[1] = oy_in[i]; o[2] = oz_in[i];
      d[0] = dx_in[i]; d[1] = dy_in[i]; d[2] = dz_in[i];
      crad[0] = ct_r[i]; crad[1] = ct_g[i]; crad[2] = ct_b[i];
    }
    float go[3], gd[3];
    r1b::backward_ray<kSoft, kCap>(
        tab, S, topo + (valid ? i : 0), N, rid_i < n_rays, (uint32_t)rid_i,
        o, d, crad, max_bounces, t_min, seed, inv_eps, go, gd,
        [](int live) { return __reduce_max_sync(kFull, live); },
        [&](bool has, int j, const float* gcol) {
          warp_add(acc, S, lane, has, j, gcol);
        });
    if (valid) {
      g_ox[i] = go[0];
      g_oy[i] = go[1];
      g_oz[i] = go[2];
      g_dx[i] = gd[0];
      g_dy[i] = gd[1];
      g_dz[i] = gd[2];
    }
  }

  __syncthreads();
  for (int k = tid; k < r1b::kNumGrad * S; k += kThreads) {
    const float v = acc[k];
    if (v != 0.0f) atomicAdd(&grads[k], v);
  }
}

template <bool kSoft, int kCap>
int launch(const float* table, int S, const float* ox, const float* oy,
           const float* oz, const float* dx, const float* dy,
           const float* dz, const int* ray_id, const float* ct_r,
           const float* ct_g, const float* ct_b, const int* topo, int N,
           int n_rays, int max_bounces, float t_min, uint32_t seed,
           float inv_eps, float* grads, float* g_ox, float* g_oy,
           float* g_oz, float* g_dx, float* g_dy, float* g_dz, int* work,
           cudaStream_t stream) {
  auto kernel = backward_kernel<kSoft, kCap>;
  const size_t smem = sizeof(float) *
                      (r1b::kNumExactRows + r1b::kNumGrad) * (size_t)S;
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
  const int chunks = (N + kThreads - 1) / kThreads;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const int grid = chunks < resident ? chunks : resident;
  kernel<<<grid, kThreads, smem, stream>>>(
      table, S, ox, oy, oz, dx, dy, dz, ray_id, ct_r, ct_g, ct_b, topo, N,
      n_rays, max_bounces, t_min, seed, inv_eps, grads, g_ox, g_oy, g_oz,
      g_dx, g_dy, g_dz, work);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the attribute or occupancy
// query or of the launch (0 on success). grads (10, S) and the chunk
// counter *work must be zero on entry; the six cotangent planes are
// written for every ray. N > 0, max_bounces <= kMaxBounces. soft_eps != 0
// runs the soft mode with inv_eps = float32(1 / soft_eps).
extern "C" int rays1_backward_launch(
    const float* table, int S, const float* ox, const float* oy,
    const float* oz, const float* dx, const float* dy, const float* dz,
    const int* ray_id, const float* ct_r, const float* ct_g,
    const float* ct_b, const int* topo, int N, int n_rays, int max_bounces,
    float t_min, uint32_t seed, float soft_eps, float inv_eps, float* grads,
    float* g_ox, float* g_oy, float* g_oz, float* g_dx, float* g_dy,
    float* g_dz, int* work, void* stream) {
  if (max_bounces > kMaxBounces) return (int)cudaErrorInvalidValue;
  const bool soft = soft_eps != 0.0f, shallow = max_bounces <= kShallowCap;
  auto fn = soft ? (shallow ? launch<true, kShallowCap>
                            : launch<true, kMaxBounces>)
                 : (shallow ? launch<false, kShallowCap>
                            : launch<false, kMaxBounces>);
  return fn(table, S, ox, oy, oz, dx, dy, dz, ray_id, ct_r, ct_g, ct_b, topo,
            N, n_rays, max_bounces, t_min, seed, inv_eps, grads, g_ox, g_oy,
            g_oz, g_dx, g_dy, g_dz, work, (cudaStream_t)stream);
}
