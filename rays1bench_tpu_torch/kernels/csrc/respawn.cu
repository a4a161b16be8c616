// Sample-respawn path tracer for Hopper (sm_90a).
//
// Replaces the Pallas kernel rays1bench_tpu/kernels/megakernel.py
// `_respawn_kernel` (launched by `trace_pallas_respawn`): every sample of
// every pixel, traced to completion, with per-pixel radiance sums and
// per-pixel counts of traced rays. Plain version and wrapper:
// rays1bench_tpu_torch/kernels/megakernel.py.
//
// Design. One thread owns one pixel and runs r1b::respawn_pixel
// (path_math.cuh): one flat loop of segments, in which a path that ends
// respawns the pixel's next sample in registers, as the Pallas kernel's
// lanes do. Under SIMT this is what keeps a warp's lanes busy: in a loop
// nest (for each sample, for each bounce) nvcc ends the bounce loop with a
// reconvergence barrier, so every lane whose path ended early idles until
// the deepest path of its 32 lanes ends, on every sample, and the warp
// pays the sum over samples of its deepest path. The flat loop pays the
// segments of its busiest pixel, which over 250 samples is close to the
// mean. Its body keeps one path to the back-edge (selects, not a branch
// around the respawn): with two, nvcc splits the loop back into the nest.
// Lane occupancy on the headline (chip_smoke.py `occupancy`, NVIDIA H100
// 80GB HBM3): 0.27 for the nest on 16x2-pixel warps, 0.83 for the flat
// loop on 8x4-pixel warps.
// Warps cover 8x4 pixels, which are more alike than a 16x2 strip; blocks
// are 2x2 warps, 16x8 pixels, and write straight into image order (row 0
// = bottom). Per-step order and sample-order sums are the plain
// version's, so the frame is equal to it bit for bit.
//
// What bounds it: FP32 issue in the S-long closest-hit sweep (512 rows on
// the large scene). The (7, S) table is staged once per block in dynamic
// shared memory in the broadcast layout of r1b::stage_row: the hot rows as
// float4 {cx, cy, cz, radius_sq}, one LDS.128 per sphere that every lane
// of the warp reads at once, and the payload rows apart, read only by
// r1b::unpack_hit4. r1b::sweep4 unrolls by kSweepUnroll (8: 4 and 16 were
// slower). Its sm_90a SASS (python -m rays1bench_tpu_torch.bench.sass): 21
// instructions per sphere test on the miss path (one LDS.128, 9 FADD, 7
// FMUL, the compare, the branch around the root and its reconvergence),
// 43 with the root. The frame runs at ~0.45 of its FP32 bound; the rest goes to the branch
// around each root, which a warp takes when any of its lanes needs it, to
// the 17% of lanes that still wait for their warp's busiest pixel, and to
// the unpack, scatter and raygen that every lane runs each segment. Tables
// above 48 KB (the giant scene's 4096 rows are 114,688 B) need the opt-in
// attribute set below; the wrapper refuses tables above 227 KB.
//
// Counting: each thread's count is reduced over its warp, then over the
// block in shared memory, and added to the 64-bit total with one atomicAdd
// per block.
//
// Rows: a launch covers a set of the frame's 8-row block-rows: from the one
// at y_lo, every stride-th, each cut at y_hi (stride 1: the rows [y_lo,
// y_hi), the whole frame or a band; stride n: a rank of a sharded render
// over n, which holds a cross-section of the frame so that the ranks' work
// is balanced). Block (bx, by) of the grid covers block-row y_lo / 8 + by *
// stride, and the outputs hold the set's pixels in image order, compactly:
// block by's rows start at output row 8 * by. y_lo is a multiple of the
// block height, so a set's warps are the whole frame's warps.
//
// Trips (kIters, the Pallas kernel's debug_iters): a warp's serial work is
// the trips of its flat loop, which it runs as long as its busiest lane, and
// a lane runs one trip a segment it counts. Each warp adds the largest count
// of its lanes to a 64-bit trip total with one atomicAdd. The kIters = false
// instantiation compiles to the kernel without it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "path_math.cuh"

namespace {

constexpr int kWarpW = 8, kWarpH = 4;        // pixels of one warp
constexpr int kWarpsX = 2, kWarpsY = 2;      // warps of one block
constexpr int kBlockX = kWarpW * kWarpsX;    // 16
constexpr int kBlockY = kWarpH * kWarpsY;    // 8
constexpr int kThreads = kBlockX * kBlockY;  // 128

template <bool kIters>
__global__ void __launch_bounds__(kThreads)
respawn_kernel(const float* __restrict__ spheres, int S,
               const float* __restrict__ cam_in, int width, int y_hi,
               int spp, int s_lo, int s_hi, int max_bounces, float t_min,
               uint32_t seed, float inv_w, float inv_h,
               float* __restrict__ rr_out, float* __restrict__ rg_out,
               float* __restrict__ rb_out, int* __restrict__ cnt_out,
               unsigned long long* __restrict__ total, int y_lo,
               unsigned long long* __restrict__ iters, int stride) {
  extern __shared__ float4 hot[];  // (S) float4, then (3, S) payload
  float* pay = reinterpret_cast<float*>(hot + S);
  __shared__ float cam[19];
  __shared__ unsigned long long warp_sums[kThreads / 32];

  const int tid = threadIdx.x;
  for (int s = tid; s < S; s += kThreads) r1b::stage_row(spheres, S, s, hot, pay);
  if (tid < 19) cam[tid] = cam_in[tid];
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int x = blockIdx.x * kBlockX + (warp % kWarpsX) * kWarpW +
                lane % kWarpW;
  const int in_block = (warp / kWarpsX) * kWarpH + lane / kWarpW;
  const int row = blockIdx.y * kBlockY + in_block;  // of the outputs
  const int y = y_lo + blockIdx.y * stride * kBlockY + in_block;
  int cnt = 0;
  if (x < width && y < y_hi) {
    const int pid = y * width + x;
    const int out = row * width + x;
    float rr = 0.0f, rg = 0.0f, rb = 0.0f;
    cnt = r1b::respawn_pixel(hot, pay, S, cam, pid, (float)x, (float)y, spp,
                             s_lo, s_hi, max_bounces, t_min, seed, inv_w,
                             inv_h, rr, rg, rb);
    rr_out[out] = rr;
    rg_out[out] = rg;
    rb_out[out] = rb;
    cnt_out[out] = cnt;
  }
  if (kIters) {
    const int trips = __reduce_max_sync(0xFFFFFFFFu, cnt);
    if (lane == 0) atomicAdd(iters, (unsigned long long)trips);
  }

  unsigned long long c = (unsigned long long)cnt;
  for (int off = 16; off > 0; off >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, off);
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (tid == 0) {
    unsigned long long block = 0;
    for (int w = 0; w < kThreads / 32; ++w) block += warp_sums[w];
    atomicAdd(total, block);
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the attribute call or the
// launch (0 on success). Traces the block-rows from y_lo every stride-th,
// cut at y_hi (0 <= y_lo < y_hi, y_lo a multiple of 8, stride >= 1), of a
// frame of width pixels; inv_h is 1 / the frame's height. Outputs are per
// pixel of the set in image order; *total must be zero on entry. iters:
// null, or a zeroed 64-bit word that receives the warps' loop trips (the
// kIters instantiation).
extern "C" int rays1_respawn_launch(
    const float* spheres, int S, const float* cam, int width, int y_hi,
    int spp, int s_lo, int s_hi, int max_bounces, float t_min, uint32_t seed,
    float inv_w, float inv_h, float* rr, float* rg, float* rb, int* cnt,
    unsigned long long* total, int y_lo, unsigned long long* iters,
    int stride, void* stream) {
  auto kernel = iters ? respawn_kernel<true> : respawn_kernel<false>;
  const size_t smem = sizeof(float) * r1b::kNumRows * (size_t)S;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int block_rows = (y_hi - y_lo + kBlockY - 1) / kBlockY;
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (block_rows + stride - 1) / stride);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      spheres, S, cam, width, y_hi, spp, s_lo, s_hi, max_bounces, t_min,
      seed, inv_w, inv_h, rr, rg, rb, cnt, total, y_lo, iters, stride);
  return (int)cudaGetLastError();
}
