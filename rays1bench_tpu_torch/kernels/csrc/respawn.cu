// Sample-respawn path tracer for Hopper (sm_90a).
//
// Replaces the Pallas kernel rays1bench_tpu/kernels/megakernel.py
// `_respawn_kernel` (launched by `trace_pallas_respawn`): every sample of
// every pixel, traced to completion, with per-pixel radiance sums and
// per-pixel counts of traced rays. Plain version and wrapper:
// rays1bench_tpu_torch/kernels/megakernel.py.
//
// Design. One thread owns one pixel and runs plain nested loops: samples
// s_lo..s_hi-1, and for each up to max_bounces+1 segments. A TPU lane cannot
// retire on its own, which is why the Pallas kernel respawns the next sample
// in-register when a path ends; a CUDA thread simply moves on to its next
// sample, so none of that machinery is needed. The per-step order is the
// Pallas kernel's: count the step, sweep, add sky on a miss, scatter, then
// continue while alive & hit & ok & b < max_bounces. Sample sums land in
// sample order, as the TPU lanes add them. Threads form 16x8 pixel blocks
// and write straight into image order (row 0 = bottom), so no slot
// permutation exists.
//
// What bounds it: FP32 issue in the S-long closest-hit sweep (512 rows on
// the large scene). Its sm_90a SASS is 27 instructions per sphere when the
// discriminant is negative, 16 of them FP32 add or multiply, and 45 when the
// IEEE square root is taken. The (7, S) sphere table is staged once per block in dynamic
// shared memory; every thread of a warp reads the same row at the same time,
// so each load is a broadcast and sphere loads are cheap. Tables above
// 48 KB (the giant scene's 4096 rows are 114,688 B) need the opt-in
// attribute set below; the wrapper refuses tables above 227 KB.
//
// Counting: each thread's count is reduced over its warp, then over the
// block in shared memory, and added to the 64-bit total with one atomicAdd
// per block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "path_math.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;

__global__ void __launch_bounds__(kThreads)
respawn_kernel(const float* __restrict__ spheres, int S,
               const float* __restrict__ cam_in, int width, int height,
               int spp, int s_lo, int s_hi, int max_bounces, float t_min,
               uint32_t seed, float inv_w, float inv_h,
               float* __restrict__ rr_out, float* __restrict__ rg_out,
               float* __restrict__ rb_out, int* __restrict__ cnt_out,
               unsigned long long* __restrict__ total) {
  extern __shared__ float sph[];
  __shared__ float cam[19];
  __shared__ unsigned long long warp_sums[kThreads / 32];

  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  for (int i = tid; i < r1b::kNumRows * S; i += kThreads) sph[i] = spheres[i];
  if (tid < 19) cam[tid] = cam_in[tid];
  __syncthreads();

  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  int cnt = 0;
  if (x < width && y < height) {
    const int pid = y * width + x;
    const float xf = (float)x, yf = (float)y;
    float rr = 0.0f, rg = 0.0f, rb = 0.0f;
    for (int s = s_lo; s < s_hi; ++s) {
      const uint32_t rid = (uint32_t)(pid * spp + s);
      float ju, jv;
      r1b::uniform_pair16(seed, rid, r1b::kBounceRaygen,
                          r1b::kSlotPixelJitter, ju, jv);
      float ox, oy, oz, dx, dy, dz;
      r1b::generate_ray(cam, (xf + ju) * inv_w, (yf + jv) * inv_h, seed, rid,
                        ox, oy, oz, dx, dy, dz);
      float ar = 1.0f, ag = 1.0f, ab = 1.0f;
      for (int b = 0;; ++b) {
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
          break;
        }
        const r1b::Hit h =
            r1b::unpack_hit(sph, S, best, bt, ox, oy, oz, dx, dy, dz);
        float sx, sy, sz;
        const bool ok =
            r1b::scatter(h, dx, dy, dz, seed, rid, (uint32_t)b, sx, sy, sz);
        if (!(ok && b < max_bounces)) break;
        ox = h.px;
        oy = h.py;
        oz = h.pz;
        dx = sx;
        dy = sy;
        dz = sz;
        ar = ar * h.albedo_x;
        ag = ag * h.albedo_y;
        ab = ab * h.albedo_z;
      }
    }
    rr_out[pid] = rr;
    rg_out[pid] = rg;
    rb_out[pid] = rb;
    cnt_out[pid] = cnt;
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
// launch (0 on success). Outputs are per pixel in image order; *total must
// be zero on entry.
extern "C" int rays1_respawn_launch(
    const float* spheres, int S, const float* cam, int width, int height,
    int spp, int s_lo, int s_hi, int max_bounces, float t_min, uint32_t seed,
    float inv_w, float inv_h, float* rr, float* rg, float* rb, int* cnt,
    unsigned long long* total, void* stream) {
  const size_t smem = sizeof(float) * r1b::kNumRows * (size_t)S;
  cudaError_t err = cudaFuncSetAttribute(
      respawn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  respawn_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      spheres, S, cam, width, height, spp, s_lo, s_hi, max_bounces, t_min,
      seed, inv_w, inv_h, rr, rg, rb, cnt, total);
  return (int)cudaGetLastError();
}
