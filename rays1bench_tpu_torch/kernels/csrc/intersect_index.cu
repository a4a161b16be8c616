// Gradient-free closest-hit index per ray, for Hopper (sm_90a): the sweep of
// the differentiable pipeline (render/pipeline.render_image with
// cfg.pallas_intersect, the engine="pipeline" gradient).
//
// Replaces the Pallas kernel rays1bench_tpu/kernels/intersect_pallas.py
// `_kernel` (launched by `closest_hit_index`). For each ray it returns the
// first row of the sphere table (center x/y/z, radius_sq poisoned to -1e30
// on placeholder rows) with the smallest root above t_min, 0 where there is
// none, and whether that root is below float32(3e38). Plain version and
// wrapper: rays1bench_tpu_torch/kernels/intersect_index.py
// (`closest_hit_index_reference`, `closest_hit_index`).
//
// The Pallas kernel's form is kept: a row counts only where disc > 0 (its
// `disc > 0 ? sqrt(max(disc, 0)) : INF`), t = t1 > t_min ? t1 : t2, the root
// must exceed t_min, a strict < keeps the first row among equal roots, and
// there is no t_max test. Skipping a row with disc <= 0 is that form: its
// root would be INF, which never wins.
//
// Design. One thread per ray, no padding of N (the Pallas kernel pads N to
// its 2048-ray tile, a TPU layout constraint). The kernel reads the
// prepared columns center_x/y/z, radius_sq and valid themselves and stages
// the table a tile of r1b::kIndexTile rows (16 KB) at a time, in row order,
// as float4 {cx, cy, cz, valid > 0 ? radius_sq : -1e30} rows
// (r1b::index_tiles), so the wrapper launches no torch op ahead of it and
// a block's shared memory no longer grows with S: the giant scene's 4,096
// rows took 64 KB a block of 128 threads, 12 warps an SM; blocks of 512
// threads share a tile among 16 warps. Every thread of
// a warp reads the same row at once, one LDS.128 each, and every ray
// sweeps every row, so the warps' trip counts agree.
//
// What bounds it: FP32 issue, S sphere tests per ray (16 FP32 adds and
// multiplies on the path where disc <= 0); its bytes, six planes in and two
// out per ray, are 29 B a ray.
#include <cuda_runtime.h>
#include <stdint.h>

#include "path_math.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
index_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
             const float* __restrict__ cz, const float* __restrict__ rsq,
             const float* __restrict__ valid, int S,
             const float* __restrict__ ox_in, const float* __restrict__ oy_in,
             const float* __restrict__ oz_in, const float* __restrict__ dx_in,
             const float* __restrict__ dy_in, const float* __restrict__ dz_in,
             int N, float t_min, int* __restrict__ idx_out,
             uint8_t* __restrict__ hit_out) {
  extern __shared__ float4 tile[];  // min(S, kIndexTile) rows
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool mine = i < N;
  const float ox = mine ? ox_in[i] : 0.0f, oy = mine ? oy_in[i] : 0.0f;
  const float oz = mine ? oz_in[i] : 0.0f, dx = mine ? dx_in[i] : 0.0f;
  const float dy = mine ? dy_in[i] : 0.0f, dz = mine ? dz_in[i] : 0.0f;
  float bt;
  const int bi = r1b::index_tiles(cx, cy, cz, rsq, valid, S, threadIdx.x,
                                  kThreads, tile, t_min, ox, oy, oz, dx, dy,
                                  dz, bt, [] { __syncthreads(); });
  if (!mine) return;
  idx_out[i] = bi;
  hit_out[i] = bt < 0x1.c363ccp+127f ? 1 : 0;  // float32(3e38)
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the attribute call or the
// launch (0 on success). cx, cy, cz, rsq and valid are the (S) float32
// columns of the prepared spheres; outputs are per ray in input order;
// N > 0.
extern "C" int rays1_index_launch(const float* cx, const float* cy,
                                  const float* cz, const float* rsq,
                                  const float* valid, int S, const float* ox,
                                  const float* oy, const float* oz,
                                  const float* dx, const float* dy,
                                  const float* dz, int N, float t_min,
                                  int* idx, uint8_t* hit, void* stream) {
  const int rows = S < r1b::kIndexTile ? S : r1b::kIndexTile;
  const size_t smem = sizeof(float4) * (size_t)rows;
  cudaError_t err = cudaFuncSetAttribute(
      index_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + kThreads - 1) / kThreads;
  index_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      cx, cy, cz, rsq, valid, S, ox, oy, oz, dx, dy, dz, N, t_min, idx, hit);
  return (int)cudaGetLastError();
}
