// Gradient-free closest-hit index per ray, for Hopper (sm_90a): the sweep of
// the differentiable pipeline (render/pipeline.render_image with
// cfg.pallas_intersect, the engine="pipeline" gradient).
//
// Replaces the Pallas kernel rays1bench_tpu/kernels/intersect_pallas.py
// `_kernel` (launched by `closest_hit_index`). For each ray it returns the
// first row of the (4, S) table (center x/y/z, radius_sq poisoned to -1e30
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
// its 2048-ray tile, a TPU layout constraint). The (4, S) table is staged
// once per block in dynamic shared memory and every thread of a warp reads
// the same row at once, so each load is a broadcast. The giant scene's 4,096
// rows are 65,536 B, above the 48 KB default: the launch opts in with
// cudaFuncSetAttribute, as respawn.cu does.
//
// What bounds it: FP32 issue, S sphere tests per ray (16 FP32 adds and
// multiplies on the path where disc <= 0); its bytes, six planes in and two
// out per ray, are 32 B a ray.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // center x, y, z, radius_sq

__global__ void __launch_bounds__(kThreads)
index_kernel(const float* __restrict__ table, int S,
             const float* __restrict__ ox_in, const float* __restrict__ oy_in,
             const float* __restrict__ oz_in, const float* __restrict__ dx_in,
             const float* __restrict__ dy_in, const float* __restrict__ dz_in,
             int N, float t_min, int* __restrict__ idx_out,
             uint8_t* __restrict__ hit_out) {
  extern __shared__ float sph[];
  for (int i = threadIdx.x; i < kRows * S; i += kThreads) sph[i] = table[i];
  __syncthreads();

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= N) return;
  const float ox = ox_in[i], oy = oy_in[i], oz = oz_in[i];
  const float dx = dx_in[i], dy = dy_in[i], dz = dz_in[i];
  float bt = __int_as_float(0x7f800000);  // +inf
  int bi = 0;
  for (int s = 0; s < S; ++s) {
    const float cox = sph[s] - ox;
    const float coy = sph[S + s] - oy;
    const float coz = sph[2 * S + s] - oz;
    const float nb = cox * dx + coy * dy + coz * dz;
    const float c = cox * cox + coy * coy + coz * coz - sph[3 * S + s];
    const float disc = nb * nb - c;
    if (disc > 0.0f) {
      const float sq = sqrtf(disc);
      const float t1 = nb - sq;
      const float t2 = nb + sq;
      const float t = t1 > t_min ? t1 : t2;
      if (t > t_min && t < bt) {
        bt = t;
        bi = s;
      }
    }
  }
  idx_out[i] = bi;
  hit_out[i] = bt < 0x1.c363ccp+127f ? 1 : 0;  // float32(3e38)
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the attribute call or the
// launch (0 on success). table is (4, S) row-major; outputs are per ray in
// input order; N > 0.
extern "C" int rays1_index_launch(const float* table, int S, const float* ox,
                                  const float* oy, const float* oz,
                                  const float* dx, const float* dy,
                                  const float* dz, int N, float t_min,
                                  int* idx, uint8_t* hit, void* stream) {
  const size_t smem = sizeof(float) * kRows * (size_t)S;
  cudaError_t err = cudaFuncSetAttribute(
      index_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + kThreads - 1) / kThreads;
  index_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      table, S, ox, oy, oz, dx, dy, dz, N, t_min, idx, hit);
  return (int)cudaGetLastError();
}
