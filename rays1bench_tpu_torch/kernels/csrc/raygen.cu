// Primary-ray generation for Hopper (sm_90a): the rays that the one-shot,
// topology and wavefront engines take as inputs, made from their ids.
//
// Replaces no Pallas kernel: the JAX package's raygen is jnp
// (rays1bench_tpu/render/pipeline.primary_rays, fused by XLA into the code
// around its kernels), so this kernel has no `pallas_call` counterpart. It
// was added because the same math in eager PyTorch is about a hundred
// elementwise ops, the uint32 hash emulated in int64, each streaming every
// ray through device memory. Plain version and wrapper:
// rays1bench_tpu_torch/render/pipeline.py (`primary_rays_from_ids`) and
// rays1bench_tpu_torch/kernels/megakernel.py (`generate_rays`).
//
// For each i < N, with id = ray_id[i] (any order; ids past the frame are
// padding and get what the plain version gives them), r1b::id_ray
// (path_math.cuh): pid = id / spp, x = pid % width and y = pid / width as
// float, then r1b::pixel_ray, the respawn kernel's raygen: the film jitter
// from uniform_pair16 at (kBounceRaygen, kSlotPixelJitter), s = (x + ju) *
// inv_w, t = (y + jv) * inv_h with inv_w = float32(1 / width), and the
// thin-lens ray of generate_ray. The float operations are the plain
// version's in its order, so under --fmad=false the six planes equal it bit
// for bit.
//
// Design. A thread per ray in a grid-stride loop over as many blocks as the
// card holds at once; the 19-float camera is staged once per block in
// shared memory. Each thread reads its id (4 B) and writes one float to
// each of the six planes (24 B), neighbouring threads on neighbouring
// addresses. What bounds it: those 28 B a ray against 3.35 TB/s (0.25 ms
// for the fit's 29.5 M rays, 0.08 ms for the CLI frame's 9.2 M); its ~120
// operations a ray (two PCG hashes, a short polynomial, two IEEE square
// roots and a division) come to about 0.1 ms at the fit's size.
#include <cuda_runtime.h>
#include <stdint.h>

#include "path_math.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
raygen_kernel(const int* __restrict__ ray_id, int N,
              const float* __restrict__ cam_in, int width, int spp,
              uint32_t seed, float inv_w, float inv_h,
              float* __restrict__ ox_out, float* __restrict__ oy_out,
              float* __restrict__ oz_out, float* __restrict__ dx_out,
              float* __restrict__ dy_out, float* __restrict__ dz_out) {
  __shared__ float cam[19];
  if (threadIdx.x < 19) cam[threadIdx.x] = cam_in[threadIdx.x];
  __syncthreads();

  const unsigned stride = gridDim.x * kThreads;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < (unsigned)N;
       i += stride) {
    float ox, oy, oz, dx, dy, dz;
    r1b::id_ray(cam, ray_id[i], width, spp, seed, inv_w, inv_h, ox, oy, oz,
                dx, dy, dz);
    ox_out[i] = ox;
    oy_out[i] = oy;
    oz_out[i] = oz;
    dx_out[i] = dx;
    dy_out[i] = dy;
    dz_out[i] = dz;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the attribute or occupancy
// query or of the launch (0 on success). ray_id: N > 0 non-negative ids;
// cam: the 19 floats of megakernel.pack_camera; inv_w, inv_h: float32(1 /
// width), float32(1 / height). Outputs: six float32[N] planes in input
// order.
extern "C" int rays1_raygen_launch(const int* ray_id, int N, const float* cam,
                                   int width, int spp, uint32_t seed,
                                   float inv_w, float inv_h, float* ox,
                                   float* oy, float* oz, float* dx, float* dy,
                                   float* dz, void* stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                        raygen_kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kThreads - 1) / kThreads;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  raygen_kernel<<<blocks < resident ? blocks : resident, kThreads, 0,
                  (cudaStream_t)stream>>>(ray_id, N, cam, width, spp, seed,
                                          inv_w, inv_h, ox, oy, oz, dx, dy,
                                          dz);
  return (int)cudaGetLastError();
}
