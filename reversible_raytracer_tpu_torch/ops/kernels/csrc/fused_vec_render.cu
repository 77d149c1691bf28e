// Object-chunked forward render kernel: the (H, W, 3) image and one
// shadow-visibility plane per light of a hard-shaded, untextured scene of
// any object count (spp 1, perspective, Phong).
//
// Replaces the TPU kernel _make_fused_vec.fwd_kernel
// (reversible_raytracer_tpu/ops/kernels/fused_vec.py:897, pallas_call at
// :953), which walks the scene's packed SMEM rows with fori_loops so that
// its compile time does not grow with the object count: a t-only nearest
// loop, a chunk-skipped resolve of the winner's attributes, an any-hit
// shadow loop per light, then shading.
//
// Design: one thread per pixel, 32 x 8 pixels per block. The globals and
// the packed object rows (about 6 KB for 64 spheres and a rect, 36 KB for
// 512 spheres and a rect) are staged once per block into shared memory,
// where every thread of the block reads the same row at the same time (a
// broadcast). Per pixel: the t-only nearest loop over the real sphere rows
// then the real rect rows (strict <: ties go to the first object; rects
// numbered from ns_pad in winner space), then only the winner's attributes,
// then per light an any-hit loop that stops at the first occluder. A GPU
// thread has no tile of pixels that could share a skipped chunk, so there
// is no chunk-skip: the winner is one index per thread.
//
// Bound: operations. Each pixel tests every object for its primary ray and
// for each light's shadow ray until an occluder, against 12 bytes of image
// and 4 bytes per visibility plane written (chip_smoke.py counts both).
//
// The visibility plane of a light is 1 where the shadow ray reaches it. On
// a pixel that hits nothing it holds the shadow test of a ray cast from the
// BIG sentinel, which carries no meaning and which the render backward
// reads only where the ray hit.
#include "render_common.cuh"

using namespace rrt;

namespace {

__global__ void __launch_bounds__(BLOCK_THREADS)
    vec_render_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                      const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                      GLayout gl, Params p, float* __restrict__ img, float* __restrict__ vis) {
  extern __shared__ float smem[];
  float* g = smem;
  float* s_sph = g + gl.Sg;
  float* s_rct = s_sph + ns_pad * P_SPH;
  stage(g, glob, gl.Sg);
  stage(s_sph, sph, ns_pad * P_SPH);
  stage(s_rct, rct, nr_pad * P_RCT);
  __syncthreads();

  const int j = blockIdx.x * BLOCK_X + threadIdx.x;
  const int i = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (i >= p.H || j >= p.W) return;

  unsigned bits;
  const V3 col = render_pixel(PackedScene{g, s_sph, s_rct, gl, N, M, ns_pad}, p, i, j, &bits);
  const long long px = (long long)i * p.W + j;
  img[3 * px + 0] = col.x;
  img[3 * px + 1] = col.y;
  img[3 * px + 2] = col.z;
  if (p.shadows) {
    const long long plane = (long long)p.H * p.W;
    for (int l = 0; l < gl.L; ++l) vis[l * plane + px] = ((bits >> l) & 1u) ? 1.0f : 0.0f;
  }
}

}  // namespace

// Shared memory a block of this kernel needs, in bytes.
extern "C" long long rrt_vec_render_smem(int n_sph, int n_rect, int n_light) {
  return (long long)render_smem(pad16(n_sph), pad16(n_rect), n_light);
}

// The most shared memory a block may have on the current device (opt-in).
extern "C" long long rrt_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

extern "C" int rrt_vec_render(const float* glob, const float* sph, const float* rct, int n_sph,
                              int n_rect, int ns_pad, int nr_pad, int n_light, int H, int W,
                              int shadows, int clip, float* img, float* vis, void* stream) {
  const GLayout gl = make_glayout(n_light);
  const Params p = make_params(H, W, shadows, clip);
  const size_t smem = render_smem(ns_pad, nr_pad, n_light);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vec_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  vec_render_kernel<<<pixel_grid(H, W), dim3(BLOCK_X, BLOCK_Y), smem, (cudaStream_t)stream>>>(
      glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, gl, p, img, vis);
  return (int)cudaGetLastError();
}
