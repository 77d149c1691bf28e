// Soft-visibility forward render kernel: the (H, W, 3) image of an
// untextured scene of any object count under soft_tau > 0 (spp 1,
// perspective, Phong): the annealed inversion's stage targets.
//
// Replaces the TPU kernel fwd_kernel
// (reversible_raytracer_tpu/ops/kernels/fused_vec_soft.py:494, pallas_call at
// :511), which walks the packed SMEM rows with fori_loops: a two-min rank
// loop, a chunk-skipped resolve of each layer's attributes and coverage, a
// soft shadow product loop per layer and light, and the two-layer
// composite. tau is a runtime argument, as the TPU kernel's SMEM scalar: one
// build serves every anneal stage.
//
// Design: one thread per pixel, 32 x 8 pixels per block, the globals and
// the packed rows staged once per block into shared memory (soft_common.cuh
// holds the per-pixel code). Per pixel: the two-min loop over the real
// sphere rows then the real rect rows (strict <), each live layer's
// attributes read directly from its winner row (a thread holds one pixel,
// so there is no chunk to skip), per layer and light the soft shadow
// product over all sphere rows and the hard rects in row order, then the
// composite over the background and the clip. The TPU kernel writes no
// visibility planes, and neither does this one.
//
// Bound: operations. Each pixel ranks every object (a square root and, for
// the spheres it does not hit, an exponential) and runs 2 x lights x N soft
// shadow tests (an exponential each), against 12 bytes of image written
// (chip_smoke.py counts both).
#include "soft_common.cuh"

using namespace rrt;

namespace {

__global__ void __launch_bounds__(BLOCK_THREADS)
    soft_render_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                       const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                       GLayout gl, Params p, float tau, float* __restrict__ img) {
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

  const PackedScene sc{g, s_sph, s_rct, gl, N, M, ns_pad};
  const Camera cam = camera(sc);
  const Ray r = primary_ray(cam, p, i, j);
  const Layers y = two_layers(sc, cam.eye, r.d, tau);
  const LayerColor c1 = layer_color(sc, p, cam.eye, r.d, y.l[0], tau);
  const LayerColor c2 = layer_color(sc, p, cam.eye, r.d, y.l[1], tau);
  V3 behind;
  V3 col = composite(c1, c2, sc.background(), &behind);
  if (p.clip) col = {clip01(col.x), clip01(col.y), clip01(col.z)};
  const long long px = (long long)i * p.W + j;
  img[3 * px + 0] = col.x;
  img[3 * px + 1] = col.y;
  img[3 * px + 2] = col.z;
}

}  // namespace

// Shared memory a block of this kernel needs, in bytes.
extern "C" long long rrt_soft_render_smem(int n_sph, int n_rect, int n_light) {
  return (long long)render_smem(pad16(n_sph), pad16(n_rect), n_light);
}

extern "C" int rrt_soft_render(const float* glob, const float* sph, const float* rct, int n_sph,
                               int n_rect, int ns_pad, int nr_pad, int n_light, int H, int W,
                               int shadows, int clip, float tau, float* img, void* stream) {
  const GLayout gl = make_glayout(n_light);
  const Params p = make_params(H, W, shadows, clip);
  const size_t smem = render_smem(ns_pad, nr_pad, n_light);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        soft_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  soft_render_kernel<<<pixel_grid(H, W), dim3(BLOCK_X, BLOCK_Y), smem, (cudaStream_t)stream>>>(
      glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, gl, p, tau, img);
  return (int)cudaGetLastError();
}
