// Forward render kernel: the (H, W, 3) image and the shadow-visibility
// planes of a hard-shaded, untextured scene (spp 1, perspective, Phong).
//
// Replaces the TPU kernel _make_fused.fwd_kernel
// (reversible_raytracer_tpu/ops/kernels/fused.py:224, pallas_call at :237).
//
// Design: one thread per pixel, 32 x 8 pixels per block. The flat scene
// (a few hundred floats) is staged once per block into shared memory; rays
// are generated in the kernel, so the only device-memory traffic is the
// output: 12 bytes of image and 4 bytes per visibility plane per pixel.
// The bound on this card is operations, not bytes: each pixel runs the
// intersection loop over every object for the primary ray and again for
// each light's shadow ray (see chip_smoke.py for the count). Threads past
// the ragged edge write nothing; there is no padded canvas.
//
// The visibility plane of a light is 1 where the shadow ray reaches it.
// Like render_tile, it is also written for pixels that miss every object,
// where its value is that of a shadow ray cast from the BIG sentinel and
// carries no meaning; the render backward reads it only where the ray hit.
#include "render_common.cuh"

using namespace rrt;

__global__ void __launch_bounds__(BLOCK_THREADS)
    render_kernel(const float* __restrict__ flat, Params p, Layout ly, float* __restrict__ img,
                  float* __restrict__ vis) {
  extern __shared__ float sc[];
  stage(sc, flat, ly.S);
  __syncthreads();

  const int j = blockIdx.x * BLOCK_X + threadIdx.x;
  const int i = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (i >= p.H || j >= p.W) return;

  unsigned bits;
  const V3 col = render_pixel(FlatScene{sc, ly}, p, i, j, &bits);
  const long long px = (long long)i * p.W + j;
  img[3 * px + 0] = col.x;
  img[3 * px + 1] = col.y;
  img[3 * px + 2] = col.z;
  if (p.shadows) {
    const long long plane = (long long)p.H * p.W;
    for (int l = 0; l < ly.L; ++l) vis[l * plane + px] = ((bits >> l) & 1u) ? 1.0f : 0.0f;
  }
}

extern "C" int rrt_render(const float* flat, int n_sph, int n_rect, int n_light, int H, int W,
                          int shadows, int clip, float* img, float* vis, void* stream) {
  const Layout ly = make_layout(n_sph, n_rect, n_light);
  const Params p = make_params(H, W, shadows, clip);
  render_kernel<<<pixel_grid(H, W), dim3(BLOCK_X, BLOCK_Y), ly.S * sizeof(float),
                  (cudaStream_t)stream>>>(flat, p, ly, img, vis);
  return (int)cudaGetLastError();
}
