// Forward render kernel: the (H, W, 3) image and the shadow-visibility
// planes of a hard-shaded, untextured scene of at most 24 objects (spp 1,
// perspective, Phong).
//
// Replaces the TPU kernel _make_fused.fwd_kernel
// (reversible_raytracer_tpu/ops/kernels/fused.py:224, pallas_call at :237).
//
// Design: one thread per pixel, 32 x 8 pixels per block, one block a tile.
// The block stages the flat scene (a few hundred floats) into shared memory
// while one thread computes the camera basis and tan(fov/2) into it, with
// the operations every pixel would otherwise repeat, so with their bits.
// Each pixel walks every object for its primary ray (trace), and only where
// the ray hit: the winner's attributes (surface), per light the any-hit walk
// of its shadow ray (occluded, stops at the first occluder) and the Phong
// terms (shade_hit). The launch bound of 4 blocks an SM lets ptxas keep 50
// registers, where it keeps 48 without one or at 5 blocks: 3-7% faster at
// configs 2 and 3 (tools/flat_step_split.py). Rays are generated in the
// kernel, so the only device-memory traffic is the output: 12 bytes of image
// and 4 bytes per visibility plane per pixel. Threads past the ragged edge
// write nothing; there is no padded canvas.
//
// The visibility plane of a light is 1 where the shadow ray of a hit pixel
// reaches it and 0 where it is blocked, and 0 on a pixel that hits nothing
// (there is no surface to shade; the render backward reads the planes only
// where the ray hit).
#include "render_common.cuh"

using namespace rrt;

constexpr int FWD_MIN_BLOCKS = 4;  // blocks an SM at the least

__global__ void __launch_bounds__(BLOCK_THREADS, FWD_MIN_BLOCKS)
    render_kernel(const float* __restrict__ flat, Params p, Layout ly, float* __restrict__ img,
                  float* __restrict__ vis) {
  extern __shared__ float sc_s[];
  __shared__ Camera cam;
  stage(sc_s, flat, ly.S);
  if (threadIdx.x == 0 && threadIdx.y == 0) cam = camera(FlatScene{flat, ly});
  __syncthreads();
  const FlatScene sc{sc_s, ly};

  const int j = blockIdx.x * BLOCK_X + threadIdx.x;
  const int i = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (i >= p.H || j >= p.W) return;

  const V3 d = primary_ray(cam, p, i, j).d;
  const Nearest h = trace(sc, cam.eye, d);
  V3 col = sc.background();
  unsigned bits = 0u;
  if (h.k >= 0)
    col = shade_hit(
        sc, cam.eye, d, h.t, surface(sc, cam.eye, d, h),
        [&](int, V3 so, const LightGeo& g) {
          return !p.shadows || !occluded(sc, so, g.ldir, g.dist);  // all lit without shadows
        },
        &bits);
  if (p.clip) col = {clip01(col.x), clip01(col.y), clip01(col.z)};
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
