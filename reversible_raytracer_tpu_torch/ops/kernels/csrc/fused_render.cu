// Forward render kernel: the (H, W, 3) image and the shadow-visibility
// planes of a hard-shaded, untextured scene of at most 24 objects (spp 1 or
// 4, perspective, Phong).
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
//
// spp 4 (the TPU kernel's 2x2 loop, render_tile's): each thread runs its
// pixel's four subsamples (render_common.cuh subsample) in turn, each its
// own ray, walks and planes (4 L planes, plane s L + l for subsample s and
// light l, the layout of pipeline.n_vis_planes), and writes the average of
// the clipped colours, ((c0 + c1) + c2) + c3 times 0.25 as render_tile sums
// them. Each spp is its own instance (SPP); the spp-1 one runs one ray at the
// pixel centre.
//
// Mirror bounces (REFL = 1 to MAX_REFL levels, spp 1 or 4; the TPU kernel
// traces shade's bounce recursion, pipeline.py:658-724): where level v hit,
// level v + 1 from its shadow origin along the reflected direction (the same
// walks, surface and Phong terms; reflected()), each level's colour blended
// unclipped into the one above by that level's winner's mirror coefficient,
// col + m (rcol - col), deepest first, and one clip at the end. A hit with
// mirror 0 traces its bounce too (the same bits: the blend adds 0). (1 +
// REFL) L planes a subsample, bounce-major: plane (1 + REFL) L q + v L + l
// is level v's light l of subsample q, 0 where that level or one above it
// missed (pipeline.n_vis_planes). Each REFL is its own instance, so the
// REFL = 0 and 1 ones keep their code.
//
// Texel grids (spp 1 or 4, REFL 0 to 3; render_kernel_tex, the TEX instances):
// the scene staged with its grids (TexFlatScene), a textured winner's base
// colour its grid's bilinear sample at a rect's (a, b) or at the lat-long
// coordinates of a sphere's normal, and a missed ray's colour, at either
// level, the environment map's at its direction (render_common.cuh surface,
// miss_color; atan2 and asin are vecmath.py's polynomials, op for op, so that
// with --fmad=false the image is the plain version's to the bit). The planes
// are as without grids.
#include "render_common.cuh"

using namespace rrt;

constexpr int FWD_MIN_BLOCKS = 4;  // blocks an SM at the least

// The levels below a hit (o, d, h) of a bounce: the colour of its reflected
// ray's level blended with the LEFT - 1 levels below that, unclipped;
// bits[v], the visibility bits of the v-th level down, where it is traced.
template <int LEFT, class SC>
__device__ __forceinline__ V3 reflected(const SC& sc, const Params& p, V3 o, V3 d, Nearest h,
                                        unsigned* bits) {
  const Surface s0 = surface(sc, o, d, h);
  const V3 o1 = shadow_origin(o, d, h.t, s0.n);
  const V3 d1 = reflect_dir(d, s0.n);
  const Nearest h1 = trace(sc, o1, d1);
  V3 col1 = miss_color(sc, d1);
  if (h1.k >= 0) {
    col1 = shade_hit(
        sc, o1, d1, h1.t, surface(sc, o1, d1, h1),
        [&](int, V3 so1, const LightGeo& g1) {
          return !p.shadows || !occluded(sc, so1, g1.ldir, g1.dist);
        },
        bits);
    if constexpr (LEFT > 1)
      col1 = blend(col1, reflected<LEFT - 1>(sc, p, o1, d1, h1, bits + 1), mirror(sc, h1));
  }
  return col1;
}

// The kernel's body on the scene type SC (FlatScene, or TexFlatScene for the
// textured instances) of layout LY.
template <int SPP, int REFL, class SC, class LY>
__device__ __forceinline__ void render_body(const float* __restrict__ flat, Params p, LY ly,
                                            float* __restrict__ img, float* __restrict__ vis) {
  extern __shared__ float sc_s[];
  __shared__ Camera cam;
  stage(sc_s, flat, ly.S);
  if (threadIdx.x == 0 && threadIdx.y == 0) cam = camera(FlatScene{flat, ly});
  __syncthreads();
  const SC sc = scene_view(sc_s, ly);

  const int j = blockIdx.x * BLOCK_X + threadIdx.x;
  const int i = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (i >= p.H || j >= p.W) return;

  const long long px = (long long)i * p.W + j;
  const long long plane = (long long)p.H * p.W;
  const int per_sub = (1 + REFL) * ly.L;  // a subsample's planes
  V3 acc = zero3();
#pragma unroll 1
  for (int q = 0; q < SPP; ++q) {
    const V3 d = primary_ray(cam, SPP == 1 ? p : subsample(p, q), i, j).d;
    const Nearest h = trace(sc, cam.eye, d);
    V3 col = sc.background();
    if constexpr (Textured<SC>::value) {
      if (h.k < 0) col = miss_color(sc, d);
    }
    unsigned bits = 0u;
    if (h.k >= 0)
      col = shade_hit(
          sc, cam.eye, d, h.t, surface(sc, cam.eye, d, h),
          [&](int, V3 so, const LightGeo& g) {
            return !p.shadows || !occluded(sc, so, g.ldir, g.dist);  // all lit without shadows
          },
          &bits);
    if constexpr (REFL != 0) {  // the bounces where level 0 hit, then the blend
      unsigned bits1[REFL] = {};
      if (h.k >= 0) col = blend(col, reflected<REFL>(sc, p, cam.eye, d, h, bits1), mirror(sc, h));
      if (p.shadows)
#pragma unroll
        for (int v = 0; v < REFL; ++v)
          for (int l = 0; l < ly.L; ++l)
            vis[(q * per_sub + (v + 1) * ly.L + l) * plane + px] =
                ((bits1[v] >> l) & 1u) ? 1.0f : 0.0f;
    }
    if (p.clip) col = {clip01(col.x), clip01(col.y), clip01(col.z)};
    acc = q == 0 ? col : acc + col;
    if (p.shadows)
      for (int l = 0; l < ly.L; ++l)
        vis[(q * per_sub + l) * plane + px] = ((bits >> l) & 1u) ? 1.0f : 0.0f;
  }
  if (SPP == 4) acc = acc * 0.25f;
  img[3 * px + 0] = acc.x;
  img[3 * px + 1] = acc.y;
  img[3 * px + 2] = acc.z;
}

template <int SPP, int REFL>
__global__ void __launch_bounds__(BLOCK_THREADS, FWD_MIN_BLOCKS)
    render_kernel(const float* __restrict__ flat, Params p, Layout ly, float* __restrict__ img,
                  float* __restrict__ vis) {
  render_body<SPP, REFL, FlatScene>(flat, p, ly, img, vis);
}

template <int SPP, int REFL>
__global__ void __launch_bounds__(BLOCK_THREADS, FWD_MIN_BLOCKS)
    render_kernel_tex(const float* __restrict__ flat, Params p, TexLayout ly,
                      float* __restrict__ img, float* __restrict__ vis) {
  render_body<SPP, REFL, TexFlatScene>(flat, p, ly, img, vis);
}

// The band entries (the wrappers'): H rows from image row row0 of an
// image_h-row image (render_common.cuh band_params); img (H, W, 3) and the
// planes (n_vis, H, W) are the band's. The textured instances: refl 0 to 3,
// spp 1 or 4 (spp (1 + refl) L planes), the texel grids' sides Ks, Kr, Ke (0
// for none) in make_tex_layout's flat layout.
extern "C" int rrt_render_tex_band(const float* flat, int n_sph, int n_rect, int n_light, int H,
                                   int W, int shadows, int clip, int row0, int image_h, int refl,
                                   int spp, int Ks, int Kr, int Ke, float* img, float* vis,
                                   void* stream) {
  const TexLayout ly = make_tex_layout(n_sph, n_rect, n_light, Ks, Kr, Ke);
  const Params p = band_params(H, W, shadows, clip, row0, image_h);
  if (refl < 0 || refl > MAX_REFL || (spp != 1 && spp != 4) || !band_ok(H, row0, image_h))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ly.S * sizeof(float);
  using K = void (*)(const float*, Params, TexLayout, float*, float*);
  static const K kernels[2][1 + MAX_REFL] = {
      {render_kernel_tex<1, 0>, render_kernel_tex<1, 1>, render_kernel_tex<1, 2>,
       render_kernel_tex<1, 3>},
      {render_kernel_tex<4, 0>, render_kernel_tex<4, 1>, render_kernel_tex<4, 2>,
       render_kernel_tex<4, 3>}};
  const K kernel = kernels[spp == 4][refl];
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<pixel_grid(H, W), dim3(BLOCK_X, BLOCK_Y), smem, (cudaStream_t)stream>>>(flat, p, ly,
                                                                                   img, vis);
  return (int)cudaGetLastError();
}

// spp 1 or 4 (spp (1 + refl) L planes), refl 0 to 3.
extern "C" int rrt_render_refl_band(const float* flat, int n_sph, int n_rect, int n_light,
                                    int H, int W, int shadows, int clip, int row0, int image_h,
                                    int spp, int refl, float* img, float* vis, void* stream) {
  const Layout ly = make_layout(n_sph, n_rect, n_light);
  const Params p = band_params(H, W, shadows, clip, row0, image_h);
  if ((spp != 1 && spp != 4) || refl < 0 || refl > MAX_REFL || !band_ok(H, row0, image_h))
    return (int)cudaErrorInvalidValue;
  using K = void (*)(const float*, Params, Layout, float*, float*);
  static const K kernels[2][1 + MAX_REFL] = {
      {render_kernel<1, 0>, render_kernel<1, 1>, render_kernel<1, 2>, render_kernel<1, 3>},
      {render_kernel<4, 0>, render_kernel<4, 1>, render_kernel<4, 2>, render_kernel<4, 3>}};
  const K kernel = kernels[spp == 4][refl];
  kernel<<<pixel_grid(H, W), dim3(BLOCK_X, BLOCK_Y), ly.S * sizeof(float),
           (cudaStream_t)stream>>>(flat, p, ly, img, vis);
  return (int)cudaGetLastError();
}

// The whole image (the entries of the tools and of earlier checkouts; the
// textured ones at spp 1).
extern "C" int rrt_render_tex(const float* flat, int n_sph, int n_rect, int n_light, int H,
                              int W, int shadows, int clip, int refl, int Ks, int Kr, int Ke,
                              float* img, float* vis, void* stream) {
  return rrt_render_tex_band(flat, n_sph, n_rect, n_light, H, W, shadows, clip, 0, H, refl, 1, Ks,
                             Kr, Ke, img, vis, stream);
}

extern "C" int rrt_render_refl(const float* flat, int n_sph, int n_rect, int n_light, int H,
                               int W, int shadows, int clip, int spp, int refl, float* img,
                               float* vis, void* stream) {
  return rrt_render_refl_band(flat, n_sph, n_rect, n_light, H, W, shadows, clip, 0, H, spp, refl,
                              img, vis, stream);
}

// spp 1 or 4 without a bounce.
extern "C" int rrt_render_spp(const float* flat, int n_sph, int n_rect, int n_light, int H,
                              int W, int shadows, int clip, int spp, float* img, float* vis,
                              void* stream) {
  return rrt_render_refl(flat, n_sph, n_rect, n_light, H, W, shadows, clip, spp, 0, img, vis,
                         stream);
}

// spp 1.
extern "C" int rrt_render(const float* flat, int n_sph, int n_rect, int n_light, int H, int W,
                          int shadows, int clip, float* img, float* vis, void* stream) {
  return rrt_render_spp(flat, n_sph, n_rect, n_light, H, W, shadows, clip, 1, img, vis, stream);
}
