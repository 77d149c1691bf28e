// Object-chunked forward render kernel: the (H, W, 3) image and one
// shadow-visibility plane per light of a hard-shaded, untextured scene of
// any object count (perspective, Phong), at one subsample offset: spp 1 is
// one launch at the pixel centre, spp 4 four launches at the offsets of
// render_common.cuh subsample(), averaged by the caller (the TPU kernel's
// four launches at the runtime offsets of off_ref, fused_vec.py:1443-1481).
//
// Replaces the TPU kernel _make_fused_vec.fwd_kernel
// (reversible_raytracer_tpu/ops/kernels/fused_vec.py:897, pallas_call at
// :953), which walks the scene's packed SMEM rows with fori_loops so that
// its compile time does not grow with the object count: a t-only nearest
// loop, a chunk-skipped resolve of the winner's attributes, an any-hit
// shadow loop per light, then shading.
//
// Design: as many blocks of 32 x 8 threads as the card holds at once
// (resident_blocks), each walking the image's 32 x 8 tiles in a fixed
// stride, one thread per pixel of a tile. The globals and the packed rows
// (the sphere rows without their mirror column) are staged into shared
// memory once per block, not once per tile (one block a tile took 0.002 ms
// longer at config 5: tools/vec_step_split.py). A warp is 32 pixels of a row,
// and the TPU kernel's chunk skip is redone per warp with the culls of rows
// 5-6 (cull.cuh):
//   - the primary rays: the spheres inside the cone of the warp's rays
//     widened by each sphere's angular radius (primary_candidates); each
//     lane's t-only nearest loop walks only those, in ascending index, then
//     every rect (strict <: ties go to the first object; rects numbered from
//     ns_pad in winner space), so the winner and its t are those of the walk
//     over every sphere, to the bit;
//   - per light, the shadow rays of the warp's hit lanes: the spheres near
//     the segment from a ball of their shadow origins to the light
//     (warp_candidates at tau = 0); each hit lane's any-hit loop walks only
//     those, then the rects, and stops at the first occluder: the visibility
//     bits of the full walk.
// Each warp keeps one cull's mask words in shared memory (ceil(N / 32)
// words), which its primary rays and then each light take in turn, so a
// block holds more spheres than the full walk's did (68 bytes a sphere
// then, 64 and one byte of masks now). Then only the winner's attributes,
// and the Phong terms of each light. Every lane runs every warp-wide vote,
// those past the ragged edge as dead lanes; only the lanes inside the image
// write.
//
// Bound: operations. Per warp the cone test of every sphere and, per light
// with a hit lane, the segment test; per pixel the sphere tests of the
// warp's candidates for its primary ray and for each light's shadow ray
// until an occluder, against 12 bytes of image and 4 bytes per visibility
// plane written (chip_smoke.py counts both).
//
// The visibility plane of a light is 1 where the shadow ray of a hit pixel
// reaches it and 0 where it is blocked, and 0 on a pixel that hits nothing
// (there is no surface, and the culls give such a lane no candidates); the
// render backward reads the planes only where the ray hit.
//
// The environment map and mirror bounces (one subsample a launch, four at
// spp 4 as for every instance; vec_render_levels_kernel,
// REFL and ENV, the TPU kernel's env global and reflection levels,
// fused_vec.py:405-440 and :907-946): with ENV the globals end with the
// (Ke, Ke, 3) map (PackedEnvRows) and a missed ray's colour is its bilinear
// sample at the lat-long coordinates of the ray's direction
// (render_common.cuh miss_color: vecmath.py's atan2 and asin, op for op);
// with REFL (1 to MAX_REFL levels) the sphere rows are staged with their
// mirror column and, where level v hit, level v + 1 is traced from its
// shadow origin along the reflected direction over every sphere (the 32
// reflected rays leave 32 points in scattered directions: the primary cone
// does not bound them), then every rect; its shadow rays take the warp's
// ball cull of their origins (warp_candidates) in the mask words that the
// level above's lights are done with; the levels' colours (the env's or the
// background at a miss) blend unclipped deepest first, col + m (rcol - col)
// with m the winner's mirror coefficient, and one clip ends the pixel. (1 +
// REFL) L planes, bounce-major: plane v L + l is level v's light l, 0 where
// that level or one above it missed. Every instance runs one body
// (vec_render_body), the bounces and the env behind if constexpr, so that
// vec_render_kernel, its <0, false> instance, keeps its code.
//
// Object texel grids (one subsample a launch, up to MAX_REFL bounces, with or without the env;
// vec_render_tex_kernel, the TPU kernel's texel tails, _row_plan:370,
// _sphere_eval:467-471, _rect_eval:503): a textured winner's base colour at
// either level is its grid's bilinear sample at the lat-long coordinates of
// a sphere's normal (the azimuth wrapped) or a rect's (a, b), gathered from
// global memory (render_common.cuh PackedTexRows: the grids stay out of the
// staged rows); the TPU kernel's dense hat-basis sampler exists because
// Mosaic cannot gather, and is not carried over.
#include "cull.cuh"

using namespace rrt;

namespace {

// The forward of every instance: REFL bounce levels (0 to MAX_REFL), and with ENV
// the environment map at the end of the globals; with TEX (and ENV, the map's
// side Ke 0 for none) object texel grids.
template <int REFL, bool ENV, bool TEX = false>
__device__ __forceinline__ void vec_render_body(const float* __restrict__ glob,
                                                const float* __restrict__ sph,
                                                const float* __restrict__ rct, int N, int M,
                                                int ns_pad, int nr_pad, GLayoutOf<ENV> gl,
                                                Params p, float* __restrict__ img,
                                                float* __restrict__ vis, TexGrids tg = {}) {
  static_assert(ENV || !TEX, "the textured instances read the env's globals layout");
  extern __shared__ float smem[];
  const auto fb =
      stage_forward<REFL ? P_SPH : FWD_SPH>(smem, glob, sph, rct, N, M, ns_pad, nr_pad, gl);
  const auto& sc = forward_scene<TEX>(fb.sc, tg);
  const int lane = threadIdx.x;
  const Camera cam = camera(sc);
  const V3 o = cam.eye;
  const dim3 tiles = pixel_grid(p.H, p.W);
  const long long plane = (long long)p.H * p.W;

  // the visibility bits of the shadow rays from so of the live lanes, each
  // light's over its culled candidates (every lane calls it)
  const auto shadow_bits = [&](V3 so, bool live) {
    unsigned bits = p.shadows ? 0u : ~0u;  // without shadows every light is lit
    if (p.shadows && __any_sync(FULL, live)) {
      for (int l = 0; l < gl.L; ++l) {
        __syncwarp();
        warp_candidates(sc, so, sc.l_pos(l), live, 0.0f, lane, fb.wm);
        if (live && !occluded_candidates(sc, so, light_geometry(sc.l_pos(l), so), fb.wm, fb.nw))
          bits |= 1u << l;
      }
    }
    return bits;
  };
  // a level's colour: shaded where its ray hit, else the background (with
  // ENV the map's sample)
  const auto shade = [&](V3 o_l, V3 d_l, const Nearest& h_l, const Surface& s_l,
                         unsigned bits) {
    V3 col = sc.background();
    if (h_l.k >= 0) {
      unsigned lit;
      col = shade_hit(
          sc, o_l, d_l, h_l.t, s_l,
          [&](int l, V3, const LightGeo&) { return ((bits >> l) & 1u) != 0; }, &lit);
    } else if constexpr (ENV) {
      col = miss_color(sc, d_l);
    }
    return col;
  };

  for (int t = blockIdx.x; t < (int)(tiles.x * tiles.y); t += gridDim.x) {
    const int j = (t % tiles.x) * BLOCK_X + threadIdx.x;
    const int i = (t / tiles.x) * BLOCK_Y + threadIdx.y;
    const bool inside = i < p.H && j < p.W;
    if (!__any_sync(FULL, inside)) continue;  // a warp wholly past the ragged edge
    const V3 d = primary_ray(cam, p, inside ? i : 0, inside ? j : 0).d;
    __syncwarp();  // the previous tile's walks are done with the mask words
    primary_candidates(sc, o, d, inside, 0.0f, lane, fb.wm);
    const Nearest h = inside ? trace_candidates(sc, o, d, fb.wm, fb.nw) : Nearest{BIG, -1};
    const bool hit = h.k >= 0;
    const Surface s = surface(sc, o, d, h);
    const V3 so = shadow_origin(o, d, h.t, s.n);
    const unsigned bits = shadow_bits(so, hit);
    V3 col = shade(o, d, h, s, bits);
    [[maybe_unused]] unsigned bits1[REFL > 0 ? REFL : 1] = {};
    [[maybe_unused]] bool hit1[REFL > 0 ? REFL : 1] = {};
    if constexpr (REFL != 0) {  // level v + 1 where level v hit, then the blends
      V3 cols[REFL + 1] = {col};  // level v's colour, set where level v - 1 hit
      float ms[REFL] = {};        // level v's mirror weight, set where it hit
      V3 so_v = so, d_v = d;
      Nearest h_v = h;
      Surface s_v = s;
#pragma unroll
      for (int v = 0; v < REFL; ++v) {
        const bool live = v == 0 ? hit : hit1[v - 1];
        const V3 d1 = reflect_dir(d_v, s_v.n);
        const Nearest h1 = live ? trace(sc, so_v, d1) : Nearest{BIG, -1};
        hit1[v] = h1.k >= 0;
        const Surface s1 = surface(sc, so_v, d1, h1);
        const V3 so1 = shadow_origin(so_v, d1, h1.t, s1.n);
        bits1[v] = shadow_bits(so1, hit1[v]);
        if (live) {
          cols[v + 1] = shade(so_v, d1, h1, s1, bits1[v]);
          ms[v] = mirror(sc, h_v);
        }
        so_v = so1;
        d_v = d1;
        h_v = h1;
        s_v = s1;
      }
      // deepest first, each level into the one above it where that one hit
#pragma unroll
      for (int v = REFL - 1; v >= 0; --v)
        if (v == 0 ? hit : hit1[v - 1]) cols[v] = blend(cols[v], cols[v + 1], ms[v]);
      col = cols[0];
    }
    if (p.clip) col = {clip01(col.x), clip01(col.y), clip01(col.z)};
    if (!inside) continue;
    const long long px = (long long)i * p.W + j;
    img[3 * px + 0] = col.x;
    img[3 * px + 1] = col.y;
    img[3 * px + 2] = col.z;
    if (p.shadows)
      for (int l = 0; l < gl.L; ++l)
        vis[l * plane + px] = (hit && ((bits >> l) & 1u)) ? 1.0f : 0.0f;
    if constexpr (REFL != 0) {
      if (p.shadows)
#pragma unroll
        for (int v = 0; v < REFL; ++v)
          for (int l = 0; l < gl.L; ++l)
            vis[((v + 1) * gl.L + l) * plane + px] =
                (hit1[v] && ((bits1[v] >> l) & 1u)) ? 1.0f : 0.0f;
    }
  }
}

__global__ void __launch_bounds__(BLOCK_THREADS)
    vec_render_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                      const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                      GLayout gl, Params p, float* __restrict__ img, float* __restrict__ vis) {
  vec_render_body<0, false>(glob, sph, rct, N, M, ns_pad, nr_pad, gl, p, img, vis);
}

// The instances with the environment map (ENV) and/or REFL bounce levels,
// one subsample a launch.
template <int REFL, bool ENV>
__global__ void __launch_bounds__(BLOCK_THREADS)
    vec_render_levels_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                             const float* __restrict__ rct, int N, int M, int ns_pad,
                             int nr_pad, GLayoutOf<ENV> gl, Params p, float* __restrict__ img,
                             float* __restrict__ vis) {
  vec_render_body<REFL, ENV>(glob, sph, rct, N, M, ns_pad, nr_pad, gl, p, img, vis);
}

// One launch of a forward kernel: as many blocks as the card holds at once
// with smem bytes each; extra, the kernel's arguments after the planes.
template <class K, class GL, class... Extra>
int launch_forward(K kernel, size_t smem, const float* glob, const float* sph, const float* rct,
                   int n_sph, int n_rect, int ns_pad, int nr_pad, GL gl, const Params& p,
                   float* img, float* vis, void* stream, Extra... extra) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nblocks = resident_blocks(kernel, smem, p.H, p.W);
  if (nblocks <= 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<nblocks, dim3(BLOCK_X, BLOCK_Y), smem, (cudaStream_t)stream>>>(
      glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, gl, p, img, vis, extra...);
  return (int)cudaGetLastError();
}

// The instances with object texel grids (one subsample a launch, REFL bounce levels, the
// environment map's side Ke 0 for none).
template <int REFL>
__global__ void __launch_bounds__(BLOCK_THREADS)
    vec_render_tex_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                          const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                          EnvGLayout gl, Params p, float* __restrict__ img,
                          float* __restrict__ vis, TexGrids tg) {
  vec_render_body<REFL, true, true>(glob, sph, rct, N, M, ns_pad, nr_pad, gl, p, img, vis, tg);
}

template <int REFL, bool ENV>
int launch_levels(const float* glob, const float* sph, const float* rct, int n_sph, int n_rect,
                  int ns_pad, int nr_pad, int n_light, int ke, const Params& p, float* img,
                  float* vis, void* stream) {
  return launch_forward(vec_render_levels_kernel<REFL, ENV>,
                        forward_smem(ns_pad, nr_pad, n_light, REFL, ke), glob, sph, rct, n_sph,
                        n_rect, ns_pad, nr_pad, globals_layout<ENV>(n_light, ke), p, img, vis,
                        stream);
}

}  // namespace

// Shared memory a block of the instance with refl bounce levels and an
// environment map of side ke (0 for none) needs, in bytes.
extern "C" long long rrt_vec_render_levels_smem(int n_sph, int n_rect, int n_light, int refl,
                                                int ke) {
  return (long long)forward_smem(pad16(n_sph), pad16(n_rect), n_light, refl, ke);
}

// The most shared memory a block may have on the current device (opt-in).
extern "C" long long rrt_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

// The band entries (the wrappers'): H rows from image row row0 of an
// image_h-row image (render_common.cuh band_params); img (H, W, 3) and the
// planes are the band's. The instance of refl bounce levels (0 to 3) and an
// environment map of side ke (0 for none) at the subsample offset (oi, oj)
// from the pixel centre, in rows and columns: at 0 and 0 L planes (the
// instance of rrt_vec_render_at), else L (1 + refl) planes.
extern "C" int rrt_vec_render_levels_band(const float* glob, const float* sph, const float* rct,
                                          int n_sph, int n_rect, int ns_pad, int nr_pad,
                                          int n_light, int H, int W, int shadows, int clip,
                                          int row0, int image_h, float oi, float oj, int refl,
                                          int ke, float* img, float* vis, void* stream) {
  if (refl < 0 || refl > MAX_REFL || ke < 0 || !band_ok(H, row0, image_h))
    return (int)cudaErrorInvalidValue;
  const Params p = band_params(H, W, shadows, clip, row0, image_h, oi, oj);
  if (!refl && !ke)
    return launch_forward(vec_render_kernel, forward_smem(ns_pad, nr_pad, n_light), glob, sph,
                          rct, n_sph, n_rect, ns_pad, nr_pad, make_glayout(n_light), p, img, vis,
                          stream);
  using Launch = int (*)(const float*, const float*, const float*, int, int, int, int, int, int,
                         const Params&, float*, float*, void*);
  static const Launch launches[2][1 + MAX_REFL] = {
      {nullptr, &launch_levels<1, false>, &launch_levels<2, false>, &launch_levels<3, false>},
      {&launch_levels<0, true>, &launch_levels<1, true>, &launch_levels<2, true>,
       &launch_levels<3, true>}};
  const Launch launch = launches[ke != 0][refl];
  return launch(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light, ke, p, img, vis,
                stream);
}

// The instance with object texel grids of sides ks (the spheres', from stex)
// and kr (the rects', from rtex), 0 for none, beside refl (0 to 3) bounce levels and
// an environment map of side ke, at the subsample offset (oi, oj): L (1 +
// refl) planes. Its shared memory is rrt_vec_render_levels_smem's (the grids
// are read from global memory).
extern "C" int rrt_vec_render_tex_band(const float* glob, const float* sph, const float* rct,
                                       const float* stex, const float* rtex, int n_sph,
                                       int n_rect, int ns_pad, int nr_pad, int n_light, int H,
                                       int W, int shadows, int clip, int row0, int image_h,
                                       float oi, float oj, int refl, int ke, int ks, int kr,
                                       float* img, float* vis, void* stream) {
  if (refl < 0 || refl > MAX_REFL || ke < 0 || ks < 0 || kr < 0 || !band_ok(H, row0, image_h))
    return (int)cudaErrorInvalidValue;
  const Params p = band_params(H, W, shadows, clip, row0, image_h, oi, oj);
  using K = void (*)(const float*, const float*, const float*, int, int, int, int, EnvGLayout,
                     Params, float*, float*, TexGrids);
  static const K kernels[1 + MAX_REFL] = {vec_render_tex_kernel<0>, vec_render_tex_kernel<1>,
                                          vec_render_tex_kernel<2>, vec_render_tex_kernel<3>};
  return launch_forward(kernels[refl],
                        forward_smem(ns_pad, nr_pad, n_light, refl, ke), glob, sph, rct, n_sph,
                        n_rect, ns_pad, nr_pad, make_env_glayout(n_light, ke), p, img, vis,
                        stream, TexGrids{stex, rtex, ks, kr});
}

// The whole image (the entries of the tools and of earlier checkouts).
extern "C" int rrt_vec_render_levels(const float* glob, const float* sph, const float* rct,
                                     int n_sph, int n_rect, int ns_pad, int nr_pad, int n_light,
                                     int H, int W, int shadows, int clip, float oi, float oj,
                                     int refl, int ke, float* img, float* vis, void* stream) {
  return rrt_vec_render_levels_band(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light, H, W,
                                    shadows, clip, 0, H, oi, oj, refl, ke, img, vis, stream);
}

extern "C" int rrt_vec_render_tex(const float* glob, const float* sph, const float* rct,
                                  const float* stex, const float* rtex, int n_sph, int n_rect,
                                  int ns_pad, int nr_pad, int n_light, int H, int W, int shadows,
                                  int clip, float oi, float oj, int refl, int ke, int ks, int kr,
                                  float* img, float* vis, void* stream) {
  return rrt_vec_render_tex_band(glob, sph, rct, stex, rtex, n_sph, n_rect, ns_pad, nr_pad,
                                 n_light, H, W, shadows, clip, 0, H, oi, oj, refl, ke, ks, kr,
                                 img, vis, stream);
}

// At the subsample offset (oi, oj), without a bounce or an environment map.
extern "C" int rrt_vec_render_at(const float* glob, const float* sph, const float* rct,
                                 int n_sph, int n_rect, int ns_pad, int nr_pad, int n_light,
                                 int H, int W, int shadows, int clip, float oi, float oj,
                                 float* img, float* vis, void* stream) {
  return rrt_vec_render_levels(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light, H, W,
                               shadows, clip, oi, oj, 0, 0, img, vis, stream);
}

// At the pixel centre.
extern "C" int rrt_vec_render(const float* glob, const float* sph, const float* rct, int n_sph,
                              int n_rect, int ns_pad, int nr_pad, int n_light, int H, int W,
                              int shadows, int clip, float* img, float* vis, void* stream) {
  return rrt_vec_render_at(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light, H, W, shadows,
                           clip, 0.0f, 0.0f, img, vis, stream);
}
