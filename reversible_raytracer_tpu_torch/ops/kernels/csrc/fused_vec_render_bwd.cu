// Object-chunked render backward kernel: the gradient of the globals and
// of every packed sphere and rect row for a cotangent (gr, gg, gb) of the
// rendered image, for a scene of any object count, in one call (three
// launches on one stream).
//
// Replaces the TPU kernel make_bwd_kernel(False)
// (reversible_raytracer_tpu/ops/kernels/fused_vec.py:979, bwd_call at
// :1283), the custom_vjp partner of the vec forward (fused_vec.py:1340-1364):
// the same body as the TPU step kernel, reading the cotangent planes where
// the step forms its residual and the forward's visibility planes where
// the step casts shadow rays.
//
// Design: the object-chunked step's kernels (vec_step.cuh) with
// CotangentSource: each thread replays its pixel's trace (over its warp's
// primary candidates, cull.cuh) and shading, reading light l's visibility
// from vis[l, i, j] where its ray hit, takes the caller's cotangent of the
// clipped image through the clip's gradient (zero past the ragged edge),
// and runs the step's adjoint; the per-warp winner lists, the block row of
// every object field, one partial row per block and vec_finalize_kernel
// carry over unchanged. No atomics: bit-for-bit the same from call to call;
// pad rows' gradients are exactly zero. Shared memory as the step's (13 KB
// per block at config 5, 73 KB at 513 objects).
//
// Bound: operations: the step's per-pixel work without the shadow rays
// (their votes and any-hit walks); bytes: the cotangent (12 bytes per
// pixel) and 4 bytes per visibility plane (chip_smoke.py counts both).
//
// The environment map and one to three bounce levels: the step's spp-1
// vec_step_levels_kernel with CotangentSource, level v's light l read from
// plane v L + l of the forward's (1 + refl) L. Object texel grids: the step's spp-1
// vec_step_tex_kernel with CotangentSource. At spp 4 either is launched
// once a subsample, at its offsets, with that subsample's planes.
#include "vec_step.cuh"

using namespace rrt;

extern "C" long long rrt_vec_render_bwd_scratch_floats(int ns_pad, int nr_pad, int n_light,
                                                       int H, int W) {
  return vec_step_scratch_floats(ns_pad, nr_pad, n_light, H, W);
}

// With an environment map of side ke (0 for none; a bounce adds no shared
// memory), at spp 1 (the pixel centre: oi = oj = 0).
extern "C" long long rrt_vec_render_bwd_levels_smem(int n_sph, int n_rect, int n_light, int ke) {
  return (long long)step_plan(pad16(n_sph), pad16(n_rect), n_light, ke).smem;
}

extern "C" long long rrt_vec_render_bwd_levels_scratch_floats(int ns_pad, int nr_pad,
                                                              int n_light, int H, int W, int ke) {
  return vec_step_scratch_floats(ns_pad, nr_pad, n_light, H, W, ke);
}

// The textured instances (one subsample a launch): object texel grids of sides ks and kr (0
// for none) read from stex and rtex; out = [0, dglob, dsph, drct, dstex,
// drtex], at the pixel centre (oi = oj = 0) or a subsample's offset.
extern "C" long long rrt_vec_render_bwd_tex_smem(int n_sph, int n_rect, int n_light, int ke,
                                                 int ks, int kr) {
  return (long long)tex_step_plan(n_sph, n_rect, n_light, ke, ks, kr).smem;
}

extern "C" long long rrt_vec_render_bwd_tex_scratch_floats(int n_sph, int n_rect, int n_light,
                                                           int H, int W, int ke, int ks, int kr) {
  return vec_step_tex_scratch_floats(n_sph, n_rect, n_light, H, W, ke, ks, kr);
}

// The band entries (the wrappers'): H rows from image row row0 of an
// image_h-row image (render_common.cuh band_params); g_img the band's (H, W,
// 3) cotangent and vis the band forward's planes.
extern "C" int rrt_vec_render_bwd_levels_band(const float* glob, const float* sph,
                                              const float* rct, int n_sph, int n_rect, int ns_pad,
                                              int nr_pad, int n_light, int H, int W, int shadows,
                                              int clip, int row0, int image_h, float oi, float oj,
                                              int refl, int ke, const float* g_img,
                                              const float* vis, float* scratch, float* out,
                                              void* stream) {
  if (!band_ok(H, row0, image_h)) return (int)cudaErrorInvalidValue;
  return launch_vec_step(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light,
                         band_params(H, W, shadows, clip, row0, image_h, oi, oj), 1,
                         CotangentSource{g_img, vis, 1.0f}, scratch, out, stream, refl, ke);
}

extern "C" int rrt_vec_render_bwd_tex_band(const float* glob, const float* sph, const float* rct,
                                           const float* stex, const float* rtex, int n_sph,
                                           int n_rect, int ns_pad, int nr_pad, int n_light, int H,
                                           int W, int shadows, int clip, int row0, int image_h,
                                           float oi, float oj, int refl, int ke, int ks, int kr,
                                           const float* g_img, const float* vis, float* scratch,
                                           float* out, void* stream) {
  if (ns_pad != pad16(n_sph) || nr_pad != pad16(n_rect) || !band_ok(H, row0, image_h))
    return (int)cudaErrorInvalidValue;
  return launch_vec_step_tex(glob, sph, rct, n_sph, n_rect, n_light, ke,
                             TexGrids{stex, rtex, ks, kr},
                             band_params(H, W, shadows, clip, row0, image_h, oi, oj), refl,
                             CotangentSource{g_img, vis, 1.0f}, scratch, out, stream);
}

// The whole image (the entries of the tools and of earlier checkouts).
extern "C" int rrt_vec_render_bwd_levels(const float* glob, const float* sph, const float* rct,
                                         int n_sph, int n_rect, int ns_pad, int nr_pad,
                                         int n_light, int H, int W, int shadows, int clip,
                                         float oi, float oj, int refl, int ke, const float* g_img,
                                         const float* vis, float* scratch, float* out,
                                         void* stream) {
  return rrt_vec_render_bwd_levels_band(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light,
                                        H, W, shadows, clip, 0, H, oi, oj, refl, ke, g_img, vis,
                                        scratch, out, stream);
}

extern "C" int rrt_vec_render_bwd_tex(const float* glob, const float* sph, const float* rct,
                                      const float* stex, const float* rtex, int n_sph, int n_rect,
                                      int ns_pad, int nr_pad, int n_light, int H, int W,
                                      int shadows, int clip, float oi, float oj, int refl, int ke,
                                      int ks, int kr, const float* g_img, const float* vis,
                                      float* scratch, float* out, void* stream) {
  return rrt_vec_render_bwd_tex_band(glob, sph, rct, stex, rtex, n_sph, n_rect, ns_pad, nr_pad,
                                     n_light, H, W, shadows, clip, 0, H, oi, oj, refl, ke, ks, kr,
                                     g_img, vis, scratch, out, stream);
}

// out = [0, dglob (Sg), dsph (ns_pad x P_SPH), drct (nr_pad x P_RCT)], at
// the subsample offset (oi, oj) (0 at spp 1; at spp 4 one launch a
// subsample, each with its cotangent and the planes of its forward launch).
extern "C" int rrt_vec_render_bwd_at(const float* glob, const float* sph, const float* rct,
                                     int n_sph, int n_rect, int ns_pad, int nr_pad,
                                     int n_light, int H, int W, int shadows, int clip, float oi,
                                     float oj, const float* g_img, const float* vis,
                                     float* scratch, float* out, void* stream) {
  return launch_vec_step(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light,
                         make_params(H, W, shadows, clip, oi, oj), 1,
                         CotangentSource{g_img, vis, 1.0f}, scratch, out, stream);
}

// At the pixel centre.
extern "C" int rrt_vec_render_bwd(const float* glob, const float* sph, const float* rct,
                                  int n_sph, int n_rect, int ns_pad, int nr_pad, int n_light,
                                  int H, int W, int shadows, int clip, const float* g_img,
                                  const float* vis, float* scratch, float* out, void* stream) {
  return rrt_vec_render_bwd_at(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light, H, W,
                               shadows, clip, 0.0f, 0.0f, g_img, vis, scratch, out, stream);
}
