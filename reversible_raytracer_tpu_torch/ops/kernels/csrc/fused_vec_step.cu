// Object-chunked fused training-step kernel: the squared-error loss of the
// render against a target, and its gradient with respect to the globals
// and every packed sphere and rect row, for a scene of any object count,
// in one call (three launches on one stream).
//
// Replaces the TPU kernel make_bwd_kernel(True)
// (reversible_raytracer_tpu/ops/kernels/fused_vec.py:979, step_call at
// :1310), which replays the trace per tile, takes jax.vjp of the shading,
// runs masked per-object vjps over chunks of 16 rows (skipping the chunks
// no pixel of the tile can reach), and adds each tile's gradient rows into
// SMEM outputs across the in-order TPU grid. A GPU grid has no order and
// CUDA has no autodiff: each thread runs the forward and the hand-written
// adjoint of its pixel (render_common.cuh's pixel_step, the same code as the
// small-scene step kernel, reading the packed layout), with the chunk skip
// redone per warp: the primary rays and each light's shadow rays walk only
// the spheres that a conservative per-warp test keeps (cull.cuh). Per-warp
// winner lists, one block row of every object field kept across the tiles
// a block walks, one partial row per block and a fixed-order reduction sum
// the gradient without atomics. The kernels live in vec_step.cuh, shared
// with the render backward (fused_vec_render_bwd.cu).
//
// Bound: operations (per warp the cone test of every sphere and, per light
// with a hit lane, the segment test; per pixel the sphere tests of the
// warp's candidates for its primary ray and for each shadow ray until an
// occluder, the shading and the adjoint; chip_smoke.py counts them). The
// partial rows, one per block (a few hundred), are 1-2 MB of scratch.
//
// The environment map and one to three bounce levels (spp 1 or 4, the TPU
// kernel's env global and reflection levels: vec_step.cuh's
// vec_step_levels_kernel) add per pixel each reflected ray's walk over every
// object, its shading, its shadow rays over their culled candidates and its
// adjoint, the mirror coefficients' gradient, and at a miss of any level the env's bilinear
// sample and its adjoint (chip_smoke.py's bounce_counts and texel_counts
// count them).
//
// Object texel grids (spp 1 or 4, up to three bounces, with or without the env; the
// TPU kernel's texel tails, _tex_nest and the _sphere_eval / _rect_eval
// samples, fused_vec.py:207, :467-471, :503): vec_step.cuh's
// vec_step_tex_kernel. A textured winner's base colour at any level is
// its grid's bilinear sample, gathered from global memory (the TPU kernel's
// dense hat-basis sampler, _make_sample_mxu, exists because Mosaic cannot
// gather, and is not carried over); each level's texel record of each pixel
// is scattered, warp by warp and in lane order, into the block's texel row
// in shared memory, which ends the block's partial row.
#include "vec_step.cuh"

using namespace rrt;

extern "C" long long rrt_vec_step_scratch_floats(int ns_pad, int nr_pad, int n_light, int H,
                                                 int W) {
  return vec_step_scratch_floats(ns_pad, nr_pad, n_light, H, W);
}

// With an environment map of side ke (0 for none; a bounce adds no shared
// memory), at spp 1 or 4.
extern "C" long long rrt_vec_step_levels_smem(int n_sph, int n_rect, int n_light, int ke) {
  return (long long)step_plan(pad16(n_sph), pad16(n_rect), n_light, ke).smem;
}

extern "C" long long rrt_vec_step_levels_scratch_floats(int ns_pad, int nr_pad, int n_light,
                                                        int H, int W, int ke) {
  return vec_step_scratch_floats(ns_pad, nr_pad, n_light, H, W, ke);
}

// The textured instances (spp 1 or 4): object texel grids of sides ks (the
// spheres') and kr (the rects'), 0 for none, read from stex and rtex, beside
// refl bounce levels and an environment map of side ke; out = [sq, dglob,
// dsph, drct, dstex, drtex].
extern "C" long long rrt_vec_step_tex_smem(int n_sph, int n_rect, int n_light, int ke, int ks,
                                           int kr) {
  return (long long)tex_step_plan(n_sph, n_rect, n_light, ke, ks, kr).smem;
}

extern "C" long long rrt_vec_step_tex_scratch_floats(int n_sph, int n_rect, int n_light, int H,
                                                     int W, int ke, int ks, int kr) {
  return vec_step_tex_scratch_floats(n_sph, n_rect, n_light, H, W, ke, ks, kr);
}

// The band entries (the wrappers'): H rows from image row row0 of an
// image_h-row image (render_common.cuh band_params), the target the band's
// (H, W, 3); w the caller's normalization (a band of a sharded step passes
// the whole image's, so that the bands' sums are the whole image's step).
extern "C" int rrt_vec_step_levels_band(const float* glob, const float* sph, const float* rct,
                                        int n_sph, int n_rect, int ns_pad, int nr_pad,
                                        int n_light, int H, int W, int shadows, int clip,
                                        int row0, int image_h, int spp, int refl, int ke,
                                        const float* target, float w, float* scratch, float* out,
                                        void* stream) {
  if (!band_ok(H, row0, image_h)) return (int)cudaErrorInvalidValue;
  return launch_vec_step(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light,
                         band_params(H, W, shadows, clip, row0, image_h), spp,
                         ResidualSource{target, w}, scratch, out, stream, refl, ke);
}

// The textured instances at spp 1 or 4 (the 2x2 loop in the kernel).
extern "C" int rrt_vec_step_tex_band(const float* glob, const float* sph, const float* rct,
                                     const float* stex, const float* rtex, int n_sph, int n_rect,
                                     int ns_pad, int nr_pad, int n_light, int H, int W, int shadows,
                                     int clip, int row0, int image_h, int spp, int refl, int ke,
                                     int ks, int kr, const float* target, float w, float* scratch,
                                     float* out, void* stream) {
  if (ns_pad != pad16(n_sph) || nr_pad != pad16(n_rect) || !band_ok(H, row0, image_h))
    return (int)cudaErrorInvalidValue;
  return launch_vec_step_tex(glob, sph, rct, n_sph, n_rect, n_light, ke,
                             TexGrids{stex, rtex, ks, kr},
                             band_params(H, W, shadows, clip, row0, image_h), refl,
                             ResidualSource{target, w}, scratch, out, stream, spp);
}

// The whole image (the entries of the tools and of earlier checkouts; the
// textured ones at spp 1).
extern "C" int rrt_vec_step_levels(const float* glob, const float* sph, const float* rct,
                                   int n_sph, int n_rect, int ns_pad, int nr_pad, int n_light,
                                   int H, int W, int shadows, int clip, int spp, int refl, int ke,
                                   const float* target, float w, float* scratch, float* out,
                                   void* stream) {
  return rrt_vec_step_levels_band(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light, H, W,
                                  shadows, clip, 0, H, spp, refl, ke, target, w, scratch, out,
                                  stream);
}

extern "C" int rrt_vec_step_tex(const float* glob, const float* sph, const float* rct,
                                const float* stex, const float* rtex, int n_sph, int n_rect,
                                int ns_pad, int nr_pad, int n_light, int H, int W, int shadows,
                                int clip, int refl, int ke, int ks, int kr, const float* target,
                                float w, float* scratch, float* out, void* stream) {
  return rrt_vec_step_tex_band(glob, sph, rct, stex, rtex, n_sph, n_rect, ns_pad, nr_pad, n_light,
                               H, W, shadows, clip, 0, H, 1, refl, ke, ks, kr, target, w, scratch,
                               out, stream);
}

// spp 1 or 4: at spp 4 the loss is of the average of the four clipped
// subsamples (render_common.cuh pixel_grads).
extern "C" int rrt_vec_step_spp(const float* glob, const float* sph, const float* rct,
                                int n_sph, int n_rect, int ns_pad, int nr_pad, int n_light,
                                int H, int W, int shadows, int clip, int spp,
                                const float* target, float w, float* scratch, float* out,
                                void* stream) {
  return launch_vec_step(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light,
                         make_params(H, W, shadows, clip), spp, ResidualSource{target, w},
                         scratch, out, stream);
}

// spp 1.
extern "C" int rrt_vec_step(const float* glob, const float* sph, const float* rct, int n_sph,
                            int n_rect, int ns_pad, int nr_pad, int n_light, int H, int W,
                            int shadows, int clip, const float* target, float w,
                            float* scratch, float* out, void* stream) {
  return rrt_vec_step_spp(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light, H, W, shadows,
                          clip, 1, target, w, scratch, out, stream);
}
