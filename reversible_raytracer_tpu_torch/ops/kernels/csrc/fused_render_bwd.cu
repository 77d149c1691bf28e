// Render backward kernel for scenes of at most 24 objects: the gradient of
// every scalar of the flat scene for a cotangent (gr, gg, gb) of the
// rendered image, in one call (one cooperative launch on the caller's
// stream).
//
// Replaces the TPU kernel _make_fused.bwd_kernel
// (reversible_raytracer_tpu/ops/kernels/fused.py:252, pallas_call at
// :281), the custom_vjp partner of the forward render (fused.py:297-311):
// it replays render_tile per tile with the forward's saved visibility
// planes under jax.vjp and adds each tile's d flat into one output row
// across the in-order TPU grid.
//
// Design: the fused training step's kernel (flat_step.cuh) with
// CotangentSource in place of the residual. Each thread replays its
// pixel's forward, reading light l's visibility from the forward's plane
// vis[l, i, j] where its ray hit instead of casting a shadow ray, takes
// the caller's cotangent of the clipped image (zero past the ragged edge)
// through the clip's gradient, and runs the step's hand-written adjoint;
// the step's lane, warp and block sums and block 0's fixed-order sum of
// the partial rows reduce it, and the camera chain runs once. No atomics:
// bit-for-bit the same from call to call. For an mse cotangent 2 (img - target) / n the
// result is the step's gradient, up to how the cotangent was rounded.
//
// Bound: operations: the step's per-pixel work without the shadow rays'
// any-hit loops, against 12 bytes of cotangent and 4 bytes per visibility
// plane read per pixel (chip_smoke.py counts both).
//
// Mirror bounces (refl 1 to 3, spp 1 or 4): the step's bounce adjoint, level
// v's visibility read from the forward's planes v L + l of its subsample ((1
// + refl) L planes a subsample, bounce-major), only where that level and
// every level above hit.
//
// Texel grids (spp 1 or 4, refl 0 to 3): the step's textured instance with
// the forward's planes (flat_step.cuh TEX).
#include "flat_step.cuh"

using namespace rrt;

extern "C" long long rrt_render_bwd_scratch_floats(int n_sph, int n_rect, int n_light, int H,
                                                   int W) {
  return flat_step_scratch_floats(n_sph, n_rect, n_light, H, W);
}

// The band entries (the wrappers'): H rows from image row row0 of an
// image_h-row image (render_common.cuh band_params); g_img the band's (H, W,
// 3) cotangent and vis the band forward's planes. out = [0, d flat (S)]. spp
// 1 or 4, refl 0 to 3: vis holds (1 + refl) L planes a subsample, at spp 4
// g_img is the cotangent of the average and vis the forward's 4 (1 + refl) L
// planes (render_common.cuh pixel_grads).
extern "C" int rrt_render_bwd_refl_band(const float* flat, int n_sph, int n_rect, int n_light,
                                        int H, int W, int shadows, int clip, int row0,
                                        int image_h, int spp, int refl, const float* g_img,
                                        const float* vis, float* scratch, float* out,
                                        void* stream) {
  if (!band_ok(H, row0, image_h)) return (int)cudaErrorInvalidValue;
  return launch_flat_step(flat, n_sph, n_rect, n_light,
                          band_params(H, W, shadows, clip, row0, image_h), spp, refl,
                          CotangentSource{g_img, vis, 1.0f}, scratch, out, stream);
}

// The textured instance: refl 0 to 3, spp 1 or 4, the grids' sides Ks, Kr, Ke.
extern "C" int rrt_render_bwd_tex_band(const float* flat, int n_sph, int n_rect, int n_light, int H,
                                       int W, int shadows, int clip, int row0, int image_h,
                                       int refl, int spp, int Ks, int Kr, int Ke,
                                       const float* g_img, const float* vis, float* scratch,
                                       float* out, void* stream) {
  if (!band_ok(H, row0, image_h)) return (int)cudaErrorInvalidValue;
  return launch_flat_step_tex(flat, n_sph, n_rect, n_light,
                              band_params(H, W, shadows, clip, row0, image_h), refl, spp, Ks, Kr,
                              Ke, CotangentSource{g_img, vis, 1.0f}, scratch, out, stream);
}

extern "C" long long rrt_render_bwd_tex_scratch_floats(int n_sph, int n_rect, int n_light, int H,
                                                       int W, int Ks, int Kr, int Ke) {
  return flat_step_tex_scratch_floats(n_sph, n_rect, n_light, H, W, Ks, Kr, Ke);
}

// The whole image (the entries of the tools and of earlier checkouts; the
// textured ones at spp 1).
extern "C" int rrt_render_bwd_refl(const float* flat, int n_sph, int n_rect, int n_light,
                                   int H, int W, int shadows, int clip, int spp, int refl,
                                   const float* g_img, const float* vis, float* scratch,
                                   float* out, void* stream) {
  return rrt_render_bwd_refl_band(flat, n_sph, n_rect, n_light, H, W, shadows, clip, 0, H, spp,
                                  refl, g_img, vis, scratch, out, stream);
}

extern "C" int rrt_render_bwd_tex(const float* flat, int n_sph, int n_rect, int n_light, int H,
                                  int W, int shadows, int clip, int refl, int Ks, int Kr, int Ke,
                                  const float* g_img, const float* vis, float* scratch,
                                  float* out, void* stream) {
  return rrt_render_bwd_tex_band(flat, n_sph, n_rect, n_light, H, W, shadows, clip, 0, H, refl, 1,
                                 Ks, Kr, Ke, g_img, vis, scratch, out, stream);
}

// No bounce.
extern "C" int rrt_render_bwd_spp(const float* flat, int n_sph, int n_rect, int n_light, int H,
                                  int W, int shadows, int clip, int spp, const float* g_img,
                                  const float* vis, float* scratch, float* out, void* stream) {
  return rrt_render_bwd_refl(flat, n_sph, n_rect, n_light, H, W, shadows, clip, spp, 0, g_img,
                             vis, scratch, out, stream);
}

// spp 1.
extern "C" int rrt_render_bwd(const float* flat, int n_sph, int n_rect, int n_light, int H,
                              int W, int shadows, int clip, const float* g_img,
                              const float* vis, float* scratch, float* out, void* stream) {
  return rrt_render_bwd_spp(flat, n_sph, n_rect, n_light, H, W, shadows, clip, 1, g_img, vis,
                            scratch, out, stream);
}
