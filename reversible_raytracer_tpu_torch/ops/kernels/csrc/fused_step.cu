// Fused training-step kernel: the squared-error loss of the render against
// a target, and its gradient with respect to every scalar of the flat
// scene, in one call (one cooperative launch on the caller's stream).
//
// Replaces the TPU kernel _make_loss_grad.kernel
// (reversible_raytracer_tpu/ops/kernels/fused.py:394, pallas_call at :436),
// which replays render_tile under jax.vjp per tile and adds each tile's
// gradient into one output row across the in-order TPU grid. A GPU grid
// has no order, and CUDA has no autodiff, so each thread runs the forward
// of its pixel (ray, nearest hit, shading with the shadow rays' visibility
// kept as bits), takes the residual against the target (threads past the
// ragged edge contribute zero: that is the TPU padding mask), and runs the
// hand-written adjoint of the pixel: shade adjoint, then the adjoint of
// the winning object only (the where chain passes no gradient to the
// losers, and visibility is a step with zero gradient, though the shadow
// origin still carries gradient through light_geometry into t, n and d),
// then the camera. The camera part is accumulated as the cotangents of the
// per-pixel linear form dt = fwd + right sx + up sy (g_fwd, g_right, g_up
// and g_tan of tan(fov/2)): 10 scalars instead of pulling 10 camera leaves
// through camera_basis in every pixel. Each lane sums what every pixel
// writes across its tiles, each warp the winners' fields per tile, each
// block its warps into one partial row, and after a grid-wide sync block 0
// sums the rows in a fixed order and runs the camera chain: no atomics,
// bit-for-bit the same from run to run. The kernel lives in flat_step.cuh,
// shared with the render backward (fused_render_bwd.cu); the per-pixel
// forward and adjoint (pixel_step) and the camera chain in
// render_common.cuh, shared with the object-chunked kernels.
//
// Bound: operations. Per pixel the forward and its adjoint are a few
// hundred to a few thousand float operations (the shadow rays test every
// object), against 12 bytes of target read. chip_smoke.py counts them.
// The kernel takes some 20x that (PERF.md): IEEE divisions, square roots,
// exp and log cost many instructions each, and the per-pixel adjoint
// (tools/flat_step_split.py) is most of its time.
//
// One mirror bounce (refl 1, spp 1 or 4; the TPU kernel traces shade's bounce
// recursion, pipeline.py:658-724): each pixel traces and shades a second
// level from its shadow origin along the reflected direction wherever the
// primary ray hit, blends the two unclipped colours by the winner's mirror
// coefficient, clips once, and runs the bounce's adjoint (render_common.cuh
// pixel_step, flat_step.cuh's REFL instance).
//
// Texel grids (spp 1 or 4; the TPU kernel samples them in render_tile, fused.py
// :93-160, with its dense hat basis, a Mosaic workaround not carried over):
// flat_step.cuh's TEX instance samples a textured winner's grid or, at a
// miss, the environment map by the bilinear gather, and scatters each
// pixel's texel record into the warp's row in lane order. Bound: operations,
// the 4 texel reads, the bilinear weights and the atan2 / asin of a sphere or
// a miss counted a pixel (chip_smoke.py).
#include "flat_step.cuh"

using namespace rrt;

extern "C" long long rrt_step_scratch_floats(int n_sph, int n_rect, int n_light, int H, int W) {
  return flat_step_scratch_floats(n_sph, n_rect, n_light, H, W);
}

// The band entries (the wrappers'): H rows from image row row0 of an
// image_h-row image (render_common.cuh band_params), the target the band's
// (H, W, 3); w the caller's normalization (a band of a sharded step passes
// the whole image's, so that the bands' sums are the whole image's step).
// spp 1 or 4, refl 0 to 3 bounce levels: at spp 4 the loss is of the average
// of the four clipped subsamples (render_common.cuh pixel_grads).
extern "C" int rrt_step_refl_band(const float* flat, int n_sph, int n_rect, int n_light, int H,
                                  int W, int shadows, int clip, int row0, int image_h, int spp,
                                  int refl, const float* target, float w, float* scratch,
                                  float* out, void* stream) {
  if (!band_ok(H, row0, image_h)) return (int)cudaErrorInvalidValue;
  return launch_flat_step(flat, n_sph, n_rect, n_light,
                          band_params(H, W, shadows, clip, row0, image_h), spp, refl,
                          ResidualSource{target, w}, scratch, out, stream);
}

// The textured instance: refl 0 to 3, spp 1 or 4, the texel grids' sides Ks,
// Kr, Ke (0 for none) in make_tex_layout's flat layout.
extern "C" int rrt_step_tex_band(const float* flat, int n_sph, int n_rect, int n_light, int H,
                                 int W, int shadows, int clip, int row0, int image_h, int refl,
                                 int spp, int Ks, int Kr, int Ke, const float* target, float w,
                                 float* scratch, float* out, void* stream) {
  if (!band_ok(H, row0, image_h)) return (int)cudaErrorInvalidValue;
  return launch_flat_step_tex(flat, n_sph, n_rect, n_light,
                              band_params(H, W, shadows, clip, row0, image_h), refl, spp, Ks, Kr,
                              Ke, ResidualSource{target, w}, scratch, out, stream);
}

// The whole image (the entries of the tools and of earlier checkouts; the
// textured ones at spp 1).
extern "C" int rrt_step_refl(const float* flat, int n_sph, int n_rect, int n_light, int H,
                             int W, int shadows, int clip, int spp, int refl,
                             const float* target, float w, float* scratch, float* out,
                             void* stream) {
  return rrt_step_refl_band(flat, n_sph, n_rect, n_light, H, W, shadows, clip, 0, H, spp, refl,
                            target, w, scratch, out, stream);
}

extern "C" long long rrt_step_tex_scratch_floats(int n_sph, int n_rect, int n_light, int H, int W,
                                                 int Ks, int Kr, int Ke) {
  return flat_step_tex_scratch_floats(n_sph, n_rect, n_light, H, W, Ks, Kr, Ke);
}

extern "C" int rrt_step_tex(const float* flat, int n_sph, int n_rect, int n_light, int H, int W,
                            int shadows, int clip, int refl, int Ks, int Kr, int Ke,
                            const float* target, float w, float* scratch, float* out,
                            void* stream) {
  return rrt_step_tex_band(flat, n_sph, n_rect, n_light, H, W, shadows, clip, 0, H, refl, 1, Ks, Kr,
                           Ke, target, w, scratch, out, stream);
}

// No bounce.
extern "C" int rrt_step_spp(const float* flat, int n_sph, int n_rect, int n_light, int H, int W,
                            int shadows, int clip, int spp, const float* target, float w,
                            float* scratch, float* out, void* stream) {
  return rrt_step_refl(flat, n_sph, n_rect, n_light, H, W, shadows, clip, spp, 0, target, w,
                       scratch, out, stream);
}

// spp 1.
extern "C" int rrt_step(const float* flat, int n_sph, int n_rect, int n_light, int H, int W,
                        int shadows, int clip, const float* target, float w, float* scratch,
                        float* out, void* stream) {
  return rrt_step_spp(flat, n_sph, n_rect, n_light, H, W, shadows, clip, 1, target, w, scratch,
                      out, stream);
}
