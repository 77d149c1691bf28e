// Soft-visibility fused training-step kernel: the squared-error loss of the
// soft render (soft_tau > 0) against a target, and its gradient with
// respect to the globals and every packed sphere and rect row, in one call
// (three launches on one stream).
//
// Replaces the TPU kernel make_bwd_kernel(True)
// (reversible_raytracer_tpu/ops/kernels/fused_vec_soft.py:547, step_call at
// :975), which replays the two-min ranking and each layer's resolve, takes
// jax.vjp of the shading and composite, transposes each layer's soft shadow
// product with chunked exclusive products in VMEM scratch, runs masked
// per-object vjps for the two layers' winners, and adds each tile's rows
// into SMEM outputs across the in-order TPU grid. CUDA has no autodiff and
// a GPU grid no order: each thread runs the forward and the hand-written
// soft adjoint of its pixel; per-warp shadow rows take the dense sphere
// gradient, per-warp winner lists the two layers' winners, and per-block
// partial rows a fixed-order reduction, no atomics. The kernels live in
// soft_step.cuh, shared with the soft render backward
// (fused_vec_soft_render_bwd.cu).
//
// Bound: operations. Per pixel: the ranking of every object, and per live
// layer and light the soft shadow product and its adjoint over the sphere
// occluders. The design cuts the latter to what the data needs: the
// TPU kernel skips a 16-sphere chunk whose product is exactly 1 over its
// tile; here each warp (32 pixels of a row) bounds its shadow rays by a
// ball and visits only the spheres near the ball's segment to the light,
// and each pixel drops those whose factor 1 - sigmoid(x) is exactly 1 in
// float32 (x < -18), so the image is the soft forward's to the bit. The
// forward walks the candidates once and keeps each prefix for the backward
// walk, which forms the exclusive products without a division.
// chip_smoke.py counts the warp test once per warp, sphere, layer and
// light, the per-pixel test for each live pixel of a warp's candidate, and
// a kept pair at the sigmoid, the factor and its adjoint.
//
// checker_tau, the TPU kernel's second SMEM scalar (fused_vec_soft.py:1133),
// is a runtime argument as tau is: checker_tau > 0 launches the soft
// checker's instance of the body (soft_step.cuh), 0 the other.
//
// Texel grids (spp 1, the hard checker: the TPU kernel's texel tails and env
// global, fused_vec_soft.py:382-443, :458-492): the _tex entries launch the
// body's texel instance, which gives each layer's textured winner a texel
// record and the composite's blend target, the environment's sample, one at
// every pixel, and ends its output with the grids' gradient (soft_step.cuh).
#include "soft_step.cuh"

using namespace rrt;

// Shared memory a block of the step kernel needs, in bytes.
extern "C" long long rrt_soft_step_smem(int n_sph, int n_rect, int n_light) {
  return (long long)soft_plan(pad16(n_sph), pad16(n_rect), n_light).smem;
}

extern "C" long long rrt_soft_step_scratch_floats(int ns_pad, int nr_pad, int n_light, int H,
                                                  int W) {
  return soft_step_scratch_floats(ns_pad, nr_pad, n_light, H, W);
}

// The texel instance (spp 1): object texel grids of sides ks (the spheres',
// from stex) and kr (the rects', from rtex) and an environment map of side ke
// ending the globals, each 0 for none; out = [sq, dglob, dsph, drct, dstex,
// drtex].
extern "C" long long rrt_soft_step_tex_smem(int n_sph, int n_rect, int n_light, int ke, int ks,
                                            int kr) {
  return (long long)soft_tex_plan(n_sph, n_rect, n_light, ke, ks, kr).smem;
}

// The prefix slots a lane of the instance for these sides gets (the untextured
// instances' where ke, ks and kr are all 0).
extern "C" int rrt_soft_step_pcap(int n_sph, int n_rect, int n_light, int ke, int ks, int kr) {
  if (!ke && !ks && !kr) return soft_plan(pad16(n_sph), pad16(n_rect), n_light).pcap;
  return soft_tex_plan(n_sph, n_rect, n_light, ke, ks, kr).pcap;
}

extern "C" long long rrt_soft_step_tex_scratch_floats(int n_sph, int n_rect, int n_light, int H,
                                                      int W, int ke, int ks, int kr) {
  return soft_step_tex_scratch_floats(n_sph, n_rect, n_light, H, W, ke, ks, kr);
}

// The band entries (the wrappers'): H rows from image row row0 of an
// image_h-row image (render_common.cuh band_params), the target the band's
// (H, W, 3); w the caller's normalization (a band of a sharded step passes
// the whole image's, so that the bands' sums are the whole image's step).
extern "C" int rrt_soft_step_band(const float* glob, const float* sph, const float* rct,
                                  int n_sph, int n_rect, int ns_pad, int nr_pad, int n_light,
                                  int H, int W, int shadows, int clip, int row0, int image_h,
                                  float tau, float ctau, const float* target, float w,
                                  float* scratch, float* out, void* stream) {
  if (!band_ok(H, row0, image_h)) return (int)cudaErrorInvalidValue;
  return launch_soft_step(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light,
                          band_params(H, W, shadows, clip, row0, image_h), tau, ctau,
                          ResidualSource{target, w}, scratch, out, stream);
}

extern "C" int rrt_soft_step_tex_band(const float* glob, const float* sph, const float* rct,
                                      const float* stex, const float* rtex, int n_sph,
                                      int n_rect, int ns_pad, int nr_pad, int n_light, int H,
                                      int W, int shadows, int clip, int row0, int image_h,
                                      float tau, int ke, int ks, int kr, const float* target,
                                      float w, float* scratch, float* out, void* stream) {
  if (ns_pad != pad16(n_sph) || nr_pad != pad16(n_rect) || !band_ok(H, row0, image_h))
    return (int)cudaErrorInvalidValue;
  return launch_soft_step_tex(glob, sph, rct, n_sph, n_rect, n_light, ke,
                              TexGrids{stex, rtex, ks, kr},
                              band_params(H, W, shadows, clip, row0, image_h), tau,
                              ResidualSource{target, w}, scratch, out, stream);
}

// The whole image (the entries of the tools and of earlier checkouts).
extern "C" int rrt_soft_step(const float* glob, const float* sph, const float* rct, int n_sph,
                             int n_rect, int ns_pad, int nr_pad, int n_light, int H, int W,
                             int shadows, int clip, float tau, float ctau, const float* target,
                             float w, float* scratch, float* out, void* stream) {
  return rrt_soft_step_band(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light, H, W,
                            shadows, clip, 0, H, tau, ctau, target, w, scratch, out, stream);
}

extern "C" int rrt_soft_step_tex(const float* glob, const float* sph, const float* rct,
                                 const float* stex, const float* rtex, int n_sph, int n_rect,
                                 int ns_pad, int nr_pad, int n_light, int H, int W, int shadows,
                                 int clip, float tau, int ke, int ks, int kr,
                                 const float* target, float w, float* scratch, float* out,
                                 void* stream) {
  return rrt_soft_step_tex_band(glob, sph, rct, stex, rtex, n_sph, n_rect, ns_pad, nr_pad,
                                n_light, H, W, shadows, clip, 0, H, tau, ke, ks, kr, target, w,
                                scratch, out, stream);
}
