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

extern "C" int rrt_soft_step(const float* glob, const float* sph, const float* rct, int n_sph,
                             int n_rect, int ns_pad, int nr_pad, int n_light, int H, int W,
                             int shadows, int clip, float tau, const float* target, float w,
                             float* scratch, float* out, void* stream) {
  return launch_soft_step(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light, H, W, shadows,
                          clip, tau, ResidualSource{target, w}, scratch, out, stream);
}
