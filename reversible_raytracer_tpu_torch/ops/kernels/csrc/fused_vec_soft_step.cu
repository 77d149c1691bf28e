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
// soft adjoint of its pixel, with exclusive shadow products that never
// divide, per-warp shadow rows for the dense sphere gradient, per-warp
// winner lists for the two layers, per-block partial rows and a
// fixed-order reduction, no atomics. The kernels live in soft_step.cuh,
// shared with the soft render backward (fused_vec_soft_render_bwd.cu).
//
// Bound: operations. Per pixel: the ranking of every object, and per live
// layer and light three walks over the sphere occluders (the forward
// product, pass 1 and pass 2, each an exponential per sphere) plus the
// adjoint of every covering sphere; chip_smoke.py counts each soft shadow
// term once, and the partial rows as bytes.
#include "soft_step.cuh"

using namespace rrt;

// Shared memory a block of the step kernel needs, in bytes.
extern "C" long long rrt_soft_step_smem(int n_sph, int n_rect, int n_light) {
  return (long long)soft_plan(pad16(n_sph), pad16(n_rect), n_light).smem;
}

// The most spheres the exclusive products' chunk boundaries can hold.
extern "C" int rrt_soft_max_spheres() { return soft_max_spheres(); }

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
