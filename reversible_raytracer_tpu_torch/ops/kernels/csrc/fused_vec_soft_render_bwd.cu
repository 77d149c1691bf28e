// Soft-visibility render backward kernel: the gradient of the globals and
// of every packed sphere and rect row for a cotangent (gr, gg, gb) of the
// soft image (soft_tau > 0), in one call (three launches on one stream).
//
// Replaces the TPU kernel make_bwd_kernel(False)
// (reversible_raytracer_tpu/ops/kernels/fused_vec_soft.py:547, bwd_call at
// :943), the custom_vjp partner of the soft forward
// (fused_vec_soft.py:1008-1040): "one body, two kernels", the step's body
// reading the cotangent planes where the step forms 2 w (img - target).
//
// Design: the soft step's kernels (soft_step.cuh) with CotangentSource in
// place of the residual: each thread replays its pixel's two-layer
// ranking, coverage and soft shadow products, takes the caller's cotangent
// of the clipped image (zero past the ragged edge) through the clip's
// gradient, and runs the soft adjoint. There are no saved visibility
// planes: soft shadows carry gradient to every covering sphere, so the
// backward recomputes them. The shadow cull (per warp a bound on its
// shadow rays, per pixel the spheres whose factor is exactly 1 dropped),
// the one forward walk over the candidates with its kept prefixes and the
// backward walk (exclusive products, never a division), the per-warp
// shadow rows, the winner lists, the partial rows and vec_finalize_kernel
// are the step's. No atomics: bit-for-bit the same from call to call.
// Shared memory as the step's (55 KB per block at config 5, 171 KB at 513
// objects; up to 832 spheres and a rect fit the H100's 227 KB).
//
// Bound: operations, as the soft step's less its residual; bytes: the rows
// and the cotangent (12 bytes per pixel) read once, the gradient written
// once (chip_smoke.py counts both). checker_tau as the step's: the soft
// checker's instance where it is above 0. The _tex entries run the step's
// texel instance (spp 1, one launch a subsample): the grids' gradient ends the output.
#include "soft_step.cuh"

using namespace rrt;

// Shared memory a block of the backward kernel needs, in bytes.
extern "C" long long rrt_soft_render_bwd_smem(int n_sph, int n_rect, int n_light) {
  return (long long)soft_plan(pad16(n_sph), pad16(n_rect), n_light).smem;
}

extern "C" long long rrt_soft_render_bwd_scratch_floats(int ns_pad, int nr_pad, int n_light,
                                                        int H, int W) {
  return soft_step_scratch_floats(ns_pad, nr_pad, n_light, H, W);
}

// The texel instance (one subsample a launch; the step's _tex entries with the caller's
// cotangent): out = [0, dglob, dsph, drct, dstex, drtex].
extern "C" long long rrt_soft_render_bwd_tex_smem(int n_sph, int n_rect, int n_light, int ke,
                                                  int ks, int kr) {
  return (long long)soft_tex_plan(n_sph, n_rect, n_light, ke, ks, kr).smem;
}

extern "C" long long rrt_soft_render_bwd_tex_scratch_floats(int n_sph, int n_rect, int n_light,
                                                            int H, int W, int ke, int ks,
                                                            int kr) {
  return soft_step_tex_scratch_floats(n_sph, n_rect, n_light, H, W, ke, ks, kr);
}

// The band entries (the wrappers'): H rows from image row row0 of an
// image_h-row image (render_common.cuh band_params); g_img the band's (H, W,
// 3) cotangent. out = [0, dglob (Sg), dsph (ns_pad x P_SPH), drct (nr_pad x
// P_RCT)], at the subsample offset (oi, oj) (0 at spp 1; at spp 4 one launch
// a subsample, each with its cotangent).
extern "C" int rrt_soft_render_bwd_at_band(const float* glob, const float* sph, const float* rct,
                                           int n_sph, int n_rect, int ns_pad, int nr_pad,
                                           int n_light, int H, int W, int shadows, int clip,
                                           int row0, int image_h, float oi, float oj, float tau,
                                           float ctau, const float* g_img, float* scratch,
                                           float* out, void* stream) {
  if (!band_ok(H, row0, image_h)) return (int)cudaErrorInvalidValue;
  return launch_soft_step(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light,
                          band_params(H, W, shadows, clip, row0, image_h, oi, oj), tau, ctau,
                          CotangentSource{g_img, nullptr, 1.0f}, scratch, out, stream);
}

extern "C" int rrt_soft_render_bwd_tex_band(const float* glob, const float* sph,
                                            const float* rct, const float* stex,
                                            const float* rtex, int n_sph, int n_rect, int ns_pad,
                                            int nr_pad, int n_light, int H, int W, int shadows,
                                            int clip, int row0, int image_h, float oi, float oj,
                                            float tau, int ke, int ks, int kr,
                                            const float* g_img, float* scratch, float* out,
                                            void* stream) {
  if (ns_pad != pad16(n_sph) || nr_pad != pad16(n_rect) || !band_ok(H, row0, image_h))
    return (int)cudaErrorInvalidValue;
  return launch_soft_step_tex(glob, sph, rct, n_sph, n_rect, n_light, ke,
                              TexGrids{stex, rtex, ks, kr},
                              band_params(H, W, shadows, clip, row0, image_h, oi, oj), tau,
                              CotangentSource{g_img, nullptr, 1.0f}, scratch, out, stream);
}

// The whole image (the entries of the tools and of earlier checkouts).
extern "C" int rrt_soft_render_bwd_at(const float* glob, const float* sph, const float* rct,
                                      int n_sph, int n_rect, int ns_pad, int nr_pad,
                                      int n_light, int H, int W, int shadows, int clip, float oi,
                                      float oj, float tau, float ctau, const float* g_img,
                                      float* scratch, float* out, void* stream) {
  return rrt_soft_render_bwd_at_band(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light, H,
                                     W, shadows, clip, 0, H, oi, oj, tau, ctau, g_img, scratch,
                                     out, stream);
}

extern "C" int rrt_soft_render_bwd_tex(const float* glob, const float* sph, const float* rct,
                                       const float* stex, const float* rtex, int n_sph,
                                       int n_rect, int ns_pad, int nr_pad, int n_light, int H,
                                       int W, int shadows, int clip, float oi, float oj,
                                       float tau, int ke, int ks, int kr, const float* g_img,
                                       float* scratch, float* out, void* stream) {
  return rrt_soft_render_bwd_tex_band(glob, sph, rct, stex, rtex, n_sph, n_rect, ns_pad, nr_pad,
                                      n_light, H, W, shadows, clip, 0, H, oi, oj, tau, ke, ks,
                                      kr, g_img, scratch, out, stream);
}

// At the pixel centre.
extern "C" int rrt_soft_render_bwd(const float* glob, const float* sph, const float* rct,
                                   int n_sph, int n_rect, int ns_pad, int nr_pad, int n_light,
                                   int H, int W, int shadows, int clip, float tau, float ctau,
                                   const float* g_img, float* scratch, float* out,
                                   void* stream) {
  return rrt_soft_render_bwd_at(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light, H, W,
                                shadows, clip, 0.0f, 0.0f, tau, ctau, g_img, scratch, out,
                                stream);
}
