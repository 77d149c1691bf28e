// Soft-visibility forward render kernel: the (H, W, 3) image of an
// untextured scene of any object count under soft_tau > 0 (spp 1,
// perspective, Phong): the annealed inversion's stage targets.
//
// Replaces the TPU kernel fwd_kernel
// (reversible_raytracer_tpu/ops/kernels/fused_vec_soft.py:494, pallas_call at
// :511), which walks the packed SMEM rows with fori_loops: a two-min rank
// loop, a chunk-skipped resolve of each layer's attributes and coverage, a
// soft shadow product loop per layer and light, and the two-layer
// composite. tau is a runtime argument, as the TPU kernel's SMEM scalar: one
// build serves every anneal stage.
//
// Design: one block of 32 x 8 threads per 32 x 8 tile, one thread per
// pixel, the globals and the packed rows (the sphere rows without their
// mirror column) staged once per block in shared memory (soft_common.cuh
// holds the per-pixel code). The kernel walks its tiles in a stride of the
// grid, as row 4's does, but a grid of as many blocks as the card holds,
// each over several tiles in a fixed order, took 0.002-0.005 ms longer
// (tools/vec_step_split.py, PERF.md): the tiles' work varies with what they
// see, and the block scheduler balances it where a fixed stride cannot. A
// warp is 32 pixels of a row, and the TPU kernel's chunk skip is redone per
// warp with the culls of rows 5-6 and 8-9 (cull.cuh):
//   - the ranking: a sphere ranks where the ray hits it, or passes within r
//     sqrt(1 + 6.91 tau) of its centre in front of the eye (sigmoid(disc /
//     (tau r^2)) > 1e-3), so the spheres outside the warp's cone of primary
//     rays widened by r sqrt(1 + SOFT_CULL tau) rank BIG for every lane
//     (primary_candidates at tau). Each lane ranks only the candidates, in
//     ascending index, then every rect, on strict <: the two layers of the
//     ranking over every object, to the bit.
//   - per live layer and light, the soft shadow product over the warp's
//     candidates for the live lanes' shadow rays (warp_candidates at tau),
//     by the per-pixel rule that drops a factor that is exactly 1 in
//     float32 (soft_visibility, the walk of row 9's shadow_pass1): the
//     product's bits over every sphere.
// Each warp keeps one cull's mask words in shared memory, which its primary
// rays and then each layer and light take in turn. Then each live layer's
// attributes read directly from its winner row, the Phong terms, and the
// composite over the background and the clip. Every lane runs every
// warp-wide vote, those past the ragged edge as dead lanes: a layer with a
// live lane in the warp is shaded by all 32 (a dead lane at t = 0,
// discarded), one with none by no lane. Only the lanes inside the image
// write. The TPU kernel writes no visibility planes, and neither does this
// one.
//
// Bound: operations. Per warp the cone test of every sphere and, per layer
// and light with a live lane, the segment test; per pixel the rank of each
// primary candidate (a square root, and an exponential for a near miss) and
// the per-pixel rule for each shadow candidate (an exponential where it
// keeps the sphere), against 12 bytes of image written (chip_smoke.py
// counts both).
#include "soft_common.cuh"

using namespace rrt;

namespace {

__global__ void __launch_bounds__(BLOCK_THREADS)
    soft_render_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                       const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                       GLayout gl, Params p, float tau, float* __restrict__ img) {
  extern __shared__ float smem[];
  const ForwardBlock fb = stage_forward(smem, glob, sph, rct, N, M, ns_pad, nr_pad, gl);
  const auto& sc = fb.sc;
  const int lane = threadIdx.x;
  const Camera cam = camera(sc);
  const V3 o = cam.eye;
  const V3 bg = sc.background();
  const dim3 tiles = pixel_grid(p.H, p.W);

  for (int t = blockIdx.x; t < (int)(tiles.x * tiles.y); t += gridDim.x) {
    const int j = (t % tiles.x) * BLOCK_X + threadIdx.x;
    const int i = (t / tiles.x) * BLOCK_Y + threadIdx.y;
    const bool inside = i < p.H && j < p.W;
    if (!__any_sync(FULL, inside)) continue;  // a warp wholly past the ragged edge
    const V3 d = primary_ray(cam, p, inside ? i : 0, inside ? j : 0).d;
    __syncwarp();  // the previous tile's walks are done with the mask words
    primary_candidates(sc, o, d, inside, tau, lane, fb.wm);
    Layers y = {{{BIG, -1}, {BIG, -1}}};
    if (inside) y = two_layers(sc, o, d, tau, fb.wm, fb.nw);
    LayerColor lc0, lc1;  // no local array: ly is a runtime index
#pragma unroll 1
    for (int ly = 0; ly < 2; ++ly) {
      const Nearest h = y.l[ly];
      const bool live = h.k >= 0;  // implies inside
      LayerColor lc = {bg, 0.0f};
      if (__any_sync(FULL, live)) {  // a warp without a live lane here shades nothing
        const Surface s = surface(sc, o, d, h);
        auto vis = [&](int l, V3 so, const LightGeo& lg) {
          return p.shadows ? soft_visibility(sc, so, lg, sc.l_pos(l), live, tau, lane, fb.wm)
                           : 1.0f;
        };
        const V3 col = shade_soft_layer(sc, o, d, live ? h.t : 0.0f, s, vis);
        if (live) lc = {col, layer_alpha(sc, o, d, h, tau)};
      }
      if (ly == 0) lc0 = lc;
      else lc1 = lc;
    }
    V3 behind;
    V3 col = composite(lc0, lc1, bg, &behind);
    if (p.clip) col = {clip01(col.x), clip01(col.y), clip01(col.z)};
    if (!inside) continue;
    const long long px = (long long)i * p.W + j;
    img[3 * px + 0] = col.x;
    img[3 * px + 1] = col.y;
    img[3 * px + 2] = col.z;
  }
}

}  // namespace

// Shared memory a block of this kernel needs, in bytes.
extern "C" long long rrt_soft_render_smem(int n_sph, int n_rect, int n_light) {
  return (long long)forward_smem(pad16(n_sph), pad16(n_rect), n_light);
}

extern "C" int rrt_soft_render(const float* glob, const float* sph, const float* rct, int n_sph,
                               int n_rect, int ns_pad, int nr_pad, int n_light, int H, int W,
                               int shadows, int clip, float tau, float* img, void* stream) {
  const GLayout gl = make_glayout(n_light);
  const Params p = make_params(H, W, shadows, clip);
  const size_t smem = forward_smem(ns_pad, nr_pad, n_light);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        soft_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 tiles = pixel_grid(H, W);
  soft_render_kernel<<<tiles.x * tiles.y, dim3(BLOCK_X, BLOCK_Y), smem, (cudaStream_t)stream>>>(
      glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, gl, p, tau, img);
  return (int)cudaGetLastError();
}
