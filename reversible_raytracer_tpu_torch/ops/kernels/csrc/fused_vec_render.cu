// Object-chunked forward render kernel: the (H, W, 3) image and one
// shadow-visibility plane per light of a hard-shaded, untextured scene of
// any object count (spp 1, perspective, Phong).
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
#include "cull.cuh"

using namespace rrt;

namespace {

__global__ void __launch_bounds__(BLOCK_THREADS)
    vec_render_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                      const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                      GLayout gl, Params p, float* __restrict__ img, float* __restrict__ vis) {
  extern __shared__ float smem[];
  const ForwardBlock fb = stage_forward(smem, glob, sph, rct, N, M, ns_pad, nr_pad, gl);
  const auto& sc = fb.sc;
  const int lane = threadIdx.x;
  const Camera cam = camera(sc);
  const V3 o = cam.eye;
  const dim3 tiles = pixel_grid(p.H, p.W);
  const long long plane = (long long)p.H * p.W;

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
    unsigned bits = p.shadows ? 0u : ~0u;  // without shadows every light is lit
    if (p.shadows && __any_sync(FULL, hit)) {
      for (int l = 0; l < gl.L; ++l) {
        __syncwarp();
        warp_candidates(sc, so, sc.l_pos(l), hit, 0.0f, lane, fb.wm);
        if (hit && !occluded_candidates(sc, so, light_geometry(sc.l_pos(l), so), fb.wm, fb.nw))
          bits |= 1u << l;
      }
    }
    V3 col = sc.background();
    if (hit) {
      unsigned lit;
      col = shade_hit(
          sc, o, d, h.t, s, [&](int l, V3, const LightGeo&) { return ((bits >> l) & 1u) != 0; },
          &lit);
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
  }
}

}  // namespace

// Shared memory a block of this kernel needs, in bytes.
extern "C" long long rrt_vec_render_smem(int n_sph, int n_rect, int n_light) {
  return (long long)forward_smem(pad16(n_sph), pad16(n_rect), n_light);
}

// The most shared memory a block may have on the current device (opt-in).
extern "C" long long rrt_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

extern "C" int rrt_vec_render(const float* glob, const float* sph, const float* rct, int n_sph,
                              int n_rect, int ns_pad, int nr_pad, int n_light, int H, int W,
                              int shadows, int clip, float* img, float* vis, void* stream) {
  const GLayout gl = make_glayout(n_light);
  const Params p = make_params(H, W, shadows, clip);
  const size_t smem = forward_smem(ns_pad, nr_pad, n_light);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vec_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int nblocks = resident_blocks(vec_render_kernel, smem, H, W);
  if (nblocks <= 0) return (int)cudaErrorInvalidConfiguration;
  vec_render_kernel<<<nblocks, dim3(BLOCK_X, BLOCK_Y), smem, (cudaStream_t)stream>>>(
      glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, gl, p, img, vis);
  return (int)cudaGetLastError();
}
