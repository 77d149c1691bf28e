// Per-warp culls of the spheres, shared by the soft step body
// (soft_step.cuh, rows 8-9), the object-chunked step body (vec_step.cuh,
// rows 5-6) and the two forwards (fused_vec_render.cu, row 4;
// fused_vec_soft_render.cu, row 7), and the walks over their candidates. A
// warp is 32 pixels of one image row. Each test is
// conservative: it drops a sphere only where no live lane of the warp can
// reach it, with an allowance for float32 rounding, so that a walk over the
// candidates gives every lane the bits of a walk over every sphere. The
// lanes test 32 spheres at a time, one each, and __ballot_sync writes the
// candidates as mask words in row order (bit u of word w: sphere 32 w + u).
// The TPU kernels' chunk skip (fused_vec.py:605-650, fused_vec_soft.py:
// 814-823) drops whole chunks of 16 rows for a tile in the same spirit.
#pragma once

#include "render_common.cuh"

namespace rrt {

constexpr float SOFT_CULL = 18.0f;  // sigmoid(-18) < 2^-25: 1 - alpha rounds to 1
constexpr float CULL_REL = 1e-3f;   // the warp tests' allowance for float32 rounding:
constexpr float CULL_ABS = 2e-3f;   // relative, and per unit of the distances rounded over

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// Every lane gets the warp's sum of v (a butterfly: each lane adds the same
// pairs, so every lane gets the same bits).
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// A warp's candidate spheres for one shadow ray per lane toward the light
// at lpos: the live lanes' shadow origins bound by a ball (centre c_w, the
// midpoint of their box; radius rho, the farthest from it), so that each
// lane's segment [so, light] lies within rho of [c_w, light]; a sphere is a
// candidate if its centre lies within R + rho of that segment, R = r sqrt(1
// + SOFT_CULL tau) (the soft kernels' per-pixel rule reaches that far; at
// tau = 0, R = r, the reach of a hard any-hit), plus the allowance. Returns
// the number of candidates (the same in every lane). Call from the whole
// warp with at least one live lane.
template <class S>
__device__ __forceinline__ int warp_candidates(const S& sc, V3 so, V3 lpos, bool live,
                                               float tau, int lane, unsigned* wm) {
  const float inf = __int_as_float(0x7f800000);
  const V3 lo = {warp_min(live ? so.x : inf), warp_min(live ? so.y : inf),
                 warp_min(live ? so.z : inf)};
  const V3 hi = {warp_max(live ? so.x : -inf), warp_max(live ? so.y : -inf),
                 warp_max(live ? so.z : -inf)};
  const V3 cw = (lo + hi) * 0.5f;
  const V3 dv = so - cw;
  const float rho = sqrtf(warp_max(live ? dot(dv, dv) : 0.0f));
  const V3 u = lpos - cw;
  const float len2 = dot(u, u);
  const float grow = sqrtf(1.0f + SOFT_CULL * tau);
  const float slack = CULL_ABS * (rho + sqrtf(len2));
  const int nw = (sc.n_sph() + 31) >> 5;
  int n = 0;
  for (int w = 0; w < nw; ++w) {
    const int k = w * 32 + lane;
    bool near = false;
    if (k < sc.n_sph()) {
      const V3 wc = sc.s_center(k) - cw;
      const float sp = len2 > 0.0f ? fminf(fmaxf(dot(wc, u) / len2, 0.0f), 1.0f) : 0.0f;
      const V3 q = wc - u * sp;
      const float lim = (sc.s_radius(k) * grow + rho) * (1.0f + CULL_REL) +
                        CULL_ABS * sqrtf(dot(wc, wc)) + slack;
      near = dot(q, q) <= lim * lim;
    }
    const unsigned m = __ballot_sync(FULL, near);
    if (lane == 0) wm[w] = m;
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// A warp's candidate spheres for its primary rays, which all leave the eye
// o: the live lanes' unit directions d lie in a cone about the axis a (their
// normalized sum) of half-angle theta (cos theta = the least d . a, sin
// theta = the largest |d x a|, by shuffles). A ray of the cone can pass
// within R = r sqrt(1 + SOFT_CULL tau) of a sphere's centre, seen from o at
// the angle gamma from a, only if gamma <= theta + beta, beta = asin(r' / D)
// its angular radius from D = |c - o| away, with r' = R (1 + CULL_REL) +
// CULL_ABS D: cos gamma D >= cos(theta + beta) D = cos theta sqrt(D^2 -
// r'^2) - sin theta r'. At tau = 0, R = r (sqrtf(1) is exactly 1): the
// spheres a hard ray can hit. At tau > 0 the soft ranking's reach: a sphere
// ranks where the ray hits it or passes within r sqrt(1 + 6.91 tau) of its
// centre (sigmoid(disc / (tau r^2)) > 1e-3), inside R. A sphere that holds
// the eye (r' >= D), or a cone of 90 degrees or more, keeps the sphere.
// Writes mask words wm; call from the whole warp with at least one live
// lane.
template <class S>
__device__ __forceinline__ void primary_candidates(const S& sc, V3 o, V3 d, bool live, float tau,
                                                   int lane, unsigned* wm) {
  const V3 sum = {warp_allsum(live ? d.x : 0.0f), warp_allsum(live ? d.y : 0.0f),
                  warp_allsum(live ? d.z : 0.0f)};
  const V3 a = sum * rsqrtf(dot(sum, sum));
  const V3 x = cross(d, a);
  const float cmin = warp_min(live ? dot(d, a) : 1.0f);
  const float smax = sqrtf(warp_max(live ? dot(x, x) : 0.0f));
  const bool wide = !(cmin > 0.0f);
  const float grow = sqrtf(1.0f + SOFT_CULL * tau);
  const int nw = (sc.n_sph() + 31) >> 5;
  for (int w = 0; w < nw; ++w) {
    const int k = w * 32 + lane;
    bool near = false;
    if (k < sc.n_sph()) {
      const V3 wc = sc.s_center(k) - o;
      const float D2 = dot(wc, wc);
      const float D = sqrtf(D2);
      const float r = sc.s_radius(k) * grow * (1.0f + CULL_REL) + CULL_ABS * D;
      near = wide || r >= D || dot(wc, a) >= cmin * sqrtf(fmaxf(D2 - r * r, 0.0f)) - smax * r;
    }
    const unsigned m = __ballot_sync(FULL, near);
    if (lane == 0) wm[w] = m;
  }
  __syncwarp();
}

// The nearest hit over the candidate spheres of the nw mask words wm, in
// ascending index, then over every rect: with first-wins ties on strict <,
// the winner and t of the walk over every sphere wherever the candidates
// hold every sphere the ray can hit (primary_candidates at tau = 0).
template <class S>
__device__ __forceinline__ Nearest trace_candidates(const S& sc, V3 o, V3 d, const unsigned* wm,
                                                    int nw) {
  Nearest h = {BIG, -1};
  for (int w = 0; w < nw; ++w)
    for (unsigned m = wm[w]; m; m &= m - 1) {
      const int k = w * 32 + __ffs(m) - 1;
      const float t = hit_sphere(o, d, sc.s_center(k), sc.s_radius(k));
      if (t < h.t) h = {t, k};
    }
  return trace_rects(sc, o, d, h);
}

// The any-hit test toward a light over the candidate spheres of wm, then
// over the rects: the full walk's answer wherever the candidates hold every
// sphere that can occlude the ray (warp_candidates at tau = 0).
template <class S>
__device__ __forceinline__ bool occluded_candidates(const S& sc, V3 so, const LightGeo& g,
                                                    const unsigned* wm, int nw) {
  for (int w = 0; w < nw; ++w)
    for (unsigned m = wm[w]; m; m &= m - 1) {
      const int k = w * 32 + __ffs(m) - 1;
      if (hit_sphere(so, g.ldir, sc.s_center(k), sc.s_radius(k)) < g.dist) return true;
    }
  return occluded_rects(sc, so, g.ldir, g.dist);
}

// Shared memory of a forward (rows 4 and 7): the globals (padded to 4
// floats; with an environment map of side ke its 3 ke^2 texels end them),
// the sphere rows of FWD_SPH floats (P_SPH with refl bounce levels: the
// mirror column) and the rect rows, then per warp one cull's mask words,
// which its primary rays and each light's shadow rays take in turn.
inline size_t forward_smem(int ns_pad, int nr_pad, int n_light, int refl = 0, int ke = 0) {
  const int sg = (make_glayout(n_light).Sg + 3 * ke * ke + 3) & ~3;
  return (size_t)(sg + ns_pad * (refl ? P_SPH : FWD_SPH) + nr_pad * P_RCT) * sizeof(float) +
         (size_t)NWARPS * ((ns_pad + 31) / 32) * sizeof(unsigned);
}

// A forward's block: its shared memory laid out as forward_smem counts it,
// the globals and rows staged (PS floats a sphere row; GL the globals'
// layout, EnvGLayout with an environment map), and this warp's mask words.
template <int PS, class GL>
struct ForwardBlockOf {
  typename std::conditional<std::is_same<GL, EnvGLayout>::value, PackedEnvRows<PS>,
                            PackedRows<PS>>::type sc;
  unsigned* wm;
  int nw;
};

using ForwardBlock = ForwardBlockOf<FWD_SPH, GLayout>;

template <int PS = FWD_SPH, class GL = GLayout>
__device__ __forceinline__ ForwardBlockOf<PS, GL> stage_forward(
    float* smem, const float* __restrict__ glob, const float* __restrict__ sph,
    const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad, GL gl) {
  float* g = smem;
  float* s_sph = g + ((gl.Sg + 3) & ~3);
  float* s_rct = s_sph + ns_pad * PS;
  unsigned* masks = (unsigned*)(s_rct + nr_pad * P_RCT);
  stage(g, glob, gl.Sg);
  stage_cols<PS>(s_sph, sph, ns_pad, P_SPH);
  stage(s_rct, rct, nr_pad * P_RCT);
  __syncthreads();
  const int nw = (N + 31) >> 5;
  return {packed_view<PS>(g, s_sph, s_rct, gl, N, M, ns_pad), masks + threadIdx.y * nw, nw};
}

// The scene a forward's tiles read: the staged rows, and with TEX the object
// texel grids tg beside them (PackedTexRows).
template <bool TEX, class S>
__device__ __forceinline__ decltype(auto) forward_scene(const S& staged, const TexGrids& tg) {
  if constexpr (TEX)
    return tex_view(staged, tg);
  else
    return (staged);
}

}  // namespace rrt
