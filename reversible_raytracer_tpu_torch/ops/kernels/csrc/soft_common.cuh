// Device code shared by the soft-visibility kernels (soft_tau > 0): the
// soft rank of a sphere, the two-layer ranking (over every sphere, or over a
// warp's primary candidates), a layer's coverage, the per-pixel rule of the
// soft shadow product and its walk over a warp's candidates, and a layer's
// shading.
//
// Semantics follow reversible_raytracer_tpu/ops/pipeline_vec.py
// (_sphere_soft, _occluded_soft, _render_soft) and the soft Pallas kernels
// (ops/kernels/fused_vec_soft.py: _two_min_loop, _occluded_soft_loop):
//   - a sphere's coverage alpha = sigmoid(disc / (tau r^2)), sigmoid(x) =
//     1 / (1 + exp(-x)), for rays that hit it or point at it;
//   - its rank t is the hit t, or the closest approach -b of a near miss
//     whose alpha exceeds 1e-3, else BIG; a rect ranks by its hit t and
//     covers fully;
//   - the two nearest layers by rank, on strict <: ties go to the earlier
//     object, and the later of a tied pair becomes layer 2;
//   - per layer and light, the visibility 1 - (1 - P), P the product of
//     (1 - alpha) over the sphere occluders between the surface and the
//     light (in row order) and of the hard 0/1 rect factors; the kernels
//     take it over a warp's candidates by the per-pixel rule (shadow_term),
//     which keeps its bits;
//   - the soft checker (checker_tau > 0; pipeline.py:229-254 and the
//     checker_tau branch of _gather_layer, pipeline_vec.py:276-327): a
//     layer's base colour c1 + u (c2 - c1), u = checker (0.5 - 0.5 q), q the
//     product over the axes of tri / (|tri| + checker_tau + 1e-6), tri =
//     2 |mod(x - 0.5, 2) - 1| - 1 at x = a sphere's (p - c) s or a rect's
//     (a s, b s), s the checker scale; mod floored (mod2), as jnp.mod and
//     torch.remainder are.
#pragma once

#include "cull.cuh"

namespace rrt {

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The soft rank of sphere (c, r) for the ray (o, d).
__device__ __forceinline__ float sphere_rank(V3 o, V3 d, V3 c, float r, float tau) {
  const V3 oc = o - c;
  const float b = dot(oc, d);
  const float disc = b * b - (dot(oc, oc) - r * r);
  const float t = -b - sqrtf(disc > 0.0f ? disc : 1.0f);
  if (disc > 0.0f && t > T_EPS) return t;
  if (!(-b > T_EPS)) return BIG;
  return sigmoid(disc / (tau * r * r)) > 1e-3f ? -b : BIG;
}

// The coverage of a live sphere layer (the ray hits or points at it).
__device__ __forceinline__ float sphere_alpha(V3 o, V3 d, V3 c, float r, float tau) {
  const V3 oc = o - c;
  const float b = dot(oc, d);
  const float disc = b * b - (dot(oc, oc) - r * r);
  return sigmoid(disc / (tau * r * r));
}

// The soft coverage of a shadow ray (so, ld) toward a light at dist by
// sphere (c, r): the sigmoid where the sphere is hit, or passed closest,
// between the surface and the light.
__device__ __forceinline__ float shadow_alpha(V3 so, V3 ld, float dist, V3 c, float r,
                                              float tau) {
  const V3 oc = so - c;
  const float b = dot(oc, ld);
  const float disc = b * b - (dot(oc, oc) - r * r);
  const float t = -b - sqrtf(disc > 0.0f ? disc : 1.0f);
  const bool between =
      (disc > 0.0f && t > T_EPS && t < dist) || (-b > T_EPS && -b < dist);
  return between ? sigmoid(disc / (tau * r * r)) : 0.0f;
}

// 0 if a rect blocks the shadow ray before the light, else 1.
template <class S>
__device__ __forceinline__ float rect_factor(const S& sc, V3 so, V3 ld, float dist) {
  for (int k = 0; k < sc.n_rect(); ++k) {
    float a, b;
    if (hit_rect(so, ld, sc.r_origin(k), sc.r_eu(k), sc.r_ev(k), &a, &b) < dist) return 0.0f;
  }
  return 1.0f;
}

// One sphere (c, r) against one lane's shadow ray (so, ld) toward a light
// at dist, by the per-pixel cull rule: kept where the sphere is hit, or
// passed closest, between the surface and the light and disc is not below
// -SOFT_CULL tau r^2; then s = alpha = sigmoid(disc / (tau r^2)), computed
// as shadow_alpha computes it, so that 1 - s is the sphere's factor in the
// shadow product. Elsewhere that factor is exactly 1 in float32 (1 -
// shadow_alpha is 1 - 0, or 1 - sigmoid(x) with x < -SOFT_CULL), so a product
// over the kept spheres alone, in row order, has the bits of the product
// over every sphere.
struct ShadowTerm {
  V3 oc;
  float b, disc, s;
  bool kept;
};

__device__ __forceinline__ ShadowTerm shadow_term(V3 so, V3 ld, float dist, V3 c, float r,
                                                  float tau) {
  ShadowTerm st;
  st.oc = so - c;
  st.b = dot(st.oc, ld);
  st.disc = st.b * st.b - (dot(st.oc, st.oc) - r * r);
  st.s = 0.0f;
  st.kept = false;
  if (st.disc < -SOFT_CULL * tau * r * r) return st;
  const float t = -st.b - sqrtf(st.disc > 0.0f ? st.disc : 1.0f);
  st.kept = (st.disc > 0.0f && t > T_EPS && t < dist) || (-st.b > T_EPS && -st.b < dist);
  if (st.kept) st.s = sigmoid(st.disc / (tau * r * r));
  return st;
}

// A lane's product of (1 - alpha) over the n candidates of the mask words
// wm, in row order, by the per-pixel rule (1 on a dead lane); before
// candidate i, pre(i, product so far) (the step keeps those prefixes). Every
// lane of the warp walks the same n candidates.
template <class S, class Pre>
__device__ __forceinline__ float shadow_product(const S& sc, V3 so, const LightGeo& lg, bool live,
                                                float tau, const unsigned* wm, int n, Pre pre) {
  float run = 1.0f;
  for (int w = 0, i = 0; i < n; ++w) {
    for (unsigned m = wm[w]; m; m &= m - 1, ++i) {
      const int k = w * 32 + __ffs(m) - 1;
      pre(i, run);
      if (live) {
        const ShadowTerm st =
            shadow_term(so, lg.ldir, lg.dist, sc.s_center(k), sc.s_radius(k), tau);
        if (st.kept) run *= 1.0f - st.s;
      }
    }
  }
  return run;
}

// The visibility 1 - (1 - P) of the light at lpos from a lane's shadow
// origin so (1 on a dead lane), P the product over the warp's candidates
// for this light (warp_candidates, written into wm) and the rects' hard
// factor: the soft step's forward (shadow_pass1) without its prefix slots.
// Call from the whole warp; wm may hold the warp's previous cull.
template <class S>
__device__ __forceinline__ float soft_visibility(const S& sc, V3 so, const LightGeo& lg, V3 lpos,
                                                 bool live, float tau, int lane, unsigned* wm) {
  __syncwarp();  // the walks over wm's previous candidates are done
  const int n = __any_sync(FULL, live) ? warp_candidates(sc, so, lpos, live, tau, lane, wm) : 0;
  const float run = shadow_product(sc, so, lg, live, tau, wm, n, [](int, float) {});
  const float rf = live ? rect_factor(sc, so, lg.ldir, lg.dist) : 1.0f;
  return live ? 1.0f - (1.0f - run * rf) : 1.0f;
}

// The two nearest layers by soft rank (k < 0: a dead layer, t = BIG).
struct Layers {
  Nearest l[2];
};

// A rank into the two layers (strict <: ties go to the earlier object).
__device__ __forceinline__ void rank_into(Layers& y, float t, int k) {
  if (t < y.l[0].t) {
    y.l[1] = y.l[0];
    y.l[0] = {t, k};
  } else if (t < y.l[1].t) {
    y.l[1] = {t, k};
  }
}

template <class S>
__device__ __forceinline__ Layers rank_rects(const S& sc, V3 o, V3 d, Layers y) {
  for (int k = 0; k < sc.n_rect(); ++k) {
    float a, b;
    rank_into(y, hit_rect(o, d, sc.r_origin(k), sc.r_eu(k), sc.r_ev(k), &a, &b),
              sc.rect_base() + k);
  }
  return y;
}

// The ranking over every sphere, then every rect.
template <class S>
__device__ __forceinline__ Layers two_layers(const S& sc, V3 o, V3 d, float tau) {
  Layers y = {{{BIG, -1}, {BIG, -1}}};
  for (int k = 0; k < sc.n_sph(); ++k)
    rank_into(y, sphere_rank(o, d, sc.s_center(k), sc.s_radius(k), tau), k);
  return rank_rects(sc, o, d, y);
}

// The ranking over the candidate spheres of the nw mask words wm, in
// ascending index, then every rect: a sphere outside the candidates ranks
// BIG, which strict < never takes, so wherever the candidates hold every
// sphere that ranks (primary_candidates at tau) the layers are those of the
// ranking over every sphere, to the bit.
template <class S>
__device__ __forceinline__ Layers two_layers(const S& sc, V3 o, V3 d, float tau,
                                             const unsigned* wm, int nw) {
  Layers y = {{{BIG, -1}, {BIG, -1}}};
  for (int w = 0; w < nw; ++w)
    for (unsigned m = wm[w]; m; m &= m - 1) {
      const int k = w * 32 + __ffs(m) - 1;
      rank_into(y, sphere_rank(o, d, sc.s_center(k), sc.s_radius(k), tau), k);
    }
  return rank_rects(sc, o, d, y);
}

// The coverage of a live layer: the sphere's sigmoid, or 1 for a rect.
template <class S>
__device__ __forceinline__ float layer_alpha(const S& sc, V3 o, V3 d, Nearest h, float tau) {
  if (h.k < 0) return 0.0f;
  if (h.k >= sc.rect_base()) return 1.0f;
  return sphere_alpha(o, d, sc.s_center(h.k), sc.s_radius(h.k), tau);
}

// Unclipped Phong colour of a live layer with soft shadows (the layer's
// surface s at its rank t; a sphere's normal (p - c) / r is not a unit
// vector for a near miss); vis_fn(l, so, g) is light l's visibility from
// the shadow origin so with light geometry g.
template <class S, class Vis>
__device__ __forceinline__ V3 shade_soft_layer(const S& sc, V3 o, V3 d, float t,
                                               const Surface& s, Vis vis_fn) {
  const V3 amb = sc.ambient();
  V3 col = {s.base.x * amb.x * s.ka, s.base.y * amb.y * s.ka, s.base.z * amb.z * s.ka};
  const V3 view = -d;
  const V3 so = shadow_origin(o, d, t, s.n);
  for (int l = 0; l < sc.n_light(); ++l) {
    const LightGeo g = light_geometry(sc.l_pos(l), so);
    const float v = vis_fn(l, so, g);
    const float ndotl = fmaxf(dot(s.n, g.ldir), 0.0f);
    const V3 refl = s.n * (2.0f * ndotl) - g.ldir;
    const float spec = s.ks * safe_pow(fmaxf(dot(refl, view), 0.0f), s.shin);
    const V3 lcol = sc.l_col(l);
    col.x += v * (s.kd * ndotl * s.base.x + spec) * lcol.x;
    col.y += v * (s.kd * ndotl * s.base.y + spec) * lcol.y;
    col.z += v * (s.kd * ndotl * s.base.z + spec) * lcol.z;
  }
  return col;
}

// One layer's colour (the background where it is dead) and coverage.
struct LayerColor {
  V3 col;
  float a;
};

// a1 c1 + (1 - a1) (a2 c2 + (1 - a2) bg), per channel; behind gets
// a2 c2 + (1 - a2) bg.
__device__ __forceinline__ V3 composite(const LayerColor& c1, const LayerColor& c2, V3 bg,
                                        V3* behind) {
  const V3 b = {c2.a * c2.col.x + (1.0f - c2.a) * bg.x, c2.a * c2.col.y + (1.0f - c2.a) * bg.y,
                c2.a * c2.col.z + (1.0f - c2.a) * bg.z};
  *behind = b;
  return {c1.a * c1.col.x + (1.0f - c1.a) * b.x, c1.a * c1.col.y + (1.0f - c1.a) * b.y,
          c1.a * c1.col.z + (1.0f - c1.a) * b.z};
}

// One axis of the soft checker at coordinate x: f = tri / (|tri| + ctau +
// 1e-6), with what its adjoint reads.
struct CheckerAxis {
  float m1, tri, den, f;  // m1 = mod(x - 0.5, 2) - 1
};

__device__ __forceinline__ CheckerAxis checker_axis(float x, float ctau) {
  CheckerAxis a;
  a.m1 = mod2(x - 0.5f) - 1.0f;
  a.tri = 2.0f * fabsf(a.m1) - 1.0f;
  a.den = (fabsf(a.tri) + ctau) + 1e-6f;
  a.f = a.tri / a.den;
  return a;
}

// The cotangent of x for a cotangent g_f of the axis's factor f: df/dtri =
// (den - |tri|) / den^2 (|tri| has the subgradient 0 at 0), dtri/dm =
// 2 sign(m1), and the floored mod's derivative is 1.
__device__ __forceinline__ float checker_axis_adjoint(const CheckerAxis& a, float g_f) {
  const float g_tri = g_f * (a.den - fabsf(a.tri)) / (a.den * a.den);
  return g_tri * 2.0f * (a.m1 > 0.0f ? 1.0f : (a.m1 < 0.0f ? -1.0f : 0.0f));
}

// c1 + u (c2 - c1), per channel.
__device__ __forceinline__ V3 checker_blend(V3 c1, V3 c2, float u) {
  return {c1.x + u * (c2.x - c1.x), c1.y + u * (c2.y - c1.y), c1.z + u * (c2.z - c1.z)};
}

// The surface of a live layer under the soft checker: surface's normal and
// material scalars, the base colour blended by the soft parity at the hit
// (a sphere's p - c at the layer's rank t, a rect's (a, b)); use2 is false.
// surface() stays the hard checker of every other kernel and of
// checker_tau = 0.
template <class S>
__device__ __forceinline__ Surface soft_surface(const S& sc, V3 o, V3 d, Nearest h, float ctau) {
  Surface s = surface(sc, o, d, h);
  if (h.k < 0) return s;
  s.use2 = false;
  if (h.k < sc.rect_base()) {
    const int k = h.k;
    const V3 pl = (o + d * h.t) - sc.s_center(k);
    const float cs = sc.s_cscale(k);
    const float q = checker_axis(pl.x * cs, ctau).f * checker_axis(pl.y * cs, ctau).f *
                    checker_axis(pl.z * cs, ctau).f;
    s.base = checker_blend(sc.s_color(k, false), sc.s_color(k, true),
                           sc.s_checker(k) * (0.5f - 0.5f * q));
  } else {
    const int k = h.k - sc.rect_base();
    float a, b;
    hit_rect(o, d, sc.r_origin(k), sc.r_eu(k), sc.r_ev(k), &a, &b);
    const float cs = sc.r_cscale(k);
    const float q = checker_axis(a * cs, ctau).f * checker_axis(b * cs, ctau).f;
    s.base = checker_blend(sc.r_color(k, false), sc.r_color(k, true),
                           sc.r_checker(k) * (0.5f - 0.5f * q));
  }
  return s;
}

// A layer's surface: the soft checker's in the kernels' SOFT_CHECKER
// instance, the hard one otherwise.
template <bool SOFT_CHECKER, class S>
__device__ __forceinline__ Surface layer_surface(const S& sc, V3 o, V3 d, Nearest h,
                                                 float ctau) {
  if constexpr (SOFT_CHECKER) return soft_surface(sc, o, d, h, ctau);
  else return surface(sc, o, d, h);
}

}  // namespace rrt
