// Device code shared by the two soft-visibility kernels (soft_tau > 0):
// the soft rank of a sphere, the two-layer ranking, a layer's coverage, the
// soft shadow product and a layer's shading.
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
//     light (in row order) and of the hard 0/1 rect factors.
#pragma once

#include "render_common.cuh"

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

// Visibility of a light from the shadow origin: 1 - (1 - P).
template <class S>
__device__ __forceinline__ float soft_vis(const S& sc, V3 so, V3 ld, float dist, float tau) {
  float prod = 1.0f;
  for (int k = 0; k < sc.n_sph(); ++k)
    prod *= 1.0f - shadow_alpha(so, ld, dist, sc.s_center(k), sc.s_radius(k), tau);
  return 1.0f - (1.0f - prod * rect_factor(sc, so, ld, dist));
}

// The two nearest layers by soft rank (k < 0: a dead layer, t = BIG).
struct Layers {
  Nearest l[2];
};

template <class S>
__device__ __forceinline__ Layers two_layers(const S& sc, V3 o, V3 d, float tau) {
  Layers y = {{{BIG, -1}, {BIG, -1}}};
  auto update = [&](float t, int k) {
    if (t < y.l[0].t) {
      y.l[1] = y.l[0];
      y.l[0] = {t, k};
    } else if (t < y.l[1].t) {
      y.l[1] = {t, k};
    }
  };
  for (int k = 0; k < sc.n_sph(); ++k) update(sphere_rank(o, d, sc.s_center(k), sc.s_radius(k), tau), k);
  for (int k = 0; k < sc.n_rect(); ++k) {
    float a, b;
    update(hit_rect(o, d, sc.r_origin(k), sc.r_eu(k), sc.r_ev(k), &a, &b), sc.rect_base() + k);
  }
  return y;
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
// vector for a near miss).
template <class S>
__device__ __forceinline__ V3 shade_soft_layer(const S& sc, const Params& p, V3 o, V3 d,
                                               float t, const Surface& s, float tau) {
  const V3 amb = sc.ambient();
  V3 col = {s.base.x * amb.x * s.ka, s.base.y * amb.y * s.ka, s.base.z * amb.z * s.ka};
  const V3 view = -d;
  const V3 so = shadow_origin(o, d, t, s.n);
  for (int l = 0; l < sc.n_light(); ++l) {
    const LightGeo g = light_geometry(sc.l_pos(l), so);
    const float v = p.shadows ? soft_vis(sc, so, g.ldir, g.dist, tau) : 1.0f;
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

template <class S>
__device__ __forceinline__ LayerColor layer_color(const S& sc, const Params& p, V3 o, V3 d,
                                                  Nearest h, float tau) {
  if (h.k < 0) return {sc.background(), 0.0f};
  const Surface s = surface(sc, o, d, h);
  return {shade_soft_layer(sc, p, o, d, h.t, s, tau), layer_alpha(sc, o, d, h, tau)};
}

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

}  // namespace rrt
