// Device code shared by the forward render kernel (fused_render.cu) and the
// fused training-step kernel (fused_step.cu): the flat scene layout, the
// per-pixel camera ray, sphere and rect intersection, the first-wins
// nearest-hit loop, the any-hit shadow test and Phong shading.
//
// Semantics follow reversible_raytracer_tpu/ops/pipeline.py (hard shading,
// spp 1, perspective camera, untextured objects, flat background):
//   - BIG, T_EPS and SHADOW_EPS as there;
//   - nearest hit on strict <, spheres before rects, so ties go to the
//     earlier object;
//   - the guarded sqrt and normalize (sqrt(1) on the dead branch);
//   - safe_pow(x, p) = exp(p * log x), zero at x <= 0.
// Compiled without --use_fast_math (sqrtf, division, expf and logf stay
// IEEE) and with --fmad=false, and the guarded normalize uses rsqrtf as
// torch.rsqrt does on the card: the forward rounds op for op like the eager
// plain version, so no silhouette pixel changes hit between the two.
#pragma once

#include <cuda_runtime.h>

namespace rrt {

constexpr float BIG = 1e10f;
constexpr float T_EPS = 1e-3f;
constexpr float SHADOW_EPS = 1e-3f;
constexpr int BLOCK_X = 32;  // one warp along a row: coalesced pixel access
constexpr int BLOCK_Y = 8;
constexpr int BLOCK_THREADS = BLOCK_X * BLOCK_Y;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }

// Start of each leaf in the flat scene vector: the leaf order of
// models/scene.py (the JAX treedef order) for an untextured scene with no
// environment map, N spheres, M rects and L lights. Python's
// fused.flat_offsets computes the same table and checks S.
struct Layout {
  int N, M, L;
  int s_center, s_radius, s_color, s_color2, s_checker, s_cscale, s_ka, s_kd, s_ks, s_shin;
  int r_origin, r_eu, r_ev, r_color, r_color2, r_checker, r_cscale, r_ka, r_kd, r_ks, r_shin;
  int l_pos, l_col;
  int c_eye, c_look, c_up, c_fov;
  int ambient, background;
  int S;
};

inline Layout make_layout(int N, int M, int L) {
  Layout ly;
  ly.N = N;
  ly.M = M;
  ly.L = L;
  ly.s_center = 0;
  ly.s_radius = 3 * N;
  ly.s_color = 4 * N;
  ly.s_color2 = 7 * N;
  ly.s_checker = 10 * N;
  ly.s_cscale = 11 * N;
  ly.s_ka = 12 * N;
  ly.s_kd = 13 * N;
  ly.s_ks = 14 * N;
  ly.s_shin = 15 * N;  // then mirror (N), texture (empty)
  const int R = 17 * N;
  ly.r_origin = R;
  ly.r_eu = R + 3 * M;
  ly.r_ev = R + 6 * M;
  ly.r_color = R + 9 * M;
  ly.r_color2 = R + 12 * M;
  ly.r_checker = R + 15 * M;
  ly.r_cscale = R + 16 * M;
  ly.r_ka = R + 17 * M;
  ly.r_kd = R + 18 * M;
  ly.r_ks = R + 19 * M;
  ly.r_shin = R + 20 * M;  // then mirror (M), texture (empty)
  const int Lb = R + 22 * M;
  ly.l_pos = Lb;
  ly.l_col = Lb + 3 * L;
  const int C = Lb + 6 * L;
  ly.c_eye = C;
  ly.c_look = C + 3;
  ly.c_up = C + 6;
  ly.c_fov = C + 9;
  ly.ambient = C + 10;
  ly.background = C + 13;
  ly.S = C + 16;  // env (empty) ends the vector
  return ly;
}

// Launch constants. The pixel-grid factors are rounded once on the host,
// like the Python floats 2.0 / W, 2.0 / H and W / H of camera_rays.
struct Params {
  int H, W, shadows, clip;
  float two_over_w, two_over_h, aspect;
};

inline Params make_params(int H, int W, int shadows, int clip) {
  return {H, W, shadows, clip, (float)(2.0 / W), (float)(2.0 / H), (float)((double)W / H)};
}

// rsqrt of the vnormalize guard: rsqrt(n2 > 1e-12 ? n2 : 1).
__device__ __forceinline__ float guarded_inv(float n2) {
  return rsqrtf(n2 > 1e-12f ? n2 : 1.0f);
}

__device__ __forceinline__ float safe_pow(float x, float p) {
  return x > 0.0f ? expf(p * logf(x)) : 0.0f;
}

// x - 2 floor(x / 2): jnp.mod / torch.remainder for the integer-valued
// checker sums.
__device__ __forceinline__ float mod2(float x) { return x - 2.0f * floorf(x * 0.5f); }

struct Camera {
  V3 eye, right, up, fwd;
  float tan_half;
};

__device__ __forceinline__ Camera camera(const float* sc, const Layout& ly) {
  Camera c;
  c.eye = ld3(sc + ly.c_eye);
  const V3 f_raw = ld3(sc + ly.c_look) - c.eye;
  c.fwd = f_raw * guarded_inv(dot(f_raw, f_raw));
  const V3 r_raw = cross(c.fwd, ld3(sc + ly.c_up));
  c.right = r_raw * guarded_inv(dot(r_raw, r_raw));
  c.up = cross(c.right, c.fwd);
  c.tan_half = tanf(sc[ly.c_fov] * 0.017453292519943295f * 0.5f);
  return c;
}

// Perspective primary ray of pixel (i, j): d = normalize(fwd + right sx +
// up sy) with sx = ax tan(fov/2) aspect, sy = ay tan(fov/2). The
// intermediates are what the step kernel's camera adjoint needs.
struct Ray {
  V3 d, dt;
  float n2, inv, ax, ay, sx, sy;
};

__device__ __forceinline__ Ray primary_ray(const Camera& c, const Params& p, int i, int j) {
  Ray r;
  r.ax = ((float)j + 0.5f) * p.two_over_w - 1.0f;
  r.ay = 1.0f - ((float)i + 0.5f) * p.two_over_h;
  r.sx = r.ax * c.tan_half * p.aspect;
  r.sy = r.ay * c.tan_half;
  r.dt = c.fwd + (c.right * r.sx + c.up * r.sy);
  r.n2 = dot(r.dt, r.dt);
  r.inv = guarded_inv(r.n2);
  r.d = r.dt * r.inv;
  return r;
}

__device__ __forceinline__ float hit_sphere(V3 o, V3 d, V3 c, float r) {
  const V3 oc = o - c;
  const float b = dot(oc, d);
  const float disc = b * b - (dot(oc, oc) - r * r);
  const float t = -b - sqrtf(disc > 0.0f ? disc : 1.0f);
  return (disc > 0.0f && t > T_EPS) ? t : BIG;
}

// Ray-parallelogram hit; (a, b) are the in-face coordinates.
__device__ __forceinline__ float hit_rect(V3 o, V3 d, V3 p0, V3 eu, V3 ev, float* a_out,
                                          float* b_out) {
  const V3 n = cross(eu, ev);
  const float denom = dot(d, n);
  const bool grazing = fabsf(denom) > 1e-9f;
  const float t = dot(p0 - o, n) / (grazing ? denom : 1.0f);
  const V3 rel = (o + d * t) - p0;
  const float a = dot(rel, eu) * (1.0f / dot(eu, eu));
  const float b = dot(rel, ev) * (1.0f / dot(ev, ev));
  *a_out = a;
  *b_out = b;
  const bool valid = grazing && t > T_EPS && a >= 0.0f && a <= 1.0f && b >= 0.0f && b <= 1.0f;
  return valid ? t : BIG;
}

// Winner of the nearest-hit loop: k < 0 misses, k < N is sphere k, else
// rect k - N (rects are numbered after the spheres).
struct Nearest {
  float t;
  int k;
};

__device__ __forceinline__ Nearest trace(const float* sc, const Layout& ly, V3 o, V3 d) {
  Nearest h = {BIG, -1};
  for (int k = 0; k < ly.N; ++k) {
    const float t = hit_sphere(o, d, ld3(sc + ly.s_center + 3 * k), sc[ly.s_radius + k]);
    if (t < h.t) h = {t, k};
  }
  for (int k = 0; k < ly.M; ++k) {
    float a, b;
    const float t = hit_rect(o, d, ld3(sc + ly.r_origin + 3 * k), ld3(sc + ly.r_eu + 3 * k),
                             ld3(sc + ly.r_ev + 3 * k), &a, &b);
    if (t < h.t) h = {t, ly.N + k};
  }
  return h;
}

__device__ __forceinline__ bool occluded(const float* sc, const Layout& ly, V3 o, V3 ldir,
                                         float dist) {
  for (int k = 0; k < ly.N; ++k)
    if (hit_sphere(o, ldir, ld3(sc + ly.s_center + 3 * k), sc[ly.s_radius + k]) < dist)
      return true;
  for (int k = 0; k < ly.M; ++k) {
    float a, b;
    if (hit_rect(o, ldir, ld3(sc + ly.r_origin + 3 * k), ld3(sc + ly.r_eu + 3 * k),
                 ld3(sc + ly.r_ev + 3 * k), &a, &b) < dist)
      return true;
  }
  return false;
}

// Shading attributes of the winning object (the trace_nearest defaults on
// a miss).
struct Surface {
  V3 n, base;
  float ka, kd, ks, shin;
  bool use2;  // checker picked color2
};

__device__ __forceinline__ Surface surface(const float* sc, const Layout& ly, V3 o, V3 d,
                                           Nearest h) {
  Surface s = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f, 0.0f, 0.0f, 1.0f, false};
  if (h.k < 0) return s;
  if (h.k < ly.N) {
    const int k = h.k;
    const V3 pl = (o + d * h.t) - ld3(sc + ly.s_center + 3 * k);
    s.n = pl * (1.0f / sc[ly.s_radius + k]);
    const float cs = sc[ly.s_cscale + k];
    const float par = mod2(floorf(pl.x * cs) + floorf(pl.y * cs) + floorf(pl.z * cs));
    s.use2 = sc[ly.s_checker + k] * par > 0.5f;
    s.base = ld3(sc + (s.use2 ? ly.s_color2 : ly.s_color) + 3 * k);
    s.ka = sc[ly.s_ka + k];
    s.kd = sc[ly.s_kd + k];
    s.ks = sc[ly.s_ks + k];
    s.shin = sc[ly.s_shin + k];
  } else {
    const int k = h.k - ly.N;
    const V3 eu = ld3(sc + ly.r_eu + 3 * k), ev = ld3(sc + ly.r_ev + 3 * k);
    const V3 nraw = cross(eu, ev);
    const V3 nu = nraw * guarded_inv(dot(nraw, nraw));
    s.n = nu * (dot(nu, d) < 0.0f ? 1.0f : -1.0f);  // two-sided: face the ray
    float a, b;
    hit_rect(o, d, ld3(sc + ly.r_origin + 3 * k), eu, ev, &a, &b);
    const float cs = sc[ly.r_cscale + k];
    s.use2 = sc[ly.r_checker + k] * mod2(floorf(a * cs) + floorf(b * cs)) > 0.5f;
    s.base = ld3(sc + (s.use2 ? ly.r_color2 : ly.r_color) + 3 * k);
    s.ka = sc[ly.r_ka + k];
    s.kd = sc[ly.r_kd + k];
    s.ks = sc[ly.r_ks + k];
    s.shin = sc[ly.r_shin + k];
  }
  return s;
}

struct LightGeo {
  V3 lvec, ldir;
  float dist2, dist, inv;
};

__device__ __forceinline__ LightGeo light_geometry(V3 lpos, V3 so) {
  LightGeo g;
  g.lvec = lpos - so;
  g.dist2 = dot(g.lvec, g.lvec);
  g.dist = sqrtf(g.dist2 > 0.0f ? g.dist2 : 1.0f);
  g.inv = 1.0f / (g.dist > 1e-9f ? g.dist : 1.0f);
  g.ldir = g.lvec * g.inv;
  return g;
}

__device__ __forceinline__ V3 shadow_origin(V3 o, V3 d, float t, V3 n) {
  return (o + d * t) + n * SHADOW_EPS;
}

// Unclipped Phong color of a hit pixel; bit l of *vis is light l's
// visibility (all set when shadows are off).
__device__ __forceinline__ V3 shade_hit(const float* sc, const Layout& ly, const Params& p, V3 o,
                                        V3 d, float t, const Surface& s, unsigned* vis) {
  const V3 amb = ld3(sc + ly.ambient);
  V3 col = {s.base.x * amb.x * s.ka, s.base.y * amb.y * s.ka, s.base.z * amb.z * s.ka};
  const V3 view = -d;
  const V3 so = shadow_origin(o, d, t, s.n);
  unsigned bits = 0;
  for (int l = 0; l < ly.L; ++l) {
    const LightGeo g = light_geometry(ld3(sc + ly.l_pos + 3 * l), so);
    const bool lit = !p.shadows || !occluded(sc, ly, so, g.ldir, g.dist);
    bits |= (lit ? 1u : 0u) << l;
    const float v = lit ? 1.0f : 0.0f;
    const float ndotl = fmaxf(dot(s.n, g.ldir), 0.0f);
    const V3 refl = s.n * (2.0f * ndotl) - g.ldir;
    const float spec = s.ks * safe_pow(fmaxf(dot(refl, view), 0.0f), s.shin);
    const V3 lcol = ld3(sc + ly.l_col + 3 * l);
    col.x += v * (s.kd * ndotl * s.base.x + spec) * lcol.x;
    col.y += v * (s.kd * ndotl * s.base.y + spec) * lcol.y;
    col.z += v * (s.kd * ndotl * s.base.z + spec) * lcol.z;
  }
  *vis = bits;
  return col;
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// Stage the flat scene into shared memory, once per block.
__device__ __forceinline__ void stage_scene(float* sc, const float* __restrict__ flat, int S) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int s = tid; s < S; s += blockDim.x * blockDim.y) sc[s] = flat[s];
}

}  // namespace rrt
