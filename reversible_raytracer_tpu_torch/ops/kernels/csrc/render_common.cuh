// Device code shared by the kernels: the two scene layouts, the per-pixel
// camera ray, sphere and rect intersection, the first-wins nearest-hit
// loop, the any-hit shadow test, Phong shading, the per-pixel forward and
// hand-written adjoint of the fused training steps and the render
// backwards (pixel_step, with the two sources of its cotangent and
// visibility: ResidualSource, CotangentSource), and the reduction and
// camera-chain passes. soft_common.cuh adds the soft-visibility code.
//
// Two layouts of the same scene, read through one interface, so that every
// kernel runs the same arithmetic:
//   - FlatScene: the flat scene vector in models/scene.py leaf order
//     (fused_render.cu, fused_step.cu, scenes of at most 24 objects);
//   - PackedRows: the JAX package's packed rows (fused_vec.py: globals,
//     P_SPH = 17 scalars per sphere, P_RCT = 22 per rect, each group padded
//     to a multiple of 16 rows; the object-chunked and soft kernels), the
//     forwards' sphere rows staged without the mirror column.
//     Rects are numbered from the padded sphere count (ns_pad) in winner
//     space, so a pad row's index never names a real object.
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
constexpr int NWARPS = BLOCK_THREADS / 32;
// Blocks per SM of the flat and vec steps: ptxas keeps a thread in 128 registers.
constexpr int STEP_BLOCKS_PER_SM = 2;
constexpr int CAM_EXTRA = 10;  // g_fwd (3), g_right (3), g_up (3), g_tan
constexpr int SPH_FIELDS = 14;  // center (3), radius, color (3), color2 (3), ka, kd, ks, shin
constexpr int RECT_FIELDS = 19;  // origin, edge_u, edge_v, color, color2 (3 each), ka, kd, ks, shin
constexpr unsigned FULL = 0xffffffffu;

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
__device__ __forceinline__ V3 zero3() { return {0.0f, 0.0f, 0.0f}; }

// ---------------------------------------------------------------------------
// Flat layout
// ---------------------------------------------------------------------------

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

// Reads a flat scene (staged in shared memory).
struct FlatScene {
  const float* sc;
  Layout ly;

  __device__ int n_sph() const { return ly.N; }
  __device__ int n_rect() const { return ly.M; }
  __device__ int n_light() const { return ly.L; }
  __device__ int rect_base() const { return ly.N; }  // winner index of rect 0

  __device__ V3 s_center(int k) const { return ld3(sc + ly.s_center + 3 * k); }
  __device__ float s_radius(int k) const { return sc[ly.s_radius + k]; }
  __device__ V3 s_color(int k, bool second) const {
    return ld3(sc + (second ? ly.s_color2 : ly.s_color) + 3 * k);
  }
  __device__ float s_checker(int k) const { return sc[ly.s_checker + k]; }
  __device__ float s_cscale(int k) const { return sc[ly.s_cscale + k]; }
  __device__ float s_ka(int k) const { return sc[ly.s_ka + k]; }
  __device__ float s_kd(int k) const { return sc[ly.s_kd + k]; }
  __device__ float s_ks(int k) const { return sc[ly.s_ks + k]; }
  __device__ float s_shin(int k) const { return sc[ly.s_shin + k]; }

  __device__ V3 r_origin(int k) const { return ld3(sc + ly.r_origin + 3 * k); }
  __device__ V3 r_eu(int k) const { return ld3(sc + ly.r_eu + 3 * k); }
  __device__ V3 r_ev(int k) const { return ld3(sc + ly.r_ev + 3 * k); }
  __device__ V3 r_color(int k, bool second) const {
    return ld3(sc + (second ? ly.r_color2 : ly.r_color) + 3 * k);
  }
  __device__ float r_checker(int k) const { return sc[ly.r_checker + k]; }
  __device__ float r_cscale(int k) const { return sc[ly.r_cscale + k]; }
  __device__ float r_ka(int k) const { return sc[ly.r_ka + k]; }
  __device__ float r_kd(int k) const { return sc[ly.r_kd + k]; }
  __device__ float r_ks(int k) const { return sc[ly.r_ks + k]; }
  __device__ float r_shin(int k) const { return sc[ly.r_shin + k]; }

  __device__ V3 l_pos(int l) const { return ld3(sc + ly.l_pos + 3 * l); }
  __device__ V3 l_col(int l) const { return ld3(sc + ly.l_col + 3 * l); }
  __device__ V3 ambient() const { return ld3(sc + ly.ambient); }
  __device__ V3 background() const { return ld3(sc + ly.background); }
  __device__ V3 eye() const { return ld3(sc + ly.c_eye); }
  __device__ V3 look() const { return ld3(sc + ly.c_look); }
  __device__ V3 up_hint() const { return ld3(sc + ly.c_up); }
  __device__ float fov() const { return sc[ly.c_fov]; }
};

// ---------------------------------------------------------------------------
// Packed layout (fused_vec.py: pack_spheres, pack_rects, globals_tree)
// ---------------------------------------------------------------------------

constexpr int P_SPH = 17;  // center(3) radius color(3) color2(3) checker cscale ka kd ks shin mirror
constexpr int P_RCT = 22;  // origin(3) edge_u(3) edge_v(3) color(3) color2(3) checker cscale ka kd ks shin mirror

// The flat globals in JAX's dict order: ambient, background, camera (eye,
// look_at, up, fov_deg), env (empty), lights (position, color).
// fused_vec.globals_offsets computes the same.
struct GLayout {
  int L;
  int ambient, background, c_eye, c_look, c_up, c_fov, l_pos, l_col, Sg;
};

inline GLayout make_glayout(int L) {
  return {L, 0, 3, 6, 9, 12, 15, 16, 16 + 3 * L, 16 + 6 * L};
}

// The packed rows as staged in shared memory, PS floats a sphere row: the
// step kernels stage all P_SPH columns, the forwards (FWD_SPH) all but the
// mirror column, which no kernel reads.
template <int PS>
struct PackedRows {
  const float* g;    // Sg globals
  const float* sph;  // ns_pad rows of PS
  const float* rct;  // nr_pad rows of P_RCT
  GLayout gl;
  int N, M, ns_pad;

  __device__ int n_sph() const { return N; }
  __device__ int n_rect() const { return M; }
  __device__ int n_light() const { return gl.L; }
  __device__ int rect_base() const { return ns_pad; }

  __device__ const float* srow(int k) const { return sph + PS * k; }
  __device__ const float* rrow(int k) const { return rct + P_RCT * k; }
  __device__ V3 s_center(int k) const { return ld3(srow(k)); }
  __device__ float s_radius(int k) const { return srow(k)[3]; }
  __device__ V3 s_color(int k, bool second) const { return ld3(srow(k) + (second ? 7 : 4)); }
  __device__ float s_checker(int k) const { return srow(k)[10]; }
  __device__ float s_cscale(int k) const { return srow(k)[11]; }
  __device__ float s_ka(int k) const { return srow(k)[12]; }
  __device__ float s_kd(int k) const { return srow(k)[13]; }
  __device__ float s_ks(int k) const { return srow(k)[14]; }
  __device__ float s_shin(int k) const { return srow(k)[15]; }

  __device__ V3 r_origin(int k) const { return ld3(rrow(k)); }
  __device__ V3 r_eu(int k) const { return ld3(rrow(k) + 3); }
  __device__ V3 r_ev(int k) const { return ld3(rrow(k) + 6); }
  __device__ V3 r_color(int k, bool second) const { return ld3(rrow(k) + (second ? 12 : 9)); }
  __device__ float r_checker(int k) const { return rrow(k)[15]; }
  __device__ float r_cscale(int k) const { return rrow(k)[16]; }
  __device__ float r_ka(int k) const { return rrow(k)[17]; }
  __device__ float r_kd(int k) const { return rrow(k)[18]; }
  __device__ float r_ks(int k) const { return rrow(k)[19]; }
  __device__ float r_shin(int k) const { return rrow(k)[20]; }

  __device__ V3 l_pos(int l) const { return ld3(g + gl.l_pos + 3 * l); }
  __device__ V3 l_col(int l) const { return ld3(g + gl.l_col + 3 * l); }
  __device__ V3 ambient() const { return ld3(g + gl.ambient); }
  __device__ V3 background() const { return ld3(g + gl.background); }
  __device__ V3 eye() const { return ld3(g + gl.c_eye); }
  __device__ V3 look() const { return ld3(g + gl.c_look); }
  __device__ V3 up_hint() const { return ld3(g + gl.c_up); }
  __device__ float fov() const { return g[gl.c_fov]; }
};

using PackedScene = PackedRows<P_SPH>;
constexpr int FWD_SPH = 16;  // a sphere row of the forwards: center .. shininess

// Packed column of field f of the step's per-object gradient (SPH_FIELDS /
// RECT_FIELDS order): the checker and checker-scale columns, which get no
// gradient, are skipped.
__host__ __device__ inline int sph_col(int f) { return f < 10 ? f : f + 2; }
__host__ __device__ inline int rct_col(int f) { return f < 15 ? f : f + 2; }

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

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

template <class S>
__device__ __forceinline__ Camera camera(const S& sc) {
  Camera c;
  c.eye = sc.eye();
  const V3 f_raw = sc.look() - c.eye;
  c.fwd = f_raw * guarded_inv(dot(f_raw, f_raw));
  const V3 r_raw = cross(c.fwd, sc.up_hint());
  c.right = r_raw * guarded_inv(dot(r_raw, r_raw));
  c.up = cross(c.right, c.fwd);
  c.tan_half = tanf(sc.fov() * 0.017453292519943295f * 0.5f);
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

// Winner of the nearest-hit loop: k < 0 misses, k < rect_base() is sphere
// k, else rect k - rect_base().
struct Nearest {
  float t;
  int k;
};

// The rects' part of the nearest loop, after the spheres' h.
template <class S>
__device__ __forceinline__ Nearest trace_rects(const S& sc, V3 o, V3 d, Nearest h) {
  for (int k = 0; k < sc.n_rect(); ++k) {
    float a, b;
    const float t = hit_rect(o, d, sc.r_origin(k), sc.r_eu(k), sc.r_ev(k), &a, &b);
    if (t < h.t) h = {t, sc.rect_base() + k};
  }
  return h;
}

// The t-only nearest loop: one intersection and a compare per object; the
// winner's attributes are evaluated once afterwards (surface).
template <class S>
__device__ __forceinline__ Nearest trace(const S& sc, V3 o, V3 d) {
  Nearest h = {BIG, -1};
  for (int k = 0; k < sc.n_sph(); ++k) {
    const float t = hit_sphere(o, d, sc.s_center(k), sc.s_radius(k));
    if (t < h.t) h = {t, k};
  }
  return trace_rects(sc, o, d, h);
}

// The rects' part of the any-hit loop.
template <class S>
__device__ __forceinline__ bool occluded_rects(const S& sc, V3 o, V3 ldir, float dist) {
  for (int k = 0; k < sc.n_rect(); ++k) {
    float a, b;
    if (hit_rect(o, ldir, sc.r_origin(k), sc.r_eu(k), sc.r_ev(k), &a, &b) < dist) return true;
  }
  return false;
}

// Any-hit toward a light: stops at the first occluder (same boolean).
template <class S>
__device__ __forceinline__ bool occluded(const S& sc, V3 o, V3 ldir, float dist) {
  for (int k = 0; k < sc.n_sph(); ++k)
    if (hit_sphere(o, ldir, sc.s_center(k), sc.s_radius(k)) < dist) return true;
  return occluded_rects(sc, o, ldir, dist);
}

// Shading attributes of the winning object (the trace_nearest defaults on
// a miss).
struct Surface {
  V3 n, base;
  float ka, kd, ks, shin;
  bool use2;  // checker picked color2
};

template <class S>
__device__ __forceinline__ Surface surface(const S& sc, V3 o, V3 d, Nearest h) {
  Surface s = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0.0f, 0.0f, 0.0f, 1.0f, false};
  if (h.k < 0) return s;
  if (h.k < sc.rect_base()) {
    const int k = h.k;
    const V3 pl = (o + d * h.t) - sc.s_center(k);
    s.n = pl * (1.0f / sc.s_radius(k));
    const float cs = sc.s_cscale(k);
    const float par = mod2(floorf(pl.x * cs) + floorf(pl.y * cs) + floorf(pl.z * cs));
    s.use2 = sc.s_checker(k) * par > 0.5f;
    s.base = sc.s_color(k, s.use2);
    s.ka = sc.s_ka(k);
    s.kd = sc.s_kd(k);
    s.ks = sc.s_ks(k);
    s.shin = sc.s_shin(k);
  } else {
    const int k = h.k - sc.rect_base();
    const V3 eu = sc.r_eu(k), ev = sc.r_ev(k);
    const V3 nraw = cross(eu, ev);
    const V3 nu = nraw * guarded_inv(dot(nraw, nraw));
    s.n = nu * (dot(nu, d) < 0.0f ? 1.0f : -1.0f);  // two-sided: face the ray
    float a, b;
    hit_rect(o, d, sc.r_origin(k), eu, ev, &a, &b);
    const float cs = sc.r_cscale(k);
    s.use2 = sc.r_checker(k) * mod2(floorf(a * cs) + floorf(b * cs)) > 0.5f;
    s.base = sc.r_color(k, s.use2);
    s.ka = sc.r_ka(k);
    s.kd = sc.r_kd(k);
    s.ks = sc.r_ks(k);
    s.shin = sc.r_shin(k);
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
// visibility, lit(l, so, g) for the shadow origin so and light geometry g.
template <class S, class Lit>
__device__ __forceinline__ V3 shade_hit(const S& sc, V3 o, V3 d, float t, const Surface& s,
                                        Lit lit_fn, unsigned* vis) {
  const V3 amb = sc.ambient();
  V3 col = {s.base.x * amb.x * s.ka, s.base.y * amb.y * s.ka, s.base.z * amb.z * s.ka};
  const V3 view = -d;
  const V3 so = shadow_origin(o, d, t, s.n);
  unsigned bits = 0;
  for (int l = 0; l < sc.n_light(); ++l) {
    const LightGeo g = light_geometry(sc.l_pos(l), so);
    const bool lit = lit_fn(l, so, g);
    bits |= (lit ? 1u : 0u) << l;
    const float v = lit ? 1.0f : 0.0f;
    const float ndotl = fmaxf(dot(s.n, g.ldir), 0.0f);
    const V3 refl = s.n * (2.0f * ndotl) - g.ldir;
    const float spec = s.ks * safe_pow(fmaxf(dot(refl, view), 0.0f), s.shin);
    const V3 lcol = sc.l_col(l);
    col.x += v * (s.kd * ndotl * s.base.x + spec) * lcol.x;
    col.y += v * (s.kd * ndotl * s.base.y + spec) * lcol.y;
    col.z += v * (s.kd * ndotl * s.base.z + spec) * lcol.z;
  }
  *vis = bits;
  return col;
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// Stage n floats into shared memory, once per block.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int s = tid; s < n; s += blockDim.x * blockDim.y) dst[s] = src[s];
}

// Stage n rows of `from` floats into rows of their first TO columns.
template <int TO>
__device__ __forceinline__ void stage_cols(float* dst, const float* __restrict__ src, int n,
                                           int from) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int s = tid; s < n * TO; s += blockDim.x * blockDim.y)
    dst[s] = src[(s / TO) * from + s % TO];
}

// ---------------------------------------------------------------------------
// The fused step's per-pixel forward and adjoint
// ---------------------------------------------------------------------------

// d max(x, 0) / dx, with the 0.5 tie split of jnp.maximum.
__device__ __forceinline__ float maxgrad(float x) {
  return x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
}

// d clip(x, 0, 1) / dx as jnp.clip takes it: maximum, then minimum.
__device__ __forceinline__ float clipgrad(float x) {
  const float m = fmaxf(x, 0.0f);
  return maxgrad(x) * (m < 1.0f ? 1.0f : (m == 1.0f ? 0.5f : 0.0f));
}

// Cotangent of a, for normalize(a) = a * inv with inv = 1 / sqrt(guarded n2).
__device__ __forceinline__ V3 normalize_adjoint(V3 a, float inv, float n2, V3 g) {
  const float k = n2 > 1e-12f ? dot(g, a) * inv * inv * inv : 0.0f;
  return g * inv - a * k;
}

// Lane 0 gets the warp's sum of v (a fixed shuffle tree).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

// Lane 0 stores the warp's sum of v into slot.
__device__ __forceinline__ void put(float* row, int slot, float v, int lane) {
  v = warp_sum(v);
  if (lane == 0) row[slot] = v;
}

__device__ __forceinline__ void put3(float* row, int slot, V3 v, int lane) {
  put(row, slot, v.x, lane);
  put(row, slot + 1, v.y, lane);
  put(row, slot + 2, v.z, lane);
}

// Lane 0 adds the warp's sum of v to slot (a row that sums several layers
// or tiles).
__device__ __forceinline__ void add(float* row, int slot, float v, int lane) {
  v = warp_sum(v);
  if (lane == 0) row[slot] += v;
}

__device__ __forceinline__ void add3(float* row, int slot, V3 v, int lane) {
  add(row, slot, v.x, lane);
  add(row, slot + 1, v.y, lane);
  add(row, slot + 2, v.z, lane);
}

// Where pixel_step's image cotangent and light visibility come from.
//
// ResidualSource, the fused training steps: the cotangent of the clipped
// image is 2 w (render - target), zero outside the image (the TPU padding
// mask), and the squared residual feeds the loss; a light's visibility is
// the any-hit test of a shadow ray, occ() (the walk's).
struct ResidualSource {
  static constexpr bool casts_shadows = true;
  const float* target;  // (H, W, 3)
  float w;

  __device__ __forceinline__ V3 cotangent(const Params& p, int i, int j, bool inside, V3 img,
                                          float* sq) const {
    V3 res = zero3();
    if (inside) {
      const float* tp = target + 3 * ((long long)i * p.W + j);
      res = {img.x - tp[0], img.y - tp[1], img.z - tp[2]};
    }
    *sq = res.x * res.x + res.y * res.y + res.z * res.z;
    return res * (2.0f * w);
  }

  template <class Occ>
  __device__ __forceinline__ bool lit(const Params& p, int, int, int, Occ occ) const {
    return !p.shadows || !occ();
  }
};

// CotangentSource, the render backwards: the caller's cotangent of the
// clipped image (zero outside the image) and no loss; a light's visibility
// is the forward's saved plane. lit() runs only where the ray hit (on a
// miss the forward kernels' planes hold 0 and the plain versions' the test
// of a ray from the BIG sentinel), and not at all without shadows, when
// there are no planes.
struct CotangentSource {
  static constexpr bool casts_shadows = false;
  const float* g_img;  // (H, W, 3)
  const float* vis;    // (n_vis, H, W); unused by the soft backward

  __device__ __forceinline__ V3 cotangent(const Params& p, int i, int j, bool inside, V3,
                                          float* sq) const {
    *sq = 0.0f;
    return inside ? ld3(g_img + 3 * ((long long)i * p.W + j)) : zero3();
  }

  template <class Occ>
  __device__ __forceinline__ bool lit(const Params& p, int i, int j, int l, Occ) const {
    return !p.shadows || vis[((long long)l * p.H + i) * p.W + j] != 0.0f;
  }
};

// How pixel_step walks the objects. FullWalk, the small-scene step and
// render backward (flat_step.cuh): every object for the primary ray and for
// each shadow ray. vec_step.cuh's WarpCull walks the candidates of per-warp
// culls (cull.cuh) instead, and casts its warp-wide votes in shadows(),
// which pixel_step calls from every lane before it branches on the hit.
struct FullWalk {
  template <class S>
  __device__ __forceinline__ Nearest trace(const S& sc, V3 o, V3 d, bool inside) const {
    return inside ? rrt::trace(sc, o, d) : Nearest{BIG, -1};
  }
  template <class S, class Src>
  __device__ __forceinline__ void shadows(const S&, const Params&, const Src&, V3, bool) const {}
  template <class S>
  __device__ __forceinline__ bool occluded(const S& sc, int, V3 so, const LightGeo& g) const {
    return rrt::occluded(sc, so, g.ldir, g.dist);
  }
};

// What one pixel adds to the gradient. The camera part is kept as the
// cotangents of its linear ray form dt = fwd + right sx + up sy (g_dt, with
// sx, sy to scale it, and g_tan of tan(fov/2)); camera_chain pulls their
// sums back to the camera leaves once per step.
struct PixelGrad {
  float sq;
  V3 g_amb, g_bg, g_eye, g_dt;
  float sx, sy, g_tan;
  int k;                   // the winner (rect_base() space), -1 on a miss
  float obj[RECT_FIELDS];  // its gradient, SPH_FIELDS or RECT_FIELDS order
};

// Forward (its objects walked as walk walks them), the image cotangent from
// src (ResidualSource: the residual against the target; CotangentSource:
// the caller's) and the hand-written adjoint of pixel (i, j): shade adjoint,
// then the adjoint of the winning object only (the where chain passes no
// gradient to the losers, and visibility is a step with zero gradient,
// though the shadow origin still carries gradient through light_geometry
// into t, n and d), then the camera. Light l's position and color gradients
// go to on_light(l, g_lpos, g_lcol, warp_hit) inside the light loop, which
// every lane of a warp runs together. Lanes outside the image run every step
// with zero cotangents: the warp-wide shuffles and votes need all 32.
template <class S, class Src, class Walk, class OnLight>
__device__ __forceinline__ PixelGrad pixel_step(const S& sc, const Params& p, int i, int j,
                                                bool inside, const Src& src, const Walk& walk,
                                                OnLight on_light) {
  PixelGrad out;
  // ---- forward
  const Camera cam = camera(sc);
  const Ray r = primary_ray(cam, p, inside ? i : 0, inside ? j : 0);
  const V3 o = cam.eye, d = r.d;
  const Nearest h = walk.trace(sc, o, d, inside);
  const bool hit = h.k >= 0;
  const Surface s = surface(sc, o, d, h);
  walk.shadows(sc, p, src, shadow_origin(o, d, h.t, s.n), hit);
  unsigned bits = 0;
  V3 pre = sc.background();
  if (hit)
    pre = shade_hit(
        sc, o, d, h.t, s,
        [&](int l, V3 so, const LightGeo& g) {
          return src.lit(p, i, j, l, [&] { return walk.occluded(sc, l, so, g); });
        },
        &bits);
  const V3 img = p.clip ? V3{clip01(pre.x), clip01(pre.y), clip01(pre.z)} : pre;

  // ---- the clipped image's cotangent, then the clip's
  V3 gc = src.cotangent(p, i, j, inside, img, &out.sq);
  if (p.clip) gc = {gc.x * clipgrad(pre.x), gc.y * clipgrad(pre.y), gc.z * clipgrad(pre.z)};

  // ---- shade adjoint: ambient term, then light by light
  const V3 gh = hit ? gc : zero3();
  out.g_bg = hit ? zero3() : gc;
  const V3 amb = sc.ambient();
  V3 g_base = {gh.x * amb.x * s.ka, gh.y * amb.y * s.ka, gh.z * amb.z * s.ka};
  out.g_amb = {gh.x * s.base.x * s.ka, gh.y * s.base.y * s.ka, gh.z * s.base.z * s.ka};
  const float g_ka = gh.x * s.base.x * amb.x + gh.y * s.base.y * amb.y + gh.z * s.base.z * amb.z;
  float g_kd = 0.0f, g_ks = 0.0f, g_shin = 0.0f;
  V3 g_n = zero3(), g_d = zero3(), g_so = zero3();
  const V3 view = -d;
  const V3 so = shadow_origin(o, d, h.t, s.n);
  const bool warp_hit = __any_sync(FULL, hit);
  for (int l = 0; l < sc.n_light(); ++l) {
    V3 g_lpos = zero3(), g_lcol = zero3();
    if (hit && ((bits >> l) & 1u)) {  // a shadowed light contributes nothing
      const LightGeo g = light_geometry(sc.l_pos(l), so);
      const V3 lcol = sc.l_col(l);
      const float ndl = dot(s.n, g.ldir);
      const float ndotl = fmaxf(ndl, 0.0f);
      const V3 refl = s.n * (2.0f * ndotl) - g.ldir;
      const float rdv = dot(refl, view);
      const float rdotv = fmaxf(rdv, 0.0f);
      const float pw = safe_pow(rdotv, s.shin);
      const float spec = s.ks * pw;
      const V3 q = {s.kd * ndotl * s.base.x + spec, s.kd * ndotl * s.base.y + spec,
                    s.kd * ndotl * s.base.z + spec};
      g_lcol = {gh.x * q.x, gh.y * q.y, gh.z * q.z};
      const V3 g_q = {gh.x * lcol.x, gh.y * lcol.y, gh.z * lcol.z};
      const float g_spec = g_q.x + g_q.y + g_q.z;
      g_kd += g_q.x * ndotl * s.base.x + g_q.y * ndotl * s.base.y + g_q.z * ndotl * s.base.z;
      float g_ndotl = g_q.x * s.kd * s.base.x + g_q.y * s.kd * s.base.y + g_q.z * s.kd * s.base.z;
      g_base = g_base + g_q * (s.kd * ndotl);
      g_ks += g_spec * pw;
      const float g_pw = g_spec * s.ks;
      float g_rdotv = 0.0f;
      if (rdotv > 0.0f) {  // safe_pow: exp(shin * log x), no gradient at x <= 0
        g_rdotv = g_pw * pw * s.shin / rdotv;
        g_shin += g_pw * pw * logf(rdotv);
      }
      const float g_rdv = g_rdotv * maxgrad(rdv);
      const V3 g_refl = view * g_rdv;
      g_d = g_d - refl * g_rdv;
      g_n = g_n + g_refl * (2.0f * ndotl);
      g_ndotl += 2.0f * dot(g_refl, s.n);
      const float g_ndl = g_ndotl * maxgrad(ndl);
      g_n = g_n + g.ldir * g_ndl;
      const V3 g_ldir = s.n * g_ndl - g_refl;
      // ldir = lvec / guarded(dist), dist = guarded sqrt(|lvec|^2)
      V3 g_lvec = g_ldir * g.inv;
      const float g_inv = dot(g_ldir, g.lvec);
      const float g_dist = g.dist > 1e-9f ? -g_inv * g.inv * g.inv : 0.0f;
      const float g_dist2 = g.dist2 > 0.0f ? g_dist * 0.5f / g.dist : 0.0f;
      g_lvec = g_lvec + g.lvec * (2.0f * g_dist2);
      g_lpos = g_lvec;
      g_so = g_so - g_lvec;
    }
    on_light(l, g_lpos, g_lcol, warp_hit);
  }
  // shadow origin so = (o + d t) + n SHADOW_EPS
  V3 g_o = g_so;
  g_d = g_d + g_so * h.t;
  const float g_t = dot(g_so, d);
  g_n = g_n + g_so * SHADOW_EPS;

  // ---- the winning object's adjoint
#pragma unroll
  for (int f = 0; f < RECT_FIELDS; ++f) out.obj[f] = 0.0f;
  const V3 g_col = s.use2 ? zero3() : g_base;
  const V3 g_col2 = s.use2 ? g_base : zero3();
  if (hit && h.k < sc.rect_base()) {
    // n = (o + d t - c) / r;  t = -b - sqrt(b^2 - |oc|^2 + r^2), b = oc . d
    const int k = h.k;
    const V3 c = sc.s_center(k);
    const float rad = sc.s_radius(k);
    const float inv_r = 1.0f / rad;
    const V3 pl = (o + d * h.t) - c;
    const V3 g_pl = g_n * inv_r;
    float g_r = -dot(g_n, pl) * inv_r * inv_r;
    g_o = g_o + g_pl;
    g_d = g_d + g_pl * h.t;
    const float g_ts = g_t + dot(g_pl, d);
    V3 g_c = -g_pl;
    const V3 oc = o - c;
    const float b = dot(oc, d);
    const float disc = b * b - (dot(oc, oc) - rad * rad);  // > 0 on a hit
    const float g_disc = -g_ts * 0.5f / sqrtf(disc);
    const float g_b = -g_ts + g_disc * 2.0f * b;
    const float g_cc = -g_disc;
    const V3 g_oc = oc * (2.0f * g_cc) + d * g_b;
    g_r -= g_cc * 2.0f * rad;
    g_d = g_d + oc * g_b;
    g_o = g_o + g_oc;
    g_c = g_c - g_oc;
    out.obj[0] = g_c.x;
    out.obj[1] = g_c.y;
    out.obj[2] = g_c.z;
    out.obj[3] = g_r;
    out.obj[4] = g_col.x;
    out.obj[5] = g_col.y;
    out.obj[6] = g_col.z;
    out.obj[7] = g_col2.x;
    out.obj[8] = g_col2.y;
    out.obj[9] = g_col2.z;
    out.obj[10] = g_ka;
    out.obj[11] = g_kd;
    out.obj[12] = g_ks;
    out.obj[13] = g_shin;
  } else if (hit) {
    // t = ((p0 - o) . nraw) / (d . nraw), n = facing * normalize(nraw),
    // nraw = edge_u x edge_v; facing is a sign with no gradient.
    const int k = h.k - sc.rect_base();
    const V3 p0 = sc.r_origin(k);
    const V3 eu = sc.r_eu(k), ev = sc.r_ev(k);
    const V3 nraw = cross(eu, ev);
    const float nn2 = dot(nraw, nraw);
    const float inv_n = guarded_inv(nn2);
    const float facing = dot(nraw * inv_n, d) < 0.0f ? 1.0f : -1.0f;
    const float denom = dot(d, nraw);
    const V3 p0o = p0 - o;
    const float num = dot(p0o, nraw);
    const float g_num = g_t / denom;
    const float g_den = -g_t * num / (denom * denom);
    const V3 g_p0 = nraw * g_num;
    g_o = g_o - g_p0;
    g_d = g_d + nraw * g_den;
    const V3 g_nraw =
        p0o * g_num + d * g_den + normalize_adjoint(nraw, inv_n, nn2, g_n * facing);
    const V3 g_eu = cross(ev, g_nraw);
    const V3 g_ev = cross(g_nraw, eu);
    out.obj[0] = g_p0.x;
    out.obj[1] = g_p0.y;
    out.obj[2] = g_p0.z;
    out.obj[3] = g_eu.x;
    out.obj[4] = g_eu.y;
    out.obj[5] = g_eu.z;
    out.obj[6] = g_ev.x;
    out.obj[7] = g_ev.y;
    out.obj[8] = g_ev.z;
    out.obj[9] = g_col.x;
    out.obj[10] = g_col.y;
    out.obj[11] = g_col.z;
    out.obj[12] = g_col2.x;
    out.obj[13] = g_col2.y;
    out.obj[14] = g_col2.z;
    out.obj[15] = g_ka;
    out.obj[16] = g_kd;
    out.obj[17] = g_ks;
    out.obj[18] = g_shin;
  }

  // ---- camera: o = eye, d = normalize(dt), dt = fwd + right sx + up sy
  out.g_dt = hit ? normalize_adjoint(r.dt, r.inv, r.n2, g_d) : zero3();
  out.g_tan = dot(out.g_dt, cam.right) * r.ax * p.aspect + dot(out.g_dt, cam.up) * r.ay;
  out.g_eye = hit ? g_o : zero3();
  out.sx = r.sx;
  out.sy = r.sy;
  out.k = h.k;
  return out;
}

// The camera chain, once per step: pull the summed ray-form cotangents gx =
// [g_fwd (3), g_right (3), g_up (3), g_tan] back through up = right x fwd,
// right = normalize(fwd x up_hint), fwd = normalize(look_at - eye) and
// tan_half = tan(fov * pi/180 * 0.5), and add them to the gradients of eye,
// look_at, up and fov_deg (at g + the given slots).
__device__ __forceinline__ void camera_chain(const float* __restrict__ gx, V3 eye, V3 look,
                                             V3 uph, float fov, float* g, int s_eye,
                                             int s_look, int s_up, int s_fov) {
  V3 G_fwd = ld3(gx), G_right = ld3(gx + 3);
  const V3 G_up = ld3(gx + 6);
  const float G_tan = gx[9];
  const V3 f_raw = look - eye;
  const float n2f = dot(f_raw, f_raw);
  const float invf = guarded_inv(n2f);
  const V3 fwd = f_raw * invf;
  const V3 r_raw = cross(fwd, uph);
  const float n2r = dot(r_raw, r_raw);
  const float invr = guarded_inv(n2r);
  const V3 right = r_raw * invr;
  G_right = G_right + cross(fwd, G_up);
  G_fwd = G_fwd + cross(G_up, right);
  const V3 g_rraw = normalize_adjoint(r_raw, invr, n2r, G_right);
  G_fwd = G_fwd + cross(uph, g_rraw);
  const V3 g_uph = cross(g_rraw, fwd);
  const V3 g_fraw = normalize_adjoint(f_raw, invf, n2f, G_fwd);
  const float deg = 0.017453292519943295f;
  const float th = tanf(fov * deg * 0.5f);
  g[s_eye + 0] -= g_fraw.x;
  g[s_eye + 1] -= g_fraw.y;
  g[s_eye + 2] -= g_fraw.z;
  g[s_look + 0] += g_fraw.x;
  g[s_look + 1] += g_fraw.y;
  g[s_look + 2] += g_fraw.z;
  g[s_up + 0] += g_uph.x;
  g[s_up + 1] += g_uph.y;
  g[s_up + 2] += g_uph.z;
  g[s_fov] += G_tan * (1.0f + th * th) * 0.5f * deg;
}

// rowsum[s] = sum over the step's per-block partial rows, in a fixed
// order. Block (32, RY): 32 slots, RY interleaved row subsets added in
// order at the end.
template <int RY>
__global__ void reduce_rows_kernel(const float* __restrict__ partials, int nrows, int ROW,
                                   float* __restrict__ rowsum) {
  __shared__ float acc[RY][32];
  const int slot = blockIdx.x * 32 + threadIdx.x;
  float a = 0.0f;
  if (slot < ROW)
    for (int b = threadIdx.y; b < nrows; b += RY) a += partials[(long long)b * ROW + slot];
  acc[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && slot < ROW) {
    float t = 0.0f;
    for (int y = 0; y < RY; ++y) t += acc[y][threadIdx.x];
    rowsum[slot] = t;
  }
}

// out = [sq, dglob (Sg), dsph (ns_pad x P_SPH), drct (nr_pad x P_RCT)];
// then the camera chain, once.
__global__ void vec_finalize_kernel(const float* __restrict__ rowsum,
                                    const float* __restrict__ glob, GLayout gl, int OROW,
                                    float* __restrict__ out) {
  const int GROW = 1 + gl.Sg + CAM_EXTRA;
  for (int s = threadIdx.x; s < 1 + gl.Sg; s += blockDim.x) out[s] = rowsum[s];
  for (int s = threadIdx.x; s < OROW; s += blockDim.x) out[1 + gl.Sg + s] = rowsum[GROW + s];
  __syncthreads();
  if (threadIdx.x != 0) return;
  camera_chain(rowsum + 1 + gl.Sg, ld3(glob + gl.c_eye), ld3(glob + gl.c_look),
               ld3(glob + gl.c_up), glob[gl.c_fov], out + 1, gl.c_eye, gl.c_look, gl.c_up,
               gl.c_fov);
}

// Rows of a packed group after padding (one dummy chunk for an empty group).
inline int pad16(int n) { return ((n > 1 ? n : 1) + 15) / 16 * 16; }

__host__ __device__ inline dim3 pixel_grid(int H, int W) {
  return dim3((W + BLOCK_X - 1) / BLOCK_X, (H + BLOCK_Y - 1) / BLOCK_Y);
}

// The grid of the flat and vec steps: the blocks of smem bytes that the
// current card holds at once (its SM count times STEP_BLOCKS_PER_SM, fewer
// where shared memory allows fewer), never more than the image has tiles;
// 0 if the card cannot be queried.
inline int step_blocks(size_t smem, int H, int W) {
  int dev = 0, sms = 0, smem_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
          cudaSuccess)
    return 0;
  const long long by_smem = smem_sm / ((long long)smem + 1024);  // 1 KB reserved a block
  const int per_sm = by_smem < 1 ? 1 : by_smem < STEP_BLOCKS_PER_SM ? (int)by_smem
                                                                     : STEP_BLOCKS_PER_SM;
  const dim3 tiles = pixel_grid(H, W);
  const long long n = (long long)tiles.x * tiles.y;
  return (int)(n < (long long)sms * per_sm ? n : (long long)sms * per_sm);
}

// The grid of the forwards: as many blocks of `kernel` with smem bytes of
// dynamic shared memory as the current card holds at once (its SM count
// times the occupancy calculator's blocks per SM), never more than the image
// has tiles; 0 if the card cannot be queried or a block does not fit.
template <class K>
inline int resident_blocks(K kernel, size_t smem, int H, int W) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK_THREADS, smem) !=
          cudaSuccess)
    return 0;
  const dim3 tiles = pixel_grid(H, W);
  const long long n = (long long)tiles.x * tiles.y;
  return (int)(n < (long long)sms * per_sm ? n : (long long)sms * per_sm);
}

}  // namespace rrt
