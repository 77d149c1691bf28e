// Device code shared by the kernels: the two scene layouts, the per-pixel
// camera ray, sphere and rect intersection, the first-wins nearest-hit
// loop, the any-hit shadow test, Phong shading, the per-pixel forward and
// hand-written adjoint of the fused training steps and the render
// backwards (pixel_step, with the two sources of its cotangent and
// visibility: ResidualSource, CotangentSource; pixel_grads, its loop over
// the subsamples of spp 4, with any of the below; with REFL, one mirror
// bounce level or more; with a TexFlatScene, object textures and the environment
// map; with a
// PackedEnvRows, the environment map; with a PackedTexRows, both, the
// object grids read from global memory), the texel records' scatter, and the
// reduction and camera-chain passes. soft_common.cuh adds the
// soft-visibility code.
//
// Two layouts of the same scene, read through one interface, so that every
// kernel runs the same arithmetic:
//   - FlatScene: the flat scene vector in models/scene.py leaf order
//     (fused_render.cu, fused_step.cu, scenes of at most 24 objects), and
//     TexFlatScene, the same with texel grids (the TEX instances);
//   - PackedRows: the JAX package's packed rows (fused_vec.py: globals,
//     P_SPH = 17 scalars per sphere, P_RCT = 22 per rect, each group padded
//     to a multiple of 16 rows; the object-chunked and soft kernels), the
//     forwards' sphere rows staged without the mirror column but where a
//     bounce reads it; and PackedEnvRows, the same with the environment map
//     ending the globals (make_env_glayout), and PackedTexRows, that with
//     the object texel grids beside it in global memory.
//     Rects are numbered from the padded sphere count (ns_pad) in winner
//     space, so a pad row's index never names a real object.
//
// Semantics follow reversible_raytracer_tpu/ops/pipeline.py (hard shading,
// spp 1 or 4, perspective camera, at most MAX_REFL mirror bounces; untextured
// objects and a flat background, or the texel grids of a TexFlatScene, a
// PackedEnvRows or a PackedTexRows, at either spp and bounce count):
//   - BIG, T_EPS and SHADOW_EPS as there;
//   - nearest hit on strict <, spheres before rects, so ties go to the
//     earlier object;
//   - the guarded sqrt and normalize (sqrt(1) on the dead branch);
//   - safe_pow(x, p) = exp(p * log x), zero at x <= 0 (its exponent capped
//     at POW_LOG_MAX, where the JAX package's overflows; see safe_pow).
// Compiled without --use_fast_math (sqrtf, division, expf and logf stay
// IEEE) and with --fmad=false, and the guarded normalize uses rsqrtf as
// torch.rsqrt does on the card: the forward rounds op for op like the eager
// plain version, so no silhouette pixel changes hit between the two.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

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
// Blocks an SM of the step instances with bounce levels (flat_step.cuh,
// vec_step.cuh): the bounce's adjoint does not fit 128 registers.
constexpr int REFL_STEP_BLOCKS_PER_SM = 1;
// The most bounce levels an instance takes (fused.MAX_REFLECTIONS): a spp-4
// step keeps a subsample's (1 + REFL) L shadow bits in one 64-bit word, at
// most 16 lights a level.
constexpr int MAX_REFL = 3;

template <int REFL>
constexpr int step_blocks_per_sm() {
  return REFL ? REFL_STEP_BLOCKS_PER_SM : STEP_BLOCKS_PER_SM;
}

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
// models/scene.py (the JAX treedef order) for N spheres, M rects and L
// lights, untextured and with no environment map (make_tex_layout shifts it
// by the texel grids). Python's fused.flat_offsets computes the same table
// and checks S.
struct Layout {
  int N, M, L;
  int s_center, s_radius, s_color, s_color2, s_checker, s_cscale, s_ka, s_kd, s_ks, s_shin;
  int r_origin, r_eu, r_ev, r_color, r_color2, r_checker, r_cscale, r_ka, r_kd, r_ks, r_shin;
  int l_pos, l_col;
  int c_eye, c_look, c_up, c_fov;
  int ambient, background;
  int S;
};

inline Layout make_layout(int N, int M, int L, int ds = 0, int dr = 0, int de = 0) {
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
  ly.s_shin = 15 * N;  // then mirror (N), texture (ds floats)
  const int R = 17 * N + ds;
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
  ly.r_shin = R + 20 * M;  // then mirror (M), texture (dr floats)
  const int Lb = R + 22 * M + dr;
  ly.l_pos = Lb;
  ly.l_col = Lb + 3 * L;
  const int C = Lb + 6 * L;
  ly.c_eye = C;
  ly.c_look = C + 3;
  ly.c_up = C + 6;
  ly.c_fov = C + 9;
  ly.ambient = C + 10;
  ly.background = C + 13;
  ly.S = C + 16 + de;  // env (de floats) ends the vector
  return ly;
}

// The layout of a scene with texel grids (the TEX instances): each group's
// (n, K, K, 3) texture follows its mirror leaf and shifts what comes after
// it, and the (Ke, Ke, 3) environment map ends the vector. Ks, Kr, Ke are
// the grids' sides, 0 for none; s_tex, r_tex, env their starts.
struct TexLayout : Layout {
  int Ks, Kr, Ke;
  int s_tex, r_tex, env;
};

inline TexLayout make_tex_layout(int N, int M, int L, int Ks, int Kr, int Ke) {
  TexLayout t;
  static_cast<Layout&>(t) = make_layout(N, M, L, 3 * N * Ks * Ks, 3 * M * Kr * Kr, 3 * Ke * Ke);
  t.Ks = Ks;
  t.Kr = Kr;
  t.Ke = Ke;
  t.s_tex = 17 * N;
  t.r_tex = t.r_shin + 2 * M;  // after the rects' shininess and mirror leaves
  t.env = t.background + 3;
  return t;
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
  __device__ float s_mirror(int k) const { return sc[ly.s_shin + ly.N + k]; }  // after shin

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
  __device__ float r_mirror(int k) const { return sc[ly.r_shin + ly.M + k]; }  // after shin

  __device__ V3 l_pos(int l) const { return ld3(sc + ly.l_pos + 3 * l); }
  __device__ V3 l_col(int l) const { return ld3(sc + ly.l_col + 3 * l); }
  __device__ V3 ambient() const { return ld3(sc + ly.ambient); }
  __device__ V3 background() const { return ld3(sc + ly.background); }
  __device__ V3 eye() const { return ld3(sc + ly.c_eye); }
  __device__ V3 look() const { return ld3(sc + ly.c_look); }
  __device__ V3 up_hint() const { return ld3(sc + ly.c_up); }
  __device__ float fov() const { return sc[ly.c_fov]; }
};

// A flat scene with texel grids: FlatScene's reads of the shifted layout,
// and each grid's texels (row-major (K, K, 3)).
struct TexFlatScene : FlatScene {
  int Ks, Kr, Ke, s_tex, r_tex, env;

  __device__ const float* s_texels(int k) const { return sc + s_tex + 3 * Ks * Ks * k; }
  __device__ const float* r_texels(int k) const { return sc + r_tex + 3 * Kr * Kr * k; }
  __device__ const float* env_texels() const { return sc + env; }
};

// The scene as a kernel reads it from its staged copy sc.
__device__ __forceinline__ FlatScene scene_view(const float* sc, const Layout& ly) {
  return FlatScene{sc, ly};
}
__device__ __forceinline__ TexFlatScene scene_view(const float* sc, const TexLayout& tl) {
  return TexFlatScene{{sc, tl}, tl.Ks, tl.Kr, tl.Ke, tl.s_tex, tl.r_tex, tl.env};
}

// Does a scene type carry texel grids? Only TexFlatScene's code samples them.
template <class S>
struct Textured : std::false_type {};
template <>
struct Textured<TexFlatScene> : std::true_type {};

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

// The globals of a scene with an environment map: GLayout's, then the
// (Ke, Ke, 3) map from slot env, counted in Sg (fused_vec.globals_offsets
// with ke). A type of its own, so that the kernels without one keep their
// parameters.
struct EnvGLayout : GLayout {
  int env, Ke;
};

inline EnvGLayout make_env_glayout(int L, int Ke) {
  EnvGLayout e;
  static_cast<GLayout&>(e) = make_glayout(L);
  e.env = e.Sg;
  e.Ke = Ke;
  e.Sg += 3 * Ke * Ke;
  return e;
}

// The globals layout of a kernel instance with (ENV) or without an
// environment map of side Ke.
template <bool ENV>
using GLayoutOf = typename std::conditional<ENV, EnvGLayout, GLayout>::type;

template <bool ENV>
inline GLayoutOf<ENV> globals_layout(int L, int Ke) {
  if constexpr (ENV)
    return make_env_glayout(L, Ke);
  else
    return make_glayout(L);
}

// The packed rows as staged in shared memory, PS floats a sphere row: the
// step kernels stage all P_SPH columns, the forwards (FWD_SPH) all but the
// mirror column, which only a bounce reads (the forwards' REFL instances
// stage P_SPH).
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
  __device__ float s_mirror(int k) const { return srow(k)[16]; }  // rows of P_SPH only

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
  __device__ float r_mirror(int k) const { return rrow(k)[21]; }

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

// Packed rows whose globals end with the environment map: Ke its side, env
// its first slot in the globals (where a texel record of it points).
template <int PS>
struct PackedEnvRows : PackedRows<PS> {
  int Ke, env;

  __device__ const float* env_texels() const { return this->g + env; }
};

using PackedEnvScene = PackedEnvRows<P_SPH>;

// The object texel grids of rows 4-6's textured instances: the spheres'
// (N, Ks, Ks, 3) and the rects' (M, Kr, Kr, 3), row-major, in global memory
// (sides 0 for none).
struct TexGrids {
  const float* stex;
  const float* rtex;
  int Ks, Kr;
};

// Packed rows (the globals ending with the environment map, Ke 0 for none)
// and object texel grids read from global memory: 64 globes at Ks = 16 are
// 192 KiB of texels, which a block's shared memory cannot hold beside their
// gradient. A texel record's base counts in the block's texel row, the
// spheres' grids from s_tex = 0, then the rects' from r_tex.
template <int PS>
struct PackedTexRows : PackedEnvRows<PS> {
  const float* stex;
  const float* rtex;
  int Ks, Kr, s_tex, r_tex;

  __device__ const float* s_texels(int k) const { return stex + 3 * Ks * Ks * k; }
  __device__ const float* r_texels(int k) const { return rtex + 3 * Kr * Kr * k; }
};

using PackedTexScene = PackedTexRows<P_SPH>;

template <int PS>
__device__ __forceinline__ PackedTexRows<PS> tex_view(const PackedEnvRows<PS>& sc,
                                                      const TexGrids& tg) {
  return {sc, tg.stex, tg.rtex, tg.Ks, tg.Kr, 0, 3 * tg.Ks * tg.Ks * sc.N};
}

template <int PS>
struct Textured<PackedTexRows<PS>> : std::true_type {};

// Does a scene type give each bounce level's textured winner a texel record
// of its own (PackedTexRows; a TexFlatScene's pixel has one record at most)?
template <class S>
struct ObjTexRows : std::false_type {};
template <int PS>
struct ObjTexRows<PackedTexRows<PS>> : std::true_type {};

// The packed scene over the staged globals g and rows: PackedRows for
// GLayout's globals, PackedEnvRows for EnvGLayout's.
template <int PS>
__device__ __forceinline__ PackedRows<PS> packed_view(const float* g, const float* sph,
                                                      const float* rct, const GLayout& gl, int N,
                                                      int M, int ns_pad) {
  return {g, sph, rct, gl, N, M, ns_pad};
}
template <int PS>
__device__ __forceinline__ PackedEnvRows<PS> packed_view(const float* g, const float* sph,
                                                         const float* rct, const EnvGLayout& gl,
                                                         int N, int M, int ns_pad) {
  return {{g, sph, rct, gl, N, M, ns_pad}, gl.Ke, gl.env};
}

// Does a scene type carry an environment map (sampled at misses, its
// gradient scattered as texel records)? TexFlatScene's (when Ke > 0) and
// PackedEnvRows'.
template <class S>
struct HasEnv : Textured<S> {};
template <int PS>
struct HasEnv<PackedEnvRows<PS>> : std::true_type {};

// Packed column of field f of the step's per-object gradient (SPH_FIELDS /
// RECT_FIELDS order): the checker and checker-scale columns, which get no
// gradient, are skipped; field SPH_FIELDS (RECT_FIELDS), a bounce's mirror
// coefficient, is the last column.
__host__ __device__ inline int sph_col(int f) { return f < 10 ? f : f + 2; }
__host__ __device__ inline int rct_col(int f) { return f < 15 ? f : f + 2; }

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Launch constants. A launch covers a row band: H whole image rows from
// image row row0 (the whole image: row0 0 and H its height), W columns; every
// extent, plane and pixel index of a launch is the band's, and only the ray
// of local row i is that of image row i + row0 (the TPU kernels' ii = row0 +
// iota, fused_vec.py:883-886). The pixel-grid factors are the whole image's,
// rounded once on the host like the Python floats 2.0 / W, 2.0 / H and W / H
// of camera_rays. (oi, oj) is the subsample's offset from the pixel centre in
// rows and columns: 0 at spp 1; a launch of one subsample of spp 4 (rows 4,
// 5, 7, 8) takes it from the host, a kernel that loops over the subsamples
// sets it (subsample).
struct Params {
  int H, W, shadows, clip, row0;
  float two_over_w, two_over_h, aspect;
  float oi, oj;
};

// The band of H rows from image row row0 of an image_h-row image.
inline Params band_params(int H, int W, int shadows, int clip, int row0, int image_h,
                          float oi = 0.0f, float oj = 0.0f) {
  return {H, W, shadows, clip, row0, (float)(2.0 / W), (float)(2.0 / image_h),
          (float)((double)W / image_h), oi, oj};
}

// The whole image.
inline Params make_params(int H, int W, int shadows, int clip, float oi = 0.0f,
                          float oj = 0.0f) {
  return band_params(H, W, shadows, clip, 0, H, oi, oj);
}

// A band entry's arguments: row0 in [0, image_h - H], H >= 1.
inline bool band_ok(int H, int row0, int image_h) {
  return H >= 1 && row0 >= 0 && row0 <= image_h - H;
}

// Subsample s of spp 4, the 2x2 grid of pipeline.py's SPP_OFFSETS: (row,
// column) offsets (-0.25, -0.25), (-0.25, 0.25), (0.25, -0.25), (0.25, 0.25)
// for s = 0..3, the order in which the average sums them. Quarters are exact
// in float32.
__host__ __device__ __forceinline__ Params subsample(Params p, int s) {
  p.oi = (s & 2) ? 0.25f : -0.25f;
  p.oj = (s & 1) ? 0.25f : -0.25f;
  return p;
}

// rsqrt of the vnormalize guard: rsqrt(n2 > 1e-12 ? n2 : 1).
__device__ __forceinline__ float guarded_inv(float n2) {
  return rsqrtf(n2 > 1e-12f ? n2 : 1.0f);
}

// safe_pow's exponent p log x is capped at POW_LOG_MAX (x^p <= e^64, about
// 6e27). Of unit vectors the Phong term's x is at most 1 and the cap never
// binds; past a near-tangent hit a bounce level's normal and reflected ray
// lose their unit length, x^p can overflow, and the adjoint's zero cotangent
// (the clip's) times that infinity would be NaN.
constexpr float POW_LOG_MAX = 64.0f;

__device__ __forceinline__ float safe_pow(float x, float p) {
  if (!(x > 0.0f)) return 0.0f;
  const float z = p * logf(x);
  return expf(z < POW_LOG_MAX ? z : POW_LOG_MAX);
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

// Perspective primary ray of the band's pixel (i, j) at the subsample offset
// (p.oi, p.oj): d = normalize(fwd + right sx + up sy) with sx = ax tan(fov/2)
// aspect, sy = ay tan(fov/2), ax from the column j + oj and ay from the image
// row (i + row0) + oi (render_tile's (iota + row0) + oi, then camera_rays;
// the integer sum is exact). The intermediates are what the step kernel's
// camera adjoint needs.
struct Ray {
  V3 d, dt;
  float n2, inv, ax, ay, sx, sy;
};

__device__ __forceinline__ Ray primary_ray(const Camera& c, const Params& p, int i, int j) {
  Ray r;
  r.ax = (((float)j + p.oj) + 0.5f) * p.two_over_w - 1.0f;
  r.ay = 1.0f - (((float)(i + p.row0) + p.oi) + 0.5f) * p.two_over_h;
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

// ---------------------------------------------------------------------------
// Texel grids (pipeline.py texture_weights, sample_texture, sphere_uv)
// ---------------------------------------------------------------------------

constexpr float PI_F = 3.14159265358979323846f;
// The Cephes atanf polynomial and fold point of vecmath.py (float32 as the
// JAX package and torch round the Python constants).
constexpr float ATAN_P0 = 8.05374449538e-2f, ATAN_P1 = -1.38776856032e-1f,
                ATAN_P2 = 1.99777106478e-1f, ATAN_P3 = -3.33329491539e-1f;
constexpr float TAN_PI_8 = 0.4142135623730951f;

// vecmath._atan_01 op for op: atan of r in [0, 1], folded above tan(pi/8)
// to pi/4 + atan((r - 1) / (r + 1)), then the odd polynomial.
__device__ __forceinline__ float atan_01(float r) {
  const bool fold = r > TAN_PI_8;
  const float x = fold ? (r - 1.0f) / (r + 1.0f) : r;
  const float z = x * x;
  float p = ATAN_P0 * z + ATAN_P1;
  p = p * z + ATAN_P2;
  p = p * z + ATAN_P3;
  const float y = p * z * x + x;
  return fold ? y + (float)(3.141592653589793 / 4) : y;
}

// vecmath.atan2 op for op (not atan2f): octant-reduced, the denominator
// guarded, atan2(0, 0) = 0, and the y < 0 select, so atan2(-0, x < 0) = +pi.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  float a = atan_01(lo / (hi > 0.0f ? hi : 1.0f));
  a = ay > ax ? (float)(3.141592653589793 / 2) - a : a;
  a = x < 0.0f ? PI_F - a : a;
  return y < 0.0f ? -a : a;
}

// vecmath.asin (not asinf): atan2(t, guarded sqrt((1 - t)(1 + t))).
__device__ __forceinline__ float asin_poly(float t) {
  const float w = (1.0f - t) * (1.0f + t);
  return atan2_poly(t, sqrtf(w > 0.0f ? w : 1.0f));
}

constexpr float UV_CLIP_LO = (float)(-1.0 + 1e-6), UV_CLIP_HI = (float)(1.0 - 1e-6);

struct UV {
  float u, v;
};

// pipeline.sphere_uv of a unit direction: u = atan2(z, x) (0.5 / pi) + 0.5, v
// = 0.5 - asin(clip(y)) / pi. The division by pi is a multiply by the float
// 1 / pi, as torch's CUDA division by a Python scalar takes it.
__device__ __forceinline__ UV sphere_uv(V3 n) {
  const float u = atan2_poly(n.z, n.x) * (float)(0.5 / 3.141592653589793) + 0.5f;
  const float cy = fminf(fmaxf(n.y, UV_CLIP_LO), UV_CLIP_HI);
  return {u, 0.5f - asin_poly(cy) * (1.0f / PI_F)};
}

// The bilinear corners (i0, i1) x (j0, j1) and weights (fi, fj) of uv (a, b)
// over a K x K grid (pipeline.texture_weights): b clamps at the edges, a
// clamps too or, with wrap (the azimuth), wraps; dfi and dfj are the
// weights' derivatives in a and b (a clamp's ties split as jnp.clip's).
struct TexW {
  int i0, i1, j0, j1;
  float fi, fj, dfi, dfj;
};

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// d max(x, 0) / dx, with the 0.5 tie split of jnp.maximum.
__device__ __forceinline__ float maxgrad(float x) {
  return x > 0.0f ? 1.0f : (x == 0.0f ? 0.5f : 0.0f);
}

// d clip(x, 0, 1) / dx as jnp.clip takes it: maximum, then minimum.
__device__ __forceinline__ float clipgrad(float x) {
  const float m = fmaxf(x, 0.0f);
  return maxgrad(x) * (m < 1.0f ? 1.0f : (m == 1.0f ? 0.5f : 0.0f));
}

__device__ __forceinline__ TexW tex_weights(float a, float b, int K, bool wrap) {
  TexW w;
  const float kf = (float)K;
  const float u = a * kf - 0.5f, v = b * kf - 0.5f;
  if (wrap) {
    const float i0f = floorf(u);
    w.fi = u - i0f;
    w.i0 = (int)i0f % K;
    if (w.i0 < 0) w.i0 += K;
    w.i1 = (w.i0 + 1) % K;
    w.dfi = kf;
  } else {
    const float i0f = fminf(fmaxf(floorf(u), 0.0f), (float)(K - 1));
    w.fi = clip01(u - i0f);
    w.i0 = (int)i0f;
    w.i1 = min(w.i0 + 1, K - 1);
    w.dfi = kf * clipgrad(u - i0f);
  }
  const float j0f = fminf(fmaxf(floorf(v), 0.0f), (float)(K - 1));
  w.fj = clip01(v - j0f);
  w.j0 = (int)j0f;
  w.j1 = min(w.j0 + 1, K - 1);
  w.dfj = kf * clipgrad(v - j0f);
  return w;
}

__device__ __forceinline__ V3 texel(const float* grid, int K, int i, int j) {
  return ld3(grid + 3 * (i * K + j));
}

// pipeline.sample_texture per channel, op for op: (1 - fi) ((1 - fj) t00 +
// fj t01) + fi ((1 - fj) t10 + fj t11).
__device__ __forceinline__ V3 bilinear(const float* grid, int K, const TexW& w) {
  const V3 t00 = texel(grid, K, w.i0, w.j0), t01 = texel(grid, K, w.i0, w.j1);
  const V3 t10 = texel(grid, K, w.i1, w.j0), t11 = texel(grid, K, w.i1, w.j1);
  const float a1 = 1.0f - w.fi, b1 = 1.0f - w.fj;
  return {a1 * (b1 * t00.x + w.fj * t01.x) + w.fi * (b1 * t10.x + w.fj * t11.x),
          a1 * (b1 * t00.y + w.fj * t01.y) + w.fi * (b1 * t10.y + w.fj * t11.y),
          a1 * (b1 * t00.z + w.fj * t01.z) + w.fi * (b1 * t10.z + w.fj * t11.z)};
}

// What a missed ray sees: the environment map's sample at sphere_uv of its
// direction (azimuth wrapped) where the scene has one (HasEnv), else the flat
// background.
template <class S>
__device__ __forceinline__ V3 miss_color(const S& sc, V3 d) {
  if constexpr (HasEnv<S>::value) {
    if (sc.Ke) {
      const UV uv = sphere_uv(d);
      return bilinear(sc.env_texels(), sc.Ke, tex_weights(uv.u, uv.v, sc.Ke, true));
    }
  }
  return sc.background();
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
    if constexpr (Textured<S>::value) {
      if (sc.Ks) {  // the lat-long texture at the normal, azimuth wrapped
        const UV uv = sphere_uv(s.n);
        s.use2 = false;
        s.base = bilinear(sc.s_texels(k), sc.Ks, tex_weights(uv.u, uv.v, sc.Ks, true));
      }
    }
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
    if constexpr (Textured<S>::value) {
      if (sc.Kr) {  // the texture at the in-face coordinates
        s.use2 = false;
        s.base = bilinear(sc.r_texels(k), sc.Kr, tex_weights(a, b, sc.Kr, false));
      }
    }
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

// Mirror bounces (pipeline.py shade_levels): the reflected ray starts at the
// hit's shadow origin and points along d - 2 (d . n) n, the JAX package's
// reflect_dir; each level's colour is unclipped, and the level above blends
// col + m (rcol - col) with m the winner's mirror coefficient (0 on a miss).
__device__ __forceinline__ V3 reflect_dir(V3 d, V3 n) { return d - n * (2.0f * dot(d, n)); }

template <class S>
__device__ __forceinline__ float mirror(const S& sc, Nearest h) {
  if (h.k < 0) return 0.0f;
  return h.k < sc.rect_base() ? sc.s_mirror(h.k) : sc.r_mirror(h.k - sc.rect_base());
}

__device__ __forceinline__ V3 blend(V3 col, V3 rcol, float m) {
  return {col.x + m * (rcol.x - col.x), col.y + m * (rcol.y - col.y), col.z + m * (rcol.z - col.z)};
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
// clipped image (zero outside the image) times scale, and no loss; a light's
// visibility is the forward's saved plane. lit() runs only where the ray hit
// (on a miss the forward kernels' planes hold 0 and the plain versions' the
// test of a ray from the BIG sentinel), and not at all without shadows, when
// there are no planes.
struct CotangentSource {
  static constexpr bool casts_shadows = false;
  const float* g_img;  // (H, W, 3)
  const float* vis;    // (n_vis, H, W); unused by the soft backward
  float scale;         // 1; 0.25 for a subsample of spp 4 (at)

  __device__ __forceinline__ V3 cotangent(const Params& p, int i, int j, bool inside, V3,
                                          float* sq) const {
    *sq = 0.0f;
    return inside ? ld3(g_img + 3 * ((long long)i * p.W + j)) * scale : zero3();
  }

  template <class Occ>
  __device__ __forceinline__ bool lit(const Params& p, int i, int j, int l, Occ) const {
    return !p.shadows || vis[((long long)l * p.H + i) * p.W + j] != 0.0f;
  }

  // Subsample s of spp 4: a quarter of the average's cotangent (the
  // average's 0.25, before each subsample's own clip gradient) and the
  // subsample's n_planes = (1 + R) L planes, from s (1 + R) L in the
  // forward's layout (pipeline.n_vis_planes: subsample-major, then bounce).
  __device__ __forceinline__ CotangentSource at(const Params& p, int s, int n_planes) const {
    return {g_img, vis + (long long)s * n_planes * p.H * p.W, scale * 0.25f};
  }
};

// SubsampleSource, the replay of one subsample of a spp-4 step
// (pixel_grads): the cotangent of the average's residual times 0.25, the
// same for the four subsamples (pixel_step then takes each one's own clip
// gradient), the squared residual on the first subsample only, and the
// visibility bits the subsample's first forward found with its shadow rays,
// so the replay casts none.
template <class Word = unsigned>
struct SubsampleSource {
  static constexpr bool casts_shadows = false;
  V3 g;
  float sq;
  Word bits;  // light l of level v at bit v L + l

  __device__ __forceinline__ V3 cotangent(const Params&, int, int, bool, V3, float* out) const {
    *out = sq;
    return g;
  }

  template <class Occ>
  __device__ __forceinline__ bool lit(const Params&, int, int, int l, Occ) const {
    return ((bits >> l) & 1u) != 0;
  }
};

// The word of a subsample's visibility bits at REFL bounce levels: 32 bits
// hold (1 + REFL) L for REFL <= 1 at 16 lights, 64 for REFL <= 3.
template <int REFL>
using BitsWord = typename std::conditional<(REFL > 1), unsigned long long, unsigned>::type;

// How pixel_step walks the objects. FullWalk, the small-scene step and
// render backward (flat_step.cuh): every object for the primary ray, the
// reflected ray (trace_bounce) and each shadow ray. vec_step.cuh's WarpCull
// walks the candidates of per-warp culls (cull.cuh) instead, and casts its
// warp-wide votes in shadows(), which pixel_forward calls from every lane
// before it branches on a level's hit.
struct FullWalk {
  template <class S>
  __device__ __forceinline__ Nearest trace(const S& sc, V3 o, V3 d, bool inside) const {
    return inside ? rrt::trace(sc, o, d) : Nearest{BIG, -1};
  }
  template <class S>
  __device__ __forceinline__ Nearest trace_bounce(const S& sc, V3 o, V3 d, bool live) const {
    return live ? rrt::trace(sc, o, d) : Nearest{BIG, -1};
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

// With R bounce levels (REFL): also the gradient of the mirror coefficient
// of each level's winner above the deepest (g_mir[l], level l's), and each
// bounce level's winner and its gradient (k1[l] and obj1[l], level l + 1's).
template <int R>
struct BounceGrad : PixelGrad {
  float g_mir[R];
  int k1[R];                   // -1 where the level or one above it missed
  float obj1[R][RECT_FIELDS];  // its gradient
};

// The forward of pixel (i, j) as pixel_step runs it: the camera and the
// primary ray, the nearest hit (walk), the winner's surface, the visibility
// bits (src.lit) and the unclipped colour pre.
struct PixelForward {
  Camera cam;
  Ray r;
  Nearest h;
  Surface s;
  V3 pre;
  unsigned bits;
};

// Bounce level l + 1 (b[l]): the reflected ray (o, d), its nearest hit,
// surface and visibility bits (src.lit of planes (l + 1) L + light), its
// unclipped colour col and the blend of it and the levels below it, rc; the
// level above's unclipped colour col0 and mirror weight m (0 on a miss).
struct Bounce {
  V3 o, d;
  Nearest h;
  Surface s;
  V3 col0, col, rc;
  unsigned bits;
  float m;
};

template <int R>
struct BounceForward : PixelForward {
  Bounce b[R];
};

// The forward's and the gradient's types at REFL bounce levels (0 to
// MAX_REFL).
template <int REFL>
struct Levels {
  static_assert(REFL >= 1 && REFL <= MAX_REFL, "0 to MAX_REFL bounce levels");
  using Forward = BounceForward<REFL>;
  using Grad = BounceGrad<REFL>;
};
template <>
struct Levels<0> {
  using Forward = PixelForward;
  using Grad = PixelGrad;
};

// A pixel's texel record: the cotangent g of one bilinear sample (a textured
// winner's base colour, or the environment's colour at a miss of either
// level) and its corners in the grid of side K whose texel (0, 0) starts at
// slot base of the gradient row it is scattered into (the flat scene's, or
// a PackedEnvRows' globals, or a PackedTexRows' block texel row; -1: the
// pixel has none). In a TexFlatScene or a PackedEnvRows a pixel has at most
// one: their object textures take no bounce, and a miss at a bounce level
// follows a hit at every level above it. A PackedTexRows pixel has besides
// one record of each level's textured winner (WithObjTexels).
struct TexelRec {
  int base, K;
  TexW w;
  V3 g;
};

template <class G>
struct WithTexels : G {
  TexelRec tex;
};

// NL levels' winners' texel records besides the environment's.
template <class G, int NL>
struct WithObjTexels : WithTexels<G> {
  TexelRec otex[NL];
};

// The gradient type of a pixel at REFL bounce levels in scene type S.
template <int REFL, class S>
using GradOf = typename std::conditional<
    ObjTexRows<S>::value, WithObjTexels<typename Levels<REFL>::Grad, 1 + REFL>,
    typename std::conditional<HasEnv<S>::value, WithTexels<typename Levels<REFL>::Grad>,
                              typename Levels<REFL>::Grad>::type>::type;

// Words a lane stages of its texel record: 4 corner slots, 12 values.
constexpr int TEX_REC = 16;

// Add the warp's texel records to gs, the warp's row of scene gradients (in
// the slots the records' bases count in: flat_step.cuh's flat scene,
// vec_step.cuh's globals), in lane order; rec is the warp's 32 x TEX_REC
// staging words. Corner (i0, j0), (i0, j1), (i1, j0), (i1, j1) of a record takes weight (1 -
// fi)(1 - fj), (1 - fi) fj, fi (1 - fj), fi fj of its cotangent; a corner that
// coincides with an earlier one is merged into it and its slot set to -1, so
// that lanes 0-11 (corner lane / 3, channel lane % 3) add to distinct slots.
__device__ __forceinline__ void scatter_texels(const TexelRec& r, float* gs, float* rec,
                                               int lane) {
  const bool has = r.base >= 0;
  const unsigned todo = __ballot_sync(FULL, has);
  if (!todo) return;
  if (has) {
    const TexW& w = r.w;
    const float a1 = 1.0f - w.fi, b1 = 1.0f - w.fj;
    const V3 ga = r.g * a1, gb = r.g * w.fi;
    V3 v[4] = {ga * b1, ga * w.fj, gb * b1, gb * w.fj};
    int slot[4] = {r.base + 3 * (w.i0 * r.K + w.j0), r.base + 3 * (w.i0 * r.K + w.j1),
                   r.base + 3 * (w.i1 * r.K + w.j0), r.base + 3 * (w.i1 * r.K + w.j1)};
    if (w.j1 == w.j0) {
      v[0] = v[0] + v[1];
      v[2] = v[2] + v[3];
      slot[1] = slot[3] = -1;
    }
    if (w.i1 == w.i0) {
      v[0] = v[0] + v[2];
      if (slot[3] >= 0) v[1] = v[1] + v[3];
      slot[2] = slot[3] = -1;
    }
    float* mine = rec + TEX_REC * lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      mine[q] = __int_as_float(slot[q]);
      mine[4 + 3 * q] = v[q].x;
      mine[5 + 3 * q] = v[q].y;
      mine[6 + 3 * q] = v[q].z;
    }
  }
  __syncwarp();
  for (unsigned left = todo; left; left &= left - 1) {
    const float* theirs = rec + TEX_REC * (__ffs(left) - 1);
    if (lane < 12) {
      const int slot = __float_as_int(theirs[lane / 3]);
      if (slot >= 0) gs[slot + lane % 3] += theirs[4 + lane];
    }
    __syncwarp();
  }
}

// With REFL, level l + 1 is traced only where level l hit (elsewhere m_l =
// 0 and the blend keeps col_l to the bit) by the walk's trace_bounce, and its
// shadow rays' votes are cast (walk.shadows) after level l's shadow rays are
// done; pre is then the levels' blend, deepest first, unclipped.
template <int REFL = 0, class S, class Src, class Walk>
__device__ __forceinline__ typename Levels<REFL>::Forward pixel_forward(
    const S& sc, const Params& p, int i, int j, bool inside, const Src& src, const Walk& walk) {
  typename Levels<REFL>::Forward f;
  f.cam = camera(sc);
  f.r = primary_ray(f.cam, p, inside ? i : 0, inside ? j : 0);
  const V3 o = f.cam.eye, d = f.r.d;
  f.h = walk.trace(sc, o, d, inside);
  const bool hit = f.h.k >= 0;
  f.s = surface(sc, o, d, f.h);
  walk.shadows(sc, p, src, shadow_origin(o, d, f.h.t, f.s.n), hit);
  f.bits = 0;
  f.pre = sc.background();
  if constexpr (HasEnv<S>::value) {
    if (!hit) f.pre = miss_color(sc, d);
  }
  if (hit)
    f.pre = shade_hit(
        sc, o, d, f.h.t, f.s,
        [&](int l, V3 so, const LightGeo& g) {
          return src.lit(p, i, j, l, [&] { return walk.occluded(sc, l, so, g); });
        },
        &f.bits);
  if constexpr (REFL != 0) {
    V3 o_up = o, d_up = d, col_up = f.pre;
    Nearest h_up = f.h;
    Surface s_up = f.s;
    bool live = hit;  // level v, the one above b, hit (and every level above it)
#pragma unroll
    for (int v = 0; v < REFL; ++v) {
      Bounce& b = f.b[v];
      b.col0 = col_up;
      b.m = mirror(sc, h_up);
      b.o = shadow_origin(o_up, d_up, h_up.t, s_up.n);
      b.d = reflect_dir(d_up, s_up.n);
      b.h = walk.trace_bounce(sc, b.o, b.d, live);
      b.s = surface(sc, b.o, b.d, b.h);
      walk.shadows(sc, p, src, shadow_origin(b.o, b.d, b.h.t, b.s.n), b.h.k >= 0);
      b.bits = 0;
      b.col = sc.background();
      if constexpr (HasEnv<S>::value) {
        if (live) b.col = miss_color(sc, b.d);  // (where a level above missed, m = 0 drops it)
      }
      if (b.h.k >= 0)
        b.col = shade_hit(
            sc, b.o, b.d, b.h.t, b.s,
            [&](int l, V3 so1, const LightGeo& g1) {
              return src.lit(p, i, j, (v + 1) * sc.n_light() + l,
                             [&] { return walk.occluded(sc, l, so1, g1); });
            },
            &b.bits);
      o_up = b.o;
      d_up = b.d;
      col_up = b.col;
      h_up = b.h;
      s_up = b.s;
      live = b.h.k >= 0;
    }
    V3 c = f.b[REFL - 1].col;
#pragma unroll
    for (int v = REFL - 1; v >= 0; --v) {
      f.b[v].rc = c;
      c = blend(f.b[v].col0, c, f.b[v].m);
    }
    f.pre = c;
  }
  return f;
}

// The shade adjoint of one level for the cotangent gh of its colour (zero
// where the ray missed): the ambient term, then light by light (a shadowed
// light, bit l of bits clear, contributes nothing). Light l's position and
// color gradients go to on_light(l, g_lpos, g_lcol, warp_hit) inside the
// light loop, which every lane of a warp runs together (warp_hit: some lane
// of the warp hit at this level).
struct ShadeGrad {
  V3 g_base, g_amb, g_n, g_d, g_so;
  float g_ka, g_kd, g_ks, g_shin;
};

template <class S, class OnLight>
__device__ __forceinline__ ShadeGrad shade_adjoint(const S& sc, V3 gh, V3 o, V3 d, float t,
                                                   const Surface& s, bool hit, unsigned bits,
                                                   OnLight on_light) {
  ShadeGrad a;
  const V3 amb = sc.ambient();
  a.g_base = {gh.x * amb.x * s.ka, gh.y * amb.y * s.ka, gh.z * amb.z * s.ka};
  a.g_amb = {gh.x * s.base.x * s.ka, gh.y * s.base.y * s.ka, gh.z * s.base.z * s.ka};
  a.g_ka = gh.x * s.base.x * amb.x + gh.y * s.base.y * amb.y + gh.z * s.base.z * amb.z;
  a.g_kd = 0.0f;
  a.g_ks = 0.0f;
  a.g_shin = 0.0f;
  a.g_n = zero3();
  a.g_d = zero3();
  a.g_so = zero3();
  const V3 view = -d;
  const V3 so = shadow_origin(o, d, t, s.n);
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
      a.g_kd += g_q.x * ndotl * s.base.x + g_q.y * ndotl * s.base.y + g_q.z * ndotl * s.base.z;
      float g_ndotl = g_q.x * s.kd * s.base.x + g_q.y * s.kd * s.base.y + g_q.z * s.kd * s.base.z;
      a.g_base = a.g_base + g_q * (s.kd * ndotl);
      a.g_ks += g_spec * pw;
      const float g_pw = g_spec * s.ks;
      float g_rdotv = 0.0f;
      // safe_pow: exp(shin * log x), no gradient at x <= 0 or past the cap
      if (rdotv > 0.0f && s.shin * logf(rdotv) < POW_LOG_MAX) {
        g_rdotv = g_pw * pw * s.shin / rdotv;
        a.g_shin += g_pw * pw * logf(rdotv);
      }
      const float g_rdv = g_rdotv * maxgrad(rdv);
      const V3 g_refl = view * g_rdv;
      a.g_d = a.g_d - refl * g_rdv;
      a.g_n = a.g_n + g_refl * (2.0f * ndotl);
      g_ndotl += 2.0f * dot(g_refl, s.n);
      const float g_ndl = g_ndotl * maxgrad(ndl);
      a.g_n = a.g_n + g.ldir * g_ndl;
      const V3 g_ldir = s.n * g_ndl - g_refl;
      // ldir = lvec / guarded(dist), dist = guarded sqrt(|lvec|^2)
      V3 g_lvec = g_ldir * g.inv;
      const float g_inv = dot(g_ldir, g.lvec);
      const float g_dist = g.dist > 1e-9f ? -g_inv * g.inv * g.inv : 0.0f;
      const float g_dist2 = g.dist2 > 0.0f ? g_dist * 0.5f / g.dist : 0.0f;
      g_lvec = g_lvec + g.lvec * (2.0f * g_dist2);
      g_lpos = g_lvec;
      a.g_so = a.g_so - g_lvec;
    }
    on_light(l, g_lpos, g_lcol, warp_hit);
  }
  return a;
}

// The winning object's adjoint for the cotangents g_t of the level's ray
// distance and g_n of its normal, and a's of its material: adds the ray's
// (o, d) cotangents to g_o and g_d and writes the winner's fields to obj
// (SPH_FIELDS or RECT_FIELDS order; zero where the ray missed).
template <class S>
__device__ __forceinline__ void object_adjoint(const S& sc, V3 o, V3 d, const Nearest& h,
                                               bool hit, const Surface& s, const ShadeGrad& a,
                                               float g_t, V3 g_n, V3& g_o, V3& g_d,
                                               float (&obj)[RECT_FIELDS]) {
#pragma unroll
  for (int f = 0; f < RECT_FIELDS; ++f) obj[f] = 0.0f;
  const V3 g_col = s.use2 ? zero3() : a.g_base;
  const V3 g_col2 = s.use2 ? a.g_base : zero3();
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
    obj[0] = g_c.x;
    obj[1] = g_c.y;
    obj[2] = g_c.z;
    obj[3] = g_r;
    obj[4] = g_col.x;
    obj[5] = g_col.y;
    obj[6] = g_col.z;
    obj[7] = g_col2.x;
    obj[8] = g_col2.y;
    obj[9] = g_col2.z;
    obj[10] = a.g_ka;
    obj[11] = a.g_kd;
    obj[12] = a.g_ks;
    obj[13] = a.g_shin;
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
    obj[0] = g_p0.x;
    obj[1] = g_p0.y;
    obj[2] = g_p0.z;
    obj[3] = g_eu.x;
    obj[4] = g_eu.y;
    obj[5] = g_eu.z;
    obj[6] = g_ev.x;
    obj[7] = g_ev.y;
    obj[8] = g_ev.z;
    obj[9] = g_col.x;
    obj[10] = g_col.y;
    obj[11] = g_col.z;
    obj[12] = g_col2.x;
    obj[13] = g_col2.y;
    obj[14] = g_col2.z;
    obj[15] = a.g_ka;
    obj[16] = a.g_kd;
    obj[17] = a.g_ks;
    obj[18] = a.g_shin;
  }
}

// ---- the adjoints of the texel samples (fused.py grid_adjoint, uv_adjoint)

// The cotangents of uv (a, b) of bilinear(grid, K, w) for the colour
// cotangent g, through the weights: d/dfi = B - A, d/dfj = (1 - fi)(t01 -
// t00) + fi (t11 - t10), times dfi, dfj.
__device__ __forceinline__ void bilinear_adjoint(const float* grid, int K, const TexW& w, V3 g,
                                                 float* g_a, float* g_b) {
  const V3 t00 = texel(grid, K, w.i0, w.j0), t01 = texel(grid, K, w.i0, w.j1);
  const V3 t10 = texel(grid, K, w.i1, w.j0), t11 = texel(grid, K, w.i1, w.j1);
  const float a1 = 1.0f - w.fi, b1 = 1.0f - w.fj;
  const V3 A = t00 * b1 + t01 * w.fj, B = t10 * b1 + t11 * w.fj;
  *g_a = dot(g, B - A) * w.dfi;
  *g_b = dot(g, (t01 - t00) * a1 + (t11 - t10) * w.fi) * w.dfj;
}

// d atan_01 / dr: the polynomial's derivative (not 1 / (1 + r^2)), through
// the fold x = (r - 1) / (r + 1) above tan(pi/8).
__device__ __forceinline__ float atan01_grad(float r) {
  const bool fold = r > TAN_PI_8;
  const float x = fold ? (r - 1.0f) / (r + 1.0f) : r;
  const float z = x * x;
  float p = ATAN_P0, dp = 0.0f;
  dp = dp * z + p;
  p = p * z + ATAN_P1;
  dp = dp * z + p;
  p = p * z + ATAN_P2;
  dp = dp * z + p;
  p = p * z + ATAN_P3;
  const float dy = (dp * z + p) * 2.0f * x * x + p * z + 1.0f;  // d (p(z) z x + x) / dx
  return fold ? dy * 2.0f / ((r + 1.0f) * (r + 1.0f)) : dy;
}

__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// The cotangents of y and x of atan2_poly for the cotangent g of its value,
// as autograd takes them through vecmath.atan2's selects.
__device__ __forceinline__ void atan2_adjoint(float y, float x, float g, float* g_y, float* g_x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  const float den = hi > 0.0f ? hi : 1.0f;
  const float r = lo / den;
  if (y < 0.0f) g = -g;
  if (x < 0.0f) g = -g;
  if (ay > ax) g = -g;
  const float g_r = g * atan01_grad(r);
  const float g_lo = g_r / den;
  const float g_hi = hi > 0.0f ? -g_r * r / den : 0.0f;
  // d max(a, b) / da = d min(b, a) / da = maxgrad(a - b), ties split
  *g_x = (g_hi * maxgrad(ax - ay) + g_lo * maxgrad(ay - ax)) * signf(x);
  *g_y = (g_hi * maxgrad(ay - ax) + g_lo * maxgrad(ax - ay)) * signf(y);
}

// The cotangent of t of asin_poly.
__device__ __forceinline__ float asin_adjoint(float t, float g) {
  const float w = (1.0f - t) * (1.0f + t);
  const float s = sqrtf(w > 0.0f ? w : 1.0f);
  float g_y, g_x;
  atan2_adjoint(t, s, g, &g_y, &g_x);
  const float g_w = w > 0.0f ? g_x * 0.5f / s : 0.0f;
  return g_y - g_w * (1.0f + t) + g_w * (1.0f - t);
}

// The cotangent of the direction n of sphere_uv for those of (u, v).
__device__ __forceinline__ V3 uv_adjoint(V3 n, float g_u, float g_v) {
  V3 g;
  atan2_adjoint(n.z, n.x, g_u * (float)(0.5 / 3.141592653589793), &g.z, &g.x);
  const float cy = fminf(fmaxf(n.y, UV_CLIP_LO), UV_CLIP_HI);
  g.y = asin_adjoint(cy, -g_v * (1.0f / PI_F)) * maxgrad(n.y - UV_CLIP_LO) *
        maxgrad(UV_CLIP_HI - fmaxf(n.y, UV_CLIP_LO));
  return g;
}

// The environment's sample at sphere_uv(d) for the colour cotangent g: its
// texel record, and the cotangent of the direction d.
template <class S>
__device__ __forceinline__ V3 env_adjoint(const S& sc, V3 d, V3 g, TexelRec& rec) {
  const UV uv = sphere_uv(d);
  rec = {sc.env, sc.Ke, tex_weights(uv.u, uv.v, sc.Ke, true), g};
  float g_u, g_v;
  bilinear_adjoint(sc.env_texels(), sc.Ke, rec.w, g, &g_u, &g_v);
  return uv_adjoint(d, g_u, g_v);
}

// object_adjoint of a winner in a TexFlatScene: a textured group's base
// colour is its grid's sample, so its cotangent a.g_base goes to the texel
// record (and not to color or color2), and through the weights to the
// sample's coordinates: a sphere's normal (sphere_uv), a rect's (a, b) =
// ((rel . edge_u) / |edge_u|^2, (rel . edge_v) / |edge_v|^2), rel = o + d t -
// origin, into o, d, t, origin, edge_u and edge_v.
template <class S>
__device__ __forceinline__ void object_adjoint_tex(const S& sc, V3 o, V3 d, const Nearest& h,
                                                   bool hit, const Surface& s, ShadeGrad a,
                                                   float g_t, V3 g_n, V3& g_o, V3& g_d,
                                                   float (&obj)[RECT_FIELDS], TexelRec& rec) {
  const bool sph = hit && h.k < sc.rect_base();
  const int K = !hit ? 0 : sph ? sc.Ks : sc.Kr;
  if (K == 0) {
    object_adjoint(sc, o, d, h, hit, s, a, g_t, g_n, g_o, g_d, obj);
    return;
  }
  const V3 g = a.g_base;
  a.g_base = zero3();
  float g_a, g_b;
  if (sph) {
    const int k = h.k;
    const UV uv = sphere_uv(s.n);
    rec = {sc.s_tex + 3 * K * K * k, K, tex_weights(uv.u, uv.v, K, true), g};
    bilinear_adjoint(sc.s_texels(k), K, rec.w, g, &g_a, &g_b);
    object_adjoint(sc, o, d, h, hit, s, a, g_t, g_n + uv_adjoint(s.n, g_a, g_b), g_o, g_d, obj);
    return;
  }
  const int k = h.k - sc.rect_base();
  const V3 p0 = sc.r_origin(k), eu = sc.r_eu(k), ev = sc.r_ev(k);
  float ra, rb;
  hit_rect(o, d, p0, eu, ev, &ra, &rb);
  rec = {sc.r_tex + 3 * K * K * k, K, tex_weights(ra, rb, K, false), g};
  bilinear_adjoint(sc.r_texels(k), K, rec.w, g, &g_a, &g_b);
  const V3 rel = (o + d * h.t) - p0;
  const float inv_u2 = 1.0f / dot(eu, eu), inv_v2 = 1.0f / dot(ev, ev);
  const float ga = g_a * inv_u2, gb = g_b * inv_v2;
  const V3 g_rel = eu * ga + ev * gb;
  g_o = g_o + g_rel;
  g_d = g_d + g_rel * h.t;
  object_adjoint(sc, o, d, h, hit, s, a, g_t + dot(g_rel, d), g_n, g_o, g_d, obj);
  const V3 g_eu = rel * ga - eu * (2.0f * ga * dot(rel, eu) * inv_u2);
  const V3 g_ev = rel * gb - ev * (2.0f * gb * dot(rel, ev) * inv_v2);
  obj[0] -= g_rel.x;
  obj[1] -= g_rel.y;
  obj[2] -= g_rel.z;
  obj[3] += g_eu.x;
  obj[4] += g_eu.y;
  obj[5] += g_eu.z;
  obj[6] += g_ev.x;
  obj[7] += g_ev.y;
  obj[8] += g_ev.z;
}

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
//
// With REFL the adjoint runs deepest level first. Of the blends c_v = col_v
// + m_v (c_{v+1} - col_v) (c_REFL = col_REFL, pre = c_0), the cotangent g_v
// of c_v gives g_{v+1} = m_v g_v, level v's colour (1 - m_v) g_v (the
// deepest's g_REFL) and the mirror coefficient of level v's winner (c_{v+1}
// - col_v) . g_v. Each bounce level's shading and winner under its colour's
// cotangent (its lights' gradients to on_light too), the cotangents of its
// ray (o', d') carried into the level above's shadow origin (o' is that
// point), normal and direction (d' = d - 2 (d . n) n), where they join that
// level's own; level 0 last.
//
// In a TexFlatScene or a PackedEnvRows (HasEnv: GradOf's WithTexels) the
// pixel's texel record goes out with its gradient: a textured winner's
// (object_adjoint_tex, a TexFlatScene's only), or the environment's at a
// miss of level 0, or of a bounce level where every level above hit, whose
// cotangent also reaches that level's ray direction (env_adjoint: the camera,
// or through d' = d - 2 (d . n) n the level above's d and n); the background
// then gets none.
// In a PackedTexRows (WithObjTexels) each level's textured winner has its
// own record (otex[level]), the environment's the other (tex).
template <int REFL = 0, class S, class Src, class Walk, class OnLight>
__device__ __forceinline__ GradOf<REFL, S> pixel_step(const S& sc, const Params& p, int i, int j,
                                                      bool inside, const Src& src,
                                                      const Walk& walk, OnLight on_light) {
  constexpr bool TEX = Textured<S>::value;
  constexpr bool ENV = HasEnv<S>::value;
  constexpr bool OBJTEX = ObjTexRows<S>::value;
  GradOf<REFL, S> out;
  if constexpr (ENV) out.tex.base = -1;
  if constexpr (OBJTEX) {
#pragma unroll
    for (int q = 0; q <= REFL; ++q) out.otex[q].base = -1;
  }
  // ---- forward
  const typename Levels<REFL>::Forward fw = pixel_forward<REFL>(sc, p, i, j, inside, src, walk);
  const Camera& cam = fw.cam;
  const Ray& r = fw.r;
  const V3 o = cam.eye, d = r.d;
  const Nearest& h = fw.h;
  const bool hit = h.k >= 0;
  const Surface& s = fw.s;
  const unsigned bits = fw.bits;
  const V3 pre = fw.pre;
  const V3 img = p.clip ? V3{clip01(pre.x), clip01(pre.y), clip01(pre.z)} : pre;

  // ---- the clipped image's cotangent, then the clip's
  V3 gc = src.cotangent(p, i, j, inside, img, &out.sq);
  if (p.clip) gc = {gc.x * clipgrad(pre.x), gc.y * clipgrad(pre.y), gc.z * clipgrad(pre.z)};

  // ---- the bounce levels, deepest first, each ray's cotangents into the
  // level above's
  [[maybe_unused]] V3 g_so_in = zero3(), g_n_in = zero3(), g_d_in = zero3(), g_bg1 = zero3(),
                      g_amb1 = zero3();
  if constexpr (REFL != 0) {
    V3 gv[REFL + 1];  // the blends' cotangents, then each level's colour's
    gv[0] = gc;
#pragma unroll
    for (int v = 0; v < REFL; ++v) {
      const Bounce& b = fw.b[v];
      const bool hit_v = v == 0 ? hit : fw.b[v - 1].h.k >= 0;
      out.g_mir[v] = hit_v ? dot(gv[v], b.rc - b.col0) : 0.0f;
      gv[v + 1] = gv[v] * b.m;
      gv[v] = gv[v] * (1.0f - b.m);
    }
    gc = gv[0];
#pragma unroll
    for (int v = REFL; v >= 1; --v) {
      const Bounce& b = fw.b[v - 1];
      const bool live = v == 1 ? hit : fw.b[v - 2].h.k >= 0;  // the level above hit
      const V3 gc1 = gv[v];
      const bool hit1 = b.h.k >= 0;
      V3 g_bgv = hit1 ? zero3() : gc1;
      const ShadeGrad a1 =
          shade_adjoint(sc, hit1 ? gc1 : zero3(), b.o, b.d, b.h.t, b.s, hit1, b.bits, on_light);
      V3 g_sov = a1.g_so, g_dv = a1.g_d, g_nv = a1.g_n;
      if (v < REFL) {  // the level below's ray leaves this level's shadow origin
        g_sov = g_sov + g_so_in;
        g_nv = g_nv + g_n_in;
        g_dv = g_dv + g_d_in;
      }
      // shadow origin so' = (o' + d' t') + n' SHADOW_EPS
      V3 g_o1 = g_sov;
      V3 g_d1 = g_dv + g_sov * b.h.t;
      const float g_t1 = dot(g_sov, b.d);
      const V3 g_n1 = g_nv + g_sov * SHADOW_EPS;
      if constexpr (ENV) {
        if (sc.Ke) {
          g_bgv = zero3();
          if (live && !hit1) g_d1 = g_d1 + env_adjoint(sc, b.d, gc1, out.tex);
        }
      }
      if constexpr (OBJTEX)  // this level's textured winner: its own texel record
        object_adjoint_tex(sc, b.o, b.d, b.h, hit1, b.s, a1, g_t1, g_n1, g_o1, g_d1,
                           out.obj1[v - 1], out.otex[v]);
      else
        object_adjoint(sc, b.o, b.d, b.h, hit1, b.s, a1, g_t1, g_n1, g_o1, g_d1, out.obj1[v - 1]);
      out.k1[v - 1] = b.h.k;
      g_bg1 = v == REFL ? g_bgv : g_bg1 + g_bgv;
      g_amb1 = v == REFL ? a1.g_amb : g_amb1 + a1.g_amb;
      // o' = so; d' = d - 2 (d . n) n, of the level above
      const V3 n_up = v == 1 ? s.n : fw.b[v - 2].s.n;
      const V3 d_up = v == 1 ? d : fw.b[v - 2].d;
      g_so_in = live ? g_o1 : zero3();
      const float gdn = live ? dot(n_up, g_d1) : 0.0f;
      g_d_in = live ? g_d1 - n_up * (2.0f * gdn) : zero3();
      g_n_in = live ? (d_up * gdn + g_d1 * dot(d_up, n_up)) * -2.0f : zero3();
    }
  }

  // ---- shade adjoint: ambient term, then light by light
  const V3 gh = hit ? gc : zero3();
  out.g_bg = hit ? zero3() : gc;
  const ShadeGrad a = shade_adjoint(sc, gh, o, d, h.t, s, hit, bits, on_light);
  out.g_amb = a.g_amb;
  V3 g_n = a.g_n, g_d = a.g_d, g_so = a.g_so;
  [[maybe_unused]] bool env_miss = false;
  if constexpr (ENV) {
    if (sc.Ke) {
      out.g_bg = zero3();
      env_miss = inside && !hit;
      if (env_miss) g_d = g_d + env_adjoint(sc, d, gc, out.tex);
    }
  }
  if constexpr (REFL != 0) {
    out.g_bg = out.g_bg + g_bg1;
    out.g_amb = out.g_amb + g_amb1;
    g_so = g_so + g_so_in;
    g_n = g_n + g_n_in;
    g_d = g_d + g_d_in;
  }
  // shadow origin so = (o + d t) + n SHADOW_EPS
  V3 g_o = g_so;
  g_d = g_d + g_so * h.t;
  const float g_t = dot(g_so, d);
  g_n = g_n + g_so * SHADOW_EPS;

  // ---- the winning object's adjoint
  if constexpr (OBJTEX)
    object_adjoint_tex(sc, o, d, h, hit, s, a, g_t, g_n, g_o, g_d, out.obj, out.otex[0]);
  else if constexpr (TEX)
    object_adjoint_tex(sc, o, d, h, hit, s, a, g_t, g_n, g_o, g_d, out.obj, out.tex);
  else
    object_adjoint(sc, o, d, h, hit, s, a, g_t, g_n, g_o, g_d, out.obj);

  // ---- camera: o = eye, d = normalize(dt), dt = fwd + right sx + up sy
  // (with an environment map a missed ray's direction has a cotangent too)
  out.g_dt = hit || env_miss ? normalize_adjoint(r.dt, r.inv, r.n2, g_d) : zero3();
  out.g_tan = dot(out.g_dt, cam.right) * r.ax * p.aspect + dot(out.g_dt, cam.up) * r.ay;
  out.g_eye = hit ? g_o : zero3();
  out.sx = r.sx;
  out.sy = r.sy;
  out.k = h.k;
  return out;
}

// The gradient of pixel (i, j) at SPP samples a pixel, handed to
// take(const GradOf<REFL, S>&) once per subsample (the flat and vec step
// kernels add each into their sums, its texel records into their rows, as
// they would a pixel's). At spp 1, pixel_step. At spp 4 the image is the
// average of the four clipped subsamples of subsample(), ((c0 + c1) + c2) +
// c3 times 0.25 as render_tile sums them:
//   - where src casts shadow rays (the steps), the residual is of the
//     average, so the four forwards run first, each keeping its visibility
//     bits (level v's in bits v L .. v L + L - 1, as src.lit numbers level
//     v's lights v L + l: one word a subsample, BitsWord's 32 bits for (1 +
//     REFL) L <= 32, 64 for REFL up to MAX_REFL at 16 lights); then src's
//     cotangent of the average, times 0.25, and each
//     subsample's forward and adjoint replayed with it and its bits
//     (SubsampleSource: no shadow rays the second time, at either level);
//   - the render backwards' caller gives the average's cotangent: each
//     subsample's adjoint takes a quarter of it and reads its own (1 + REFL)
//     L planes (CotangentSource::at).
// Every lane runs every subsample (the walks' warp-wide votes).
template <int SPP, int REFL = 0, class S, class Src, class Walk, class OnLight, class Take>
__device__ __forceinline__ void pixel_grads(const S& sc, const Params& p, int i, int j,
                                            bool inside, const Src& src, const Walk& walk,
                                            OnLight on_light, Take take) {
  static_assert(SPP == 1 || SPP == 4, "spp is 1 or 4");
  if constexpr (SPP == 1) {
    take(pixel_step<REFL>(sc, p, i, j, inside, src, walk, on_light));
  } else if constexpr (Src::casts_shadows) {
    using Word = BitsWord<REFL>;
    V3 acc = zero3();
    Word bits[4];  // one word a subsample: at most 16 lights (MAX_LIGHTS) a level
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      const typename Levels<REFL>::Forward fw =
          pixel_forward<REFL>(sc, subsample(p, q), i, j, inside, src, walk);
      const V3 img = p.clip ? V3{clip01(fw.pre.x), clip01(fw.pre.y), clip01(fw.pre.z)} : fw.pre;
      acc = q == 0 ? img : acc + img;
      Word w = fw.bits;
      if constexpr (REFL != 0) {
#pragma unroll
        for (int v = 0; v < REFL; ++v) w |= (Word)fw.b[v].bits << ((v + 1) * sc.n_light());
      }
      bits[q] = w;
    }
    float sq;
    const V3 g = src.cotangent(p, i, j, inside, acc * 0.25f, &sq) * 0.25f;
#pragma unroll 1
    for (int q = 0; q < 4; ++q)
      take(pixel_step<REFL>(sc, subsample(p, q), i, j, inside,
                            SubsampleSource<Word>{g, q == 0 ? sq : 0.0f, bits[q]}, walk,
                            on_light));
  } else {
#pragma unroll 1
    for (int q = 0; q < 4; ++q)
      take(pixel_step<REFL>(sc, subsample(p, q), i, j, inside,
                            src.at(p, q, (1 + REFL) * sc.n_light()), walk, on_light));
  }
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
// current card holds at once (its SM count times max_per_sm, by default
// STEP_BLOCKS_PER_SM, fewer where shared memory allows fewer), never more
// than the image has tiles; 0 if the card cannot be queried.
inline int step_blocks(size_t smem, int H, int W, int max_per_sm = STEP_BLOCKS_PER_SM) {
  int dev = 0, sms = 0, smem_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
          cudaSuccess)
    return 0;
  const long long by_smem = smem_sm / ((long long)smem + 1024);  // 1 KB reserved a block
  const int per_sm = by_smem < 1 ? 1 : by_smem < max_per_sm ? (int)by_smem : max_per_sm;
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
