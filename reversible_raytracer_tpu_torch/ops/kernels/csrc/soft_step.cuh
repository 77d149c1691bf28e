// The kernels of the soft-visibility fused step (soft_tau > 0, packed
// rows), shared by the training step (fused_vec_soft_step.cu,
// ResidualSource) and the soft render backward
// (fused_vec_soft_render_bwd.cu, CotangentSource, whose visibility planes
// are not read: soft shadows carry gradient and are recomputed): one body,
// two kernels, as the TPU's make_bwd_kernel builds its step and backward.
//
// 1. soft_step_kernel: one thread per pixel, 32 x 8 pixels per block (a
//    warp is 32 pixels of a row), the globals and packed rows staged in
//    shared memory. Each thread ranks its two layers, shades them, takes
//    the image cotangent from its source, and runs the hand-written adjoint
//    that ops/kernels/fused_vec_soft.py's _soft_adjoint runs in eager
//    torch: the composite, then per layer the shading, the soft shadow
//    product's transpose, the light geometry and the layer's winner, then
//    the camera as 10 ray-form cotangents.
//    - The shadow cull. A sphere's factor in a shadow product is 1 -
//      sigmoid(x), x = disc / (tau r^2); below x = -SOFT_CULL it is exactly
//      1 in float32, so the per-pixel rule (shadow_term) drops the sphere
//      there, and where it is not between the surface and the light: the
//      product keeps its bits (the image is row 7's, bit for bit) and the
//      adjoint loses terms each under 2^-25 of its cotangent.
//    - The warp's candidates. Per layer and light the live lanes' shadow
//      origins lie in a ball (centre c_w, radius rho, by shuffles), so each
//      lane's segment [so, light] lies within rho of [c_w, light]; a sphere
//      can pass the per-pixel rule only if its centre lies within R + rho of
//      that segment, R = r sqrt(1 + SOFT_CULL tau) (plus an allowance for
//      rounding): cull.cuh's warp_candidates, which the hard step shares.
//    - One walk forward, one back. The forward (shadow_pass1) walks the
//      candidates once per layer and light: each lane's product, so its
//      visibility, which the shading reads, and the prefix before each
//      candidate, kept in the warp's shared slots (pcap per lane, up to
//      PCAP, as many as the block's shared memory leaves room for) while
//      they last. The adjoint (shadow_pass2) walks the candidates backward
//      with the suffix: a sphere's factor is the exclusive product, prefix
//      times suffix, exact where a factor is 0 (a hard rect, a saturated
//      sigmoid), never a division. A layer and light whose prefixes did not
//      fit (and every one after it) rebuild them pcap at a time in the
//      then free slots, walking forward again from the first candidate.
//    - Every sphere gets a shadow-silhouette gradient from every pixel whose
//      shadow ray keeps it. Each warp reduces the 4 geometry cotangents
//      (center, radius) of a candidate by shuffle, only where some lane's is
//      not 0, and adds them into the warp's own row of ns_pad x 4 floats in
//      shared memory; the warps' rows are summed in warp order at the end.
//    - The two layers' winners go, layer by layer, through per-warp lists
//      of at most 32 distinct objects, entry e's sums held by lane e, into
//      one block row of every object field, warp by warp.
//    The block writes one partial row: [sq, dglob, camera (10), sphere
//    rows, rect rows].
// 2. reduce_rows_kernel sums the partial rows in a fixed order.
// 3. vec_finalize_kernel copies out [sq, dglob, dsph, drct] and applies the
//    camera chain once.
//
// The soft checker (checker_tau > 0, soft_common.cuh soft_surface) is the
// SOFT_CHECKER instance of the step kernel, which the launch takes where
// checker_tau > 0; the other instance is the code of checker_tau = 0 as it
// was. Its adjoint adds, per layer's winner, the blend's: (1 - u) g_base to
// color and u g_base to color2, u = checker (0.5 - 0.5 q); the checker and
// checker-scale columns' gradients; and through q the cotangent of the hit
// position, a sphere's p - c (so o, d, the rank t and the centre) or a
// rect's (a, b) (so o, d, t, the origin and, through their normalizations,
// the edges). Each factor's cotangent is the product of the others, never a
// division by a factor, which is 0 on a cell boundary.
//
// Texel grids (spp 1, the hard checker; soft_step_tex_kernel, the TPU
// kernel's texel tails and env global, fused_vec_soft.py:382-443 and
// :458-492) run the same body on a PackedTexScene: the grids are read from
// global memory, the environment ends the globals.
//    - Each layer's textured winner's base colour is its grid's sample at
//      sphere_uv of its normal (p - c) / r (not renormalised at a near miss;
//      the clamp of its y is the semantics) or at a rect's (a, b); its
//      cotangent goes to a texel record, not to color or color2, and through
//      the sample's weights to the normal or (a, b), and so to the rank t,
//      the centre and radius or the rect's origin and edges.
//    - The composite's blend target is the environment's sample at the
//      primary ray's direction at every pixel, weighted (1 - a1)(1 - a2):
//      every pixel of the image scatters an env record into its warp's
//      globals row (the background gets no gradient), and its cotangent of
//      d reaches the camera.
//    - After each layer's winner lists the warps take turns, a barrier
//      between, each scattering its records in lane order (render_common.cuh
//      scatter_texels) through one staging of 32 records the block shares:
//      the objects' into the block's texel row of 3 (N Ks^2 + M Kr^2) floats
//      in shared memory, which ends the partial row, the env's into the
//      warp's globals row.
//    - The texel row takes 192 KiB for the 64 globes, so the prefix slots
//      get what is left (soft_tex_plan: 10 a lane there, against 32 without
//      the grids), and one block an SM fits: the instance's grid holds as
//      many blocks as the card does at once, each walking the image's tiles
//      in a stride of it (rows 5-6's textured instances do the same), where
//      the others have one block a tile.
//
// No atomics: the result is bit-for-bit the same from call to call on one
// card. Pad rows are never read and their gradient is exactly zero; so are
// the mirror columns, and without the soft checker the checker and
// checker-scale columns.
#pragma once

#include "cull.cuh"
#include "soft_common.cuh"

namespace rrt {

constexpr int PCAP = 32;            // the most prefix slots per lane of a warp
constexpr int GEO = 4;              // center (3) and radius: the shadow gradient per sphere

// The most shared memory a block may have on the current device (opt-in).
inline long long smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

struct SoftPlan {
  int Sg, GROW, OROW, TROW, ROW, NWP, NC, pcap;
  size_t smem;
};

// The block's shared memory, with as many prefix slots per lane (pcap, at
// least 1, at most PCAP) as the card's opt-in leaves room for; a scene that
// does not fit with one slot gets a size over the opt-in, which the
// wrappers refuse. With texel grids (tex): the environment's texels (side ke)
// in the globals and in each warp row, then before the prefix slots one
// staging of 32 texel records, which the warps take in turn, and the block's
// texel row of trow floats, which ends its partial row.
inline SoftPlan soft_plan(int ns_pad, int nr_pad, int n_light, bool tex = false, int ke = 0,
                          int trow = 0) {
  SoftPlan s;
  s.Sg = make_env_glayout(n_light, ke).Sg;
  s.GROW = 1 + s.Sg + CAM_EXTRA;
  s.OROW = ns_pad * P_SPH + nr_pad * P_RCT;
  s.TROW = trow;
  s.ROW = s.GROW + s.OROW + s.TROW;
  s.NWP = (ns_pad + 31) / 32;  // candidate mask words per layer and light
  s.NC = 2 * n_light;          // layers x lights
  // globals, rows, warp rows, block object row, warp shadow rows, warp
  // visibilities; the candidate masks and per layer and light [slot, count,
  // rect bits]; with texel grids the staging and the texel row; then the
  // warps' prefix slots
  const size_t base = (size_t)(s.Sg + s.OROW + NWARPS * s.GROW + s.OROW +
                               NWARPS * ns_pad * GEO + NWARPS * s.NC * 32 +
                               (tex ? 32 * TEX_REC + s.TROW : 0)) *
                          sizeof(float) +
                      (size_t)(NWARPS * s.NC * (s.NWP + 3)) * sizeof(int);
  const size_t per_slot = (size_t)NWARPS * 32 * sizeof(float);
  const long long room = (smem_optin() - (long long)base) / (long long)per_slot;
  s.pcap = (int)(room < 1 ? 1 : room > PCAP ? PCAP : room);
  s.smem = base + s.pcap * per_slot;
  return s;
}

// The plan of the texel instance: n_sph spheres with grids of side ks, n_rect
// rects with grids of side kr, an environment map of side ke (0 for none).
inline SoftPlan soft_tex_plan(int n_sph, int n_rect, int n_light, int ke, int ks, int kr) {
  return soft_plan(pad16(n_sph), pad16(n_rect), n_light, true, ke,
                   3 * (n_sph * ks * ks + n_rect * kr * kr));
}

// The packed column of field f of the SOFT_CHECKER instance's per-object
// gradient: the fields of sph_col / rct_col, then checker and checker scale.
__host__ __device__ inline int sph_col_ck(int f) {
  return f < SPH_FIELDS ? sph_col(f) : 10 + (f - SPH_FIELDS);
}
__host__ __device__ inline int rct_col_ck(int f) {
  return f < RECT_FIELDS ? rct_col(f) : 15 + (f - RECT_FIELDS);
}

// Adds the warp's sums of the 4 components of v to row[0..3] in 6 shuffles
// (a fixed tree: halves trade components, then a butterfly); lanes 0, 8,
// 16 and 24 hold the sums of x, y, z and w.
__device__ __forceinline__ void add4(float* row, float4 v, int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8;
  const float a0 = (hi16 ? v.z : v.x) + __shfl_xor_sync(FULL, hi16 ? v.x : v.z, 16);
  const float a1 = (hi16 ? v.w : v.y) + __shfl_xor_sync(FULL, hi16 ? v.y : v.w, 16);
  float s = (hi8 ? a1 : a0) + __shfl_xor_sync(FULL, hi8 ? a0 : a1, 8);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if ((lane & 7) == 0) row[lane >> 3] += s;
}

// Cotangents of the shadow coverage alpha of a kept sphere of radius r for
// the ray direction ld, given g_alpha: adds to g_so and g_ld and returns
// those of the center (x, y, z) and radius (w). The gate, and with it
// dist, carries no gradient.
__device__ __forceinline__ float4 shadow_alpha_adjoint(const ShadowTerm& st, V3 ld, float r,
                                                       float tau, float g_alpha, V3* g_so,
                                                       V3* g_ld) {
  const float den = tau * r * r;
  const float g_x = g_alpha * st.s * (1.0f - st.s);
  const float g_disc = g_x / den;
  float g_r = -g_x * st.disc / (den * den) * (2.0f * tau * r);
  const float g_b = 2.0f * st.b * g_disc;
  const float g_cc = -g_disc;
  const V3 g_oc = st.oc * (2.0f * g_cc) + ld * g_b;
  g_r = g_r - 2.0f * r * g_cc;
  *g_so = *g_so + g_oc;
  *g_ld = *g_ld + st.oc * g_b;
  return make_float4(-g_oc.x, -g_oc.y, -g_oc.z, g_r);
}

// Pass 1, the forward of one layer and light: the warp's candidates, then
// one walk over them in row order (shadow_product, which row 7 walks too).
// Each live lane's product of its kept factors; the prefix before each
// candidate into the warp's pcap slots from *slot while all of them fit
// (else this layer and light, and every later one, keep none); the rect
// factor's zero lanes as a bit mask. info gets
// [first slot or -1, count, rect bits]. Returns the visibility 1 - (1 - P
// rf) (1 on a dead lane). Call from the whole warp.
template <class S>
__device__ __forceinline__ float shadow_pass1(const S& sc, V3 so, const LightGeo& lg, V3 lpos,
                                              bool live, float tau, int lane, unsigned* wm,
                                              int* info, float* wpre, int pcap, int* slot) {
  const int n = __any_sync(FULL, live) ? warp_candidates(sc, so, lpos, live, tau, lane, wm) : 0;
  const int first = *slot;
  const bool keep = first + n <= pcap;
  *slot = keep ? first + n : pcap + 1;
  const float run = shadow_product(sc, so, lg, live, tau, wm, n, [&](int i, float pre) {
    if (keep) wpre[(first + i) * 32 + lane] = pre;
  });
  const float rf = live ? rect_factor(sc, so, lg.ldir, lg.dist) : 1.0f;
  const unsigned rfz = __ballot_sync(FULL, rf == 0.0f);
  if (lane == 0) {
    info[0] = keep ? first : -1;
    info[1] = n;
    info[2] = (int)rfz;
  }
  return live ? 1.0f - (1.0f - run * rf) : 1.0f;
}

// Pass 2, the adjoint of one layer and light's product P, per lane given
// g_prod, the cotangent of each (1 - alpha) factor's product (0 on a lane
// with nothing to propagate): the candidates walked backward with the
// suffix, each kept sphere's g_alpha = -g_prod * prefix * suffix, its
// geometry cotangents into the warp's shadow rows wsh (where some lane's
// is not 0) and those of so and ld into g_so, g_ld. Prefixes come from
// the slots pass 1 kept, or are rebuilt pcap at a time from slot 0 (free
// by then: the layers and lights before this one are done, the ones after
// it kept none). Call from the whole warp.
template <class S>
__device__ __forceinline__ void shadow_pass2(const S& sc, V3 so, const LightGeo& lg, float tau,
                                             float g_prod, int lane, const unsigned* wm,
                                             const int* info, float* wpre, int pcap, float* wsh,
                                             V3* g_so, V3* g_ld) {
  const int first = info[0], n = info[1];
  const int nw = (sc.n_sph() + 31) >> 5;
  float suf = 1.0f;
  for (int hi = n; hi > 0;) {
    const int lo = first >= 0 ? 0 : max(hi - pcap, 0);
    const int base = first >= 0 ? first : 0;
    if (first < 0) {  // rebuild the prefixes of candidates [lo, hi)
      float run = 1.0f;
      for (int w = 0, i = 0; i < hi; ++w) {
        for (unsigned m = wm[w]; m && i < hi; m &= m - 1, ++i) {
          const int k = w * 32 + __ffs(m) - 1;
          if (i >= lo) wpre[(i - lo) * 32 + lane] = run;
          if (g_prod != 0.0f) {
            const ShadowTerm st =
                shadow_term(so, lg.ldir, lg.dist, sc.s_center(k), sc.s_radius(k), tau);
            if (st.kept) run *= 1.0f - st.s;
          }
        }
      }
    }
    int i = n;
    for (int w = nw - 1; w >= 0 && i > lo; --w) {
      for (unsigned m = wm[w]; m && i > lo;) {
        const int u = 31 - __clz(m);
        m ^= 1u << u;
        if (--i >= hi) continue;
        const int k = w * 32 + u;
        float4 gk = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (g_prod != 0.0f) {
          const float r = sc.s_radius(k);
          const ShadowTerm st = shadow_term(so, lg.ldir, lg.dist, sc.s_center(k), r, tau);
          if (st.kept) {
            gk = shadow_alpha_adjoint(st, lg.ldir, r, tau,
                                      g_prod * wpre[(base + i - lo) * 32 + lane] * suf, g_so,
                                      g_ld);
            suf *= 1.0f - st.s;
          }
        }
        if (__any_sync(FULL, gk.x != 0.0f || gk.y != 0.0f || gk.z != 0.0f || gk.w != 0.0f))
          add4(wsh + k * GEO, gk, lane);
      }
    }
    hi = lo;
  }
}

// The body of every instance: the soft checker's (SOFT_CHECKER) or the hard
// one's, and with TEX (the hard checker) the texel grids: the environment
// map at the end of the globals (EnvGLayout; its side Ke, 0 for none) and the
// object grids tg read from global memory (PackedTexScene). Without TEX a
// block runs the tile of its (x, y) in a grid of the image's tiles; with TEX
// a grid of as many blocks as the card holds walks the tiles in a stride of
// it (the block's texel row leaves room for one block an SM), each block's
// rows summing its tiles.
template <class Src, bool SOFT_CHECKER, bool TEX = false>
__device__ __forceinline__ void soft_step_body(const float* __restrict__ glob,
                                               const float* __restrict__ sph,
                                               const float* __restrict__ rct, int N, int M,
                                               int ns_pad, int nr_pad, GLayoutOf<TEX> gl,
                                               Params p, float tau, float ctau, int pcap,
                                               Src src, float* __restrict__ partials,
                                               TexGrids tg = {}) {
  static_assert(!(SOFT_CHECKER && TEX), "the texel instance takes the hard checker");
  // the per-object gradient's fields: the soft checker adds checker and scale
  constexpr int SF = SOFT_CHECKER ? SPH_FIELDS + 2 : SPH_FIELDS;
  constexpr int RF = SOFT_CHECKER ? RECT_FIELDS + 2 : RECT_FIELDS;
  extern __shared__ float smem[];
  const int GROW = 1 + gl.Sg + CAM_EXTRA;
  const int OROW = ns_pad * P_SPH + nr_pad * P_RCT;
  const int NWP = (ns_pad + 31) / 32;
  const int NC = 2 * gl.L;
  const int TROW = TEX ? 3 * (N * tg.Ks * tg.Ks + M * tg.Kr * tg.Kr) : 0;
  float* g = smem;
  float* s_sph = g + gl.Sg;
  float* s_rct = s_sph + ns_pad * P_SPH;
  float* wp = s_rct + nr_pad * P_RCT;  // NWARPS rows of GROW
  float* orow = wp + NWARPS * GROW;    // the block's object row (OROW)
  float* shp = orow + OROW;            // NWARPS rows of ns_pad x GEO
  float* vsh = shp + NWARPS * ns_pad * GEO;          // NWARPS x NC x 32 visibilities
  unsigned* cmask = (unsigned*)(vsh + NWARPS * NC * 32);  // NWARPS x NC x NWP candidate masks
  int* cinfo = (int*)(cmask + NWARPS * NC * NWP);   // NWARPS x NC x [slot, count, rect bits]
  // with TEX: one staging of 32 texel records, then the block's texel row
  [[maybe_unused]] float* trec = (float*)(cinfo + NWARPS * NC * 3);
  [[maybe_unused]] float* trow = trec + 32 * TEX_REC;
  float* pre = TEX ? trow + TROW : (float*)(cinfo + NWARPS * NC * 3);  // NWARPS x pcap x 32
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  stage(g, glob, gl.Sg);
  stage(s_sph, sph, ns_pad * P_SPH);
  stage(s_rct, rct, nr_pad * P_RCT);
  for (int s = tid; s < NWARPS * GROW + OROW; s += BLOCK_THREADS) wp[s] = 0.0f;
  for (int s = tid; s < NWARPS * ns_pad * GEO; s += BLOCK_THREADS) shp[s] = 0.0f;
  if constexpr (TEX)
    for (int s = tid; s < TROW; s += BLOCK_THREADS) trow[s] = 0.0f;
  __syncthreads();
  float* wrow = wp + warp * GROW;  // [sq, globals (Sg), camera basis (10)]
  float* gs = wrow + 1;
  float* gx = wrow + 1 + gl.Sg;
  float* wsh = shp + warp * ns_pad * GEO;
  float* wpre = pre + warp * pcap * 32;
  float* wvis = vsh + warp * NC * 32;
  unsigned* wmask = cmask + warp * NC * NWP;
  int* winfo = cinfo + warp * NC * 3;
  const auto sc = [&] {
    if constexpr (TEX)
      return tex_view<P_SPH>(packed_view<P_SPH>(g, s_sph, s_rct, gl, N, M, ns_pad), tg);
    else
      return PackedScene{g, s_sph, s_rct, gl, N, M, ns_pad};
  }();

  // the warps add their texel records in turn, each in lane order, through
  // the block's one staging (the environment's into the warp's globals row,
  // an object's into the block's texel row)
  [[maybe_unused]] const auto scatter_in_turn = [&](const TexelRec& rec, float* row) {
    for (int v = 0; v < NWARPS; ++v) {
      if (v == warp) scatter_texels(rec, row, trec, lane);
      __syncthreads();
    }
  };

  const auto tile = [&](int i, int j) {
    const bool inside = i < p.H && j < p.W;

    // ---- forward: per layer and light, pass 1 over the warp's candidates
    // gives the visibility, which the shading reads (row 7's soft_visibility)
    const V3 o = sc.eye();
    const V3 d = primary_ray(camera(sc), p, inside ? i : 0, inside ? j : 0).d;
    Layers y = {{{BIG, -1}, {BIG, -1}}};
    if (inside) y = two_layers(sc, o, d, tau);
    LayerColor lc0, lc1;  // the layers' colours and coverage (no local array: ly is runtime)
    int slot = 0;  // the warp's prefix slots in use (the same in every lane)
#pragma unroll 1
    for (int ly = 0; ly < 2; ++ly) {
      const Nearest h = y.l[ly];
      const bool live = h.k >= 0;  // implies inside
      const Surface s = layer_surface<SOFT_CHECKER>(sc, o, d, h, ctau);
      const V3 so = shadow_origin(o, d, live ? h.t : 0.0f, s.n);
      for (int l = 0; l < sc.n_light(); ++l) {
        const int cb = ly * gl.L + l;
        float vis = 1.0f;
        if (p.shadows)
          vis = shadow_pass1(sc, so, light_geometry(sc.l_pos(l), so), sc.l_pos(l), live, tau,
                             lane, wmask + cb * NWP, winfo + cb * 3, wpre, pcap, &slot);
        wvis[cb * 32 + lane] = vis;
      }
      auto stored = [&](int l, V3, const LightGeo&) { return wvis[(ly * gl.L + l) * 32 + lane]; };
      const LayerColor lc = live ? LayerColor{shade_soft_layer(sc, o, d, h.t, s, stored),
                                              layer_alpha(sc, o, d, h, tau)}
                                 : LayerColor{sc.background(), 0.0f};
      if (ly == 0) lc0 = lc;
      else lc1 = lc;
    }
    __syncwarp();  // lane 0's candidate masks and counts, for the adjoint
    V3 bg = sc.background();
    if constexpr (TEX) bg = miss_color(sc, d);  // the environment's sample, once a pixel
    V3 behind;
    const V3 comp = composite(lc0, lc1, bg, &behind);
    const V3 img = p.clip ? V3{clip01(comp.x), clip01(comp.y), clip01(comp.z)} : comp;

    // ---- the clipped image's cotangent (its source's), then the clip's
    float sq;
    V3 g_comp = src.cotangent(p, i, j, inside, img, &sq);
    if (p.clip)
      g_comp = {g_comp.x * clipgrad(comp.x), g_comp.y * clipgrad(comp.y),
                g_comp.z * clipgrad(comp.z)};

    // ---- composite adjoint
    const float g_a0 = g_comp.x * (lc0.col.x - behind.x) + g_comp.y * (lc0.col.y - behind.y) +
                       g_comp.z * (lc0.col.z - behind.z);
    const V3 g_col0 = g_comp * lc0.a;
    const V3 g_beh = g_comp * (1.0f - lc0.a);
    const float g_a1 = g_beh.x * (lc1.col.x - bg.x) + g_beh.y * (lc1.col.y - bg.y) +
                       g_beh.z * (lc1.col.z - bg.z);
    const V3 g_col1 = g_beh * lc1.a;
    V3 g_bg = g_beh * (1.0f - lc1.a);
    V3 g_amb = zero3(), g_o_cam = zero3(), g_d_cam = zero3();
    const V3 amb = sc.ambient();
    const V3 view = -d;

#pragma unroll 1
    for (int ly = 0; ly < 2; ++ly) {
      const Nearest h = y.l[ly];
      const bool live = h.k >= 0;  // implies inside
      const V3 g_col = ly == 0 ? g_col0 : g_col1;
      if (!live) g_bg = g_bg + g_col;
      const V3 gh = live ? g_col : zero3();
      const float g_alpha = live ? (ly == 0 ? g_a0 : g_a1) : 0.0f;
      const Surface s = layer_surface<SOFT_CHECKER>(sc, o, d, h, ctau);
      const float t = live ? h.t : 0.0f;
      V3 g_base = {gh.x * amb.x * s.ka, gh.y * amb.y * s.ka, gh.z * amb.z * s.ka};
      g_amb = g_amb + V3{gh.x * s.base.x * s.ka, gh.y * s.base.y * s.ka, gh.z * s.base.z * s.ka};
      const float g_ka =
          gh.x * s.base.x * amb.x + gh.y * s.base.y * amb.y + gh.z * s.base.z * amb.z;
      float g_kd = 0.0f, g_ks = 0.0f, g_shin = 0.0f;
      V3 g_n = zero3(), g_d = zero3(), g_so = zero3();
      const V3 so = shadow_origin(o, d, t, s.n);

      for (int l = 0; l < sc.n_light(); ++l) {
        const int cb = ly * gl.L + l;
        const LightGeo lg = light_geometry(sc.l_pos(l), so);
        const float vis = wvis[cb * 32 + lane];
        const float rf = (p.shadows && ((winfo[cb * 3 + 2] >> lane) & 1)) ? 0.0f : 1.0f;
        // shading forward and adjoint of this light
        V3 g_lpos = zero3(), g_lcol = zero3();
        float g_vis = 0.0f;
        V3 g_ldir = zero3();
        if (live) {
          const V3 lcol = sc.l_col(l);
          const float ndl = dot(s.n, lg.ldir);
          const float ndotl = fmaxf(ndl, 0.0f);
          const V3 refl = s.n * (2.0f * ndotl) - lg.ldir;
          const float rdv = dot(refl, view);
          const float rdotv = fmaxf(rdv, 0.0f);
          const float pw = safe_pow(rdotv, s.shin);
          const float spec = s.ks * pw;
          const V3 q = {s.kd * ndotl * s.base.x + spec, s.kd * ndotl * s.base.y + spec,
                        s.kd * ndotl * s.base.z + spec};
          g_lcol = {gh.x * vis * q.x, gh.y * vis * q.y, gh.z * vis * q.z};
          g_vis = gh.x * q.x * lcol.x + gh.y * q.y * lcol.y + gh.z * q.z * lcol.z;
          const V3 g_q = {gh.x * vis * lcol.x, gh.y * vis * lcol.y, gh.z * vis * lcol.z};
          const float g_spec = g_q.x + g_q.y + g_q.z;
          g_kd += g_q.x * ndotl * s.base.x + g_q.y * ndotl * s.base.y + g_q.z * ndotl * s.base.z;
          float g_ndotl =
              g_q.x * s.kd * s.base.x + g_q.y * s.kd * s.base.y + g_q.z * s.kd * s.base.z;
          g_base = g_base + g_q * (s.kd * ndotl);
          g_ks += g_spec * pw;
          const float g_pw = g_spec * s.ks;
          float g_rdotv = 0.0f;
          // safe_pow: exp(shin * log x), no gradient at x <= 0 or past the cap
          if (rdotv > 0.0f && s.shin * logf(rdotv) < POW_LOG_MAX) {
            g_rdotv = g_pw * pw * s.shin / rdotv;
            g_shin += g_pw * pw * logf(rdotv);
          }
          const float g_rdv = g_rdotv * maxgrad(rdv);
          const V3 g_refl = view * g_rdv;
          g_d = g_d - refl * g_rdv;
          g_ndotl += 2.0f * dot(g_refl, s.n);
          const float g_ndl = g_ndotl * maxgrad(ndl);
          g_n = g_n + (g_refl * (2.0f * ndotl) + lg.ldir * g_ndl);
          g_ldir = s.n * g_ndl - g_refl;
        }
        add3(gs, gl.l_col + 3 * l, g_lcol, lane);
        // pass 2: vis = 1 - (1 - rf prod_k (1 - alpha_k)); each kept sphere's
        // factor is the exclusive product, walked backward over the candidates
        const float g_prod = (live && p.shadows) ? -g_vis * rf : 0.0f;  // per (1 - alpha) factor
        if (p.shadows && __any_sync(FULL, g_prod != 0.0f))
          shadow_pass2(sc, so, lg, tau, g_prod, lane, wmask + cb * NWP, winfo + cb * 3, wpre, pcap,
                       wsh, &g_so, &g_ldir);
        if (live) {  // the light's geometry again, rather than held through pass 2
          const LightGeo lga = light_geometry(sc.l_pos(l), so);
          // ldir = lvec / guarded(dist), dist = guarded sqrt(|lvec|^2)
          V3 g_lvec = g_ldir * lga.inv;
          const float g_inv = dot(g_ldir, lga.lvec);
          const float g_dist = lga.dist > 1e-9f ? -g_inv * lga.inv * lga.inv : 0.0f;
          const float g_dist2 = lga.dist2 > 0.0f ? g_dist * 0.5f / lga.dist : 0.0f;
          g_lvec = g_lvec + lga.lvec * (2.0f * g_dist2);
          g_lpos = g_lvec;
          g_so = g_so - g_lvec;
        }
        add3(gs, gl.l_pos + 3 * l, g_lpos, lane);
      }
      // shadow origin so = (o + d t) + n SHADOW_EPS
      V3 g_o = g_so;
      g_d = g_d + g_so * t;
      const float g_t = dot(g_so, d);
      g_n = g_n + g_so * SHADOW_EPS;

      // ---- the layer's winner (with TEX a textured one's texel record)
      [[maybe_unused]] TexelRec orec;
      if constexpr (TEX) orec.base = -1;
      float obj[RF];
#pragma unroll
      for (int f = 0; f < RF; ++f) obj[f] = 0.0f;
      V3 g_c1 = s.use2 ? zero3() : g_base;
      V3 g_c2 = s.use2 ? g_base : zero3();
      if (live && h.k < ns_pad) {
        // n = (o + d t - c) / r, t = -b - sqrt(disc) on a hit, -b on a near
        // miss; alpha = sigmoid(disc / (tau r^2))
        const int k = h.k;
        const V3 c = sc.s_center(k);
        const float rad = sc.s_radius(k);
        const float inv_r = 1.0f / rad;
        const V3 pl = (o + d * t) - c;
        if constexpr (TEX) {
          if (sc.Ks) {  // the lat-long texture at the normal, azimuth wrapped: its texels, and
                        // through the weights the normal (not renormalised: sphere_uv's clamp)
            const UV uv = sphere_uv(s.n);
            orec = {sc.s_tex + 3 * sc.Ks * sc.Ks * k, sc.Ks, tex_weights(uv.u, uv.v, sc.Ks, true),
                    g_base};
            float g_a, g_b;
            bilinear_adjoint(sc.s_texels(k), sc.Ks, orec.w, g_base, &g_a, &g_b);
            g_n = g_n + uv_adjoint(s.n, g_a, g_b);
            g_c1 = zero3();
            g_c2 = zero3();
          }
        }
        V3 g_pl = g_n * inv_r;
        if constexpr (SOFT_CHECKER) {  // base = c1 + u (c2 - c1) at (p - c) s
          const float cs = sc.s_cscale(k), chk = sc.s_checker(k);
          const CheckerAxis ax = checker_axis(pl.x * cs, ctau), ay = checker_axis(pl.y * cs, ctau),
                            az = checker_axis(pl.z * cs, ctau);
          const float par = 0.5f - 0.5f * (ax.f * ay.f * az.f);
          const float u = chk * par;
          const V3 c1 = sc.s_color(k, false), c2 = sc.s_color(k, true);
          g_c1 = g_base * (1.0f - u);
          g_c2 = g_base * u;
          const float g_u = dot(g_base, c2 - c1);
          const float g_q = -0.5f * chk * g_u;
          const V3 g_x = {checker_axis_adjoint(ax, g_q * ay.f * az.f),
                          checker_axis_adjoint(ay, g_q * ax.f * az.f),
                          checker_axis_adjoint(az, g_q * ax.f * ay.f)};
          g_pl = g_pl + g_x * cs;
          obj[SPH_FIELDS] = g_u * par;
          obj[SPH_FIELDS + 1] = g_x.x * pl.x + g_x.y * pl.y + g_x.z * pl.z;
        }
        float g_r = -dot(g_n, pl) * inv_r * inv_r;
        g_o = g_o + g_pl;
        g_d = g_d + g_pl * t;
        const float g_ts = g_t + dot(g_pl, d);
        V3 g_c = -g_pl;
        const V3 oc = o - c;
        const float b = dot(oc, d);
        const float disc = b * b - (dot(oc, oc) - rad * rad);
        const float sqd = sqrtf(disc > 0.0f ? disc : 1.0f);
        const bool hit = disc > 0.0f && -b - sqd > T_EPS;
        float g_disc = hit ? -g_ts * 0.5f / sqd : 0.0f;
        const float den = tau * rad * rad;
        const float sg = sigmoid(disc / den);
        const float g_x = g_alpha * sg * (1.0f - sg);
        g_disc = g_disc + g_x / den;
        g_r = g_r - g_x * disc / (den * den) * (2.0f * tau * rad);
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
        obj[4] = g_c1.x;
        obj[5] = g_c1.y;
        obj[6] = g_c1.z;
        obj[7] = g_c2.x;
        obj[8] = g_c2.y;
        obj[9] = g_c2.z;
        obj[10] = g_ka;
        obj[11] = g_kd;
        obj[12] = g_ks;
        obj[13] = g_shin;
      } else if (live) {
        // t = ((p0 - o) . nraw) / (d . nraw), n = facing * normalize(nraw)
        const int k = h.k - ns_pad;
        const V3 p0 = sc.r_origin(k);
        const V3 eu = sc.r_eu(k), ev = sc.r_ev(k);
        const V3 nraw = cross(eu, ev);
        const float nn2 = dot(nraw, nraw);
        const float inv_n = guarded_inv(nn2);
        const float facing = dot(nraw * inv_n, d) < 0.0f ? 1.0f : -1.0f;
        const float denom = dot(d, nraw);
        const V3 p0o = p0 - o;
        const float num = dot(p0o, nraw);
        float g_tr = g_t;
        V3 g_rel = zero3(), g_eu_ck = zero3(), g_ev_ck = zero3();
        if constexpr (TEX) {
          if (sc.Kr) {  // the texture at (a, b) = (rel . eu / |eu|^2, rel . ev / |ev|^2), rel =
                        // (o + d t) - p0: its texels, and through the weights rel and the edges
            float a, b;
            hit_rect(o, d, p0, eu, ev, &a, &b);
            orec = {sc.r_tex + 3 * sc.Kr * sc.Kr * k, sc.Kr, tex_weights(a, b, sc.Kr, false),
                    g_base};
            float g_a, g_b;
            bilinear_adjoint(sc.r_texels(k), sc.Kr, orec.w, g_base, &g_a, &g_b);
            const V3 rel = (o + d * t) - p0;
            const float inv_uu = 1.0f / dot(eu, eu), inv_vv = 1.0f / dot(ev, ev);
            const float ga = g_a * inv_uu, gb = g_b * inv_vv;
            g_rel = eu * ga + ev * gb;
            g_eu_ck = rel * ga - eu * (2.0f * ga * dot(rel, eu) * inv_uu);
            g_ev_ck = rel * gb - ev * (2.0f * gb * dot(rel, ev) * inv_vv);
            g_tr = g_t + dot(g_rel, d);
            g_c1 = zero3();
            g_c2 = zero3();
          }
        }
        if constexpr (SOFT_CHECKER) {
          // base = c1 + u (c2 - c1) at (a s, b s), (a, b) = (rel . eu / |eu|^2,
          // rel . ev / |ev|^2), rel = (o + d t) - p0 (hit_rect's)
          const float cs = sc.r_cscale(k), chk = sc.r_checker(k);
          const V3 rel = (o + d * t) - p0;
          const float inv_uu = 1.0f / dot(eu, eu), inv_vv = 1.0f / dot(ev, ev);
          const float a = dot(rel, eu) * inv_uu, b = dot(rel, ev) * inv_vv;
          const CheckerAxis aa = checker_axis(a * cs, ctau), ab = checker_axis(b * cs, ctau);
          const float par = 0.5f - 0.5f * (aa.f * ab.f);
          const float u = chk * par;
          const V3 c1 = sc.r_color(k, false), c2 = sc.r_color(k, true);
          g_c1 = g_base * (1.0f - u);
          g_c2 = g_base * u;
          const float g_u = dot(g_base, c2 - c1);
          const float g_q = -0.5f * chk * g_u;
          const float g_xa = checker_axis_adjoint(aa, g_q * ab.f);
          const float g_xb = checker_axis_adjoint(ab, g_q * aa.f);
          obj[RECT_FIELDS] = g_u * par;
          obj[RECT_FIELDS + 1] = g_xa * a + g_xb * b;
          const float ga = g_xa * cs * inv_uu, gb = g_xb * cs * inv_vv;
          g_rel = eu * ga + ev * gb;
          g_eu_ck = rel * ga + eu * (-2.0f * ga * dot(rel, eu) * inv_uu);
          g_ev_ck = rel * gb + ev * (-2.0f * gb * dot(rel, ev) * inv_vv);
          g_tr = g_t + dot(g_rel, d);
        }
        const float g_num = g_tr / denom;
        const float g_den = -g_tr * num / (denom * denom);
        V3 g_p0 = nraw * g_num;
        g_o = g_o - g_p0;
        g_d = g_d + nraw * g_den;
        const V3 g_nraw =
            p0o * g_num + d * g_den + normalize_adjoint(nraw, inv_n, nn2, g_n * facing);
        V3 g_eu = cross(ev, g_nraw);
        V3 g_ev = cross(g_nraw, eu);
        if constexpr (SOFT_CHECKER || TEX) {  // rel = (o + d t) - p0, and (a, b)'s edges
          g_p0 = g_p0 - g_rel;
          g_o = g_o + g_rel;
          g_d = g_d + g_rel * t;
          g_eu = g_eu + g_eu_ck;
          g_ev = g_ev + g_ev_ck;
        }
        obj[0] = g_p0.x;
        obj[1] = g_p0.y;
        obj[2] = g_p0.z;
        obj[3] = g_eu.x;
        obj[4] = g_eu.y;
        obj[5] = g_eu.z;
        obj[6] = g_ev.x;
        obj[7] = g_ev.y;
        obj[8] = g_ev.z;
        obj[9] = g_c1.x;
        obj[10] = g_c1.y;
        obj[11] = g_c1.z;
        obj[12] = g_c2.x;
        obj[13] = g_c2.y;
        obj[14] = g_c2.z;
        obj[15] = g_ka;
        obj[16] = g_kd;
        obj[17] = g_ks;
        obj[18] = g_shin;
      }
      if (live) {
        g_o_cam = g_o_cam + g_o;
        g_d_cam = g_d_cam + g_d;
      }

      // ---- this layer's winners: the warp's list (lane e holds entry e's
      // sums, as lane 0 reduced them), then the block's row, warp by warp
      const int kw = live ? h.k : -1;
      int n = 0, ke = -1;
      float acc[RF];
#pragma unroll
      for (int f = 0; f < RF; ++f) acc[f] = 0.0f;
      for (unsigned todo = __ballot_sync(FULL, kw >= 0); todo;) {
        const int k = __shfl_sync(FULL, kw, __ffs(todo) - 1);
        const unsigned same = __ballot_sync(FULL, kw == k);
        const bool mine = kw == k;
        const int nf = k < ns_pad ? SF : RF;  // the same in every lane
#pragma unroll
        for (int f = 0; f < RF; ++f) {
          if (f < nf) {
            const float v = __shfl_sync(FULL, warp_sum(mine ? obj[f] : 0.0f), 0);
            if (lane == n) acc[f] = v;
          }
        }
        if (lane == n) ke = k;
        ++n;
        todo &= ~same;
      }
      for (int v = 0; v < NWARPS; ++v) {
        if (v == warp && ke >= 0) {
          if (ke < ns_pad) {
#pragma unroll
            for (int f = 0; f < SF; ++f) orow[ke * P_SPH + sph_col_ck(f)] += acc[f];
          } else {
#pragma unroll
            for (int f = 0; f < RF; ++f)
              orow[ns_pad * P_SPH + (ke - ns_pad) * P_RCT + rct_col_ck(f)] += acc[f];
          }
        }
        __syncthreads();
      }
      if constexpr (TEX) scatter_in_turn(orec, trow);
    }

    // ---- the environment's sample at every pixel of the image: its texel
    // record and the cotangent of d; the background gets none
    if constexpr (TEX) {
      if (sc.Ke) {
        TexelRec erec;
        erec.base = -1;
        if (inside) g_d_cam = g_d_cam + env_adjoint(sc, d, g_bg, erec);
        g_bg = zero3();
        scatter_in_turn(erec, gs);
      }
    }

    // ---- camera: o = eye, d = normalize(dt), dt = fwd + right sx + up sy
    // (the ray again, rather than its terms held through the adjoint)
    const Camera cam = camera(sc);
    const Ray r = primary_ray(cam, p, inside ? i : 0, inside ? j : 0);
    const V3 g_dt = normalize_adjoint(r.dt, r.inv, r.n2, g_d_cam);
    const float g_tan = dot(g_dt, cam.right) * r.ax * p.aspect + dot(g_dt, cam.up) * r.ay;
    add(wrow, 0, sq, lane);
    add3(gs, gl.ambient, g_amb, lane);
    add3(gs, gl.background, g_bg, lane);
    add3(gs, gl.c_eye, g_o_cam, lane);
    add3(gx, 0, g_dt, lane);
    add3(gx, 3, g_dt * r.sx, lane);
    add3(gx, 6, g_dt * r.sy, lane);
    add(gx, 9, g_tan, lane);
  };

  if constexpr (TEX) {
    const dim3 tiles = pixel_grid(p.H, p.W);
    for (int t = blockIdx.x; t < (int)(tiles.x * tiles.y); t += gridDim.x)
      tile((t / tiles.x) * BLOCK_Y + threadIdx.y, (t % tiles.x) * BLOCK_X + threadIdx.x);
  } else {
    tile(blockIdx.y * BLOCK_Y + threadIdx.y, blockIdx.x * BLOCK_X + threadIdx.x);
  }
  __syncthreads();

  // ---- the warps' shadow rows into the block's sphere geometry columns
  for (int s = tid; s < N * GEO; s += BLOCK_THREADS) {
    const int k = s / GEO;
    float acc = orow[k * P_SPH + (s - k * GEO)];
    for (int v = 0; v < NWARPS; ++v) acc += shp[v * ns_pad * GEO + s];
    orow[k * P_SPH + (s - k * GEO)] = acc;
  }
  __syncthreads();

  // ---- the block's partial row
  float* prow =
      partials + (long long)(blockIdx.y * gridDim.x + blockIdx.x) * (GROW + OROW + TROW);
  for (int s = tid; s < GROW; s += BLOCK_THREADS) {
    float acc = 0.0f;
    for (int v = 0; v < NWARPS; ++v) acc += wp[v * GROW + s];
    prow[s] = acc;
  }
  for (int s = tid; s < OROW; s += BLOCK_THREADS) prow[GROW + s] = orow[s];
  if constexpr (TEX)  // the texel row ends the partial row
    for (int s = tid; s < TROW; s += BLOCK_THREADS) prow[GROW + OROW + s] = trow[s];
}

// Two blocks per SM: 128 registers a thread. One block lets ptxas keep
// everything in 172 registers, but half the warps in flight took it from
// 0.20 to 0.30 ms at config 5, 512^2 (PERF.md).
template <class Src, bool SOFT_CHECKER>
__global__ void __launch_bounds__(BLOCK_THREADS, 2)
    soft_step_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                     const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                     GLayout gl, Params p, float tau, float ctau, int pcap, Src src,
                     float* __restrict__ partials) {
  soft_step_body<Src, SOFT_CHECKER>(glob, sph, rct, N, M, ns_pad, nr_pad, gl, p, tau, ctau, pcap,
                                    src, partials);
}

// The texel instance (spp 1, the hard checker): one block an SM, as the
// block's texel row leaves no room for a second (rows 5-6's textured
// instances, vec_step.cuh, have the same).
template <class Src>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    soft_step_tex_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                         const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                         EnvGLayout gl, Params p, float tau, int pcap, Src src,
                         float* __restrict__ partials, TexGrids tg) {
  soft_step_body<Src, false, true>(glob, sph, rct, N, M, ns_pad, nr_pad, gl, p, tau, 0.0f, pcap,
                                   src, partials, tg);
}


constexpr int SOFT_REDUCE_RY = 32;  // row subsets per slot in the reduction

inline long long soft_step_scratch_floats(int ns_pad, int nr_pad, int n_light, int H, int W) {
  const dim3 grid = pixel_grid(H, W);
  return ((long long)grid.x * grid.y + 1) * soft_plan(ns_pad, nr_pad, n_light).ROW;
}

// The same for the texel instance, on the grid of one block an SM; -1 if the
// card cannot be queried.
inline long long soft_step_tex_scratch_floats(int n_sph, int n_rect, int n_light, int H, int W,
                                              int ke, int ks, int kr) {
  const SoftPlan plan = soft_tex_plan(n_sph, n_rect, n_light, ke, ks, kr);
  const int nblocks = step_blocks(plan.smem, H, W, 1);
  return nblocks > 0 ? ((long long)nblocks + 1) * plan.ROW : -1;
}

// The reduction and the finalize on one stream after a step kernel's nrows
// partial rows of plan.ROW floats (plan.TROW of them the texel row);
// out = [sq, dglob, dsph, drct (, the texels)].
inline int soft_step_reduce(const float* glob, const GLayout& gl, const SoftPlan& plan,
                            int nrows, float* scratch, float* out, cudaStream_t st) {
  float* rowsum = scratch + (long long)nrows * plan.ROW;
  reduce_rows_kernel<SOFT_REDUCE_RY><<<(plan.ROW + 31) / 32, dim3(32, SOFT_REDUCE_RY), 0, st>>>(
      scratch, nrows, plan.ROW, rowsum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vec_finalize_kernel<<<1, 256, 0, st>>>(rowsum, glob, gl, plan.OROW + plan.TROW, out);
  return (int)cudaGetLastError();
}

// The three launches on one stream; out = [sq, dglob, dsph, drct].
template <class Src, bool SOFT_CHECKER>
int launch_soft_step_instance(const float* glob, const float* sph, const float* rct, int n_sph,
                              int n_rect, int ns_pad, int nr_pad, int n_light, const Params& p,
                              float tau, float ctau, Src src, float* scratch, float* out,
                              void* stream) {
  const GLayout gl = make_glayout(n_light);
  const SoftPlan plan = soft_plan(ns_pad, nr_pad, n_light);
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = pixel_grid(p.H, p.W);
  cudaError_t err;
  if (plan.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(soft_step_kernel<Src, SOFT_CHECKER>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
  }
  soft_step_kernel<Src, SOFT_CHECKER><<<grid, dim3(BLOCK_X, BLOCK_Y), plan.smem, st>>>(
      glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, gl, p, tau, ctau, plan.pcap, src, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return soft_step_reduce(glob, gl, plan, grid.x * grid.y, scratch, out, st);
}

// The soft checker's instance where checker_tau > 0, else the other. p
// gives the image, the flags and the subsample offset: 0 for the step,
// which is spp 1 (as the TPU's, fused_vec_soft.py:365-380); one of spp 4's
// four for a launch of the render backward.
template <class Src>
int launch_soft_step(const float* glob, const float* sph, const float* rct, int n_sph,
                     int n_rect, int ns_pad, int nr_pad, int n_light, const Params& p, float tau,
                     float ctau, Src src, float* scratch, float* out, void* stream) {
  if (ctau > 0.0f)
    return launch_soft_step_instance<Src, true>(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad,
                                                n_light, p, tau, ctau, src, scratch, out,
                                                stream);
  return launch_soft_step_instance<Src, false>(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad,
                                               n_light, p, tau, ctau, src, scratch, out, stream);
}

// The texel instance (spp 1, the hard checker): an environment map of side
// ke and object texel grids tg (sides 0 for none), on a grid of one block an
// SM; out = [sq, dglob, dsph, drct, the spheres' texels, the rects'].
template <class Src>
int launch_soft_step_tex(const float* glob, const float* sph, const float* rct, int n_sph,
                         int n_rect, int n_light, int ke, const TexGrids& tg, const Params& p,
                         float tau, Src src, float* scratch, float* out, void* stream) {
  if (ke < 0 || tg.Ks < 0 || tg.Kr < 0) return (int)cudaErrorInvalidValue;
  const SoftPlan plan = soft_tex_plan(n_sph, n_rect, n_light, ke, tg.Ks, tg.Kr);
  if (plan.smem > (size_t)smem_optin()) return (int)cudaErrorInvalidValue;  // Python refuses it
  const int nblocks = step_blocks(plan.smem, p.H, p.W, 1);
  if (nblocks <= 0) return (int)cudaErrorInvalidDevice;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto kernel = soft_step_tex_kernel<Src>;
  cudaError_t err;
  if (plan.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const EnvGLayout gl = make_env_glayout(n_light, ke);
  kernel<<<nblocks, dim3(BLOCK_X, BLOCK_Y), plan.smem, st>>>(
      glob, sph, rct, n_sph, n_rect, pad16(n_sph), pad16(n_rect), gl, p, tau, plan.pcap, src,
      scratch, tg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return soft_step_reduce(glob, gl, plan, nblocks, scratch, out, st);
}

}  // namespace rrt
