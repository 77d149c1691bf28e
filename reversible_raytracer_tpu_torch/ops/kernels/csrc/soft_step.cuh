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
// No atomics: the result is bit-for-bit the same from call to call on one
// card. Pad rows are never read and their gradient is exactly zero; so are
// the checker, checker-scale and mirror columns.
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
  int Sg, GROW, OROW, ROW, NWP, NC, pcap;
  size_t smem;
};

// The block's shared memory, with as many prefix slots per lane (pcap, at
// least 1, at most PCAP) as the card's opt-in leaves room for; a scene that
// does not fit with one slot gets a size over the opt-in, which the
// wrappers refuse.
inline SoftPlan soft_plan(int ns_pad, int nr_pad, int n_light) {
  SoftPlan s;
  s.Sg = make_glayout(n_light).Sg;
  s.GROW = 1 + s.Sg + CAM_EXTRA;
  s.OROW = ns_pad * P_SPH + nr_pad * P_RCT;
  s.ROW = s.GROW + s.OROW;
  s.NWP = (ns_pad + 31) / 32;  // candidate mask words per layer and light
  s.NC = 2 * n_light;          // layers x lights
  // globals, rows, warp rows, block object row, warp shadow rows, warp
  // visibilities; the candidate masks and per layer and light [slot, count,
  // rect bits]; then the warps' prefix slots
  const size_t base = (size_t)(s.Sg + s.OROW + NWARPS * s.GROW + s.OROW +
                               NWARPS * ns_pad * GEO + NWARPS * s.NC * 32) *
                          sizeof(float) +
                      (size_t)(NWARPS * s.NC * (s.NWP + 3)) * sizeof(int);
  const size_t per_slot = (size_t)NWARPS * 32 * sizeof(float);
  const long long room = (smem_optin() - (long long)base) / (long long)per_slot;
  s.pcap = (int)(room < 1 ? 1 : room > PCAP ? PCAP : room);
  s.smem = base + s.pcap * per_slot;
  return s;
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

// Two blocks per SM: 128 registers a thread. One block lets ptxas keep
// everything in 172 registers, but half the warps in flight took it from
// 0.20 to 0.30 ms at config 5, 512^2 (PERF.md).
template <class Src>
__global__ void __launch_bounds__(BLOCK_THREADS, 2)
    soft_step_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                     const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                     GLayout gl, Params p, float tau, int pcap, Src src,
                     float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int GROW = 1 + gl.Sg + CAM_EXTRA;
  const int OROW = ns_pad * P_SPH + nr_pad * P_RCT;
  const int NWP = (ns_pad + 31) / 32;
  const int NC = 2 * gl.L;
  float* g = smem;
  float* s_sph = g + gl.Sg;
  float* s_rct = s_sph + ns_pad * P_SPH;
  float* wp = s_rct + nr_pad * P_RCT;  // NWARPS rows of GROW
  float* orow = wp + NWARPS * GROW;    // the block's object row (OROW)
  float* shp = orow + OROW;            // NWARPS rows of ns_pad x GEO
  float* vsh = shp + NWARPS * ns_pad * GEO;          // NWARPS x NC x 32 visibilities
  unsigned* cmask = (unsigned*)(vsh + NWARPS * NC * 32);  // NWARPS x NC x NWP candidate masks
  int* cinfo = (int*)(cmask + NWARPS * NC * NWP);   // NWARPS x NC x [slot, count, rect bits]
  float* pre = (float*)(cinfo + NWARPS * NC * 3);   // NWARPS x pcap slots x 32 lanes
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  stage(g, glob, gl.Sg);
  stage(s_sph, sph, ns_pad * P_SPH);
  stage(s_rct, rct, nr_pad * P_RCT);
  for (int s = tid; s < NWARPS * GROW + OROW; s += BLOCK_THREADS) wp[s] = 0.0f;
  for (int s = tid; s < NWARPS * ns_pad * GEO; s += BLOCK_THREADS) shp[s] = 0.0f;
  __syncthreads();
  float* wrow = wp + warp * GROW;  // [sq, globals (Sg), camera basis (10)]
  float* gs = wrow + 1;
  float* gx = wrow + 1 + gl.Sg;
  float* wsh = shp + warp * ns_pad * GEO;
  float* wpre = pre + warp * pcap * 32;
  float* wvis = vsh + warp * NC * 32;
  unsigned* wmask = cmask + warp * NC * NWP;
  int* winfo = cinfo + warp * NC * 3;

  const int j = blockIdx.x * BLOCK_X + threadIdx.x;
  const int i = blockIdx.y * BLOCK_Y + threadIdx.y;
  const bool inside = i < p.H && j < p.W;
  const PackedScene sc{g, s_sph, s_rct, gl, N, M, ns_pad};

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
    const Surface s = surface(sc, o, d, h);
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
  const V3 bg = sc.background();
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
    const Surface s = surface(sc, o, d, h);
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
        if (rdotv > 0.0f) {  // safe_pow: exp(shin * log x), no gradient at x <= 0
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

    // ---- the layer's winner
    float obj[RECT_FIELDS];
#pragma unroll
    for (int f = 0; f < RECT_FIELDS; ++f) obj[f] = 0.0f;
    const V3 g_c1 = s.use2 ? zero3() : g_base;
    const V3 g_c2 = s.use2 ? g_base : zero3();
    if (live && h.k < ns_pad) {
      // n = (o + d t - c) / r, t = -b - sqrt(disc) on a hit, -b on a near
      // miss; alpha = sigmoid(disc / (tau r^2))
      const int k = h.k;
      const V3 c = sc.s_center(k);
      const float rad = sc.s_radius(k);
      const float inv_r = 1.0f / rad;
      const V3 pl = (o + d * t) - c;
      const V3 g_pl = g_n * inv_r;
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
    float acc[RECT_FIELDS];
#pragma unroll
    for (int f = 0; f < RECT_FIELDS; ++f) acc[f] = 0.0f;
    for (unsigned todo = __ballot_sync(FULL, kw >= 0); todo;) {
      const int k = __shfl_sync(FULL, kw, __ffs(todo) - 1);
      const unsigned same = __ballot_sync(FULL, kw == k);
      const bool mine = kw == k;
      const int nf = k < ns_pad ? SPH_FIELDS : RECT_FIELDS;  // the same in every lane
#pragma unroll
      for (int f = 0; f < RECT_FIELDS; ++f) {
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
          for (int f = 0; f < SPH_FIELDS; ++f) orow[ke * P_SPH + sph_col(f)] += acc[f];
        } else {
#pragma unroll
          for (int f = 0; f < RECT_FIELDS; ++f)
            orow[ns_pad * P_SPH + (ke - ns_pad) * P_RCT + rct_col(f)] += acc[f];
        }
      }
      __syncthreads();
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
  float* prow = partials + (long long)(blockIdx.y * gridDim.x + blockIdx.x) * (GROW + OROW);
  for (int s = tid; s < GROW; s += BLOCK_THREADS) {
    float acc = 0.0f;
    for (int v = 0; v < NWARPS; ++v) acc += wp[v * GROW + s];
    prow[s] = acc;
  }
  for (int s = tid; s < OROW; s += BLOCK_THREADS) prow[GROW + s] = orow[s];
}

constexpr int SOFT_REDUCE_RY = 32;  // row subsets per slot in the reduction

inline long long soft_step_scratch_floats(int ns_pad, int nr_pad, int n_light, int H, int W) {
  const dim3 grid = pixel_grid(H, W);
  return ((long long)grid.x * grid.y + 1) * soft_plan(ns_pad, nr_pad, n_light).ROW;
}

// The three launches on one stream; out = [sq, dglob, dsph, drct].
template <class Src>
int launch_soft_step(const float* glob, const float* sph, const float* rct, int n_sph,
                     int n_rect, int ns_pad, int nr_pad, int n_light, int H, int W, int shadows,
                     int clip, float tau, Src src, float* scratch, float* out, void* stream) {
  const GLayout gl = make_glayout(n_light);
  const Params p = make_params(H, W, shadows, clip);
  const SoftPlan plan = soft_plan(ns_pad, nr_pad, n_light);
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = pixel_grid(H, W);
  const int nrows = grid.x * grid.y;
  float* partials = scratch;
  float* rowsum = scratch + (long long)nrows * plan.ROW;
  cudaError_t err;
  if (plan.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(soft_step_kernel<Src>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
  }
  soft_step_kernel<Src><<<grid, dim3(BLOCK_X, BLOCK_Y), plan.smem, st>>>(
      glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, gl, p, tau, plan.pcap, src, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<SOFT_REDUCE_RY><<<(plan.ROW + 31) / 32, dim3(32, SOFT_REDUCE_RY), 0, st>>>(
      partials, nrows, plan.ROW, rowsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vec_finalize_kernel<<<1, 256, 0, st>>>(rowsum, glob, gl, plan.OROW, out);
  return (int)cudaGetLastError();
}

}  // namespace rrt
