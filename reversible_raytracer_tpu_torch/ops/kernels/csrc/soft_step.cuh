// The kernels of the soft-visibility fused step (soft_tau > 0, packed
// rows), shared by the training step (fused_vec_soft_step.cu,
// ResidualSource) and the soft render backward
// (fused_vec_soft_render_bwd.cu, CotangentSource, whose visibility planes
// are not read: soft shadows carry gradient and are recomputed): one body,
// two kernels, as the TPU's make_bwd_kernel builds its step and backward.
//
// 1. soft_step_kernel: one thread per pixel, 32 x 8 pixels per block, the
//    globals and packed rows staged in shared memory. Each thread runs the
//    forward (soft_common.cuh), takes the image cotangent from its source,
//    and runs the hand-written adjoint that ops/kernels/fused_vec_soft.py's
//    _soft_adjoint runs in eager torch: the composite, then per layer the
//    shading, the soft shadow product's transpose, the light geometry and
//    the layer's winner, then the camera as 10 ray-form cotangents.
//    - The shadow product's transpose needs, per occluding sphere k, the
//      exclusive product prod_{j != k} (1 - alpha_j) times the rect factor,
//      exact where a factor is 0 (a hard rect, a saturated sigmoid), so
//      never a division. Pass 1 keeps the running product at each boundary
//      of 16 spheres (a short per-thread array); pass 2 walks the chunks
//      backward with the suffix, recomputing each chunk's 16 factors and
//      their in-chunk prefixes in registers.
//    - Every sphere gets a shadow-silhouette gradient from every pixel whose
//      shadow ray it softly covers: dense in N. Each warp reduces the 4
//      geometry cotangents (center, radius) of each sphere by shuffle, and
//      lane 0 adds them into the warp's own row of ns_pad x 4 floats in
//      shared memory; the warps' rows are summed in warp order at the end.
//    - The two layers' winners go, layer by layer, through per-warp lists
//      of at most 32 distinct objects (as vec_step.cuh) into one block
//      row of every object field, warp by warp.
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

#include "soft_common.cuh"

namespace rrt {

constexpr int CH = 16;          // spheres per chunk of the exclusive products
constexpr int MAX_CHUNKS = 64;  // so at most 1024 spheres
constexpr int GEO = 4;          // center (3) and radius: the shadow gradient per sphere

struct SoftPlan {
  int Sg, GROW, OROW, ROW;
  size_t smem;
};

inline SoftPlan soft_plan(int ns_pad, int nr_pad, int n_light) {
  SoftPlan s;
  s.Sg = make_glayout(n_light).Sg;
  s.GROW = 1 + s.Sg + CAM_EXTRA;
  s.OROW = ns_pad * P_SPH + nr_pad * P_RCT;
  s.ROW = s.GROW + s.OROW;
  // globals, rows, warp rows, block object row, warp lists, warp shadow rows;
  // then the lists' ids and counts
  s.smem = (size_t)(s.Sg + s.OROW + NWARPS * s.GROW + s.OROW + NWARPS * 32 * RECT_FIELDS +
                    NWARPS * ns_pad * GEO) *
               sizeof(float) +
           (size_t)(NWARPS * 32 + NWARPS) * sizeof(int);
  return s;
}

// Lane 0 adds the warp's sum of v to slot (both layers add to one slot).
__device__ __forceinline__ void add(float* row, int slot, float v, int lane) {
  v = warp_sum(v);
  if (lane == 0) row[slot] += v;
}

__device__ __forceinline__ void add3(float* row, int slot, V3 v, int lane) {
  add(row, slot, v.x, lane);
  add(row, slot + 1, v.y, lane);
  add(row, slot + 2, v.z, lane);
}

// Cotangents of the shadow coverage alpha of sphere (c, r) for the ray
// (so, ld) toward a light at dist, given g_alpha: adds to g_so and g_ld
// and returns those of the center (x, y, z) and radius (w). The gate, and
// with it dist, carries no gradient.
__device__ __forceinline__ float4 shadow_alpha_adjoint(V3 so, V3 ld, float dist, V3 c, float r,
                                                       float tau, float g_alpha, V3* g_so,
                                                       V3* g_ld) {
  const V3 oc = so - c;
  const float b = dot(oc, ld);
  const float disc = b * b - (dot(oc, oc) - r * r);
  const float t = -b - sqrtf(disc > 0.0f ? disc : 1.0f);
  const bool between =
      (disc > 0.0f && t > T_EPS && t < dist) || (-b > T_EPS && -b < dist);
  if (!between) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float den = tau * r * r;
  const float s = sigmoid(disc / den);
  const float g_x = g_alpha * s * (1.0f - s);
  const float g_disc = g_x / den;
  float g_r = -g_x * disc / (den * den) * (2.0f * tau * r);
  const float g_b = 2.0f * b * g_disc;
  const float g_cc = -g_disc;
  const V3 g_oc = oc * (2.0f * g_cc) + ld * g_b;
  g_r = g_r - 2.0f * r * g_cc;
  *g_so = *g_so + g_oc;
  *g_ld = *g_ld + oc * g_b;
  return make_float4(-g_oc.x, -g_oc.y, -g_oc.z, g_r);
}

template <class Src>
__global__ void __launch_bounds__(BLOCK_THREADS)
    soft_step_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                     const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                     GLayout gl, Params p, float tau, Src src, float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int GROW = 1 + gl.Sg + CAM_EXTRA;
  const int OROW = ns_pad * P_SPH + nr_pad * P_RCT;
  float* g = smem;
  float* s_sph = g + gl.Sg;
  float* s_rct = s_sph + ns_pad * P_SPH;
  float* wp = s_rct + nr_pad * P_RCT;  // NWARPS rows of GROW
  float* orow = wp + NWARPS * GROW;    // the block's object row (OROW)
  float* wval = orow + OROW;           // NWARPS x 32 entries of RECT_FIELDS
  float* shp = wval + NWARPS * 32 * RECT_FIELDS;  // NWARPS rows of ns_pad x GEO
  int* wid = (int*)(shp + NWARPS * ns_pad * GEO);  // NWARPS x 32 winner ids
  int* wcnt = wid + NWARPS * 32;                   // entries per warp
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

  const int j = blockIdx.x * BLOCK_X + threadIdx.x;
  const int i = blockIdx.y * BLOCK_Y + threadIdx.y;
  const bool inside = i < p.H && j < p.W;
  const PackedScene sc{g, s_sph, s_rct, gl, N, M, ns_pad};

  // ---- forward
  const Camera cam = camera(sc);
  const Ray r = primary_ray(cam, p, inside ? i : 0, inside ? j : 0);
  const V3 o = cam.eye, d = r.d;
  Layers y = {{{BIG, -1}, {BIG, -1}}};
  if (inside) y = two_layers(sc, o, d, tau);
  const LayerColor lc[2] = {layer_color(sc, p, o, d, y.l[0], tau),
                            layer_color(sc, p, o, d, y.l[1], tau)};
  const V3 bg = sc.background();
  V3 behind;
  const V3 comp = composite(lc[0], lc[1], bg, &behind);
  const V3 img = p.clip ? V3{clip01(comp.x), clip01(comp.y), clip01(comp.z)} : comp;

  // ---- the clipped image's cotangent (its source's), then the clip's
  float sq;
  V3 g_comp = src.cotangent(p, i, j, inside, img, &sq);
  if (p.clip)
    g_comp = {g_comp.x * clipgrad(comp.x), g_comp.y * clipgrad(comp.y),
              g_comp.z * clipgrad(comp.z)};

  // ---- composite adjoint
  float g_a[2];
  V3 g_col[2];
  g_a[0] = g_comp.x * (lc[0].col.x - behind.x) + g_comp.y * (lc[0].col.y - behind.y) +
           g_comp.z * (lc[0].col.z - behind.z);
  g_col[0] = g_comp * lc[0].a;
  const V3 g_beh = g_comp * (1.0f - lc[0].a);
  g_a[1] = g_beh.x * (lc[1].col.x - bg.x) + g_beh.y * (lc[1].col.y - bg.y) +
           g_beh.z * (lc[1].col.z - bg.z);
  g_col[1] = g_beh * lc[1].a;
  V3 g_bg = g_beh * (1.0f - lc[1].a);
  V3 g_amb = zero3(), g_o_cam = zero3(), g_d_cam = zero3();
  const V3 amb = sc.ambient();
  const V3 view = -d;

#pragma unroll 1
  for (int ly = 0; ly < 2; ++ly) {
    const Nearest h = y.l[ly];
    const bool live = h.k >= 0;  // implies inside
    if (!live) g_bg = g_bg + g_col[ly];
    const V3 gh = live ? g_col[ly] : zero3();
    const float g_alpha = live ? g_a[ly] : 0.0f;
    const Surface s = surface(sc, o, d, h);
    const float t = live ? h.t : 0.0f;
    V3 g_base = {gh.x * amb.x * s.ka, gh.y * amb.y * s.ka, gh.z * amb.z * s.ka};
    g_amb = g_amb + V3{gh.x * s.base.x * s.ka, gh.y * s.base.y * s.ka, gh.z * s.base.z * s.ka};
    const float g_ka =
        gh.x * s.base.x * amb.x + gh.y * s.base.y * amb.y + gh.z * s.base.z * amb.z;
    float g_kd = 0.0f, g_ks = 0.0f, g_shin = 0.0f;
    V3 g_n = zero3(), g_d = zero3(), g_so = zero3();
    const V3 so = shadow_origin(o, d, t, s.n);
    const bool warp_live = __any_sync(FULL, live);

    for (int l = 0; l < sc.n_light(); ++l) {
      const LightGeo lg = light_geometry(sc.l_pos(l), so);
      // pass 1: the running product of the sphere factors at each chunk
      // boundary, the rect factor, and the visibility
      float cpre[MAX_CHUNKS];
      float rf = 1.0f, vis = 1.0f;
      const int nch = (N + CH - 1) / CH;
      if (live && p.shadows) {
        float run = 1.0f;
        for (int c = 0; c < nch; ++c) {
          cpre[c] = run;
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            const int k = c * CH + u;
            if (k < N)
              run *= 1.0f - shadow_alpha(so, lg.ldir, lg.dist, sc.s_center(k), sc.s_radius(k),
                                         tau);
          }
        }
        rf = rect_factor(sc, so, lg.ldir, lg.dist);
        vis = 1.0f - (1.0f - run * rf);
      }
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
      // pass 2: vis = 1 - (1 - rf prod_k (1 - alpha_k)); the factor of
      // sphere k is the exclusive product, walked backward chunk by chunk
      const float g_prod = (live && p.shadows) ? -g_vis * rf : 0.0f;  // per (1 - alpha) factor
      V3 g_so_sh = zero3(), g_ld_sh = zero3();
      if (p.shadows && __any_sync(FULL, g_prod != 0.0f)) {
        float suf = 1.0f;
        for (int c = nch - 1; c >= 0; --c) {
          float om[CH], inpre[CH];
          float run = 1.0f;
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            const int k = c * CH + u;
            om[u] = (g_prod != 0.0f && k < N)
                        ? 1.0f - shadow_alpha(so, lg.ldir, lg.dist, sc.s_center(k),
                                              sc.s_radius(k), tau)
                        : 1.0f;
            inpre[u] = run;
            run *= om[u];
          }
          const float exterior = (g_prod != 0.0f) ? cpre[c] * suf : 0.0f;
          float insuf = 1.0f;
#pragma unroll
          for (int u = CH - 1; u >= 0; --u) {
            const int k = c * CH + u;
            float4 gk = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (g_prod != 0.0f && k < N)
              gk = shadow_alpha_adjoint(so, lg.ldir, lg.dist, sc.s_center(k), sc.s_radius(k),
                                        tau, g_prod * exterior * inpre[u] * insuf, &g_so_sh,
                                        &g_ld_sh);
            insuf *= om[u];
            if (k < N && __any_sync(FULL, gk.x != 0.0f || gk.y != 0.0f || gk.z != 0.0f ||
                                              gk.w != 0.0f)) {
              float* row = wsh + k * GEO;
              add(row, 0, gk.x, lane);
              add(row, 1, gk.y, lane);
              add(row, 2, gk.z, lane);
              add(row, 3, gk.w, lane);
            }
          }
          suf *= run;
        }
      }
      if (live) {
        g_ldir = g_ldir + g_ld_sh;
        // ldir = lvec / guarded(dist), dist = guarded sqrt(|lvec|^2)
        V3 g_lvec = g_ldir * lg.inv;
        const float g_inv = dot(g_ldir, lg.lvec);
        const float g_dist = lg.dist > 1e-9f ? -g_inv * lg.inv * lg.inv : 0.0f;
        const float g_dist2 = lg.dist2 > 0.0f ? g_dist * 0.5f / lg.dist : 0.0f;
        g_lvec = g_lvec + lg.lvec * (2.0f * g_dist2);
        g_lpos = g_lvec;
        g_so = g_so + g_so_sh - g_lvec;
      }
      if (warp_live) {
        add3(gs, gl.l_pos + 3 * l, g_lpos, lane);
        add3(gs, gl.l_col + 3 * l, g_lcol, lane);
      }
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

    // ---- this layer's winners: the warp's list, then the block's row
    const int kw = live ? h.k : -1;
    const int base = warp * 32;
    int n = 0;
    for (unsigned todo = __ballot_sync(FULL, kw >= 0); todo;) {
      const int k = __shfl_sync(FULL, kw, __ffs(todo) - 1);
      const unsigned same = __ballot_sync(FULL, kw == k);
      const bool mine = kw == k;
      const int nf = k < ns_pad ? SPH_FIELDS : RECT_FIELDS;  // the same in every lane
#pragma unroll
      for (int f = 0; f < RECT_FIELDS; ++f) {
        if (f < nf) {
          const float v = warp_sum(mine ? obj[f] : 0.0f);
          if (lane == 0) wval[(base + n) * RECT_FIELDS + f] = v;
        }
      }
      if (lane == 0) wid[base + n] = k;
      ++n;
      todo &= ~same;
    }
    if (lane == 0) wcnt[warp] = n;
    __syncthreads();
    for (int v = 0; v < NWARPS; ++v) {
      const int cnt = wcnt[v];
      for (int e = tid; e < cnt * RECT_FIELDS; e += BLOCK_THREADS) {
        const int idx = e / RECT_FIELDS;
        const int f = e - idx * RECT_FIELDS;
        const int k = wid[v * 32 + idx];
        const float val = wval[(v * 32 + idx) * RECT_FIELDS + f];
        if (k < ns_pad) {
          if (f < SPH_FIELDS) orow[k * P_SPH + sph_col(f)] += val;
        } else {
          orow[ns_pad * P_SPH + (k - ns_pad) * P_RCT + rct_col(f)] += val;
        }
      }
      __syncthreads();
    }
  }

  // ---- camera: o = eye, d = normalize(dt), dt = fwd + right sx + up sy
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

// The most spheres the exclusive products' chunk boundaries can hold.
inline int soft_max_spheres() { return CH * MAX_CHUNKS; }

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
      glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, gl, p, tau, src, partials);
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
