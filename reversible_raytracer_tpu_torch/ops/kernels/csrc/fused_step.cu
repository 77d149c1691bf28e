// Fused training-step kernel: the squared-error loss of the render against
// a target, and its gradient with respect to every scalar of the flat
// scene, in one call (three launches on one stream).
//
// Replaces the TPU kernel _make_loss_grad.kernel
// (reversible_raytracer_tpu/ops/kernels/fused.py:394, pallas_call at :436),
// which replays render_tile under jax.vjp per tile and adds each tile's
// gradient into one output row across the in-order TPU grid. A GPU grid
// has no order, and CUDA has no autodiff, so:
//
// 1. step_kernel: one thread per pixel, 32 x 8 pixels per block, scene in
//    shared memory. Each thread runs the forward (ray, nearest hit, shading
//    with the shadow rays' visibility kept as bits), takes the residual
//    against the target (threads past the ragged edge contribute zero: that
//    is the TPU padding mask), and runs the hand-written adjoint of the
//    pixel: shade adjoint, then the adjoint of the winning object only
//    (the where chain passes no gradient to the losers, and visibility is
//    a step with zero gradient, though the shadow origin still carries
//    gradient through light_geometry into t, n and d), then the camera.
//    The camera part is accumulated as the cotangents of the per-pixel
//    linear form dt = fwd + right sx + up sy (g_fwd, g_right, g_up and
//    g_tan of tan(fov/2)): 10 scalars instead of pulling 10 camera leaves
//    through camera_basis in every pixel.
//    Each warp sums every gradient slot with shuffles (skipping objects no
//    lane of the warp hit) into its row of shared memory; the block adds
//    its 8 warp rows in order and writes one partial row of
//    1 + S + 10 floats.
// 2. reduce_rows_kernel sums the partial rows, slot by slot, in a fixed
//    order.
// 3. finalize_kernel copies loss and gradients out and applies the
//    camera_basis / normalize / tan(deg2rad) chain once.
//
// No atomics: for a given image size the result is bit-for-bit the same
// from run to run on one card.
//
// Bound: operations. Per pixel the forward and its adjoint are a few
// hundred to a few thousand float operations (the shadow rays test every
// object), against 12 bytes of target read. chip_smoke.py counts them.
#include "render_common.cuh"

using namespace rrt;

namespace {

constexpr int NWARPS = BLOCK_THREADS / 32;
constexpr int CAM_EXTRA = 10;  // g_fwd (3), g_right (3), g_up (3), g_tan
constexpr int SPH_FIELDS = 14;
constexpr int RECT_FIELDS = 19;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int row_len(const Layout& ly) { return 1 + ly.S + CAM_EXTRA; }

__device__ __forceinline__ V3 zero3() { return {0.0f, 0.0f, 0.0f}; }

// Lane 0 stores the warp's sum of v (fixed shuffle tree) into slot.
__device__ __forceinline__ void put(float* row, int slot, float v, int lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  if (lane == 0) row[slot] = v;
}

__device__ __forceinline__ void put3(float* row, int slot, V3 v, int lane) {
  put(row, slot, v.x, lane);
  put(row, slot + 1, v.y, lane);
  put(row, slot + 2, v.z, lane);
}

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

// Flat index of field f of sphere k: center (3), radius, color (3),
// color2 (3), ka, kd, ks, shininess.
__device__ __forceinline__ int sphere_slot(const Layout& ly, int k, int f) {
  if (f < 3) return ly.s_center + 3 * k + f;
  if (f == 3) return ly.s_radius + k;
  if (f < 7) return ly.s_color + 3 * k + (f - 4);
  if (f < 10) return ly.s_color2 + 3 * k + (f - 7);
  if (f == 10) return ly.s_ka + k;
  if (f == 11) return ly.s_kd + k;
  if (f == 12) return ly.s_ks + k;
  return ly.s_shin + k;
}

// Field f of rect k: origin (3), edge_u (3), edge_v (3), color (3),
// color2 (3), ka, kd, ks, shininess.
__device__ __forceinline__ int rect_slot(const Layout& ly, int k, int f) {
  if (f < 3) return ly.r_origin + 3 * k + f;
  if (f < 6) return ly.r_eu + 3 * k + (f - 3);
  if (f < 9) return ly.r_ev + 3 * k + (f - 6);
  if (f < 12) return ly.r_color + 3 * k + (f - 9);
  if (f < 15) return ly.r_color2 + 3 * k + (f - 12);
  if (f == 15) return ly.r_ka + k;
  if (f == 16) return ly.r_kd + k;
  if (f == 17) return ly.r_ks + k;
  return ly.r_shin + k;
}

__global__ void __launch_bounds__(BLOCK_THREADS)
    step_kernel(const float* __restrict__ flat, Params p, Layout ly,
                const float* __restrict__ target, float w, float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* sc = smem;
  const int ROW = row_len(ly);
  float* wp = smem + ly.S;  // NWARPS rows of ROW slots
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  stage_scene(sc, flat, ly.S);
  for (int s = tid; s < NWARPS * ROW; s += BLOCK_THREADS) wp[s] = 0.0f;
  __syncthreads();
  float* wrow = wp + warp * ROW;  // [sq, scene grads (S), camera basis (10)]
  float* gs = wrow + 1;
  float* gx = wrow + 1 + ly.S;

  // ---- forward
  const int j = blockIdx.x * BLOCK_X + threadIdx.x;
  const int i = blockIdx.y * BLOCK_Y + threadIdx.y;
  const bool inside = i < p.H && j < p.W;
  const Camera cam = camera(sc, ly);
  const Ray r = primary_ray(cam, p, inside ? i : 0, inside ? j : 0);
  const V3 o = cam.eye, d = r.d;
  const Nearest h = inside ? trace(sc, ly, o, d) : Nearest{BIG, -1};
  const bool hit = h.k >= 0;
  const Surface s = surface(sc, ly, o, d, h);
  unsigned bits = 0;
  V3 pre = ld3(sc + ly.background);
  if (hit) pre = shade_hit(sc, ly, p, o, d, h.t, s, &bits);
  const V3 img = p.clip ? V3{clip01(pre.x), clip01(pre.y), clip01(pre.z)} : pre;

  // ---- residual; its cotangent is 2 w (render - target)
  V3 res = zero3();
  if (inside) {
    const float* tp = target + 3 * ((long long)i * p.W + j);
    res = {img.x - tp[0], img.y - tp[1], img.z - tp[2]};
  }
  const float sq = res.x * res.x + res.y * res.y + res.z * res.z;
  V3 gc = res * (2.0f * w);
  if (p.clip) gc = {gc.x * clipgrad(pre.x), gc.y * clipgrad(pre.y), gc.z * clipgrad(pre.z)};

  // ---- shade adjoint: ambient term, then light by light
  const V3 gh = hit ? gc : zero3();
  const V3 gbg = hit ? zero3() : gc;
  const V3 amb = ld3(sc + ly.ambient);
  V3 g_base = {gh.x * amb.x * s.ka, gh.y * amb.y * s.ka, gh.z * amb.z * s.ka};
  const V3 g_amb = {gh.x * s.base.x * s.ka, gh.y * s.base.y * s.ka, gh.z * s.base.z * s.ka};
  const float g_ka = gh.x * s.base.x * amb.x + gh.y * s.base.y * amb.y + gh.z * s.base.z * amb.z;
  float g_kd = 0.0f, g_ks = 0.0f, g_shin = 0.0f;
  V3 g_n = zero3(), g_d = zero3(), g_so = zero3();
  const V3 view = -d;
  const V3 so = shadow_origin(o, d, h.t, s.n);
  const bool warp_hit = __any_sync(FULL, hit);
  for (int l = 0; l < ly.L; ++l) {
    V3 g_lpos = zero3(), g_lcol = zero3();
    if (hit && ((bits >> l) & 1u)) {  // a shadowed light contributes nothing
      const LightGeo g = light_geometry(ld3(sc + ly.l_pos + 3 * l), so);
      const V3 lcol = ld3(sc + ly.l_col + 3 * l);
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
    if (warp_hit) {
      put3(gs, ly.l_pos + 3 * l, g_lpos, lane);
      put3(gs, ly.l_col + 3 * l, g_lcol, lane);
    }
  }
  // shadow origin so = (o + d t) + n SHADOW_EPS
  V3 g_o = g_so;
  g_d = g_d + g_so * h.t;
  const float g_t = dot(g_so, d);
  g_n = g_n + g_so * SHADOW_EPS;

  // ---- the winning object's adjoint
  float gobj[RECT_FIELDS];
#pragma unroll
  for (int f = 0; f < RECT_FIELDS; ++f) gobj[f] = 0.0f;
  const V3 g_col = s.use2 ? zero3() : g_base;
  const V3 g_col2 = s.use2 ? g_base : zero3();
  if (hit && h.k < ly.N) {
    // n = (o + d t - c) / r;  t = -b - sqrt(b^2 - |oc|^2 + r^2), b = oc . d
    const int k = h.k;
    const V3 c = ld3(sc + ly.s_center + 3 * k);
    const float rad = sc[ly.s_radius + k];
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
    gobj[0] = g_c.x;
    gobj[1] = g_c.y;
    gobj[2] = g_c.z;
    gobj[3] = g_r;
    gobj[4] = g_col.x;
    gobj[5] = g_col.y;
    gobj[6] = g_col.z;
    gobj[7] = g_col2.x;
    gobj[8] = g_col2.y;
    gobj[9] = g_col2.z;
    gobj[10] = g_ka;
    gobj[11] = g_kd;
    gobj[12] = g_ks;
    gobj[13] = g_shin;
  } else if (hit) {
    // t = ((p0 - o) . nraw) / (d . nraw), n = facing * normalize(nraw),
    // nraw = edge_u x edge_v; facing is a sign with no gradient.
    const int k = h.k - ly.N;
    const V3 p0 = ld3(sc + ly.r_origin + 3 * k);
    const V3 eu = ld3(sc + ly.r_eu + 3 * k), ev = ld3(sc + ly.r_ev + 3 * k);
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
    gobj[0] = g_p0.x;
    gobj[1] = g_p0.y;
    gobj[2] = g_p0.z;
    gobj[3] = g_eu.x;
    gobj[4] = g_eu.y;
    gobj[5] = g_eu.z;
    gobj[6] = g_ev.x;
    gobj[7] = g_ev.y;
    gobj[8] = g_ev.z;
    gobj[9] = g_col.x;
    gobj[10] = g_col.y;
    gobj[11] = g_col.z;
    gobj[12] = g_col2.x;
    gobj[13] = g_col2.y;
    gobj[14] = g_col2.z;
    gobj[15] = g_ka;
    gobj[16] = g_kd;
    gobj[17] = g_ks;
    gobj[18] = g_shin;
  }

  // ---- camera: o = eye, d = normalize(dt), dt = fwd + right sx + up sy
  const V3 g_dt = hit ? normalize_adjoint(r.dt, r.inv, r.n2, g_d) : zero3();
  const float g_tan = dot(g_dt, cam.right) * r.ax * p.aspect + dot(g_dt, cam.up) * r.ay;
  const V3 g_eye = hit ? g_o : zero3();

  // ---- warp sums into this warp's row, then the block's partial row
  put(wrow, 0, sq, lane);
  put3(gs, ly.ambient, g_amb, lane);
  put3(gs, ly.background, gbg, lane);
  put3(gs, ly.c_eye, g_eye, lane);
  put3(gx, 0, g_dt, lane);
  put3(gx, 3, g_dt * r.sx, lane);
  put3(gx, 6, g_dt * r.sy, lane);
  put(gx, 9, g_tan, lane);
  for (int k = 0; k < ly.N; ++k) {
    if (!__any_sync(FULL, h.k == k)) continue;  // every lane agrees
    const bool mine = h.k == k;
#pragma unroll
    for (int f = 0; f < SPH_FIELDS; ++f) put(gs, sphere_slot(ly, k, f), mine ? gobj[f] : 0.0f, lane);
  }
  for (int k = 0; k < ly.M; ++k) {
    if (!__any_sync(FULL, h.k == ly.N + k)) continue;
    const bool mine = h.k == ly.N + k;
#pragma unroll
    for (int f = 0; f < RECT_FIELDS; ++f) put(gs, rect_slot(ly, k, f), mine ? gobj[f] : 0.0f, lane);
  }
  __syncthreads();
  float* prow = partials + (long long)(blockIdx.y * gridDim.x + blockIdx.x) * ROW;
  for (int s = tid; s < ROW; s += BLOCK_THREADS) {
    float acc = 0.0f;
    for (int v = 0; v < NWARPS; ++v) acc += wp[v * ROW + s];
    prow[s] = acc;
  }
}

// rowsum[s] = sum over the partial rows, in a fixed order. Block (32, 8):
// 32 slots, 8 interleaved row subsets added in order at the end.
__global__ void reduce_rows_kernel(const float* __restrict__ partials, int nrows, int ROW,
                                   float* __restrict__ rowsum) {
  __shared__ float acc[8][32];
  const int slot = blockIdx.x * 32 + threadIdx.x;
  float a = 0.0f;
  if (slot < ROW)
    for (int b = threadIdx.y; b < nrows; b += 8) a += partials[(long long)b * ROW + slot];
  acc[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && slot < ROW) {
    float t = 0.0f;
    for (int y = 0; y < 8; ++y) t += acc[y][threadIdx.x];
    rowsum[slot] = t;
  }
}

// out = [sq, grads]; then the camera chain, once: up = right x fwd,
// right = normalize(fwd x up_hint), fwd = normalize(look_at - eye),
// tan_half = tan(fov * pi/180 * 0.5).
__global__ void finalize_kernel(const float* __restrict__ rowsum, const float* __restrict__ flat,
                                Layout ly, float* __restrict__ out) {
  for (int s = threadIdx.x; s < 1 + ly.S; s += blockDim.x) out[s] = rowsum[s];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const float* gx = rowsum + 1 + ly.S;
  V3 G_fwd = ld3(gx), G_right = ld3(gx + 3);
  const V3 G_up = ld3(gx + 6);
  const float G_tan = gx[9];
  const V3 eye = ld3(flat + ly.c_eye), look = ld3(flat + ly.c_look), uph = ld3(flat + ly.c_up);
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
  const float th = tanf(flat[ly.c_fov] * deg * 0.5f);
  float* g = out + 1;
  g[ly.c_eye + 0] -= g_fraw.x;
  g[ly.c_eye + 1] -= g_fraw.y;
  g[ly.c_eye + 2] -= g_fraw.z;
  g[ly.c_look + 0] += g_fraw.x;
  g[ly.c_look + 1] += g_fraw.y;
  g[ly.c_look + 2] += g_fraw.z;
  g[ly.c_up + 0] += g_uph.x;
  g[ly.c_up + 1] += g_uph.y;
  g[ly.c_up + 2] += g_uph.z;
  g[ly.c_fov] += G_tan * (1.0f + th * th) * 0.5f * deg;
}

inline dim3 step_grid(int H, int W) {
  return dim3((W + BLOCK_X - 1) / BLOCK_X, (H + BLOCK_Y - 1) / BLOCK_Y);
}

}  // namespace

extern "C" long long rrt_step_scratch_floats(int n_sph, int n_rect, int n_light, int H, int W) {
  const dim3 grid = step_grid(H, W);
  return ((long long)grid.x * grid.y + 1) * row_len(make_layout(n_sph, n_rect, n_light));
}

extern "C" int rrt_step(const float* flat, int n_sph, int n_rect, int n_light, int H, int W,
                        int shadows, int clip, const float* target, float w, float* scratch,
                        float* out, void* stream) {
  const Layout ly = make_layout(n_sph, n_rect, n_light);
  const Params p = make_params(H, W, shadows, clip);
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = step_grid(H, W);
  const int nrows = grid.x * grid.y;
  const int ROW = row_len(ly);
  float* partials = scratch;
  float* rowsum = scratch + (long long)nrows * ROW;
  const size_t smem = (size_t)(ly.S + NWARPS * ROW) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // > 24 objects; refused in Python

  step_kernel<<<grid, dim3(BLOCK_X, BLOCK_Y), smem, st>>>(flat, p, ly, target, w, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<(ROW + 31) / 32, dim3(32, 8), 0, st>>>(partials, nrows, ROW, rowsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<1, 256, 0, st>>>(rowsum, flat, ly, out);
  return (int)cudaGetLastError();
}
