// The kernel of the fused step for a flat scene (at most 24 objects),
// shared by the training step (fused_step.cu, ResidualSource) and the
// render backward (fused_render_bwd.cu, CotangentSource): one body, two
// kernels, as the TPU's make_bwd_kernel builds its step and backward.
//
// One cooperative launch of flat_step_kernel per call, on a grid of as many
// blocks of 32 x 8 threads as the card holds at once (step_blocks), each
// walking the image's 32 x 8 tiles in a fixed stride with the scene staged
// in shared memory once. Each thread runs render_common.cuh's pixel_step
// for its pixel of the tile: the forward, the image cotangent from its
// source, and the hand-written adjoint.
//   - The slots that every pixel writes (sq, ambient, background, eye, the
//     camera's 10 ray-form sums and each light's position and color) are
//     summed by each lane across its tiles: the first 20 in registers, the
//     lights' 6 L in shared memory, one column per thread. A warp reduces
//     them with shuffles once, at the end.
//   - The fields of the objects that some lane of the warp hit are reduced
//     per tile, in one transposing shuffle tree per object (warp_sum_many:
//     16 shuffles for a sphere's 14 fields, 31 for a rect's 19, where a
//     tree per field took 70 and 95), and added to the warp's row.
//   - The block adds its 8 warp rows in order and writes one partial row of
//     1 + S + 10 floats (264 rows at 512^2 on 132 SMs, where one row per
//     tile was 1024).
//   - After a grid-wide sync, block 0 sums the partial rows in a fixed
//     order, writes [sq, grads] and applies the camera_basis / normalize /
//     tan(deg2rad) chain once.
//
// spp 4 (the TPU kernels' 2x2 loop): each thread takes its pixel's four
// subsamples in turn (render_common.cuh pixel_grads: the step runs the four
// forwards first, since its residual is of their average), and each
// subsample's gradient goes into the sums as a pixel's would, with a bounce
// level and with texel grids too (each subsample's texel record scattered
// as a pixel's). Each spp is its own instance of the kernel (SPP), so the
// spp-1 ones keep their code.
//
// Mirror bounces (REFL = 1 to MAX_REFL levels, spp 1 or 4): each pixel adds
// into each level's winner's fields (with the mirror coefficient's at every
// level above the deepest). A warp's list of objects is the union of the
// 1 + REFL levels' winners, still one transposing tree per object a tile (a
// lane's value is the sum of its levels' for that object, level 0's first).
// The instances have their own launch bound (REFL_STEP_BLOCKS_PER_SM blocks
// an SM: the bounce's adjoint does not fit the 128 registers of two), and a
// grid sized to match.
//
// Texel grids (flat_step_tex_kernel, TEX: spp 1 or 4, object textures without
// a bounce or the environment map with or without bounces): the body runs on a
// TexFlatScene, whose S includes the grids, and each pixel's one texel
// record (render_common.cuh pixel_step) is scattered into the warp's row
// after the objects' trees (scatter_texels): every lane stages its four
// corners and 12 values in shared memory, corners that coincide merged
// first (a clamped edge, a 1-texel wrapped axis), and lanes 0-11 add one
// lane's record at a time, in lane order. The block then stages 8 x 32
// records of 16 words more; at 16 x 16 grids S is 829, and block 0 sums rows
// of 840 slots.
//
// No atomics and no counter: nothing in the scratch is read before this
// call writes it, and the grid follows from the card and the scene alone,
// so for a given image size the result is bit-for-bit the same from call to
// call on one card, and the render backward's gradient for the mse
// cotangent is the step's, bit for bit (same body, same grid, same order).
#pragma once

#include <cooperative_groups.h>

#include "render_common.cuh"

namespace rrt {

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

// One exchange round of warp_sum_many: lanes l and l ^ H swap halves of the
// 2H values each holds, each keeping the half its lane bit H picks plus the
// partner's copy of it; then the rounds of H / 2, ..., 1. The rounds are
// templates so that every index is a constant and v stays in registers (a
// loop over the rounds left it in local memory).
template <int H, int V>
__device__ __forceinline__ void exchange_rounds(float (&v)[V], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
  if constexpr (H > 1) exchange_rounds<H / 2>(v, lane);
}

// The warp's sums of V values a lane (V a power of two, at most 32): lane l
// gets the sum over the 32 lanes of v[l % V]. The exchange rounds halve the
// values a lane holds; then plain rounds sum across the groups of V lanes.
// V - 1 + 5 - log2(V) shuffles, where a warp_sum per value takes 5 V; a fixed
// order, so the same bits from call to call.
template <int V>
__device__ __forceinline__ float warp_sum_many(float (&v)[V], int lane) {
  static_assert(V >= 2 && V <= 32 && (V & (V - 1)) == 0, "V is a power of two, 2 to 32");
  exchange_rounds<V / 2>(v, lane);
  float s = v[0];
#pragma unroll
  for (int o = V; o < 32; o *= 2) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

// Rows block 0 loads at once per thread when it sums the partial rows: one
// load at a time waits out the L2's latency 33 times at 512^2 on 132 SMs.
constexpr int SUM_LOADS = 16;

// Mirror field of a sphere (SPH_FIELDS) and a rect (RECT_FIELDS) in the
// reduction's order: the flat layout holds the mirror leaf after shininess.
__device__ __forceinline__ int sphere_field_slot(const Layout& ly, int k, int f) {
  return f < SPH_FIELDS ? sphere_slot(ly, k, f) : ly.s_shin + ly.N + k;
}

__device__ __forceinline__ int rect_field_slot(const Layout& ly, int k, int f) {
  return f < RECT_FIELDS ? rect_slot(ly, k, f) : ly.r_shin + ly.M + k;
}

// The shared memory of a block, in floats: block 0's row subsets (the
// partial rows as float4 columns), the scene, the warp rows, the lanes'
// light sums, and with texel grids (tex) the warps' texel records.
struct FlatPlan {
  int ROW, ROWP, SUB;
  size_t smem;
};

inline FlatPlan flat_plan(const Layout& ly, bool tex = false) {
  FlatPlan f;
  f.ROW = 1 + ly.S + CAM_EXTRA;  // [sq, scene grads (S), camera basis (10)]
  f.ROWP = (f.ROW + 3) / 4 * 4;  // a partial row, padded to float4
  const int cols = f.ROWP / 4;
  f.SUB = cols >= BLOCK_THREADS ? 1 : BLOCK_THREADS / cols;
  f.smem = (size_t)(f.SUB * f.ROWP + ly.S + NWARPS * f.ROW + 6 * ly.L * BLOCK_THREADS +
                    (tex ? NWARPS * 32 * TEX_REC : 0)) *
           sizeof(float);
  return f;
}

// The kernel's body on the scene type SC (FlatScene, or TexFlatScene for the
// textured instances) of layout LY.
template <int SPP, int REFL, class Src, class SC, class LY>
__device__ __forceinline__ void flat_step_body(const float* __restrict__ flat, Params p, LY ly,
                                               FlatPlan fp, Src src,
                                               float* __restrict__ partials,
                                               float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sub = (float*)smem4;          // block 0's SUB row subsets (ROWP each)
  float* sc = sub + fp.SUB * fp.ROWP;  // the scene (S)
  const int ROW = fp.ROW;
  float* wp = sc + ly.S;               // NWARPS rows of ROW slots
  float* lacc = wp + NWARPS * ROW;     // 6 L sums per thread, slot-major
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  stage(sc, flat, ly.S);
  for (int s = tid; s < NWARPS * ROW; s += BLOCK_THREADS) wp[s] = 0.0f;
  for (int s = tid; s < 6 * ly.L * BLOCK_THREADS; s += BLOCK_THREADS) lacc[s] = 0.0f;
  __syncthreads();
  float* wrow = wp + warp * ROW;  // [sq, scene grads (S), camera basis (10)]
  float* gs = wrow + 1;
  float* gx = wrow + 1 + ly.S;
  float* mine = lacc + tid;  // this lane's light sum q at mine[q * BLOCK_THREADS]

  float a_sq = 0.0f, a_tan = 0.0f;
  V3 a_amb = zero3(), a_bg = zero3(), a_eye = zero3(), a_dt = zero3(), a_dtx = zero3(),
     a_dty = zero3();
  const SC scene = scene_view(sc, ly);
  [[maybe_unused]] float* trec = lacc + 6 * ly.L * BLOCK_THREADS + warp * 32 * TEX_REC;
  const dim3 tiles = pixel_grid(p.H, p.W);
  for (int t = blockIdx.x; t < (int)(tiles.x * tiles.y); t += gridDim.x) {
    const int j = (t % tiles.x) * BLOCK_X + threadIdx.x;
    const int i = (t / tiles.x) * BLOCK_Y + threadIdx.y;
    pixel_grads<SPP, REFL>(
        scene, p, i, j, i < p.H && j < p.W, src, FullWalk{},
        [&](int l, V3 g_lpos, V3 g_lcol, bool) {
          float* q = mine + 6 * l * BLOCK_THREADS;
          q[0] += g_lpos.x;
          q[BLOCK_THREADS] += g_lpos.y;
          q[2 * BLOCK_THREADS] += g_lpos.z;
          q[3 * BLOCK_THREADS] += g_lcol.x;
          q[4 * BLOCK_THREADS] += g_lcol.y;
          q[5 * BLOCK_THREADS] += g_lcol.z;
        },
        [&](const auto& g) {
          a_sq += g.sq;
          a_amb = a_amb + g.g_amb;
          a_bg = a_bg + g.g_bg;
          a_eye = a_eye + g.g_eye;
          a_dt = a_dt + g.g_dt;
          a_dtx = a_dtx + g.g_dt * g.sx;
          a_dty = a_dty + g.g_dt * g.sy;
          a_tan += g.g_tan;

          // ---- the fields of each object some lane hit, one tree per
          // object, in the order of the lowest lane that hit it (each
          // object's slots get one add per tile, so the order of objects
          // does not touch the bits)
          if constexpr (REFL == 0) {
            for (unsigned todo = __ballot_sync(FULL, g.k >= 0); todo;) {
              const int k = __shfl_sync(FULL, g.k, __ffs(todo) - 1);
              const bool hit_k = g.k == k;
              todo &= ~__ballot_sync(FULL, hit_k);
              if (k < ly.N) {
                float v[16] = {};
#pragma unroll
                for (int f = 0; f < SPH_FIELDS; ++f) v[f] = hit_k ? g.obj[f] : 0.0f;
                const float s = warp_sum_many(v, lane);
                if (lane < SPH_FIELDS) gs[sphere_slot(ly, k, lane)] += s;
              } else {
                float v[32] = {};
#pragma unroll
                for (int f = 0; f < RECT_FIELDS; ++f) v[f] = hit_k ? g.obj[f] : 0.0f;
                const float s = warp_sum_many(v, lane);
                if (lane < RECT_FIELDS) gs[rect_slot(ly, k - ly.N, lane)] += s;
              }
            }
          } else {
            // ---- with bounces: the union of every level's winners; a lane
            // adds its fields of each level at which it hit k (level 0's
            // first), and the mirror coefficient's of each such level above
            // the deepest
            bool pend[1 + REFL];
            pend[0] = g.k >= 0;
#pragma unroll
            for (int v = 0; v < REFL; ++v) pend[1 + v] = g.k1[v] >= 0;
            for (;;) {
              unsigned tc = 0;  // the shallowest level with a winner left: its lowest lane's
              int kc = 0;
#pragma unroll
              for (int v = REFL; v >= 0; --v) {
                const unsigned tv = __ballot_sync(FULL, pend[v]);
                if (tv) {
                  tc = tv;
                  kc = v == 0 ? g.k : g.k1[v - 1];
                }
              }
              if (!tc) break;
              const int k = __shfl_sync(FULL, kc, __ffs(tc) - 1);
              bool at[1 + REFL];
              at[0] = g.k == k;
              pend[0] = pend[0] && !at[0];
#pragma unroll
              for (int v = 0; v < REFL; ++v) {
                at[1 + v] = g.k1[v] == k;
                pend[1 + v] = pend[1 + v] && !at[1 + v];
              }
              if (k < ly.N) {
                float v[16] = {};
#pragma unroll
                for (int f = 0; f < SPH_FIELDS; ++f) {
                  v[f] = (at[0] ? g.obj[f] : 0.0f) + (at[1] ? g.obj1[0][f] : 0.0f);
#pragma unroll
                  for (int u = 1; u < REFL; ++u) v[f] += at[1 + u] ? g.obj1[u][f] : 0.0f;
                }
                v[SPH_FIELDS] = at[0] ? g.g_mir[0] : 0.0f;
#pragma unroll
                for (int u = 1; u < REFL; ++u) v[SPH_FIELDS] += at[u] ? g.g_mir[u] : 0.0f;
                const float s = warp_sum_many(v, lane);
                if (lane <= SPH_FIELDS) gs[sphere_field_slot(ly, k, lane)] += s;
              } else {
                float v[32] = {};
#pragma unroll
                for (int f = 0; f < RECT_FIELDS; ++f) {
                  v[f] = (at[0] ? g.obj[f] : 0.0f) + (at[1] ? g.obj1[0][f] : 0.0f);
#pragma unroll
                  for (int u = 1; u < REFL; ++u) v[f] += at[1 + u] ? g.obj1[u][f] : 0.0f;
                }
                v[RECT_FIELDS] = at[0] ? g.g_mir[0] : 0.0f;
#pragma unroll
                for (int u = 1; u < REFL; ++u) v[RECT_FIELDS] += at[u] ? g.g_mir[u] : 0.0f;
                const float s = warp_sum_many(v, lane);
                if (lane <= RECT_FIELDS) gs[rect_field_slot(ly, k - ly.N, lane)] += s;
              }
            }
          }
          if constexpr (Textured<SC>::value) scatter_texels(g.tex, gs, trec, lane);
        });
  }

  // ---- the lanes' sums, once per warp, then the block's partial row
  add(wrow, 0, a_sq, lane);
  add3(gs, ly.ambient, a_amb, lane);
  add3(gs, ly.background, a_bg, lane);
  add3(gs, ly.c_eye, a_eye, lane);
  add3(gx, 0, a_dt, lane);
  add3(gx, 3, a_dtx, lane);
  add3(gx, 6, a_dty, lane);
  add(gx, 9, a_tan, lane);
  for (int l = 0; l < ly.L; ++l)
    for (int c = 0; c < 6; ++c)
      add(gs, (c < 3 ? ly.l_pos : ly.l_col) + 3 * l + c % 3, mine[(6 * l + c) * BLOCK_THREADS],
          lane);
  __syncthreads();
  float* prow = partials + (long long)blockIdx.x * fp.ROWP;
  for (int s = tid; s < fp.ROWP; s += BLOCK_THREADS) {
    float acc = 0.0f;
    for (int v = 0; v < NWARPS && s < ROW; ++v) acc += wp[v * ROW + s];
    prow[s] = acc;  // the pad slots 0
  }

  // ---- block 0: the partial rows' sum, in a fixed order: thread it of
  // column c (4 slots) and subset y adds rows y, y + SUB, ...; then the
  // subsets in order
  cooperative_groups::this_grid().sync();
  if (blockIdx.x != 0) return;
  const int cols = fp.ROWP / 4, nb = gridDim.x;
  const float4* rows4 = (const float4*)partials;
  for (int it = tid; it < cols * fp.SUB; it += BLOCK_THREADS) {
    const int c = it % cols, y = it / cols;
    float4 a = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int b = y; b < nb; b += SUM_LOADS * fp.SUB) {
      float4 r[SUM_LOADS];  // loads in flight together, then added in row order
#pragma unroll
      for (int u = 0; u < SUM_LOADS; ++u) {
        const int bu = b + u * fp.SUB;
        r[u] = bu < nb ? __ldcg(rows4 + (long long)bu * cols + c) : float4{0.0f, 0.0f, 0.0f, 0.0f};
      }
#pragma unroll
      for (int u = 0; u < SUM_LOADS; ++u) {
        a.x += r[u].x;
        a.y += r[u].y;
        a.z += r[u].z;
        a.w += r[u].w;
      }
    }
    smem4[y * cols + c] = a;
  }
  __syncthreads();
  float* rowsum = wp;
  for (int s = tid; s < ROW; s += BLOCK_THREADS) {
    float acc = 0.0f;
    for (int y = 0; y < fp.SUB; ++y) acc += sub[y * fp.ROWP + s];
    rowsum[s] = acc;
    if (s < 1 + ly.S) out[s] = acc;
  }
  __syncthreads();
  if (tid == 0)
    camera_chain(rowsum + 1 + ly.S, ld3(sc + ly.c_eye), ld3(sc + ly.c_look), ld3(sc + ly.c_up),
                 sc[ly.c_fov], out + 1, ly.c_eye, ly.c_look, ly.c_up, ly.c_fov);
}

template <int SPP, int REFL, class Src>
__global__ void __launch_bounds__(BLOCK_THREADS, step_blocks_per_sm<REFL>())
    flat_step_kernel(const float* __restrict__ flat, Params p, Layout ly, FlatPlan fp, Src src,
                     float* __restrict__ partials, float* __restrict__ out) {
  flat_step_body<SPP, REFL, Src, FlatScene>(flat, p, ly, fp, src, partials, out);
}

// The textured instances.
template <int SPP, int REFL, class Src>
__global__ void __launch_bounds__(BLOCK_THREADS, step_blocks_per_sm<REFL>())
    flat_step_tex_kernel(const float* __restrict__ flat, Params p, TexLayout ly, FlatPlan fp,
                         Src src, float* __restrict__ partials, float* __restrict__ out) {
  flat_step_body<SPP, REFL, Src, TexFlatScene>(flat, p, ly, fp, src, partials, out);
}

// Floats of scratch a call needs (the partial rows); -1 if the card cannot
// be queried.
inline long long flat_step_scratch_floats(int n_sph, int n_rect, int n_light, int H, int W) {
  const FlatPlan fp = flat_plan(make_layout(n_sph, n_rect, n_light));
  const int nblocks = step_blocks(fp.smem, H, W);
  return nblocks > 0 ? (long long)nblocks * fp.ROWP : -1;
}

// The same for the textured instances, whose grids have sides Ks, Kr, Ke.
inline long long flat_step_tex_scratch_floats(int n_sph, int n_rect, int n_light, int H, int W,
                                              int Ks, int Kr, int Ke) {
  const FlatPlan fp = flat_plan(make_tex_layout(n_sph, n_rect, n_light, Ks, Kr, Ke), true);
  const int nblocks = step_blocks(fp.smem, H, W);
  return nblocks > 0 ? (long long)nblocks * fp.ROWP : -1;
}

// The one cooperative launch of kernel (an instance taking layout LY) on the
// caller's stream; out = [sq, grads (S)]. The scratch of
// flat_step_scratch_floats (or _tex_) holds the rows of every instance (those
// with a bounce level have fewer blocks).
template <class LY, class Src>
int launch_flat(const void* kernel, int per_sm, const float* flat, LY ly, FlatPlan fp, Params p,
                Src src, float* scratch, float* out, void* stream) {
  const int nblocks = step_blocks(fp.smem, p.H, p.W, per_sm);
  if (nblocks <= 0) return (int)cudaErrorInvalidDevice;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // At most 24 objects and 16 lights (more are refused in Python) take
  // 124,304 bytes without texel grids; Python refuses grids that need more
  // than a block holds (fused.step_smem_bytes).
  if (fp.smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (fp.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)fp.smem);
    if (err != cudaSuccess) return (int)err;
  }
  void* args[] = {&flat, &p, &ly, &fp, &src, &scratch, &out};
  err = cudaLaunchCooperativeKernel(kernel, dim3(nblocks), dim3(BLOCK_X, BLOCK_Y), args, fp.smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int SPP, int REFL, class Src>
int launch_flat_step_instance(const float* flat, int n_sph, int n_rect, int n_light,
                              const Params& p, Src src, float* scratch, float* out,
                              void* stream) {
  const Layout ly = make_layout(n_sph, n_rect, n_light);
  return launch_flat((const void*)flat_step_kernel<SPP, REFL, Src>, step_blocks_per_sm<REFL>(),
                     flat, ly, flat_plan(ly), p, src, scratch, out, stream);
}

// The kernel of a textured instance.
template <int SPP, int REFL, class Src>
const void* flat_step_tex_instance() {
  return (const void*)flat_step_tex_kernel<SPP, REFL, Src>;
}

// The textured instance of refl 0 to MAX_REFL at spp 1 or 4 (the shared
// memory and the scratch do not depend on the spp or refl).
template <class Src>
int launch_flat_step_tex(const float* flat, int n_sph, int n_rect, int n_light, const Params& p,
                         int refl, int spp, int Ks, int Kr, int Ke, Src src, float* scratch,
                         float* out, void* stream) {
  if (refl < 0 || refl > MAX_REFL || (spp != 1 && spp != 4)) return (int)cudaErrorInvalidValue;
  const TexLayout ly = make_tex_layout(n_sph, n_rect, n_light, Ks, Kr, Ke);
  using Pick = const void* (*)();
  static const Pick kernels[2][1 + MAX_REFL] = {
      {&flat_step_tex_instance<1, 0, Src>, &flat_step_tex_instance<1, 1, Src>,
       &flat_step_tex_instance<1, 2, Src>, &flat_step_tex_instance<1, 3, Src>},
      {&flat_step_tex_instance<4, 0, Src>, &flat_step_tex_instance<4, 1, Src>,
       &flat_step_tex_instance<4, 2, Src>, &flat_step_tex_instance<4, 3, Src>}};
  return launch_flat(kernels[spp == 4][refl](),
                     refl ? step_blocks_per_sm<1>() : step_blocks_per_sm<0>(), flat, ly,
                     flat_plan(ly, true), p, src, scratch, out, stream);
}

// The instance of spp 1 or 4 with refl 0 to MAX_REFL bounce levels.
template <class Src>
int launch_flat_step(const float* flat, int n_sph, int n_rect, int n_light, const Params& p,
                     int spp, int refl, Src src, float* scratch, float* out, void* stream) {
  if ((spp != 1 && spp != 4) || refl < 0 || refl > MAX_REFL) return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const float*, int, int, int, const Params&, Src, float*, float*, void*);
  static const Launch launches[2][1 + MAX_REFL] = {
      {&launch_flat_step_instance<1, 0, Src>, &launch_flat_step_instance<1, 1, Src>,
       &launch_flat_step_instance<1, 2, Src>, &launch_flat_step_instance<1, 3, Src>},
      {&launch_flat_step_instance<4, 0, Src>, &launch_flat_step_instance<4, 1, Src>,
       &launch_flat_step_instance<4, 2, Src>, &launch_flat_step_instance<4, 3, Src>}};
  return launches[spp == 4][refl](flat, n_sph, n_rect, n_light, p, src, scratch, out, stream);
}

}  // namespace rrt
