// The kernels of the object-chunked fused step (scenes of any object
// count, packed rows), shared by the training step (fused_vec_step.cu,
// ResidualSource) and the render backward (fused_vec_render_bwd.cu,
// CotangentSource): one body, two kernels, as the TPU's make_bwd_kernel
// builds its step and backward.
//
// 1. vec_step_kernel: a grid of as many blocks of 32 x 8 threads as the card
//    holds at once (step_blocks), each walking the image's 32 x 8 tiles in a
//    fixed stride, with the globals and the packed rows staged in shared
//    memory once per block. Each thread runs render_common.cuh's pixel_step
//    for its pixel of the tile: the forward, the image cotangent from its
//    source, and the hand-written adjoint (shade, then the winning object
//    only, then the camera as 10 ray-form cotangents).
//    - The culls (WarpCull, cull.cuh). A warp is 32 pixels of a row. Its
//      primary rays leave the eye inside a cone, and a sphere outside the
//      cone widened by the sphere's angular radius cannot be hit by any of
//      them; each lane's nearest loop walks only the warp's candidates (in
//      ascending index, then every rect), so with first-wins ties on strict
//      < the winner and its t are those of the walk over every sphere, to
//      the bit. Where the source casts shadow rays (the step), the warp's
//      hit lanes' shadow origins are bounded by a ball and each light's
//      any-hit loop walks only the spheres near the ball's segment to the
//      light (the soft step's warp_candidates at tau = 0): the visibility
//      bits are those of the full walk. The render backward reads the
//      forward's visibility planes and casts no shadow rays.
//    - The gradient row would not fit per warp at large N (8 rows of 1 + S
//      + 10 floats is 315 KB at 513 objects), so a block keeps, across its
//      tiles:
//        - per warp, a short row of the globals: sq, the Sg globals, the 10
//          camera sums (warp shuffles, added tile by tile);
//        - one block row of every object field (ns_pad * 17 + nr_pad * 22).
//      Per tile, each warp lists the objects its lanes hit (at most 32),
//      entry e's 14 or 19 field sums held by lane e (one shuffle tree per
//      field), and the warps add their lists to the block row in warp order,
//      each list in parallel (its objects are distinct), with a barrier
//      between warps.
//    The block then writes one partial row: [sq, dglob, camera (10), sphere
//    rows, rect rows]: a few hundred rows where one per tile was 4096 at
//    1024^2.
// 2. reduce_rows_kernel sums the partial rows, slot by slot, in a fixed
//    order.
// 3. vec_finalize_kernel copies out [sq, dglob, dsph, drct] and applies the
//    camera chain once.
//
// spp 4: the step (row 6) takes the TPU kernel's 2x2 loop (fused_vec.py:
// 997-1006, with a bounce too: :772-780) in each thread, as the flat step
// does (render_common.cuh pixel_grads), each subsample's walk culled by its
// own warp's rays (a bounce level's walk stays the full walk), each
// subsample's gradient and texel records added as a pixel's; the render
// backward (row 5) is launched once per subsample at that subsample's
// offsets (Params oi, oj), as the TPU's four launches at the runtime offsets
// of off_ref. Each spp is its own instance (SPP).
//
// The environment map and mirror bounces (spp 1 or 4; vec_step_levels_kernel,
// REFL and ENV, the TPU kernel's env global and reflection levels,
// fused_vec.py:405-440, :1015-1054, :1220-1266): each thread runs
// pixel_step<REFL> on a PackedEnvRows (ENV: the env ends the globals,
// make_env_glayout) or a PackedScene.
//    - Level v + 1 (REFL = 1 to MAX_REFL levels) is traced where level v
//      hit, from level v's shadow origin along the reflected direction, over
//      every sphere (WarpCull::trace_bounce: the 32 rays leave 32 surface
//      points in scattered directions, so the primary cone does not bound
//      them), then every rect. Its shadow rays take the warp's ball cull of
//      their origins (warp_candidates, valid from any origins), cast after
//      level v's shadow rays are done with the lights' mask words.
//    - The winner lists: a warp can hit 32 (1 + REFL) distinct objects over
//      its levels, but its list holds 32 (one entry a lane), so it builds
//      one list per level, level 0's first, each above the deepest with the
//      mirror coefficient's gradient (column 16 of P_SPH and 21 of P_RCT, the
//      field after the others), each added to the block row in warp order.
//    - The env's gradient: each pixel's texel record (a miss of level 0, or
//      of a bounce level where every level above hit) is scattered into the warp's globals
//      row, in lane order (render_common.cuh scatter_texels), with 32 x 16
//      words of staging a warp; the row grows by the 3 Ke^2 texels.
//    - A bounce needs more registers than two blocks an SM leave
//      (step_blocks_per_sm: one block an SM with REFL, and a grid to
//      match).
// Object texel grids (spp 1 or 4; vec_step_tex_kernel, REFL, the env's side Ke 0
// for none, the TPU kernel's texel tails, fused_vec.py:207, :467-471, :503):
// each thread runs pixel_step<REFL> on a PackedTexScene, whose grids stay in
// global memory (64 globes at 16 x 16 texels are 192 KiB: a block cannot
// stage them beside their gradient).
//    - A pixel has a texel record for each level's textured winner (level
//      v's winner can be any sphere) besides the env's. After each tile's
//      winner lists the warps take turns, a barrier between, each
//      scattering its records in lane order (scatter_texels, level 0's
//      first; the env's into its globals row) through one staging of 32
//      records that the block shares.
//    - The block's texel row (3 (N Ks^2 + M Kr^2) floats in shared memory,
//      tex_step_plan) ends its partial row, so reduce_rows_kernel sums it in
//      its fixed order and vec_finalize_kernel copies it out after the rows:
//      out = [sq, dglob, dsph, drct, dstex, drtex]. One block an SM: the
//      row leaves no room for a second (211 KB for the globes).
// Every instance runs one body (vec_step_body), the bounce, the env and the
// texels behind if constexpr, so that vec_step_kernel's instances keep
// their code.
//
// No atomics, and a grid that follows from the card and the scene alone:
// for a given image size the result is bit-for-bit the same from run to run
// on one card, and the render backward's gradient for the mse cotangent is
// the step's, bit for bit (same body, same order). Pad rows are never read
// by the loops and their gradient is exactly zero; so are the checker and
// checker-scale columns (a step and a floor), and the mirror column
// without a bounce.
#pragma once

#include "cull.cuh"

namespace rrt {

struct StepPlan {
  int Sg, GROW, OROW, TROW, ROW, NWP;
  size_t smem;
};

// The shared memory of a block: the globals (with an environment map of
// side ke, its 3 ke^2 texels), the rows, the warp rows, the block object
// row; per warp the primary cull's mask words, then each light's; with an
// environment map, per warp 32 texel records of TEX_REC words.
inline StepPlan step_plan(int ns_pad, int nr_pad, int n_light, int ke = 0) {
  StepPlan s;
  s.Sg = make_glayout(n_light).Sg + 3 * ke * ke;
  s.GROW = 1 + s.Sg + CAM_EXTRA;
  s.OROW = ns_pad * P_SPH + nr_pad * P_RCT;
  s.TROW = 0;
  s.ROW = s.GROW + s.OROW;
  s.NWP = (ns_pad + 31) / 32;  // mask words of one cull
  s.smem = (size_t)(s.Sg + s.OROW + NWARPS * s.GROW + s.OROW) * sizeof(float) +
           (size_t)NWARPS * (1 + n_light) * s.NWP * sizeof(unsigned) +
           (ke ? (size_t)NWARPS * 32 * TEX_REC * sizeof(float) : 0);
  return s;
}

// The shared memory of a block of the textured instances (n_sph spheres with
// grids of side ks, n_rect rects with grids of side kr, an environment map of
// side ke): step_plan's without the per-warp staging, then one staging of 32
// texel records, which the warps take in turn, and the block's texel row of
// 3 (n_sph ks^2 + n_rect kr^2) floats, which each partial row ends with.
inline StepPlan tex_step_plan(int n_sph, int n_rect, int n_light, int ke, int ks, int kr) {
  const int ns_pad = pad16(n_sph), nr_pad = pad16(n_rect);
  StepPlan s = step_plan(ns_pad, nr_pad, n_light);
  s.Sg += 3 * ke * ke;
  s.GROW += 3 * ke * ke;
  s.TROW = 3 * (n_sph * ks * ks + n_rect * kr * kr);
  s.ROW = s.GROW + s.OROW + s.TROW;
  s.smem = (size_t)(s.Sg + s.OROW + NWARPS * s.GROW + s.OROW + 32 * TEX_REC + s.TROW) *
               sizeof(float) +
           (size_t)NWARPS * (1 + n_light) * s.NWP * sizeof(unsigned);
  return s;
}

// vec_step's walk (see the notes at the top): the spheres culled per warp,
// for the primary rays and, where the source casts shadow rays, for each
// light's; the rects every time; a bounce's reflected rays over every
// sphere. wm holds the warp's mask words (nw words for the primary rays,
// then nw per light).
struct WarpCull {
  unsigned* wm;
  int nw, lane;

  template <class S>
  __device__ __forceinline__ Nearest trace(const S& sc, V3 o, V3 d, bool inside) const {
    if (!__any_sync(FULL, inside)) return {BIG, -1};
    primary_candidates(sc, o, d, inside, 0.0f, lane, wm);
    if (!inside) return {BIG, -1};
    return trace_candidates(sc, o, d, wm, nw);
  }

  template <class S>
  __device__ __forceinline__ Nearest trace_bounce(const S& sc, V3 o, V3 d, bool live) const {
    return live ? rrt::trace(sc, o, d) : Nearest{BIG, -1};
  }

  template <class S, class Src>
  __device__ __forceinline__ void shadows(const S& sc, const Params& p, const Src&, V3 so,
                                          bool live) const {
    if constexpr (Src::casts_shadows) {
      if (!p.shadows || !__any_sync(FULL, live)) return;
      for (int l = 0; l < sc.n_light(); ++l)
        warp_candidates(sc, so, sc.l_pos(l), live, 0.0f, lane, wm + (1 + l) * nw);
    }
  }

  template <class S>
  __device__ __forceinline__ bool occluded(const S& sc, int l, V3 so, const LightGeo& g) const {
    return occluded_candidates(sc, so, g, wm + (1 + l) * nw, nw);
  }
};

// One level's winner list: the warp's distinct objects k (-1: the lane's ray
// missed at this level) in the order of the lowest lane that hit each, lane e
// holding entry e's sums of the fields obj (as lane 0 reduced them; with MIR
// also the mirror coefficient's g_mir, the field after them); then the warps
// add their lists to the block's object row, warp by warp.
template <bool MIR>
__device__ __forceinline__ void add_level_winners(int k_px, const float (&obj)[RECT_FIELDS],
                                                  float g_mir, int ns_pad, float* orow, int lane,
                                                  int warp) {
  constexpr int NF = RECT_FIELDS + (MIR ? 1 : 0);
  int n = 0, ke = -1;
  float acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.0f;
  for (unsigned todo = __ballot_sync(FULL, k_px >= 0); todo;) {
    const int k = __shfl_sync(FULL, k_px, __ffs(todo) - 1);
    const unsigned same = __ballot_sync(FULL, k_px == k);
    const bool mine = k_px == k;
    const int nf = k < ns_pad ? SPH_FIELDS : RECT_FIELDS;  // the same in every lane
#pragma unroll
    for (int f = 0; f < RECT_FIELDS; ++f) {
      if (f < nf) {
        const float v = __shfl_sync(FULL, warp_sum(mine ? obj[f] : 0.0f), 0);
        if (lane == n) acc[f] = v;
      }
    }
    if constexpr (MIR) {
      const float v = __shfl_sync(FULL, warp_sum(mine ? g_mir : 0.0f), 0);
      if (lane == n) acc[RECT_FIELDS] = v;
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
        if constexpr (MIR) orow[ke * P_SPH + sph_col(SPH_FIELDS)] += acc[RECT_FIELDS];
      } else {
        float* row = orow + ns_pad * P_SPH + (ke - ns_pad) * P_RCT;
#pragma unroll
        for (int f = 0; f < RECT_FIELDS; ++f) row[rct_col(f)] += acc[f];
        if constexpr (MIR) row[rct_col(RECT_FIELDS)] += acc[RECT_FIELDS];
      }
    }
    __syncthreads();
  }
}

// The kernels' body on the scene type SC (PackedScene, or PackedEnvScene
// with an environment map, or PackedTexScene with object texel grids tg) of
// globals layout GL (GLayout, EnvGLayout), at REFL bounce levels.
template <int SPP, int REFL, class Src, class SC, class GL>
__device__ __forceinline__ void vec_step_body(const float* __restrict__ glob,
                                              const float* __restrict__ sph,
                                              const float* __restrict__ rct, int N, int M,
                                              int ns_pad, int nr_pad, GL gl, Params p, Src src,
                                              float* __restrict__ partials,
                                              TexGrids tg = {}) {
  constexpr bool OBJTEX = ObjTexRows<SC>::value;
  extern __shared__ float smem[];
  const int GROW = 1 + gl.Sg + CAM_EXTRA;
  const int OROW = ns_pad * P_SPH + nr_pad * P_RCT;
  const int nw = (N + 31) >> 5;
  float* g = smem;
  float* s_sph = g + gl.Sg;
  float* s_rct = s_sph + ns_pad * P_SPH;
  float* wp = s_rct + nr_pad * P_RCT;  // NWARPS rows of GROW
  float* orow = wp + NWARPS * GROW;    // the block's object row (OROW)
  unsigned* masks = (unsigned*)(orow + OROW);  // NWARPS x (1 + L) x nw words
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  stage(g, glob, gl.Sg);
  stage(s_sph, sph, ns_pad * P_SPH);
  stage(s_rct, rct, nr_pad * P_RCT);
  for (int s = tid; s < NWARPS * GROW + OROW; s += BLOCK_THREADS) wp[s] = 0.0f;
  __syncthreads();
  float* wrow = wp + warp * GROW;  // [sq, globals (Sg), camera basis (10)]
  float* gs = wrow + 1;
  float* gx = wrow + 1 + gl.Sg;
  // the warps' texel records, after the mask words step_plan counts (with
  // object texel grids, tex_step_plan's one staging the warps take in turn,
  // then the block's texel row of TROW floats)
  float* const after_masks = (float*)(masks + NWARPS * (1 + gl.L) * ((ns_pad + 31) / 32));
  [[maybe_unused]] float* trec = after_masks + (OBJTEX ? 0 : warp * 32 * TEX_REC);
  [[maybe_unused]] float* trow = after_masks + 32 * TEX_REC;
  const int TROW = OBJTEX ? 3 * (N * tg.Ks * tg.Ks + M * tg.Kr * tg.Kr) : 0;
  if constexpr (OBJTEX)
    for (int s = tid; s < TROW; s += BLOCK_THREADS) trow[s] = 0.0f;
  const WarpCull walk{masks + warp * (1 + gl.L) * nw, nw, lane};
  const SC scene = [&] {
    if constexpr (OBJTEX)
      return tex_view<P_SPH>(packed_view<P_SPH>(g, s_sph, s_rct, gl, N, M, ns_pad), tg);
    else
      return packed_view<P_SPH>(g, s_sph, s_rct, gl, N, M, ns_pad);
  }();
  const dim3 tiles = pixel_grid(p.H, p.W);

  for (int t = blockIdx.x; t < (int)(tiles.x * tiles.y); t += gridDim.x) {
    const int j = (t % tiles.x) * BLOCK_X + threadIdx.x;
    const int i = (t / tiles.x) * BLOCK_Y + threadIdx.y;
    pixel_grads<SPP, REFL>(
        scene, p, i, j, i < p.H && j < p.W, src, walk,
        [&](int l, V3 g_lpos, V3 g_lcol, bool warp_hit) {
          if (warp_hit) {
            add3(gs, gl.l_pos + 3 * l, g_lpos, lane);
            add3(gs, gl.l_col + 3 * l, g_lcol, lane);
          }
        },
        [&](const auto& pg) {
          // ---- warp sums of the globals into this warp's row
          add(wrow, 0, pg.sq, lane);
          add3(gs, gl.ambient, pg.g_amb, lane);
          add3(gs, gl.background, pg.g_bg, lane);
          add3(gs, gl.c_eye, pg.g_eye, lane);
          add3(gx, 0, pg.g_dt, lane);
          add3(gx, 3, pg.g_dt * pg.sx, lane);
          add3(gx, 6, pg.g_dt * pg.sy, lane);
          add(gx, 9, pg.g_tan, lane);

          if constexpr (REFL == 0) {
            add_level_winners<false>(pg.k, pg.obj, 0.0f, ns_pad, orow, lane, warp);
          } else {
            // ---- with bounces: level 0's list, then each bounce level's (with
            // the mirror coefficients' gradient, but the deepest)
            add_level_winners<true>(pg.k, pg.obj, pg.g_mir[0], ns_pad, orow, lane, warp);
#pragma unroll
            for (int v = 1; v < REFL; ++v)
              add_level_winners<true>(pg.k1[v - 1], pg.obj1[v - 1], pg.g_mir[v], ns_pad, orow,
                                      lane, warp);
            add_level_winners<false>(pg.k1[REFL - 1], pg.obj1[REFL - 1], 0.0f, ns_pad, orow,
                                     lane, warp);
          }
          if constexpr (OBJTEX) {
            // ---- the texel records into the block's texel row (the env's
            // into the warp's globals row), warp by warp, each warp's in
            // lane order, level 0's first
            for (int v = 0; v < NWARPS; ++v) {
              if (v == warp) {
                scatter_texels(pg.tex, gs, trec, lane);
#pragma unroll
                for (int q = 0; q <= REFL; ++q) scatter_texels(pg.otex[q], trow, trec, lane);
              }
              __syncthreads();
            }
          } else if constexpr (HasEnv<SC>::value) {
            scatter_texels(pg.tex, gs, trec, lane);
          }
        });
  }

  // ---- the block's partial row (the last tile's texel scatter into the warp
  // rows comes after its winner lists' last barrier)
  if constexpr (HasEnv<SC>::value) __syncthreads();
  float* prow = partials + (long long)blockIdx.x * (GROW + OROW + TROW);
  for (int s = tid; s < GROW; s += BLOCK_THREADS) {
    float acc = 0.0f;
    for (int v = 0; v < NWARPS; ++v) acc += wp[v * GROW + s];
    prow[s] = acc;
  }
  for (int s = tid; s < OROW; s += BLOCK_THREADS) prow[GROW + s] = orow[s];
  if constexpr (OBJTEX)  // the texel row ends the partial row
    for (int s = tid; s < TROW; s += BLOCK_THREADS) prow[GROW + OROW + s] = trow[s];
}

template <int SPP, class Src>
__global__ void __launch_bounds__(BLOCK_THREADS, STEP_BLOCKS_PER_SM)
    vec_step_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                    const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                    GLayout gl, Params p, Src src, float* __restrict__ partials) {
  vec_step_body<SPP, 0, Src, PackedScene>(glob, sph, rct, N, M, ns_pad, nr_pad, gl, p, src,
                                          partials);
}

// The instances with the environment map (ENV) and/or REFL bounce levels, at
// SPP samples a pixel.
template <int SPP, int REFL, bool ENV, class Src>
__global__ void __launch_bounds__(BLOCK_THREADS, step_blocks_per_sm<REFL>())
    vec_step_levels_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                           const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                           GLayoutOf<ENV> gl, Params p, Src src, float* __restrict__ partials) {
  using SC = typename std::conditional<ENV, PackedEnvScene, PackedScene>::type;
  vec_step_body<SPP, REFL, Src, SC>(glob, sph, rct, N, M, ns_pad, nr_pad, gl, p, src, partials);
}

// The instances with object texel grids (the environment map's side Ke 0 for
// none, REFL bounce levels, SPP samples a pixel): one block an SM, as their
// block's texel row leaves no room for a second.
template <int SPP, int REFL, class Src>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    vec_step_tex_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                        const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                        EnvGLayout gl, Params p, Src src, float* __restrict__ partials,
                        TexGrids tg) {
  vec_step_body<SPP, REFL, Src, PackedTexScene>(glob, sph, rct, N, M, ns_pad, nr_pad, gl, p,
                                                src, partials, tg);
}

constexpr int VEC_REDUCE_RY = 32;  // row subsets per slot in the reduction

// Floats of scratch a call needs (with an environment map of side ke): the
// partial rows and their sum; -1 if the card cannot be queried. Sized for
// the grid of two blocks an SM, which holds the bounce instances' too.
inline long long vec_step_scratch_floats(int ns_pad, int nr_pad, int n_light, int H, int W,
                                         int ke = 0) {
  const StepPlan plan = step_plan(ns_pad, nr_pad, n_light, ke);
  const int nblocks = step_blocks(plan.smem, H, W);
  return nblocks > 0 ? ((long long)nblocks + 1) * plan.ROW : -1;
}

// The same for the textured instances.
inline long long vec_step_tex_scratch_floats(int n_sph, int n_rect, int n_light, int H, int W,
                                             int ke, int ks, int kr) {
  const StepPlan plan = tex_step_plan(n_sph, n_rect, n_light, ke, ks, kr);
  const int nblocks = step_blocks(plan.smem, H, W);
  return nblocks > 0 ? ((long long)nblocks + 1) * plan.ROW : -1;
}

// The three launches of one instance on one stream; out = [sq, dglob, dsph,
// drct] (the textured instances' ends with the texel row: the spheres'
// grids, then the rects'); extra, the kernel's arguments after the partial
// rows.
template <class K, class GL, class Src, class... Extra>
int launch_vec_instance(K kernel, int per_sm, const float* glob, const float* sph,
                        const float* rct, int n_sph, int n_rect, int ns_pad, int nr_pad, GL gl,
                        const StepPlan& plan, const Params& p, Src src, float* scratch,
                        float* out, void* stream, Extra... extra) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int nblocks = step_blocks(plan.smem, p.H, p.W, per_sm);
  if (nblocks <= 0) return (int)cudaErrorInvalidDevice;
  float* partials = scratch;
  float* rowsum = scratch + (long long)nblocks * plan.ROW;
  cudaError_t err;
  if (plan.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<nblocks, dim3(BLOCK_X, BLOCK_Y), plan.smem, st>>>(
      glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, gl, p, src, partials, extra...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<VEC_REDUCE_RY><<<(plan.ROW + 31) / 32, dim3(32, VEC_REDUCE_RY), 0, st>>>(
      partials, nblocks, plan.ROW, rowsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vec_finalize_kernel<<<1, 256, 0, st>>>(rowsum, glob, gl, plan.OROW + plan.TROW, out);
  return (int)cudaGetLastError();
}

template <int SPP, int REFL, bool ENV, class Src>
int launch_vec_levels(const float* glob, const float* sph, const float* rct, int n_sph,
                      int n_rect, int ns_pad, int nr_pad, int n_light, int ke, const Params& p,
                      Src src, float* scratch, float* out, void* stream) {
  return launch_vec_instance(vec_step_levels_kernel<SPP, REFL, ENV, Src>,
                             step_blocks_per_sm<REFL>(),
                             glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad,
                             globals_layout<ENV>(n_light, ke),
                             step_plan(ns_pad, nr_pad, n_light, ke), p, src, scratch, out,
                             stream);
}

// The textured instance of refl 0 to MAX_REFL bounce levels, an environment map of
// side ke (0 for none) and object texel grids tg, at spp 1 or 4 (the shared
// memory and the scratch do not depend on the spp); out = [sq, dglob, dsph,
// drct, the spheres' texels, the rects'].
template <class Src>
int launch_vec_step_tex(const float* glob, const float* sph, const float* rct, int n_sph,
                        int n_rect, int n_light, int ke, const TexGrids& tg, const Params& p,
                        int refl, Src src, float* scratch, float* out, void* stream,
                        int spp = 1) {
  if (refl < 0 || refl > MAX_REFL || (spp != 1 && spp != 4) || ke < 0 || tg.Ks < 0 || tg.Kr < 0)
    return (int)cudaErrorInvalidValue;
  const StepPlan plan = tex_step_plan(n_sph, n_rect, n_light, ke, tg.Ks, tg.Kr);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (plan.smem > (size_t)optin) return (int)cudaErrorInvalidValue;  // Python refuses it first
  using K = decltype(&vec_step_tex_kernel<1, 0, Src>);
  static const K spp1[1 + MAX_REFL] = {vec_step_tex_kernel<1, 0, Src>, vec_step_tex_kernel<1, 1, Src>,
                                       vec_step_tex_kernel<1, 2, Src>, vec_step_tex_kernel<1, 3, Src>};
  K kernel = spp1[refl];
  if (spp == 4) {  // the step's loop; the render backward launches a subsample at spp 1
    if constexpr (Src::casts_shadows) {
      static const K spp4[1 + MAX_REFL] = {
          vec_step_tex_kernel<4, 0, Src>, vec_step_tex_kernel<4, 1, Src>,
          vec_step_tex_kernel<4, 2, Src>, vec_step_tex_kernel<4, 3, Src>};
      kernel = spp4[refl];
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return launch_vec_instance(kernel, 1, glob, sph, rct, n_sph, n_rect, pad16(n_sph),
                             pad16(n_rect), make_env_glayout(n_light, ke), plan, p, src, scratch,
                             out, stream, tg);
}

// The instance of the call, on one stream; out = [sq, dglob, dsph, drct]. p
// gives the image, the flags and a subsample's offsets; spp is 1 or 4 (the
// 2x2 loop in the kernel, p's offsets 0), with refl 0 to MAX_REFL bounce levels and
// an environment map of side ke (0 for none).
template <class Src>
int launch_vec_step(const float* glob, const float* sph, const float* rct, int n_sph,
                    int n_rect, int ns_pad, int nr_pad, int n_light, const Params& p, int spp,
                    Src src, float* scratch, float* out, void* stream, int refl = 0,
                    int ke = 0) {
  if ((spp != 1 && spp != 4) || refl < 0 || refl > MAX_REFL || ke < 0)
    return (int)cudaErrorInvalidValue;
  if (refl || ke) {
    using Launch = decltype(&launch_vec_levels<1, 1, true, Src>);
    static const Launch spp1[2][1 + MAX_REFL] = {
        {nullptr, &launch_vec_levels<1, 1, false, Src>, &launch_vec_levels<1, 2, false, Src>,
         &launch_vec_levels<1, 3, false, Src>},
        {&launch_vec_levels<1, 0, true, Src>, &launch_vec_levels<1, 1, true, Src>,
         &launch_vec_levels<1, 2, true, Src>, &launch_vec_levels<1, 3, true, Src>}};
    Launch launch = spp1[ke != 0][refl];
    if (spp == 4) {
      // only the step loops over the subsamples; the render backward is
      // launched once a subsample at spp 1
      if constexpr (Src::casts_shadows) {
        static const Launch spp4[2][1 + MAX_REFL] = {
            {nullptr, &launch_vec_levels<4, 1, false, Src>, &launch_vec_levels<4, 2, false, Src>,
             &launch_vec_levels<4, 3, false, Src>},
            {&launch_vec_levels<4, 0, true, Src>, &launch_vec_levels<4, 1, true, Src>,
             &launch_vec_levels<4, 2, true, Src>, &launch_vec_levels<4, 3, true, Src>}};
        launch = spp4[ke != 0][refl];
      } else {
        return (int)cudaErrorInvalidValue;
      }
    }
    return launch(glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, n_light, ke, p, src, scratch,
                  out, stream);
  }
  return launch_vec_instance(spp == 4 ? vec_step_kernel<4, Src> : vec_step_kernel<1, Src>,
                             STEP_BLOCKS_PER_SM, glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad,
                             make_glayout(n_light), step_plan(ns_pad, nr_pad, n_light), p, src,
                             scratch, out, stream);
}

}  // namespace rrt
