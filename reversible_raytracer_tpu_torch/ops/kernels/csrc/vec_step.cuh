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
// No atomics, and a grid that follows from the card and the scene alone:
// for a given image size the result is bit-for-bit the same from run to run
// on one card, and the render backward's gradient for the mse cotangent is
// the step's, bit for bit (same body, same order). Pad rows are never read
// by the loops and their gradient is exactly zero; so are the checker,
// checker-scale and mirror columns (a step, a floor, and no reflection
// levels).
#pragma once

#include "cull.cuh"

namespace rrt {

struct StepPlan {
  int Sg, GROW, OROW, ROW, NWP;
  size_t smem;
};

inline StepPlan step_plan(int ns_pad, int nr_pad, int n_light) {
  StepPlan s;
  s.Sg = make_glayout(n_light).Sg;
  s.GROW = 1 + s.Sg + CAM_EXTRA;
  s.OROW = ns_pad * P_SPH + nr_pad * P_RCT;
  s.ROW = s.GROW + s.OROW;
  s.NWP = (ns_pad + 31) / 32;  // mask words of one cull
  // globals, rows, warp rows, block object row; per warp the primary cull's
  // mask words, then each light's
  s.smem = (size_t)(s.Sg + s.OROW + NWARPS * s.GROW + s.OROW) * sizeof(float) +
           (size_t)NWARPS * (1 + n_light) * s.NWP * sizeof(unsigned);
  return s;
}

// vec_step's walk (see the notes at the top): the spheres culled per warp,
// for the primary rays and, where the source casts shadow rays, for each
// light's; the rects every time. wm holds the warp's mask words (nw words
// for the primary rays, then nw per light).
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

template <class Src>
__global__ void __launch_bounds__(BLOCK_THREADS, STEP_BLOCKS_PER_SM)
    vec_step_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                    const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                    GLayout gl, Params p, Src src, float* __restrict__ partials) {
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
  const WarpCull walk{masks + warp * (1 + gl.L) * nw, nw, lane};
  const PackedScene scene{g, s_sph, s_rct, gl, N, M, ns_pad};
  const dim3 tiles = pixel_grid(p.H, p.W);

  for (int t = blockIdx.x; t < (int)(tiles.x * tiles.y); t += gridDim.x) {
    const int j = (t % tiles.x) * BLOCK_X + threadIdx.x;
    const int i = (t / tiles.x) * BLOCK_Y + threadIdx.y;
    const PixelGrad pg = pixel_step(
        scene, p, i, j, i < p.H && j < p.W, src, walk,
        [&](int l, V3 g_lpos, V3 g_lcol, bool warp_hit) {
          if (warp_hit) {
            add3(gs, gl.l_pos + 3 * l, g_lpos, lane);
            add3(gs, gl.l_col + 3 * l, g_lcol, lane);
          }
        });

    // ---- warp sums of the globals into this warp's row
    add(wrow, 0, pg.sq, lane);
    add3(gs, gl.ambient, pg.g_amb, lane);
    add3(gs, gl.background, pg.g_bg, lane);
    add3(gs, gl.c_eye, pg.g_eye, lane);
    add3(gx, 0, pg.g_dt, lane);
    add3(gx, 3, pg.g_dt * pg.sx, lane);
    add3(gx, 6, pg.g_dt * pg.sy, lane);
    add(gx, 9, pg.g_tan, lane);

    // ---- the warp's list of winners, one entry per distinct object in the
    // order of the lowest lane that hit it, lane e holding entry e's sums (as
    // lane 0 reduced them); then the block's row, warp by warp
    int n = 0, ke = -1;
    float acc[RECT_FIELDS];
#pragma unroll
    for (int f = 0; f < RECT_FIELDS; ++f) acc[f] = 0.0f;
    for (unsigned todo = __ballot_sync(FULL, pg.k >= 0); todo;) {
      const int k = __shfl_sync(FULL, pg.k, __ffs(todo) - 1);
      const unsigned same = __ballot_sync(FULL, pg.k == k);
      const bool mine = pg.k == k;
      const int nf = k < ns_pad ? SPH_FIELDS : RECT_FIELDS;  // the same in every lane
#pragma unroll
      for (int f = 0; f < RECT_FIELDS; ++f) {
        if (f < nf) {
          const float v = __shfl_sync(FULL, warp_sum(mine ? pg.obj[f] : 0.0f), 0);
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

  // ---- the block's partial row
  float* prow = partials + (long long)blockIdx.x * (GROW + OROW);
  for (int s = tid; s < GROW; s += BLOCK_THREADS) {
    float acc = 0.0f;
    for (int v = 0; v < NWARPS; ++v) acc += wp[v * GROW + s];
    prow[s] = acc;
  }
  for (int s = tid; s < OROW; s += BLOCK_THREADS) prow[GROW + s] = orow[s];
}

constexpr int VEC_REDUCE_RY = 32;  // row subsets per slot in the reduction

// Floats of scratch a call needs: the partial rows and their sum; -1 if
// the card cannot be queried.
inline long long vec_step_scratch_floats(int ns_pad, int nr_pad, int n_light, int H, int W) {
  const StepPlan plan = step_plan(ns_pad, nr_pad, n_light);
  const int nblocks = step_blocks(plan.smem, H, W);
  return nblocks > 0 ? ((long long)nblocks + 1) * plan.ROW : -1;
}

// The three launches on one stream; out = [sq, dglob, dsph, drct].
template <class Src>
int launch_vec_step(const float* glob, const float* sph, const float* rct, int n_sph,
                    int n_rect, int ns_pad, int nr_pad, int n_light, int H, int W, int shadows,
                    int clip, Src src, float* scratch, float* out, void* stream) {
  const GLayout gl = make_glayout(n_light);
  const Params p = make_params(H, W, shadows, clip);
  const StepPlan plan = step_plan(ns_pad, nr_pad, n_light);
  const cudaStream_t st = (cudaStream_t)stream;
  const int nblocks = step_blocks(plan.smem, H, W);
  if (nblocks <= 0) return (int)cudaErrorInvalidDevice;
  float* partials = scratch;
  float* rowsum = scratch + (long long)nblocks * plan.ROW;
  cudaError_t err;
  if (plan.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(vec_step_kernel<Src>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
  }
  vec_step_kernel<Src><<<nblocks, dim3(BLOCK_X, BLOCK_Y), plan.smem, st>>>(
      glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, gl, p, src, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<VEC_REDUCE_RY><<<(plan.ROW + 31) / 32, dim3(32, VEC_REDUCE_RY), 0, st>>>(
      partials, nblocks, plan.ROW, rowsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vec_finalize_kernel<<<1, 256, 0, st>>>(rowsum, glob, gl, plan.OROW, out);
  return (int)cudaGetLastError();
}

}  // namespace rrt
