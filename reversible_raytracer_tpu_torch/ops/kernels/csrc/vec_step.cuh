// The kernels of the object-chunked fused step (scenes of any object
// count, packed rows), shared by the training step (fused_vec_step.cu,
// ResidualSource) and the render backward (fused_vec_render_bwd.cu,
// CotangentSource): one body, two kernels, as the TPU's make_bwd_kernel
// builds its step and backward.
//
// 1. vec_step_kernel: one thread per pixel, 32 x 8 pixels per block, the
//    globals and the packed rows staged in shared memory. Each thread runs
//    render_common.cuh's pixel_step: the forward, the image cotangent from
//    its source, and the hand-written adjoint (shade, then the winning
//    object only, then the camera as 10 ray-form cotangents).
//    The gradient row of a block would not fit per warp at large N (8 rows
//    of 1 + S + 10 floats is 315 KB at 513 objects), so a block keeps:
//      - per warp, a short row of the globals: sq, the Sg globals, the 10
//        camera sums (warp shuffles, as flat_step.cuh);
//      - per warp, a list of the objects its lanes hit (at most 32), each
//        with its 14 or 19 field sums (one shuffle tree per field);
//      - one block row of every object field (ns_pad * 17 + nr_pad * 22),
//        to which the warps' lists are added in warp order, each list in
//        parallel (its objects are distinct), with a barrier between warps.
//    The block then writes one partial row: [sq, dglob, camera (10),
//    sphere rows, rect rows].
// 2. reduce_rows_kernel sums the partial rows, slot by slot, in a fixed
//    order.
// 3. vec_finalize_kernel copies out [sq, dglob, dsph, drct] and applies the
//    camera chain once.
//
// No atomics: for a given image size the result is bit-for-bit the same
// from run to run on one card. Pad rows are never read by the loops and
// their gradient is exactly zero; so are the checker, checker-scale and
// mirror columns (a step, a floor, and no reflection levels).
#pragma once

#include "render_common.cuh"

namespace rrt {

struct StepPlan {
  int Sg, GROW, OROW, ROW;
  size_t smem;
};

inline StepPlan step_plan(int ns_pad, int nr_pad, int n_light) {
  StepPlan s;
  s.Sg = make_glayout(n_light).Sg;
  s.GROW = 1 + s.Sg + CAM_EXTRA;
  s.OROW = ns_pad * P_SPH + nr_pad * P_RCT;
  s.ROW = s.GROW + s.OROW;
  // globals, rows, warp rows, block object row, warp lists (values, ids, counts)
  s.smem = (size_t)(s.Sg + s.OROW + NWARPS * s.GROW + s.OROW + NWARPS * 32 * RECT_FIELDS) *
               sizeof(float) +
           (size_t)(NWARPS * 32 + NWARPS) * sizeof(int);
  return s;
}

template <class Src>
__global__ void __launch_bounds__(BLOCK_THREADS)
    vec_step_kernel(const float* __restrict__ glob, const float* __restrict__ sph,
                    const float* __restrict__ rct, int N, int M, int ns_pad, int nr_pad,
                    GLayout gl, Params p, Src src, float* __restrict__ partials) {
  extern __shared__ float smem[];
  const int GROW = 1 + gl.Sg + CAM_EXTRA;
  const int OROW = ns_pad * P_SPH + nr_pad * P_RCT;
  float* g = smem;
  float* s_sph = g + gl.Sg;
  float* s_rct = s_sph + ns_pad * P_SPH;
  float* wp = s_rct + nr_pad * P_RCT;  // NWARPS rows of GROW
  float* orow = wp + NWARPS * GROW;    // the block's object row (OROW)
  float* wval = orow + OROW;           // NWARPS x 32 entries of RECT_FIELDS
  int* wid = (int*)(wval + NWARPS * 32 * RECT_FIELDS);  // NWARPS x 32 winner ids
  int* wcnt = wid + NWARPS * 32;                         // entries per warp
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

  const int j = blockIdx.x * BLOCK_X + threadIdx.x;
  const int i = blockIdx.y * BLOCK_Y + threadIdx.y;
  const PackedScene scene{g, s_sph, s_rct, gl, N, M, ns_pad};
  const PixelGrad pg = pixel_step(
      scene, p, i, j, i < p.H && j < p.W, src,
      [&](int l, V3 g_lpos, V3 g_lcol, bool warp_hit) {
        if (warp_hit) {
          put3(gs, gl.l_pos + 3 * l, g_lpos, lane);
          put3(gs, gl.l_col + 3 * l, g_lcol, lane);
        }
      });

  // ---- warp sums of the globals into this warp's row
  put(wrow, 0, pg.sq, lane);
  put3(gs, gl.ambient, pg.g_amb, lane);
  put3(gs, gl.background, pg.g_bg, lane);
  put3(gs, gl.c_eye, pg.g_eye, lane);
  put3(gx, 0, pg.g_dt, lane);
  put3(gx, 3, pg.g_dt * pg.sx, lane);
  put3(gx, 6, pg.g_dt * pg.sy, lane);
  put(gx, 9, pg.g_tan, lane);

  // ---- the warp's list of winners: one entry per distinct object, in the
  // order of the lowest lane that hit it
  const int base = warp * 32;
  int n = 0;
  for (unsigned todo = __ballot_sync(FULL, pg.k >= 0); todo;) {
    const int k = __shfl_sync(FULL, pg.k, __ffs(todo) - 1);
    const unsigned same = __ballot_sync(FULL, pg.k == k);
    const bool mine = pg.k == k;
    const int nf = k < ns_pad ? SPH_FIELDS : RECT_FIELDS;  // the same in every lane
#pragma unroll
    for (int f = 0; f < RECT_FIELDS; ++f) {
      if (f < nf) {
        const float v = warp_sum(mine ? pg.obj[f] : 0.0f);
        if (lane == 0) wval[(base + n) * RECT_FIELDS + f] = v;
      }
    }
    if (lane == 0) wid[base + n] = k;
    ++n;
    todo &= ~same;
  }
  if (lane == 0) wcnt[warp] = n;
  __syncthreads();

  // ---- the warps' lists into the block's object row, warp by warp
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

  // ---- the block's partial row
  float* prow = partials + (long long)(blockIdx.y * gridDim.x + blockIdx.x) * (GROW + OROW);
  for (int s = tid; s < GROW; s += BLOCK_THREADS) {
    float acc = 0.0f;
    for (int v = 0; v < NWARPS; ++v) acc += wp[v * GROW + s];
    prow[s] = acc;
  }
  for (int s = tid; s < OROW; s += BLOCK_THREADS) prow[GROW + s] = orow[s];
}

constexpr int VEC_REDUCE_RY = 32;  // row subsets per slot in the reduction

inline long long vec_step_scratch_floats(int ns_pad, int nr_pad, int n_light, int H, int W) {
  const dim3 grid = pixel_grid(H, W);
  return ((long long)grid.x * grid.y + 1) * step_plan(ns_pad, nr_pad, n_light).ROW;
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
  const dim3 grid = pixel_grid(H, W);
  const int nrows = grid.x * grid.y;
  float* partials = scratch;
  float* rowsum = scratch + (long long)nrows * plan.ROW;
  cudaError_t err;
  if (plan.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(vec_step_kernel<Src>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
  }
  vec_step_kernel<Src><<<grid, dim3(BLOCK_X, BLOCK_Y), plan.smem, st>>>(
      glob, sph, rct, n_sph, n_rect, ns_pad, nr_pad, gl, p, src, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<VEC_REDUCE_RY><<<(plan.ROW + 31) / 32, dim3(32, VEC_REDUCE_RY), 0, st>>>(
      partials, nrows, plan.ROW, rowsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vec_finalize_kernel<<<1, 256, 0, st>>>(rowsum, glob, gl, plan.OROW, out);
  return (int)cudaGetLastError();
}

}  // namespace rrt
