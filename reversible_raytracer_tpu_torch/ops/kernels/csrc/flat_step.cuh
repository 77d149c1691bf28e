// The kernels of the fused step for a flat scene (at most 24 objects),
// shared by the training step (fused_step.cu, ResidualSource) and the
// render backward (fused_render_bwd.cu, CotangentSource): one body, two
// kernels, as the TPU's make_bwd_kernel builds its step and backward.
//
// 1. flat_step_kernel: one thread per pixel, 32 x 8 pixels per block, scene
//    in shared memory. Each thread runs render_common.cuh's pixel_step: the
//    forward, the image cotangent from its source, and the hand-written
//    adjoint of the pixel. Each warp sums every gradient slot with shuffles
//    (skipping objects no lane of the warp hit) into its row of shared
//    memory; the block adds its 8 warp rows in order and writes one partial
//    row of 1 + S + 10 floats.
// 2. reduce_rows_kernel sums the partial rows, slot by slot, in a fixed
//    order.
// 3. flat_finalize_kernel copies [sq, grads] out and applies the
//    camera_basis / normalize / tan(deg2rad) chain once.
//
// No atomics: for a given image size the result is bit-for-bit the same
// from run to run on one card.
#pragma once

#include "render_common.cuh"

namespace rrt {

__host__ __device__ inline int row_len(const Layout& ly) { return 1 + ly.S + CAM_EXTRA; }

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

template <class Src>
__global__ void __launch_bounds__(BLOCK_THREADS)
    flat_step_kernel(const float* __restrict__ flat, Params p, Layout ly, Src src,
                     float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* sc = smem;
  const int ROW = row_len(ly);
  float* wp = smem + ly.S;  // NWARPS rows of ROW slots
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  stage(sc, flat, ly.S);
  for (int s = tid; s < NWARPS * ROW; s += BLOCK_THREADS) wp[s] = 0.0f;
  __syncthreads();
  float* wrow = wp + warp * ROW;  // [sq, scene grads (S), camera basis (10)]
  float* gs = wrow + 1;
  float* gx = wrow + 1 + ly.S;

  const int j = blockIdx.x * BLOCK_X + threadIdx.x;
  const int i = blockIdx.y * BLOCK_Y + threadIdx.y;
  const FlatScene scene{sc, ly};
  const PixelGrad g = pixel_step(
      scene, p, i, j, i < p.H && j < p.W, src, FullWalk{},
      [&](int l, V3 g_lpos, V3 g_lcol, bool warp_hit) {
        if (warp_hit) {
          put3(gs, ly.l_pos + 3 * l, g_lpos, lane);
          put3(gs, ly.l_col + 3 * l, g_lcol, lane);
        }
      });

  // ---- warp sums into this warp's row, then the block's partial row
  put(wrow, 0, g.sq, lane);
  put3(gs, ly.ambient, g.g_amb, lane);
  put3(gs, ly.background, g.g_bg, lane);
  put3(gs, ly.c_eye, g.g_eye, lane);
  put3(gx, 0, g.g_dt, lane);
  put3(gx, 3, g.g_dt * g.sx, lane);
  put3(gx, 6, g.g_dt * g.sy, lane);
  put(gx, 9, g.g_tan, lane);
  for (int k = 0; k < ly.N; ++k) {
    if (!__any_sync(FULL, g.k == k)) continue;  // every lane agrees
    const bool mine = g.k == k;
#pragma unroll
    for (int f = 0; f < SPH_FIELDS; ++f) put(gs, sphere_slot(ly, k, f), mine ? g.obj[f] : 0.0f, lane);
  }
  for (int k = 0; k < ly.M; ++k) {
    if (!__any_sync(FULL, g.k == ly.N + k)) continue;
    const bool mine = g.k == ly.N + k;
#pragma unroll
    for (int f = 0; f < RECT_FIELDS; ++f) put(gs, rect_slot(ly, k, f), mine ? g.obj[f] : 0.0f, lane);
  }
  __syncthreads();
  float* prow = partials + (long long)(blockIdx.y * gridDim.x + blockIdx.x) * ROW;
  for (int s = tid; s < ROW; s += BLOCK_THREADS) {
    float acc = 0.0f;
    for (int v = 0; v < NWARPS; ++v) acc += wp[v * ROW + s];
    prow[s] = acc;
  }
}

// out = [sq, grads]; then the camera chain, once.
__global__ void flat_finalize_kernel(const float* __restrict__ rowsum,
                                     const float* __restrict__ flat, Layout ly,
                                     float* __restrict__ out) {
  for (int s = threadIdx.x; s < 1 + ly.S; s += blockDim.x) out[s] = rowsum[s];
  __syncthreads();
  if (threadIdx.x != 0) return;
  camera_chain(rowsum + 1 + ly.S, ld3(flat + ly.c_eye), ld3(flat + ly.c_look),
               ld3(flat + ly.c_up), flat[ly.c_fov], out + 1, ly.c_eye, ly.c_look, ly.c_up,
               ly.c_fov);
}


inline long long flat_step_scratch_floats(int n_sph, int n_rect, int n_light, int H, int W) {
  const dim3 grid = pixel_grid(H, W);
  return ((long long)grid.x * grid.y + 1) * row_len(make_layout(n_sph, n_rect, n_light));
}

// The three launches on one stream; out = [sq, grads (S)].
template <class Src>
int launch_flat_step(const float* flat, int n_sph, int n_rect, int n_light, int H, int W,
                     int shadows, int clip, Src src, float* scratch, float* out,
                     void* stream) {
  const Layout ly = make_layout(n_sph, n_rect, n_light);
  const Params p = make_params(H, W, shadows, clip);
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid = pixel_grid(H, W);
  const int nrows = grid.x * grid.y;
  const int ROW = row_len(ly);
  float* partials = scratch;
  float* rowsum = scratch + (long long)nrows * ROW;
  const size_t smem = (size_t)(ly.S + NWARPS * ROW) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // > 24 objects; refused in Python

  flat_step_kernel<Src><<<grid, dim3(BLOCK_X, BLOCK_Y), smem, st>>>(flat, p, ly, src, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<8><<<(ROW + 31) / 32, dim3(32, 8), 0, st>>>(partials, nrows, ROW, rowsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flat_finalize_kernel<<<1, 256, 0, st>>>(rowsum, flat, ly, out);
  return (int)cudaGetLastError();
}

}  // namespace rrt
