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
// The per-pixel forward and adjoint (pixel_step) and the camera chain live
// in render_common.cuh, shared with the object-chunked step kernel.
#include "render_common.cuh"

using namespace rrt;

namespace {

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
      scene, p, i, j, i < p.H && j < p.W, target, w,
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
__global__ void finalize_kernel(const float* __restrict__ rowsum, const float* __restrict__ flat,
                                Layout ly, float* __restrict__ out) {
  for (int s = threadIdx.x; s < 1 + ly.S; s += blockDim.x) out[s] = rowsum[s];
  __syncthreads();
  if (threadIdx.x != 0) return;
  camera_chain(rowsum + 1 + ly.S, ld3(flat + ly.c_eye), ld3(flat + ly.c_look),
               ld3(flat + ly.c_up), flat[ly.c_fov], out + 1, ly.c_eye, ly.c_look, ly.c_up,
               ly.c_fov);
}

}  // namespace

extern "C" long long rrt_step_scratch_floats(int n_sph, int n_rect, int n_light, int H, int W) {
  const dim3 grid = pixel_grid(H, W);
  return ((long long)grid.x * grid.y + 1) * row_len(make_layout(n_sph, n_rect, n_light));
}

extern "C" int rrt_step(const float* flat, int n_sph, int n_rect, int n_light, int H, int W,
                        int shadows, int clip, const float* target, float w, float* scratch,
                        float* out, void* stream) {
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

  step_kernel<<<grid, dim3(BLOCK_X, BLOCK_Y), smem, st>>>(flat, p, ly, target, w, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<8><<<(ROW + 31) / 32, dim3(32, 8), 0, st>>>(partials, nrows, ROW, rowsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<1, 256, 0, st>>>(rowsum, flat, ly, out);
  return (int)cudaGetLastError();
}
