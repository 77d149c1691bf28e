#!/usr/bin/env python3
"""Where the time of the object-chunked kernels goes: variant builds of
their CUDA sources with one part cut each, timed on the card beside the
unchanged build. By default the step (row 6, csrc/fused_vec_step.cu, body
csrc/vec_step.cuh).

    python3 tools/vec_step_split.py [--tree DIR] [--reps 2]
                                    [--kernel step|bwd|fwd|soft_fwd] [--textured]

``--tree`` names a checkout of the repository whose kernels are split (by
default the one this script lies in); its port package is imported and its
``csrc`` copied, so a ``git archive`` of an older commit can be split with
this script. Each variant is the tree's ``csrc`` copied into its build
directory with text substitutions (a substitution that does not match
raises), built with the port's nvcc flags, loaded with ctypes and called
through ``rrt_vec_step`` on config 5 at 1024^2 and on the 513-object shape
at 512^2 (perturb(scale=0.05, seed=4) against the plain render of the true
scene). ``--kernel bwd`` splits the render backward (row 5,
csrc/fused_vec_render_bwd.cu, the same body) instead, through
``rrt_vec_render_bwd`` with a seeded normal cotangent and the vec
forward's planes; it casts no shadow rays, so it has no shadow_lit cut.
``--kernel fwd`` splits the vec forward (row 4, csrc/fused_vec_render.cu,
through ``rrt_vec_render``) at the same two shapes, and ``--kernel
soft_fwd`` the soft forward (row 7, csrc/fused_vec_soft_render.cu, through
``rrt_soft_render``) at config 5 512^2 and 1024^2 and at 513 objects 512^2,
tau 0.08; both render the perturbed scene.
The builds are timed in turns, every variant once per round, for
``--reps`` rounds (CUDA events, median of 20 after 3 warm-ups each; for the
forwards also each build's device time per call, `device_ms`).

The step's and backward's cuts (two sets: the object-chunked step before
the per-warp culls, and after, told apart by csrc/cull.cuh):
  - primary_winner: the nearest-hit walk cut to the winner only, read from
    a plane the script computes with `nearest_vec`;
  - shadow_lit: the shadow rays' any-hit walk cut to a read of the vec
    forward's visibility plane (the same bits, so the same later work);
  - no_adjoint: the per-pixel adjoint, the light sums and the winner lists
    cut (the forward and the squared error stay);
  - no_block_row: the warps' lists into the block's object row and the
    object part of the partial rows cut;
  - no_reduce: the launch of the partial rows' reduction cut.
The forwards' cuts (two sets each: before the per-warp culls and after,
told apart by whether the forward's source calls primary_candidates):
  - primary_winner (row 4) / primary_layers (row 7): the primary walk (with
    its cull) cut to the winner, or the two layers, read from planes the
    script computes (`nearest_vec`, `two_layers`), their t recomputed;
  - shadow_plane: the shadow walks (with their culls) cut to a read of
    planes: row 4's visibility from the shipped forward, row 7's soft
    visibility per layer and light from its eager twin;
  - no_phong: the Phong terms of each light cut to the visibility alone;
  - no_writes: the image's (and planes') stores cut to one that never runs;
  - tile_grid (row 4, after the culls): one block per 32 x 8 tile in place
    of the grid of resident blocks that walk the tiles in a stride;
    resident_grid (row 7, after the culls): the other way round;
  - three_blocks (after the culls): not a cut but the launch bound of 3
    blocks an SM, which lets ptxas give a thread 85 registers where it
    otherwise keeps 64.
``--textured`` (with ``--kernel step`` or ``bwd``) splits the textured
instances instead (vec_step_tex_kernel, through the ``_tex`` entries) on
chip_smoke.py's 64 textured globes at 512^2 without and with one bounce
(`globes_case`, perturb(scale=0.4, seed=0) of the texels), with the cuts of
the object texel records' pass:
  - no_texel_scatter: the records' scatter into the block's texel row cut
    (the warp-by-warp loop and its barriers stay);
  - no_texel_pass: the whole warp-by-warp loop cut, barriers included.
A part's time is the unchanged build's less the variant's. Prints one JSON
line per shape, then the card's nvidia-smi line; stops on a build failure.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

from kernel_timing import time_ms

HERE = Path(__file__).resolve().parent.parent

# Device pointers the cut variants read: the winner plane and the
# visibility planes, set through rrt_split_set.
DECL = ("namespace rrt {\n\nconstexpr float BIG",
        "namespace rrt {\n\n__device__ const int* split_winner;\n"
        "__device__ const float* split_vis;\n\nconstexpr float BIG")
SETTER = """
extern "C" int rrt_split_set(const int* w, const float* v) {
  cudaMemcpyToSymbol(rrt::split_winner, &w, sizeof(w));
  cudaMemcpyToSymbol(rrt::split_vis, &v, sizeof(v));
  return (int)cudaGetLastError();
}
"""
WINNER_ONLY = """Nearest h = {BIG, -1};
  if (inside) {
    const int kw = split_winner[(long long)i * p.W + j];
    const int kr = kw - sc.rect_base();
    float a_, b_;
    if (kw >= 0 && kr < 0) h = {hit_sphere(o, d, sc.s_center(kw), sc.s_radius(kw)), kw};
    else if (kw >= 0)
      h = {hit_rect(o, d, sc.r_origin(kr), sc.r_eu(kr), sc.r_ev(kr), &a_, &b_), kw};
  }"""
LIT_OLD = """  __device__ __forceinline__ bool lit(const S& sc, const Params& p, int, int, int, V3 so,
                                      const LightGeo& g) const {
    return !p.shadows || !occluded(sc, so, g.ldir, g.dist);
  }"""
LIT_PLANE = """  __device__ __forceinline__ bool lit(const S&, const Params& p, int i, int j, int l, V3,
                                      const LightGeo&) const {
    return !p.shadows || split_vis[((long long)l * p.H + i) * p.W + j] != 0.0f;
  }"""
CUT_ADJOINT = """
  {
    out.g_amb = out.g_bg = out.g_eye = out.g_dt = zero3();
    out.sx = out.sy = out.g_tan = 0.0f;
    out.k = -1;
    for (int f = 0; f < RECT_FIELDS; ++f) out.obj[f] = 0.0f;
    return out;
  }
"""
CLIP_GRAD = ("  if (p.clip) gc = {gc.x * clipgrad(pre.x), gc.y * clipgrad(pre.y), "
             "gc.z * clipgrad(pre.z)};\n")
REDUCE_LAUNCH = """  reduce_rows_kernel<VEC_REDUCE_RY><<<(plan.ROW + 31) / 32, dim3(32, VEC_REDUCE_RY), 0, st>>>(
      partials, nrows, plan.ROW, rowsum);
"""

# The step before the per-warp culls (one block per 32 x 8 tile).
CUTS_PARENT = {
    "full": [],
    "primary_winner": [("render_common.cuh",
                        "const Nearest h = inside ? trace(sc, o, d) : Nearest{BIG, -1};",
                        WINNER_ONLY)],
    "shadow_lit": [("render_common.cuh", LIT_OLD, LIT_PLANE)],
    "no_adjoint": [("render_common.cuh", CLIP_GRAD, CLIP_GRAD + CUT_ADJOINT)],
    "no_block_row": [
        ("vec_step.cuh", "s < NWARPS * GROW + OROW; s += BLOCK_THREADS) wp[s] = 0.0f;",
         "s < NWARPS * GROW; s += BLOCK_THREADS) wp[s] = 0.0f;"),
        ("vec_step.cuh", "  for (int v = 0; v < NWARPS; ++v) {\n    const int cnt = wcnt[v];",
         "  for (int v = 0; v < 0; ++v) {\n    const int cnt = wcnt[v];"),
        ("vec_step.cuh",
         "  for (int s = tid; s < OROW; s += BLOCK_THREADS) prow[GROW + s] = orow[s];",
         "  if (tid == 0) prow[GROW] = wval[0];"),
    ],
    "no_reduce": [("vec_step.cuh", REDUCE_LAUNCH, "")],
}

# The step with the per-warp culls and a grid of resident blocks, each over
# several tiles (csrc/cull.cuh present).
LIT_CULLED = """  template <class Occ>
  __device__ __forceinline__ bool lit(const Params& p, int, int, int, Occ occ) const {
    return !p.shadows || !occ();
  }"""
LIT_CULLED_PLANE = """  template <class Occ>
  __device__ __forceinline__ bool lit(const Params& p, int i, int j, int l, Occ) const {
    return !p.shadows || split_vis[((long long)l * p.H + i) * p.W + j] != 0.0f;
  }"""
LIST_ADDS = """  for (int v = 0; v < NWARPS; ++v) {
    if (v == warp && ke >= 0) {"""
LIST_KEPT = """  if (ke == -7) {  // never: keeps the lists' sums without the adds
    float z = 0.0f;
    for (int f = 0; f < RECT_FIELDS; ++f) z += acc[f];
    orow[0] = z;
  }
  for (int v = 0; v < 0; ++v) {
    if (v == warp && ke >= 0) {"""
CUTS_CULLED = {
    "full": [],
    "primary_winner": [("render_common.cuh", "  f.h = walk.trace(sc, o, d, inside);",
                        "  " + WINNER_ONLY + "\n  f.h = h;")],
    "shadow_lit": [("render_common.cuh",
                    "  walk.shadows(sc, p, src, shadow_origin(o, d, f.h.t, f.s.n), hit);\n", ""),
                   ("render_common.cuh", LIT_CULLED, LIT_CULLED_PLANE)],
    "no_adjoint": [("render_common.cuh", CLIP_GRAD, CLIP_GRAD + CUT_ADJOINT)],
    "no_block_row": [
        ("vec_step.cuh", LIST_ADDS, LIST_KEPT),
        ("vec_step.cuh",
         "  for (int s = tid; s < OROW; s += BLOCK_THREADS) prow[GROW + s] = orow[s];",
         "  if (tid == 0) prow[GROW] = orow[0];"),
    ],
    "no_reduce": [("vec_step.cuh", REDUCE_LAUNCH.replace("nrows", "nblocks"), "")],
}


# The textured step and backward (vec_step_tex_kernel): the object texel
# records' pass after each tile's winner lists.
TEX_CUTS = {
    "full": [],
    "no_texel_scatter": [("vec_step.cuh", "scatter_texels(pg.otex[q], trow, trec, lane);",
                          "(void)q;")],
    "no_texel_pass": [("vec_step.cuh",
                       "            for (int v = 0; v < NWARPS; ++v) {\n              if (v == warp) {",
                       "            for (int v = 0; v < 0; ++v) {\n              if (v == warp) {")],
}


# The forwards (rows 4 and 7). Helpers the cuts call, added at the end of a
# header: the winner (or each layer's winner) read from split_winner and its
# t recomputed.
SPLIT_NEAREST = """template <class S>
__device__ __forceinline__ Nearest split_nearest(const S& sc, V3 o, V3 d, long long px) {
  const int kw = split_winner[px];
  const int kr = kw - sc.rect_base();
  float a_, b_;
  if (kw < 0) return {BIG, -1};
  if (kr < 0) return {hit_sphere(o, d, sc.s_center(kw), sc.s_radius(kw)), kw};
  return {hit_rect(o, d, sc.r_origin(kr), sc.r_eu(kr), sc.r_ev(kr), &a_, &b_), kw};
}

}  // namespace rrt"""
SPLIT_LAYERS = """template <class S>
__device__ __forceinline__ Layers split_layers(const S& sc, V3 o, V3 d, float tau, long long px,
                                               long long plane) {
  Layers y;
  for (int ly = 0; ly < 2; ++ly) {
    const int kw = split_winner[ly * plane + px];
    const int kr = kw - sc.rect_base();
    float a_, b_;
    y.l[ly] = kw < 0   ? Nearest{BIG, -1}
              : kr < 0 ? Nearest{sphere_rank(o, d, sc.s_center(kw), sc.s_radius(kw), tau), kw}
                       : Nearest{hit_rect(o, d, sc.r_origin(kr), sc.r_eu(kr), sc.r_ev(kr), &a_,
                                          &b_), kw};
  }
  return y;
}

}  // namespace rrt"""
NS_END = "}  // namespace rrt"
PHONG = """    const float ndotl = fmaxf(dot(s.n, g.ldir), 0.0f);
    const V3 refl = s.n * (2.0f * ndotl) - g.ldir;
    const float spec = s.ks * safe_pow(fmaxf(dot(refl, view), 0.0f), s.shin);
    const V3 lcol = sc.l_col(l);
    col.x += v * (s.kd * ndotl * s.base.x + spec) * lcol.x;
    col.y += v * (s.kd * ndotl * s.base.y + spec) * lcol.y;
    col.z += v * (s.kd * ndotl * s.base.z + spec) * lcol.z;
"""
PHONG_CUT = "    col.x += v;\n"
IMG_STORES = """  img[3 * px + 0] = col.x;
  img[3 * px + 1] = col.y;
  img[3 * px + 2] = col.z;
"""

# Row 4 before the culls: render_pixel (render_common.cuh) per pixel.
FWD_PARENT = {
    "full": [],
    "primary_winner": [
        ("render_common.cuh", NS_END, SPLIT_NEAREST),
        ("render_common.cuh", "const Nearest h = trace(sc, cam.eye, r.d);",
         "const Nearest h = split_nearest(sc, cam.eye, r.d, (long long)i * p.W + j);")],
    "shadow_plane": [("render_common.cuh", """      [&](int, V3 so, const LightGeo& g) {
        return !p.shadows || !occluded(sc, so, g.ldir, g.dist);  // all lit without shadows""",
                      """      [&](int l, V3, const LightGeo&) {
        return !p.shadows || split_vis[((long long)l * p.H + i) * p.W + j] != 0.0f;""")],
    "no_phong": [("render_common.cuh", PHONG, PHONG_CUT)],
    "no_writes": [("fused_vec_render.cu", IMG_STORES + """  if (p.shadows) {
    const long long plane = (long long)p.H * p.W;
    for (int l = 0; l < gl.L; ++l) vis[l * plane + px] = ((bits >> l) & 1u) ? 1.0f : 0.0f;
  }
""", "  if (col.x + col.y + col.z == -7.0f + (float)bits) img[px] = 0.0f;\n")],
}

# Row 7 before the culls: two_layers and layer_color (soft_common.cuh).
SOFT_FWD_PARENT = {
    "full": [],
    "primary_layers": [
        ("soft_common.cuh", NS_END, SPLIT_LAYERS),
        ("fused_vec_soft_render.cu", "const Layers y = two_layers(sc, cam.eye, r.d, tau);",
         "const Layers y = split_layers(sc, cam.eye, r.d, tau, (long long)i * p.W + j,\n"
         "                                (long long)p.H * p.W);")],
    "shadow_plane": [("fused_vec_soft_render.cu", """  const LayerColor c1 = layer_color(sc, p, cam.eye, r.d, y.l[0], tau);
  const LayerColor c2 = layer_color(sc, p, cam.eye, r.d, y.l[1], tau);
""", """  const long long px_ = (long long)i * p.W + j, hw_ = (long long)p.H * p.W;
  auto split_lc = [&](int ly) {
    const Nearest h = y.l[ly];
    if (h.k < 0) return LayerColor{sc.background(), 0.0f};
    const Surface s = surface(sc, cam.eye, r.d, h);
    auto vis = [&](int l, V3, const LightGeo&) {
      return p.shadows ? split_vis[(ly * gl.L + l) * hw_ + px_] : 1.0f;
    };
    return LayerColor{shade_soft_layer(sc, cam.eye, r.d, h.t, s, vis),
                      layer_alpha(sc, cam.eye, r.d, h, tau)};
  };
  const LayerColor c1 = split_lc(0);
  const LayerColor c2 = split_lc(1);
""")],
    "no_phong": [("soft_common.cuh", PHONG, PHONG_CUT)],
    "no_writes": [("fused_vec_soft_render.cu", IMG_STORES,
                   "  if (col.x + col.y + col.z == -7.0f) img[px] = 0.0f;\n")],
}

# The forwards with the per-warp culls: a grid of resident blocks, each over
# several tiles (the forward's source calls primary_candidates).
STORES_CULLED = """    const long long px = (long long)i * p.W + j;
    img[3 * px + 0] = col.x;
    img[3 * px + 1] = col.y;
    img[3 * px + 2] = col.z;
"""
PLANE_STORES = """    if (p.shadows)
      for (int l = 0; l < gl.L; ++l)
        vis[l * plane + px] = (hit && ((bits >> l) & 1u)) ? 1.0f : 0.0f;
"""
STORES_NEVER = """    const long long px = (long long)i * p.W + j;
    if (col.x + col.y + col.z == -7.0f + (float)bits) img[px] = 0.0f;
"""


def three_blocks(kernel_fn):
    return ("__global__ void __launch_bounds__(BLOCK_THREADS)\n    " + kernel_fn,
            "__global__ void __launch_bounds__(BLOCK_THREADS, 3)\n    " + kernel_fn)


FWD_CULLED = {
    "full": [],
    "primary_winner": [
        ("render_common.cuh", NS_END, SPLIT_NEAREST),
        ("fused_vec_render.cu", """    primary_candidates(sc, o, d, inside, 0.0f, lane, fb.wm);
    const Nearest h = inside ? trace_candidates(sc, o, d, fb.wm, fb.nw) : Nearest{BIG, -1};""",
         """    const Nearest h = inside ? split_nearest(sc, o, d, (long long)i * p.W + j)
                             : Nearest{BIG, -1};""")],
    "shadow_plane": [("fused_vec_render.cu", """    const unsigned bits = shadow_bits(so, hit);""",
                      """    unsigned bits = p.shadows ? 0u : ~0u;
    if (p.shadows && hit)
      for (int l = 0; l < gl.L; ++l)
        if (split_vis[l * plane + (long long)i * p.W + j] != 0.0f) bits |= 1u << l;""")],
    "no_phong": [("render_common.cuh", PHONG, PHONG_CUT)],
    "no_writes": [("fused_vec_render.cu", STORES_CULLED + PLANE_STORES, STORES_NEVER)],
    "tile_grid": [("fused_vec_render.cu",
                   "  const int nblocks = resident_blocks(kernel, smem, p.H, p.W);",
                   "  const int nblocks = pixel_grid(p.H, p.W).x * pixel_grid(p.H, p.W).y;")],
    "three_blocks": [("fused_vec_render.cu", *three_blocks("vec_render_kernel"))],
}

SOFT_FWD_CULLED = {
    "full": [],
    "primary_layers": [
        ("soft_common.cuh", NS_END, SPLIT_LAYERS),
        ("fused_vec_soft_render.cu", """    primary_candidates(sc, o, d, inside, tau, lane, fb.wm);
    Layers y = {{{BIG, -1}, {BIG, -1}}};
    if (inside) y = two_layers(sc, o, d, tau, fb.wm, fb.nw);""", """    Layers y = {{{BIG, -1}, {BIG, -1}}};
    if (inside) y = split_layers(sc, o, d, tau, (long long)i * p.W + j, (long long)p.H * p.W);""")],
    "shadow_plane": [("fused_vec_soft_render.cu", """          return p.shadows ? soft_visibility(sc, so, lg, sc.l_pos(l), live, tau, lane, fb.wm)
                           : 1.0f;""", """          return p.shadows && inside
                     ? split_vis[(ly * gl.L + l) * (long long)p.H * p.W + (long long)i * p.W + j]
                     : 1.0f;""")],
    "no_phong": [("soft_common.cuh", PHONG, PHONG_CUT)],
    "no_writes": [("fused_vec_soft_render.cu", STORES_CULLED,
                   STORES_NEVER.replace(" + (float)bits", ""))],
    "resident_grid": [("fused_vec_soft_render.cu", """  const dim3 tiles = pixel_grid(H, W);
  kernel<<<tiles.x * tiles.y,""", """  const int nblocks = resident_blocks(kernel, smem, H, W);
  if (nblocks <= 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<nblocks,""")],
    "three_blocks": [("fused_vec_soft_render.cu", *three_blocks("soft_render_kernel"))],
}


def make_variant(csrc: Path, root: Path, subs, source: str) -> Path:
    """A copy of ``csrc`` under ``root`` with the substitutions applied and
    the setter appended to ``source``; returns that source."""
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(csrc, root)
    for name, old, new in [("render_common.cuh", *DECL), *subs]:
        path = root / name
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{root.name}: {name} holds {text.count(old)} copies of {old!r}")
        path.write_text(text.replace(old, new))
    path = root / source
    path.write_text(path.read_text() + SETTER)
    return path


def build_variants(_build, cuts, kernel, kernel_fn):
    """Build every variant of ``cuts`` for ``kernel`` (one nvcc process each,
    all started together) under the tree's build directory and load them;
    returns ``(libs, ptxas)``, ptxas's lines on ``kernel_fn`` and registers
    for each."""
    build = _build.BUILD_DIR / "split"
    procs = {}
    for name, subs in cuts.items():
        src = make_variant(_build.CSRC, build / name, subs, kernel.source.name)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(build / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if kernel_fn in ln or "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(str(build / f"lib{name}.so"))
        for fn, (argtypes, restype) in kernel.signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.rrt_split_set.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.rrt_split_set.restype = ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def cut_set(csrc: Path, kernel: str):
    """("parent" or "culled", the cuts) of ``kernel`` for the sources in
    ``csrc``."""
    if kernel in ("step", "bwd"):
        culled = (csrc / "cull.cuh").exists()
        cuts = CUTS_CULLED if culled else CUTS_PARENT
        if kernel == "bwd":  # it casts no shadow rays
            cuts = {name: subs for name, subs in cuts.items() if name != "shadow_lit"}
        return ("culled" if culled else "parent"), cuts
    source = "fused_vec_render.cu" if kernel == "fwd" else "fused_vec_soft_render.cu"
    culled = "primary_candidates" in (csrc / source).read_text()
    table = {("fwd", False): FWD_PARENT, ("fwd", True): FWD_CULLED,
             ("soft_fwd", False): SOFT_FWD_PARENT, ("soft_fwd", True): SOFT_FWD_CULLED}
    return ("culled" if culled else "parent"), table[kernel, culled]


def _forward_planes(kind, start, cfg, fused_vec):
    """(winner planes, visibility planes) the forwards' cuts read: row 4's
    winner and the shipped forward's visibility; row 7's two layers'
    winners and the soft visibility of each layer and light (eager twin).
    Winners are in the kernels' index space (rects from ns_pad)."""
    import torch

    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops import pipeline_vec as pv
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec_soft

    N, ns_pad = start.spheres.count, fused_vec.row_plan(start)[0]
    o, d = pl.primary_rays(start, cfg)
    to_kernel = lambda k: torch.where(k >= N, k - N + ns_pad, k).to(torch.int32)  # noqa: E731
    if kind == "fwd":
        return (to_kernel(pv.nearest_vec(start, o, d)[1]).contiguous(),
                fused_vec.render_vec(start, cfg)[1].contiguous())
    tau = cfg.soft_tau
    ray = fused.primary_ray_terms(start, cfg)
    zero = torch.zeros((cfg.height, cfg.width), device=start.device)
    winners, vis = [], []
    with torch.no_grad():
        for _, k in pv.two_layers(start, o, d, tau):
            winners.append(to_kernel(k))
            y = fused_vec_soft._layer(start, cfg, ray, k, tau, zero)
            vis += [f.vis for f in y.lights]
    return torch.stack(winners).contiguous(), torch.stack(vis).contiguous()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--kernel", choices=("step", "bwd", "fwd", "soft_fwd"), default="step")
    ap.add_argument("--textured", action="store_true",
                    help="the textured instances of the step or backward, on the globes")
    args = ap.parse_args()
    if args.textured and args.kernel not in ("step", "bwd"):
        ap.error("--textured splits the step or the render backward")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("vec_step_split: no CUDA device", file=sys.stderr)
        return 2
    from kernel_timing import device_ms

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops.kernels import _build, fused_vec, fused_vec_soft
    from reversible_raytracer_tpu_torch.ops.pipeline_vec import nearest_vec

    which, cuts = cut_set(_build.CSRC, args.kernel)
    if args.textured:
        which, cuts = "textured", TEX_CUTS
    step = args.kernel == "step"
    forward = args.kernel in ("fwd", "soft_fwd")
    kernel = {"step": fused_vec.VEC_STEP, "bwd": fused_vec.VEC_RENDER_BWD,
              "fwd": fused_vec.VEC_RENDER, "soft_fwd": fused_vec_soft.SOFT_RENDER}[args.kernel]
    kernel_fn = {"fwd": "vec_render_kernel", "soft_fwd": "soft_render_kernel"}.get(
        args.kernel, "vec_step_tex_kernel" if args.textured else "vec_step_kernel")
    libs, ptxas = build_variants(_build, cuts, kernel, kernel_fn)
    print(json.dumps({"split": "build", "kernel": kernel.name, "cuts": which,
                      "ptxas": ptxas}), flush=True)

    stream = torch.cuda.current_stream().cuda_stream
    if args.textured:
        return split_textured(args, libs, kernel, step, tree)
    shapes = ((("config5_1024", 64, 1024, 0.0), ("513obj_512", 512, 512, 0.0))
              if args.kernel != "soft_fwd" else
              (("config5_512_t0.08", 64, 512, 0.08), ("config5_1024_t0.08", 64, 1024, 0.08),
               ("513obj_512_t0.08", 512, 512, 0.08)))
    for label, n_spheres, size, tau in shapes:
        scene, spec, cfg = configs.config5_many_spheres(size=size, n_spheres=n_spheres,
                                                        device="cuda")
        cfg = dataclasses.replace(cfg, soft_tau=tau)
        start = configs.perturb(scene, spec, scale=0.05, seed=4)
        target = fused_vec.render_vec_plain(scene, cfg)[0].contiguous() if step else None
        glob, sph, rct = fused_vec.packed_inputs(start)
        geom = fused_vec._geometry(start, cfg)
        H, W = cfg.height, cfg.width
        if forward:
            winner, vis = _forward_planes(args.kernel, start, cfg, fused_vec)
        else:
            ns_pad = geom[2]
            o, d = pl.primary_rays(start, cfg)
            k = nearest_vec(start, o, d)[1]
            winner = torch.where(k >= start.spheres.count, k - start.spheres.count + ns_pad,
                                 k).to(torch.int32).contiguous()
            vis = fused_vec.render_vec(start, cfg)[1].contiguous()
        g_img = torch.from_numpy(np.random.default_rng(0).normal(size=(H, W, 3)).astype(
            np.float32)).cuda()
        scratch = None
        if not forward:
            n_scratch = getattr(libs["full"], f"rrt_{'vec_step' if step else 'vec_render_bwd'}"
                                              f"_scratch_floats")(*geom[2:7])
            scratch = torch.empty((n_scratch,), device="cuda")
        size_out = (H * W * 3 if forward
                    else 1 + glob.numel() + sph.numel() + rct.numel())
        outs = {name: torch.empty((size_out,), device="cuda") for name in libs}
        planes_out = torch.empty((start.lights.count, H, W), device="cuda")
        calls = {}
        for name, lib in libs.items():
            if lib.rrt_split_set(winner.data_ptr(), vis.data_ptr()) != 0:
                raise RuntimeError(f"rrt_split_set failed for {name}")

            def call(lib=lib, out=outs[name]):
                rows = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom)
                if args.kernel == "fwd":
                    err = lib.rrt_vec_render(*rows, out.data_ptr(), planes_out.data_ptr(), stream)
                elif args.kernel == "soft_fwd":
                    err = lib.rrt_soft_render(*rows, tau, 0.0, out.data_ptr(), stream)
                elif step:
                    err = lib.rrt_vec_step(*rows, target.data_ptr(), 1.0 / (H * W * 3),
                                           scratch.data_ptr(), out.data_ptr(), stream)
                else:
                    err = lib.rrt_vec_render_bwd(*rows, g_img.data_ptr(), vis.data_ptr(),
                                                 scratch.data_ptr(), out.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(f"{kernel.name} failed: CUDA error {err}")
            calls[name] = call
            call()
        torch.cuda.synchronize()
        if step:  # the full build's loss is the shipped kernel's
            shipped = fused_vec.loss_grad_vec(start, cfg, target)[0]
            same_as_shipped = bool(torch.equal(
                shipped, fused_vec.fused._loss_norm(cfg, "mse") * outs["full"][0]))
        elif forward:  # the full build's image is the shipped kernel's
            shipped = (fused_vec.render_vec(start, cfg)[0] if args.kernel == "fwd"
                       else fused_vec_soft.render_vec_soft(start, cfg))
            same_as_shipped = bool(torch.equal(shipped.reshape(-1), outs["full"]))
        else:  # the full build's gradient row is the shipped kernel's
            shipped = torch.empty_like(outs["full"])
            kernel.call("rrt_vec_render_bwd", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(),
                        *geom, g_img.data_ptr(), vis.data_ptr(), scratch.data_ptr(),
                        shipped.data_ptr(), stream)
            torch.cuda.synchronize()
            same_as_shipped = bool(torch.equal(shipped, outs["full"]))
        diff = {name: float((outs[name] - outs["full"]).abs().max()) for name in libs}
        times = {name: [] for name in libs}
        dev = {name: [] for name in libs}
        for _ in range(args.reps):
            for name, call in calls.items():
                times[name].append(time_ms(call))
                if forward:
                    dev[name].append(device_ms(call)["ms"])
        full = statistics.mean(times["full"])
        line = {"split": label, "ms": times,
                "part_ms": {name: full - statistics.mean(t)
                            for name, t in times.items() if name != "full"},
                "max_diff_from_full": diff, "full_is_shipped": same_as_shipped}
        if forward:
            dfull = statistics.mean(dev["full"])
            line.update(device_ms=dev, part_device_ms={
                name: dfull - statistics.mean(t) for name, t in dev.items() if name != "full"})
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


def split_textured(args, libs, kernel, step, tree) -> int:
    """The ``--textured`` split: every build's event time through the
    ``_tex`` entries on the globes at 512^2 without and with one bounce."""
    import numpy as np
    import torch

    sys.path.insert(0, str(tree))
    from chip_smoke import globes_case

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec

    stream = torch.cuda.current_stream().cuda_stream
    for refl in (0, 1):
        scene, spec, cfg = globes_case(512, refl)
        start = configs.perturb(scene, spec, scale=0.4, seed=0)
        target = fused_vec.render_vec(scene, cfg)[0].contiguous()
        vis = fused_vec.render_vec(start, cfg)[1].contiguous()
        glob, sph, rct = fused_vec.packed_inputs(start)
        tex = fused_vec.texel_inputs(start)
        geom = fused_vec._geometry(start, cfg)
        tl = fused_vec.tex_levels(start, cfg)
        H, W = cfg.height, cfg.width
        g_img = torch.from_numpy(np.random.default_rng(0).normal(size=(H, W, 3)).astype(
            np.float32)).cuda()
        entry = "vec_step" if step else "vec_render_bwd"
        scratch = torch.empty((getattr(libs["full"], f"rrt_{entry}_tex_scratch_floats")(
            geom[0], geom[1], *geom[4:7], *tl[1:]),), device="cuda")
        n_out = 1 + glob.numel() + sph.numel() + rct.numel() + fused_vec.texel_row(start)
        outs = {name: torch.empty((n_out,), device="cuda") for name in libs}
        rows = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *(t.data_ptr() for t in tex),
                *geom)
        calls = {}
        for name, lib in libs.items():
            def call(lib=lib, out=outs[name]):
                if step:
                    err = lib.rrt_vec_step_tex(*rows, *tl, target.data_ptr(), 1.0 / (H * W * 3),
                                               scratch.data_ptr(), out.data_ptr(), stream)
                else:
                    err = lib.rrt_vec_render_bwd_tex(*rows, 0.0, 0.0, *tl, g_img.data_ptr(),
                                                     vis.data_ptr(), scratch.data_ptr(),
                                                     out.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(f"{kernel.name} failed: CUDA error {err}")
            calls[name] = call
            call()
        torch.cuda.synchronize()
        if step:  # the full build's loss and gradient are the shipped kernel's
            l_s, g_s = fused_vec.loss_grad_vec(start, cfg, target)
            norm = fused_vec.fused._loss_norm(cfg, "mse")
            same_as_shipped = bool(torch.equal(l_s, norm * outs["full"][0]) and torch.equal(
                torch.cat([t.reshape(-1) for t in fused_vec.pack_texels(g_s)]),
                outs["full"][n_out - fused_vec.texel_row(start):]))
        else:
            shipped = fused_vec._render_bwd_launch(start, cfg, (0.0, 0.0), glob, sph, rct, g_img,
                                                   vis, tex)
            same_as_shipped = bool(torch.equal(
                torch.cat([t.reshape(-1) for t in fused_vec.pack_texels(shipped)]),
                outs["full"][n_out - fused_vec.texel_row(start):]))
        diff = {name: float((outs[name] - outs["full"]).abs().max()) for name in libs}
        times = {name: [] for name in libs}
        for _ in range(args.reps):
            for name, call in calls.items():
                times[name].append(time_ms(call))
        full = statistics.mean(times["full"])
        print(json.dumps({"split": f"globes_r{refl}_512", "ms": times,
                          "part_ms": {name: full - statistics.mean(t)
                                      for name, t in times.items() if name != "full"},
                          "max_diff_from_full": diff, "full_is_shipped": same_as_shipped}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
