#!/usr/bin/env python3
"""Where the time of the object-chunked step (row 6, csrc/fused_vec_step.cu,
body csrc/vec_step.cuh) goes: variant builds of its CUDA sources with one
part cut each, timed on the card beside the unchanged build.

    python3 tools/vec_step_split.py [--tree DIR] [--reps 2] [--kernel step|bwd]

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
The builds are timed in turns, every variant once per round, for
``--reps`` rounds (CUDA events, median of 20 after 3 warm-ups each).

The cuts (two sets: the object-chunked step before the per-warp culls, and
after, told apart by csrc/cull.cuh):
  - primary_winner: the nearest-hit walk cut to the winner only, read from
    a plane the script computes with `nearest_vec`;
  - shadow_lit: the shadow rays' any-hit walk cut to a read of the vec
    forward's visibility plane (the same bits, so the same later work);
  - no_adjoint: the per-pixel adjoint, the light sums and the winner lists
    cut (the forward and the squared error stay);
  - no_block_row: the warps' lists into the block's object row and the
    object part of the partial rows cut;
  - no_reduce: the launch of the partial rows' reduction cut.
A part's time is the unchanged build's less the variant's. Prints one JSON
line per shape, then the card's nvidia-smi line; stops on a build failure.
"""

from __future__ import annotations

import argparse
import ctypes
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
LIST_ADDS = """    for (int v = 0; v < NWARPS; ++v) {
      if (v == warp && ke >= 0) {"""
LIST_KEPT = """    if (ke == -7) {  // never: keeps the lists' sums without the adds
      float z = 0.0f;
      for (int f = 0; f < RECT_FIELDS; ++f) z += acc[f];
      orow[0] = z;
    }
    for (int v = 0; v < 0; ++v) {
      if (v == warp && ke >= 0) {"""
CUTS_CULLED = {
    "full": [],
    "primary_winner": [("render_common.cuh", "const Nearest h = walk.trace(sc, o, d, inside);",
                        WINNER_ONLY)],
    "shadow_lit": [("render_common.cuh",
                    "  walk.shadows(sc, p, src, shadow_origin(o, d, h.t, s.n), hit);\n", ""),
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--kernel", choices=("step", "bwd"), default="step")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("vec_step_split: no CUDA device", file=sys.stderr)
        return 2
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops.kernels import _build, fused_vec
    from reversible_raytracer_tpu_torch.ops.pipeline_vec import nearest_vec

    culled = (_build.CSRC / "cull.cuh").exists()
    cuts = CUTS_CULLED if culled else CUTS_PARENT
    step = args.kernel == "step"
    kernel = fused_vec.VEC_STEP if step else fused_vec.VEC_RENDER_BWD
    if not step:
        cuts = {name: subs for name, subs in cuts.items() if name != "shadow_lit"}
    libs, ptxas = build_variants(_build, cuts, kernel, "vec_step_kernel")
    print(json.dumps({"split": "build", "kernel": kernel.name,
                      "cuts": "culled" if culled else "parent",
                      "ptxas": ptxas}), flush=True)

    stream = torch.cuda.current_stream().cuda_stream
    for label, n_spheres, size in (("config5_1024", 64, 1024), ("513obj_512", 512, 512)):
        scene, spec, cfg = configs.config5_many_spheres(size=size, n_spheres=n_spheres,
                                                        device="cuda")
        start = configs.perturb(scene, spec, scale=0.05, seed=4)
        target = fused_vec.render_vec_plain(scene, cfg)[0].contiguous()
        glob, sph, rct = fused_vec.packed_inputs(start)
        geom = fused_vec._geometry(start, cfg)
        ns_pad = geom[2]
        o, d = pl.primary_rays(start, cfg)
        k = nearest_vec(start, o, d)[1]
        winner = torch.where(k >= start.spheres.count, k - start.spheres.count + ns_pad,
                             k).to(torch.int32).contiguous()
        vis = fused_vec.render_vec(start, cfg)[1].contiguous()
        H, W = cfg.height, cfg.width
        g_img = torch.from_numpy(np.random.default_rng(0).normal(size=(H, W, 3)).astype(
            np.float32)).cuda()
        n_scratch = getattr(libs["full"], f"rrt_{'vec_step' if step else 'vec_render_bwd'}"
                                          f"_scratch_floats")(*geom[2:7])
        scratch = torch.empty((n_scratch,), device="cuda")
        outs = {name: torch.empty((1 + glob.numel() + sph.numel() + rct.numel(),),
                                  device="cuda") for name in libs}
        calls = {}
        for name, lib in libs.items():
            if lib.rrt_split_set(winner.data_ptr(), vis.data_ptr()) != 0:
                raise RuntimeError(f"rrt_split_set failed for {name}")

            def call(lib=lib, out=outs[name]):
                rows = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom)
                tail = (scratch.data_ptr(), out.data_ptr(), stream)
                if step:
                    err = lib.rrt_vec_step(*rows, target.data_ptr(), 1.0 / (H * W * 3), *tail)
                else:
                    err = lib.rrt_vec_render_bwd(*rows, g_img.data_ptr(), vis.data_ptr(), *tail)
                if err != 0:
                    raise RuntimeError(f"{kernel.name} failed: CUDA error {err}")
            calls[name] = call
            call()
        torch.cuda.synchronize()
        if step:  # the full build's loss is the shipped kernel's
            shipped = fused_vec.loss_grad_vec(start, cfg, target)[0]
            same_as_shipped = bool(torch.equal(
                shipped, fused_vec.fused._loss_norm(cfg, "mse") * outs["full"][0]))
        else:  # the full build's gradient row is the shipped kernel's
            shipped = torch.empty_like(outs["full"])
            kernel.call("rrt_vec_render_bwd", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(),
                        *geom, g_img.data_ptr(), vis.data_ptr(), scratch.data_ptr(),
                        shipped.data_ptr(), stream)
            torch.cuda.synchronize()
            same_as_shipped = bool(torch.equal(shipped, outs["full"]))
        diff = {name: float((outs[name] - outs["full"]).abs().max()) for name in libs}
        times = {name: [] for name in libs}
        for _ in range(args.reps):
            for name, call in calls.items():
                times[name].append(time_ms(call))
        full = statistics.mean(times["full"])
        print(json.dumps({"split": label, "ms": times,
                          "part_ms": {name: full - statistics.mean(t)
                                      for name, t in times.items() if name != "full"},
                          "max_diff_from_full": diff, "full_is_shipped": same_as_shipped}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
