#!/usr/bin/env python3
"""Where the time of the small-scene kernels goes: variant builds of their
CUDA sources with one part cut each, timed on the card beside the unchanged
build. By default the step (row 1, csrc/fused_step.cu, body
csrc/flat_step.cuh).

    python3 tools/flat_step_split.py [--tree DIR] [--reps 2] [--kernel step|bwd|fwd]

The method of tools/vec_step_split.py, whose variant builds this script
reuses: ``--tree`` names a checkout whose kernels are split (its port
package imported, its ``csrc`` copied); each variant is built with the
port's nvcc flags and called through ``rrt_step`` on config 2 and config 3
(two lights) at 512^2, from perturb(scale=0.1, seed=4) against the plain
render of the true scene. ``--kernel bwd`` splits the render backward (row
3, csrc/fused_render_bwd.cu, the same body) through ``rrt_render_bwd`` with
a seeded normal cotangent and the forward kernel's planes; it casts no
shadow rays, so it has no shadow_lit cut. The builds are timed in turns,
every variant once per round, for ``--reps`` rounds: the event time
(tools/kernel_timing.py `time_ms`, which includes the host's time to
launch the kernels) and the kernels' device time per call (`device_ms`, the
profiler's CUDA activity).

The cuts (two sets: the step of three launches, a block per 32 x 8 tile,
and the step of one cooperative launch, told apart by flat_step.cuh):
  - no_puts: the warp shuffle sums into the warp rows cut to a compare that
    keeps each value live;
  - no_reduce: the sum of the partial rows cut (three launches: its launch;
    one launch: the grid sync and block 0's sum);
  - no_sum (one launch only): block 0's sum cut, the grid sync kept;
  - no_finalize: the camera chain and the copy out cut (three launches: the
    finalize launch);
  - no_adjoint: the per-pixel adjoint cut (the forward and the squared
    error stay);
  - shadow_lit: the shadow rays' any-hit walk cut to a read of the forward
    kernel's visibility plane (the same bits, so the same later work).
``--kernel fwd`` splits the forward (row 2, csrc/fused_render.cu) through
``rrt_render`` at 512^2: config 2, config 3, and config5_many_spheres with
23 spheres and its ground (24 objects, the most the unrolled kernels take),
each from perturb(seed=4) (scale 0.1, 0.05 for config 5). Its cuts, in
both sets:
  - primary_winner: the primary walk cut to a read of the winner from a
    plane the script computes (`nearest_vec`), its t recomputed;
  - shadow_plane: the shadow walks cut to a read of the shipped forward's
    visibility planes (the same bits on hit pixels);
  - no_phong: the Phong terms of each light cut to the visibility alone;
  - no_writes: the image's and planes' stores cut to one that never runs.
Before the redesign (each thread calling render_pixel, told apart by
whether fused_render.cu calls it) also:
  - camera_once: the camera basis and tan(fov/2) computed once a block by
    one thread into shared memory, not per pixel;
  - skip_miss: no shading and no shadow walk where the primary ray missed.
After it also the cut floor (every ray misses: what is left is the launch,
the block's staging and camera, the rays and the stores), and min_blocks_N,
a build with the launch bound of N blocks an SM for the shipped 4.
``--textured`` splits the textured instances of the step or backward
instead (flat_step_tex_kernel, through ``rrt_step_tex`` /
``rrt_render_bwd_tex``) at configs 7, 8 and 9, 512^2, from perturb(scale=0.4,
seed=0) of their texels, with one cut more:
  - no_texels: the texel records' scatter into the warp rows cut (their
    adjoint stays).
A part's time is the unchanged build's less the variant's. Prints one JSON
line per shape, then the card's nvidia-smi line; stops on a build failure.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

from kernel_timing import device_ms, time_ms
from vec_step_split import (CLIP_GRAD, CUT_ADJOINT, FWD_PARENT, HERE, LIT_CULLED,
                            LIT_CULLED_PLANE, NS_END, SPLIT_NEAREST, build_variants)

PUT = "  v = warp_sum(v);\n  if (lane == 0) row[slot] = v;\n"
KEEP = "  if (v == 1.5e-45f) row[slot] = v;  // keeps v live, no shuffles\n"
SHADOW_LIT = [("render_common.cuh", LIT_CULLED, LIT_CULLED_PLANE)]
NO_ADJOINT = [("render_common.cuh", CLIP_GRAD, CLIP_GRAD + CUT_ADJOINT)]
NO_TEXELS = [("flat_step.cuh", "          if constexpr (Textured<SC>::value) "
                               "scatter_texels(g.tex, gs, trec, lane);\n", "")]

# Three launches: the step kernel over one block per tile, reduce_rows_kernel,
# flat_finalize_kernel.
CUTS_PARENT = {
    "full": [],
    "no_puts": [("render_common.cuh", PUT, KEEP)],
    "no_reduce": [("flat_step.cuh", "  reduce_rows_kernel<8><<<(ROW + 31) / 32, dim3(32, 8), 0, "
                                    "st>>>(partials, nrows, ROW, rowsum);\n", "")],
    "no_finalize": [("flat_step.cuh",
                     "  flat_finalize_kernel<<<1, 256, 0, st>>>(rowsum, flat, ly, out);\n", "")],
    "no_adjoint": NO_ADJOINT,
    "shadow_lit": SHADOW_LIT,
}

# One cooperative launch: lane sums across tiles, a transposing shuffle tree
# per hit object a tile, one partial row a block, block 0's sum after a grid
# sync.
ADD = "  v = warp_sum(v);\n  if (lane == 0) row[slot] += v;\n"
KEEP_ADD = "  if (v == 1.5e-45f) row[slot] += v;  // keeps v live, no shuffles\n"
CUTS = {
    "full": [],
    "no_puts": [("render_common.cuh", ADD, KEEP_ADD),
                ("flat_step.cuh", "    v[i] = keep + __shfl_xor_sync(FULL, send, H);",
                 "    v[i] = keep + send;"),
                ("flat_step.cuh",
                 "  for (int o = V; o < 32; o *= 2) s += __shfl_xor_sync(FULL, s, o);", "")],
    "no_reduce": [("flat_step.cuh", "  cooperative_groups::this_grid().sync();\n", ""),
                  ("flat_step.cuh", "const int cols = fp.ROWP / 4, nb = gridDim.x;",
                   "const int cols = fp.ROWP / 4, nb = 0;")],
    "no_sum": [("flat_step.cuh", "const int cols = fp.ROWP / 4, nb = gridDim.x;",
                "const int cols = fp.ROWP / 4, nb = 0;")],
    "no_finalize": [("flat_step.cuh", "    if (s < 1 + ly.S) out[s] = acc;\n", ""),
                    ("flat_step.cuh", "  if (tid == 0)\n    camera_chain(",
                     "  if (tid < 0)\n    camera_chain(")],
    "no_adjoint": NO_ADJOINT,
    "shadow_lit": SHADOW_LIT,
}


# The forward (row 2) before its redesign: one thread a pixel, each calling
# render_pixel (render_common.cuh), which row 4's parent also called: its
# primary_winner, shadow_plane and no_phong cuts are row 4's.
FWD_STORES_PARENT = """  img[3 * px + 0] = col.x;
  img[3 * px + 1] = col.y;
  img[3 * px + 2] = col.z;
  if (p.shadows) {
    const long long plane = (long long)p.H * p.W;
    for (int l = 0; l < ly.L; ++l) vis[l * plane + px] = ((bits >> l) & 1u) ? 1.0f : 0.0f;
  }
"""
FWD_RENDER_PIXEL = {
    "full": [],
    "camera_once": [
        ("render_common.cuh", "struct Camera {\n  V3 eye, right, up, fwd;\n  float tan_half;\n};\n",
         "struct Camera {\n  V3 eye, right, up, fwd;\n  float tan_half;\n};\n\n"
         "__shared__ Camera split_cam;\n"),
        ("render_common.cuh",
         "  const Camera cam = camera(sc);\n  const Ray r = primary_ray(cam, p, i, j);",
         "  const Camera cam = split_cam;\n  const Ray r = primary_ray(cam, p, i, j);"),
        ("fused_render.cu", "  stage(sc, flat, ly.S);\n  __syncthreads();\n",
         "  stage(sc, flat, ly.S);\n  __syncthreads();\n"
         "  if (threadIdx.x == 0 && threadIdx.y == 0) split_cam = camera(FlatScene{sc, ly});\n"
         "  __syncthreads();\n")],
    "primary_winner": FWD_PARENT["primary_winner"],
    "shadow_plane": FWD_PARENT["shadow_plane"],
    "no_phong": FWD_PARENT["no_phong"],
    "skip_miss": [("render_common.cuh", "  V3 col = shade_hit(\n      sc, cam.eye, r.d, h.t, s,",
                   "  V3 col = sc.background();\n  *bits = 0u;\n  if (h.k >= 0)\n"
                   "    col = shade_hit(\n      sc, cam.eye, r.d, h.t, s,")],
    "no_writes": [("fused_render.cu", FWD_STORES_PARENT,
                   "  if (col.x + col.y + col.z == -7.0f + (float)bits) img[px] = 0.0f;\n")],
}

# The forward after its redesign: the camera once a block, no shading where
# the primary ray missed, the launch bound of FWD_MIN_BLOCKS blocks an SM.
# Besides its cuts, the bounds it was chosen among, each a build of its own.
FWD_TRACE = "  const Nearest h = trace(sc, cam.eye, d);\n"
FWD_LIT = """          [&](int, V3 so, const LightGeo& g) {
            return !p.shadows || !occluded(sc, so, g.ldir, g.dist);  // all lit without shadows"""
FWD_STORES = """  img[3 * px + 0] = acc.x;
  img[3 * px + 1] = acc.y;
  img[3 * px + 2] = acc.z;
"""
FWD_PLANES = """    if (p.shadows)
      for (int l = 0; l < ly.L; ++l)
        vis[(q * per_sub + l) * plane + px] = ((bits >> l) & 1u) ? 1.0f : 0.0f;
"""
FWD_REDESIGN = {
    "full": [],
    "primary_winner": [
        ("render_common.cuh", NS_END, SPLIT_NEAREST),
        ("fused_render.cu", FWD_TRACE,
         "  const Nearest h = split_nearest(sc, cam.eye, d, (long long)i * p.W + j);\n")],
    "floor": [("fused_render.cu", FWD_TRACE, "  const Nearest h = {BIG, -1};\n")],
    "shadow_plane": [("fused_render.cu", FWD_LIT, """          [&](int l, V3, const LightGeo&) {
            return !p.shadows || split_vis[((long long)l * p.H + i) * p.W + j] != 0.0f;""")],
    "no_phong": FWD_PARENT["no_phong"],
    "no_writes": [("fused_render.cu", FWD_PLANES,
                   "    if (col.x + col.y + col.z == -7.0f + (float)bits) vis[px] = 0.0f;\n"),
                  ("fused_render.cu", FWD_STORES,
                   "  if (acc.x + acc.y + acc.z == -7.0f) img[px] = 0.0f;\n")],
    **{f"min_blocks_{n}": [("fused_render.cu", "constexpr int FWD_MIN_BLOCKS = 4;",
                            f"constexpr int FWD_MIN_BLOCKS = {n};")] for n in (1, 5, 6)},
}


def cut_set(csrc: Path, kernel: str = "step") -> tuple[str, dict]:
    """The cuts of ``kernel`` that fit the tree's sources, and their set's
    name."""
    if kernel == "fwd":
        if "render_pixel(" in (csrc / "fused_render.cu").read_text():
            return "render_pixel", FWD_RENDER_PIXEL
        return "redesign", FWD_REDESIGN
    three = "flat_finalize_kernel<<<" in (csrc / "flat_step.cuh").read_text()
    cuts = CUTS_PARENT if three else CUTS
    if kernel == "bwd":  # it casts no shadow rays
        cuts = {name: subs for name, subs in cuts.items() if name != "shadow_lit"}
    return ("three_launches" if three else "one_launch"), cuts


def _print_smi():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())


def _timed_rounds(calls, reps):
    """Each call's event time and device time, every call once a round."""
    ms = {name: [] for name in calls}
    dev = {name: [] for name in calls}
    launches = {}
    for _ in range(reps):
        for name, call in calls.items():
            ms[name].append(time_ms(call))
            d = device_ms(call)
            dev[name].append(d["ms"])
            launches[name] = d["kernels"]
    full, full_dev = statistics.mean(ms["full"]), statistics.mean(dev["full"])
    return {
        "ms": ms, "device_ms": dev,
        "part_ms": {name: full - statistics.mean(t) for name, t in ms.items() if name != "full"},
        "part_device_ms": {name: full_dev - statistics.mean(t) for name, t in dev.items()
                           if name != "full"},
        "kernels": launches}


FWD_SHAPES = (("config2_512", 2, 0.1), ("config3_512", 3, 0.1), ("24obj_512", 23, 0.05))


def split_forward(tree: Path, reps: int) -> int:
    """The forward's split (``--kernel fwd``)."""
    import torch

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops.kernels import _build, fused
    from reversible_raytracer_tpu_torch.ops.pipeline_vec import nearest_vec

    which, cuts = cut_set(_build.CSRC, "fwd")
    libs, ptxas = build_variants(_build, cuts, fused.FUSED_RENDER, "render_kernel")
    print(json.dumps({"split": "build", "kernel": "fused_render", "cuts": which,
                      "tree": str(tree), "ptxas": ptxas}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for label, num, scale in FWD_SHAPES:
        if num in configs.CONFIGS:
            scene, spec, cfg = configs.CONFIGS[num](size=512, device="cuda")
        else:
            scene, spec, cfg = configs.config5_many_spheres(size=512, n_spheres=num,
                                                            device="cuda")
        start = configs.perturb(scene, spec, scale=scale, seed=4)
        flat = fused._cuda_flat(start, cfg)
        geom = fused._geometry(start, cfg)
        H, W = cfg.height, cfg.width
        o, d = pl.primary_rays(start, cfg)
        winner = nearest_vec(start, o, d)[1].to(torch.int32).contiguous()
        shipped_img, vis = fused.render_fused(start, cfg)
        vis = vis.contiguous()
        outs = {name: torch.empty((H, W, 3), device="cuda") for name in libs}
        planes = {name: torch.empty_like(vis) for name in libs}
        calls = {}
        for name, lib in libs.items():
            if lib.rrt_split_set(winner.data_ptr(), vis.data_ptr()) != 0:
                raise RuntimeError(f"rrt_split_set failed for {name}")

            def call(lib=lib, out=outs[name], vo=planes[name]):
                err = lib.rrt_render(flat.data_ptr(), *geom, out.data_ptr(), vo.data_ptr(),
                                     stream)
                if err != 0:
                    raise RuntimeError(f"fused_render ({name}) failed: CUDA error {err}")
            calls[name] = call
            call()
        torch.cuda.synchronize()
        hit = winner >= 0
        line = {"split": label, "objects": start.spheres.count + start.rects.count,
                "lights": start.lights.count, "hit_share": float(hit.float().mean()),
                **_timed_rounds(calls, reps),
                "max_diff_from_full": {name: float((outs[name] - outs["full"]).abs().max())
                                       for name in libs},
                "planes_on_hits_as_full": {name: bool(torch.equal(planes[name][:, hit],
                                                                  planes["full"][:, hit]))
                                           for name in libs},
                "full_is_shipped": bool(torch.equal(shipped_img, outs["full"]))}
        print(json.dumps(line), flush=True)
    _print_smi()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--kernel", choices=("step", "bwd", "fwd"), default="step")
    ap.add_argument("--textured", action="store_true",
                    help="the textured instances at configs 7, 8 and 9 (step or bwd)")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("flat_step_split: no CUDA device", file=sys.stderr)
        return 2
    if args.kernel == "fwd":
        return split_forward(tree, args.reps)
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops import pipeline
    from reversible_raytracer_tpu_torch.ops.kernels import _build, fused

    which, cuts = cut_set(_build.CSRC, args.kernel)
    if args.textured:
        cuts = {**cuts, "no_texels": NO_TEXELS}
    step = args.kernel == "step"
    kernel = fused.FUSED_STEP if step else fused.FUSED_RENDER_BWD
    libs, ptxas = build_variants(_build, cuts, kernel, "flat_step_kernel")
    print(json.dumps({"split": "build", "kernel": kernel.name, "cuts": which, "tree": str(tree),
                      "ptxas": ptxas}), flush=True)

    stream = torch.cuda.current_stream().cuda_stream
    shapes = ((("config7_512", 7), ("config8_512", 8), ("config9_512", 9)) if args.textured
              else (("config2_512", 2), ("config3_512", 3)))
    for label, num in shapes:
        scene, spec, cfg = configs.CONFIGS[num](size=512, device="cuda")
        start = (configs.perturb(scene, spec, scale=0.4, seed=0) if args.textured
                 else configs.perturb(scene, spec, scale=0.1, seed=4))
        target = fused.render_fused_plain(scene, cfg)[0].contiguous()
        flat = fused._cuda_flat(start, cfg)
        geom = fused._geometry(start, cfg)
        H, W = cfg.height, cfg.width
        vis = torch.empty((pipeline.n_vis_planes(start, cfg), H, W), device="cuda")
        img = torch.empty((H, W, 3), device="cuda")
        extra = (cfg.reflections, *fused.texel_sizes(start)) if args.textured else ()
        fused.FUSED_RENDER.call("rrt_render_tex" if args.textured else "rrt_render",
                                flat.data_ptr(), *geom, *extra, img.data_ptr(), vis.data_ptr(),
                                stream)
        g_img = torch.from_numpy(np.random.default_rng(0).normal(size=(H, W, 3)).astype(
            np.float32)).cuda()
        entry = ("rrt_step" if step else "rrt_render_bwd") + ("_tex" if args.textured else "")
        scratch = torch.empty((getattr(libs["full"], f"{entry}_scratch_floats")(
            *geom[:5], *extra[1:]),), device="cuda")
        outs = {name: torch.empty((1 + flat.numel(),), device="cuda") for name in libs}
        calls = {}
        for name, lib in libs.items():
            if lib.rrt_split_set(None, vis.data_ptr()) != 0:
                raise RuntimeError(f"rrt_split_set failed for {name}")

            def call(lib=lib, out=outs[name]):
                src = ((target.data_ptr(), 1.0 / (H * W * 3)) if step
                       else (g_img.data_ptr(), vis.data_ptr()))
                err = getattr(lib, entry)(flat.data_ptr(), *geom, *extra, *src,
                                          scratch.data_ptr(), out.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(f"{kernel.name} ({name}) failed: CUDA error {err}")
            calls[name] = call
            call()
        torch.cuda.synchronize()
        shipped = torch.empty_like(outs["full"])  # the full build's row is the shipped kernel's
        kernel.call(entry, flat.data_ptr(), *geom, *extra,
                    *((target.data_ptr(), 1.0 / (H * W * 3)) if step
                      else (g_img.data_ptr(), vis.data_ptr())),
                    scratch.data_ptr(), shipped.data_ptr(), stream)
        torch.cuda.synchronize()
        diff = {name: float((outs[name] - outs["full"]).abs().max()) for name in libs}
        print(json.dumps({
            "split": label, **_timed_rounds(calls, args.reps), "max_diff_from_full": diff,
            "full_is_shipped": bool(torch.equal(shipped, outs["full"]))}), flush=True)
    _print_smi()
    return 0


if __name__ == "__main__":
    sys.exit(main())
