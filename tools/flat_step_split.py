#!/usr/bin/env python3
"""Where the time of the small-scene step (row 1, csrc/fused_step.cu, body
csrc/flat_step.cuh) goes: variant builds of its CUDA sources with one part
cut each, timed on the card beside the unchanged build.

    python3 tools/flat_step_split.py [--tree DIR] [--reps 2] [--kernel step|bwd]

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
from vec_step_split import (CLIP_GRAD, CUT_ADJOINT, HERE, LIT_CULLED, LIT_CULLED_PLANE,
                            build_variants)

PUT = "  v = warp_sum(v);\n  if (lane == 0) row[slot] = v;\n"
KEEP = "  if (v == 1.5e-45f) row[slot] = v;  // keeps v live, no shuffles\n"
SHADOW_LIT = [("render_common.cuh", LIT_CULLED, LIT_CULLED_PLANE)]
NO_ADJOINT = [("render_common.cuh", CLIP_GRAD, CLIP_GRAD + CUT_ADJOINT)]

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


def cut_set(csrc: Path) -> tuple[str, dict]:
    """The cuts that fit the tree's flat_step.cuh, and their set's name."""
    three = "flat_finalize_kernel<<<" in (csrc / "flat_step.cuh").read_text()
    return ("three_launches", CUTS_PARENT) if three else ("one_launch", CUTS)


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
        print("flat_step_split: no CUDA device", file=sys.stderr)
        return 2
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops.kernels import _build, fused

    which, cuts = cut_set(_build.CSRC)
    step = args.kernel == "step"
    kernel = fused.FUSED_STEP if step else fused.FUSED_RENDER_BWD
    if not step:
        cuts = {name: subs for name, subs in cuts.items() if name != "shadow_lit"}
    libs, ptxas = build_variants(_build, cuts, kernel, "flat_step_kernel")
    print(json.dumps({"split": "build", "kernel": kernel.name, "cuts": which, "tree": str(tree),
                      "ptxas": ptxas}), flush=True)

    stream = torch.cuda.current_stream().cuda_stream
    for label, num in (("config2_512", 2), ("config3_512", 3)):
        scene, spec, cfg = configs.CONFIGS[num](size=512, device="cuda")
        start = configs.perturb(scene, spec, scale=0.1, seed=4)
        target = fused.render_fused_plain(scene, cfg)[0].contiguous()
        flat = fused._cuda_flat(start, cfg)
        geom = fused._geometry(start, cfg)
        H, W = cfg.height, cfg.width
        vis = torch.empty((start.lights.count, H, W), device="cuda")
        img = torch.empty((H, W, 3), device="cuda")
        fused.FUSED_RENDER.call("rrt_render", flat.data_ptr(), *geom, img.data_ptr(),
                                vis.data_ptr(), stream)
        g_img = torch.from_numpy(np.random.default_rng(0).normal(size=(H, W, 3)).astype(
            np.float32)).cuda()
        entry = "rrt_step" if step else "rrt_render_bwd"
        scratch = torch.empty((getattr(libs["full"], f"{entry}_scratch_floats")(*geom[:5]),),
                              device="cuda")
        outs = {name: torch.empty((1 + flat.numel(),), device="cuda") for name in libs}
        calls = {}
        for name, lib in libs.items():
            if lib.rrt_split_set(None, vis.data_ptr()) != 0:
                raise RuntimeError(f"rrt_split_set failed for {name}")

            def call(lib=lib, out=outs[name]):
                src = ((target.data_ptr(), 1.0 / (H * W * 3)) if step
                       else (g_img.data_ptr(), vis.data_ptr()))
                err = getattr(lib, entry)(flat.data_ptr(), *geom, *src, scratch.data_ptr(),
                                          out.data_ptr(), stream)
                if err != 0:
                    raise RuntimeError(f"{kernel.name} ({name}) failed: CUDA error {err}")
            calls[name] = call
            call()
        torch.cuda.synchronize()
        shipped = torch.empty_like(outs["full"])  # the full build's row is the shipped kernel's
        kernel.call(entry, flat.data_ptr(), *geom,
                    *((target.data_ptr(), 1.0 / (H * W * 3)) if step
                      else (g_img.data_ptr(), vis.data_ptr())),
                    scratch.data_ptr(), shipped.data_ptr(), stream)
        torch.cuda.synchronize()
        diff = {name: float((outs[name] - outs["full"]).abs().max()) for name in libs}
        ms = {name: [] for name in libs}
        dev = {name: [] for name in libs}
        launches = {}
        for _ in range(args.reps):
            for name, call in calls.items():
                ms[name].append(time_ms(call))
                d = device_ms(call)
                dev[name].append(d["ms"])
                launches[name] = d["kernels"]
        full, full_dev = statistics.mean(ms["full"]), statistics.mean(dev["full"])
        print(json.dumps({
            "split": label, "ms": ms, "device_ms": dev,
            "part_ms": {name: full - statistics.mean(t) for name, t in ms.items()
                        if name != "full"},
            "part_device_ms": {name: full_dev - statistics.mean(t) for name, t in dev.items()
                               if name != "full"},
            "kernels": launches, "max_diff_from_full": diff,
            "full_is_shipped": bool(torch.equal(shipped, outs["full"]))}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
