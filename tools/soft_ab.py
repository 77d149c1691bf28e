#!/usr/bin/env python3
"""Rows 7, 8 and 9 (the soft forward, render backward and step) of this
checkout beside those of another, on one card, in one process.

    python3 tools/soft_ab.py --tree DIR [--reps 2]

Builds the three soft sources (csrc/fused_vec_soft_render.cu,
fused_vec_soft_render_bwd.cu, fused_vec_soft_step.cu) of this checkout and
of the checkout ``DIR`` (a ``git archive`` of an older commit, say) with
this checkout's nvcc flags, all six at once, loads each with ctypes, and
calls them on the same inputs: config 5 at 512^2, tau 0.08, the scene from
perturb(scale=0.05, seed=4) against the plain render of the true scene, and
a seeded normal cotangent for row 8. An older tree's entries take no
checker_tau (told by its source's text); this tree's are called with
checker_tau 0, the instance of the hard checker. Each row's outputs must
be bit for bit the other tree's, and each row's device time per call
(`kernel_timing.device_ms`, median of 20 after 3 warm-ups) is taken in
turns, other, this, this, other, for ``--reps`` rounds. Prints one JSON
line per row (the rounds' times, each tree's mean and this / other), then
the card's nvidia-smi line; exits 1 if an output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

SOURCES = ("fused_vec_soft_render", "fused_vec_soft_render_bwd", "fused_vec_soft_step")


def build(_build, csrc: Path, out: Path):
    """Start nvcc on the three soft sources of ``csrc`` into ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    return {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
         str(csrc / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in SOURCES}


def load(procs, out: Path, csrc: Path, kernels):
    """The built libraries, their entries typed by this tree's signatures
    (those the library has: an older tree's lacks the subsample entries),
    less the checker_tau float where ``csrc``'s entries take none."""
    libs = {}
    has_ctau = "float ctau" in (csrc / "fused_vec_soft_render.cu").read_text()
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, (argtypes, restype) in kernels[name].signatures.items():
            if not hasattr(lib, fn):
                continue
            if not has_ctau and fn in ("rrt_soft_render", "rrt_soft_step", "rrt_soft_render_bwd"):
                argtypes = argtypes[:13] + argtypes[14:]  # drop checker_tau after tau
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs, has_ctau


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, help="the other checkout's root")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("soft_ab: no CUDA device", file=sys.stderr)
        return 2
    from kernel_timing import device_ms

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops.kernels import _build, fused_vec, fused_vec_soft

    kernels = {k.name: k for k in fused_vec_soft.KERNELS}
    other_csrc = Path(args.tree).resolve() / _build.CSRC.relative_to(HERE.parent)
    root = _build.BUILD_DIR / "ab"
    procs = {"other": build(_build, other_csrc, root / "other"),
             "this": build(_build, _build.CSRC, root / "this")}
    libs = {"other": load(procs["other"], root / "other", other_csrc, kernels),
            "this": load(procs["this"], root / "this", _build.CSRC, kernels)}

    scene, spec, cfg = configs.config5_many_spheres(size=512, device="cuda")
    cfg = dataclasses.replace(cfg, soft_tau=0.08)
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    target = fused_vec_soft.render_vec_soft_plain(scene, cfg).contiguous()
    H, W = cfg.height, cfg.width
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(H, W, 3)).astype(
        np.float32)).cuda()
    glob, sph, rct = fused_vec.packed_inputs(start)
    geom = fused_vec._geometry(start, cfg)
    rows = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom)
    stream = torch.cuda.current_stream().cuda_stream
    n_out = 1 + glob.numel() + sph.numel() + rct.numel()
    n_scratch = max(lib["fused_vec_soft_step"].rrt_soft_step_scratch_floats(*geom[2:7])
                    for lib, _ in libs.values())
    scratch = torch.empty((n_scratch,), device="cuda")
    outs = {(t, r): torch.empty((H * W * 3 if r == 7 else n_out,), device="cuda")
            for t in libs for r in (7, 8, 9)}

    def call(tree, row):
        lib, has_ctau = libs[tree]
        taus = (0.08, 0.0) if has_ctau else (0.08,)
        out = outs[tree, row].data_ptr()
        if row == 7:
            err = lib["fused_vec_soft_render"].rrt_soft_render(*rows, *taus, out, stream)
        elif row == 8:
            err = lib["fused_vec_soft_render_bwd"].rrt_soft_render_bwd(
                *rows, *taus, g.data_ptr(), scratch.data_ptr(), out, stream)
        else:
            err = lib["fused_vec_soft_step"].rrt_soft_step(
                *rows, *taus, target.data_ptr(), 1.0 / (H * W * 3), scratch.data_ptr(), out,
                stream)
        if err != 0:
            raise RuntimeError(f"row {row} of {tree} failed: CUDA error {err}")

    same = True
    for row in (7, 8, 9):
        for tree in libs:
            call(tree, row)
        torch.cuda.synchronize()
        bit_equal = bool(torch.equal(outs["other", row], outs["this", row]))
        same = same and bit_equal
        times = {"other": [], "this": []}
        for _ in range(args.reps):
            for tree in ("other", "this", "this", "other"):
                times[tree].append(device_ms(lambda tree=tree: call(tree, row))["ms"])
        mean = {t: sum(v) / len(v) for t, v in times.items()}
        print(json.dumps({"row": row, "case": "config5_512_t0.08", "bit_equal": bit_equal,
                          "device_ms": times, "mean_ms": mean,
                          "this_over_other": mean["this"] / mean["other"]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
