#!/usr/bin/env python3
"""Rows 1-6 (the small-scene step, forward and render backward, and the
vec forward, render backward and step: the kernels built from
csrc/render_common.cuh's pixel_step, csrc/fused_render.cu or
csrc/fused_vec_render.cu) of this checkout beside those of another, on one
card, in one process: their instances without texel grids.

    python3 tools/flat_ab.py --tree DIR [--reps 2]

Builds the six sources (csrc/fused_step.cu, fused_render.cu,
fused_render_bwd.cu, fused_vec_render.cu, fused_vec_render_bwd.cu,
fused_vec_step.cu) of this checkout and of the checkout ``DIR`` (a ``git
archive`` of an older commit, say) with this checkout's nvcc flags, all
twelve at once, and loads each with ctypes. For each source it compares the
two trees' machine code (``cuobjdump -sass``) kernel by kernel, each
instance that both trees have (the others are counted). Then it calls each
row's entry on the
same inputs, through the entries both trees have: rows 1-3 at config 2
512^2 from perturb(scale=0.1, seed=4) against the plain render of the true
scene, and with their bounce level (rows 1r-3r, the refl entries) at config
6 512^2 from perturb(scale=0.3, seed=3), their textured instances (the
``_tex`` entries, spp 1) at config 7 512^2 (rows 1t-3t, a textured floor)
and config 9 512^2 (rows 1s-3s, the sky and its bounce) from
perturb(scale=0.4, seed=0), rows 4-6 at config 5 1024^2 from
perturb(scale=0.05, seed=4), and with the env and the bounce (rows 4r-6r,
the ``_levels`` entries) at config 10 512^2 from perturb(scale=0.2,
seed=10), their textured instances (the ``_tex`` entries, spp 1) on the 64
textured globes at 512^2 without and with a bounce (rows 4g-6g, 4h-6h) from
perturb(scale=0.4, seed=0), and a seeded normal cotangent for the backwards
(with the forward's planes). A row whose entry the other tree lacks is timed in this
tree alone. Each row's outputs must be bit for bit the other tree's, and
each row's device time per call (`kernel_timing.device_ms`, median of 20
after 3 warm-ups) is taken in turns, other, this, this, other, for
``--reps`` rounds. Prints one JSON line per source (its SASS comparison;
for a kernel that differs, the lines a line diff changes and the first)
and per row (the rounds' times, each tree's mean and this / other), then
the card's nvidia-smi line; exits 1 if an output differs.
"""

from __future__ import annotations

import argparse
import difflib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

SOURCES = ("fused_step", "fused_render", "fused_render_bwd", "fused_vec_render",
           "fused_vec_render_bwd", "fused_vec_step")


def build(_build, csrc: Path, out: Path):
    """Start nvcc on the sources of ``csrc`` into ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    return {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
         str(csrc / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in SOURCES}


def load(procs, out: Path, csrc: Path, kernels):
    """The built libraries, their entries typed by this tree's signatures
    (those the library has)."""
    import ctypes

    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, (argtypes, restype) in kernels[name].signatures.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def unnamed(name: str) -> str:
    """A mangled name with the anonymous namespace's file-specific id (the
    length-prefixed ``_GLOBAL__N_...`` after ``_ZN``) replaced by one token,
    so that a kernel keeps its name when its file's text changes."""
    found = re.match(r"_ZN(\d+)", name)
    if found and name[found.end():].startswith("_GLOBAL__N_"):
        return "_ZN_anon_" + name[found.end() + int(found.group(1)):]
    return name


def sass(cuobjdump: str, lib: Path) -> dict:
    """{kernel name: [instructions]} of a library, addresses and encodings
    stripped."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    out, name = {}, None
    for line in text.splitlines():
        found = re.match(r"\s*Function : (\S+)", line)
        if found:
            name = unnamed(found.group(1))
            out[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name is not None and ins:
            out[name].append(ins.group(1))
    return out


def sass_changes(this: list, other: list) -> str:
    """How two kernels' instructions differ: the lines a line diff changes on
    each side, and the first change."""
    ops = [op for op in difflib.SequenceMatcher(a=other, b=this, autojunk=False).get_opcodes()
           if op[0] != "equal"]
    n_other = sum(i2 - i1 for _, i1, i2, _, _ in ops)
    n_this = sum(j2 - j1 for _, _, _, j1, j2 in ops)
    _, i1, i2, j1, j2 = ops[0]
    return (f"{n_this} lines here against {n_other} there changed; first at instruction {j1}: "
            f"{this[j1:j2][:2]} against {other[i1:i2][:2]}")


def compare_sass(root: Path):
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    rows = []
    for name in SOURCES:
        this = sass(cuobjdump, root / "this" / f"lib{name}.so")
        other = sass(cuobjdump, root / "other" / f"lib{name}.so")
        kernels = {k: "same" if other[k] == ins else
                   f"differs ({len(ins)} against {len(other[k])} instructions; "
                   f"{sass_changes(ins, other[k])})"
                   for k, ins in this.items() if k in other}
        rows.append({"source": name, "kernels": kernels,
                     "same": all(v == "same" for v in kernels.values()),
                     "only_here": len(this) - len(kernels),
                     "only_there": len(other) - len(kernels)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, help="the other checkout's root")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("flat_ab: no CUDA device", file=sys.stderr)
        return 2
    from kernel_timing import device_ms

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops.kernels import _build, fused, fused_vec

    kernels = {k.name: k for k in fused.KERNELS + fused_vec.KERNELS}
    other_csrc = Path(args.tree).resolve() / _build.CSRC.relative_to(HERE.parent)
    root = _build.BUILD_DIR / "flat_ab"
    procs = {"other": build(_build, other_csrc, root / "other"),
             "this": build(_build, _build.CSRC, root / "this")}
    libs = {"other": load(procs["other"], root / "other", other_csrc, kernels),
            "this": load(procs["this"], root / "this", _build.CSRC, kernels)}
    compare_sass(root)
    stream = torch.cuda.current_stream().cuda_stream

    def cotangent(H, W):
        return torch.from_numpy(np.random.default_rng(0).normal(size=(H, W, 3)).astype(
            np.float32)).cuda()

    # rows 1-3: config 2 at 512^2
    scene, spec, cfg = configs.config2_four_spheres(size=512, device="cuda")
    start = configs.perturb(scene, spec, scale=0.1, seed=4)
    target = fused.render_fused_plain(scene, cfg)[0].contiguous()
    H, W = cfg.height, cfg.width
    g2 = cotangent(H, W)
    flat = fused._cuda_flat(start, cfg)
    geom = fused._geometry(start, cfg)
    n_scratch = max(lib["fused_step"].rrt_step_scratch_floats(*geom[:5])
                    for lib in libs.values())
    scratch = torch.empty((n_scratch,), device="cuda")
    vis = torch.empty((start.lights.count, H, W), device="cuda")
    libs["this"]["fused_render"].rrt_render_spp(flat.data_ptr(), *geom, 1,
                                                torch.empty((H, W, 3), device="cuda").data_ptr(),
                                                vis.data_ptr(), stream)
    # rows 1r-3r: config 6 at 512^2, one bounce level
    scene6, spec6, cfg6 = configs.config6_mirror(size=512, device="cuda")
    start6 = configs.perturb(scene6, spec6, scale=0.3, seed=3)
    target6 = fused.render_fused_plain(scene6, cfg6)[0].contiguous()
    flat6 = fused._cuda_flat(start6, cfg6)
    geom6 = fused._geometry(start6, cfg6)
    vis6 = torch.empty((2 * start6.lights.count, H, W), device="cuda")
    libs["this"]["fused_render"].rrt_render_refl(
        flat6.data_ptr(), *geom6, 1, 1, torch.empty((H, W, 3), device="cuda").data_ptr(),
        vis6.data_ptr(), stream)
    # rows 1t-3t / 1s-3s: the textured instances at config 7 / config 9 (the sky,
    # one bounce level), 512^2
    tex_flat = {}
    for tag, num in (("t", 7), ("s", 9)):
        sc, sp_, cf = configs.CONFIGS[num](size=512, device="cuda")
        st = configs.perturb(sc, sp_, scale=0.4, seed=0)
        fl, ge = fused._cuda_flat(st, cf), fused._geometry(st, cf)
        tl = (cf.reflections, *fused.texel_sizes(st))
        n_s = max(lib["fused_step"].rrt_step_tex_scratch_floats(*ge[:5], *tl[1:])
                  for lib in libs.values())
        vs = torch.empty((fused.n_vis_planes(st, cf), H, W), device="cuda")
        libs["this"]["fused_render"].rrt_render_tex(
            fl.data_ptr(), *ge, *tl, torch.empty((H, W, 3), device="cuda").data_ptr(),
            vs.data_ptr(), stream)
        tex_flat[tag] = dict(flat=fl, geom=ge, tl=tl, vis=vs,
                             target=fused.render_fused_plain(sc, cf)[0].contiguous(),
                             scratch=torch.empty((n_s,), device="cuda"))
    # rows 4-6: config 5 at 1024^2
    scene5, spec5, cfg5 = configs.config5_many_spheres(size=1024, device="cuda")
    start5 = configs.perturb(scene5, spec5, scale=0.05, seed=4)
    target5 = fused_vec.render_vec_plain(scene5, cfg5)[0].contiguous()
    vis5 = fused_vec.render_vec(start5, cfg5)[1].contiguous()
    g5 = cotangent(cfg5.height, cfg5.width)
    glob, sph, rct = fused_vec.packed_inputs(start5)
    geom5 = fused_vec._geometry(start5, cfg5)
    rows5 = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom5)
    n_out5 = 1 + glob.numel() + sph.numel() + rct.numel()
    n_scratch5 = max(max(lib["fused_vec_step"].rrt_vec_step_scratch_floats(*geom5[2:7]),
                         lib["fused_vec_render_bwd"].rrt_vec_render_bwd_scratch_floats(
                             *geom5[2:7])) for lib in libs.values())
    scratch5 = torch.empty((n_scratch5,), device="cuda")
    # rows 4r-6r: config 10 at 512^2, the env and one bounce level
    scene10, spec10, cfg10 = configs.config10_chrome_field(size=512, device="cuda")
    start10 = configs.perturb(scene10, spec10, scale=0.2, seed=10)
    target10 = fused_vec.render_vec_plain(scene10, cfg10)[0].contiguous()
    vis10 = fused_vec.render_vec(start10, cfg10)[1].contiguous()
    glob10, sph10, rct10 = fused_vec.packed_inputs(start10)
    lv10 = fused_vec.levels(start10, cfg10)
    rows10 = (glob10.data_ptr(), sph10.data_ptr(), rct10.data_ptr(),
              *fused_vec._geometry(start10, cfg10))
    n_out10 = 1 + glob10.numel() + sph10.numel() + rct10.numel()
    scratch10 = torch.empty((libs["this"]["fused_vec_step"].rrt_vec_step_levels_scratch_floats(
        *fused_vec._geometry(start10, cfg10)[2:7], lv10[1]),), device="cuda")
    # rows 4g-6g / 4h-6h: the textured instances on the 64 textured globes at
    # 512^2, without and with a bounce level
    import chip_smoke

    tex_vec = {}
    for tag, refl in (("g", 0), ("h", 1)):
        sc, sp_, cf = chip_smoke.globes_case(512, refl)
        st = configs.perturb(sc, sp_, scale=0.4, seed=0)
        gl, sh, rc_ = fused_vec.packed_inputs(st)
        stex, rtex = fused_vec.texel_inputs(st)
        ge = fused_vec._geometry(st, cf)
        tl = fused_vec.tex_levels(st, cf)
        tex_vec[tag] = dict(
            rows=(gl.data_ptr(), sh.data_ptr(), rc_.data_ptr(), stex.data_ptr(),
                  rtex.data_ptr(), *ge), keep=(gl, sh, rc_, stex, rtex), tl=tl,
            target=fused_vec.render_vec_plain(sc, cf)[0].contiguous(),
            vis=fused_vec.render_vec(st, cf)[1].contiguous(),
            n_out=1 + gl.numel() + sh.numel() + rc_.numel() + fused_vec.texel_row(st),
            scratch=torch.empty((libs["this"]["fused_vec_step"].rrt_vec_step_tex_scratch_floats(
                ge[0], ge[1], *ge[4:7], *tl[1:]),), device="cuda"))
    sizes = {1: 1 + flat.numel(), 2: H * W * 3, 3: 1 + flat.numel(),
             4: cfg5.height * cfg5.width * 3, 5: n_out5, 6: n_out5, "1r": 1 + flat6.numel(), "2r": H * W * 3,
             "3r": 1 + flat6.numel(), "4r": H * W * 3, "5r": n_out10, "6r": n_out10}
    for tag, c in tex_flat.items():
        sizes.update({f"1{tag}": 1 + c["flat"].numel(), f"2{tag}": H * W * 3,
                      f"3{tag}": 1 + c["flat"].numel()})
    for tag, c in tex_vec.items():
        sizes.update({f"4{tag}": H * W * 3, f"5{tag}": c["n_out"], f"6{tag}": c["n_out"]})
    outs = {(t, r): torch.empty((n,), device="cuda") for t in libs for r, n in sizes.items()}
    planes = {(t, r): torch.empty_like(v) for t in libs
              for r, v in ((2, vis), ("2r", vis6), (4, vis5), ("4r", vis10),
                           *((f"2{k}", c["vis"]) for k, c in tex_flat.items()),
                           *((f"4{k}", c["vis"]) for k, c in tex_vec.items()))}
    entries = {4: ("fused_vec_render", "rrt_vec_render_at"),
               "4r": ("fused_vec_render", "rrt_vec_render_levels"),
               "5r": ("fused_vec_render_bwd", "rrt_vec_render_bwd_levels"),
               "6r": ("fused_vec_step", "rrt_vec_step_levels")}

    def call(tree, row):
        lib, out = libs[tree], outs[tree, row].data_ptr()
        tag = row[1:] if isinstance(row, str) else ""
        if tag in tex_flat:
            c = tex_flat[tag]
            head = (c["flat"].data_ptr(), *c["geom"], *c["tl"])
            err = {"1": lambda: lib["fused_step"].rrt_step_tex(
                       *head, c["target"].data_ptr(), 1.0 / (H * W * 3),
                       c["scratch"].data_ptr(), out, stream),
                   "2": lambda: lib["fused_render"].rrt_render_tex(
                       *head, out, planes[tree, row].data_ptr(), stream),
                   "3": lambda: lib["fused_render_bwd"].rrt_render_bwd_tex(
                       *head, g2.data_ptr(), c["vis"].data_ptr(), c["scratch"].data_ptr(), out,
                       stream)}[row[0]]()
        elif tag in tex_vec:
            c = tex_vec[tag]
            err = {"4": lambda: lib["fused_vec_render"].rrt_vec_render_tex(
                       *c["rows"], 0.0, 0.0, *c["tl"], out, planes[tree, row].data_ptr(), stream),
                   "5": lambda: lib["fused_vec_render_bwd"].rrt_vec_render_bwd_tex(
                       *c["rows"], 0.0, 0.0, *c["tl"], g2.data_ptr(), c["vis"].data_ptr(),
                       c["scratch"].data_ptr(), out, stream),
                   "6": lambda: lib["fused_vec_step"].rrt_vec_step_tex(
                       *c["rows"], *c["tl"], c["target"].data_ptr(), 1.0 / (H * W * 3),
                       c["scratch"].data_ptr(), out, stream)}[row[0]]()
        elif row == 1:
            err = lib["fused_step"].rrt_step_spp(flat.data_ptr(), *geom, 1, target.data_ptr(),
                                                 1.0 / (H * W * 3), scratch.data_ptr(), out,
                                                 stream)
        elif row == 2:
            err = lib["fused_render"].rrt_render_spp(flat.data_ptr(), *geom, 1, out,
                                                     planes[tree, 2].data_ptr(), stream)
        elif row == "1r":
            err = lib["fused_step"].rrt_step_refl(flat6.data_ptr(), *geom6, 1, 1,
                                                  target6.data_ptr(), 1.0 / (H * W * 3),
                                                  scratch.data_ptr(), out, stream)
        elif row == "2r":
            err = lib["fused_render"].rrt_render_refl(flat6.data_ptr(), *geom6, 1, 1, out,
                                                      planes[tree, "2r"].data_ptr(), stream)
        elif row == "3r":
            err = lib["fused_render_bwd"].rrt_render_bwd_refl(
                flat6.data_ptr(), *geom6, 1, 1, g2.data_ptr(), vis6.data_ptr(),
                scratch.data_ptr(), out, stream)
        elif row == 3:
            err = lib["fused_render_bwd"].rrt_render_bwd_spp(
                flat.data_ptr(), *geom, 1, g2.data_ptr(), vis.data_ptr(), scratch.data_ptr(),
                out, stream)
        elif row == 4:
            err = lib["fused_vec_render"].rrt_vec_render_at(*rows5, 0.0, 0.0, out,
                                                           planes[tree, 4].data_ptr(), stream)
        elif row == "4r":
            err = lib["fused_vec_render"].rrt_vec_render_levels(
                *rows10, 0.0, 0.0, *lv10, out, planes[tree, "4r"].data_ptr(), stream)
        elif row == "5r":
            err = lib["fused_vec_render_bwd"].rrt_vec_render_bwd_levels(
                *rows10, 0.0, 0.0, *lv10, g2.data_ptr(), vis10.data_ptr(), scratch10.data_ptr(),
                out, stream)
        elif row == "6r":
            err = lib["fused_vec_step"].rrt_vec_step_levels(
                *rows10, 1, *lv10, target10.data_ptr(), 1.0 / (H * W * 3), scratch10.data_ptr(),
                out, stream)
        elif row == 5:
            err = lib["fused_vec_render_bwd"].rrt_vec_render_bwd_at(
                *rows5, 0.0, 0.0, g5.data_ptr(), vis5.data_ptr(), scratch5.data_ptr(), out,
                stream)
        else:
            err = lib["fused_vec_step"].rrt_vec_step_spp(
                *rows5, 1, target5.data_ptr(), 1.0 / (cfg5.height * cfg5.width * 3),
                scratch5.data_ptr(), out, stream)
        if err != 0:
            raise RuntimeError(f"row {row} of {tree} failed: CUDA error {err}")

    planes_rows = {r for _, r in planes}
    same = True
    for row, case in ((1, "config2_512"), (2, "config2_512"), (3, "config2_512"),
                      ("1r", "config6_512"), ("2r", "config6_512"), ("3r", "config6_512"),
                      (4, "config5_1024"), (5, "config5_1024"), (6, "config5_1024"),
                      ("4r", "config10_512"), ("5r", "config10_512"), ("6r", "config10_512"),
                      ("1t", "config7_512"), ("2t", "config7_512"), ("3t", "config7_512"),
                      ("1s", "config9_512"), ("2s", "config9_512"), ("3s", "config9_512"),
                      ("4g", "globes_512"), ("5g", "globes_512"), ("6g", "globes_512"),
                      ("4h", "globes_r1_512"), ("5h", "globes_r1_512"),
                      ("6h", "globes_r1_512")):
        src, fn = entries.get(row, (None, None))
        trees = [t for t in libs if src is None or hasattr(libs[t][src], fn)]
        for tree in trees:
            call(tree, row)
        torch.cuda.synchronize()
        times = {t: [] for t in trees}
        for _ in range(args.reps):
            for tree in ("other", "this", "this", "other"):
                if tree in times:
                    times[tree].append(device_ms(lambda tree=tree: call(tree, row))["ms"])
        mean = {t: sum(v) / len(v) for t, v in times.items()}
        line = {"row": row, "case": case, "device_ms": times, "mean_ms": mean}
        if "other" in trees:
            bit_equal = bool(torch.equal(outs["other", row], outs["this", row]))
            if row in planes_rows:
                bit_equal = bit_equal and bool(torch.equal(planes["other", row],
                                                           planes["this", row]))
            same = same and bit_equal
            line.update(bit_equal=bit_equal, this_over_other=mean["this"] / mean["other"])
        else:
            line["other"] = "the other tree lacks the entry"
        print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
