#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero:
  1. device  - the card's name and power limit (nvidia-smi), torch and CUDA.
  2. build   - nvcc builds the nine kernels from reversible_raytracer_tpu_torch/
               ops/kernels/csrc (one process per source, all started
               together), and with them the contracted builds of phase 7.
  3. render  - the forward render kernel against its plain version (eager
               torch on the same card): config 2 at 512^2, config 3 at 512^2
               (two lights, two visibility planes), config 1 at 64^2 (no
               shadows, no planes) and 23 spheres of config 5 with its ground
               at 512^2 (24 objects, the most the kernel takes). The image bit
               for bit, the planes bit for bit on the pixels that hit an
               object and 0 where the ray hits nothing
               (the plain version's planes hold the shadow test of a ray cast
               from the BIG sentinel there, and nothing reads them); and the
               rule of tests/test_render_vs_oracle.py, printed beside (fewer
               than 0.1% of pixel-channels off by more than 2e-3, a mean
               error under 1e-4).
  4. step    - the fused step kernel against autograd and against the eager
               hand-written adjoint, config 2 at 512^2 from
               perturb(scale=0.1, seed=4): loss within 1e-4 relative, every
               gradient leaf within 1e-2 of the leaf's scale; three calls
               bit-identical.
  5. main    - the port's CLI: invert --config 2 --size 512 --iters 50 on the
               card, with the launch counts read around it.
  6. times   - each kernel and its plain version at 512^2 with CUDA events
               (median of 20 after warm-up), beside the kernel's bound; and
               each kernel's device time by launch and its launches per call
               (torch.profiler's CUDA activity over 20 calls: `device`); the
               step kernel must make one launch a call. The forward also at
               config 3 and at 24 objects, 512^2 (`render_shapes`: events and
               device time).
  7. fmad    - both kernels built as the port builds them (--fmad=false)
               and with nvcc's default FMA contraction, timed on the same
               inputs, and the contracted build's distance from the plain
               version (reported, not held).
  8. vec_render - the object-chunked forward kernel against its plain
               version (render_vec_plain) by the same rules as phase 3, on
               config 5 (64 spheres + ground) at 1024^2 and on bench.py's
               513-object shape (512 spheres + ground) at 512^2; the image
               and the planes on hit pixels must be bit-identical
               (`bit_identical`: the per-warp culls keep the full walks'
               bits) and the planes 0 where the ray hits nothing; the culls'
               counters (`cull`, as phase 11 prints them).
  9. vec_step - the object-chunked step kernel against autograd
               (loss_grad_vec_plain) and the eager adjoint at both shapes,
               from perturb(scale=0.05, seed=4): loss within 1e-4 relative,
               every leaf within 1e-2 of its scale; two calls bit-identical;
               and against the vec forward kernel's own image of the same
               scene (the true one, and perturb seeds 0-2) a loss of exactly
               0 and every gradient exactly 0 (the step's culled walks give
               the forward's full walks' bits); the most spheres a block of
               this card takes with config 5's rect and light, in rows 5-6
               and in row 4 (at least 1520 and 3392, what they took before
               the culls, on a card with the H100's 227 KB a block).
 10. vec_main - the port's CLI: invert --config 5 --size 1024 --iters 20 on
               the card, with the launch counts read around it.
 11. vec_times - both vec kernels and their plain versions at the two shapes
               of phase 8 (CUDA events, median of 20 after warm-up), beside
               their bounds (with the per-warp culls, and without them as
               before: `render_bound_uncull`, `step_bound_uncull`) and row
               4's device time by launch (`render_device`); the culls'
               counters: candidate visits per warp walk, and the (pixel,
               sphere) pairs they keep against all pairs, for the primary
               and the shadow rays.
 12. soft_render - the soft forward kernel (soft_tau > 0) against its plain
               version (render_vec_soft_plain) by the rule of phase 3, on
               config 5 at 512^2 and 1024^2 at tau 0.08 and 0.01 and on the
               513-object shape at 512^2 (tau 0.08), with shadows; whether
               the images are bit-identical, and the culls' counters
               (`cull`: the ranking's widened cone, the shadow candidates).
 13. soft_step - the soft step kernel against autograd of the plain version
               and against the eager adjoint at the shapes of phase 12, from
               perturb(scale=0.05, seed=4): loss within 1e-4 relative, every
               leaf within 1e-2 of its scale; two calls bit-identical; and
               against the soft forward kernel's own image of the true scene
               a loss of exactly 0 and every gradient exactly 0 (the step's
               culled forward is the forward kernel's, bit for bit); the
               most spheres a block of this card takes with config 5's rect
               and light in rows 8-9 and in row 7 (at least 3392).
 14. anneal_main - the port's CLI: invert --config 5 --size 1024 --anneal
               0.08,0.03,0.01,0 --anneal-size 512 --lr 2e-3 --perturb 0.03
               --iters 20 on the card, with the launch counts read around it:
               the soft forward 3 times (the stage targets), the soft step
               60, the vec step 20, the vec forward at least twice, rows 1-2
               never; each soft stage's loss falls; the final parameter RMS
               is below the start's.
 15. soft_times - both soft kernels and their plain versions at config 5
               (512^2 and 1024^2, tau 0.08) and at 513 objects (512^2), with
               CUDA events (median of 20 after warm-up), beside their bounds
               (with the culls, and without them as before); row 7's device
               time by launch; the (pixel, sphere, layer, light) shadow pairs
               the cull keeps against all pairs, and the warps' candidate
               visits, for the shadows and for row 7's ranking.
 16. render_grad - the three render backward kernels (rows 3, 5, 8) at config
               2 512^2, config 5 1024^2 and config 5 512^2 tau 0.08, from
               perturb(seed=4): each against its plain version (autograd of
               the eager render) for a seeded normal cotangent, and row 8
               against its eager twin, every leaf within 1e-2 of its scale;
               the mse gradient of a differentiable `render` against the
               matching step kernel's (rows 1, 6, 9), by the same rule, and
               bit-equal for rows 3 and 1 and rows 5 and 6 (one body, one
               grid); three calls bit-identical; an expanded (stride-0)
               cotangent, from
               `render(...).sum().backward()`, bit-identical to its
               contiguous copy.
 17. render_grad_main - 20 steps of optimize(render_fn=render) on each of the
               three shapes (the JAX package's make_step route): the forward
               kernel 21 times (the target and one per step), the backward
               20, the step kernels and every other kernel never; the loss
               falls.
 18. render_grad_times - each backward kernel, its plain version, the forward
               and backward together, and the matching step kernel at the
               three shapes (CUDA events, median of 20 after 3 warm-ups),
               beside the backward's bound (row 5's with the primary cull,
               and without it as before); the backward's device time by
               launch and its launches per call, as in phase 6
               (`bwd_device`; row 3 must make one launch a call).
Then the card's nvidia-smi line, the {"kernels": [...]} line (each kernel
with its status as PERF.md's table of TPU kernels records it; `ms` is the
event time, and rows 1-5, 7 and 8 add `device_ms`, their kernels' device
time per call, and `launches_per_call`; the three forwards add
`launches_render_fn`, their launches in phase 17's run of their family,
beside `launches` on their CLI path), and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

from tools.kernel_timing import device_ms, time_ms

REPO = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12  # H100 SXM, non-tensor float32, at 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def run_phase(name, fn, *args):
    try:
        return fn(*args)
    except BaseException as exc:
        emit(name, ok=False, error=f"{type(exc).__name__}: {exc}")
        raise


# ---------------------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", ok=True, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return smi


def _ptxas(log):
    return [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]


def phase_build():
    """Build the nine kernels as the port builds them, and alongside (all
    eleven nvcc processes at once) the small-scene render and step sources
    with nvcc's default FMA contraction, for phase fmad. Returns the
    contracted libraries."""
    import ctypes
    import time

    from reversible_raytracer_tpu_torch.ops.kernels import fused
    from reversible_raytracer_tpu_torch.ops.kernels._build import (
        BUILD_DIR, NVCC_FLAGS, build_all, nvcc_path)

    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f != "--fmad=false"]
    timed = (fused.FUSED_RENDER, fused.FUSED_STEP)
    procs = {k.name: subprocess.Popen(
        [nvcc_path(), *flags, "-o", str(BUILD_DIR / f"lib{k.name}_fmad.so"), str(k.source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for k in timed}
    try:
        seconds = build_all(_all_kernels())
        logs = {name: proc.communicate()[0] for name, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    contracted = {}
    for k in timed:
        if procs[k.name].returncode != 0:
            raise RuntimeError(f"nvcc (contracted) failed for {k.source.name}:\n{logs[k.name]}")
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{k.name}_fmad.so"))
        for fn, (argtypes, restype) in k.signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        contracted[k.name] = lib
    emit("build", ok=True, seconds=seconds, with_contracted_seconds=time.perf_counter() - t0,
         ptxas={k.name: _ptxas(k.build_log) for k in _all_kernels()},
         ptxas_contracted={name: _ptxas(log) for name, log in logs.items()})
    return contracted


def _all_kernels():
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft

    return fused.KERNELS + fused_vec.KERNELS + fused_vec_soft.KERNELS


def _hit_mask(scene, cfg):
    from reversible_raytracer_tpu_torch.ops import pipeline as pl

    o, d = pl.primary_rays(scene, cfg)
    return pl.trace_nearest(scene, o, d, cfg.shape)[1]


# Row 2's shapes: (label, config number or the spheres of config 5, size,
# visibility planes).
RENDER_CASES = (("config2_512", 2, 512, 1), ("config3_512", 3, 512, 2), ("config1_64", 1, 64, 0),
                ("24obj_512", 23, 512, 1))


def _render_case(num, size):
    from reversible_raytracer_tpu_torch.models import configs

    if num in configs.CONFIGS:
        return configs.CONFIGS[num](size=size, device="cuda")
    return configs.config5_many_spheres(size=size, n_spheres=num, device="cuda")


def phase_render():
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused

    rows = []
    for label, num, size, planes in RENDER_CASES:
        scene, _, cfg = _render_case(num, size)
        img_k, vis_k = fused.render_fused(scene, cfg)
        img_p, vis_p = fused.render_fused_plain(scene, cfg)
        torch.cuda.synchronize()
        if img_k.shape != img_p.shape or vis_k.shape != vis_p.shape or vis_k.shape[0] != planes:
            raise AssertionError(f"{label}: shapes {img_k.shape}/{vis_k.shape} "
                                 f"vs {img_p.shape}/{vis_p.shape}")
        if not torch.isfinite(img_k).all():
            raise AssertionError(f"{label}: non-finite pixels")
        err = (img_k - img_p).abs()
        hit = _hit_mask(scene, cfg)
        row = dict(shape=label, objects=scene.spheres.count + scene.rects.count, size=size,
                   planes=planes, frac_bad=float((err > 2e-3).float().mean()),
                   mean_err=float(err.mean()), max_abs_err=float(err.max()),
                   bit_identical=bool(torch.equal(img_k, img_p)
                                      and torch.equal(vis_k[:, hit], vis_p[:, hit])),
                   vis_on_miss_zero=not bool(vis_k[:, ~hit].any()),
                   hit_share=float(hit.float().mean()))
        rows.append(row)
        if not (row["frac_bad"] < 1e-3 and row["mean_err"] < 1e-4 and row["bit_identical"]
                and row["vis_on_miss_zero"]):
            raise AssertionError(f"forward kernel disagrees with its plain version: {row}")
    emit("render", ok=True, rows=rows)
    return max(r["max_abs_err"] for r in rows if r["shape"] == "config2_512")


def _grad_errors(ga, gb):
    """Worst |a - b| / scale(a) per leaf (the rule of tests/test_fused_step.py)."""
    from reversible_raytracer_tpu_torch.models.scene import leaf_paths, tree_leaves

    out = {}
    for path, a, b in zip(leaf_paths(ga), tree_leaves(ga), tree_leaves(gb)):
        if a.numel():
            scale = max(float(a.abs().max()), 1e-6)
            out[path] = float((a - b).abs().max()) / scale
    return out


def phase_step():
    import torch

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves
    from reversible_raytracer_tpu_torch.ops.kernels import fused

    scene, spec, cfg = configs.config2_four_spheres(size=512, device="cuda")
    start = configs.perturb(scene, spec, scale=0.1, seed=4)
    target = fused.render_fused_plain(scene, cfg)[0]
    runs = [fused.loss_grad_fused(start, cfg, target) for _ in range(3)]
    l_k, g_k = runs[0]
    flat = [torch.cat([l.reshape(1), fused.flatten_scene(g)]) for l, g in runs]
    deterministic = all(torch.equal(flat[0], f) for f in flat[1:])
    l_p, g_p = fused.loss_grad_fused_plain(start, cfg, target)
    l_a, g_a = fused.loss_grad_adjoint_eager(start, cfg, target)
    torch.cuda.synchronize()
    report = {}
    for name, (l_ref, g_ref) in (("autograd", (l_p, g_p)), ("adjoint_eager", (l_a, g_a))):
        rel = abs(float(l_k) - float(l_ref)) / max(abs(float(l_ref)), 1e-12)
        errs = _grad_errors(g_ref, g_k)
        worst = max(errs, key=errs.get)
        report[name] = dict(loss_rel=rel, worst_leaf=worst, worst_err=errs[worst])
        if not (rel <= 1e-4 and errs[worst] <= 1e-2):
            raise AssertionError(f"step kernel disagrees with {name}: {report[name]}")
    if not deterministic:
        raise AssertionError("step kernel: three calls are not bit-identical")
    max_abs = max(float((a - b).abs().max())
                  for a, b in zip(tree_leaves(g_p), tree_leaves(g_k)) if a.numel())
    emit("step", ok=True, loss=float(l_k), deterministic=deterministic, **report)
    return start, target, cfg, max_abs, g_p


def phase_main():
    import torch

    from reversible_raytracer_tpu_torch import cli

    out_dir = REPO / "smoke_out"
    png = out_dir / "final.png"
    for k in _all_kernels():
        k.launches = 0
    summary = cli.main(["invert", "--config", "2", "--size", "512", "--iters", "50",
                        "--perturb", "0.1", "--seed", "0", "--log-every", "10",
                        "--metrics", str(out_dir / "metrics.jsonl"), "-o", str(png)])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in _all_kernels()}
    hist = summary["history"]
    first, last = hist[0]["loss"], hist[-1]["loss"]
    ok = (launches["fused_render"] >= 2 and launches["fused_step"] == 50
          and all(n == 0 for name, n in launches.items() if name not in ("fused_render",
                                                                      "fused_step"))
          and math.isfinite(last) and last < first and png.exists()
          and math.isfinite(summary["param_err"]))
    emit("main", ok=ok, launches=launches, first_loss=first, final_loss=last,
         param_err=summary["param_err"], seconds=summary["seconds"], png_bytes=png.stat().st_size
         if png.exists() else 0)
    if not ok:
        raise AssertionError("main path did not run through both kernels or did not descend")
    return launches


def _launch(lib, fn, *args):
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {err}")


def phase_fmad(contracted, step_inputs, g_plain):
    """Both kernels as built (--fmad=false) and with nvcc's default FMA
    contraction, timed on the same inputs in the order built, contracted,
    contracted, built; and how far the contracted build is from the plain
    version (reported, not held: the port ships the --fmad=false build)."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused

    start, target, cfg = step_inputs
    geom = fused._geometry(start, cfg)
    flat = fused._cuda_flat(start, cfg)
    stream = torch.cuda.current_stream().cuda_stream
    H, W = cfg.height, cfg.width
    img = torch.empty((H, W, 3), device="cuda")
    vis = torch.empty((start.lights.count if cfg.shadows else 0, H, W), device="cuda")
    scratch = torch.empty((fused.FUSED_STEP.lib().rrt_step_scratch_floats(*geom[:5]),),
                          device="cuda")
    out = torch.empty((1 + flat.numel(),), device="cuda")
    w = 1.0 / (H * W * 3)
    libs = {"built": (fused.FUSED_RENDER.lib(), fused.FUSED_STEP.lib()),
            "contracted": (contracted["fused_render"], contracted["fused_step"])}

    def render(which):
        return lambda: _launch(libs[which][0], "rrt_render", flat.data_ptr(), *geom,
                               img.data_ptr(), vis.data_ptr(), stream)

    def step(which):
        return lambda: _launch(libs[which][1], "rrt_step", flat.data_ptr(), *geom,
                               target.data_ptr(), w, scratch.data_ptr(), out.data_ptr(), stream)

    times = {}
    for kname, make in (("fused_render", render), ("fused_step", step)):
        runs = [(which, time_ms(make(which)))
                for which in ("built", "contracted", "contracted", "built")]
        times[kname] = {which: [t for wh, t in runs if wh == which]
                        for which in ("built", "contracted")}
    render("contracted")()
    step("contracted")()
    torch.cuda.synchronize()
    img_p, vis_p = fused.render_fused_plain(start, cfg)
    err = (img - img_p).abs()
    errs = _grad_errors(g_plain, fused.unflatten_scene(start, out[1:]))
    worst = max(errs, key=errs.get)
    emit("fmad", ok=True, size=H, ms=times,
         contracted_render=dict(frac_bad=float((err > 2e-3).float().mean()),
                                mean_err=float(err.mean()), max_abs_err=float(err.max()),
                                vis_diff_all=float((vis != vis_p).float().mean())),
         contracted_step=dict(worst_leaf=worst, worst_err=errs[worst]))


# ---------------------------------------------------------------------------
# Bounds: the operations and bytes that this run's work needs, counted from
# the code (csrc/render_common.cuh, csrc/fused_step.cu). Each add, subtract,
# multiply, divide, sqrt, rsqrt, floor, exp, log and tan counts one;
# comparisons, selects, min/max and negations count none. A value is counted
# once where it is needed once: what depends only on the scene (the camera
# basis, per-object and per-rect constants such as the rect normal and
# 1/|edge|^2, the sphere's |eye - c|^2 - r^2) once per launch, what depends
# only on a pixel's column or row once per column or row, and a pixel's own
# work once per pixel. The kernels recompute some of this per pixel, and the
# step's adjoint recomputes the forward of each lit light and of the winning
# object; the bound counts none of that. Each per-pixel term of the step's
# gradient counts one add into the sum over pixels.
OPS = dict(
    camera=43,  # basis, tan(fov/2), tan(fov/2) * aspect: once per launch
    sphere_const=13,  # eye - c, |eye - c|^2 - r^2, 1/r, 1/r^2, 2r: per sphere
    rect_const=40,  # normal, its unit and rsqrt^3, 1/|eu|^2, 1/|ev|^2, p0 - eye, num
    material_const=15,  # ambient * ka, color * ka, color * ambient (both colors)
    cam_chain=100,  # the step's camera_basis / normalize / tan chain, once
    line=7,  # per column (ax, sx, right sx) and per row (ay, sy, up sy)
    ray=15,  # fwd + right sx + up sy, its norm, rsqrt, d
    sphere_primary=9,  # b = (eye - c) . d, b^2 - c0, sqrt, -b - sqrt
    rect_primary=27,  # d . n, num / denom, o + d t - p0, a, b
    sphere_shadow=18,  # the same tests from the shadow origin
    rect_shadow=35,
    surf_sphere=25,  # hit point, p - c, n, checker parity
    surf_rect=18,  # facing, n, checker parity (a, b and p from the trace)
    miss_point=6,  # o + d BIG on a miss (its shadow rays fill the vis planes)
    so=6,  # shadow origin
    light=13,  # light_geometry of one light
    phong=34,  # diffuse + specular terms of one lit light
    resid=14,  # residual, squared error, 2 w residual, clip gradient
    adj_base=28,  # ambient adjoint, shadow-origin adjoint
    adj_camera=36,  # normalize adjoint of the ray, g_tan, g_dt sx, g_dt sy
    adj_light=98,  # one lit light's adjoint (forward values reused)
    adj_sphere=53, adj_rect=61,  # the winning object's adjoint
    sum_pixel=1, sum_miss=3, sum_hit=16,  # adds into the sums: sq; bg; ambient, eye, camera 10
    sum_sphere=14, sum_rect=19, sum_light=6,  # object fields; light position and color
)


def work_counts(scene, cfg, cull=False):
    """Pixels by winner type, lit (pixel, light) pairs, and the shadow-ray
    sphere and rect tests the kernels run (the any-hit loop tests spheres,
    then rects, and stops at the first occluder), on hit pixels and on all
    pixels. With ``cull``, also the per-warp culls' work (csrc/cull.cuh, by
    the plain versions in ops/kernels/cull.py; a warp is 32 pixels of a row):
    the warps and their primary candidates, the (pixel, candidate) pairs
    the primary rays test; per light the warps with a hit lane, their shadow
    candidates, the (hit pixel, candidate) pairs inside them, and the
    sphere tests of the hit pixels' any-hit walks over the candidates until
    the first occluder."""
    import torch

    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops.kernels import cull as cl
    from reversible_raytracer_tpu_torch.ops.pipeline_vec import sphere_ts

    H, W = cfg.height, cfg.width
    dev = scene.device
    sp, rc = scene.spheres, scene.rects
    o, d = pl.primary_rays(scene, cfg)
    t_best = torch.full((H, W), pl.BIG, device=dev)
    kind = torch.zeros((H, W), dtype=torch.int32, device=dev)  # 0 miss, 1 sphere, 2 rect
    tests = [(1, lambda oo, dd, k=k: pl.intersect_sphere(oo, dd, sp.center[k], sp.radius[k]))
             for k in range(sp.count)]
    tests += [(2, lambda oo, dd, k=k: pl.intersect_rect(oo, dd, rc.origin[k], rc.edge_u[k],
                                                        rc.edge_v[k])[0])
              for k in range(rc.count)]
    for kk, test in tests:
        t = test(o, d)
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        kind = torch.where(closer, kk, kind)
    hit = kind > 0
    _, _, at = pl.trace_nearest(scene, o, d, (H, W))
    so = pl.shadow_origin(o, d, t_best, (at["nx"], at["ny"], at["nz"]))
    shadow = {(kk, where): 0 for kk in (1, 2) for where in ("hit", "all")}
    lit = 0
    for li in range(scene.lights.count):
        ldir, dist = pl.light_geometry(scene.lights, li, so)
        done = torch.zeros((H, W), dtype=torch.bool, device=dev)
        for kk, test in tests:
            if cfg.shadows:
                shadow[kk, "hit"] += int((hit & ~done).sum())
                shadow[kk, "all"] += int((~done).sum())
            done = done | (test(so, ldir) < dist)
        lit += int((hit & ~done).sum()) if cfg.shadows else int(hit.sum())
    out = dict(height=H, width=W, pixels=H * W, sph=int((kind == 1).sum()),
               rect=int((kind == 2).sum()), hit=int(hit.sum()), lit=lit,
               shadow_sph_hit=shadow[1, "hit"], shadow_rect_hit=shadow[2, "hit"],
               shadow_sph_all=shadow[1, "all"], shadow_rect_all=shadow[2, "all"],
               n_sph=sp.count, n_rect=rc.count, lights=scene.lights.count)
    if not cull:
        return out
    with torch.no_grad():
        lanes = cl.runs(torch.ones((H, W), dtype=torch.bool, device=dev), False).sum(-1)
        n_p = cl.primary_candidates(sp, scene.camera.eye, d).sum(-1)  # (H, R)
        out.update(warps=lanes.numel(), prim_visits=int(n_p.sum()),
                   prim_pairs=int((n_p * lanes).sum()), prim_all=H * W * sp.count,
                   shadow_warps=0, shadow_visits=0, shadow_pairs=0, shadow_all=0,
                   shadow_sph_culled=0)
        if not cfg.shadows:
            return out
        hit_lanes = cl.runs(hit, False).sum(-1)
        for li in range(scene.lights.count):
            ldir, dist = pl.light_geometry(scene.lights, li, so)
            cand = cl.warp_candidates(sp, so, hit, scene.lights.position[li], 0.0)
            n_s = cand.sum(-1)
            keep = cl.per_pixel(cand, W)
            occ = (sphere_ts(sp, so, ldir) < dist[None]) & keep
            visited = torch.cumsum(keep, 0, dtype=torch.int16)
            first = occ.to(torch.uint8).argmax(0)
            tests_px = torch.where(occ.any(0), visited.gather(0, first[None])[0],
                                   visited[-1])
            out["shadow_warps"] += int((hit_lanes > 0).sum())
            out["shadow_visits"] += int(n_s.sum())
            out["shadow_pairs"] += int((n_s * hit_lanes).sum())
            out["shadow_all"] += int(hit.sum()) * sp.count
            out["shadow_sph_culled"] += int(tests_px[hit].sum())
            del occ, visited, keep
    return out


def _common_ops(c):
    """Per launch, per column and row, and the primary ray and its trace."""
    n_obj = c["n_sph"] + c["n_rect"]
    launch = (OPS["camera"] + c["n_sph"] * OPS["sphere_const"] + c["n_rect"] * OPS["rect_const"]
              + n_obj * OPS["material_const"])
    lines = (c["height"] + c["width"]) * OPS["line"]
    trace = c["n_sph"] * OPS["sphere_primary"] + c["n_rect"] * OPS["rect_primary"]
    return launch + lines + c["pixels"] * (OPS["ray"] + trace)


def render_ops(c, cull=False, misses=True):
    """A hard forward's operations: every object's primary test per pixel
    and, as rows 2 and 4 shaded before their redesigns, the shadow rays of
    every pixel (a miss's from the BIG sentinel); ``misses=False``: as row 2
    shades since its redesign, no shading and no shadow rays where the ray
    hits nothing; ``cull``: row 4's per-warp culls (`_cull_ops` over the
    counts of `work_counts(..., cull=True)`) and no shadow rays on a miss."""
    miss = c["pixels"] - c["hit"]
    shade = c["sph"] * OPS["surf_sphere"] + c["rect"] * OPS["surf_rect"] + c["lit"] * OPS["phong"]
    hit_shadows = c["hit"] * (OPS["so"] + c["lights"] * OPS["light"]) + shade
    if cull:
        culled, _ = _cull_ops(c)
        return (_common_ops(c) - c["pixels"] * c["n_sph"] * OPS["sphere_primary"] + culled
                + hit_shadows + c["shadow_rect_hit"] * OPS["rect_shadow"])
    if not misses:
        return (_common_ops(c) + hit_shadows + c["shadow_sph_hit"] * OPS["sphere_shadow"]
                + c["shadow_rect_hit"] * OPS["rect_shadow"])
    return (_common_ops(c) + c["pixels"] * (OPS["so"] + c["lights"] * OPS["light"])
            + miss * OPS["miss_point"] + shade
            + c["shadow_sph_all"] * OPS["sphere_shadow"]
            + c["shadow_rect_all"] * OPS["rect_shadow"])


# The per-warp culls of rows 4-6 (csrc/cull.cuh), counted as the rest of
# OPS at what the cheapest known algorithm spends: per sphere once, its
# offset from the eye, distance, widened radius r' and sqrt(D^2 - r'^2); per
# warp the cone (the axis from its lanes' directions, its cosine and sine);
# per (warp, sphere) the cone test (a . (c - eye) against cos theta
# sqrt(D^2 - r'^2) - sin theta r'); per (warp, sphere, light) with a hit
# lane the segment test (SOFT_OPS' warp_test); then per (pixel, candidate)
# the primary sphere test, and per hit pixel the shadow sphere tests over
# the candidates until the first occluder.
CULL_OPS = dict(cone_sphere=12, cone_warp=30, cone_test=8)


def _cull_ops(c, shadows=True):
    """The culled walks' operations, and the full walks' they replace."""
    culled = (c["n_sph"] * CULL_OPS["cone_sphere"]
              + c["warps"] * (CULL_OPS["cone_warp"] + c["n_sph"] * CULL_OPS["cone_test"])
              + c["prim_pairs"] * OPS["sphere_primary"])
    full = c["pixels"] * c["n_sph"] * OPS["sphere_primary"]
    if shadows:
        culled += (c["shadow_warps"] * c["n_sph"] * SOFT_OPS["warp_test"]
                   + c["shadow_sph_culled"] * OPS["sphere_shadow"])
        full += c["shadow_sph_hit"] * OPS["sphere_shadow"]
    return culled, full


def step_ops(c, cull=False):
    """The step's operations; ``cull`` counts rows 5-6's per-warp culls in
    place of the full walks (the counts of `work_counts(..., cull=True)`)."""
    culled, full = _cull_ops(c) if cull else (0, 0)
    miss = c["pixels"] - c["hit"]
    per_hit = (OPS["so"] + c["lights"] * OPS["light"] + OPS["adj_base"] + OPS["adj_camera"]
               + OPS["sum_hit"])
    return (_common_ops(c) + OPS["cam_chain"] + culled - full
            + c["pixels"] * (OPS["resid"] + OPS["sum_pixel"]) + miss * OPS["sum_miss"]
            + c["hit"] * per_hit
            + c["sph"] * (OPS["surf_sphere"] + OPS["adj_sphere"] + OPS["sum_sphere"])
            + c["rect"] * (OPS["surf_rect"] + OPS["adj_rect"] + OPS["sum_rect"])
            + c["lit"] * (OPS["phong"] + OPS["adj_light"] + OPS["sum_light"])
            + c["shadow_sph_hit"] * OPS["sphere_shadow"]
            + c["shadow_rect_hit"] * OPS["rect_shadow"])


def bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _render_shape_times(num, size):
    """Row 2 at another shape: its event and device time, and its bound."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused

    scene, _, cfg = _render_case(num, size)
    flat = fused._cuda_flat(scene, cfg)
    geom = fused._geometry(scene, cfg)
    img = torch.empty((size, size, 3), device="cuda")
    vis = torch.empty((scene.lights.count, size, size), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        fused.FUSED_RENDER.call("rrt_render", flat.data_ptr(), *geom, img.data_ptr(),
                                vis.data_ptr(), stream)

    nbytes = 4 * (flat.numel() + size * size * (3 + vis.shape[0]))
    return dict(ms=time_ms(call), device=device_ms(call),
                bound=bound(render_ops(work_counts(scene, cfg), misses=False), nbytes))


def phase_times(step_inputs, launches, render_err, step_err):
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused

    start, target, cfg = step_inputs
    scene = start
    S = fused.flatten_scene(scene).numel()
    geom = fused._geometry(scene, cfg)
    flat = fused._cuda_flat(scene, cfg)
    stream = torch.cuda.current_stream().cuda_stream
    H, W = cfg.height, cfg.width
    n_vis = scene.lights.count if cfg.shadows else 0
    img = torch.empty((H, W, 3), device="cuda")
    vis = torch.empty((n_vis, H, W), device="cuda")
    scratch = torch.empty((fused.FUSED_STEP.lib().rrt_step_scratch_floats(*geom[:5]),),
                          device="cuda")
    out = torch.empty((1 + S,), device="cuda")
    w = 1.0 / (H * W * 3)
    saved = {k.name: k.launches for k in fused.KERNELS}

    render = lambda: fused.FUSED_RENDER.call(  # noqa: E731
        "rrt_render", flat.data_ptr(), *geom, img.data_ptr(), vis.data_ptr(), stream)
    step = lambda: fused.FUSED_STEP.call(  # noqa: E731
        "rrt_step", flat.data_ptr(), *geom, target.data_ptr(), w, scratch.data_ptr(),
        out.data_ptr(), stream)
    render_ms, step_ms = time_ms(render), time_ms(step)
    device = {"fused_render": device_ms(render), "fused_step": device_ms(step)}
    if device["fused_step"]["launches"] != 1:  # one cooperative launch a call
        raise AssertionError(f"row 1 did not make one launch a call: {device['fused_step']}")
    render_plain_ms = time_ms(lambda: fused.render_fused_plain(scene, cfg))
    step_plain_ms = time_ms(lambda: fused.loss_grad_fused_plain(scene, cfg, target))
    render_shapes = {label: _render_shape_times(num, size) for label, num, size, _ in RENDER_CASES
                     if label in ("config3_512", "24obj_512")}
    for k in fused.KERNELS:
        k.launches = saved[k.name]

    c = work_counts(scene, cfg)
    r_bound, r_by = bound(render_ops(c, misses=False), 4 * (S + H * W * (3 + n_vis)))
    s_bound, s_by = bound(step_ops(c), 4 * (S + H * W * 3 + 1 + S))
    kernels = [
        dict(name="fused_step", route="cuda",
             source="reversible_raytracer_tpu_torch/ops/kernels/csrc/fused_step.cu",
             replaces="reversible_raytracer_tpu/ops/kernels/fused.py:394",
             launches=launches["fused_step"], max_abs_err=step_err, ms=step_ms,
             plain_ms=step_plain_ms, bound_ms=s_bound, bound_by=s_by, library_ms=None,
             device_ms=device["fused_step"]["ms"],
             launches_per_call=device["fused_step"]["launches"]),
        dict(name="fused_render", route="cuda",
             source="reversible_raytracer_tpu_torch/ops/kernels/csrc/fused_render.cu",
             replaces="reversible_raytracer_tpu/ops/kernels/fused.py:224",
             launches=launches["fused_render"], max_abs_err=render_err, ms=render_ms,
             plain_ms=render_plain_ms, bound_ms=r_bound, bound_by=r_by, library_ms=None,
             device_ms=device["fused_render"]["ms"],
             launches_per_call=device["fused_render"]["launches"]),
    ]
    emit("times", ok=True, size=H, work=c, render_ops=render_ops(c, misses=False),
         step_ops=step_ops(c), step_rays_per_s=H * W / (step_ms * 1e-3),
         ms={"fused_render": render_ms, "fused_step": step_ms}, device=device,
         render_shapes=render_shapes)
    return kernels



# ---------------------------------------------------------------------------
# The object-chunked kernels (scenes of more than 24 objects)
# ---------------------------------------------------------------------------

# bench.py:717-747: config 5 as BASELINE.json defines it (64 spheres +
# ground, 1024^2) and the 513-object shape (512 spheres + ground, 512^2).
VEC_SHAPES = (("config5_1024", 64, 1024), ("513obj_512", 512, 512))


def _vec_case(n_spheres, size):
    from reversible_raytracer_tpu_torch.models import configs

    scene, spec, cfg = configs.config5_many_spheres(size=size, n_spheres=n_spheres,
                                                    device="cuda")
    start = configs.perturb(scene, spec, scale=0.05, seed=4)
    return scene, start, cfg


def _vec_hit_mask(scene, cfg):
    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops.pipeline_vec import nearest_vec

    o, d = pl.primary_rays(scene, cfg)
    return nearest_vec(scene, o, d)[1] >= 0


def phase_vec_render():
    """Row 4 against render_vec_plain; returns the largest image difference
    at config 5 and the targets (plain renders of the true scenes)."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec

    rows, targets = [], {}
    for label, n_spheres, size in VEC_SHAPES:
        scene, _, cfg = _vec_case(n_spheres, size)
        img_k, vis_k = fused_vec.render_vec(scene, cfg)
        img_p, vis_p = fused_vec.render_vec_plain(scene, cfg)
        torch.cuda.synchronize()
        if img_k.shape != img_p.shape or vis_k.shape != vis_p.shape or vis_k.shape[0] != 1:
            raise AssertionError(f"{label}: shapes {img_k.shape}/{vis_k.shape} "
                                 f"vs {img_p.shape}/{vis_p.shape}")
        if not torch.isfinite(img_k).all():
            raise AssertionError(f"{label}: non-finite pixels")
        err = (img_k - img_p).abs()
        hit = _vec_hit_mask(scene, cfg)
        row = dict(shape=label, objects=n_spheres + 1, size=size,
                   frac_bad=float((err > 2e-3).float().mean()), mean_err=float(err.mean()),
                   max_abs_err=float(err.max()),
                   bit_identical=bool(torch.equal(img_k, img_p) and
                                      torch.equal(vis_k[:, hit], vis_p[:, hit])),
                   vis_diff_hit=float((vis_k != vis_p)[:, hit].float().mean()),
                   vis_on_miss_zero=not bool(vis_k[:, ~hit].any()),
                   cull=cull_counters(work_counts(scene, cfg, cull=True)))
        rows.append(row)
        if not (row["frac_bad"] < 1e-3 and row["mean_err"] < 1e-4 and row["vis_diff_hit"] < 1e-3
                and row["bit_identical"] and row["vis_on_miss_zero"]):
            raise AssertionError(f"vec forward kernel disagrees with its plain version: {row}")
        targets[label] = img_p
    emit("vec_render", ok=True, rows=rows)
    return rows[0]["max_abs_err"], targets


# The most spheres a block of rows 5-6 took with config 5's rect and light
# on the H100 (232,448 bytes of shared memory a block) before the per-warp
# culls, and a block of rows 4 and 7: the layouts with the culls must take
# at least as many.
VEC_MOST_SPHERES_BEFORE = 1520
FWD_MOST_SPHERES_BEFORE = 3392


def phase_vec_step(targets):
    """Row 6 against autograd and the eager adjoint, two calls bit for bit,
    and against row 4's own image of the same scene (the true one, and
    perturb seeds 0-2) a loss and gradient of exactly 0; returns the largest
    gradient difference from autograd at config 5."""
    import torch

    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.models.scene import tree_leaves
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec

    rows, max_abs = [], None
    for label, n_spheres, size in VEC_SHAPES:
        scene, start, cfg = _vec_case(n_spheres, size)
        spec = configs.config5_many_spheres(size=size, n_spheres=n_spheres, device="cuda")[1]
        zero = {}
        for seed in (None, 0, 1, 2):
            sc = scene if seed is None else configs.perturb(scene, spec, scale=0.05, seed=seed)
            l_0, g_0 = fused_vec.loss_grad_vec(sc, cfg, fused_vec.render_vec(sc, cfg)[0].detach())
            zero["true" if seed is None else f"seed{seed}"] = bool(
                float(l_0) == 0.0 and not fused.flatten_scene(g_0).any())
        target = targets[label]
        l_k, g_k = fused_vec.loss_grad_vec(start, cfg, target)
        l_k2, g_k2 = fused_vec.loss_grad_vec(start, cfg, target)
        torch.cuda.reset_peak_memory_stats()
        l_p, g_p = fused_vec.loss_grad_vec_plain(start, cfg, target)
        plain_peak = torch.cuda.max_memory_allocated()
        l_a, g_a = fused_vec.loss_grad_vec_adjoint_eager(start, cfg, target)
        torch.cuda.synchronize()
        same = bool(torch.equal(torch.cat([l_k.reshape(1), fused.flatten_scene(g_k)]),
                                torch.cat([l_k2.reshape(1), fused.flatten_scene(g_k2)])))
        row = dict(shape=label, loss=float(l_k), deterministic=same,
                   plain_peak_gb=plain_peak / 1e9, zero_residual_exact=zero)
        for name, (l_ref, g_ref) in (("autograd", (l_p, g_p)), ("adjoint_eager", (l_a, g_a))):
            rel = abs(float(l_k) - float(l_ref)) / max(abs(float(l_ref)), 1e-12)
            errs = _grad_errors(g_ref, g_k)
            worst = max(errs, key=errs.get)
            row[name] = dict(loss_rel=rel, worst_leaf=worst, worst_err=errs[worst])
            if not (rel <= 1e-4 and errs[worst] <= 1e-2):
                raise AssertionError(f"vec step kernel disagrees with {name}: {row}")
        if not same:
            raise AssertionError(f"vec step kernel is not bit-identical from call to call: {row}")
        if not all(zero.values()):
            raise AssertionError(f"vec step kernel's forward is not the vec forward's: {row}")
        rows.append(row)
        if max_abs is None:
            max_abs = max(float((a - b).abs().max())
                          for a, b in zip(tree_leaves(g_p), tree_leaves(g_k)) if a.numel())
    most, most_fwd = fused_vec.most_spheres(), fused_vec.most_render_spheres()
    if fused_vec.VEC_RENDER.lib().rrt_smem_optin() >= 232448 and (
            most < VEC_MOST_SPHERES_BEFORE or most_fwd < FWD_MOST_SPHERES_BEFORE):
        raise AssertionError(f"a block of the vec step takes {most} spheres and one of the vec "
                             f"forward {most_fwd}, fewer than the {VEC_MOST_SPHERES_BEFORE} and "
                             f"{FWD_MOST_SPHERES_BEFORE} they took before the culls")
    emit("vec_step", ok=True, rows=rows, most_spheres=most,
         most_spheres_before=VEC_MOST_SPHERES_BEFORE, most_render_spheres=most_fwd,
         most_render_spheres_before=FWD_MOST_SPHERES_BEFORE)
    return max_abs


def phase_vec_main():
    import time

    import torch

    from reversible_raytracer_tpu_torch import cli

    out_dir = REPO / "smoke_out"
    png = out_dir / "final_config5.png"
    for k in _all_kernels():
        k.launches = 0
    t0 = time.perf_counter()
    summary = cli.main(["invert", "--config", "5", "--size", "1024", "--iters", "20",
                        "--seed", "0", "--log-every", "5",
                        "--metrics", str(out_dir / "metrics_config5.jsonl"), "-o", str(png)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _all_kernels()}
    hist = summary["history"]
    first, last = hist[0]["loss"], hist[-1]["loss"]
    ok = (launches["fused_vec_render"] >= 2 and launches["fused_vec_step"] == 20
          and all(n == 0 for name, n in launches.items() if name not in ("fused_vec_render",
                                                                      "fused_vec_step"))
          and math.isfinite(last) and last < first and png.exists()
          and math.isfinite(summary["param_err"]))
    emit("vec_main", ok=ok, launches=launches, first_loss=first, final_loss=last,
         param_err=summary["param_err"], loop_seconds=summary["seconds"], wall_seconds=wall,
         png_bytes=png.stat().st_size if png.exists() else 0)
    if not ok:
        raise AssertionError("config-5 main path did not run through the vec kernels only, "
                             "or did not descend")
    return launches


def vec_step_bytes(c, Sg, ns_pad, nr_pad, planes=0):
    """The bytes the function needs: inputs read once (globals, rows, the
    target or the image cotangent, ``planes`` visibility planes), outputs
    written once (loss, gradients). The per-block partial rows are the
    kernels' own scratch, not counted."""
    rows = Sg + ns_pad * 17 + nr_pad * 22
    return 4 * (rows + (3 + planes) * c["pixels"] + 1 + rows)


def cull_counters(c):
    """Rows 5-6's cull counters from `work_counts(..., cull=True)`: candidate
    visits per warp walk, and the (pixel, sphere) pairs the culls keep
    against all pairs, for the primary rays and the step's shadow rays."""
    return dict(primary_visits_per_walk=c["prim_visits"] / max(c["warps"], 1),
                primary_kept_pairs=c["prim_pairs"], primary_all_pairs=c["prim_all"],
                shadow_visits_per_walk=c["shadow_visits"] / max(c["shadow_warps"], 1),
                shadow_kept_pairs=c["shadow_pairs"], shadow_all_pairs=c["shadow_all"],
                shadow_sphere_tests=c["shadow_sph_culled"],
                shadow_sphere_tests_uncull=c["shadow_sph_hit"])


def phase_vec_times():
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec

    stream = torch.cuda.current_stream().cuda_stream
    saved = {k.name: k.launches for k in _all_kernels()}
    rows = {}
    for label, n_spheres, size in VEC_SHAPES:
        scene, start, cfg = _vec_case(n_spheres, size)
        H, W = cfg.height, cfg.width
        target = fused_vec.render_vec_plain(scene, cfg)[0]
        glob, sph, rct = fused_vec._cuda_inputs(start, cfg)
        geom = fused_vec._geometry(start, cfg)
        img = torch.empty((H, W, 3), device="cuda")
        vis = torch.empty((1, H, W), device="cuda")
        scratch = torch.empty((fused_vec.VEC_STEP.lib().rrt_vec_step_scratch_floats(
            *geom[2:7]),), device="cuda")
        out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel(),), device="cuda")
        w = 1.0 / (H * W * 3)
        render = lambda: fused_vec.VEC_RENDER.call(  # noqa: E731
            "rrt_vec_render", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom,
            img.data_ptr(), vis.data_ptr(), stream)
        render_ms, render_device = time_ms(render), device_ms(render)
        step_ms = time_ms(lambda: fused_vec.VEC_STEP.call(
            "rrt_vec_step", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom,
            target.data_ptr(), w, scratch.data_ptr(), out.data_ptr(), stream))
        render_plain_ms = time_ms(lambda: fused_vec.render_vec_plain(start, cfg), reps=10)
        step_plain_ms = time_ms(lambda: fused_vec.loss_grad_vec_plain(start, cfg, target),
                                reps=10)
        c = work_counts(start, cfg, cull=True)
        Sg, (ns_pad, nr_pad) = glob.numel(), fused_vec.row_plan(start)
        in_rows = 4 * (Sg + ns_pad * 17 + nr_pad * 22)
        s_bytes = vec_step_bytes(c, Sg, ns_pad, nr_pad)
        r_bytes = in_rows + 4 * H * W * 4
        s_bound = bound(step_ops(c, cull=True), s_bytes)
        rows[label] = dict(render_ms=render_ms, step_ms=step_ms, render_plain_ms=render_plain_ms,
                           step_plain_ms=step_plain_ms,
                           render_bound=bound(render_ops(c, cull=True), r_bytes),
                           render_bound_uncull=bound(render_ops(c), r_bytes),
                           render_device=render_device, step_bound=s_bound,
                           step_bound_uncull=bound(step_ops(c), s_bytes),
                           render_ops=render_ops(c, cull=True),
                           render_ops_uncull=render_ops(c), step_ops=step_ops(c, cull=True),
                           step_ops_uncull=step_ops(c), step_bytes=s_bytes,
                           cull=cull_counters(c), work=c,
                           step_rays_per_s=H * W / (step_ms * 1e-3))
    for k in _all_kernels():
        k.launches = saved[k.name]
    emit("vec_times", ok=True, rows=rows)
    return rows

# ---------------------------------------------------------------------------
# The soft-visibility kernels (soft_tau > 0: the annealed inversion)
# ---------------------------------------------------------------------------

# (label, spheres, size, tau): config 5 at the anneal's soft size and at its
# published size, at the first and last soft stages' taus, and bench.py's
# 513-object shape.
SOFT_CASES = (("config5_512_t0.08", 64, 512, 0.08), ("config5_512_t0.01", 64, 512, 0.01),
              ("config5_1024_t0.08", 64, 1024, 0.08), ("config5_1024_t0.01", 64, 1024, 0.01),
              ("513obj_512_t0.08", 512, 512, 0.08))
SOFT_TIMED = ("config5_512_t0.08", "config5_1024_t0.08", "513obj_512_t0.08")


def _soft_case(n_spheres, size, tau):
    import dataclasses

    scene, start, cfg = _vec_case(n_spheres, size)
    return scene, start, dataclasses.replace(cfg, soft_tau=tau)


def phase_soft_render():
    """Row 7 against render_vec_soft_plain; returns the largest image
    difference at config 5, 512^2, tau 0.08 (the anneal's first stage)."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft

    rows = []
    for label, n_spheres, size, tau in SOFT_CASES:
        scene, _, cfg = _soft_case(n_spheres, size, tau)
        img_k = fused_vec_soft.render_vec_soft(scene, cfg)
        img_p = fused_vec_soft.render_vec_soft_plain(scene, cfg)
        torch.cuda.synchronize()
        if img_k.shape != img_p.shape or not torch.isfinite(img_k).all():
            raise AssertionError(f"{label}: shape {tuple(img_k.shape)} or non-finite pixels")
        err = (img_k - img_p).abs()
        row = dict(case=label, frac_bad=float((err > 2e-3).float().mean()),
                   mean_err=float(err.mean()), max_abs_err=float(err.max()),
                   bit_identical=bool(torch.equal(img_k, img_p)),
                   cull=soft_cull_counters(soft_work_counts(scene, cfg)))
        rows.append(row)
        if not (row["frac_bad"] < 1e-3 and row["mean_err"] < 1e-4):
            raise AssertionError(f"soft forward kernel disagrees with its plain version: {row}")
    emit("soft_render", ok=True, rows=rows)
    return rows[0]["max_abs_err"]


def soft_cull_counters(c):
    """Row 7's cull counters from `soft_work_counts`: candidate visits per
    warp walk and the (pixel, sphere) pairs kept against all pairs, for the
    ranking's cone and for the shadow products (layer-and-light walks with
    a candidate; live pairs inside the candidates, and those the per-pixel
    rule keeps)."""
    return dict(primary_visits_per_walk=c["prim_visits"] / max(c["warps"], 1),
                primary_kept_pairs=c["prim_pairs"], primary_all_pairs=c["prim_all"],
                shadow_visits_per_walk=c["warp_visits"] / max(c["walks"], 1),
                shadow_kept_pairs=c["candidate_pairs"], shadow_rule_kept_pairs=c["shadow_kept"],
                shadow_all_pairs=c["shadow_tests"])


def phase_soft_step():
    """Row 9 against autograd and the eager adjoint, and two calls bit for
    bit; returns the largest gradient difference from autograd at config 5,
    512^2, tau 0.08."""
    import torch

    from reversible_raytracer_tpu_torch.models.scene import tree_leaves
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft

    rows, max_abs = [], None
    for label, n_spheres, size, tau in SOFT_CASES:
        scene, start, cfg = _soft_case(n_spheres, size, tau)
        target = fused_vec_soft.render_vec_soft_plain(scene, cfg)
        l_k, g_k = fused_vec_soft.loss_grad_vec_soft(start, cfg, target)
        l_k2, g_k2 = fused_vec_soft.loss_grad_vec_soft(start, cfg, target)
        torch.cuda.reset_peak_memory_stats()
        l_p, g_p = fused_vec_soft.loss_grad_vec_soft_plain(start, cfg, target)
        plain_peak = torch.cuda.max_memory_allocated()
        l_a, g_a = fused_vec_soft.loss_grad_vec_soft_adjoint_eager(start, cfg, target)
        torch.cuda.synchronize()
        same = bool(torch.equal(torch.cat([l_k.reshape(1), fused.flatten_scene(g_k)]),
                                torch.cat([l_k2.reshape(1), fused.flatten_scene(g_k2)])))
        row = dict(case=label, loss=float(l_k), deterministic=same,
                   plain_peak_gb=plain_peak / 1e9)
        for name, (l_ref, g_ref) in (("autograd", (l_p, g_p)), ("adjoint_eager", (l_a, g_a))):
            rel = abs(float(l_k) - float(l_ref)) / max(abs(float(l_ref)), 1e-12)
            errs = _grad_errors(g_ref, g_k)
            worst = max(errs, key=errs.get)
            row[name] = dict(loss_rel=rel, worst_leaf=worst, worst_err=errs[worst])
        # the true scene against the forward kernel's image of it
        img = fused_vec_soft.render_vec_soft(scene, cfg)
        l_0, g_0 = fused_vec_soft.loss_grad_vec_soft(scene, cfg, img)
        torch.cuda.synchronize()
        row["zero_residual_exact"] = bool(float(l_0) == 0.0
                                          and not fused.flatten_scene(g_0).any())
        rows.append(row)
        for name in ("autograd", "adjoint_eager"):
            if not (row[name]["loss_rel"] <= 1e-4 and row[name]["worst_err"] <= 1e-2):
                raise AssertionError(f"soft step kernel disagrees with {name}: {row}")
        if not same:
            raise AssertionError(f"soft step kernel is not bit-identical from call to call: {row}")
        if not row["zero_residual_exact"]:
            raise AssertionError(f"soft step kernel's forward is not the soft forward's: {row}")
        if max_abs is None:
            max_abs = max(float((a - b).abs().max())
                          for a, b in zip(tree_leaves(g_p), tree_leaves(g_k)) if a.numel())
    most_fwd = fused_vec_soft.most_render_spheres()
    if fused_vec.VEC_RENDER.lib().rrt_smem_optin() >= 232448 and most_fwd < FWD_MOST_SPHERES_BEFORE:
        raise AssertionError(f"a block of the soft forward takes {most_fwd} spheres, fewer than "
                             f"the {FWD_MOST_SPHERES_BEFORE} it took before the culls")
    emit("soft_step", ok=True, rows=rows, most_spheres=fused_vec_soft.most_spheres(),
         most_render_spheres=most_fwd, most_render_spheres_before=FWD_MOST_SPHERES_BEFORE)
    return max_abs


ANNEAL_TAUS = (0.08, 0.03, 0.01, 0.0)
ANNEAL_ITERS = 20


def phase_anneal_main():
    import time

    import torch

    from reversible_raytracer_tpu_torch import cli

    out_dir = REPO / "smoke_out"
    png = out_dir / "final_anneal.png"
    for k in _all_kernels():
        k.launches = 0
    t0 = time.perf_counter()
    summary = cli.main(["invert", "--config", "5", "--size", "1024", "--anneal",
                        ",".join(str(t) for t in ANNEAL_TAUS), "--anneal-size", "512",
                        "--lr", "2e-3", "--perturb", "0.03", "--iters", str(ANNEAL_ITERS),
                        "--seed", "0", "--metrics", str(out_dir / "metrics_anneal.jsonl"),
                        "-o", str(png)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _all_kernels()}
    la = summary["losses"]
    stages = [la[i * ANNEAL_ITERS:(i + 1) * ANNEAL_ITERS] for i in range(len(ANNEAL_TAUS))]
    soft_fall = [st[-1] < st[0] for st, tau in zip(stages, ANNEAL_TAUS) if tau > 0]
    expect = {"fused_vec_soft_render": 3, "fused_vec_soft_step": 3 * ANNEAL_ITERS,
              "fused_vec_step": ANNEAL_ITERS, "fused_render": 0, "fused_step": 0}
    ok = (all(launches[name] == n for name, n in expect.items())
          and launches["fused_vec_render"] >= 2 and all(soft_fall)
          and all(math.isfinite(x) for x in la) and png.exists()
          and summary["param_err"] < summary["start_param_err"])
    emit("anneal_main", ok=ok, launches=launches, expected=expect,
         stage_first_last=[[st[0], st[-1]] for st in stages], soft_stages_fall=soft_fall,
         start_param_err=summary["start_param_err"], param_err=summary["param_err"],
         loop_seconds=summary["seconds"], wall_seconds=wall,
         png_bytes=png.stat().st_size if png.exists() else 0)
    if not ok:
        raise AssertionError("the annealed path did not run through the expected kernels, a "
                             "soft stage did not descend, or the parameters did not improve")
    return launches


# Soft terms, counted as the rest of OPS (csrc/soft_common.cuh,
# csrc/soft_step.cuh): the sigmoid of a ranked near miss; one soft shadow
# test (a sphere's coverage of a shadow ray and its factor in the product),
# counted for every sphere, live layer and light in the forward; its
# adjoint; the per-pixel cull test of a (pixel, sphere) pair the step drops
# (oc, b, |oc|^2 - r^2, disc); the per-warp test of one sphere against a
# warp's ball of shadow origins (c - c_w, its projection on the segment to
# the light, clamped, the offset and its square against (R + rho)^2); a
# live sphere layer's coverage and its adjoint; the composite and its
# adjoint per pixel. The step's shadow terms are counted with the cull at
# what the cheapest known algorithm spends: per (warp, sphere, layer,
# light) with a live lane the warp test, per live lane of a warp's
# candidate the pixel test, and a kept pair at its soft test and adjoint;
# and, as before the cull, every pair at its soft test and each pair whose
# coverage is not gated to zero at its adjoint.
SOFT_OPS = dict(rank_sigmoid=4, shadow_soft=26, adj_shadow=42, shadow_cull=16, warp_test=25,
                layer_alpha=4, adj_alpha=12, composite=18, adj_composite=30)


def soft_work_counts(scene, cfg):
    """What the soft kernels' work depends on in this run's data: live
    layers by winner type, sphere-ray pairs that rank by their sigmoid, and
    the soft shadow tests, the ones whose coverage is not gated to zero and
    the ones the cull keeps, over both layers and every light; by
    `cull.warp_candidates`, the warps' sphere tests (a warp with a
    live lane tests every sphere), their candidate visits (each a walk step
    of 32 lanes), the live (pixel, sphere) pairs inside those candidates,
    and the layer-and-light walks with a candidate; by
    `cull.primary_candidates` at tau (row 7's ranking), the warps, their
    candidate visits, the (pixel, candidate) pairs the ranking tests, and
    those of them that rank by their sigmoid."""
    import torch

    from reversible_raytracer_tpu_torch.ops import pipeline as pl
    from reversible_raytracer_tpu_torch.ops import pipeline_vec as pv
    from reversible_raytracer_tpu_torch.ops.kernels import cull
    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft as fvs

    with torch.no_grad():
        H, W = cfg.height, cfg.width
        tau = cfg.soft_tau
        sp, rc = scene.spheres, scene.rects
        N, M, L = sp.count, rc.count, scene.lights.count
        o, d = pl.primary_rays(scene, cfg)
        c, r = pv.sphere_axis(sp)
        oc = pl.vm.vsub(pv._lead(o), c)
        b = pl.vm.vdot(oc, pv._lead(d))
        disc = b * b - (pl.vm.vdot(oc, oc) - r * r)
        t = -b - pl.vm.safe_sqrt(disc)
        sigm = (~((disc > 0) & (t > pl.T_EPS))) & (-b > pl.T_EPS)
        n_p = cull.primary_candidates(sp, scene.camera.eye, d, tau)  # (H, R, N)
        keep = cull.per_pixel(n_p, W)
        lanes_p = cull.runs(torch.ones((H, W), dtype=torch.bool, device=scene.device),
                            False).sum(-1)
        prim = dict(warps=lanes_p.numel(), prim_visits=int(n_p.sum()),
                    prim_pairs=int((n_p.sum(-1) * lanes_p).sum()), prim_all=H * W * N,
                    ranked_sigmoid_cull=int((sigm & keep).sum()))
        ranked = int(sigm.sum())
        del oc, b, disc, t, sigm, keep
        live = live_sph = live_rect = gated = kept = tests = visits = pairs = walks = 0
        for _, k in pv.two_layers(scene, o, d, tau):
            tt, lv, at, _ = pv.soft_layer(scene, o, d, k, tau, (H, W))
            live += int(lv.sum())
            live_sph += int(((k >= 0) & (k < N)).sum())
            live_rect += int((k >= N).sum())
            so = pl.shadow_origin(o, d, tt, (at["nx"], at["ny"], at["nz"]))
            for li in range(L):
                ldir, dist = pl.light_geometry(scene.lights, li, so)
                alpha = pv.sphere_shadow_alpha(c, r, pv._lead(so), pv._lead(ldir), dist[None],
                                               tau)
                gated += int(((alpha > 0) & lv[None]).sum())
                kept += int((fvs.shadow_kept(c, r, pv._lead(so), pv._lead(ldir), dist[None], tau)
                             & lv[None]).sum())
                n = cull.warp_candidates(sp, so, lv, scene.lights.position[li], tau).sum(-1)
                lanes = torch.nn.functional.pad(lv, (0, -W % 32)).reshape(H, -1, 32).sum(-1)
                tests += int((lanes > 0).sum()) * N
                visits += int(n.sum())
                pairs += int((n * lanes).sum())
                walks += int((n > 0).sum())
        shadows = live * L if cfg.shadows else 0
    return dict(height=H, width=W, pixels=H * W, n_sph=N, n_rect=M, lights=L, live=live,
                live_sph=live_sph, live_rect=live_rect, ranked_sigmoid=ranked, **prim,
                shadow_tests=shadows * N, shadow_rect=shadows * M,
                shadow_gated=gated if cfg.shadows else 0,
                shadow_kept=kept if cfg.shadows else 0,
                warp_tests=tests if cfg.shadows else 0,
                warp_visits=visits if cfg.shadows else 0,
                candidate_pairs=pairs if cfg.shadows else 0, walks=walks if cfg.shadows else 0)


def _soft_shadow_cull_ops(c):
    """The soft shadow products over the warps' candidates (rows 7-9): per
    warp with a live lane the warp test of every sphere, per live lane of a
    candidate the per-pixel rule, and a kept pair at its soft test."""
    return (c["warp_tests"] * SOFT_OPS["warp_test"]
            + max(c["candidate_pairs"] - c["shadow_kept"], 0) * SOFT_OPS["shadow_cull"]
            + c["shadow_kept"] * SOFT_OPS["shadow_soft"])


def soft_render_ops(c, cull=False):
    """The soft forward's operations: every object ranked per pixel and
    every sphere's soft shadow test per live layer and light; ``cull``: row
    7's culls, the ranking over each warp's candidates of the widened cone
    and the shadow products over the warps' shadow candidates."""
    ops = (_common_ops(c) + c["ranked_sigmoid"] * SOFT_OPS["rank_sigmoid"]
           + c["live_sph"] * (OPS["surf_sphere"] + SOFT_OPS["layer_alpha"])
           + c["live_rect"] * OPS["surf_rect"]
           + c["live"] * (OPS["so"] + c["lights"] * (OPS["light"] + OPS["phong"]))
           + c["shadow_tests"] * SOFT_OPS["shadow_soft"] + c["shadow_rect"] * OPS["rect_shadow"]
           + c["pixels"] * SOFT_OPS["composite"])
    if cull:
        n = c["n_sph"]
        ops += (n * CULL_OPS["cone_sphere"] + c["warps"] * (CULL_OPS["cone_warp"]
                                                            + n * CULL_OPS["cone_test"])
                + (c["prim_pairs"] - c["pixels"] * n) * OPS["sphere_primary"]
                + (c["ranked_sigmoid_cull"] - c["ranked_sigmoid"]) * SOFT_OPS["rank_sigmoid"]
                + _soft_shadow_cull_ops(c) - c["shadow_tests"] * SOFT_OPS["shadow_soft"])
    return ops


def soft_step_ops(c, cull=True):
    """The soft step's operations; ``cull=False`` counts the shadow terms
    as before the cull."""
    if cull:
        shadow = _soft_shadow_cull_ops(c) + c["shadow_kept"] * SOFT_OPS["adj_shadow"]
    else:
        shadow = (c["shadow_tests"] * SOFT_OPS["shadow_soft"]
                  + c["shadow_gated"] * SOFT_OPS["adj_shadow"])
    return (soft_render_ops(c) - c["shadow_tests"] * SOFT_OPS["shadow_soft"] + shadow
            + OPS["cam_chain"]
            + c["pixels"] * (OPS["resid"] + OPS["sum_pixel"] + SOFT_OPS["adj_composite"]
                             + OPS["adj_camera"] + OPS["sum_hit"])
            + c["live"] * (OPS["adj_base"] + c["lights"] * (OPS["adj_light"] + OPS["sum_light"]))
            + c["live_sph"] * (OPS["adj_sphere"] + SOFT_OPS["adj_alpha"] + OPS["sum_sphere"])
            + c["live_rect"] * (OPS["adj_rect"] + OPS["sum_rect"]))


def phase_soft_times():
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused_vec, fused_vec_soft

    stream = torch.cuda.current_stream().cuda_stream
    saved = {k.name: k.launches for k in _all_kernels()}
    rows = {}
    for label, n_spheres, size, tau in SOFT_CASES:
        if label not in SOFT_TIMED:
            continue
        scene, start, cfg = _soft_case(n_spheres, size, tau)
        H, W = cfg.height, cfg.width
        target = fused_vec_soft.render_vec_soft_plain(scene, cfg)
        glob, sph, rct = fused_vec_soft._cuda_inputs(start, cfg)
        geom = fused_vec._geometry(start, cfg)
        img = torch.empty((H, W, 3), device="cuda")
        scratch = torch.empty((fused_vec_soft.SOFT_STEP.lib().rrt_soft_step_scratch_floats(
            *geom[2:7]),), device="cuda")
        out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel(),), device="cuda")
        w = 1.0 / (H * W * 3)
        render = lambda: fused_vec_soft.SOFT_RENDER.call(  # noqa: E731
            "rrt_soft_render", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom, tau,
            img.data_ptr(), stream)
        render_ms, render_device = time_ms(render), device_ms(render)
        step_ms = time_ms(lambda: fused_vec_soft.SOFT_STEP.call(
            "rrt_soft_step", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom, tau,
            target.data_ptr(), w, scratch.data_ptr(), out.data_ptr(), stream))
        render_plain_ms = time_ms(lambda: fused_vec_soft.render_vec_soft_plain(start, cfg),
                                  reps=5, warmup=1)
        step_plain_ms = time_ms(
            lambda: fused_vec_soft.loss_grad_vec_soft_plain(start, cfg, target), reps=5, warmup=1)
        c = soft_work_counts(start, cfg)
        Sg, (ns_pad, nr_pad) = glob.numel(), fused_vec.row_plan(start)
        in_rows = 4 * (Sg + ns_pad * 17 + nr_pad * 22)
        s_bytes = vec_step_bytes(c, Sg, ns_pad, nr_pad)
        r_bytes = in_rows + 4 * H * W * 3
        s_bound = bound(soft_step_ops(c), s_bytes)
        rows[label] = dict(render_ms=render_ms, step_ms=step_ms, render_plain_ms=render_plain_ms,
                           step_plain_ms=step_plain_ms,
                           render_bound=bound(soft_render_ops(c, cull=True), r_bytes),
                           render_bound_uncull=bound(soft_render_ops(c), r_bytes),
                           render_device=render_device, step_bound=s_bound,
                           step_bound_uncull=bound(soft_step_ops(c, cull=False), s_bytes),
                           kept_pairs=c["shadow_kept"], all_pairs=c["shadow_tests"],
                           render_ops=soft_render_ops(c, cull=True),
                           render_ops_uncull=soft_render_ops(c), step_ops=soft_step_ops(c),
                           cull=soft_cull_counters(c), work=c,
                           step_rays_per_s=H * W / (step_ms * 1e-3))
    for k in _all_kernels():
        k.launches = saved[k.name]
    emit("soft_times", ok=True, rows=rows)
    return rows

# ---------------------------------------------------------------------------
# The render backward kernels (rows 3, 5, 8): a differentiable render
# ---------------------------------------------------------------------------

# (label, family, spheres, size, tau, perturb scale and lr of the main run):
# config 2 at bench.py's 512^2, config 5 at its BASELINE 1024^2, and config 5
# at the anneal's soft size and first stage (the scales and rates of the
# CLI runs of phases main, vec_main and anneal_main).
GRAD_CASES = (("config2_512", "fused", 4, 512, 0.0, 0.1, 1e-2),
              ("config5_1024", "vec", 64, 1024, 0.0, 0.05, 1e-2),
              ("config5_512_t0.08", "soft", 64, 512, 0.08, 0.03, 2e-3))
BWD_NAMES = {"fused": "fused_render_bwd", "vec": "fused_vec_render_bwd",
             "soft": "fused_vec_soft_render_bwd"}
FWD_NAMES = {"fused": "fused_render", "vec": "fused_vec_render", "soft": "fused_vec_soft_render"}
BWD_REPLACES = {"fused": "reversible_raytracer_tpu/ops/kernels/fused.py:252",
                "vec": "reversible_raytracer_tpu/ops/kernels/fused_vec.py:979",
                "soft": "reversible_raytracer_tpu/ops/kernels/fused_vec_soft.py:547"}


def _grad_case(family, n_spheres, size, tau):
    import dataclasses

    from reversible_raytracer_tpu_torch.models import configs

    if family == "fused":
        scene, spec, cfg = configs.config2_four_spheres(size=size, device="cuda")
    else:
        scene, spec, cfg = configs.config5_many_spheres(size=size, n_spheres=n_spheres,
                                                        device="cuda")
    return scene, spec, dataclasses.replace(cfg, soft_tau=tau)


def _grad_start(family, scene, spec):
    from reversible_raytracer_tpu_torch.models import configs

    return configs.perturb(scene, spec, scale=0.1 if family == "fused" else 0.05, seed=4)


def _bwd(scene, cfg, g):
    """The scene's gradient for cotangent ``g`` by the main path's route,
    autograd of `render`: one forward and one backward-kernel launch."""
    from reversible_raytracer_tpu_torch.ops.kernels import fused
    from reversible_raytracer_tpu_torch.ops.render import render

    return fused.autograd_vjp(render, scene, cfg, g)


def _bwd_plain(family):
    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft

    return {"fused": fused.render_fused_bwd_plain, "vec": fused_vec.render_vec_bwd_plain,
            "soft": fused_vec_soft.render_vec_soft_bwd_plain}[family]


def _seeded_cotangent(cfg):
    import numpy as np
    import torch

    g = np.random.default_rng(0).normal(size=(cfg.height, cfg.width, 3)).astype(np.float32)
    return torch.from_numpy(g).cuda()


def phase_render_grad():
    """Rows 3, 5 and 8, reached as the main path reaches them (autograd of
    `render`), against their plain versions and against the step kernels'
    mse gradient; returns each family's largest absolute gradient
    difference from its plain version."""
    import torch

    from reversible_raytracer_tpu_torch.models.scene import tree_leaves, tree_unflatten
    from reversible_raytracer_tpu_torch.ops.kernels import fused
    from reversible_raytracer_tpu_torch.ops.render import loss_and_grad_fn, render

    rows, max_abs = [], {}
    for label, family, n_spheres, size, tau, *_ in GRAD_CASES:
        scene, spec, cfg = _grad_case(family, n_spheres, size, tau)
        start = _grad_start(family, scene, spec)
        target = render(scene, cfg)
        g = _seeded_cotangent(cfg)
        kernel = {k.name: k for k in _all_kernels()}[BWD_NAMES[family]]
        before = kernel.launches
        got = _bwd(start, cfg, g)
        one_launch = kernel.launches == before + 1
        again = [_bwd(start, cfg, g) for _ in range(2)]
        plain = _bwd_plain(family)(start, cfg, g)
        leaves = [l.clone().requires_grad_(True) for l in tree_leaves(start)]
        ((render(tree_unflatten(start, leaves), cfg) - target) ** 2).mean().backward()
        grads = lambda: [torch.zeros_like(l) if l.grad is None else l.grad  # noqa: E731
                         for l in leaves]
        by_render = tree_unflatten(start, grads())
        by_step = loss_and_grad_fn(start, cfg)(start, target)[1]
        for l in leaves:
            l.grad = None
        render(tree_unflatten(start, leaves), cfg).sum().backward()
        expanded = torch.cat([x.reshape(-1) for x in grads()])
        ones = _bwd(start, cfg, torch.ones_like(g))
        torch.cuda.synchronize()
        row = dict(case=label, kernel=BWD_NAMES[family], one_launch=one_launch,
                   deterministic=all(torch.equal(fused.flatten_scene(got),
                                                 fused.flatten_scene(a)) for a in again),
                   expanded_cotangent_same=bool(torch.equal(expanded, fused.flatten_scene(ones))),
                   mse_bit_equal=bool(torch.equal(fused.flatten_scene(by_render),
                                                  fused.flatten_scene(by_step))))
        checks = [("plain", plain, got), ("mse_vs_step", by_step, by_render)]
        if family == "soft":  # row 8 against its eager twin too
            from reversible_raytracer_tpu_torch.ops.kernels import fused_vec_soft

            checks.append(("twin", fused_vec_soft.render_vec_soft_bwd_adjoint_eager(start, cfg, g),
                           got))
        for name, ref, test in checks:
            errs = _grad_errors(ref, test)
            worst = max(errs, key=errs.get)
            row[name] = dict(worst_leaf=worst, worst_err=errs[worst])
        max_abs[family] = max(float((a - b).abs().max())
                              for a, b in zip(tree_leaves(plain), tree_leaves(got)) if a.numel())
        row["plain"]["max_abs_err"] = max_abs[family]
        rows.append(row)
        if not (all(row[name]["worst_err"] <= 1e-2 for name, *_ in checks)
                and row["one_launch"] and row["deterministic"]
                and row["expanded_cotangent_same"]
                and (row["mse_bit_equal"] or family == "soft")):
            raise AssertionError(f"render backward kernel failed a check: {row}")
    emit("render_grad", ok=True, rows=rows)
    return max_abs


GRAD_ITERS = 20


def phase_render_grad_main():
    """optimize(render_fn=render): each step autograd through the forward and
    the backward kernel. Returns the launch counts of each shape's run."""
    import time

    import torch

    from reversible_raytracer_tpu_torch.optim import OptConfig, optimize, param_error
    from reversible_raytracer_tpu_torch.models import configs
    from reversible_raytracer_tpu_torch.ops.render import render

    rows, counts = [], {}
    for label, family, n_spheres, size, tau, scale, lr in GRAD_CASES:
        scene, spec, cfg = _grad_case(family, n_spheres, size, tau)
        for k in _all_kernels():
            k.launches = 0
        t0 = time.perf_counter()
        target = render(scene, cfg)
        start = configs.perturb(scene, spec, scale=scale, seed=0)
        final, _, losses = optimize(start, target, spec, cfg, OptConfig(iters=GRAD_ITERS, lr=lr),
                                    log_every=0, render_fn=lambda s, cfg=cfg: render(s, cfg))
        la = losses.cpu().tolist()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in _all_kernels()}
        expect = {FWD_NAMES[family]: GRAD_ITERS + 1, BWD_NAMES[family]: GRAD_ITERS}
        row = dict(case=label, launches=launches, expected=expect, first_loss=la[0],
                   final_loss=la[-1], start_param_err=float(param_error(start, scene, spec)),
                   param_err=float(param_error(final, scene, spec)), wall_seconds=wall)
        rows.append(row)
        counts[label] = launches
        ok = (all(launches[name] == expect.get(name, 0) for name in launches)
              and all(math.isfinite(x) for x in la) and la[-1] < la[0])
        if not ok:
            raise AssertionError(f"optimize(render_fn=render) did not run through the forward "
                                 f"and backward kernels only, or did not descend: {row}")
    emit("render_grad_main", ok=True, rows=rows)
    return counts


# The backward's operations: the step's, without the shadow rays' any-hit
# tests for the hard families (the planes are read instead), and with the
# caller's cotangent times the clip gradient (3 multiplies) in place of the
# residual and the squared error.
OPS_COT = 3


def bwd_ops(c, cull=False):
    """The render backward's operations: the step's without its shadow rays
    (``cull``: with the primary cull, as rows 5-6 walk)."""
    ops = (step_ops(c) - c["pixels"] * (OPS["resid"] + OPS["sum_pixel"] - OPS_COT)
           - c["shadow_sph_hit"] * OPS["sphere_shadow"]
           - c["shadow_rect_hit"] * OPS["rect_shadow"])
    if cull:
        culled, full = _cull_ops(c, shadows=False)
        ops += culled - full
    return ops


def soft_bwd_ops(c, cull=True):
    return soft_step_ops(c, cull) - c["pixels"] * (OPS["resid"] + OPS["sum_pixel"] - OPS_COT)


def _raw_calls(family, start, cfg, g, target):
    """(forward, backward, step) launches of the family's C entries on fixed
    buffers (no wrapper, no counter), the backward's bound and the work
    counts. The forward runs once here, so the planes the backward reads
    are this scene's."""
    import torch

    from reversible_raytracer_tpu_torch.ops.kernels import fused, fused_vec, fused_vec_soft

    stream = torch.cuda.current_stream().cuda_stream
    H, W = cfg.height, cfg.width
    w = 1.0 / (H * W * 3)
    img = torch.empty((H, W, 3), device="cuda")
    if family == "fused":
        flat = fused._cuda_flat(start, cfg)
        geom = fused._geometry(start, cfg)
        S = flat.numel()
        vis = torch.empty((start.lights.count, H, W), device="cuda")
        scratch = torch.empty((fused.FUSED_STEP.lib().rrt_step_scratch_floats(*geom[:5]),),
                              device="cuda")
        out = torch.empty((1 + S,), device="cuda")
        fwd = lambda: fused.FUSED_RENDER.call("rrt_render", flat.data_ptr(), *geom,  # noqa: E731
                                              img.data_ptr(), vis.data_ptr(), stream)
        bwd = lambda: fused.FUSED_RENDER_BWD.call(  # noqa: E731
            "rrt_render_bwd", flat.data_ptr(), *geom, g.data_ptr(), vis.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), stream)
        step = lambda: fused.FUSED_STEP.call(  # noqa: E731
            "rrt_step", flat.data_ptr(), *geom, target.data_ptr(), w, scratch.data_ptr(),
            out.data_ptr(), stream)
        fwd()
        c = work_counts(start, cfg)
        return fwd, bwd, step, bound(bwd_ops(c), 4 * (S + H * W * (3 + vis.shape[0]) + 1 + S)), c
    glob, sph, rct = fused_vec.packed_inputs(start)
    geom = fused_vec._geometry(start, cfg)
    Sg, (ns_pad, nr_pad) = glob.numel(), fused_vec.row_plan(start)
    out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel(),), device="cuda")

    def rows():  # the lambdas below keep the row tensors alive through this
        return glob.data_ptr(), sph.data_ptr(), rct.data_ptr()

    if family == "vec":
        vis = torch.empty((start.lights.count, H, W), device="cuda")
        scratch = torch.empty((fused_vec.VEC_STEP.lib().rrt_vec_step_scratch_floats(
            *geom[2:7]),), device="cuda")
        fwd = lambda: fused_vec.VEC_RENDER.call(  # noqa: E731
            "rrt_vec_render", *rows(), *geom, img.data_ptr(), vis.data_ptr(), stream)
        bwd = lambda: fused_vec.VEC_RENDER_BWD.call(  # noqa: E731
            "rrt_vec_render_bwd", *rows(), *geom, g.data_ptr(), vis.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), stream)
        step = lambda: fused_vec.VEC_STEP.call(  # noqa: E731
            "rrt_vec_step", *rows(), *geom, target.data_ptr(), w, scratch.data_ptr(),
            out.data_ptr(), stream)
        fwd()
        c = work_counts(start, cfg, cull=True)
        nbytes = vec_step_bytes(c, Sg, ns_pad, nr_pad, planes=vis.shape[0])
        c["bound_uncull"] = bound(bwd_ops(c), nbytes)
        c["cull"] = cull_counters(c)
        return fwd, bwd, step, bound(bwd_ops(c, cull=True), nbytes), c
    tau = float(cfg.soft_tau)
    scratch = torch.empty((fused_vec_soft.SOFT_STEP.lib().rrt_soft_step_scratch_floats(
        *geom[2:7]),), device="cuda")
    fwd = lambda: fused_vec_soft.SOFT_RENDER.call(  # noqa: E731
        "rrt_soft_render", *rows(), *geom, tau, img.data_ptr(), stream)
    bwd = lambda: fused_vec_soft.SOFT_RENDER_BWD.call(  # noqa: E731
        "rrt_soft_render_bwd", *rows(), *geom, tau, g.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), stream)
    step = lambda: fused_vec_soft.SOFT_STEP.call(  # noqa: E731
        "rrt_soft_step", *rows(), *geom, tau, target.data_ptr(), w, scratch.data_ptr(),
        out.data_ptr(), stream)
    c = soft_work_counts(start, cfg)
    c["bound_uncull"] = bound(soft_bwd_ops(c, cull=False), vec_step_bytes(c, Sg, ns_pad, nr_pad))
    return fwd, bwd, step, bound(soft_bwd_ops(c), vec_step_bytes(c, Sg, ns_pad, nr_pad)), c


def phase_render_grad_times():
    """Each backward kernel, its plain version, forward + backward and the
    matching step kernel (CUDA events, median of 20 after 3 warm-ups; the
    plain version 10 or 5), beside the backward's bound."""
    from reversible_raytracer_tpu_torch.ops.render import render

    saved = {k.name: k.launches for k in _all_kernels()}
    rows = {}
    for label, family, n_spheres, size, tau, *_ in GRAD_CASES:
        scene, spec, cfg = _grad_case(family, n_spheres, size, tau)
        start = _grad_start(family, scene, spec)
        target = render(scene, cfg)
        g = _seeded_cotangent(cfg)
        fwd, bwd, step, b, c = _raw_calls(family, start, cfg, g, target)
        plain = _bwd_plain(family)
        soft = family == "soft"
        rows[label] = dict(
            bwd_ms=time_ms(bwd), bwd_device=device_ms(bwd),
            plain_ms=time_ms(lambda: plain(start, cfg, g), reps=5 if soft else 10,
                             warmup=1 if soft else 3),
            fwd_bwd_ms=time_ms(lambda: (fwd(), bwd())), step_ms=time_ms(step), bound=b,
            ops=soft_bwd_ops(c) if soft else bwd_ops(c, cull=family == "vec"), work=c)
        rows[label]["rays_per_s"] = cfg.height * cfg.width / (rows[label]["bwd_ms"] * 1e-3)
    for k in _all_kernels():
        k.launches = saved[k.name]
    if rows["config2_512"]["bwd_device"]["launches"] != 1:  # one cooperative launch a call
        raise AssertionError(f"row 3 did not make one launch a call: "
                             f"{rows['config2_512']['bwd_device']}")
    emit("render_grad_times", ok=True, rows=rows)
    return rows


def kernel_status():
    """Each kernel's status as PERF.md's table of TPU kernels records it
    (ported, and redesigned, and when), by the CUDA source in its row."""
    import re

    status = {}
    perf = REPO / "PERF.md"
    for line in perf.read_text().splitlines() if perf.exists() else []:
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        found = re.search(r"csrc/(\w+)\.cu", line)
        if len(cells) > 3 and cells[0].isdigit() and found:
            status[found.group(1)] = re.sub(r" \(.*\)$", "", cells[2])
    return status


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (REPO / "reversible_raytracer_tpu_torch" / "ops" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = run_phase("device", phase_device)
    contracted = run_phase("build", phase_build)
    render_err = run_phase("render", phase_render)
    start, target, cfg, step_err, g_plain = run_phase("step", phase_step)
    launches = run_phase("main", phase_main)
    kernels = run_phase("times", phase_times, (start, target, cfg), launches, render_err, step_err)
    run_phase("fmad", phase_fmad, contracted, (start, target, cfg), g_plain)
    vec_render_err, targets = run_phase("vec_render", phase_vec_render)
    vec_step_err = run_phase("vec_step", phase_vec_step, targets)
    vec_launches = run_phase("vec_main", phase_vec_main)
    vt = run_phase("vec_times", phase_vec_times)["config5_1024"]
    soft_render_err = run_phase("soft_render", phase_soft_render)
    soft_step_err = run_phase("soft_step", phase_soft_step)
    anneal_launches = run_phase("anneal_main", phase_anneal_main)
    st = run_phase("soft_times", phase_soft_times)["config5_512_t0.08"]
    grad_err = run_phase("render_grad", phase_render_grad)
    grad_launches = run_phase("render_grad_main", phase_render_grad_main)
    gt = run_phase("render_grad_times", phase_render_grad_times)
    src = "reversible_raytracer_tpu_torch/ops/kernels/csrc/"
    kernels += [
        dict(name="fused_vec_step", route="cuda", source=src + "fused_vec_step.cu",
             replaces="reversible_raytracer_tpu/ops/kernels/fused_vec.py:979",
             launches=vec_launches["fused_vec_step"], max_abs_err=vec_step_err,
             ms=vt["step_ms"], plain_ms=vt["step_plain_ms"], bound_ms=vt["step_bound"][0],
             bound_by=vt["step_bound"][1], library_ms=None),
        dict(name="fused_vec_render", route="cuda", source=src + "fused_vec_render.cu",
             replaces="reversible_raytracer_tpu/ops/kernels/fused_vec.py:897",
             launches=vec_launches["fused_vec_render"], max_abs_err=vec_render_err,
             ms=vt["render_ms"], plain_ms=vt["render_plain_ms"], bound_ms=vt["render_bound"][0],
             bound_by=vt["render_bound"][1], library_ms=None,
             device_ms=vt["render_device"]["ms"],
             launches_per_call=vt["render_device"]["launches"]),
        dict(name="fused_vec_soft_step", route="cuda", source=src + "fused_vec_soft_step.cu",
             replaces="reversible_raytracer_tpu/ops/kernels/fused_vec_soft.py:547",
             launches=anneal_launches["fused_vec_soft_step"], max_abs_err=soft_step_err,
             ms=st["step_ms"], plain_ms=st["step_plain_ms"], bound_ms=st["step_bound"][0],
             bound_by=st["step_bound"][1], library_ms=None),
        dict(name="fused_vec_soft_render", route="cuda", source=src + "fused_vec_soft_render.cu",
             replaces="reversible_raytracer_tpu/ops/kernels/fused_vec_soft.py:494",
             launches=anneal_launches["fused_vec_soft_render"], max_abs_err=soft_render_err,
             ms=st["render_ms"], plain_ms=st["render_plain_ms"], bound_ms=st["render_bound"][0],
             bound_by=st["render_bound"][1], library_ms=None,
             device_ms=st["render_device"]["ms"],
             launches_per_call=st["render_device"]["launches"]),
    ]
    for label, family, *_ in GRAD_CASES:
        name = BWD_NAMES[family]
        kernels.append(dict(
            name=name, route="cuda", source=src + f"{name}.cu", replaces=BWD_REPLACES[family],
            launches=grad_launches[label][name], max_abs_err=grad_err[family],
            ms=gt[label]["bwd_ms"], plain_ms=gt[label]["plain_ms"],
            bound_ms=gt[label]["bound"][0], bound_by=gt[label]["bound"][1], library_ms=None,
            device_ms=gt[label]["bwd_device"]["ms"],
            launches_per_call=gt[label]["bwd_device"]["launches"]))
    for label, family, *_ in GRAD_CASES:  # the forwards' launches on the render_fn path
        for k in kernels:
            if k["name"] == FWD_NAMES[family]:
                k["launches_render_fn"] = grad_launches[label][k["name"]]
    status = kernel_status()
    for k in kernels:
        k["status"] = status.get(k["name"], "not recorded")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
