"""The two CUDA kernels of the inverse-render path, their wrappers and
their plain versions.

- `render_fused`: the forward render kernel (``csrc/fused_render.cu``),
  replacing the TPU kernel ``_make_fused.fwd_kernel``
  (reversible_raytracer_tpu/ops/kernels/fused.py:224). It writes the
  (H, W, 3) image and the shadow-visibility planes. Plain version:
  `render_fused_plain`.
- `loss_grad_fused`: the fused training-step kernel (``csrc/fused_step.cu``),
  replacing ``_make_loss_grad.kernel`` (fused.py:394). One launch gives the
  squared-error loss against a target and its gradient with respect to
  every scene scalar. Plain version: `loss_grad_fused_plain` (autograd).
  `loss_grad_adjoint_eager` runs the kernel's own hand-written adjoint,
  pixel for pixel, in eager torch: it is how the adjoint is tested on the
  CPU before it is trusted in CUDA.

The scene enters both kernels as one flat float32 vector in the leaf
order of `models.scene.tree_leaves` (`flatten_scene`); the kernels find
each leaf from the object and light counts alone (`flat_offsets`).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import dataclasses as dc
import math

import numpy as np
import torch

from ...models.scene import tree_leaves, tree_unflatten
from .. import vecmath as vm
from ..pipeline import (
    BIG,
    SHADOW_EPS,
    RenderConfig,
    camera_basis,
    intersect_rect,
    intersect_sphere,
    n_vis_planes,
    occluded,
    render_tile,
)
from ._build import Kernel

MAX_OBJECTS = 24
MAX_LIGHTS = 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GEOM = [_I, _I, _I, _I, _I, _I, _I]  # n_sph, n_rect, n_light, H, W, shadows, clip

FUSED_RENDER = Kernel("fused_render", {
    "rrt_render": ([_P, *_GEOM, _P, _P, _P], _I),
})
FUSED_STEP = Kernel("fused_step", {
    "rrt_step": ([_P, *_GEOM, _P, _F, _P, _P, _P], _I),
    "rrt_step_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
})
KERNELS = (FUSED_RENDER, FUSED_STEP)


# ---------------------------------------------------------------------------
# Flat scalar layout of a Scene
# ---------------------------------------------------------------------------


def scene_layout(scene_like):
    """([(start, shape)], total_size) for row-major flat packing in
    `tree_leaves` order."""
    meta, off = [], 0
    for leaf in tree_leaves(scene_like):
        shape = tuple(leaf.shape)
        meta.append((off, shape))
        off += int(np.prod(shape)) if shape else 1
    return meta, off


def flatten_scene(scene):
    """Scene -> flat (S,) vector (differentiable)."""
    return torch.cat([l.reshape(-1) for l in tree_leaves(scene)])


def unflatten_scene(scene_like, flat):
    """Inverse of `flatten_scene`: a Scene with the leaf shapes of
    ``scene_like`` whose values come from ``flat``."""
    meta, _ = scene_layout(scene_like)
    leaves = [flat[s:s + (int(np.prod(shape)) if shape else 1)].reshape(shape)
              for s, shape in meta]
    return tree_unflatten(scene_like, leaves)


def flat_offsets(n_sph: int, n_rect: int, n_light: int) -> dict:
    """Start of each leaf the kernels read, for an untextured scene without
    an environment map (``csrc/render_common.cuh`` computes the same)."""
    N, M, L = n_sph, n_rect, n_light
    R = 17 * N
    Lb = R + 22 * M
    C = Lb + 6 * L
    return {
        "s_center": 0, "s_radius": 3 * N, "s_color": 4 * N, "s_color2": 7 * N,
        "s_checker": 10 * N, "s_cscale": 11 * N, "s_ka": 12 * N, "s_kd": 13 * N,
        "s_ks": 14 * N, "s_shin": 15 * N,
        "r_origin": R, "r_eu": R + 3 * M, "r_ev": R + 6 * M, "r_color": R + 9 * M,
        "r_color2": R + 12 * M, "r_checker": R + 15 * M, "r_cscale": R + 16 * M,
        "r_ka": R + 17 * M, "r_kd": R + 18 * M, "r_ks": R + 19 * M, "r_shin": R + 20 * M,
        "l_pos": Lb, "l_col": Lb + 3 * L,
        "c_eye": C, "c_look": C + 3, "c_up": C + 6, "c_fov": C + 9,
        "ambient": C + 10, "background": C + 13, "S": C + 16,
    }


def uncovered(scene, cfg: RenderConfig):
    """What neither kernel family covers (a reason), or None."""
    if cfg.soft_tau > 0.0 or cfg.checker_tau > 0.0:
        return "soft_tau/checker_tau"
    if cfg.reflections:
        return "mirror reflections"
    if cfg.spp != 1:
        return f"spp={cfg.spp}"
    if cfg.shader != "phong":
        return f"the {cfg.shader} shader"
    if cfg.projection != "perspective":
        return f"the {cfg.projection} projection"
    if scene.spheres.textured or scene.rects.textured:
        return "object textures"
    if scene.env_mapped:
        return "environment maps"
    if scene.lights.count > MAX_LIGHTS:
        return f"more than {MAX_LIGHTS} lights"
    return None


def check_kernel_config(scene, cfg: RenderConfig) -> None:
    """Raise NotImplementedError for what the two kernels do not cover."""
    why = uncovered(scene, cfg)
    if why is None and scene.spheres.count + scene.rects.count > MAX_OBJECTS:
        why = f"more than {MAX_OBJECTS} objects"
    if why is not None:
        raise NotImplementedError(f"the CUDA kernels do not cover {why}")


def refuse_grad(scene, backward: str) -> None:
    """Raise when autograd would need a gradient of a CUDA render: grad mode
    is on and a scene leaf requires grad. ``backward`` names the render
    backward kernel that is not ported yet."""
    if torch.is_grad_enabled() and any(l.requires_grad for l in tree_leaves(scene)):
        raise NotImplementedError(
            f"render on CUDA carries no gradient: its backward ({backward}) is not ported "
            "yet. Render a scene whose leaves do not require grad (or under "
            "torch.no_grad()), or take the training step from ops.render.loss_and_grad_fn")


def _geometry(scene, cfg: RenderConfig):
    return [scene.spheres.count, scene.rects.count, scene.lights.count,
            cfg.height, cfg.width, int(cfg.shadows), int(cfg.clip)]


def _cuda_flat(scene, cfg):
    check_kernel_config(scene, cfg)
    if scene.ambient.dtype != torch.float32:
        raise ValueError(f"the kernels take float32 scenes, not {scene.ambient.dtype}")
    flat = flatten_scene(scene).detach().contiguous()
    off = flat_offsets(scene.spheres.count, scene.rects.count, scene.lights.count)
    if flat.numel() != off["S"]:
        raise ValueError(f"flat scene has {flat.numel()} scalars, layout expects {off['S']}")
    return flat


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Forward render kernel
# ---------------------------------------------------------------------------


def render_fused_plain(scene, cfg: RenderConfig):
    """`render_tile(return_vis=True)` in eager torch: the (H, W, 3) image
    and the (n_vis, H, W) visibility planes (`n_vis_planes` layout)."""
    (r, g, b), vis = render_tile(scene, cfg, 0, 0, cfg.height, cfg.width, return_vis=True)
    n_vis = n_vis_planes(scene, cfg)
    planes = (torch.stack(vis[:n_vis]) if n_vis
              else r.new_zeros((0, cfg.height, cfg.width)))
    return torch.stack([r, g, b], dim=-1), planes


def render_fused(scene, cfg: RenderConfig):
    """Image (H, W, 3) and visibility planes (n_vis, H, W). The forward
    kernel on CUDA, `render_fused_plain` on the CPU."""
    dev = scene.device
    if dev.type == "cpu":
        return render_fused_plain(scene, cfg)
    if dev.type != "cuda":
        raise NotImplementedError(f"no render kernel for device {dev}")
    refuse_grad(scene, "fused.py:252 _make_fused.bwd_kernel, the render backward")
    flat = _cuda_flat(scene, cfg)
    img = torch.empty((cfg.height, cfg.width, 3), device=dev)
    vis = torch.empty((n_vis_planes(scene, cfg), cfg.height, cfg.width), device=dev)
    FUSED_RENDER.call("rrt_render", flat.data_ptr(), *_geometry(scene, cfg),
                      img.data_ptr(), vis.data_ptr(), _stream(dev))
    FUSED_RENDER.launches += 1
    return img, vis


# ---------------------------------------------------------------------------
# Fused training-step kernel
# ---------------------------------------------------------------------------


def _loss_norm(cfg: RenderConfig, loss: str) -> float:
    if loss == "mse":
        return 1.0 / (cfg.height * cfg.width * 3)
    if loss == "sum":
        return 1.0
    raise ValueError(f"the step kernel takes loss 'mse' or 'sum', not {loss!r}")


def _check_target(target, cfg: RenderConfig, scene) -> None:
    """The target must be (H, W, 3) on the scene's device, in its dtype
    (float32 for the kernel; the plain versions also take float64)."""
    if tuple(target.shape) != (cfg.height, cfg.width, 3):
        raise ValueError(f"target shape {tuple(target.shape)} != {(cfg.height, cfg.width, 3)}")
    want = (scene.device, scene.ambient.dtype)
    if (target.device, target.dtype) != want:
        raise ValueError(f"target must be {want[1]} on {want[0]}, "
                         f"got {target.dtype} on {target.device}")


def loss_grad_fused(scene, cfg: RenderConfig, target, loss: str = "mse"):
    """``(norm * sq_sum, grads as a Scene)`` of the squared error between
    the render of ``scene`` and ``target``, with ``norm`` = 1/(H*W*3) for
    mse and 1 for sum. One step-kernel launch on CUDA; autograd over the
    eager renderer on the CPU."""
    dev = scene.device
    norm = _loss_norm(cfg, loss)
    _check_target(target, cfg, scene)
    if dev.type == "cpu":
        return loss_grad_fused_plain(scene, cfg, target, loss)
    if dev.type != "cuda":
        raise NotImplementedError(f"no step kernel for device {dev}")
    flat = _cuda_flat(scene, cfg)
    target = target.contiguous()
    geom = _geometry(scene, cfg)
    n_scratch = FUSED_STEP.lib().rrt_step_scratch_floats(*geom[:5])
    scratch = torch.empty((n_scratch,), device=dev)
    out = torch.empty((1 + flat.numel(),), device=dev)
    FUSED_STEP.call("rrt_step", flat.data_ptr(), *geom, target.data_ptr(),
                    norm, scratch.data_ptr(), out.data_ptr(), _stream(dev))
    FUSED_STEP.launches += 1
    return norm * out[0], unflatten_scene(scene, out[1:])


def loss_grad_fused_plain(scene, cfg: RenderConfig, target, loss: str = "mse"):
    """torch.autograd of ``loss(render_eager(scene), target)``."""
    from ..render import render_eager

    return autograd_loss_grad(render_eager, scene, cfg, target, loss)


def autograd_loss_grad(render_fn, scene, cfg: RenderConfig, target, loss: str = "mse"):
    """``(loss, grads as a Scene)`` of ``loss(render_fn(scene, cfg), target)``
    by torch autograd (the plain version of a step kernel)."""
    from ..render import LOSSES

    leaves = [l.detach().clone().requires_grad_(True) for l in tree_leaves(scene)]
    with torch.enable_grad():
        value = LOSSES[loss](render_fn(tree_unflatten(scene, leaves), cfg), target)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g for l, g in zip(leaves, grads)]
    return value.detach(), tree_unflatten(scene, grads)


# ---------------------------------------------------------------------------
# The step kernel's hand-written adjoint, in eager torch
# ---------------------------------------------------------------------------


def _maxgrad(x):
    """d max(x, 0)/dx with the tie split of jnp.maximum."""
    return torch.where(x > 0.0, 1.0, torch.where(x == 0.0, 0.5, 0.0))


def _clipgrad(x):
    """d clip(x, 0, 1)/dx (maximum then minimum, ties split)."""
    m = torch.clamp_min(x, 0.0)
    return _maxgrad(x) * torch.where(m < 1.0, 1.0, torch.where(m == 1.0, 0.5, 0.0))


def _normalize_adjoint(a, inv, n2, g):
    """Cotangent of ``a`` for ``normalize(a) = a * inv`` (guarded rsqrt),
    given the cotangent ``g`` of the result."""
    live = n2 > 1e-12
    k = torch.where(live, vm.vdot(g, a) * inv * inv * inv, 0.0)
    return tuple(gc * inv - k * ac for gc, ac in zip(g, a))


def camera_adjoint(cam, g_fwd, g_right, g_up, g_tan):
    """Pull the summed cotangents of the ray basis (fwd, right, up) and of
    tan(fov/2) back to (eye, look_at, up, fov_deg). The step kernel's last
    pass runs the same chain once per step."""
    eye, look, uph = vm.splat(cam.eye), vm.splat(cam.look_at), vm.splat(cam.up)
    f_raw = vm.vsub(look, eye)
    n2f = vm.vdot(f_raw, f_raw)
    invf = torch.rsqrt(torch.where(n2f > 1e-12, n2f, 1.0))
    fwd = vm.vscale(f_raw, invf)
    r_raw = vm.vcross(fwd, uph)
    n2r = vm.vdot(r_raw, r_raw)
    invr = torch.rsqrt(torch.where(n2r > 1e-12, n2r, 1.0))
    right = vm.vscale(r_raw, invr)
    # up = right x fwd
    g_right = vm.vadd(g_right, vm.vcross(fwd, g_up))
    g_fwd = vm.vadd(g_fwd, vm.vcross(g_up, right))
    g_rraw = _normalize_adjoint(r_raw, invr, n2r, g_right)
    g_fwd = vm.vadd(g_fwd, vm.vcross(uph, g_rraw))
    g_uph = vm.vcross(g_rraw, fwd)
    g_fraw = _normalize_adjoint(f_raw, invf, n2f, g_fwd)
    tanf = torch.tan(cam.fov_deg * (math.pi / 180.0) * 0.5)
    g_fov = g_tan * (1.0 + tanf * tanf) * 0.5 * (math.pi / 180.0)
    return (torch.stack(vm.vneg(g_fraw)), torch.stack(g_fraw), torch.stack(g_uph), g_fov)


def loss_grad_adjoint_eager(scene, cfg: RenderConfig, target, loss: str = "mse"):
    """The step kernel's algorithm in eager torch, vectorized over pixels:
    forward with the winner index per pixel, residual, shade adjoint, the
    winning object's adjoint, the per-pixel camera adjoint, and the
    reduction (camera chain applied once at the end). Same contract as
    `loss_grad_fused`."""
    check_kernel_config(scene, cfg)
    norm = _loss_norm(cfg, loss)
    _check_target(target, cfg, scene)
    with torch.no_grad():
        return _adjoint(scene, cfg, target, norm, nearest=_nearest_chain, occluded_fn=occluded)


def _nearest_chain(scene, o, d):
    """(t, k) of every ray's nearest hit by the first-wins where chain:
    spheres 0..N-1, rects N..N+M-1, -1 on a miss."""
    sp, rc = scene.spheres, scene.rects
    N = sp.count
    t_best = torch.full(o[0].shape, BIG, device=scene.device, dtype=scene.ambient.dtype)
    kbest = torch.full(o[0].shape, -1, dtype=torch.long, device=scene.device)
    for k in range(N):
        t = intersect_sphere(o, d, sp.center[k], sp.radius[k])
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        kbest = torch.where(closer, k, kbest)
    for k in range(rc.count):
        t, _, _, _ = intersect_rect(o, d, rc.origin[k], rc.edge_u[k], rc.edge_v[k])
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        kbest = torch.where(closer, N + k, kbest)
    return t_best, kbest


def _adjoint(scene, cfg, target, norm, nearest, occluded_fn):
    """The per-pixel step adjoint; ``nearest(scene, o, d) -> (t, k)`` and
    ``occluded_fn`` are the trace's nearest hit and any-hit test."""
    dev = scene.device
    H, W = cfg.height, cfg.width
    sp, rc, lt, cam = scene.spheres, scene.rects, scene.lights, scene.camera
    N, M, L = sp.count, rc.count, lt.count
    like = dict(device=dev, dtype=scene.ambient.dtype)
    zero = torch.zeros((H, W), **like)

    # ---- forward: camera ray (perspective), kept with its intermediates
    right, up, fwd = camera_basis(cam)
    tanf = torch.tan(cam.fov_deg * (math.pi / 180.0) * 0.5)
    aspect = W / H
    ii = torch.arange(H, **like)[:, None].expand(H, W)
    jj = torch.arange(W, **like)[None, :].expand(H, W)
    ax = (jj + 0.5) * (2.0 / W) - 1.0
    ay = 1.0 - (ii + 0.5) * (2.0 / H)
    sx = ax * tanf * aspect
    sy = ay * tanf
    dt = vm.vadd(fwd, vm.vadd(vm.vscale(right, sx), vm.vscale(up, sy)))
    n2d = vm.vdot(dt, dt)
    inv_d = torch.rsqrt(torch.where(n2d > 1e-12, n2d, 1.0))
    d = vm.vscale(dt, inv_d)
    o = vm.vbroadcast(vm.splat(cam.eye), (H, W))

    # ---- nearest hit: winner index kbest (spheres 0..N-1, rects N..N+M-1)
    t_best, kbest = nearest(scene, o, d)
    t = t_best
    is_sph = (kbest >= 0) & (kbest < N)
    is_rct = kbest >= N
    hit = is_sph | is_rct

    # ---- winner attributes (gathered by kbest)
    ks_ = kbest.clamp(0, max(N - 1, 0))
    kr_ = (kbest - N).clamp(0, max(M - 1, 0))

    def gather(leaf, idx, fill=0.0):
        if leaf.shape[0] == 0:
            return zero + fill if leaf.dim() == 1 else (zero + fill,) * 3
        g = leaf[idx]
        return g if leaf.dim() == 1 else (g[..., 0], g[..., 1], g[..., 2])

    sc = gather(sp.center, ks_)
    sr = gather(sp.radius, ks_, 1.0)
    p = vm.vadd(o, vm.vscale(d, t))
    s_pl = vm.vsub(p, sc)
    s_invr = 1.0 / sr
    s_n = vm.vscale(s_pl, s_invr)
    s_par = torch.remainder(sum(torch.floor(c * gather(sp.material.checker_scale, ks_))
                                for c in s_pl), 2.0)
    s_use2 = gather(sp.material.checker, ks_) * s_par > 0.5

    p0 = gather(rc.origin, kr_)
    eu = gather(rc.edge_u, kr_)
    ev = gather(rc.edge_v, kr_)
    nraw = vm.vcross(eu, ev)
    nn2 = vm.vdot(nraw, nraw)
    inv_n = torch.rsqrt(torch.where(nn2 > 1e-12, nn2, 1.0))
    nu = vm.vscale(nraw, inv_n)
    facing = torch.where(vm.vdot(nu, d) < 0.0, 1.0, -1.0)
    r_n = vm.vscale(nu, facing)
    rel = vm.vsub(p, p0)
    ra = vm.vdot(rel, eu) * (1.0 / vm.vdot(eu, eu))
    rb = vm.vdot(rel, ev) * (1.0 / vm.vdot(ev, ev))
    r_cs = gather(rc.material.checker_scale, kr_)
    r_par = torch.remainder(torch.floor(ra * r_cs) + torch.floor(rb * r_cs), 2.0)
    r_use2 = gather(rc.material.checker, kr_) * r_par > 0.5

    def pick(sv, rv, miss):
        return torch.where(is_sph, sv, torch.where(is_rct, rv, miss))

    def mat(name, miss=0.0):
        return pick(gather(getattr(sp.material, name), ks_),
                    gather(getattr(rc.material, name), kr_), zero + miss)

    n = tuple(pick(a, b, zero) for a, b in zip(s_n, r_n))
    use2 = torch.where(is_sph, s_use2, r_use2)
    base = tuple(pick(torch.where(s_use2, a2, a1), torch.where(r_use2, b2, b1), zero)
                 for a1, a2, b1, b2 in zip(gather(sp.material.color, ks_),
                                           gather(sp.material.color2, ks_),
                                           gather(rc.material.color, kr_),
                                           gather(rc.material.color2, kr_)))
    ka, kd, ksp, shin = mat("ka"), mat("kd"), mat("ks"), mat("shininess", 1.0)

    # ---- shade forward
    amb = vm.splat(scene.ambient)
    col = vm.vscale(vm.vmul(base, amb), ka)
    view = vm.vneg(d)
    so = vm.vadd(vm.vadd(o, vm.vscale(d, t)), vm.vscale(n, SHADOW_EPS))
    per_light = []
    for li in range(L):
        lpos, lcol = vm.splat(lt.position[li]), vm.splat(lt.color[li])
        lvec = vm.vsub(lpos, so)
        dist2 = vm.vdot(lvec, lvec)
        dist = torch.sqrt(torch.where(dist2 > 0.0, dist2, 1.0))
        inv_l = 1.0 / torch.where(dist > 1e-9, dist, 1.0)
        ldir = vm.vscale(lvec, inv_l)
        vis = (torch.where(occluded_fn(scene, so, ldir, dist), 0.0, 1.0)
               if cfg.shadows else zero + 1.0)
        ndl = vm.vdot(n, ldir)
        ndotl = vm.vmax0(ndl)
        refl = vm.vsub(vm.vscale(n, 2.0 * ndotl), ldir)
        rdv = vm.vdot(refl, view)
        rdotv = vm.vmax0(rdv)
        pw = vm.safe_pow(rdotv, shin)
        spec = ksp * pw
        q = tuple(kd * ndotl * base[c] + spec for c in range(3))
        col = vm.vadd(col, tuple(vis * q[c] * lcol[c] for c in range(3)))
        per_light.append((lvec, dist2, dist, inv_l, ldir, vis, ndl, ndotl, refl,
                          rdv, rdotv, pw, q, lcol))
    bg = vm.splat(scene.background)
    pre = tuple(torch.where(hit, c, b) for c, b in zip(col, bg))
    img = tuple(vm.clip01(c) for c in pre) if cfg.clip else pre

    # ---- residual and loss
    resid = tuple(img[c] - target[..., c] for c in range(3))
    sq = sum(torch.sum(r * r) for r in resid)
    gc = tuple(2.0 * norm * r * (_clipgrad(p_) if cfg.clip else 1.0)
               for r, p_ in zip(resid, pre))

    # ---- shade adjoint (hit pixels; everything below is masked by hit)
    gh = tuple(torch.where(hit, g, 0.0) for g in gc)
    g_bg = tuple(torch.sum(torch.where(hit, 0.0, g)) for g in gc)
    g_base = tuple(gh[c] * amb[c] * ka for c in range(3))
    g_amb = tuple(torch.sum(gh[c] * base[c] * ka) for c in range(3))
    g_ka = sum(gh[c] * base[c] * amb[c] for c in range(3))
    g_kd, g_ks, g_shin = zero, zero, zero
    g_n, g_d, g_so = (zero,) * 3, (zero,) * 3, (zero,) * 3
    g_lpos, g_lcol = [], []
    for (lvec, dist2, dist, inv_l, ldir, vis, ndl, ndotl, refl, rdv, rdotv, pw, q,
         lcol) in per_light:
        g_lcol.append(tuple(torch.sum(gh[c] * vis * q[c]) for c in range(3)))
        g_q = tuple(gh[c] * vis * lcol[c] for c in range(3))
        g_spec = g_q[0] + g_q[1] + g_q[2]
        g_kd = g_kd + sum(g_q[c] * ndotl * base[c] for c in range(3))
        g_ndotl = sum(g_q[c] * kd * base[c] for c in range(3))
        g_base = tuple(g_base[c] + g_q[c] * kd * ndotl for c in range(3))
        g_ks = g_ks + g_spec * pw
        g_pw = g_spec * ksp
        pos = rdotv > 0.0
        safe_r = torch.where(pos, rdotv, 1.0)
        g_rdotv = torch.where(pos, g_pw * pw * shin / safe_r, 0.0)
        g_shin = g_shin + torch.where(pos, g_pw * pw * torch.log(safe_r), 0.0)
        g_rdv = g_rdotv * _maxgrad(rdv)
        g_refl = vm.vscale(view, g_rdv)
        g_d = vm.vsub(g_d, vm.vscale(refl, g_rdv))
        g_n = vm.vadd(g_n, vm.vscale(g_refl, 2.0 * ndotl))
        g_ndotl = g_ndotl + 2.0 * vm.vdot(g_refl, n)
        g_ldir = vm.vneg(g_refl)
        g_ndl = g_ndotl * _maxgrad(ndl)
        g_n = vm.vadd(g_n, vm.vscale(ldir, g_ndl))
        g_ldir = vm.vadd(g_ldir, vm.vscale(n, g_ndl))
        g_lvec = vm.vscale(g_ldir, inv_l)
        g_inv = vm.vdot(g_ldir, lvec)
        g_dist = torch.where(dist > 1e-9, -g_inv * inv_l * inv_l, 0.0)
        g_dist2 = torch.where(dist2 > 0.0, g_dist * 0.5 / dist, 0.0)
        g_lvec = vm.vadd(g_lvec, vm.vscale(lvec, 2.0 * g_dist2))
        g_lpos.append(tuple(torch.sum(g) for g in g_lvec))
        g_so = vm.vsub(g_so, g_lvec)
    # so = (o + d t) + n * SHADOW_EPS
    g_o = g_so
    g_d = vm.vadd(g_d, vm.vscale(g_so, t))
    g_t = vm.vdot(g_so, d)
    g_n = vm.vadd(g_n, vm.vscale(g_so, SHADOW_EPS))

    # ---- winning sphere: n = (o + d t - c) / r, t = -b - sqrt(b^2 - |oc|^2 + r^2)
    g_pl = vm.vscale(g_n, s_invr)
    g_r = -vm.vdot(g_n, s_pl) * s_invr * s_invr
    s_go = g_pl
    s_gd = vm.vscale(g_pl, t)
    s_gt = g_t + vm.vdot(g_pl, d)
    g_c = vm.vneg(g_pl)
    oc = vm.vsub(o, sc)
    b = vm.vdot(oc, d)
    disc = b * b - (vm.vdot(oc, oc) - sr * sr)
    g_b = -s_gt
    g_disc = torch.where(disc > 0.0, -s_gt * 0.5 / torch.sqrt(torch.where(disc > 0.0, disc, 1.0)), 0.0)
    g_b = g_b + g_disc * 2.0 * b
    g_cc = -g_disc
    g_oc = vm.vadd(vm.vscale(oc, 2.0 * g_cc), vm.vscale(d, g_b))
    g_r = g_r - g_cc * 2.0 * sr
    s_gd = vm.vadd(s_gd, vm.vscale(oc, g_b))
    s_go = vm.vadd(s_go, g_oc)
    g_c = vm.vsub(g_c, g_oc)

    # ---- winning rect: t = dot(p0 - o, nraw) / dot(d, nraw), n = facing * normalize(nraw)
    denom = vm.vdot(d, nraw)
    denom = torch.where(is_rct, denom, 1.0)
    num = vm.vdot(vm.vsub(p0, o), nraw)
    g_num = g_t / denom
    g_den = -g_t * num / (denom * denom)
    g_p0 = vm.vscale(nraw, g_num)
    r_go = vm.vneg(g_p0)
    g_nraw = vm.vscale(vm.vsub(p0, o), g_num)
    r_gd = vm.vscale(nraw, g_den)
    g_nraw = vm.vadd(g_nraw, vm.vscale(d, g_den))
    g_nraw = vm.vadd(g_nraw, _normalize_adjoint(nraw, inv_n, nn2, vm.vscale(g_n, facing)))
    g_eu = vm.vcross(ev, g_nraw)
    g_ev = vm.vcross(g_nraw, eu)

    g_o = tuple(g_o[c] + pick(s_go[c], r_go[c], zero) for c in range(3))
    g_d = tuple(g_d[c] + pick(s_gd[c], r_gd[c], zero) for c in range(3))

    # ---- camera: d = normalize(fwd + right sx + up sy), o = eye
    g_dt = _normalize_adjoint(dt, inv_d, n2d, tuple(torch.where(hit, g, 0.0) for g in g_d))
    G_fwd = tuple(torch.sum(g) for g in g_dt)
    G_right = tuple(torch.sum(g * sx) for g in g_dt)
    G_up = tuple(torch.sum(g * sy) for g in g_dt)
    G_tan = torch.sum(vm.vdot(g_dt, right) * ax * aspect + vm.vdot(g_dt, up) * ay)
    g_eye, g_look, g_uph, g_fov = camera_adjoint(cam, G_fwd, G_right, G_up, G_tan)
    g_eye = g_eye + torch.stack([torch.sum(torch.where(hit, g, 0.0)) for g in g_o])

    # ---- reduction into the scene's leaves
    def winner_rows(count, idx, mask, vals):
        """Sum per-pixel values into the row of each pixel's winner."""
        v = torch.stack([torch.where(mask, x, 0.0) for x in vals], dim=-1)
        out = torch.zeros((count, len(vals)), **like)
        return out.index_add_(0, idx.reshape(-1), v.reshape(-1, len(vals)))

    def material_grads(mat_like, count, idx, mask):
        rows = winner_rows(count, idx, mask, [g_ka, g_kd, g_ks, g_shin])
        return dc.replace(mat_like,
                          color=winner_rows(count, idx, mask & ~use2, g_base),
                          color2=winner_rows(count, idx, mask & use2, g_base),
                          ka=rows[:, 0], kd=rows[:, 1], ks=rows[:, 2], shininess=rows[:, 3])

    grads = tree_unflatten(scene, [torch.zeros_like(l) for l in tree_leaves(scene)])
    spheres, rects = grads.spheres, grads.rects
    if N:
        spheres = dc.replace(spheres, center=winner_rows(N, ks_, is_sph, g_c),
                             radius=winner_rows(N, ks_, is_sph, [g_r])[:, 0],
                             material=material_grads(spheres.material, N, ks_, is_sph))
    if M:
        rects = dc.replace(rects, origin=winner_rows(M, kr_, is_rct, g_p0),
                           edge_u=winner_rows(M, kr_, is_rct, g_eu),
                           edge_v=winner_rows(M, kr_, is_rct, g_ev),
                           material=material_grads(rects.material, M, kr_, is_rct))
    lights = grads.lights
    if L:
        lights = dc.replace(lights, position=torch.stack([torch.stack(g) for g in g_lpos]),
                            color=torch.stack([torch.stack(g) for g in g_lcol]))
    camera = dc.replace(grads.camera, eye=g_eye, look_at=g_look, up=g_uph, fov_deg=g_fov)
    grads = dc.replace(grads, spheres=spheres, rects=rects, lights=lights, camera=camera,
                       ambient=torch.stack(g_amb), background=torch.stack(g_bg))
    return norm * sq, grads
