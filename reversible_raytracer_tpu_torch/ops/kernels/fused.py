"""The CUDA kernels of scenes of at most 24 objects, their wrappers and
their plain versions.

- `render_fused`: the forward render kernel (``csrc/fused_render.cu``),
  replacing the TPU kernel ``_make_fused.fwd_kernel``
  (reversible_raytracer_tpu/ops/kernels/fused.py:224). It writes the
  (H, W, 3) image and the shadow-visibility planes. Plain version:
  `render_fused_plain`. On CUDA the image is differentiable: `_FusedRender`
  pairs this kernel with the render backward, as the JAX package's
  ``custom_vjp`` (fused.py:297-311) pairs its two.
- the render backward kernel (``csrc/fused_render_bwd.cu``), replacing
  ``_make_fused.bwd_kernel`` (fused.py:252, pallas_call at :281), launched
  only by `_FusedRender.backward`. It pulls the cotangent of the image back
  to every scene scalar, reading the forward's visibility planes instead of
  casting shadow rays. Plain version: `render_fused_bwd_plain` (autograd);
  `render_bwd_adjoint_eager` runs its hand-written adjoint in eager torch.
- `loss_grad_fused`: the fused training-step kernel (``csrc/fused_step.cu``),
  replacing ``_make_loss_grad.kernel`` (fused.py:394). One launch gives the
  squared-error loss against a target and its gradient with respect to
  every scene scalar. Plain version: `loss_grad_fused_plain` (autograd).
  `loss_grad_adjoint_eager` runs the kernel's own hand-written adjoint,
  pixel for pixel, in eager torch: it is how the adjoint is tested on the
  CPU before it is trusted in CUDA. The step and the render backward share
  that adjoint (`_adjoint`); they differ in where the image's cotangent
  comes from (a residual against a target, or the caller) and where the
  visibility comes from (shadow rays, or the forward's planes).

The scene enters the kernels as one flat float32 vector in the leaf
order of `models.scene.tree_leaves` (`flatten_scene`); the kernels find
each leaf from the object and light counts alone (`flat_offsets`).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import dataclasses as dc
import math
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ...models.scene import tree_leaves, tree_unflatten
from .. import vecmath as vm
from ..pipeline import (
    BIG,
    SHADOW_EPS,
    T_EPS,
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
FUSED_RENDER_BWD = Kernel("fused_render_bwd", {
    "rrt_render_bwd": ([_P, *_GEOM, _P, _P, _P, _P, _P], _I),
    "rrt_render_bwd_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
})
KERNELS = (FUSED_RENDER, FUSED_STEP, FUSED_RENDER_BWD)


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


def _scratch(kernel: Kernel, entry: str, dims, dev):
    """The partial rows a step or backward call writes, sized for this
    card's grid (``dims``: the entry's scene counts and image size)."""
    n = getattr(kernel.lib(), entry)(*dims)
    if n <= 0:
        raise RuntimeError(f"{kernel.name}: the card's SM count could not be read")
    return torch.empty((n,), device=dev)


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
    kernel on CUDA, `render_fused_plain` on the CPU: the same image to the
    bit, the same planes where the ray hit an object; where it hit nothing
    the kernel's planes are 0 (the plain version's hold the shadow test of a
    ray from the BIG sentinel; the render backward reads neither). The image
    carries the scene's gradient on both: on CUDA through the render
    backward kernel (the planes carry none)."""
    dev = scene.device
    if dev.type == "cpu":
        return render_fused_plain(scene, cfg)
    if dev.type != "cuda":
        raise NotImplementedError(f"no render kernel for device {dev}")
    return _FusedRender.apply(scene, cfg, *tree_leaves(scene))


class _FusedRender(torch.autograd.Function):
    """The forward kernel and the render backward kernel as one
    differentiable function of the scene's leaves (the ``custom_vjp`` of
    fused.py:297-311): the forward saves the flat scene and the visibility
    planes, the backward launches the backward kernel once."""

    @staticmethod
    def forward(ctx, scene, cfg, *leaves):
        flat = _cuda_flat(scene, cfg)
        img = torch.empty((cfg.height, cfg.width, 3), device=flat.device)
        vis = torch.empty((n_vis_planes(scene, cfg), cfg.height, cfg.width), device=flat.device)
        FUSED_RENDER.call("rrt_render", flat.data_ptr(), *_geometry(scene, cfg),
                          img.data_ptr(), vis.data_ptr(), _stream(flat.device))
        FUSED_RENDER.launches += 1
        ctx.scene, ctx.cfg = scene, cfg
        ctx.save_for_backward(flat, vis)
        ctx.mark_non_differentiable(vis)
        ctx.set_materialize_grads(False)
        return img, vis

    @staticmethod
    @once_differentiable
    def backward(ctx, g_img, _g_vis):
        flat, vis = ctx.saved_tensors
        if g_img is None:
            return (None, None, *(None for _ in tree_leaves(ctx.scene)))
        dflat = _render_bwd_launch(ctx.scene, ctx.cfg, flat, g_img, vis)
        return (None, None, *tree_leaves(unflatten_scene(ctx.scene, dflat)))


# ---------------------------------------------------------------------------
# Render backward kernel
# ---------------------------------------------------------------------------


def cotangent_f32(g_img, cfg: RenderConfig):
    """The image cotangent as the kernels read it: (H, W, 3), contiguous
    float32 (autograd may hand over an expanded or strided view)."""
    if tuple(g_img.shape) != (cfg.height, cfg.width, 3):
        raise ValueError(f"cotangent shape {tuple(g_img.shape)} != {(cfg.height, cfg.width, 3)}")
    return g_img.to(torch.float32).contiguous()


def _render_bwd_launch(scene_like, cfg, flat, g_img, vis):
    """d flat (S,) from one backward-kernel call."""
    dev = flat.device
    g_img = cotangent_f32(g_img, cfg)
    geom = _geometry(scene_like, cfg)
    scratch = _scratch(FUSED_RENDER_BWD, "rrt_render_bwd_scratch_floats", geom[:5], dev)
    out = torch.empty((1 + flat.numel(),), device=dev)
    FUSED_RENDER_BWD.call("rrt_render_bwd", flat.data_ptr(), *geom, g_img.data_ptr(),
                          vis.data_ptr(), scratch.data_ptr(), out.data_ptr(), _stream(dev))
    FUSED_RENDER_BWD.launches += 1
    return out[1:]


def render_fused_bwd_plain(scene, cfg: RenderConfig, g_img):
    """torch.autograd of `render_eager` for the image cotangent ``g_img``."""
    from ..render import render_eager

    return autograd_vjp(render_eager, scene, cfg, g_img)


# ---------------------------------------------------------------------------
# Fused training-step kernel
# ---------------------------------------------------------------------------


def _loss_norm(cfg: RenderConfig, loss: str) -> float:
    if loss == "mse":
        return 1.0 / (cfg.height * cfg.width * 3)
    if loss == "sum":
        return 1.0
    raise ValueError(f"the step kernel takes loss 'mse' or 'sum', not {loss!r}")


def _check_target(target, cfg: RenderConfig, scene, what: str = "target") -> None:
    """The target (or an image cotangent) must be (H, W, 3) on the scene's
    device, in its dtype (float32 for the kernel; the plain versions also
    take float64)."""
    if tuple(target.shape) != (cfg.height, cfg.width, 3):
        raise ValueError(f"{what} shape {tuple(target.shape)} != {(cfg.height, cfg.width, 3)}")
    want = (scene.device, scene.ambient.dtype)
    if (target.device, target.dtype) != want:
        raise ValueError(f"{what} must be {want[1]} on {want[0]}, "
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
    scratch = _scratch(FUSED_STEP, "rrt_step_scratch_floats", geom[:5], dev)
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


def autograd_vjp(render_fn, scene, cfg: RenderConfig, g_img):
    """The scene's gradient (a Scene) of ``render_fn(scene, cfg)`` for the
    image cotangent ``g_img``, by torch autograd (the plain version of a
    render backward kernel)."""
    leaves = [l.detach().clone().requires_grad_(True) for l in tree_leaves(scene)]
    with torch.enable_grad():
        img = render_fn(tree_unflatten(scene, leaves), cfg)
        grads = torch.autograd.grad(img, leaves, g_img.to(img.dtype), allow_unused=True)
    return tree_unflatten(scene, [torch.zeros_like(l) if g is None else g
                                  for l, g in zip(leaves, grads)])


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
        sq, grads = _adjoint(scene, cfg, _nearest_chain, residual_cotangent(target, norm),
                             traced_visibility(scene, cfg, occluded))
    return norm * sq, grads


def render_bwd_adjoint_eager(scene, cfg: RenderConfig, g_img, vis):
    """The render backward kernel's algorithm in eager torch: the step's
    adjoint (`_adjoint`) with the image cotangent ``g_img`` (H, W, 3) in
    place of the residual and the forward's visibility planes ``vis`` in
    place of the shadow rays: the scene's gradient (a Scene)."""
    check_kernel_config(scene, cfg)
    _check_target(g_img, cfg, scene, "cotangent")
    with torch.no_grad():
        return _adjoint(scene, cfg, _nearest_chain, image_cotangent(g_img),
                        saved_visibility(cfg, vis))[1]


def residual_cotangent(target, norm):
    """The step's source of the image cotangent: ``img -> (2 norm (img -
    target) per channel, sum of squared residuals)``."""
    def cotangent(img):
        resid = tuple(img[c] - target[..., c] for c in range(3))
        return tuple(2.0 * norm * r for r in resid), sum(torch.sum(r * r) for r in resid)
    return cotangent


def image_cotangent(g_img):
    """The render backward's source of the image cotangent: the caller's
    (H, W, 3) ``g_img``, whatever the image; no squared error (0)."""
    return lambda img: (tuple(g_img[..., c] for c in range(3)), 0.0)


def traced_visibility(scene, cfg: RenderConfig, occluded_fn):
    """The step's visibility of light ``li``: a shadow ray from the shadow
    origin toward it, tested by ``occluded_fn`` (1 everywhere without
    shadows)."""
    def visibility(li, so, f, zero, hit):
        if not cfg.shadows:
            return zero + 1.0
        return torch.where(occluded_fn(scene, so, f.ldir, f.dist), 0.0, 1.0)
    return visibility


def saved_visibility(cfg: RenderConfig, vis):
    """The render backward's visibility of light ``li``: the forward's plane
    (`n_vis_planes` layout; a miss pixel's value is never used, as its
    cotangents are masked to zero)."""
    if tuple(vis.shape[1:]) != (cfg.height, cfg.width):
        raise ValueError(f"visibility planes {tuple(vis.shape)} do not fit "
                         f"{(cfg.height, cfg.width)}")
    return lambda li, so, f, zero, hit: vis[li].to(zero.dtype) if cfg.shadows else zero + 1.0


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


def primary_ray_terms(scene, cfg: RenderConfig):
    """The perspective primary rays with the intermediates their adjoint
    needs: o = eye, d = normalize(dt), dt = fwd + right sx + up sy."""
    H, W = cfg.height, cfg.width
    like = dict(device=scene.device, dtype=scene.ambient.dtype)
    right, up, fwd = camera_basis(scene.camera)
    tanf = torch.tan(scene.camera.fov_deg * (math.pi / 180.0) * 0.5)
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
    return SimpleNamespace(o=vm.vbroadcast(vm.splat(scene.camera.eye), (H, W)),
                           d=vm.vscale(dt, inv_d), dt=dt, n2d=n2d, inv_d=inv_d, ax=ax, ay=ay,
                           sx=sx, sy=sy, aspect=aspect, right=right, up=up)


def camera_grads(cam, ray, g_o, g_d):
    """(eye, look_at, up, fov_deg) cotangents from the per-pixel cotangents
    of the ray origin and direction (zero where nothing was hit)."""
    g_dt = _normalize_adjoint(ray.dt, ray.inv_d, ray.n2d, g_d)
    G_fwd = tuple(torch.sum(g) for g in g_dt)
    G_right = tuple(torch.sum(g * ray.sx) for g in g_dt)
    G_up = tuple(torch.sum(g * ray.sy) for g in g_dt)
    G_tan = torch.sum(vm.vdot(g_dt, ray.right) * ray.ax * ray.aspect
                      + vm.vdot(g_dt, ray.up) * ray.ay)
    g_eye, g_look, g_uph, g_fov = camera_adjoint(cam, G_fwd, G_right, G_up, G_tan)
    return g_eye + torch.stack([torch.sum(g) for g in g_o]), g_look, g_uph, g_fov


def light_terms(lights, li: int, so, n, d, base, kd, ksp, shin):
    """Light ``li``'s geometry from the shadow origin ``so`` and its
    unshadowed Phong term q (per colour channel), with intermediates."""
    f = SimpleNamespace(lcol=vm.splat(lights.color[li]))
    f.lvec = vm.vsub(vm.splat(lights.position[li]), so)
    f.dist2 = vm.vdot(f.lvec, f.lvec)
    f.dist = torch.sqrt(torch.where(f.dist2 > 0.0, f.dist2, 1.0))
    f.inv_l = 1.0 / torch.where(f.dist > 1e-9, f.dist, 1.0)
    f.ldir = vm.vscale(f.lvec, f.inv_l)
    f.ndl = vm.vdot(n, f.ldir)
    f.ndotl = vm.vmax0(f.ndl)
    f.refl = vm.vsub(vm.vscale(n, 2.0 * f.ndotl), f.ldir)
    f.rdv = vm.vdot(f.refl, vm.vneg(d))
    f.rdotv = vm.vmax0(f.rdv)
    f.pw = vm.safe_pow(f.rdotv, shin)
    spec = ksp * f.pw
    f.q = tuple(kd * f.ndotl * base[c] + spec for c in range(3))
    return f


def light_adjoint(f, gh, vis, n, d, base, kd, ksp, shin):
    """Per-pixel cotangents of light ``f``'s term vis * q * lcol, given the
    colour cotangent ``gh``: of lcol, vis, kd, ks, shin, base, n, d and the
    light direction."""
    view = vm.vneg(d)
    g = SimpleNamespace(lcol=tuple(gh[c] * vis * f.q[c] for c in range(3)),
                        vis=sum(gh[c] * f.q[c] * f.lcol[c] for c in range(3)))
    g_q = tuple(gh[c] * vis * f.lcol[c] for c in range(3))
    g_spec = g_q[0] + g_q[1] + g_q[2]
    g.kd = sum(g_q[c] * f.ndotl * base[c] for c in range(3))
    g_ndotl = sum(g_q[c] * kd * base[c] for c in range(3))
    g.base = tuple(g_q[c] * kd * f.ndotl for c in range(3))
    g.ks = g_spec * f.pw
    g_pw = g_spec * ksp
    pos = f.rdotv > 0.0
    safe_r = torch.where(pos, f.rdotv, 1.0)
    g_rdotv = torch.where(pos, g_pw * f.pw * shin / safe_r, 0.0)
    g.shin = torch.where(pos, g_pw * f.pw * torch.log(safe_r), 0.0)
    g_rdv = g_rdotv * _maxgrad(f.rdv)
    g_refl = vm.vscale(view, g_rdv)
    g.d = vm.vneg(vm.vscale(f.refl, g_rdv))
    g_ndotl = g_ndotl + 2.0 * vm.vdot(g_refl, n)
    g_ndl = g_ndotl * _maxgrad(f.ndl)
    g.n = vm.vadd(vm.vscale(g_refl, 2.0 * f.ndotl), vm.vscale(f.ldir, g_ndl))
    g.ldir = vm.vsub(vm.vscale(n, g_ndl), g_refl)
    return g


def light_geometry_adjoint(f, g_ldir):
    """Cotangent of lvec = light position - shadow origin, given that of
    ldir = lvec / guarded(dist), dist = guarded sqrt(|lvec|^2)."""
    g_lvec = vm.vscale(g_ldir, f.inv_l)
    g_inv = vm.vdot(g_ldir, f.lvec)
    g_dist = torch.where(f.dist > 1e-9, -g_inv * f.inv_l * f.inv_l, 0.0)
    g_dist2 = torch.where(f.dist2 > 0.0, g_dist * 0.5 / f.dist, 0.0)
    return vm.vadd(g_lvec, vm.vscale(f.lvec, 2.0 * g_dist2))


def sphere_winner_adjoint(o, d, t, c, r, g_t, g_n, soft=None):
    """Cotangents (o, d, center, radius) of a winning sphere's n = (o + d t
    - c) / r and t = -b - sqrt(disc) (-b for a soft layer's near miss: no
    sqrt term where the ray misses). ``soft = (tau, g_alpha)`` adds the
    coverage alpha = sigmoid(disc / (tau r^2))."""
    inv_r = 1.0 / r
    pl = vm.vsub(vm.vadd(o, vm.vscale(d, t)), c)
    g_pl = vm.vscale(g_n, inv_r)
    g_r = -vm.vdot(g_n, pl) * inv_r * inv_r
    g_o = g_pl
    g_d = vm.vscale(g_pl, t)
    g_ts = g_t + vm.vdot(g_pl, d)
    g_c = vm.vneg(g_pl)
    oc = vm.vsub(o, c)
    b = vm.vdot(oc, d)
    disc = b * b - (vm.vdot(oc, oc) - r * r)
    sq = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    hit = (disc > 0.0) & (-b - sq > T_EPS)
    g_b = -g_ts
    g_disc = torch.where(hit, -g_ts * 0.5 / sq, 0.0)
    if soft is not None:
        tau, g_alpha = soft
        den = tau * r * r
        s = torch.sigmoid(disc / den)
        g_x = g_alpha * s * (1.0 - s)
        g_disc = g_disc + g_x / den
        g_r = g_r - g_x * disc / (den * den) * (2.0 * tau * r)
    g_b = g_b + g_disc * 2.0 * b
    g_cc = -g_disc
    g_oc = vm.vadd(vm.vscale(oc, 2.0 * g_cc), vm.vscale(d, g_b))
    g_r = g_r - g_cc * 2.0 * r
    g_d = vm.vadd(g_d, vm.vscale(oc, g_b))
    g_o = vm.vadd(g_o, g_oc)
    g_c = vm.vsub(g_c, g_oc)
    return g_o, g_d, g_c, g_r


def rect_winner_adjoint(o, d, p0, eu, ev, is_rct, g_t, g_n):
    """Cotangents (o, d, origin, edge_u, edge_v) of a winning rect's t =
    ((p0 - o) . nraw) / (d . nraw) and n = facing * normalize(nraw), nraw =
    edge_u x edge_v (facing is a sign with no gradient)."""
    nraw = vm.vcross(eu, ev)
    nn2 = vm.vdot(nraw, nraw)
    inv_n = torch.rsqrt(torch.where(nn2 > 1e-12, nn2, 1.0))
    facing = torch.where(vm.vdot(vm.vscale(nraw, inv_n), d) < 0.0, 1.0, -1.0)
    denom = torch.where(is_rct, vm.vdot(d, nraw), 1.0)
    num = vm.vdot(vm.vsub(p0, o), nraw)
    g_num = g_t / denom
    g_den = -g_t * num / (denom * denom)
    g_p0 = vm.vscale(nraw, g_num)
    g_nraw = vm.vscale(vm.vsub(p0, o), g_num)
    g_nraw = vm.vadd(g_nraw, vm.vscale(d, g_den))
    g_nraw = vm.vadd(g_nraw, _normalize_adjoint(nraw, inv_n, nn2, vm.vscale(g_n, facing)))
    return (vm.vneg(g_p0), vm.vscale(nraw, g_den), g_p0, vm.vcross(ev, g_nraw),
            vm.vcross(g_nraw, eu))


def gather_rows(leaf, idx, zero, fill=0.0):
    """Per-pixel rows of a stacked leaf (a Vec3 for (K, 3) leaves); the
    constant ``fill`` for an empty group."""
    if leaf.shape[0] == 0:
        return zero + fill if leaf.dim() == 1 else (zero + fill,) * 3
    g = leaf[idx]
    return g if leaf.dim() == 1 else (g[..., 0], g[..., 1], g[..., 2])


def winner_rows(count, idx, mask, vals, like):
    """Sum per-pixel values into the row of each pixel's winner."""
    v = torch.stack([torch.where(mask, x, 0.0) for x in vals], dim=-1)
    out = torch.zeros((count, len(vals)), **like)
    return out.index_add_(0, idx.reshape(-1), v.reshape(-1, len(vals)))


def material_grads(mat_like, count, idx, mask, use2, g, like):
    """The material leaves' gradients of the winners: ``g`` holds the
    per-pixel cotangents base (Vec3), ka, kd, ks, shin; base goes to color
    or color2 as the checker picked."""
    rows = winner_rows(count, idx, mask, [g.ka, g.kd, g.ks, g.shin], like)
    return dc.replace(mat_like,
                      color=winner_rows(count, idx, mask & ~use2, g.base, like),
                      color2=winner_rows(count, idx, mask & use2, g.base, like),
                      ka=rows[:, 0], kd=rows[:, 1], ks=rows[:, 2], shininess=rows[:, 3])


def winner_geometry(scene, k, zero):
    """The per-pixel winner ``k`` (spheres 0..N-1, rects N..N+M-1, -1 for
    none): its masks ``is_sph``/``is_rct``/``hit``, its clamped rows
    ``ks``/``kr``, and its geometry ``sc``, ``sr``, ``p0``, ``eu``, ``ev``."""
    sp, rc = scene.spheres, scene.rects
    N, M = sp.count, rc.count
    w = SimpleNamespace(is_sph=(k >= 0) & (k < N), is_rct=k >= N)
    w.hit = w.is_sph | w.is_rct
    w.ks = k.clamp(0, max(N - 1, 0))
    w.kr = (k - N).clamp(0, max(M - 1, 0))
    w.sc = gather_rows(sp.center, w.ks, zero)
    w.sr = gather_rows(sp.radius, w.ks, zero, 1.0)
    w.p0, w.eu, w.ev = (gather_rows(getattr(rc, f), w.kr, zero)
                        for f in ("origin", "edge_u", "edge_v"))
    return w


def winner_surface(scene, w, o, d, t, zero):
    """Add to ``w`` (from `winner_geometry`) the winner's surface at ray
    distance ``t``: the normal ``n`` (a sphere's is (p - c) / r), the
    checker pick ``use2``, the ``base`` colour, ``ka``/``kd``/``ksp``/
    ``shin``, and ``pick(sphere_value, rect_value, miss_value)``."""
    sp, rc = scene.spheres, scene.rects
    p = vm.vadd(o, vm.vscale(d, t))
    s_pl = vm.vsub(p, w.sc)
    s_n = vm.vscale(s_pl, 1.0 / w.sr)
    s_par = torch.remainder(sum(torch.floor(c * gather_rows(sp.material.checker_scale, w.ks, zero))
                                for c in s_pl), 2.0)
    s_use2 = gather_rows(sp.material.checker, w.ks, zero) * s_par > 0.5

    nu = vm.vnormalize(vm.vcross(w.eu, w.ev))
    r_n = vm.vscale(nu, torch.where(vm.vdot(nu, d) < 0.0, 1.0, -1.0))
    rel = vm.vsub(p, w.p0)
    ra = vm.vdot(rel, w.eu) * (1.0 / vm.vdot(w.eu, w.eu))
    rb = vm.vdot(rel, w.ev) * (1.0 / vm.vdot(w.ev, w.ev))
    r_cs = gather_rows(rc.material.checker_scale, w.kr, zero)
    r_par = torch.remainder(torch.floor(ra * r_cs) + torch.floor(rb * r_cs), 2.0)
    r_use2 = gather_rows(rc.material.checker, w.kr, zero) * r_par > 0.5

    def pick(sv, rv, miss):
        return torch.where(w.is_sph, sv, torch.where(w.is_rct, rv, miss))

    def mat(name, miss=0.0):
        return pick(gather_rows(getattr(sp.material, name), w.ks, zero),
                    gather_rows(getattr(rc.material, name), w.kr, zero), zero + miss)

    w.pick = pick
    w.n = tuple(pick(a, b, zero) for a, b in zip(s_n, r_n))
    w.use2 = torch.where(w.is_sph, s_use2, r_use2)
    w.base = tuple(pick(torch.where(s_use2, a2, a1), torch.where(r_use2, b2, b1), zero)
                   for a1, a2, b1, b2 in zip(gather_rows(sp.material.color, w.ks, zero),
                                             gather_rows(sp.material.color2, w.ks, zero),
                                             gather_rows(rc.material.color, w.kr, zero),
                                             gather_rows(rc.material.color2, w.kr, zero)))
    w.ka, w.kd, w.ksp, w.shin = mat("ka"), mat("kd"), mat("ks"), mat("shininess", 1.0)
    return w


def forward_terms(scene, cfg, nearest, visibility):
    """The forward of the hard kernels in eager torch, with what their
    adjoint needs: the primary rays (``ray``), the nearest hit (``t``) and
    the winner's surface (``w``), the shadow origins (``so``), per light its
    terms and visibility plane (``per_light``), the unclipped image
    (``pre``) and the image (``img``), each a tuple of (H, W) channels.
    ``nearest(scene, o, d) -> (t, k)`` is the trace's nearest hit;
    ``visibility(li, so, f, zero, hit)`` gives light li's visibility plane
    where the rays ``hit`` (`traced_visibility`, `saved_visibility`)."""
    lt = scene.lights
    zero = torch.zeros((cfg.height, cfg.width), device=scene.device, dtype=scene.ambient.dtype)
    ray = primary_ray_terms(scene, cfg)
    o, d = ray.o, ray.d
    t, kbest = nearest(scene, o, d)
    w = winner_surface(scene, winner_geometry(scene, kbest, zero), o, d, t, zero)
    amb = vm.splat(scene.ambient)
    col = vm.vscale(vm.vmul(w.base, amb), w.ka)
    so = vm.vadd(vm.vadd(o, vm.vscale(d, t)), vm.vscale(w.n, SHADOW_EPS))
    per_light = []
    for li in range(lt.count):
        f = light_terms(lt, li, so, w.n, d, w.base, w.kd, w.ksp, w.shin)
        vis = visibility(li, so, f, zero, w.hit)
        col = vm.vadd(col, tuple(vis * f.q[c] * f.lcol[c] for c in range(3)))
        per_light.append((f, vis))
    bg = vm.splat(scene.background)
    pre = tuple(torch.where(w.hit, c, b) for c, b in zip(col, bg))
    img = tuple(vm.clip01(c) for c in pre) if cfg.clip else pre
    return SimpleNamespace(ray=ray, t=t, w=w, so=so, per_light=per_light, pre=pre, img=img)


def _adjoint(scene, cfg, nearest, cotangent, visibility):
    """The per-pixel adjoint of the step and of the render backward: ``(sum
    of squared residuals, grads as a Scene)``. ``nearest`` and
    ``visibility`` as `forward_terms` takes them; ``cotangent(img)`` gives
    the cotangent of the clipped image per channel and the squared error
    (`residual_cotangent`, `image_cotangent`)."""
    dev = scene.device
    H, W = cfg.height, cfg.width
    sp, rc, lt, cam = scene.spheres, scene.rects, scene.lights, scene.camera
    N, M, L = sp.count, rc.count, lt.count
    like = dict(device=dev, dtype=scene.ambient.dtype)
    zero = torch.zeros((H, W), **like)

    # ---- forward: the camera ray with its intermediates, the nearest hit,
    # the winner's attributes, the shading
    fw = forward_terms(scene, cfg, nearest, visibility)
    ray, t, w, per_light, pre, img = fw.ray, fw.t, fw.w, fw.per_light, fw.pre, fw.img
    o, d = ray.o, ray.d
    is_sph, is_rct, hit, ks_, kr_ = w.is_sph, w.is_rct, w.hit, w.ks, w.kr
    sc, sr, p0, eu, ev = w.sc, w.sr, w.p0, w.eu, w.ev
    pick, n, use2, base = w.pick, w.n, w.use2, w.base
    ka, kd, ksp, shin = w.ka, w.kd, w.ksp, w.shin
    amb = vm.splat(scene.ambient)

    # ---- the image's cotangent, through the clip
    g_img, sq = cotangent(img)
    gc = tuple(g * (_clipgrad(p_) if cfg.clip else 1.0) for g, p_ in zip(g_img, pre))

    # ---- shade adjoint (hit pixels; everything below is masked by hit)
    gh = tuple(torch.where(hit, g, 0.0) for g in gc)
    g_bg = tuple(torch.sum(torch.where(hit, 0.0, g)) for g in gc)
    g = SimpleNamespace(base=tuple(gh[c] * amb[c] * ka for c in range(3)),
                        ka=sum(gh[c] * base[c] * amb[c] for c in range(3)),
                        kd=zero, ks=zero, shin=zero)
    g_amb = tuple(torch.sum(gh[c] * base[c] * ka) for c in range(3))
    g_n, g_d, g_so = (zero,) * 3, (zero,) * 3, (zero,) * 3
    g_lpos, g_lcol = [], []
    for f, vis in per_light:
        gl = light_adjoint(f, gh, vis, n, d, base, kd, ksp, shin)
        g_lcol.append(tuple(torch.sum(x) for x in gl.lcol))
        g.kd, g.ks, g.shin = g.kd + gl.kd, g.ks + gl.ks, g.shin + gl.shin
        g.base = vm.vadd(g.base, gl.base)
        g_d = vm.vadd(g_d, gl.d)
        g_n = vm.vadd(g_n, gl.n)
        g_lvec = light_geometry_adjoint(f, gl.ldir)
        g_lpos.append(tuple(torch.sum(x) for x in g_lvec))
        g_so = vm.vsub(g_so, g_lvec)
    # so = (o + d t) + n * SHADOW_EPS
    g_o = g_so
    g_d = vm.vadd(g_d, vm.vscale(g_so, t))
    g_t = vm.vdot(g_so, d)
    g_n = vm.vadd(g_n, vm.vscale(g_so, SHADOW_EPS))

    # ---- the winning object
    s_go, s_gd, g_c, g_r = sphere_winner_adjoint(o, d, t, sc, sr, g_t, g_n)
    r_go, r_gd, g_p0, g_eu, g_ev = rect_winner_adjoint(o, d, p0, eu, ev, is_rct, g_t, g_n)
    g_o = tuple(g_o[c] + pick(s_go[c], r_go[c], zero) for c in range(3))
    g_d = tuple(g_d[c] + pick(s_gd[c], r_gd[c], zero) for c in range(3))

    # ---- camera, and the reduction into the scene's leaves
    g_eye, g_look, g_uph, g_fov = camera_grads(
        cam, ray, tuple(torch.where(hit, x, 0.0) for x in g_o),
        tuple(torch.where(hit, x, 0.0) for x in g_d))
    grads = tree_unflatten(scene, [torch.zeros_like(l) for l in tree_leaves(scene)])
    spheres, rects = grads.spheres, grads.rects
    if N:
        spheres = dc.replace(spheres, center=winner_rows(N, ks_, is_sph, g_c, like),
                             radius=winner_rows(N, ks_, is_sph, [g_r], like)[:, 0],
                             material=material_grads(spheres.material, N, ks_, is_sph, use2,
                                                     g, like))
    if M:
        rects = dc.replace(rects, origin=winner_rows(M, kr_, is_rct, g_p0, like),
                           edge_u=winner_rows(M, kr_, is_rct, g_eu, like),
                           edge_v=winner_rows(M, kr_, is_rct, g_ev, like),
                           material=material_grads(rects.material, M, kr_, is_rct, use2, g,
                                                   like))
    lights = grads.lights
    if L:
        lights = dc.replace(lights, position=torch.stack([torch.stack(x) for x in g_lpos]),
                            color=torch.stack([torch.stack(x) for x in g_lcol]))
    camera = dc.replace(grads.camera, eye=g_eye, look_at=g_look, up=g_uph, fov_deg=g_fov)
    grads = dc.replace(grads, spheres=spheres, rects=rects, lights=lights, camera=camera,
                       ambient=torch.stack(g_amb), background=torch.stack(g_bg))
    return sq, grads
