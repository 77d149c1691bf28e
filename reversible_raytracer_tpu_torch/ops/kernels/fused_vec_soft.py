"""The soft-visibility CUDA kernels (``soft_tau > 0``), their wrappers and
their plain versions: the annealed inversion's soft stages.

- `render_vec_soft`: the soft forward kernel
  (``csrc/fused_vec_soft_render.cu``), replacing the TPU kernel ``fwd_kernel``
  (reversible_raytracer_tpu/ops/kernels/fused_vec_soft.py:494, pallas_call at
  :511). It writes the (H, W, 3) image only. Plain version:
  `render_vec_soft_plain` (`pipeline_vec.render_eager_vec` with soft_tau).
  On CUDA the image is differentiable through the soft render backward
  (`_SoftRender`, the ``custom_vjp`` of fused_vec_soft.py:1008-1040).
- the soft render backward kernel (``csrc/fused_vec_soft_render_bwd.cu``),
  replacing ``make_bwd_kernel(False)`` (fused_vec_soft.py:547, ``bwd_call``
  at :943), launched only by `_SoftRender.backward`: the image cotangent ->
  the gradient of every scene scalar. No saved
  visibility: soft shadows carry gradient, so the backward recomputes
  them. Plain version: `render_vec_soft_bwd_plain` (autograd);
  `render_vec_soft_bwd_adjoint_eager` runs its hand-written adjoint in
  eager torch, the soft step's adjoint with the caller's cotangent.
- `loss_grad_vec_soft`: the soft training step
  (``csrc/fused_vec_soft_step.cu``), replacing ``make_bwd_kernel(True)``
  (fused_vec_soft.py:547, ``step_call`` at :975). Plain version:
  `loss_grad_vec_soft_plain` (autograd over the soft render);
  `loss_grad_vec_soft_adjoint_eager` runs the kernel's hand-written adjoint
  in eager torch.

The three kernels drop a sphere from a pixel's shadow product where its
factor 1 - alpha is exactly 1 (`shadow_kept`, `SOFT_CULL`), and each warp of
32 pixels visits only the spheres its conservative test keeps
(`cull.warp_candidates`, the plain version of that test, used by the tests):
the products keep their bits, and the step's and backward's gradients drop
terms each under 2^-25 of their cotangent. The forward also ranks only each
warp's primary candidates of a cone widened to the soft ranking's reach
(`cull.primary_candidates` at tau): a sphere outside it ranks BIG for every
ray of the warp, so the two layers are the full ranking's to the bit. The
eager twins apply the same per-pixel rule (`render_vec_soft_culled`, the
forward's twin, the warp tests as well).

Semantics are the JAX package's `_render_soft`: two layers ranked by the
soft t (strict < ranking, first-wins ties), sphere coverage alpha =
sigmoid(disc / (tau r^2)), rect coverage 1, per layer and light a soft
shadow product over the sphere occluders (rect occluders hard), and the
composite a1 c1 + (1 - a1) (a2 c2 + (1 - a2) bg), clipped. tau is a runtime
argument of both kernels: one build serves every anneal stage.

The scene enters as `fused_vec`'s packed rows (globals, sphere and rect
rows padded to 16, rects numbered from the padded sphere count). Covered:
spp 1, perspective, Phong, untextured objects, no environment map, no
soft checker, no mirror levels; anything else raises on CUDA. On a CPU
tensor each wrapper runs its plain version; on a CUDA tensor it launches
its kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses as dc
from types import SimpleNamespace

import torch
from torch.autograd.function import once_differentiable

from ...models.scene import tree_leaves, tree_unflatten
from .. import vecmath as vm
from ..pipeline import BIG, SHADOW_EPS, RenderConfig
from ..pipeline_vec import (
    sphere_axis,
    rect_ts,
    render_eager_vec,
    sphere_shadow_alpha,
    two_layers,
)
from . import fused, fused_vec
from .cull import SOFT_CULL, per_pixel, primary_candidates, warp_candidates
from ._build import Kernel

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GEOM = fused_vec._GEOM  # n_sph, n_rect, ns_pad, nr_pad, n_light, H, W, shadows, clip

SOFT_RENDER = Kernel("fused_vec_soft_render", {
    "rrt_soft_render": ([_P, _P, _P, *_GEOM, _F, _P, _P], _I),
    "rrt_soft_render_smem": ([_I, _I, _I], ctypes.c_longlong),
})
SOFT_STEP = Kernel("fused_vec_soft_step", {
    "rrt_soft_step": ([_P, _P, _P, *_GEOM, _F, _P, _F, _P, _P, _P], _I),
    "rrt_soft_step_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
    "rrt_soft_step_smem": ([_I, _I, _I], ctypes.c_longlong),
})
SOFT_RENDER_BWD = Kernel("fused_vec_soft_render_bwd", {
    "rrt_soft_render_bwd": ([_P, _P, _P, *_GEOM, _F, _P, _P, _P, _P], _I),
    "rrt_soft_render_bwd_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
    "rrt_soft_render_bwd_smem": ([_I, _I, _I], ctypes.c_longlong),
})
KERNELS = (SOFT_RENDER, SOFT_STEP, SOFT_RENDER_BWD)


def soft_kernel_ok(scene_like) -> bool:
    """Can the soft kernels take this scene (the JAX package's
    `soft_kernel_ok`)? Untextured scenes with no environment map, until the
    texel tails and the env global are ported."""
    return not (scene_like.spheres.textured or scene_like.rects.textured
                or scene_like.env_mapped)


def soft_uncovered(scene, cfg: RenderConfig):
    """What the soft kernels do not cover (a reason), or None."""
    if cfg.spp != 1:
        return (f"spp={cfg.spp} (a spp-4 soft stage needs subsample offsets in the soft "
                "forward and backward kernels)")
    if cfg.checker_tau > 0.0:
        return "checker_tau > 0 (the soft checker)"
    if cfg.reflections:
        return "mirror reflections"
    if cfg.shader != "phong":
        return f"the {cfg.shader} shader"
    if cfg.projection != "perspective":
        return f"the {cfg.projection} projection"
    if not soft_kernel_ok(scene):
        return "object textures or environment maps"
    if scene.lights.count > fused.MAX_LIGHTS:
        return f"more than {fused.MAX_LIGHTS} lights"
    return None


def check_soft_kernel_config(scene, cfg: RenderConfig) -> None:
    """Raise for a configuration the soft kernels do not take."""
    if not cfg.soft_tau > 0.0:
        raise ValueError("the soft kernels need soft_tau > 0 (the hard path is fused_vec)")
    why = soft_uncovered(scene, cfg)
    if why is not None:
        raise NotImplementedError(f"the soft CUDA kernels do not cover {why}")


def _cuda_inputs(scene, cfg: RenderConfig):
    check_soft_kernel_config(scene, cfg)
    return fused_vec.packed_inputs(scene)


# ---------------------------------------------------------------------------
# Forward render kernel (row 7)
# ---------------------------------------------------------------------------


def render_vec_soft_plain(scene, cfg: RenderConfig):
    """The soft (H, W, 3) image in eager torch."""
    return render_eager_vec(scene, cfg)


def most_spheres(n_rect: int = 1, n_light: int = 1) -> int:
    """The most spheres, in the rows' steps of 16, that the soft step and
    soft render backward take beside ``n_rect`` rects and ``n_light``
    lights on the current card: what a block's shared memory holds with one
    prefix slot per lane (csrc/soft_step.cuh `soft_plan`)."""
    return fused_vec.most_rows(SOFT_STEP.lib().rrt_soft_step_smem, n_rect, n_light)


def most_render_spheres(n_rect: int = 1, n_light: int = 1) -> int:
    """The most spheres that the soft forward takes beside ``n_rect`` rects
    and ``n_light`` lights on the current card (csrc/cull.cuh
    `forward_smem`)."""
    return fused_vec.most_rows(SOFT_RENDER.lib().rrt_soft_render_smem, n_rect, n_light)


def render_vec_soft(scene, cfg: RenderConfig):
    """The soft (H, W, 3) image: the forward kernel on CUDA,
    `render_vec_soft_plain` on the CPU. Differentiable on both: on CUDA
    through the soft render backward kernel."""
    dev = scene.device
    if dev.type == "cpu":
        return render_vec_soft_plain(scene, cfg)
    if dev.type != "cuda":
        raise NotImplementedError(f"no soft render kernel for device {dev}")
    return _SoftRender.apply(scene, cfg, *tree_leaves(scene))


class _SoftRender(torch.autograd.Function):
    """The soft forward and soft render backward kernels as one
    differentiable function of the scene's leaves (the ``custom_vjp`` of
    fused_vec_soft.py:1008-1040): the forward saves the packed rows (tau
    is in the saved configuration), the backward launches the backward
    kernel once."""

    @staticmethod
    def forward(ctx, scene, cfg, *leaves):
        glob, sph, rct = _cuda_inputs(scene, cfg)
        fused_vec.check_smem(SOFT_RENDER, "rrt_soft_render_smem", scene)
        if any(ctx.needs_input_grad):
            fused_vec.check_smem(SOFT_RENDER_BWD, "rrt_soft_render_bwd_smem", scene)
        img = torch.empty((cfg.height, cfg.width, 3), device=glob.device)
        SOFT_RENDER.call("rrt_soft_render", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(),
                         *fused_vec._geometry(scene, cfg), float(cfg.soft_tau), img.data_ptr(),
                         fused._stream(glob.device))
        SOFT_RENDER.launches += 1
        ctx.scene, ctx.cfg = scene, cfg
        ctx.save_for_backward(glob, sph, rct)
        ctx.set_materialize_grads(False)
        return img

    @staticmethod
    @once_differentiable
    def backward(ctx, g_img):
        if g_img is None:
            return (None, None, *(None for _ in tree_leaves(ctx.scene)))
        glob, sph, rct = ctx.saved_tensors
        grads = _render_bwd_launch(ctx.scene, ctx.cfg, glob, sph, rct, g_img)
        return (None, None, *tree_leaves(grads))


# ---------------------------------------------------------------------------
# Render backward kernel (row 8)
# ---------------------------------------------------------------------------


def _render_bwd_launch(scene_like, cfg, glob, sph, rct, g_img):
    """The scene's gradient (a Scene) from one soft backward-kernel call."""
    dev = glob.device
    g_img = fused.cotangent_f32(g_img, cfg)
    geom = fused_vec._geometry(scene_like, cfg)
    scratch = torch.empty(
        (SOFT_RENDER_BWD.lib().rrt_soft_render_bwd_scratch_floats(*geom[2:7]),), device=dev)
    out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel(),), device=dev)
    SOFT_RENDER_BWD.call("rrt_soft_render_bwd", glob.data_ptr(), sph.data_ptr(),
                         rct.data_ptr(), *geom, float(cfg.soft_tau), g_img.data_ptr(),
                         scratch.data_ptr(), out.data_ptr(), fused._stream(dev))
    SOFT_RENDER_BWD.launches += 1
    return fused_vec._unpack_out(scene_like, out, glob, sph, rct)


def render_vec_soft_bwd_plain(scene, cfg: RenderConfig, g_img):
    """torch.autograd of the soft render for the image cotangent."""
    return fused.autograd_vjp(render_eager_vec, scene, cfg, g_img)


# ---------------------------------------------------------------------------
# Training-step kernel (row 9)
# ---------------------------------------------------------------------------


def loss_grad_vec_soft(scene, cfg: RenderConfig, target, loss: str = "mse"):
    """``(norm * sq_sum, grads as a Scene)`` of the squared error between
    the soft render of ``scene`` and ``target``. One step-kernel call on
    CUDA; autograd over the soft render on the CPU."""
    dev = scene.device
    norm = fused._loss_norm(cfg, loss)
    fused._check_target(target, cfg, scene)
    if dev.type == "cpu":
        return loss_grad_vec_soft_plain(scene, cfg, target, loss)
    if dev.type != "cuda":
        raise NotImplementedError(f"no soft step kernel for device {dev}")
    glob, sph, rct = _cuda_inputs(scene, cfg)
    fused_vec.check_smem(SOFT_STEP, "rrt_soft_step_smem", scene)
    target = target.contiguous()
    geom = fused_vec._geometry(scene, cfg)
    scratch = torch.empty((SOFT_STEP.lib().rrt_soft_step_scratch_floats(*geom[2:7]),),
                          device=dev)
    out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel(),), device=dev)
    SOFT_STEP.call("rrt_soft_step", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom,
                   float(cfg.soft_tau), target.data_ptr(), norm, scratch.data_ptr(),
                   out.data_ptr(), fused._stream(dev))
    SOFT_STEP.launches += 1
    return norm * out[0], fused_vec._unpack_out(scene, out, glob, sph, rct)


def loss_grad_vec_soft_plain(scene, cfg: RenderConfig, target, loss: str = "mse"):
    """torch.autograd of ``loss(soft render(scene), target)``."""
    return fused.autograd_loss_grad(render_eager_vec, scene, cfg, target, loss)


def loss_grad_vec_soft_adjoint_eager(scene, cfg: RenderConfig, target, loss: str = "mse"):
    """The soft step kernel's algorithm in eager torch, vectorized over
    pixels: the two-layer ranking, each layer's winner, coverage and soft
    shadow products, the residual, then the adjoint of the composite, of
    each layer's shading, of its shadow products (each kept occluder's
    factor is the exclusive product of the others, from prefix and suffix
    products, never a division), of the light geometry and of the layer's
    winner, and the camera chain once. Same contract as
    `loss_grad_vec_soft`."""
    check_soft_kernel_config(scene, cfg)
    norm = fused._loss_norm(cfg, loss)
    fused._check_target(target, cfg, scene)
    with torch.no_grad():
        sq, grads = _soft_adjoint(scene, cfg, fused.residual_cotangent(target, norm))
    return norm * sq, grads


def render_vec_soft_bwd_adjoint_eager(scene, cfg: RenderConfig, g_img):
    """The soft render backward kernel's algorithm in eager torch: the soft
    step's adjoint (`_soft_adjoint`) with the image cotangent ``g_img`` in
    place of the residual: the scene's gradient (a Scene)."""
    check_soft_kernel_config(scene, cfg)
    fused._check_target(g_img, cfg, scene, "cotangent")
    with torch.no_grad():
        return _soft_adjoint(scene, cfg, fused.image_cotangent(g_img))[1]


def shadow_kept(c, r, so, ld, dist, tau):
    """The per-pixel cull rule of the soft step and backward kernels: for
    each sphere (axis 0) and pixel, whether the sphere is between the
    surface and the light and its shadow-ray coverage is not below
    -SOFT_CULL (``disc`` computed as `sphere_shadow_alpha` computes it)."""
    oc = vm.vsub(so, c)
    b = vm.vdot(oc, ld)
    disc = b * b - (vm.vdot(oc, oc) - r * r)
    t = -b - torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    between = (((disc > 0.0) & (t > fused.T_EPS) & (t < dist))
               | ((-b > fused.T_EPS) & (-b < dist)))
    return between & ~(disc < -SOFT_CULL[disc.dtype] * tau * r * r)


def _exclusive_products(one_m):
    """prod_{j != k} one_m[j] for every k along axis 0, as the product of
    the prefix before k and the suffix after it."""
    ones = torch.ones_like(one_m[:1])
    pre = torch.cat([ones, torch.cumprod(one_m, 0)[:-1]])
    suf = torch.cat([torch.flip(torch.cumprod(torch.flip(one_m, [0]), 0), [0])[1:], ones])
    return pre * suf


def _shadow_alpha_adjoint(spheres, so, ld, dist, tau, g_alpha):
    """Cotangents of ``sphere_shadow_alpha`` over the sphere occluders the
    cull keeps (axis 0; `shadow_kept`) for the per-occluder cotangents
    ``g_alpha`` (N, H, W): of the shadow origin and direction (summed over
    occluders), and of each sphere's center and radius (summed over
    pixels). The gate, and with it the distance to the light, carries no
    gradient."""
    c, r = sphere_axis(spheres)
    oc = vm.vsub(tuple(x[None] for x in so), c)
    ldl = tuple(x[None] for x in ld)
    b = vm.vdot(oc, ldl)
    disc = b * b - (vm.vdot(oc, oc) - r * r)
    kept = shadow_kept(c, r, tuple(x[None] for x in so), ldl, dist[None], tau)
    den = tau * r * r
    s = torch.sigmoid(disc / den)
    g_x = torch.where(kept, g_alpha * s * (1.0 - s), 0.0)
    g_disc = g_x / den
    g_r = -g_x * disc / (den * den) * (2.0 * tau * r)
    g_b = 2.0 * b * g_disc
    g_cc = -g_disc
    g_oc = vm.vadd(vm.vscale(oc, 2.0 * g_cc), vm.vscale(ldl, g_b))
    g_r = g_r - 2.0 * r * g_cc
    g_so = tuple(x.sum(0) for x in g_oc)
    g_ld = tuple((o_ * g_b).sum(0) for o_ in oc)
    g_c = torch.stack([-x.sum((1, 2)) for x in g_oc], dim=1)
    return g_so, g_ld, g_c, g_r.sum((1, 2))


def _layer(scene, cfg, ray, k, tau, zero, warp_cull=False):
    """One soft layer's forward with the intermediates its adjoint needs:
    the winner's geometry and coverage, its surface, and per light the
    Phong terms and the shadow factors (sphere 1 - alpha, exactly 1 where
    `shadow_kept` drops the sphere, and with ``warp_cull`` also outside the
    warp's candidates, `cull.warp_candidates`; the hard rect factor) and
    visibility."""
    sp, rc, lt = scene.spheres, scene.rects, scene.lights
    N, M = sp.count, rc.count
    o, d = ray.o, ray.d
    y = fused.winner_geometry(scene, k, zero)
    oc = vm.vsub(o, y.sc)
    b = vm.vdot(oc, d)
    disc = b * b - (vm.vdot(oc, oc) - y.sr * y.sr)
    t_hit = -b - torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    t_s = torch.where((disc > 0.0) & (t_hit > fused.T_EPS), t_hit, -b)
    a_s = torch.sigmoid(disc / (tau * y.sr * y.sr))
    t_r = fused.intersect_rect(o, d, y.p0, y.eu, y.ev)[0]
    y.t = torch.where(y.is_sph, t_s, torch.where(y.is_rct, t_r, BIG))
    y.alpha = torch.where(y.is_sph, a_s, torch.where(y.is_rct, 1.0, 0.0))
    fused.winner_surface(scene, y, o, d, y.t, zero)

    # shading with the soft shadow product
    amb = vm.splat(scene.ambient)
    col = vm.vscale(vm.vmul(y.base, amb), y.ka)
    y.so = vm.vadd(vm.vadd(o, vm.vscale(d, y.t)), vm.vscale(y.n, SHADOW_EPS))
    y.lights = []
    for li in range(lt.count):
        f = fused.light_terms(lt, li, y.so, y.n, d, y.base, y.kd, y.ksp, y.shin)
        f.one_m, f.vis = None, zero + 1.0
        if cfg.shadows:
            rect_f = zero + 1.0
            if M:
                rect_f = torch.where((rect_ts(rc, y.so, f.ldir) < f.dist).any(0), 0.0, 1.0)
            f.rect_f, f.vis = rect_f, rect_f
            if N:  # a culled factor is exactly 1 already: the product keeps its bits
                c, r = sphere_axis(sp)
                so, ld = tuple(x[None] for x in y.so), tuple(x[None] for x in f.ldir)
                kept = shadow_kept(c, r, so, ld, f.dist[None], tau)
                if warp_cull:
                    kept = kept & per_pixel(warp_candidates(sp, y.so, y.hit, lt.position[li],
                                                            tau), cfg.width)
                f.one_m = torch.where(kept,
                                      1.0 - sphere_shadow_alpha(c, r, so, ld, f.dist[None], tau),
                                      1.0)
                f.vis = 1.0 - (1.0 - torch.prod(f.one_m, 0) * rect_f)
        col = vm.vadd(col, tuple(f.vis * f.q[c] * f.lcol[c] for c in range(3)))
        y.lights.append(f)
    bg = vm.splat(scene.background)
    y.col = tuple(torch.where(y.hit, c, b_) for c, b_ in zip(col, bg))
    y.a = torch.where(y.hit, y.alpha, 0.0)
    return y


def _soft_forward(scene, cfg, cull=False):
    """The soft kernels' forward in eager torch, with what the adjoint
    needs: the primary rays, the two layers (`_layer`), the background, the
    composite behind layer 1 and in front, and the image. With ``cull``, as
    the soft forward kernel walks: the ranking over each warp's primary
    candidates of the widened cone (`cull.primary_candidates` at tau), and
    each shadow product over the warp's candidates as well."""
    tau = cfg.soft_tau
    zero = torch.zeros((cfg.height, cfg.width), device=scene.device, dtype=scene.ambient.dtype)
    ray = fused.primary_ray_terms(scene, cfg)
    keep = None
    if cull and scene.spheres.count:
        keep = per_pixel(primary_candidates(scene.spheres, scene.camera.eye, ray.d, tau),
                         cfg.width)
    y1, y2 = (_layer(scene, cfg, ray, k, tau, zero, warp_cull=cull)
              for _, k in two_layers(scene, ray.o, ray.d, tau, keep))
    bg = vm.splat(scene.background)
    behind = tuple(y2.a * y2.col[c] + (1.0 - y2.a) * bg[c] for c in range(3))
    comp = tuple(y1.a * y1.col[c] + (1.0 - y1.a) * behind[c] for c in range(3))
    img = tuple(vm.clip01(c) for c in comp) if cfg.clip else comp
    return SimpleNamespace(ray=ray, y1=y1, y2=y2, bg=bg, behind=behind, comp=comp, img=img)


def render_vec_soft_culled(scene, cfg: RenderConfig):
    """The soft forward kernel's algorithm in eager torch: the two layers
    ranked over each warp's primary candidates, each shadow product over
    the warp's candidates by the per-pixel rule, the composite. The (H, W,
    3) image."""
    check_soft_kernel_config(scene, cfg)
    with torch.no_grad():
        return torch.stack(_soft_forward(scene, cfg, cull=True).img, dim=-1)


def _soft_adjoint(scene, cfg, cotangent):
    """The per-pixel soft adjoint of the step and of the render backward:
    ``(sum of squared residuals, grads as a Scene)``; ``cotangent(img)``
    gives the clipped image's cotangent per channel and the squared error
    (`fused.residual_cotangent`, `fused.image_cotangent`)."""
    tau = cfg.soft_tau
    sp, rc, lt = scene.spheres, scene.rects, scene.lights
    N, M, L = sp.count, rc.count, lt.count
    like = dict(device=scene.device, dtype=scene.ambient.dtype)
    zero = torch.zeros((cfg.height, cfg.width), **like)
    fw = _soft_forward(scene, cfg)
    ray, y1, y2, bg, behind, comp = fw.ray, fw.y1, fw.y2, fw.bg, fw.behind, fw.comp
    o, d = ray.o, ray.d

    # ---- the image's cotangent through the clip
    g_img, sq = cotangent(fw.img)
    g_comp = tuple(g * (fused._clipgrad(p_) if cfg.clip else 1.0) for g, p_ in zip(g_img, comp))

    # ---- composite adjoint
    y1.g_a = sum(g_comp[c] * (y1.col[c] - behind[c]) for c in range(3))
    y1.g_col = tuple(g * y1.a for g in g_comp)
    g_beh = tuple(g * (1.0 - y1.a) for g in g_comp)
    y2.g_a = sum(g_beh[c] * (y2.col[c] - bg[c]) for c in range(3))
    y2.g_col = tuple(g * y2.a for g in g_beh)
    g_bg = [g * (1.0 - y2.a) for g in g_beh]
    for y in (y1, y2):  # a dead layer's colour is the background
        g_bg = [a + torch.where(y.hit, 0.0, g) for a, g in zip(g_bg, y.g_col)]

    grads = tree_unflatten(scene, [torch.zeros_like(l) for l in tree_leaves(scene)])
    spheres, rects = grads.spheres, grads.rects
    g_lpos = [(zero,) * 3 for _ in range(L)]
    g_lcol = [(zero,) * 3 for _ in range(L)]
    g_amb = (zero,) * 3
    g_o_cam, g_d_cam = (zero,) * 3, (zero,) * 3
    amb = vm.splat(scene.ambient)
    for y in (y1, y2):
        # ---- shading adjoint of the layer (zero where it is dead)
        gh = tuple(torch.where(y.hit, g, 0.0) for g in y.g_col)
        g_alpha = torch.where(y.hit, y.g_a, 0.0)
        g = SimpleNamespace(base=tuple(gh[c] * amb[c] * y.ka for c in range(3)),
                            ka=sum(gh[c] * y.base[c] * amb[c] for c in range(3)),
                            kd=zero, ks=zero, shin=zero)
        g_amb = tuple(a + gh[c] * y.base[c] * y.ka for c, a in enumerate(g_amb))
        g_n, g_d, g_so = (zero,) * 3, (zero,) * 3, (zero,) * 3
        for li, f in enumerate(y.lights):
            gl = fused.light_adjoint(f, gh, f.vis, y.n, d, y.base, y.kd, y.ksp, y.shin)
            g_lcol[li] = vm.vadd(g_lcol[li], gl.lcol)
            g.kd, g.ks, g.shin = g.kd + gl.kd, g.ks + gl.ks, g.shin + gl.shin
            g.base = vm.vadd(g.base, gl.base)
            g_d = vm.vadd(g_d, gl.d)
            g_n = vm.vadd(g_n, gl.n)
            g_ldir = gl.ldir
            if f.one_m is not None:  # transpose of vis = rect_f * prod_k (1 - alpha_k)
                g_a_sh = -gl.vis * f.rect_f * _exclusive_products(f.one_m)
                g_so_sh, g_ld_sh, g_c_sh, g_r_sh = _shadow_alpha_adjoint(
                    sp, y.so, f.ldir, f.dist, tau, torch.where(y.hit, g_a_sh, 0.0))
                g_so = vm.vadd(g_so, g_so_sh)
                g_ldir = vm.vadd(g_ldir, g_ld_sh)
                spheres = dc.replace(spheres, center=spheres.center + g_c_sh,
                                     radius=spheres.radius + g_r_sh)
            g_lvec = fused.light_geometry_adjoint(f, g_ldir)
            g_lpos[li] = vm.vadd(g_lpos[li], g_lvec)
            g_so = vm.vsub(g_so, g_lvec)
        # so = (o + d t) + n * SHADOW_EPS
        g_o = g_so
        g_d = vm.vadd(g_d, vm.vscale(g_so, y.t))
        g_t = vm.vdot(g_so, d)
        g_n = vm.vadd(g_n, vm.vscale(g_so, SHADOW_EPS))

        # ---- the layer's winner
        s_go, s_gd, g_c, g_r = fused.sphere_winner_adjoint(o, d, y.t, y.sc, y.sr, g_t, g_n,
                                                           soft=(tau, g_alpha))
        r_go, r_gd, g_p0, g_eu, g_ev = fused.rect_winner_adjoint(o, d, y.p0, y.eu, y.ev,
                                                                 y.is_rct, g_t, g_n)
        g_o_cam = tuple(a + torch.where(y.hit, g_o[c] + y.pick(s_go[c], r_go[c], zero), 0.0)
                        for c, a in enumerate(g_o_cam))
        g_d_cam = tuple(a + torch.where(y.hit, g_d[c] + y.pick(s_gd[c], r_gd[c], zero), 0.0)
                        for c, a in enumerate(g_d_cam))
        if N:
            mg = fused.material_grads(spheres.material, N, y.ks, y.is_sph, y.use2, g, like)
            spheres = dc.replace(
                spheres, center=spheres.center + fused.winner_rows(N, y.ks, y.is_sph, g_c, like),
                radius=spheres.radius + fused.winner_rows(N, y.ks, y.is_sph, [g_r], like)[:, 0],
                material=_add_materials(spheres.material, mg))
        if M:
            mg = fused.material_grads(rects.material, M, y.kr, y.is_rct, y.use2, g, like)
            rects = dc.replace(
                rects, origin=rects.origin + fused.winner_rows(M, y.kr, y.is_rct, g_p0, like),
                edge_u=rects.edge_u + fused.winner_rows(M, y.kr, y.is_rct, g_eu, like),
                edge_v=rects.edge_v + fused.winner_rows(M, y.kr, y.is_rct, g_ev, like),
                material=_add_materials(rects.material, mg))

    # ---- camera, and the scene-wide leaves
    g_eye, g_look, g_uph, g_fov = fused.camera_grads(scene.camera, ray, g_o_cam, g_d_cam)
    lights = grads.lights
    if L:
        lights = dc.replace(
            lights, position=torch.stack([torch.stack([x.sum() for x in v]) for v in g_lpos]),
            color=torch.stack([torch.stack([x.sum() for x in v]) for v in g_lcol]))
    camera = dc.replace(grads.camera, eye=g_eye, look_at=g_look, up=g_uph, fov_deg=g_fov)
    grads = dc.replace(grads, spheres=spheres, rects=rects, lights=lights, camera=camera,
                       ambient=torch.stack([x.sum() for x in g_amb]),
                       background=torch.stack([x.sum() for x in g_bg]))
    return sq, grads


def _add_materials(acc, inc):
    """``acc`` plus the winners' material gradients ``inc`` (the fields
    `fused.material_grads` fills)."""
    return dc.replace(acc, **{f: getattr(acc, f) + getattr(inc, f)
                              for f in ("color", "color2", "ka", "kd", "ks", "shininess")})
