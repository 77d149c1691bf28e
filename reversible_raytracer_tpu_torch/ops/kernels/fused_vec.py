"""The object-chunked CUDA kernels (scenes of more than 24 objects), their
wrappers and their plain versions.

- `render_vec`: the forward kernel (``csrc/fused_vec_render.cu``), replacing
  the TPU kernel ``_make_fused_vec.fwd_kernel``
  (reversible_raytracer_tpu/ops/kernels/fused_vec.py:897). It writes the
  (H, W, 3) image and one visibility plane per light. Plain version:
  `render_vec_plain`. On CUDA the image is differentiable through the
  render backward (`_VecRender`, the ``custom_vjp`` of fused_vec.py:1340).
- the render backward kernel (``csrc/fused_vec_render_bwd.cu``),
  replacing ``make_bwd_kernel(False)`` (fused_vec.py:979, ``bwd_call`` at
  :1283), launched only by `_VecRender.backward`: the image cotangent and
  the forward's visibility planes -> the gradient of every scene scalar.
  Plain version: `render_vec_bwd_plain` (autograd);
  `render_vec_bwd_adjoint_eager` runs its hand-written adjoint in eager
  torch.
- `loss_grad_vec`: the fused training step (``csrc/fused_vec_step.cu``),
  replacing ``make_bwd_kernel(True)`` (fused_vec.py:979, ``step_call`` at
  :1310). One call gives the squared-error loss against a target and its
  gradient with respect to every scene scalar. Plain version:
  `loss_grad_vec_plain` (autograd over `render_eager_vec`);
  `loss_grad_vec_adjoint_eager` runs the kernel's hand-written adjoint in
  eager torch.

The three kernels walk, for each warp of 32 pixels of a row, only the
spheres that a conservative per-warp test keeps (``csrc/cull.cuh``;
`cull.primary_candidates` for the primary rays, `cull.warp_candidates` at
tau = 0 for the forward's and the step's shadow rays): a dropped sphere
misses every ray of the warp, so winners, t and visibility are those of the
walk over every sphere, to the bit. Their eager twins (`render_vec_culled`,
`loss_grad_vec_adjoint_eager`, `render_vec_bwd_adjoint_eager`) walk the same
candidates; the plain versions and `render_eager_vec` walk every object.
The forward writes 0 into a light's visibility plane where the ray hits
nothing (no surface, no shadow ray); the backward reads the planes only
where the ray hit.

The scene enters both kernels as the JAX package's packed rows: one flat
vector of the object-count-independent globals (`flatten_globals`), the
sphere rows (`pack_spheres`, ``P_SPH`` scalars each) and the rect rows
(`pack_rects`, ``P_RCT``), each group padded to a multiple of ``CHUNK``
rows with benign far-away objects (`pad_rows`). The kernels read real rows
only, number the rects from the padded sphere count in winner-index space,
and leave the gradient of every pad row exactly zero. The step's gradient
comes back through the transpose of the packing (`unpack_grads`).

Covered: hard shading, spp 1, perspective, Phong, untextured objects, no
environment map, no mirror bounces (the TPU kernels' spp-4 loop, reflection
levels, texel tails and env global are not ported yet and raise). On a CPU
tensor each wrapper runs its plain version; on a CUDA tensor it launches its
kernel or raises. The step (gradient rows of the padded packing) and the
render backward deliver their gradients alike, through `unpack_grads`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ...models.scene import tree_leaves, tree_unflatten
from ..pipeline import RenderConfig, n_vis_planes, render_tile
from ..pipeline_vec import nearest_vec, occluded_any, render_eager_vec, shade_vec
from . import fused
from ._build import Kernel
from .cull import per_pixel, primary_candidates, warp_candidates

P_SPH = 17  # center(3) radius color(3) color2(3) checker cscale ka kd ks shin mirror
P_RCT = 22  # origin(3) edge_u(3) edge_v(3) + the same 13 material scalars
CHUNK = 16  # rows are padded to a multiple of this
# Pad rows: far away (z = 1e6), every quantity finite, never a winner.
SPH_PAD_ROW = np.array([0.0, 0.0, 1e6, 1.0] + [0.5] * 6 + [0.0, 1.0, 0.5, 0.5, 0.0, 1.0, 0.0],
                       np.float32)
RCT_PAD_ROW = np.array([0.0, 0.0, 1e6, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
                       + [0.5] * 6 + [0.0, 1.0, 0.5, 0.5, 0.0, 1.0, 0.0], np.float32)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# n_sph, n_rect, ns_pad, nr_pad, n_light, H, W, shadows, clip
_GEOM = [_I] * 9

VEC_RENDER = Kernel("fused_vec_render", {
    "rrt_vec_render": ([_P, _P, _P, *_GEOM, _P, _P, _P], _I),
    "rrt_vec_render_smem": ([_I, _I, _I], ctypes.c_longlong),
    "rrt_smem_optin": ([], ctypes.c_longlong),
})
VEC_STEP = Kernel("fused_vec_step", {
    "rrt_vec_step": ([_P, _P, _P, *_GEOM, _P, _F, _P, _P, _P], _I),
    "rrt_vec_step_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
    "rrt_vec_step_smem": ([_I, _I, _I], ctypes.c_longlong),
})
VEC_RENDER_BWD = Kernel("fused_vec_render_bwd", {
    "rrt_vec_render_bwd": ([_P, _P, _P, *_GEOM, _P, _P, _P, _P, _P], _I),
    "rrt_vec_render_bwd_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
    "rrt_vec_render_bwd_smem": ([_I, _I, _I], ctypes.c_longlong),
})
KERNELS = (VEC_RENDER, VEC_STEP, VEC_RENDER_BWD)


# ---------------------------------------------------------------------------
# Packed rows
# ---------------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def row_plan(scene_like):
    """(ns_pad, nr_pad): rows of each group after padding (one dummy chunk
    for an empty group)."""
    return (_round_up(max(scene_like.spheres.count, 1), CHUNK),
            _round_up(max(scene_like.rects.count, 1), CHUNK))


def _mat_cols(mat):
    return [mat.color, mat.color2, mat.checker[:, None], mat.checker_scale[:, None],
            mat.ka[:, None], mat.kd[:, None], mat.ks[:, None], mat.shininess[:, None],
            mat.mirror[:, None]]


def pack_spheres(scene):
    """(N, P_SPH) sphere rows (differentiable)."""
    sp = scene.spheres
    if sp.textured:
        raise NotImplementedError("texel tails of the packed rows are not ported yet")
    if sp.count == 0:
        return scene.ambient.new_zeros((0, P_SPH))
    return torch.cat([sp.center, sp.radius[:, None], *_mat_cols(sp.material)], dim=1)


def pack_rects(scene):
    """(M, P_RCT) rect rows (differentiable)."""
    rc = scene.rects
    if rc.textured:
        raise NotImplementedError("texel tails of the packed rows are not ported yet")
    if rc.count == 0:
        return scene.ambient.new_zeros((0, P_RCT))
    return torch.cat([rc.origin, rc.edge_u, rc.edge_v, *_mat_cols(rc.material)], dim=1)


def pad_rows(rows, n_pad: int, pad_row):
    """Pad object rows to ``n_pad`` with copies of the benign ``pad_row``."""
    if rows.shape[0] == n_pad:
        return rows
    fill = torch.as_tensor(pad_row, dtype=rows.dtype, device=rows.device)
    return torch.cat([rows, fill.expand(n_pad - rows.shape[0], -1)])


def globals_tree(scene) -> dict:
    """The object-count-independent parameters, in the key order in which
    JAX flattens a dict (sorted): ambient, background, camera, env, lights."""
    return {"ambient": scene.ambient, "background": scene.background,
            "camera": scene.camera, "env": scene.env, "lights": scene.lights}


def _globals_leaves(scene) -> list:
    return [leaf for v in globals_tree(scene).values() for leaf in tree_leaves(v)]


def flatten_globals(scene):
    """The flat (Sg,) globals vector (differentiable)."""
    return torch.cat([l.reshape(-1) for l in _globals_leaves(scene)])


def globals_offsets(n_light: int) -> dict:
    """Start of each global the kernels read, for a scene without an
    environment map (``csrc/render_common.cuh`` computes the same)."""
    return {"ambient": 0, "background": 3, "c_eye": 6, "c_look": 9, "c_up": 12,
            "c_fov": 15, "l_pos": 16, "l_col": 16 + 3 * n_light, "Sg": 16 + 6 * n_light}


def unpack_grads(scene_like, dglob, dsph, drct):
    """The transpose of the packing: gradients of the flat globals and of
    the (padded) sphere and rect rows -> a Scene of gradients."""
    N, M = scene_like.spheres.count, scene_like.rects.count

    def mat(rows, c0, like):
        return type(like)(color=rows[:, c0:c0 + 3], color2=rows[:, c0 + 3:c0 + 6],
                          checker=rows[:, c0 + 6], checker_scale=rows[:, c0 + 7],
                          ka=rows[:, c0 + 8], kd=rows[:, c0 + 9], ks=rows[:, c0 + 10],
                          shininess=rows[:, c0 + 11], mirror=rows[:, c0 + 12])

    sp, rc = scene_like.spheres, scene_like.rects
    ds, dr = dsph[:N], drct[:M]
    spheres = type(sp)(center=ds[:, 0:3], radius=ds[:, 3], material=mat(ds, 4, sp.material),
                       texture=torch.zeros_like(sp.texture))
    rects = type(rc)(origin=dr[:, 0:3], edge_u=dr[:, 3:6], edge_v=dr[:, 6:9],
                     material=mat(dr, 9, rc.material), texture=torch.zeros_like(rc.texture))
    g_leaves, off = [], 0
    for leaf in _globals_leaves(scene_like):
        g_leaves.append(dglob[off:off + leaf.numel()].reshape(leaf.shape))
        off += leaf.numel()
    if off != dglob.numel():
        raise ValueError(f"dglob has {dglob.numel()} scalars, the globals {off}")
    it = iter(g_leaves)
    back = {k: tree_unflatten(v, [next(it) for _ in tree_leaves(v)])
            for k, v in globals_tree(scene_like).items()}
    return type(scene_like)(spheres=spheres, rects=rects, lights=back["lights"],
                            camera=back["camera"], ambient=back["ambient"],
                            background=back["background"], env=back["env"])


# ---------------------------------------------------------------------------
# Kernel inputs
# ---------------------------------------------------------------------------


def check_vec_kernel_config(scene, cfg: RenderConfig) -> None:
    """Raise NotImplementedError for what the two vec kernels do not cover
    (the TPU kernels' spp-4 loop, reflection levels, texel tails and env
    global are still to port); any object count is covered."""
    why = fused.uncovered(scene, cfg)
    if why is not None:
        raise NotImplementedError(f"the object-chunked CUDA kernels do not cover {why}")


def _geometry(scene, cfg: RenderConfig):
    ns_pad, nr_pad = row_plan(scene)
    return [scene.spheres.count, scene.rects.count, ns_pad, nr_pad, scene.lights.count,
            cfg.height, cfg.width, int(cfg.shadows), int(cfg.clip)]


def most_rows(smem_fn, n_rect: int, n_light: int) -> int:
    """The most spheres, in the rows' steps of 16, whose block needs at most
    the shared memory the current card allows, by ``smem_fn(n_sph, n_rect,
    n_light)`` (bytes a block of some kernel needs)."""
    have = VEC_RENDER.lib().rrt_smem_optin()
    n = 0
    while smem_fn(n + 16, n_rect, n_light) <= have:
        n += 16
    return n


def most_spheres(n_rect: int = 1, n_light: int = 1) -> int:
    """The most spheres that the vec step and render backward take beside
    ``n_rect`` rects and ``n_light`` lights on the current card
    (csrc/vec_step.cuh `step_plan`)."""
    return most_rows(VEC_STEP.lib().rrt_vec_step_smem, n_rect, n_light)


def most_render_spheres(n_rect: int = 1, n_light: int = 1) -> int:
    """The most spheres that the vec forward takes beside ``n_rect`` rects
    and ``n_light`` lights on the current card (csrc/cull.cuh
    `forward_smem`)."""
    return most_rows(VEC_RENDER.lib().rrt_vec_render_smem, n_rect, n_light)


def check_smem(kernel: Kernel, entry: str, scene) -> None:
    """Refuse, with the numbers, a scene whose rows do not fit the shared
    memory a block of this card can have."""
    lib = kernel.lib()
    need = getattr(lib, entry)(scene.spheres.count, scene.rects.count, scene.lights.count)
    have = VEC_RENDER.lib().rrt_smem_optin()
    if need > have:
        raise NotImplementedError(
            f"{kernel.name} needs {need} bytes of shared memory per block for "
            f"{scene.spheres.count} spheres and {scene.rects.count} rects; this card "
            f"allows {have}")


def _cuda_inputs(scene, cfg: RenderConfig):
    check_vec_kernel_config(scene, cfg)
    return packed_inputs(scene)


def packed_inputs(scene):
    """(globals, padded sphere rows, padded rect rows), contiguous float32,
    without gradient."""
    if scene.ambient.dtype != torch.float32:
        raise ValueError(f"the kernels take float32 scenes, not {scene.ambient.dtype}")
    ns_pad, nr_pad = row_plan(scene)
    with torch.no_grad():
        glob = flatten_globals(scene).contiguous()
        sph = pad_rows(pack_spheres(scene), ns_pad, SPH_PAD_ROW).contiguous()
        rct = pad_rows(pack_rects(scene), nr_pad, RCT_PAD_ROW).contiguous()
    if glob.numel() != globals_offsets(scene.lights.count)["Sg"]:
        raise ValueError(f"globals have {glob.numel()} scalars, layout expects "
                         f"{globals_offsets(scene.lights.count)['Sg']}")
    return glob, sph, rct


# ---------------------------------------------------------------------------
# Forward render kernel
# ---------------------------------------------------------------------------


def render_vec_plain(scene, cfg: RenderConfig):
    """`render_eager_vec` with the visibility planes: the (H, W, 3) image and
    the (n_vis, H, W) planes (`n_vis_planes` layout)."""
    (r, g, b), vis = render_tile(scene, cfg, 0, 0, cfg.height, cfg.width, return_vis=True,
                                 shade_fn=shade_vec)
    n_vis = n_vis_planes(scene, cfg)
    planes = torch.stack(vis[:n_vis]) if n_vis else r.new_zeros((0, cfg.height, cfg.width))
    return torch.stack([r, g, b], dim=-1), planes


def render_vec(scene, cfg: RenderConfig):
    """Image (H, W, 3) and visibility planes (n_vis, H, W). The forward
    kernel on CUDA, `render_vec_plain` on the CPU. The image carries the
    scene's gradient on both: on CUDA through the render backward kernel
    (the planes carry none)."""
    dev = scene.device
    if dev.type == "cpu":
        return render_vec_plain(scene, cfg)
    if dev.type != "cuda":
        raise NotImplementedError(f"no render kernel for device {dev}")
    return _VecRender.apply(scene, cfg, *tree_leaves(scene))


class _VecRender(torch.autograd.Function):
    """The vec forward and render backward kernels as one differentiable
    function of the scene's leaves (the ``custom_vjp`` of
    fused_vec.py:1340-1364): the forward saves the packed rows and the
    visibility planes, the backward launches the backward kernel once."""

    @staticmethod
    def forward(ctx, scene, cfg, *leaves):
        glob, sph, rct = _cuda_inputs(scene, cfg)
        check_smem(VEC_RENDER, "rrt_vec_render_smem", scene)
        if any(ctx.needs_input_grad):
            check_smem(VEC_RENDER_BWD, "rrt_vec_render_bwd_smem", scene)
        dev = glob.device
        img = torch.empty((cfg.height, cfg.width, 3), device=dev)
        vis = torch.empty((n_vis_planes(scene, cfg), cfg.height, cfg.width), device=dev)
        VEC_RENDER.call("rrt_vec_render", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(),
                        *_geometry(scene, cfg), img.data_ptr(), vis.data_ptr(),
                        fused._stream(dev))
        VEC_RENDER.launches += 1
        ctx.scene, ctx.cfg = scene, cfg
        ctx.save_for_backward(glob, sph, rct, vis)
        ctx.mark_non_differentiable(vis)
        ctx.set_materialize_grads(False)
        return img, vis

    @staticmethod
    @once_differentiable
    def backward(ctx, g_img, _g_vis):
        if g_img is None:
            return (None, None, *(None for _ in tree_leaves(ctx.scene)))
        glob, sph, rct, vis = ctx.saved_tensors
        grads = _render_bwd_launch(ctx.scene, ctx.cfg, glob, sph, rct, g_img, vis)
        return (None, None, *tree_leaves(grads))


# ---------------------------------------------------------------------------
# Render backward kernel
# ---------------------------------------------------------------------------


def _render_bwd_launch(scene_like, cfg, glob, sph, rct, g_img, vis):
    """The scene's gradient (a Scene) from one backward-kernel call."""
    dev = glob.device
    g_img = fused.cotangent_f32(g_img, cfg)
    geom = _geometry(scene_like, cfg)
    scratch = fused._scratch(VEC_RENDER_BWD, "rrt_vec_render_bwd_scratch_floats", geom[2:7],
                             dev)
    out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel(),), device=dev)
    VEC_RENDER_BWD.call("rrt_vec_render_bwd", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(),
                        *geom, g_img.data_ptr(), vis.data_ptr(), scratch.data_ptr(),
                        out.data_ptr(), fused._stream(dev))
    VEC_RENDER_BWD.launches += 1
    return _unpack_out(scene_like, out, glob, sph, rct)


def _unpack_out(scene_like, out, glob, sph, rct):
    """A step or backward kernel's output [sq, dglob, dsph, drct] -> the
    scene's gradient (a Scene)."""
    a = 1 + glob.numel()
    b = a + sph.numel()
    return unpack_grads(scene_like, out[1:a], out[a:b].view(sph.shape), out[b:].view(rct.shape))


def render_vec_bwd_plain(scene, cfg: RenderConfig, g_img):
    """torch.autograd of `render_eager_vec` for the image cotangent."""
    return fused.autograd_vjp(render_eager_vec, scene, cfg, g_img)


# ---------------------------------------------------------------------------
# Fused training-step kernel
# ---------------------------------------------------------------------------


def loss_grad_vec(scene, cfg: RenderConfig, target, loss: str = "mse"):
    """``(norm * sq_sum, grads as a Scene)`` of the squared error between
    the render of ``scene`` and ``target`` (norm 1/(H*W*3) for mse, 1 for
    sum). One step-kernel call on CUDA; autograd over `render_eager_vec` on
    the CPU."""
    dev = scene.device
    norm = fused._loss_norm(cfg, loss)
    fused._check_target(target, cfg, scene)
    if dev.type == "cpu":
        return loss_grad_vec_plain(scene, cfg, target, loss)
    if dev.type != "cuda":
        raise NotImplementedError(f"no step kernel for device {dev}")
    glob, sph, rct = _cuda_inputs(scene, cfg)
    check_smem(VEC_STEP, "rrt_vec_step_smem", scene)
    target = target.contiguous()
    geom = _geometry(scene, cfg)
    scratch = fused._scratch(VEC_STEP, "rrt_vec_step_scratch_floats", geom[2:7], dev)
    out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel(),), device=dev)
    VEC_STEP.call("rrt_vec_step", glob.data_ptr(), sph.data_ptr(), rct.data_ptr(), *geom,
                  target.data_ptr(), norm, scratch.data_ptr(), out.data_ptr(),
                  fused._stream(dev))
    VEC_STEP.launches += 1
    return norm * out[0], _unpack_out(scene, out, glob, sph, rct)


def loss_grad_vec_plain(scene, cfg: RenderConfig, target, loss: str = "mse"):
    """torch.autograd of ``loss(render_eager_vec(scene), target)``."""
    return fused.autograd_loss_grad(render_eager_vec, scene, cfg, target, loss)


def culled_nearest(scene, o, d):
    """`nearest_vec` over each warp's primary candidates
    (`cull.primary_candidates`), as the step and backward kernels walk."""
    keep = per_pixel(primary_candidates(scene.spheres, scene.camera.eye, d), d[0].shape[1])
    return nearest_vec(scene, o, d, keep)


def culled_visibility(scene, cfg: RenderConfig):
    """The step kernel's visibility of light ``li``: the any-hit test over
    each warp's shadow candidates for its hit pixels (`cull.warp_candidates`
    at tau = 0), then the rects (1 everywhere without shadows)."""
    def visibility(li, so, f, zero, hit):
        if not cfg.shadows:
            return zero + 1.0
        cand = warp_candidates(scene.spheres, so, hit, scene.lights.position[li], 0.0)
        occ = occluded_any(scene, so, f.ldir, f.dist, per_pixel(cand, cfg.width))
        return torch.where(occ, 0.0, 1.0)
    return visibility


def render_vec_culled(scene, cfg: RenderConfig):
    """The vec forward kernel's algorithm in eager torch: the nearest hit
    over each warp's primary candidates and the any-hit shadow test over
    each light's shadow candidates of its hit pixels, then the shading of
    the step's forward. Returns the (H, W, 3) image and the (L, H, W)
    visibility planes (0 where the ray hits nothing, as the kernel writes
    them; none without shadows)."""
    check_vec_kernel_config(scene, cfg)
    with torch.no_grad():
        fw = fused.forward_terms(scene, cfg, culled_nearest, culled_visibility(scene, cfg))
    img = torch.stack(fw.img, dim=-1)
    if not cfg.shadows:
        return img, img.new_zeros((0, cfg.height, cfg.width))
    return img, torch.stack([torch.where(fw.w.hit, vis, 0.0) for _, vis in fw.per_light])


def loss_grad_vec_adjoint_eager(scene, cfg: RenderConfig, target, loss: str = "mse"):
    """The vec step kernel's algorithm in eager torch: the object-vectorized
    nearest hit over each warp's primary candidates and any-hit shadow test
    over its shadow candidates, then the same per-pixel adjoint as the
    small-scene step (`fused.loss_grad_adjoint_eager`): shade, the winning
    object only, the camera. Same contract as `loss_grad_vec`."""
    check_vec_kernel_config(scene, cfg)
    norm = fused._loss_norm(cfg, loss)
    fused._check_target(target, cfg, scene)
    with torch.no_grad():
        sq, grads = fused._adjoint(scene, cfg, culled_nearest,
                                   fused.residual_cotangent(target, norm),
                                   culled_visibility(scene, cfg))
    return norm * sq, grads


def render_vec_bwd_adjoint_eager(scene, cfg: RenderConfig, g_img, vis):
    """The vec render backward kernel's algorithm in eager torch: the vec
    step's adjoint (over the same primary candidates) with the image
    cotangent ``g_img`` in place of the residual and the forward's planes
    ``vis`` in place of the shadow rays: the scene's gradient (a Scene)."""
    check_vec_kernel_config(scene, cfg)
    fused._check_target(g_img, cfg, scene, "cotangent")
    with torch.no_grad():
        return fused._adjoint(scene, cfg, culled_nearest, fused.image_cotangent(g_img),
                              fused.saved_visibility(cfg, vis))[1]
