"""The CUDA kernels of scenes of at most 24 objects, their wrappers and
their plain versions.

- `render_fused`: the forward render kernel (``csrc/fused_render.cu``),
  replacing the TPU kernel ``_make_fused.fwd_kernel``
  (reversible_raytracer_tpu/ops/kernels/fused.py:224). It writes the
  (H, W, 3) image and the shadow-visibility planes (per subsample and
  light). Plain version:
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

Mirror bounces (``cfg.reflections`` = K, 1 to `MAX_REFLECTIONS`) are the
TPU kernels' trace of `shade`'s bounce recursion: each kernel has an
instance of each K (REFL), whose level l + 1 is traced from level l's shadow
origin along the reflected direction where every level above hit, the
levels blended unclipped deepest first by each winner's mirror coefficient;
the forward writes (1 + K) L planes a subsample, bounce-major. The eager
twins run the same levels (`forward_terms`, `_adjoint`). More levels are
refused by name (`uncovered`).

spp 4 (2x2 supersampling) is the TPU kernels' loop inside each kernel,
with a bounce and with texel grids too: a pixel is the average of four
clipped subsamples at quarter-pixel offsets (`pipeline.SPP_OFFSETS`), summed
in that order and times 0.25, as `render_tile` sums them. The forward writes
each subsample's (1 + R) L planes in turn; the step's residual is of the
average, so it runs the four forwards before the adjoints, keeping each
subsample's shadow bits of every level (`subsample_adjoint` is its eager
twin); the render backward gives each subsample a quarter of the average's
cotangent and its own planes.

Object textures and the environment map (spp 1 or 4; the env with one
bounce, not object textures with one, as in the JAX package's
fused.py:191-197) are each kernel's textured instance (TEX): the texel
grids ride in the flat scene (`flat_offsets`), the winner's base colour is
its grid's bilinear sample and a missed ray's colour the environment's
(`pipeline.sample_texture`, `pipeline.sphere_uv`), and the adjoint
scatters each hit's four corners into its texels and carries the weights'
gradient through the hit's coordinates (`grid_adjoint`, `uv_adjoint`).

Row bands (the JAX package's ``row0`` / ``out_height``, fused.py:459-532):
every wrapper and plain version takes ``row0`` and ``out_height`` (the steps
also ``norm``) and renders, steps or pulls back only those whole image rows
(`pipeline.band_config`); the kernels' ``_band`` entries launch over the
band's rows alone, each ray that of its image row. A step's default
``norm`` is the whole image's 1/(H W 3) for mse, so the bands' losses and
gradients sum to the whole image's (the sharded step, `parallel.shard`).

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

from ...models.scene import scene_textured, tree_leaves, tree_map, tree_unflatten
from .. import vecmath as vm
from ..pipeline import (
    BIG,
    SHADOW_EPS,
    T_EPS,
    SPP_OFFSETS,
    RenderConfig,
    band_config,
    camera_basis,
    intersect_rect,
    intersect_sphere,
    n_vis_planes,
    occluded,
    primary_rays,
    reflect_dir,
    render_tile,
    shadow_origin,
    soft_checker_q,
    sample_grid,
    sphere_uv,
    trace_nearest,
)
from ._build import Kernel

MAX_OBJECTS = 24
MAX_LIGHTS = 16
# Bounce levels the kernels take: a spp-4 step keeps each subsample's (1 + K)
# L shadow bits in one 64-bit word, so K = 3 at 16 lights.
MAX_REFLECTIONS = 3
# Shared memory a block of the H100 may opt in to (227 KB): the textured step
# and render backward stage the scene, texels included, and each warp's row of
# every scalar's gradient (`step_smem_bytes`).
MAX_BLOCK_SMEM = 232448

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GEOM = [_I, _I, _I, _I, _I, _I, _I]  # n_sph, n_rect, n_light, H, W, shadows, clip

# Each kernel's entry takes the spp (1 or 4) and the bounce levels (0 to 3)
# after the geometry; the entries without them are spp 1 or the given spp
# without a bounce, for tools/ and for checkouts from before them. The
# textured instances (``_tex``) take the bounce levels, the spp (in the
# ``_band`` entries; the whole image's are spp 1) and the texel grids' sides:
# spheres', rects' and the environment's, 0 for none (`texel_sizes`).
_TEX = [_I, _I, _I]
# The wrappers call the ``_band`` entries alone: the band's first image row
# and the image's height after the geometry, whose H is the band's rows; the
# others are the whole image, for tools/ and for checkouts from before them.
_BAND = [_I, _I]  # row0, image_h
FUSED_RENDER = Kernel("fused_render", {
    "rrt_render_tex_band": ([_P, *_GEOM, *_BAND, _I, _I, *_TEX, _P, _P, _P], _I),
    "rrt_render_refl_band": ([_P, *_GEOM, *_BAND, _I, _I, _P, _P, _P], _I),
    "rrt_render_tex": ([_P, *_GEOM, _I, *_TEX, _P, _P, _P], _I),
    "rrt_render_refl": ([_P, *_GEOM, _I, _I, _P, _P, _P], _I),
    "rrt_render_spp": ([_P, *_GEOM, _I, _P, _P, _P], _I),
    "rrt_render": ([_P, *_GEOM, _P, _P, _P], _I),
})
FUSED_STEP = Kernel("fused_step", {
    "rrt_step_tex_band": ([_P, *_GEOM, *_BAND, _I, _I, *_TEX, _P, _F, _P, _P, _P], _I),
    "rrt_step_refl_band": ([_P, *_GEOM, *_BAND, _I, _I, _P, _F, _P, _P, _P], _I),
    "rrt_step_tex": ([_P, *_GEOM, _I, *_TEX, _P, _F, _P, _P, _P], _I),
    "rrt_step_tex_scratch_floats": ([_I, _I, _I, _I, _I, *_TEX], ctypes.c_longlong),
    "rrt_step_refl": ([_P, *_GEOM, _I, _I, _P, _F, _P, _P, _P], _I),
    "rrt_step_spp": ([_P, *_GEOM, _I, _P, _F, _P, _P, _P], _I),
    "rrt_step": ([_P, *_GEOM, _P, _F, _P, _P, _P], _I),
    "rrt_step_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
})
FUSED_RENDER_BWD = Kernel("fused_render_bwd", {
    "rrt_render_bwd_tex_band": ([_P, *_GEOM, *_BAND, _I, _I, *_TEX, _P, _P, _P, _P, _P], _I),
    "rrt_render_bwd_refl_band": ([_P, *_GEOM, *_BAND, _I, _I, _P, _P, _P, _P, _P], _I),
    "rrt_render_bwd_tex": ([_P, *_GEOM, _I, *_TEX, _P, _P, _P, _P, _P], _I),
    "rrt_render_bwd_tex_scratch_floats": ([_I, _I, _I, _I, _I, *_TEX], ctypes.c_longlong),
    "rrt_render_bwd_refl": ([_P, *_GEOM, _I, _I, _P, _P, _P, _P, _P], _I),
    "rrt_render_bwd_spp": ([_P, *_GEOM, _I, _P, _P, _P, _P, _P], _I),
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


def texel_sizes(scene_like):
    """(ks, kr, ke): the side of the spheres', the rects' and the
    environment's texel grids, 0 where there is none."""
    sp, rc = scene_like.spheres, scene_like.rects
    return (sp.texture.shape[1] if sp.textured else 0, rc.texture.shape[1] if rc.textured else 0,
            scene_like.env.shape[0] if scene_like.env_mapped else 0)


def flat_offsets(n_sph: int, n_rect: int, n_light: int, ks: int = 0, kr: int = 0,
                 ke: int = 0) -> dict:
    """Start of each leaf the kernels read (``csrc/render_common.cuh``
    make_layout and make_tex_layout compute the same): the spheres' texels
    (N ks^2 3) follow their mirror leaf, the rects' (M kr^2 3) theirs, and the
    environment's (ke^2 3) end the vector."""
    N, M, L = n_sph, n_rect, n_light
    R = 17 * N + N * ks * ks * 3
    Lb = R + 22 * M + M * kr * kr * 3
    C = Lb + 6 * L
    return {
        "s_center": 0, "s_radius": 3 * N, "s_color": 4 * N, "s_color2": 7 * N,
        "s_checker": 10 * N, "s_cscale": 11 * N, "s_ka": 12 * N, "s_kd": 13 * N,
        "s_ks": 14 * N, "s_shin": 15 * N, "s_mirror": 16 * N,
        "r_origin": R, "r_eu": R + 3 * M, "r_ev": R + 6 * M, "r_color": R + 9 * M,
        "r_color2": R + 12 * M, "r_checker": R + 15 * M, "r_cscale": R + 16 * M,
        "r_ka": R + 17 * M, "r_kd": R + 18 * M, "r_ks": R + 19 * M, "r_shin": R + 20 * M,
        "r_mirror": R + 21 * M,
        "l_pos": Lb, "l_col": Lb + 3 * L,
        "c_eye": C, "c_look": C + 3, "c_up": C + 6, "c_fov": C + 9,
        "ambient": C + 10, "background": C + 13, "s_tex": 17 * N, "r_tex": R + 22 * M,
        "env": C + 16, "S": C + 16 + ke * ke * 3,
    }


def step_smem_bytes(n_sph: int, n_rect: int, n_light: int, ks: int = 0, kr: int = 0,
                    ke: int = 0) -> int:
    """Shared memory of a block of the textured step and render backward
    (csrc/flat_step.cuh flat_plan): block 0's row subsets, the scene, 8 warp
    rows of 1 + S + 10 slots, 6 L light sums a thread, and 8 warps' staging
    of 32 texel records of 16 words."""
    S = flat_offsets(n_sph, n_rect, n_light, ks, kr, ke)["S"]
    row = 1 + S + 10
    rowp = (row + 3) // 4 * 4
    sub = 1 if rowp // 4 >= 256 else 256 // (rowp // 4)
    return 4 * (sub * rowp + S + 8 * row + 6 * n_light * 256 + 8 * 32 * 16)


def uncovered(scene, cfg: RenderConfig, texels: bool = False, env: bool = False):
    """What the kernels do not cover (a reason), or None: with ``texels``
    the unrolled family's (object textures and the environment map, the
    environment with a bounce), with ``env`` the object-chunked family's
    (object textures and the environment map, either with a bounce;
    `fused_vec.check_vec_kernel_config` adds the shared memory of object
    texel grids), else every family's (no texel grid); each at spp 1 and 4,
    with or without bounce levels. The spp changes no block's shared
    memory (`step_smem_bytes`); nor does the bounce count, 0 to
    `MAX_REFLECTIONS` levels."""
    if cfg.soft_tau > 0.0 or cfg.checker_tau > 0.0:
        return "soft_tau/checker_tau"
    if cfg.spp not in SPP_OFFSETS:
        return f"spp={cfg.spp} (spp is 1 or 4)"
    if cfg.reflections > MAX_REFLECTIONS:
        return (f"reflections > {MAX_REFLECTIONS} (reflections={cfg.reflections}; the kernels "
                f"take at most {MAX_REFLECTIONS} bounce levels: a spp-4 step keeps a subsample's "
                f"(1 + K) L shadow bits in one 64-bit word, and (1 + {cfg.reflections}) x "
                f"{MAX_LIGHTS} lights = {(1 + cfg.reflections) * MAX_LIGHTS} > 64)")
    if cfg.shader != "phong":
        return f"the {cfg.shader} shader"
    if cfg.projection != "perspective":
        return f"the {cfg.projection} projection"
    if scene.lights.count > MAX_LIGHTS:
        return f"more than {MAX_LIGHTS} lights"
    objects = scene.spheres.textured or scene.rects.textured
    if not texels:
        if objects and not env:
            return "object textures"
        if scene.env_mapped and not env:
            return "environment maps"
        return None
    if not scene_textured(scene):
        return None
    if objects and cfg.reflections:
        return ("object textures with mirror reflections (the JAX package's kernels refuse "
                "that pair too, fused.py:191-197)")
    need = step_smem_bytes(scene.spheres.count, scene.rects.count, scene.lights.count,
                           *texel_sizes(scene))
    if need > MAX_BLOCK_SMEM:
        S = flat_offsets(scene.spheres.count, scene.rects.count, scene.lights.count,
                         *texel_sizes(scene))["S"]
        return (f"a texel grid this large: {S} scene scalars need {need} bytes of shared "
                f"memory a block in the textured step, above the {MAX_BLOCK_SMEM} a block has")
    return None


def check_kernel_config(scene, cfg: RenderConfig) -> None:
    """Raise NotImplementedError for what the two kernels do not cover."""
    why = uncovered(scene, cfg, texels=True)
    if why is None and scene.spheres.count + scene.rects.count > MAX_OBJECTS:
        why = f"more than {MAX_OBJECTS} objects"
    if why is not None:
        raise NotImplementedError(f"the CUDA kernels do not cover {why}")


def _geometry(scene, cfg: RenderConfig):
    return [scene.spheres.count, scene.rects.count, scene.lights.count,
            cfg.height, cfg.width, int(cfg.shadows), int(cfg.clip)]


def band_args(cfg: RenderConfig):
    """The ``_band`` entries' arguments after the geometry (whose H is the
    band's rows): the band's first image row and the image's height."""
    return [cfg.row0, cfg.image_height]


def instance(scene_like, cfg: RenderConfig):
    """The kernels' instance the wrappers launch: (the suffix of its C
    entries, their arguments after the geometry, the suffix of its scratch
    entries, their arguments after the image size). The textured instances
    (``_tex``) take the bounce levels, the spp and the grids' sides, the
    others (``_refl``) the spp and the bounce levels."""
    if scene_textured(scene_like):
        tex = texel_sizes(scene_like)
        return "_tex", (cfg.reflections, cfg.spp, *tex), "_tex", tex
    return "_refl", (cfg.spp, cfg.reflections), "", ()


def _cuda_flat(scene, cfg):
    check_kernel_config(scene, cfg)
    if scene.ambient.dtype != torch.float32:
        raise ValueError(f"the kernels take float32 scenes, not {scene.ambient.dtype}")
    flat = flatten_scene(scene).detach().contiguous()
    off = flat_offsets(scene.spheres.count, scene.rects.count, scene.lights.count,
                       *texel_sizes(scene))
    if flat.numel() != off["S"]:
        raise ValueError(f"flat scene has {flat.numel()} scalars, layout expects {off['S']}")
    return flat


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_HOST_QUERIES: dict = {}


def host_query(kernel: Kernel, entry: str, *args, device=None) -> int:
    """``kernel``'s host entry ``entry(*args)`` (a size that depends on the
    card), asked once per card and arguments: a launch inside a CUDA graph
    capture then makes no query of the card."""
    key = (kernel.name, entry, args, torch.cuda.current_device() if device is None else device)
    n = _HOST_QUERIES.get(key)
    if n is None:
        n = _HOST_QUERIES[key] = int(getattr(kernel.lib(), entry)(*args))
    return n


def _scratch(kernel: Kernel, entry: str, dims, dev):
    """The partial rows a step or backward call writes, sized for this
    card's grid (``dims``: the entry's scene counts and image size)."""
    n = host_query(kernel, entry, *dims, device=dev.index)
    if n <= 0:
        raise RuntimeError(f"{kernel.name}: the card's SM count could not be read")
    return torch.empty((n,), device=dev)


# ---------------------------------------------------------------------------
# Forward render kernel
# ---------------------------------------------------------------------------


def render_fused_plain(scene, cfg: RenderConfig, row0=0, out_height: int | None = None):
    """`render_tile(return_vis=True)` in eager torch: the (H, W, 3) image
    and the (n_vis, H, W) visibility planes (`n_vis_planes` layout), H the
    rows of the band of ``out_height`` rows from ``row0`` (`band_config`)."""
    cfg = band_config(cfg, row0, out_height)
    (r, g, b), vis = render_tile(scene, cfg, cfg.row0, 0, cfg.height, cfg.width,
                                 return_vis=True)
    n_vis = n_vis_planes(scene, cfg)
    planes = (torch.stack(vis[:n_vis]) if n_vis
              else r.new_zeros((0, cfg.height, cfg.width)))
    return torch.stack([r, g, b], dim=-1), planes


def render_fused(scene, cfg: RenderConfig, row0=0, out_height: int | None = None):
    """Image (H, W, 3) and visibility planes (n_vis, H, W), of the band of
    ``out_height`` rows from ``row0`` if given (H its rows). The forward
    kernel on CUDA, `render_fused_plain` on the CPU: the same image to the
    bit, the same planes where the ray hit an object; where it hit nothing
    the kernel's planes are 0 (the plain version's hold the shadow test of a
    ray from the BIG sentinel; the render backward reads neither). With
    bounces, a bounce level's plane is the same where it and every level
    above hit, and 0 where one of them missed. The image carries the scene's
    gradient on both: on CUDA through the render backward kernel (the planes
    carry none)."""
    dev = scene.device
    cfg = band_config(cfg, row0, out_height)
    if dev.type == "cpu":
        return render_fused_plain(scene, cfg)
    if dev.type != "cuda":
        raise NotImplementedError(f"no render kernel for device {dev}")
    return _FusedRender.apply(scene, cfg, *tree_leaves(scene))


def level_hits(scene, cfg: RenderConfig, off=(0.0, 0.0)):
    """Per bounce level, the (H, W) pixels whose ray at the subsample offset
    ``off`` (`pipeline.SPP_OFFSETS`; the pixel centre at spp 1) hit an
    object: level 0's primary rays, and at each of the ``cfg.reflections``
    bounce levels the reflected rays where every level above hit too: where
    the forward kernel's planes of that level and subsample are the plain
    version's (elsewhere the kernel's are 0)."""
    o, d = primary_rays(scene, cfg, off)
    t, hit, at = trace_nearest(scene, o, d, cfg.shape)
    hits = [hit]
    for _ in range(cfg.reflections):
        n = (at["nx"], at["ny"], at["nz"])
        o, d = shadow_origin(o, d, t, n), reflect_dir(d, n)
        t, hit1, at = trace_nearest(scene, o, d, cfg.shape)
        hits.append(hits[-1] & hit1)
    return hits


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
        sfx, args, _, _ = instance(scene, cfg)
        FUSED_RENDER.call(f"rrt_render{sfx}_band", flat.data_ptr(), *_geometry(scene, cfg),
                          *band_args(cfg), *args, img.data_ptr(), vis.data_ptr(),
                          _stream(flat.device))
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
    sfx, args, ssfx, sargs = instance(scene_like, cfg)
    scratch = _scratch(FUSED_RENDER_BWD, f"rrt_render_bwd{ssfx}_scratch_floats",
                       (*geom[:5], *sargs), dev)
    out = torch.empty((1 + flat.numel(),), device=dev)
    FUSED_RENDER_BWD.call(f"rrt_render_bwd{sfx}_band", flat.data_ptr(), *geom, *band_args(cfg),
                          *args, g_img.data_ptr(), vis.data_ptr(), scratch.data_ptr(),
                          out.data_ptr(), _stream(dev))
    FUSED_RENDER_BWD.launches += 1
    return out[1:]


def render_fused_bwd_plain(scene, cfg: RenderConfig, g_img):
    """torch.autograd of `render_eager` for the image cotangent ``g_img``."""
    from ..render import render_eager

    return autograd_vjp(render_eager, scene, cfg, g_img)


# ---------------------------------------------------------------------------
# Fused training-step kernel
# ---------------------------------------------------------------------------


def _loss_norm(cfg: RenderConfig, loss: str, norm: float | None = None) -> float:
    """``norm`` if given, else the whole image's: 1/(H W 3) for mse (of a
    band too, as the JAX package's ``norm`` of a shard band), 1 for sum."""
    if loss not in ("mse", "sum"):
        raise ValueError(f"the step kernel takes loss 'mse' or 'sum', not {loss!r}")
    if norm is not None:
        return float(norm)
    return 1.0 / (cfg.image_height * cfg.width * 3) if loss == "mse" else 1.0


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


def loss_grad_fused(scene, cfg: RenderConfig, target, loss: str = "mse", row0=0,
                    out_height: int | None = None, norm: float | None = None):
    """``(norm * sq_sum, grads as a Scene)`` of the squared error between
    the render of ``scene`` and ``target``, with ``norm`` = 1/(H*W*3) for
    mse and 1 for sum unless given. With ``row0`` / ``out_height`` only that
    band is rendered and ``target`` is the band's (its norm still the whole
    image's). One step-kernel launch on CUDA; autograd over the eager
    renderer on the CPU."""
    dev = scene.device
    cfg = band_config(cfg, row0, out_height)
    w = _loss_norm(cfg, loss, norm)
    _check_target(target, cfg, scene)
    if dev.type == "cpu":  # the plain version takes the mean where no band or norm is given
        return loss_grad_fused_plain(scene, cfg, target, loss, norm=norm)
    if dev.type != "cuda":
        raise NotImplementedError(f"no step kernel for device {dev}")
    flat = _cuda_flat(scene, cfg)
    target = target.contiguous()
    geom = _geometry(scene, cfg)
    sfx, args, ssfx, sargs = instance(scene, cfg)
    scratch = _scratch(FUSED_STEP, f"rrt_step{ssfx}_scratch_floats", (*geom[:5], *sargs), dev)
    out = torch.empty((1 + flat.numel(),), device=dev)
    FUSED_STEP.call(f"rrt_step{sfx}_band", flat.data_ptr(), *geom, *band_args(cfg), *args,
                    target.data_ptr(), w, scratch.data_ptr(), out.data_ptr(), _stream(dev))
    FUSED_STEP.launches += 1
    return w * out[0], unflatten_scene(scene, out[1:])


def loss_grad_fused_plain(scene, cfg: RenderConfig, target, loss: str = "mse", row0=0,
                          out_height: int | None = None, norm: float | None = None):
    """torch.autograd of ``loss(render_eager(scene), target)`` (of the band's
    ``norm`` times its squared error, `autograd_loss_grad`)."""
    from ..render import render_eager

    return autograd_loss_grad(render_eager, scene, band_config(cfg, row0, out_height), target,
                              loss, norm)


def autograd_loss_grad(render_fn, scene, cfg: RenderConfig, target, loss: str = "mse",
                       norm: float | None = None):
    """``(loss, grads as a Scene)`` of ``loss(render_fn(scene, cfg), target)``
    by torch autograd (the plain version of a step kernel). For a band
    (`band_config`), or with ``norm`` given, the loss is ``norm`` (by
    default the whole image's, `_loss_norm`) times the squared error's sum."""
    from ..render import LOSSES

    if norm is None and cfg.height == cfg.image_height:
        loss_fn = LOSSES[loss]
    else:
        w = _loss_norm(cfg, loss, norm)
        loss_fn = lambda img, t: w * torch.sum((img - t) * (img - t))  # noqa: E731
    leaves = [l.detach().clone().requires_grad_(True) for l in tree_leaves(scene)]
    with torch.enable_grad():
        value = loss_fn(render_fn(tree_unflatten(scene, leaves), cfg), target)
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
        sq, grads = subsample_adjoint(scene, cfg, _nearest_chain,
                                      residual_cotangent(target, norm),
                                      lambda q: traced_visibility(scene, cfg, occluded))
    return norm * sq, grads


def render_bwd_adjoint_eager(scene, cfg: RenderConfig, g_img, vis):
    """The render backward kernel's algorithm in eager torch: the step's
    adjoint (`_adjoint`) with the image cotangent ``g_img`` (H, W, 3) in
    place of the residual and the forward's visibility planes ``vis`` in
    place of the shadow rays: the scene's gradient (a Scene)."""
    check_kernel_config(scene, cfg)
    _check_target(g_img, cfg, scene, "cotangent")
    with torch.no_grad():
        return subsample_adjoint(scene, cfg, _nearest_chain, image_cotangent(g_img),
                                 subsample_planes(scene, cfg, vis))[1]


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
    """The step's visibility of light ``li`` (at any bounce ``level``): a
    shadow ray from the shadow origin toward it, tested by ``occluded_fn``
    (1 everywhere without shadows)."""
    def visibility(li, so, f, zero, hit, level=0):
        if not cfg.shadows:
            return zero + 1.0
        return torch.where(occluded_fn(scene, so, f.ldir, f.dist), 0.0, 1.0)
    return visibility


def saved_visibility(cfg: RenderConfig, vis, n_light: int):
    """The render backward's visibility of light ``li`` at bounce ``level``:
    the forward's plane level L + li (`n_vis_planes` layout; a miss pixel's
    value is never used, as its cotangents are masked to zero)."""
    if tuple(vis.shape[1:]) != (cfg.height, cfg.width):
        raise ValueError(f"visibility planes {tuple(vis.shape)} do not fit "
                         f"{(cfg.height, cfg.width)}")
    return lambda li, so, f, zero, hit, level=0: (vis[level * n_light + li].to(zero.dtype)
                                                  if cfg.shadows else zero + 1.0)


def subsample_planes(scene_like, cfg: RenderConfig, vis):
    """``q -> saved_visibility`` of subsample q's planes (its (1 + R) L
    planes of the forward's (spp (1 + R) L, H, W) planes for R bounces, the
    `n_vis_planes` layout), as `subsample_adjoint` takes its visibility."""
    L = scene_like.lights.count
    P = L * (1 + cfg.reflections)
    return lambda q: saved_visibility(cfg, vis[q * P:(q + 1) * P], L)


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


def primary_ray_terms(scene, cfg: RenderConfig, off=(0.0, 0.0)):
    """The perspective primary rays at the subsample offset ``off`` (rows,
    columns; `pipeline.SPP_OFFSETS`) with the intermediates their adjoint
    needs: o = eye, d = normalize(dt), dt = fwd + right sx + up sy. Of a
    band's rows (`pipeline.BandConfig`), each the ray of its image row."""
    H, W, Hi = cfg.height, cfg.width, cfg.image_height
    like = dict(device=scene.device, dtype=scene.ambient.dtype)
    right, up, fwd = camera_basis(scene.camera)
    tanf = torch.tan(scene.camera.fov_deg * (math.pi / 180.0) * 0.5)
    aspect = W / Hi
    ii = (torch.arange(H, **like) + cfg.row0)[:, None].expand(H, W) + off[0]
    jj = torch.arange(W, **like)[None, :].expand(H, W) + off[1]
    ax = (jj + 0.5) * (2.0 / W) - 1.0
    ay = 1.0 - (ii + 0.5) * (2.0 / Hi)
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
    live = pos & (shin * torch.log(safe_r) < vm.POW_LOG_MAX)  # `safe_pow`'s cap
    g_rdotv = torch.where(live, g_pw * f.pw * shin / safe_r, 0.0)
    g.shin = torch.where(live, g_pw * f.pw * torch.log(safe_r), 0.0)
    g_rdv = g_rdotv * vm.maxgrad(f.rdv)
    g_refl = vm.vscale(view, g_rdv)
    g.d = vm.vneg(vm.vscale(f.refl, g_rdv))
    g_ndotl = g_ndotl + 2.0 * vm.vdot(g_refl, n)
    g_ndl = g_ndotl * vm.maxgrad(f.ndl)
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


def sphere_winner_adjoint(o, d, t, c, r, g_t, g_n, soft=None, g_pl=None):
    """Cotangents (o, d, center, radius) of a winning sphere's n = (o + d t
    - c) / r and t = -b - sqrt(disc) (-b for a soft layer's near miss: no
    sqrt term where the ray misses). ``soft = (tau, g_alpha)`` adds the
    coverage alpha = sigmoid(disc / (tau r^2)); ``g_pl`` a cotangent of the
    local hit position p - c besides the normal's (the soft checker's)."""
    inv_r = 1.0 / r
    pl = vm.vsub(vm.vadd(o, vm.vscale(d, t)), c)
    g_pl = vm.vscale(g_n, inv_r) if g_pl is None else vm.vadd(vm.vscale(g_n, inv_r), g_pl)
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


def rect_winner_adjoint(o, d, p0, eu, ev, is_rct, g_t, g_n, g_ab=None):
    """Cotangents (o, d, origin, edge_u, edge_v) of a winning rect's t =
    ((p0 - o) . nraw) / (d . nraw) and n = facing * normalize(nraw), nraw =
    edge_u x edge_v (facing is a sign with no gradient). ``g_ab``, the
    cotangents of its in-face coordinates (a textured rect's): a = (rel .
    edge_u) / |edge_u|^2, b likewise, rel = o + d t - origin."""
    nraw = vm.vcross(eu, ev)
    nn2 = vm.vdot(nraw, nraw)
    inv_n = torch.rsqrt(torch.where(nn2 > 1e-12, nn2, 1.0))
    facing = torch.where(vm.vdot(vm.vscale(nraw, inv_n), d) < 0.0, 1.0, -1.0)
    denom = torch.where(is_rct, vm.vdot(d, nraw), 1.0)
    num = vm.vdot(vm.vsub(p0, o), nraw)
    if g_ab is not None:
        t = num / denom
        rel = vm.vsub(vm.vadd(o, vm.vscale(d, t)), p0)
        inv_u2, inv_v2 = 1.0 / vm.vdot(eu, eu), 1.0 / vm.vdot(ev, ev)
        ga, gb = g_ab[0] * inv_u2, g_ab[1] * inv_v2
        g_rel = vm.vadd(vm.vscale(eu, ga), vm.vscale(ev, gb))
        g_eu_ab = vm.vsub(vm.vscale(rel, ga), vm.vscale(eu, 2.0 * ga * vm.vdot(rel, eu) * inv_u2))
        g_ev_ab = vm.vsub(vm.vscale(rel, gb), vm.vscale(ev, 2.0 * gb * vm.vdot(rel, ev) * inv_v2))
        g_t = g_t + vm.vdot(g_rel, d)
    g_num = g_t / denom
    g_den = -g_t * num / (denom * denom)
    g_p0 = vm.vscale(nraw, g_num)
    g_nraw = vm.vscale(vm.vsub(p0, o), g_num)
    g_nraw = vm.vadd(g_nraw, vm.vscale(d, g_den))
    g_nraw = vm.vadd(g_nraw, _normalize_adjoint(nraw, inv_n, nn2, vm.vscale(g_n, facing)))
    out = (vm.vneg(g_p0), vm.vscale(nraw, g_den), g_p0, vm.vcross(ev, g_nraw),
           vm.vcross(g_nraw, eu))
    if g_ab is None:
        return out
    return (vm.vadd(out[0], g_rel), vm.vadd(out[1], vm.vscale(g_rel, t)), vm.vsub(out[2], g_rel),
            vm.vadd(out[3], g_eu_ab), vm.vadd(out[4], g_ev_ab))


def grid_adjoint(ts, g, mask, n_rows: int):
    """The adjoint of a `pipeline.sample_grid` ``ts`` for the colour cotangent ``g``
    where ``mask`` holds: the (n_rows, 3) texel rows' gradient (each pixel's
    four corners, weights (1 - fi)(1 - fj), (1 - fi) fj, fi (1 - fj), fi fj,
    scattered), and the per-pixel cotangents of the coordinates (a, b)
    through the weights (not masked)."""
    fi, fj, t = ts.fi, ts.fj, ts.t
    weights = ((1.0 - fi) * (1.0 - fj), (1.0 - fi) * fj, fi * (1.0 - fj), fi * fj)
    out = torch.zeros((n_rows, 3), dtype=fi.dtype, device=fi.device)
    for ix, wq in zip(ts.idx, weights):
        vals = torch.stack([torch.where(mask, g[c] * wq, 0.0) for c in range(3)], dim=-1)
        out.index_add_(0, ix.reshape(-1), vals.reshape(-1, 3))
    g_fi = sum(g[c] * (((1.0 - fj) * t[2][..., c] + fj * t[3][..., c])
                       - ((1.0 - fj) * t[0][..., c] + fj * t[1][..., c])) for c in range(3))
    g_fj = sum(g[c] * ((1.0 - fi) * (t[1][..., c] - t[0][..., c])
                       + fi * (t[3][..., c] - t[2][..., c])) for c in range(3))
    return out, g_fi * ts.dfi, g_fj * ts.dfj


def _atan01_grad(r):
    """d `vecmath._atan_01` / dr: the derivative of its polynomial (not 1 /
    (1 + r^2)), through the fold x = (r - 1) / (r + 1) above tan(pi/8)."""
    fold = r > vm._TAN_PI_8
    x = torch.where(fold, (r - 1.0) / (r + 1.0), r)
    z = x * x
    p, dp = vm._ATAN_P[0], 0.0
    for c in vm._ATAN_P[1:]:
        dp = dp * z + p
        p = p * z + c
    dy = (dp * z + p) * 2.0 * x * x + p * z + 1.0  # d (p(z) z x + x) / dx
    return torch.where(fold, dy * 2.0 / ((r + 1.0) * (r + 1.0)), dy)


def atan2_adjoint(y, x, g):
    """(cotangent of y, of x) of `vecmath.atan2` for the cotangent ``g`` of
    its value, as autograd takes them through its selects: the max and min
    split a tie, |.| has gradient 0 at 0."""
    ax, ay = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(ax, ay), torch.minimum(ax, ay)
    den = torch.where(hi > 0.0, hi, 1.0)
    r = lo / den
    g = torch.where(y < 0.0, -g, g)
    g = torch.where(x < 0.0, -g, g)
    g = torch.where(ay > ax, -g, g)
    g_r = g * _atan01_grad(r)
    g_lo = g_r / den
    g_hi = torch.where(hi > 0.0, -g_r * r / den, 0.0)
    # d max(a, b) / da = d min(b, a) / da = maxgrad(a - b), ties split
    g_ax = g_hi * vm.maxgrad(ax - ay) + g_lo * vm.maxgrad(ay - ax)
    g_ay = g_hi * vm.maxgrad(ay - ax) + g_lo * vm.maxgrad(ax - ay)
    return g_ay * torch.sign(y), g_ax * torch.sign(x)


def asin_adjoint(t, g):
    """Cotangent of t of `vecmath.asin` = atan2(t, guarded sqrt((1 - t)(1 +
    t)))."""
    w = (1.0 - t) * (1.0 + t)
    s = torch.sqrt(torch.where(w > 0.0, w, 1.0))
    g_y, g_x = atan2_adjoint(t, s, g)
    g_w = torch.where(w > 0.0, g_x * 0.5 / s, 0.0)
    return g_y - g_w * (1.0 + t) + g_w * (1.0 - t)


def uv_adjoint(n, g_u, g_v):
    """Cotangent (a Vec3) of the direction ``n`` of `pipeline.sphere_uv` for
    the cotangents of its (u, v)."""
    nx, ny, nz = n
    g_nz, g_nx = atan2_adjoint(nz, nx, g_u * (0.5 / math.pi))
    lo, hi = -1.0 + 1e-6, 1.0 - 1e-6
    g_cy = asin_adjoint(vm.clip(ny, lo, hi), -g_v / math.pi)
    g_ny = g_cy * vm.maxgrad(ny - lo) * vm.maxgrad(hi - torch.clamp_min(ny, lo))
    return g_nx, g_ny, g_nz


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


def material_grads(mat_like, count, idx, mask, use2, g, like, textured=False):
    """The material leaves' gradients of the winners: ``g`` holds the
    per-pixel cotangents base (Vec3), ka, kd, ks, shin, and mir (the mirror
    coefficient's, or None for none); base goes to color or color2 as the
    checker picked, and to neither for a ``textured`` group (its texels take
    it)."""
    rows = winner_rows(count, idx, mask, [g.ka, g.kd, g.ks, g.shin], like)
    colour = mask & ~torch.full_like(mask, textured)
    out = dc.replace(mat_like,
                     color=winner_rows(count, idx, colour & ~use2, g.base, like),
                     color2=winner_rows(count, idx, colour & use2, g.base, like),
                     ka=rows[:, 0], kd=rows[:, 1], ks=rows[:, 2], shininess=rows[:, 3])
    if getattr(g, "mir", None) is not None:
        out = dc.replace(out, mirror=winner_rows(count, idx, mask, [g.mir], like)[:, 0])
    return out


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


def winner_surface(scene, w, o, d, t, zero, checker_tau=0.0):
    """Add to ``w`` (from `winner_geometry`) the winner's surface at ray
    distance ``t``: the normal ``n`` (a sphere's is (p - c) / r), the
    checker pick ``use2``, the ``base`` colour, ``ka``/``kd``/``ksp``/
    ``shin``, and ``pick(sphere_value, rect_value, miss_value)``. At
    ``checker_tau > 0`` the base is the soft checker's blend c1 + u (c2 -
    c1) and ``use2`` is False; ``w.ck`` keeps what its adjoint reads
    (`pipeline.sphere_hit`). A textured group's base is its grid's sample
    (``w.tex_s``, ``w.tex_r``: `pipeline.sample_grid` at `pipeline.sphere_uv` of the
    sphere's normal ``w.s_n``, or at the rect's (a, b)) and its ``use2``
    False."""
    sp, rc = scene.spheres, scene.rects
    if checker_tau > 0.0 and (sp.textured or rc.textured):
        raise NotImplementedError("object textures take the hard checker only")
    p = vm.vadd(o, vm.vscale(d, t))
    s_pl = vm.vsub(p, w.sc)
    s_n = vm.vscale(s_pl, 1.0 / w.sr)
    s_cs = gather_rows(sp.material.checker_scale, w.ks, zero)
    s_chk = gather_rows(sp.material.checker, w.ks, zero)
    s_use2 = s_chk * torch.remainder(sum(torch.floor(c * s_cs) for c in s_pl), 2.0) > 0.5

    nu = vm.vnormalize(vm.vcross(w.eu, w.ev))
    r_n = vm.vscale(nu, torch.where(vm.vdot(nu, d) < 0.0, 1.0, -1.0))
    rel = vm.vsub(p, w.p0)
    ra = vm.vdot(rel, w.eu) * (1.0 / vm.vdot(w.eu, w.eu))
    rb = vm.vdot(rel, w.ev) * (1.0 / vm.vdot(w.ev, w.ev))
    r_cs = gather_rows(rc.material.checker_scale, w.kr, zero)
    r_chk = gather_rows(rc.material.checker, w.kr, zero)
    r_use2 = r_chk * torch.remainder(torch.floor(ra * r_cs) + torch.floor(rb * r_cs), 2.0) > 0.5
    w.s_n, w.tex_s, w.tex_r = s_n, None, None
    if sp.textured:
        w.tex_s = sample_grid(sp.texture, w.ks, *sphere_uv(s_n), wrap_a=True)
        s_use2 = torch.zeros_like(s_use2)
    if rc.textured:
        w.tex_r = sample_grid(rc.texture, w.kr, ra, rb)
        r_use2 = torch.zeros_like(r_use2)

    def pick(sv, rv, miss):
        return torch.where(w.is_sph, sv, torch.where(w.is_rct, rv, miss))

    def mat(name, miss=0.0):
        return pick(gather_rows(getattr(sp.material, name), w.ks, zero),
                    gather_rows(getattr(rc.material, name), w.kr, zero), zero + miss)

    w.pick = pick
    w.n = tuple(pick(a, b, zero) for a, b in zip(s_n, r_n))
    s_c1, s_c2 = (gather_rows(getattr(sp.material, f), w.ks, zero) for f in ("color", "color2"))
    r_c1, r_c2 = (gather_rows(getattr(rc.material, f), w.kr, zero) for f in ("color", "color2"))
    if checker_tau > 0.0:
        s_parts, r_parts = tuple(c * s_cs for c in s_pl), (ra * r_cs, rb * r_cs)
        s_u = s_chk * (0.5 - 0.5 * soft_checker_q(s_parts, checker_tau))
        r_u = r_chk * (0.5 - 0.5 * soft_checker_q(r_parts, checker_tau))
        w.use2 = torch.zeros_like(w.hit)
        w.base = tuple(pick(a1 + s_u * (a2 - a1), b1 + r_u * (b2 - b1), zero)
                       for a1, a2, b1, b2 in zip(s_c1, s_c2, r_c1, r_c2))
        w.ck = SimpleNamespace(s_pl=s_pl, s_cs=s_cs, s_chk=s_chk, s_parts=s_parts, s_u=s_u,
                               s_dc=vm.vsub(s_c2, s_c1), rel=rel, ra=ra, rb=rb, r_cs=r_cs,
                               r_chk=r_chk, r_parts=r_parts, r_u=r_u, r_dc=vm.vsub(r_c2, r_c1))
    else:
        w.use2 = torch.where(w.is_sph, s_use2, r_use2)
        s_base = (w.tex_s.col if sp.textured else
                  tuple(torch.where(s_use2, a2, a1) for a1, a2 in zip(s_c1, s_c2)))
        r_base = (w.tex_r.col if rc.textured else
                  tuple(torch.where(r_use2, b2, b1) for b1, b2 in zip(r_c1, r_c2)))
        w.base = tuple(pick(a, b, zero) for a, b in zip(s_base, r_base))
    w.ka, w.kd, w.ksp, w.shin = mat("ka"), mat("kd"), mat("ks"), mat("shininess", 1.0)
    w.mir = mat("mirror")
    return w


def level_terms(scene, nearest, visibility, o, d, zero, level=0):
    """One level of the hard kernels' forward in eager torch, for the rays
    (``o``, ``d``): the nearest hit (``t``) and the winner's surface
    (``w``), the shadow origins (``so``), per light its terms and
    visibility plane (``per_light``), and the unclipped colour (``col``,
    the background where the ray hit nothing), each a tuple of (H, W)
    channels. ``nearest(scene, o, d) -> (t, k)`` is the trace's nearest
    hit; ``visibility(li, so, f, zero, hit, level)`` gives light li's
    visibility plane at this bounce ``level`` where the rays ``hit``
    (`traced_visibility`, `saved_visibility`). With an environment map a
    miss takes its sample at `pipeline.sphere_uv` of the ray's direction
    (``env``, a `pipeline.sample_grid`)."""
    lt = scene.lights
    t, kbest = nearest(scene, o, d)
    w = winner_surface(scene, winner_geometry(scene, kbest, zero), o, d, t, zero)
    amb = vm.splat(scene.ambient)
    col = vm.vscale(vm.vmul(w.base, amb), w.ka)
    so = vm.vadd(vm.vadd(o, vm.vscale(d, t)), vm.vscale(w.n, SHADOW_EPS))
    per_light = []
    for li in range(lt.count):
        f = light_terms(lt, li, so, w.n, d, w.base, w.kd, w.ksp, w.shin)
        vis = (visibility(li, so, f, zero, w.hit, level=level) if level
               else visibility(li, so, f, zero, w.hit))
        col = vm.vadd(col, tuple(vis * f.q[c] * f.lcol[c] for c in range(3)))
        per_light.append((f, vis))
    env = None
    if scene.env_mapped:
        env = sample_grid(scene.env[None], 0, *sphere_uv(d), wrap_a=True)
        bg = env.col
    else:
        bg = vm.splat(scene.background)
    col = tuple(torch.where(w.hit, c, b) for c, b in zip(col, bg))
    return SimpleNamespace(o=o, d=d, t=t, w=w, so=so, per_light=per_light, col=col, env=env)


def forward_terms(scene, cfg, nearest, visibility, off=(0.0, 0.0), nearest1=None):
    """The forward of the hard kernels in eager torch at the subsample offset
    ``off``, with what their adjoint needs: the primary rays (``ray``), each
    bounce level's `level_terms` (``levels``; level 0's ``t``, ``w``,
    ``so`` and ``per_light`` also as attributes), per level above the
    deepest the mirror weight ``ms[l]`` = where(hit, mirror, 0) and the
    colour of the levels below it, blended (``rcols[l]``), the unclipped
    image (``pre``) and the image (``img``), each a tuple of (H, W)
    channels. With ``cfg.reflections`` = K bounce levels, level l + 1 traces
    the reflected rays from level l's shadow origins along `reflect_dir` (by
    ``nearest1``, ``nearest`` if None: the object-chunked kernels walk every
    sphere there), and the levels compose deepest first, col_l + m_l
    (rcol_l - col_l), one clip at the top (`pipeline.shade_levels`). ``m``
    is level 0's weight (None without a bounce)."""
    zero = torch.zeros((cfg.height, cfg.width), device=scene.device, dtype=scene.ambient.dtype)
    ray = primary_ray_terms(scene, cfg, off)
    lv = level_terms(scene, nearest, visibility, ray.o, ray.d, zero)
    levels, ms = [lv], []
    for depth in range(1, cfg.reflections + 1):
        up = levels[-1]
        levels.append(level_terms(scene, nearest1 or nearest, visibility, up.so,
                                  reflect_dir(up.d, up.w.n), zero, level=depth))
        ms.append(torch.where(up.w.hit, up.w.mir, 0.0))
    pre, rcols = levels[-1].col, [None] * len(ms)
    for l in reversed(range(len(ms))):
        rcols[l] = pre
        pre = tuple(c + ms[l] * (rc - c) for c, rc in zip(levels[l].col, pre))
    img = tuple(vm.clip01(c) for c in pre) if cfg.clip else pre
    return SimpleNamespace(ray=ray, t=lv.t, w=lv.w, so=lv.so, per_light=lv.per_light,
                           levels=levels, ms=ms, rcols=rcols, m=ms[0] if ms else None, pre=pre,
                           img=img)


def subsample_average(imgs):
    """The image of spp subsamples: ((c0 + c1) + c2) + c3 times 0.25 at spp
    4, summed in `pipeline.SPP_OFFSETS` order as `render_tile` sums them;
    the one image at spp 1. Each image is a tensor or a tuple of channels."""
    if len(imgs) == 1:
        return imgs[0]
    tup = isinstance(imgs[0], tuple)
    acc = imgs[0]
    for img in imgs[1:]:
        acc = vm.vadd(acc, img) if tup else acc + img
    return vm.vscale(acc, 1.0 / len(imgs)) if tup else acc * (1.0 / len(imgs))


def subsample_adjoint(scene, cfg, nearest, cotangent, visibility_at, nearest1=None):
    """The adjoint of every subsample of the pixels, as the kernels' spp
    loop runs it (csrc/render_common.cuh `pixel_grads`): ``(sum of squared
    residuals, grads as a Scene)``. At spp 1 `_adjoint`. At spp 4 the four
    forwards, the cotangent of their average (`subsample_average`), and
    each subsample's adjoint with a quarter of it (the average's 0.25,
    before each subsample's own clip gradient), summed. ``visibility_at(q)``
    is subsample q's visibility, and ``nearest1`` the bounce level's trace,
    as `forward_terms` takes them."""
    offsets = SPP_OFFSETS[cfg.spp]
    if len(offsets) == 1:
        return _adjoint(scene, cfg, nearest, cotangent, visibility_at(0), nearest1=nearest1)
    imgs = [forward_terms(scene, cfg, nearest, visibility_at(q), off, nearest1).img
            for q, off in enumerate(offsets)]
    g, sq = cotangent(subsample_average(imgs))
    g = vm.vscale(g, 1.0 / len(offsets))
    grads = None
    for q, off in enumerate(offsets):
        _, gq = _adjoint(scene, cfg, nearest, lambda img: (g, 0.0), visibility_at(q), off,
                         nearest1)
        grads = gq if grads is None else tree_map(torch.add, grads, gq)
    return sq, grads


def _adjoint(scene, cfg, nearest, cotangent, visibility, off=(0.0, 0.0), nearest1=None):
    """The per-pixel adjoint of the step and of the render backward at one
    subsample offset ``off``: ``(sum
    of squared residuals, grads as a Scene)``. ``nearest``, ``visibility``
    and ``nearest1`` as `forward_terms` takes them; ``cotangent(img)`` gives
    the cotangent of the clipped image per channel and the squared error
    (`residual_cotangent`, `image_cotangent`). With K bounce levels the
    adjoint runs deepest level first: the blend c_l = col_l + m_l (c_{l+1} -
    col_l) gives level l's colour the cotangent (1 - m_l) g_l (the deepest's
    g_K) and the blend below it g_{l+1} = m_l g_l, g_0 the clipped image's;
    each level's shading and winner under its cotangent, its ray's cotangents
    carried back into the level above's shadow origin (the reflected ray's
    origin), normal and direction, and that level's mirror coefficient's
    (c_{l+1} - col_l) . g_l; level 0 last."""
    zero = torch.zeros((cfg.height, cfg.width), device=scene.device, dtype=scene.ambient.dtype)
    fw = forward_terms(scene, cfg, nearest, visibility, off, nearest1)
    lv = fw.levels[0]
    hit = lv.w.hit

    # ---- the image's cotangent, through the clip
    g_img, sq = cotangent(fw.img)
    gc = tuple(g * (vm.clip01_grad(p_) if cfg.clip else 1.0) for g, p_ in zip(g_img, fw.pre))

    # ---- the bounces, c_l = col_l + m_l (c_{l+1} - col_l) with c_K = col_K:
    # each blend's cotangents top down, then the levels deepest first, each
    # handing the level above what its ray's cotangents give (`level_adjoint`)
    g_blend = [gc]
    for m in fw.ms:
        g_blend.append(tuple(g * m for g in g_blend[-1]))
    bounce, grads = None, None
    for l in reversed(range(1, len(fw.levels))):
        lvl, up = fw.levels[l], fw.levels[l - 1]
        g_col = g_blend[l] if l == len(fw.ms) else tuple(g * (1.0 - fw.ms[l]) for g in g_blend[l])
        g_o1, g_d1, gl = level_adjoint(scene, lvl, g_col, zero, bounce)
        grads = gl if grads is None else tree_map(torch.add, grads, gl)
        n, d = up.w.n, up.d  # d1 = d - 2 (d . n) n
        gdn, dn = vm.vdot(n, g_d1), vm.vdot(d, n)
        bounce = dict(so=g_o1, d=vm.vsub(g_d1, vm.vscale(n, 2.0 * gdn)),
                      n=vm.vscale(vm.vadd(vm.vscale(d, gdn), vm.vscale(g_d1, dn)), -2.0),
                      mir=sum(g * (rc - c) for g, c, rc in zip(g_blend[l - 1], up.col,
                                                              fw.rcols[l - 1])))
    if fw.ms:
        gc = tuple(g * (1.0 - fw.ms[0]) for g in gc)
    g_o, g_d, grads0 = level_adjoint(scene, lv, gc, zero, bounce)
    grads = grads0 if grads is None else tree_map(torch.add, grads0, grads)

    # ---- camera (a missed ray's direction has the environment's cotangent)
    live = hit | scene.env_mapped
    g_eye, g_look, g_uph, g_fov = camera_grads(
        scene.camera, fw.ray, tuple(torch.where(hit, x, 0.0) for x in g_o),
        tuple(torch.where(live, x, 0.0) for x in g_d))
    camera = dc.replace(grads.camera, eye=g_eye, look_at=g_look, up=g_uph, fov_deg=g_fov)
    return sq, dc.replace(grads, camera=camera)


def level_adjoint(scene, lv, g_col, zero, bounce=None):
    """The adjoint of one level (`level_terms`) for the cotangent ``g_col``
    of its unclipped colour: the shade adjoint (the background's where the
    ray hit nothing), the shadow origin's, and the winning object's only.
    ``bounce``, from the level it reflects: the cotangents of this level's
    shadow origin ``so``, ray direction ``d`` and normal ``n``, and of its
    winner's mirror coefficient ``mir`` (each used where the ray hit).
    Returns the per-pixel cotangents of the level's ray origin and direction
    (not masked) and the gradient of every leaf but the camera's (a Scene).
    A textured winner's base cotangent goes to its texels and, through the
    sample's weights, to its coordinates (the sphere's normal, the rect's a
    and b); with an environment map a miss's goes to the environment's texels
    and the ray's direction, and the background gets none."""
    like = dict(device=zero.device, dtype=zero.dtype)
    sp, rc, lt = scene.spheres, scene.rects, scene.lights
    N, M, L = sp.count, rc.count, lt.count
    w, o, d, t = lv.w, lv.o, lv.d, lv.t
    hit, n, base = w.hit, w.n, w.base
    amb = vm.splat(scene.ambient)

    # ---- shade adjoint (hit pixels; everything below is masked by hit)
    gh = tuple(torch.where(hit, g, 0.0) for g in g_col)
    g_bg = tuple(torch.sum(torch.where(hit | scene.env_mapped, 0.0, g)) for g in g_col)
    g = SimpleNamespace(base=tuple(gh[c] * amb[c] * w.ka for c in range(3)),
                        ka=sum(gh[c] * base[c] * amb[c] for c in range(3)),
                        kd=zero, ks=zero, shin=zero)
    g_amb = tuple(torch.sum(gh[c] * base[c] * w.ka) for c in range(3))
    g_n, g_d, g_so = (zero,) * 3, (zero,) * 3, (zero,) * 3
    g_lpos, g_lcol = [], []
    for f, vis in lv.per_light:
        gl = light_adjoint(f, gh, vis, n, d, base, w.kd, w.ksp, w.shin)
        g_lcol.append(tuple(torch.sum(x) for x in gl.lcol))
        g.kd, g.ks, g.shin = g.kd + gl.kd, g.ks + gl.ks, g.shin + gl.shin
        g.base = vm.vadd(g.base, gl.base)
        g_d = vm.vadd(g_d, gl.d)
        g_n = vm.vadd(g_n, gl.n)
        g_lvec = light_geometry_adjoint(f, gl.ldir)
        g_lpos.append(tuple(torch.sum(x) for x in g_lvec))
        g_so = vm.vsub(g_so, g_lvec)
    if bounce is not None:
        g_so, g_d, g_n = (vm.vadd(mine, tuple(torch.where(hit, x, 0.0) for x in bounce[key]))
                          for mine, key in ((g_so, "so"), (g_d, "d"), (g_n, "n")))
    # so = (o + d t) + n * SHADOW_EPS
    g_o = g_so
    g_d = vm.vadd(g_d, vm.vscale(g_so, t))
    g_t = vm.vdot(g_so, d)
    g_n = vm.vadd(g_n, vm.vscale(g_so, SHADOW_EPS))
    g_env = None
    if scene.env_mapped:  # a miss: the environment's sample at sphere_uv(d)
        miss = ~hit
        g_env, g_u, g_v = grid_adjoint(lv.env, g_col, miss, scene.env.shape[0] ** 2)
        g_d = vm.vadd(g_d, uv_adjoint(d, torch.where(miss, g_u, 0.0), torch.where(miss, g_v, 0.0)))

    # ---- the winning object (a textured one's texels and coordinates)
    g_n_s, g_ab, g_tex = g_n, None, {}
    if sp.textured:
        g_tex["s"], g_u, g_v = grid_adjoint(w.tex_s, g.base, hit & w.is_sph,
                                            sp.texture[..., 0].numel())
        g_n_s = vm.vadd(g_n, uv_adjoint(w.s_n, torch.where(w.is_sph, g_u, 0.0),
                                        torch.where(w.is_sph, g_v, 0.0)))
    if rc.textured:
        g_tex["r"], g_a, g_b = grid_adjoint(w.tex_r, g.base, hit & w.is_rct,
                                            rc.texture[..., 0].numel())
        g_ab = (torch.where(w.is_rct, g_a, 0.0), torch.where(w.is_rct, g_b, 0.0))
    s_go, s_gd, g_c, g_r = sphere_winner_adjoint(o, d, t, w.sc, w.sr, g_t, g_n_s)
    r_go, r_gd, g_p0, g_eu, g_ev = rect_winner_adjoint(o, d, w.p0, w.eu, w.ev, w.is_rct, g_t, g_n,
                                                       g_ab)
    g_o = tuple(g_o[c] + w.pick(s_go[c], r_go[c], zero) for c in range(3))
    g_d = tuple(g_d[c] + w.pick(s_gd[c], r_gd[c], zero) for c in range(3))

    # ---- the reduction into the scene's leaves
    grads = tree_unflatten(scene, [torch.zeros_like(l) for l in tree_leaves(scene)])
    spheres, rects = grads.spheres, grads.rects
    g.mir = None if bounce is None else bounce["mir"]
    if N:
        spheres = dc.replace(spheres, center=winner_rows(N, w.ks, w.is_sph, g_c, like),
                             radius=winner_rows(N, w.ks, w.is_sph, [g_r], like)[:, 0],
                             material=material_grads(spheres.material, N, w.ks, w.is_sph,
                                                     w.use2, g, like, sp.textured))
        if sp.textured:
            spheres = dc.replace(spheres, texture=g_tex["s"].reshape(sp.texture.shape))
    if M:
        rects = dc.replace(rects, origin=winner_rows(M, w.kr, w.is_rct, g_p0, like),
                           edge_u=winner_rows(M, w.kr, w.is_rct, g_eu, like),
                           edge_v=winner_rows(M, w.kr, w.is_rct, g_ev, like),
                           material=material_grads(rects.material, M, w.kr, w.is_rct, w.use2, g,
                                                   like, rc.textured))
        if rc.textured:
            rects = dc.replace(rects, texture=g_tex["r"].reshape(rc.texture.shape))
    lights = grads.lights
    if L:
        lights = dc.replace(lights, position=torch.stack([torch.stack(x) for x in g_lpos]),
                            color=torch.stack([torch.stack(x) for x in g_lcol]))
    grads = dc.replace(grads, spheres=spheres, rects=rects, lights=lights,
                       ambient=torch.stack(g_amb), background=torch.stack(g_bg))
    if g_env is not None:
        grads = dc.replace(grads, env=g_env.reshape(scene.env.shape))
    return g_o, g_d, grads
