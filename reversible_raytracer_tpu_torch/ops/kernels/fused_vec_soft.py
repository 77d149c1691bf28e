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

The soft checker (``checker_tau > 0``, the anneal's ``checker_ratio``): a
layer's base colour is c1 + u (c2 - c1), u = checker (0.5 - 0.5 q), q the
smooth parity `pipeline.soft_checker_q` of its hit position (a sphere's p
- c at its rank t, a rect's (a, b)) times the checker scale, so the hit
positions, the camera and the checker columns get gradients. checker_tau
is a runtime argument too, as the TPU kernels' second SMEM scalar; each
kernel is built twice from one body (a ``SOFT_CHECKER`` template flag), and
the wrapper launches the checker instance where ``checker_tau > 0`` and the
other where it is 0, which keeps the hard select's code, bits and time (the
TPU kernels' runtime select, fused_vec.py:523-538).

Object texel grids and the environment map (the hard checker; the TPU
kernels' texel tails and env global, fused_vec_soft.py:382-443 and
:458-492): each kernel has a texel instance (the ``_tex`` entries) beside
the other two. Each layer's textured winner's base colour is its own grid's
bilinear sample at `pipeline.sphere_uv` of its normal (p - c) / r at the
layer's rank t, not renormalised at a near miss, or at a rect's (a, b),
gathered from global memory (`fused_vec.pack_texels`); the composite's
blend target is the environment's sample at the primary ray's direction
(`pipeline.miss_color`), so the backward scatters an environment texel
record at every pixel, and each layer's textured winner its own record,
into a block texel row in shared memory that ends each block's partial row
(`soft_step_plan`: with the 64 globes' grids it leaves 10 prefix slots a
lane of the 32 the untextured step has). The step then walks the image's
tiles from a grid of one block an SM, as rows 5-6's textured instances do.
The render takes them at spp 1 and 4 (four launches at the offsets, as
without a grid), the step at spp 1. A grid whose gradient does not fit a
block and the soft checker with a grid are refused by name
(`soft_uncovered`).

The scene enters as `fused_vec`'s packed rows (globals, sphere and rect
rows padded to 16, rects numbered from the padded sphere count). Covered:
perspective, Phong, no mirror levels; spp 1 and 4 in the render, spp 1 in
the step, as in the JAX package (fused_vec_soft.py:365-380): at spp 4 the forward and the render
backward are launched once per subsample at its offsets and the image is
their average in torch (fused_vec_soft.py:1059-1092), so a spp-4 soft step
is autograd of that render (`ops.render.loss_and_grad_fn`,
`optim.anneal_stage_uses_step`). Anything else raises on CUDA. On a CPU
tensor each wrapper runs its plain version; on a CUDA tensor it launches
its kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses as dc
from types import SimpleNamespace

import torch
from torch.autograd.function import once_differentiable

from ...models.scene import scene_textured, tree_leaves, tree_map, tree_unflatten
from .. import vecmath as vm
from ..pipeline import (
    BIG,
    SHADOW_EPS,
    SPP_OFFSETS,
    RenderConfig,
    band_config,
    sample_grid,
    soft_checker_q,
    sphere_uv,
)
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

# Entries with a subsample's (row, column) offset (``_at``, rows 7-8) after
# the geometry; those without are at the pixel centre, for tools/ and for
# checkouts from before spp 4.
# The texel instances' ``_tex`` entries take the object grids' pointers after
# the rows, and after tau the environment map's and the grids' sides (ke, ks,
# kr; 0 for none); the step's and backward's output ends with the grids'
# gradient.
_TX = [_P, _P]  # stex, rtex
_KS = [_I, _I, _I]  # ke, ks, kr
# The wrappers call the ``_band`` entries: the band's first image row and the
# image's height after the geometry, whose H is the band's rows
# (`fused.band_args`); the others are the whole image.
_BAND = fused._BAND
SOFT_RENDER = Kernel("fused_vec_soft_render", {
    "rrt_soft_render_tex_band": ([_P, _P, _P, *_TX, *_GEOM, *_BAND, _F, _F, _F, *_KS, _P, _P],
                                 _I),
    "rrt_soft_render_at_band": ([_P, _P, _P, *_GEOM, *_BAND, _F, _F, _F, _F, _P, _P], _I),
    "rrt_soft_render_tex": ([_P, _P, _P, *_TX, *_GEOM, _F, _F, _F, *_KS, _P, _P], _I),
    "rrt_soft_render_tex_smem": ([_I, _I, _I, _I], ctypes.c_longlong),
    "rrt_soft_render_at": ([_P, _P, _P, *_GEOM, _F, _F, _F, _F, _P, _P], _I),
    "rrt_soft_render": ([_P, _P, _P, *_GEOM, _F, _F, _P, _P], _I),
    "rrt_soft_render_smem": ([_I, _I, _I], ctypes.c_longlong),
})
SOFT_STEP = Kernel("fused_vec_soft_step", {
    "rrt_soft_step_tex_band": ([_P, _P, _P, *_TX, *_GEOM, *_BAND, _F, *_KS, _P, _F, _P, _P, _P],
                               _I),
    "rrt_soft_step_band": ([_P, _P, _P, *_GEOM, *_BAND, _F, _F, _P, _F, _P, _P, _P], _I),
    "rrt_soft_step_tex": ([_P, _P, _P, *_TX, *_GEOM, _F, *_KS, _P, _F, _P, _P, _P], _I),
    "rrt_soft_step_tex_smem": ([_I] * 6, ctypes.c_longlong),
    "rrt_soft_step_tex_scratch_floats": ([_I] * 8, ctypes.c_longlong),
    "rrt_soft_step_pcap": ([_I] * 6, _I),
    "rrt_soft_step": ([_P, _P, _P, *_GEOM, _F, _F, _P, _F, _P, _P, _P], _I),
    "rrt_soft_step_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
    "rrt_soft_step_smem": ([_I, _I, _I], ctypes.c_longlong),
})
SOFT_RENDER_BWD = Kernel("fused_vec_soft_render_bwd", {
    "rrt_soft_render_bwd_tex_band": ([_P, _P, _P, *_TX, *_GEOM, *_BAND, _F, _F, _F, *_KS, _P, _P,
                                      _P, _P], _I),
    "rrt_soft_render_bwd_at_band": ([_P, _P, _P, *_GEOM, *_BAND, _F, _F, _F, _F, _P, _P, _P, _P],
                                    _I),
    "rrt_soft_render_bwd_tex": ([_P, _P, _P, *_TX, *_GEOM, _F, _F, _F, *_KS, _P, _P, _P, _P],
                                _I),
    "rrt_soft_render_bwd_tex_smem": ([_I] * 6, ctypes.c_longlong),
    "rrt_soft_render_bwd_tex_scratch_floats": ([_I] * 8, ctypes.c_longlong),
    "rrt_soft_render_bwd_at": ([_P, _P, _P, *_GEOM, _F, _F, _F, _F, _P, _P, _P, _P], _I),
    "rrt_soft_render_bwd": ([_P, _P, _P, *_GEOM, _F, _F, _P, _P, _P, _P], _I),
    "rrt_soft_render_bwd_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
    "rrt_soft_render_bwd_smem": ([_I, _I, _I], ctypes.c_longlong),
})
KERNELS = (SOFT_RENDER, SOFT_STEP, SOFT_RENDER_BWD)


# The soft step's prefix slots per lane at most, and its per-sphere shadow
# gradient (csrc/soft_step.cuh PCAP, GEO).
PCAP, GEO = 32, 4


def soft_step_plan(scene_like, optin: int = fused.MAX_BLOCK_SMEM) -> dict:
    """The shared memory of a block of the soft step and render backward
    (csrc/soft_step.cuh `soft_plan`, and with a texel grid `soft_tex_plan`)
    on a card whose blocks may have ``optin`` bytes: the globals (with the
    environment map's texels), the rows, 8 warp rows of 1 + Sg + 10 slots,
    the block's object row, 8 warp rows of the spheres' shadow gradient, per
    warp and layer-and-light 32 visibilities, the candidate mask words and
    3 words of bookkeeping; with a texel grid one staging of 32 texel records
    of 16 words and the block's texel row (``trow``, 3 (N ks^2 + M kr^2)
    floats); then as many prefix slots a lane (``pcap``, 1 to 32) as the
    rest holds, 8 x 32 floats each. ``smem`` above ``optin`` (at one slot)
    does not fit."""
    ns_pad, nr_pad = fused_vec.row_plan(scene_like)
    L = scene_like.lights.count
    ks, kr, ke = fused.texel_sizes(scene_like)
    tex = scene_textured(scene_like)
    sg = fused_vec.globals_offsets(L, ke)["Sg"]
    grow = 1 + sg + 10
    orow = ns_pad * fused_vec.P_SPH + nr_pad * fused_vec.P_RCT
    nc, nwp = 2 * L, (ns_pad + 31) // 32
    trow = fused_vec.texel_row(scene_like) if tex else 0
    words = (sg + orow + 8 * grow + orow + 8 * ns_pad * GEO + 8 * nc * 32
             + (32 * 16 + trow if tex else 0))
    base = 4 * words + 4 * 8 * nc * (nwp + 3)
    per_slot = 4 * 8 * 32
    pcap = min(max((optin - base) // per_slot, 1), PCAP)
    return dict(smem=base + pcap * per_slot, pcap=pcap, texels=trow, Sg=sg)


def soft_kernel_ok(scene_like) -> bool:
    """Can the soft kernels take this scene (the JAX package's
    `soft_kernel_ok`)? Object texel grids and the environment map too,
    where the textured soft step's block (`soft_step_plan`, its texel row in
    shared memory) fits the shared memory a block has: the port's budget in
    place of the JAX package's `vec_smem_ok` and its K <= 32 cap."""
    return (not scene_textured(scene_like)
            or soft_step_plan(scene_like)["smem"] <= fused.MAX_BLOCK_SMEM)


def soft_uncovered(scene, cfg: RenderConfig, step: bool = False):
    """What the soft kernels do not cover (a reason), or None: the render
    (rows 7-8) or, with ``step``, the soft step (row 9)."""
    if cfg.spp not in SPP_OFFSETS:
        return f"spp={cfg.spp} (spp is 1 or 4)"
    if step and cfg.spp != 1:
        return (f"spp={cfg.spp} in the soft step, which is spp 1 as in the JAX package "
                "(fused_vec_soft.py:365-380) and takes no subsample offsets: a spp-4 soft step "
                "is autograd of the four-launch soft render (ops.render.loss_and_grad_fn)")
    if cfg.reflections:
        return "mirror reflections"
    if cfg.shader != "phong":
        return f"the {cfg.shader} shader"
    if cfg.projection != "perspective":
        return f"the {cfg.projection} projection"
    if scene.lights.count > fused.MAX_LIGHTS:
        return f"more than {fused.MAX_LIGHTS} lights"
    if not scene_textured(scene):
        return None
    if cfg.checker_tau > 0.0:
        return ("the soft checker (checker_tau > 0) with a texel grid (object textures or an "
                "environment map): the soft kernels' texel instances take the hard checker")
    if not soft_kernel_ok(scene):
        need = soft_step_plan(scene)["smem"]
        return (f"a texel grid this large: {fused_vec.texel_row(scene)} object texels and an "
                f"environment map of side {fused.texel_sizes(scene)[2]} need {need} bytes of "
                f"shared memory a block in the textured soft step, above the "
                f"{fused.MAX_BLOCK_SMEM} a block has")
    return None


def check_soft_kernel_config(scene, cfg: RenderConfig, step: bool = False) -> None:
    """Raise for a configuration the soft render kernels (or, with
    ``step``, the soft step) do not take."""
    if not cfg.soft_tau > 0.0:
        if cfg.checker_tau > 0.0:
            raise NotImplementedError(
                "the checker-only relaxation (soft_tau = 0, checker_tau > 0) has no soft kernel: "
                "it renders through pipeline_vec.render_eager_vec, as in the JAX package")
        raise ValueError("the soft kernels need soft_tau > 0 (the hard path is fused_vec)")
    why = soft_uncovered(scene, cfg, step)
    if why is not None:
        raise NotImplementedError(f"the soft CUDA kernels do not cover {why}")


def _cuda_inputs(scene, cfg: RenderConfig, step: bool = False):
    """The packed rows, and for a scene with a texel grid the object grids
    after them (`fused_vec.texel_inputs`: the texel instances' inputs)."""
    check_soft_kernel_config(scene, cfg, step)
    rows = fused_vec.packed_inputs(scene)
    return (*rows, *fused_vec.texel_inputs(scene)) if scene_textured(scene) else rows


# ---------------------------------------------------------------------------
# Forward render kernel (row 7)
# ---------------------------------------------------------------------------


def render_vec_soft_plain(scene, cfg: RenderConfig, row0=0, out_height: int | None = None):
    """The soft (H, W, 3) image in eager torch, of the band of
    ``out_height`` rows from ``row0`` if given (`band_config`)."""
    return render_eager_vec(scene, cfg, row0, out_height)


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


def render_vec_soft(scene, cfg: RenderConfig, row0=0, out_height: int | None = None):
    """The soft (H, W, 3) image, of the band of ``out_height`` rows from
    ``row0`` if given (H its rows): the forward kernel on CUDA, once per
    subsample (the image their average), `render_vec_soft_plain` on the
    CPU. Differentiable on both: on CUDA through the soft render backward
    kernel, once per subsample."""
    dev = scene.device
    cfg = band_config(cfg, row0, out_height)
    if dev.type == "cpu":
        return render_vec_soft_plain(scene, cfg)
    if dev.type != "cuda":
        raise NotImplementedError(f"no soft render kernel for device {dev}")
    rows = _cuda_inputs(scene, cfg)
    cfg1 = dc.replace(cfg, spp=1)
    leaves = tree_leaves(scene)
    return fused.subsample_average([_SoftRender.apply(scene, cfg1, off, rows, *leaves)
                                    for off in SPP_OFFSETS[cfg.spp]])


class _SoftRender(torch.autograd.Function):
    """The soft forward and soft render backward kernels at one subsample
    offset ``off`` as one differentiable function of the scene's leaves (the
    ``custom_vjp`` of fused_vec_soft.py:1008-1040), given the scene's packed
    ``rows`` (`fused_vec.packed_inputs`): the forward saves them (tau is in
    the saved configuration), the backward launches the backward kernel
    once."""

    @staticmethod
    def forward(ctx, scene, cfg, off, rows, *leaves):
        glob, sph, rct, *tex = rows
        img = torch.empty((cfg.height, cfg.width, 3), device=glob.device)
        geom, stream = fused_vec._geometry(scene, cfg), fused._stream(glob.device)
        if tex:
            sides = fused_vec.tex_levels(scene, cfg)[1:]  # ke, ks, kr
            fused_vec.check_smem(SOFT_RENDER, "rrt_soft_render_tex_smem", scene, sides[0])
            if any(ctx.needs_input_grad):
                fused_vec.check_smem(SOFT_RENDER_BWD, "rrt_soft_render_bwd_tex_smem", scene,
                                     *sides)
            SOFT_RENDER.call("rrt_soft_render_tex_band", glob.data_ptr(), sph.data_ptr(),
                             rct.data_ptr(), *(t.data_ptr() for t in tex), *geom,
                             *fused.band_args(cfg), *off, float(cfg.soft_tau), *sides,
                             img.data_ptr(), stream)
        else:
            fused_vec.check_smem(SOFT_RENDER, "rrt_soft_render_smem", scene)
            if any(ctx.needs_input_grad):
                fused_vec.check_smem(SOFT_RENDER_BWD, "rrt_soft_render_bwd_smem", scene)
            SOFT_RENDER.call("rrt_soft_render_at_band", glob.data_ptr(), sph.data_ptr(),
                             rct.data_ptr(), *geom, *fused.band_args(cfg), *off,
                             float(cfg.soft_tau), float(cfg.checker_tau), img.data_ptr(), stream)
        SOFT_RENDER.launches += 1
        ctx.scene, ctx.cfg, ctx.off = scene, cfg, off
        ctx.save_for_backward(glob, sph, rct, *tex)
        ctx.set_materialize_grads(False)
        return img

    @staticmethod
    @once_differentiable
    def backward(ctx, g_img):
        if g_img is None:
            return (None, None, None, None, *(None for _ in tree_leaves(ctx.scene)))
        glob, sph, rct, *tex = ctx.saved_tensors
        grads = _render_bwd_launch(ctx.scene, ctx.cfg, ctx.off, glob, sph, rct, g_img, tex)
        return (None, None, None, None, *tree_leaves(grads))


# ---------------------------------------------------------------------------
# Render backward kernel (row 8)
# ---------------------------------------------------------------------------


def _render_bwd_launch(scene_like, cfg, off, glob, sph, rct, g_img, tex=()):
    """The scene's gradient (a Scene) from one soft backward-kernel call at
    the subsample offset ``off`` (``tex``: the object grids of a scene with a
    texel grid, the ``_tex`` entry)."""
    dev = glob.device
    g_img = fused.cotangent_f32(g_img, cfg)
    geom = fused_vec._geometry(scene_like, cfg)
    out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel()
                       + fused_vec.texel_row(scene_like),), device=dev)
    ptrs = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr())
    if tex:
        sides = fused_vec.tex_levels(scene_like, cfg)[1:]  # ke, ks, kr
        scratch = fused._scratch(SOFT_RENDER_BWD, "rrt_soft_render_bwd_tex_scratch_floats",
                                 (geom[0], geom[1], *geom[4:7], *sides), dev)
        SOFT_RENDER_BWD.call("rrt_soft_render_bwd_tex_band", *ptrs,
                             *(t.data_ptr() for t in tex), *geom, *fused.band_args(cfg), *off,
                             float(cfg.soft_tau), *sides, g_img.data_ptr(), scratch.data_ptr(),
                             out.data_ptr(), fused._stream(dev))
    else:
        scratch = fused._scratch(SOFT_RENDER_BWD, "rrt_soft_render_bwd_scratch_floats",
                                 geom[2:7], dev)
        SOFT_RENDER_BWD.call("rrt_soft_render_bwd_at_band", *ptrs, *geom, *fused.band_args(cfg),
                             *off, float(cfg.soft_tau), float(cfg.checker_tau), g_img.data_ptr(),
                             scratch.data_ptr(), out.data_ptr(), fused._stream(dev))
    SOFT_RENDER_BWD.launches += 1
    return fused_vec._unpack_out(scene_like, out, glob, sph, rct)


def render_vec_soft_bwd_plain(scene, cfg: RenderConfig, g_img):
    """torch.autograd of the soft render for the image cotangent."""
    return fused.autograd_vjp(render_eager_vec, scene, cfg, g_img)


# ---------------------------------------------------------------------------
# Training-step kernel (row 9)
# ---------------------------------------------------------------------------


def loss_grad_vec_soft(scene, cfg: RenderConfig, target, loss: str = "mse", row0=0,
                       out_height: int | None = None, norm: float | None = None):
    """``(norm * sq_sum, grads as a Scene)`` of the squared error between
    the soft render of ``scene`` and ``target``, of the band of
    ``out_height`` rows from ``row0`` if given (``target`` the band's;
    `fused.loss_grad_fused`). One step-kernel call on CUDA; autograd over
    the soft render on the CPU."""
    dev = scene.device
    cfg = band_config(cfg, row0, out_height)
    w = fused._loss_norm(cfg, loss, norm)
    fused._check_target(target, cfg, scene)
    if dev.type == "cpu":  # the plain version takes the mean where no band or norm is given
        return loss_grad_vec_soft_plain(scene, cfg, target, loss, norm=norm)
    if dev.type != "cuda":
        raise NotImplementedError(f"no soft step kernel for device {dev}")
    glob, sph, rct, *tex = _cuda_inputs(scene, cfg, step=True)
    target = target.contiguous()
    geom = fused_vec._geometry(scene, cfg)
    out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel()
                       + fused_vec.texel_row(scene),), device=dev)
    ptrs = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr())
    if tex:
        sides = fused_vec.tex_levels(scene, cfg)[1:]  # ke, ks, kr
        fused_vec.check_smem(SOFT_STEP, "rrt_soft_step_tex_smem", scene, *sides)
        scratch = fused._scratch(SOFT_STEP, "rrt_soft_step_tex_scratch_floats",
                                 (geom[0], geom[1], *geom[4:7], *sides), dev)
        SOFT_STEP.call("rrt_soft_step_tex_band", *ptrs, *(t.data_ptr() for t in tex), *geom,
                       *fused.band_args(cfg), float(cfg.soft_tau), *sides, target.data_ptr(),
                       w, scratch.data_ptr(), out.data_ptr(), fused._stream(dev))
    else:
        fused_vec.check_smem(SOFT_STEP, "rrt_soft_step_smem", scene)
        scratch = fused._scratch(SOFT_STEP, "rrt_soft_step_scratch_floats", geom[2:7], dev)
        SOFT_STEP.call("rrt_soft_step_band", *ptrs, *geom, *fused.band_args(cfg),
                       float(cfg.soft_tau), float(cfg.checker_tau), target.data_ptr(), w,
                       scratch.data_ptr(), out.data_ptr(), fused._stream(dev))
    SOFT_STEP.launches += 1
    return w * out[0], fused_vec._unpack_out(scene, out, glob, sph, rct)


def loss_grad_vec_soft_plain(scene, cfg: RenderConfig, target, loss: str = "mse", row0=0,
                             out_height: int | None = None, norm: float | None = None):
    """torch.autograd of ``loss(soft render(scene), target)`` (of a band's,
    `fused.autograd_loss_grad`)."""
    return fused.autograd_loss_grad(render_eager_vec, scene, band_config(cfg, row0, out_height),
                                    target, loss, norm)


def loss_grad_vec_soft_adjoint_eager(scene, cfg: RenderConfig, target, loss: str = "mse"):
    """The soft step kernel's algorithm in eager torch, vectorized over
    pixels: the two-layer ranking, each layer's winner, coverage and soft
    shadow products, the residual, then the adjoint of the composite, of
    each layer's shading, of its shadow products (each kept occluder's
    factor is the exclusive product of the others, from prefix and suffix
    products, never a division), of the light geometry and of the layer's
    winner, and the camera chain once. Same contract as
    `loss_grad_vec_soft`, and spp 1 as the kernel."""
    check_soft_kernel_config(scene, cfg, step=True)
    norm = fused._loss_norm(cfg, loss)
    fused._check_target(target, cfg, scene)
    with torch.no_grad():
        sq, grads = _soft_adjoint(scene, cfg, fused.residual_cotangent(target, norm))
    return norm * sq, grads


def render_vec_soft_bwd_adjoint_eager(scene, cfg: RenderConfig, g_img):
    """The soft render backward kernel's algorithm in eager torch: the soft
    step's adjoint (`_soft_adjoint`) with the image cotangent ``g_img`` in
    place of the residual: the scene's gradient (a Scene). At spp 4 the sum
    of the four subsamples' adjoints, each with a quarter of ``g_img``, as
    the four backward launches take it through the average."""
    check_soft_kernel_config(scene, cfg)
    fused._check_target(g_img, cfg, scene, "cotangent")
    offsets = SPP_OFFSETS[cfg.spp]
    g = g_img if len(offsets) == 1 else g_img * (1.0 / len(offsets))
    grads = None
    with torch.no_grad():
        for off in offsets:
            gq = _soft_adjoint(scene, cfg, fused.image_cotangent(g), off)[1]
            grads = gq if grads is None else tree_map(torch.add, grads, gq)
    return grads


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
    the winner's geometry and coverage, its surface (a textured winner's
    base colour its grid's sample, `fused.winner_surface`), and per light the
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
    fused.winner_surface(scene, y, o, d, y.t, zero, cfg.checker_tau)

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


def _soft_forward(scene, cfg, cull=False, off=(0.0, 0.0)):
    """The soft kernels' forward in eager torch at the subsample offset
    ``off``, with what the adjoint needs: the primary rays, the two layers
    (`_layer`), the blend target (the background, or the environment map's
    sample at the primary ray's direction, ``env``, a `pipeline.sample_grid`),
    the composite behind layer 1 and in front, and the image. With ``cull``,
    as the soft forward kernel walks: the ranking over each warp's primary
    candidates of the widened cone (`cull.primary_candidates` at tau), and
    each shadow product over the warp's candidates as well."""
    tau = cfg.soft_tau
    zero = torch.zeros((cfg.height, cfg.width), device=scene.device, dtype=scene.ambient.dtype)
    ray = fused.primary_ray_terms(scene, cfg, off)
    keep = None
    if cull and scene.spheres.count:
        keep = per_pixel(primary_candidates(scene.spheres, scene.camera.eye, ray.d, tau),
                         cfg.width)
    y1, y2 = (_layer(scene, cfg, ray, k, tau, zero, warp_cull=cull)
              for _, k in two_layers(scene, ray.o, ray.d, tau, keep))
    env = None
    if scene.env_mapped:  # the blend target: the environment's sample at sphere_uv(d)
        env = sample_grid(scene.env[None], 0, *sphere_uv(ray.d), wrap_a=True)
        bg = env.col
    else:
        bg = vm.splat(scene.background)
    behind = tuple(y2.a * y2.col[c] + (1.0 - y2.a) * bg[c] for c in range(3))
    comp = tuple(y1.a * y1.col[c] + (1.0 - y1.a) * behind[c] for c in range(3))
    img = tuple(vm.clip01(c) for c in comp) if cfg.clip else comp
    return SimpleNamespace(ray=ray, y1=y1, y2=y2, bg=bg, env=env, behind=behind, comp=comp,
                           img=img)


def render_vec_soft_culled(scene, cfg: RenderConfig):
    """The soft forward kernel's algorithm in eager torch, once per
    subsample: the two layers ranked over each warp's primary candidates,
    each shadow product over the warp's candidates by the per-pixel rule,
    the composite. The (H, W, 3) image (the subsamples' average)."""
    check_soft_kernel_config(scene, cfg)
    with torch.no_grad():
        return fused.subsample_average([
            torch.stack(_soft_forward(scene, cfg, cull=True, off=off).img, dim=-1)
            for off in SPP_OFFSETS[cfg.spp]])


def _soft_adjoint(scene, cfg, cotangent, off=(0.0, 0.0)):
    """The per-pixel soft adjoint of the step and of the render backward at
    the subsample offset ``off``: ``(sum of squared residuals, grads as a
    Scene)``; ``cotangent(img)`` gives the clipped image's cotangent per
    channel and the squared error (`fused.residual_cotangent`,
    `fused.image_cotangent`)."""
    tau = cfg.soft_tau
    sp, rc, lt = scene.spheres, scene.rects, scene.lights
    N, M, L = sp.count, rc.count, lt.count
    like = dict(device=scene.device, dtype=scene.ambient.dtype)
    zero = torch.zeros((cfg.height, cfg.width), **like)
    fw = _soft_forward(scene, cfg, off=off)
    ray, y1, y2, bg, behind, comp = fw.ray, fw.y1, fw.y2, fw.bg, fw.behind, fw.comp
    o, d = ray.o, ray.d

    # ---- the image's cotangent through the clip
    g_img, sq = cotangent(fw.img)
    g_comp = tuple(g * (vm.clip01_grad(p_) if cfg.clip else 1.0) for g, p_ in zip(g_img, comp))

    # ---- composite adjoint
    y1.g_a = sum(g_comp[c] * (y1.col[c] - behind[c]) for c in range(3))
    y1.g_col = tuple(g * y1.a for g in g_comp)
    g_beh = tuple(g * (1.0 - y1.a) for g in g_comp)
    y2.g_a = sum(g_beh[c] * (y2.col[c] - bg[c]) for c in range(3))
    y2.g_col = tuple(g * y2.a for g in g_beh)
    g_bg = [g * (1.0 - y2.a) for g in g_beh]
    for y in (y1, y2):  # a dead layer's colour is the background
        g_bg = [a + torch.where(y.hit, 0.0, g) for a, g in zip(g_bg, y.g_col)]
    g_env = None
    if fw.env is not None:  # every pixel's blend target: the environment's texels and d
        g_env, g_u, g_v = fused.grid_adjoint(fw.env, g_bg, torch.ones_like(zero, dtype=torch.bool),
                                             scene.env.shape[0] ** 2)
        g_d_env = fused.uv_adjoint(d, g_u, g_v)
        g_bg = [zero] * 3

    grads = tree_unflatten(scene, [torch.zeros_like(l) for l in tree_leaves(scene)])
    spheres, rects = grads.spheres, grads.rects
    tex_s, tex_r = spheres.texture.reshape(-1, 3), rects.texture.reshape(-1, 3)
    g_lpos = [(zero,) * 3 for _ in range(L)]
    g_lcol = [(zero,) * 3 for _ in range(L)]
    g_amb = (zero,) * 3
    g_o_cam, g_d_cam = (zero,) * 3, (zero,) * 3
    if g_env is not None:
        g_d_cam = g_d_env
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

        # ---- the layer's winner (and its soft checker's hit position, or
        # a textured winner's texels and, through the sample's weights, its
        # normal or (a, b))
        ck = _checker_adjoint(y, g.base, cfg.checker_tau) if cfg.checker_tau > 0.0 else None
        g_n_s, g_ab = g_n, None
        if sp.textured:
            g_ts, g_u, g_v = fused.grid_adjoint(y.tex_s, g.base, y.hit & y.is_sph,
                                                sp.texture[..., 0].numel())
            tex_s = tex_s + g_ts
            g_n_s = vm.vadd(g_n, fused.uv_adjoint(y.s_n, torch.where(y.is_sph, g_u, 0.0),
                                                   torch.where(y.is_sph, g_v, 0.0)))
        if rc.textured:
            g_tr, g_a, g_b = fused.grid_adjoint(y.tex_r, g.base, y.hit & y.is_rct,
                                                rc.texture[..., 0].numel())
            tex_r = tex_r + g_tr
            g_ab = (torch.where(y.is_rct, g_a, 0.0), torch.where(y.is_rct, g_b, 0.0))
        s_go, s_gd, g_c, g_r = fused.sphere_winner_adjoint(
            o, d, y.t, y.sc, y.sr, g_t, g_n_s, soft=(tau, g_alpha),
            g_pl=None if ck is None else ck.s_pl)
        r_go, r_gd, g_p0, g_eu, g_ev = fused.rect_winner_adjoint(
            o, d, y.p0, y.eu, y.ev, y.is_rct, g_t if ck is None else g_t + vm.vdot(ck.rel, d), g_n,
            g_ab)
        if ck is not None:  # rel = (o + d t) - origin, (a, b) = (rel . eu / |eu|^2, rel . ev / |ev|^2)
            r_go, r_gd = vm.vadd(r_go, ck.rel), vm.vadd(r_gd, vm.vscale(ck.rel, y.t))
            g_p0, g_eu, g_ev = vm.vsub(g_p0, ck.rel), vm.vadd(g_eu, ck.eu), vm.vadd(g_ev, ck.ev)
        g_o_cam = tuple(a + torch.where(y.hit, g_o[c] + y.pick(s_go[c], r_go[c], zero), 0.0)
                        for c, a in enumerate(g_o_cam))
        g_d_cam = tuple(a + torch.where(y.hit, g_d[c] + y.pick(s_gd[c], r_gd[c], zero), 0.0)
                        for c, a in enumerate(g_d_cam))
        if N:
            mg = _winner_materials(spheres.material, N, y.ks, y.is_sph, y.use2, g, ck, "s", like,
                                   sp.textured)
            spheres = dc.replace(
                spheres, center=spheres.center + fused.winner_rows(N, y.ks, y.is_sph, g_c, like),
                radius=spheres.radius + fused.winner_rows(N, y.ks, y.is_sph, [g_r], like)[:, 0],
                material=_add_materials(spheres.material, mg))
        if M:
            mg = _winner_materials(rects.material, M, y.kr, y.is_rct, y.use2, g, ck, "r", like,
                                   rc.textured)
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
    spheres = dc.replace(spheres, texture=tex_s.reshape(sp.texture.shape))
    rects = dc.replace(rects, texture=tex_r.reshape(rc.texture.shape))
    grads = dc.replace(grads, spheres=spheres, rects=rects, lights=lights, camera=camera,
                       ambient=torch.stack([x.sum() for x in g_amb]),
                       background=torch.stack([x.sum() for x in g_bg]))
    if g_env is not None:
        grads = dc.replace(grads, env=g_env.reshape(scene.env.shape))
    return sq, grads


_MATERIAL_GRADS = ("color", "color2", "checker", "checker_scale", "ka", "kd", "ks", "shininess")


def _add_materials(acc, inc):
    """``acc`` plus the winners' material gradients ``inc`` (from
    `_winner_materials`)."""
    return dc.replace(acc, **{f: getattr(acc, f) + getattr(inc, f) for f in _MATERIAL_GRADS})


def _winner_materials(mat_like, count, idx, mask, use2, g, ck, kind, like, textured=False):
    """The material leaves' gradients of a layer's winners of one kind
    (``kind``: "s" spheres, "r" rects): `fused.material_grads` for the hard
    checker (``ck`` None: the base to color or color2 as the checker
    picked, to neither for a ``textured`` group, no gradient to the checker
    columns), else the soft checker's
    (`_checker_adjoint`): the base's (1 - u) to color and u to color2, and
    the checker and checker-scale columns'."""
    zeros = torch.zeros((count,), **like)
    if ck is None:
        return dc.replace(fused.material_grads(mat_like, count, idx, mask, use2, g, like, textured),
                          checker=zeros, checker_scale=zeros)
    mg = fused.material_grads(mat_like, count, idx, mask, use2,
                              SimpleNamespace(**{**vars(g), "base": getattr(ck, kind + "_c1")}),
                              like)
    cols = fused.winner_rows(count, idx, mask, [getattr(ck, kind + "_chk"),
                                                getattr(ck, kind + "_cs")], like)
    return dc.replace(mg, color2=fused.winner_rows(count, idx, mask, getattr(ck, kind + "_c2"),
                                                   like),
                      checker=cols[:, 0], checker_scale=cols[:, 1])


def _soft_checker_q_adjoint(parts, tau, g_q):
    """Cotangents of the coordinates ``parts`` of q = `soft_checker_q`(parts,
    tau) for q's cotangent ``g_q``: factor i's is g_q times the product of
    the others (never a division by a factor, which is 0 on a cell
    boundary); f = tri / (|tri| + tau + 1e-6) has df/dtri = tau' / den^2,
    written (den - |tri|) / den^2 (1 / den where tri = 0, where |tri| has the
    subgradient 0); tri = 2 |m - 1| - 1 with the floored m = mod(x - 0.5, 2),
    whose derivative is 1."""
    m1 = [torch.remainder(x - 0.5, 2.0) - 1.0 for x in parts]
    tri = [2.0 * torch.abs(m) - 1.0 for m in m1]
    den = [torch.abs(t) + tau + 1e-6 for t in tri]
    f = [t / dn for t, dn in zip(tri, den)]
    out = []
    for i in range(len(parts)):
        others = g_q
        for j in range(len(parts)):
            if j != i:
                others = others * f[j]
        g_tri = others * (den[i] - torch.abs(tri[i])) / (den[i] * den[i])
        out.append(g_tri * 2.0 * torch.sign(m1[i]))
    return out


def _checker_adjoint(y, g_base, ctau):
    """The soft checker's adjoint for a layer's winners (``y`` from `_layer`,
    its ``ck`` from `fused.winner_surface`), given the base colour's
    cotangent ``g_base``, each term for a sphere winner and for a rect
    winner: base = c1 + u (c2 - c1), u = checker (0.5 - 0.5 q), q =
    soft_checker_q(parts), parts a sphere's (p - c) s or a rect's (a s, b s).
    Gives the cotangents of c1 and c2 (``s_c1`` ...), of the checker and
    checker-scale columns (``s_chk``, ``s_cs``), of a sphere's p - c
    (``s_pl``), and of a rect's rel = p - origin (``rel``) and, through the
    normalizations of (a, b), of its edges (``eu``, ``ev``)."""
    k = y.ck
    out = SimpleNamespace()
    for kind, parts, u, chk, dc_ in (("s", k.s_parts, k.s_u, k.s_chk, k.s_dc),
                                     ("r", k.r_parts, k.r_u, k.r_chk, k.r_dc)):
        parity = 0.5 - 0.5 * soft_checker_q(parts, ctau)
        g_u = vm.vdot(g_base, dc_)
        setattr(out, kind + "_c1", vm.vscale(g_base, 1.0 - u))
        setattr(out, kind + "_c2", vm.vscale(g_base, u))
        setattr(out, kind + "_chk", g_u * parity)
        setattr(out, kind + "_parts", _soft_checker_q_adjoint(parts, ctau, -0.5 * chk * g_u))
    out.s_pl = tuple(g * k.s_cs for g in out.s_parts)
    out.s_cs = sum(g * p for g, p in zip(out.s_parts, k.s_pl))
    g_a, g_b = (g * k.r_cs for g in out.r_parts)
    out.r_cs = out.r_parts[0] * k.ra + out.r_parts[1] * k.rb
    inv_uu, inv_vv = 1.0 / vm.vdot(y.eu, y.eu), 1.0 / vm.vdot(y.ev, y.ev)
    ga_n, gb_n = g_a * inv_uu, g_b * inv_vv
    out.rel = vm.vadd(vm.vscale(y.eu, ga_n), vm.vscale(y.ev, gb_n))
    out.eu = vm.vadd(vm.vscale(k.rel, ga_n),
                     vm.vscale(y.eu, -2.0 * ga_n * vm.vdot(k.rel, y.eu) * inv_uu))
    out.ev = vm.vadd(vm.vscale(k.rel, gb_n),
                     vm.vscale(y.ev, -2.0 * gb_n * vm.vdot(k.rel, y.ev) * inv_vv))
    return out
