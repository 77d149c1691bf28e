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

Covered: hard shading, spp 1 and 4, perspective, Phong, untextured objects;
and at either spp object texel grids, with or without the environment map
and bounce levels (the TPU kernels' texel tails, ``_tex_nest`` at fused_vec.py:207
and the samples of ``_sphere_eval`` / ``_rect_eval`` at :467-471 and :503):
the grids are not in the rows but read apart (`pack_texels`), a textured
winner's base colour at either level is its grid's bilinear sample, gathered
(the TPU kernels' dense hat-basis sampler, ``_make_sample_mxu`` at :253,
exists because Mosaic cannot gather, and is not carried over), and the step
and the render backward end their output with the grids' gradient (the
``_tex`` entries; `texel_step_smem_bytes` refuses grids whose gradient row
does not fit a block's shared memory). And at either spp
the environment map and K = 1 to `fused.MAX_REFLECTIONS` mirror bounce
levels, together or apart (the TPU kernels' env global, globals_tree at
fused_vec.py:405, and their reflection levels, :907-946 and :1015-1054,
:1029-1054 looping the levels in ``range(R + 1)``): the env ends the globals
(`globals_offsets`) and a missed ray's colour, at any level, is its bilinear
sample at the lat-long coordinates of the ray's direction; each bounce traces
level l + 1 from level l's shadow origins along the reflected direction where
every level above hit, over every sphere (the primary cone assumes rays
leaving the eye; the shadow rays of every level keep their per-warp cull),
the levels blend col_l + m_l (rcol_l - col_l) deepest first by the winners'
mirror coefficients and clip once; the forward writes (1 + K) L planes,
bounce-major. Each such combination is its own instance of each
kernel (the ``_levels`` entries), so the others keep their code. spp 4 as the
TPU kernels run it, in every instance: the forward and the render backward
are launched once per subsample at its offsets (`pipeline.SPP_OFFSETS`;
fused_vec.py:1443-1481), the image is the average of the four
(`fused.subsample_average`) formed in torch, through which autograd gives
each backward launch a quarter of the cotangent, and the planes are the four
launches' in order ((1 + R) L each); the step runs the 2x2 loop in the
kernel (fused_vec.py:997-1006, with a bounce :772-780), its residual of the
average (the textured step's ``_tex_band`` entry too). On a CPU
tensor each wrapper runs its plain version; on a CUDA tensor it launches its
kernel or raises. The step (gradient rows of the padded packing) and the
render backward deliver their gradients alike, through `unpack_grads`.
"""

from __future__ import annotations

import ctypes
import dataclasses as dc

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ...models.scene import tree_leaves, tree_unflatten
from ..pipeline import (
    SPP_OFFSETS,
    RenderConfig,
    band_config,
    n_vis_planes,
    primary_rays,
    reflect_dir,
    render_tile,
    shadow_origin,
)
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

# The wrappers call the ``_levels`` entries alone: after the geometry a
# subsample's (row, column) offset (rows 4-5) or the spp (row 6, which takes
# spp 4 in every instance; its textured ``_tex_band`` entry too), then the
# bounce levels (0 to 3) and the environment map's side (0 for none). At 0
# and 0 they launch the instances of the older entries, which stay only for
# tools/flat_ab.py's and tools/vec_step_split.py's builds of checkouts from
# before them (``_at`` / ``_spp``: spp 4; none: spp 1) and for chip_smoke.py's
# timings of rows 4-6: they are superseded, and go when no tool needs an
# entry that both trees have.
_LV = [_I, _I]  # refl, ke
# The textured instances' ``_tex`` entries take the texel grids' pointers
# after the rows, and after the bounce levels and the env's side the grids'
# sides (spheres', rects'; 0 for none); their output ends with the grids'
# gradient.
_TX = [_P, _P]  # stex, rtex
_KS = [_I, _I]  # ks, kr
# The wrappers call the ``_band`` entries of those two: the band's first
# image row and the image's height after the geometry, whose H is the band's
# rows (`fused.band_args`); the others are the whole image.
_BAND = fused._BAND
VEC_RENDER = Kernel("fused_vec_render", {
    "rrt_vec_render_tex_band": ([_P, _P, _P, *_TX, *_GEOM, *_BAND, _F, _F, *_LV, *_KS, _P, _P,
                                 _P], _I),
    "rrt_vec_render_levels_band": ([_P, _P, _P, *_GEOM, *_BAND, _F, _F, *_LV, _P, _P, _P], _I),
    "rrt_vec_render_tex": ([_P, _P, _P, *_TX, *_GEOM, _F, _F, *_LV, *_KS, _P, _P, _P], _I),
    "rrt_vec_render_levels": ([_P, _P, _P, *_GEOM, _F, _F, *_LV, _P, _P, _P], _I),
    "rrt_vec_render_levels_smem": ([_I, _I, _I, *_LV], ctypes.c_longlong),
    "rrt_vec_render_at": ([_P, _P, _P, *_GEOM, _F, _F, _P, _P, _P], _I),
    "rrt_vec_render": ([_P, _P, _P, *_GEOM, _P, _P, _P], _I),
    "rrt_smem_optin": ([], ctypes.c_longlong),
})
VEC_STEP = Kernel("fused_vec_step", {
    "rrt_vec_step_tex_band": ([_P, _P, _P, *_TX, *_GEOM, *_BAND, _I, *_LV, *_KS, _P, _F, _P, _P,
                               _P], _I),
    "rrt_vec_step_levels_band": ([_P, _P, _P, *_GEOM, *_BAND, _I, *_LV, _P, _F, _P, _P, _P], _I),
    "rrt_vec_step_tex": ([_P, _P, _P, *_TX, *_GEOM, *_LV, *_KS, _P, _F, _P, _P, _P], _I),
    "rrt_vec_step_tex_scratch_floats": ([_I] * 8, ctypes.c_longlong),
    "rrt_vec_step_tex_smem": ([_I] * 6, ctypes.c_longlong),
    "rrt_vec_step_levels": ([_P, _P, _P, *_GEOM, _I, *_LV, _P, _F, _P, _P, _P], _I),
    "rrt_vec_step_levels_scratch_floats": ([_I] * 6, ctypes.c_longlong),
    "rrt_vec_step_levels_smem": ([_I] * 4, ctypes.c_longlong),
    "rrt_vec_step_spp": ([_P, _P, _P, *_GEOM, _I, _P, _F, _P, _P, _P], _I),
    "rrt_vec_step": ([_P, _P, _P, *_GEOM, _P, _F, _P, _P, _P], _I),
    "rrt_vec_step_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
})
VEC_RENDER_BWD = Kernel("fused_vec_render_bwd", {
    "rrt_vec_render_bwd_tex_band": ([_P, _P, _P, *_TX, *_GEOM, *_BAND, _F, _F, *_LV, *_KS, _P, _P,
                                     _P, _P, _P], _I),
    "rrt_vec_render_bwd_levels_band": ([_P, _P, _P, *_GEOM, *_BAND, _F, _F, *_LV, _P, _P, _P, _P,
                                        _P], _I),
    "rrt_vec_render_bwd_tex": ([_P, _P, _P, *_TX, *_GEOM, _F, _F, *_LV, *_KS, _P, _P, _P, _P, _P],
                               _I),
    "rrt_vec_render_bwd_tex_scratch_floats": ([_I] * 8, ctypes.c_longlong),
    "rrt_vec_render_bwd_tex_smem": ([_I] * 6, ctypes.c_longlong),
    "rrt_vec_render_bwd_levels": ([_P, _P, _P, *_GEOM, _F, _F, *_LV, _P, _P, _P, _P, _P], _I),
    "rrt_vec_render_bwd_levels_scratch_floats": ([_I] * 6, ctypes.c_longlong),
    "rrt_vec_render_bwd_levels_smem": ([_I] * 4, ctypes.c_longlong),
    "rrt_vec_render_bwd_at": ([_P, _P, _P, *_GEOM, _F, _F, _P, _P, _P, _P, _P], _I),
    "rrt_vec_render_bwd": ([_P, _P, _P, *_GEOM, _P, _P, _P, _P, _P], _I),
    "rrt_vec_render_bwd_scratch_floats": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
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
    """(N, P_SPH) sphere rows (differentiable); a texel grid is not in them
    (`pack_texels`)."""
    sp = scene.spheres
    if sp.count == 0:
        return scene.ambient.new_zeros((0, P_SPH))
    return torch.cat([sp.center, sp.radius[:, None], *_mat_cols(sp.material)], dim=1)


def pack_rects(scene):
    """(M, P_RCT) rect rows (differentiable); a texel grid is not in them
    (`pack_texels`)."""
    rc = scene.rects
    if rc.count == 0:
        return scene.ambient.new_zeros((0, P_RCT))
    return torch.cat([rc.origin, rc.edge_u, rc.edge_v, *_mat_cols(rc.material)], dim=1)


def object_textured(scene_like) -> bool:
    """Does either object group carry texel grids?"""
    return scene_like.spheres.textured or scene_like.rects.textured


def pack_texels(scene):
    """The object texel grids as the textured instances read them: the
    spheres' (N ks^2 3,) and the rects' (M kr^2 3,), row-major, each empty
    where its group has none (differentiable). The step's and the render
    backward's output ends with their gradient in the same order: the JAX
    package's texel tails of the rows (fused_vec.py:370), read apart."""
    return scene.spheres.texture.reshape(-1), scene.rects.texture.reshape(-1)


def pad_rows(rows, n_pad: int, pad_row):
    """Pad object rows to ``n_pad`` with copies of the benign ``pad_row``."""
    if rows.shape[0] == n_pad:
        return rows
    key = (pad_row.tobytes(), rows.dtype, rows.device)
    fill = _PAD_FILLS.get(key)
    if fill is None:  # made once per device: no host copy inside a graph capture
        fill = _PAD_FILLS[key] = torch.as_tensor(pad_row, dtype=rows.dtype, device=rows.device)
    return torch.cat([rows, fill.expand(n_pad - rows.shape[0], -1)])


_PAD_FILLS: dict = {}


def globals_tree(scene) -> dict:
    """The object-count-independent parameters, in the key order in which
    JAX flattens a dict (sorted: ambient, background, camera, lights), but
    with the environment map last, as `fused.flat_offsets` ends the flat scene
    with it (a scene without one has an empty env: the order of JAX's
    globals)."""
    return {"ambient": scene.ambient, "background": scene.background,
            "camera": scene.camera, "lights": scene.lights, "env": scene.env}


def _globals_leaves(scene) -> list:
    return [leaf for v in globals_tree(scene).values() for leaf in tree_leaves(v)]


def flatten_globals(scene):
    """The flat (Sg,) globals vector (differentiable)."""
    return torch.cat([l.reshape(-1) for l in _globals_leaves(scene)])


def globals_offsets(n_light: int, ke: int = 0) -> dict:
    """Start of each global the kernels read, the (ke, ke, 3) environment
    map last (``csrc/render_common.cuh`` make_glayout and make_env_glayout
    compute the same)."""
    env = 16 + 6 * n_light
    return {"ambient": 0, "background": 3, "c_eye": 6, "c_look": 9, "c_up": 12,
            "c_fov": 15, "l_pos": 16, "l_col": 16 + 3 * n_light, "env": env,
            "Sg": env + 3 * ke * ke}


def unpack_grads(scene_like, dglob, dsph, drct, dtex=None):
    """The transpose of the packing: gradients of the flat globals, of the
    (padded) sphere and rect rows and of the texel grids (``dtex``, the
    spheres' then the rects' as `pack_texels` lays them out; zeros where it
    is None) -> a Scene of gradients."""
    N, M = scene_like.spheres.count, scene_like.rects.count

    def mat(rows, c0, like):
        return type(like)(color=rows[:, c0:c0 + 3], color2=rows[:, c0 + 3:c0 + 6],
                          checker=rows[:, c0 + 6], checker_scale=rows[:, c0 + 7],
                          ka=rows[:, c0 + 8], kd=rows[:, c0 + 9], ks=rows[:, c0 + 10],
                          shininess=rows[:, c0 + 11], mirror=rows[:, c0 + 12])

    sp, rc = scene_like.spheres, scene_like.rects
    ds, dr = dsph[:N], drct[:M]
    if dtex is None:
        s_tex, r_tex = torch.zeros_like(sp.texture), torch.zeros_like(rc.texture)
    else:
        if dtex.numel() != texel_row(scene_like):
            raise ValueError(f"dtex has {dtex.numel()} scalars, the grids {texel_row(scene_like)}")
        n = sp.texture.numel()
        s_tex, r_tex = dtex[:n].view(sp.texture.shape), dtex[n:].view(rc.texture.shape)
    spheres = type(sp)(center=ds[:, 0:3], radius=ds[:, 3], material=mat(ds, 4, sp.material),
                       texture=s_tex)
    rects = type(rc)(origin=dr[:, 0:3], edge_u=dr[:, 3:6], edge_v=dr[:, 6:9],
                     material=mat(dr, 9, rc.material), texture=r_tex)
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
    """Raise NotImplementedError for what the three vec kernels do not
    cover: more than `fused.MAX_REFLECTIONS` bounce levels, object texel
    grids whose gradient row does not fit a block's shared memory
    (`texel_step_smem_bytes`, the same at spp 1 and 4 and at every bounce
    count); any object count is covered, and at spp 1 and 4 object
    textures, the environment map and 1 to `fused.MAX_REFLECTIONS` bounce
    levels."""
    why = fused.uncovered(scene, cfg, env=True)
    if why is None and object_textured(scene):
        need = texel_step_smem_bytes(scene)
        if need > fused.MAX_BLOCK_SMEM:
            why = (f"object texel grids this large: {texel_row(scene)} texels' gradient needs "
                   f"{need} bytes of shared memory a block in the textured step, above the "
                   f"{fused.MAX_BLOCK_SMEM} a block has")
    if why is not None:
        raise NotImplementedError(f"the object-chunked CUDA kernels do not cover {why}")


def texel_row(scene_like) -> int:
    """The scalars of the object texel grids (the block's texel row)."""
    return scene_like.spheres.texture.numel() + scene_like.rects.texture.numel()


def texel_step_smem_bytes(scene_like) -> int:
    """Shared memory of a block of the textured step and render backward
    (csrc/vec_step.cuh `tex_step_plan`): the globals (with the environment
    map's texels), the rows, 8 warp rows of 1 + Sg + 10 slots, the block's
    object row, each warp's mask words of the primary cull and of each
    light's, one staging of 32 texel records of 16 words, and the block's
    texel row."""
    ns_pad, nr_pad = row_plan(scene_like)
    L = scene_like.lights.count
    Sg = globals_offsets(L, fused.texel_sizes(scene_like)[2])["Sg"]
    orow = ns_pad * P_SPH + nr_pad * P_RCT
    words = Sg + orow + 8 * (1 + Sg + 10) + orow + 32 * 16 + texel_row(scene_like)
    return 4 * words + 4 * 8 * (1 + L) * ((ns_pad + 31) // 32)


def levels(scene_like, cfg: RenderConfig):
    """The ``_levels`` entries' (bounce levels, the environment map's side,
    0 for none) of a scene and config."""
    return cfg.reflections, fused.texel_sizes(scene_like)[2]


def tex_levels(scene_like, cfg: RenderConfig):
    """The ``_tex`` entries' (bounce levels, the environment map's side, the
    spheres' and the rects' grids' sides; 0 for none)."""
    ks, kr, ke = fused.texel_sizes(scene_like)
    return cfg.reflections, ke, ks, kr


def _geometry(scene, cfg: RenderConfig):
    ns_pad, nr_pad = row_plan(scene)
    return [scene.spheres.count, scene.rects.count, ns_pad, nr_pad, scene.lights.count,
            cfg.height, cfg.width, int(cfg.shadows), int(cfg.clip)]


def most_rows(smem_fn, *rest) -> int:
    """The most spheres, in the rows' steps of 16, whose block needs at most
    the shared memory the current card allows, by ``smem_fn(n_sph, *rest)``
    (bytes a block of some kernel needs; ``rest``: the rects, the lights, the
    bounce levels and the environment map's side)."""
    have = fused.host_query(VEC_RENDER, "rrt_smem_optin")
    n = 0
    while smem_fn(n + 16, *rest) <= have:
        n += 16
    return n


def most_spheres(n_rect: int = 1, n_light: int = 1, ke: int = 0) -> int:
    """The most spheres that the vec step and render backward take beside
    ``n_rect`` rects and ``n_light`` lights (and an environment map of side
    ``ke``; the bounce adds none) on the current card (csrc/vec_step.cuh
    `step_plan`)."""
    return most_rows(VEC_STEP.lib().rrt_vec_step_levels_smem, n_rect, n_light, ke)


def most_render_spheres(n_rect: int = 1, n_light: int = 1, refl: int = 0, ke: int = 0) -> int:
    """The most spheres that the vec forward takes beside ``n_rect`` rects
    and ``n_light`` lights, with ``refl`` bounce levels and an environment
    map of side ``ke``, on the current card (csrc/cull.cuh
    `forward_smem`)."""
    return most_rows(VEC_RENDER.lib().rrt_vec_render_levels_smem, n_rect, n_light, refl, ke)


def check_smem(kernel: Kernel, entry: str, scene, *extra) -> None:
    """Refuse, with the numbers, a scene whose rows do not fit the shared
    memory a block of this card can have, by ``entry(n_sph, n_rect, n_light,
    *extra)`` (the ``_levels_smem`` entries' ``extra``: the forward's
    `levels`, the step's and backward's environment map side)."""
    need = fused.host_query(kernel, entry, scene.spheres.count, scene.rects.count,
                            scene.lights.count, *extra)
    have = fused.host_query(VEC_RENDER, "rrt_smem_optin")
    if need > have:
        raise NotImplementedError(
            f"{kernel.name} needs {need} bytes of shared memory per block for "
            f"{scene.spheres.count} spheres and {scene.rects.count} rects; this card "
            f"allows {have}")


def _cuda_inputs(scene, cfg: RenderConfig):
    check_vec_kernel_config(scene, cfg)
    return packed_inputs(scene)


def texel_inputs(scene):
    """`pack_texels`, contiguous float32, without gradient."""
    with torch.no_grad():
        return tuple(t.contiguous() for t in pack_texels(scene))


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
    want = globals_offsets(scene.lights.count, fused.texel_sizes(scene)[2])["Sg"]
    if glob.numel() != want:
        raise ValueError(f"globals have {glob.numel()} scalars, layout expects {want}")
    return glob, sph, rct


# ---------------------------------------------------------------------------
# Forward render kernel
# ---------------------------------------------------------------------------


def render_vec_plain(scene, cfg: RenderConfig, row0=0, out_height: int | None = None):
    """`render_eager_vec` with the visibility planes: the (H, W, 3) image and
    the (n_vis, H, W) planes (`n_vis_planes` layout), H the rows of the band
    of ``out_height`` rows from ``row0`` (`band_config`)."""
    cfg = band_config(cfg, row0, out_height)
    (r, g, b), vis = render_tile(scene, cfg, cfg.row0, 0, cfg.height, cfg.width, return_vis=True,
                                 shade_fn=shade_vec)
    n_vis = n_vis_planes(scene, cfg)
    planes = torch.stack(vis[:n_vis]) if n_vis else r.new_zeros((0, cfg.height, cfg.width))
    return torch.stack([r, g, b], dim=-1), planes


def render_vec(scene, cfg: RenderConfig, row0=0, out_height: int | None = None):
    """Image (H, W, 3) and visibility planes (n_vis, H, W), of the band of
    ``out_height`` rows from ``row0`` if given (H its rows). The forward
    kernel on CUDA, once per subsample (the image the subsamples' average,
    the planes theirs in order), `render_vec_plain` on the CPU. The image
    carries the scene's gradient on both: on CUDA through the render
    backward kernel, once per subsample (the planes carry none)."""
    dev = scene.device
    cfg = band_config(cfg, row0, out_height)
    if dev.type == "cpu":
        return render_vec_plain(scene, cfg)
    if dev.type != "cuda":
        raise NotImplementedError(f"no render kernel for device {dev}")
    rows = _cuda_inputs(scene, cfg)
    if object_textured(scene):
        rows = (*rows, *texel_inputs(scene))
    cfg1 = dc.replace(cfg, spp=1)
    leaves = tree_leaves(scene)
    outs = [_VecRender.apply(scene, cfg1, off, rows, *leaves) for off in SPP_OFFSETS[cfg.spp]]
    if len(outs) == 1:
        return outs[0]
    return fused.subsample_average([img for img, _ in outs]), torch.cat([v for _, v in outs])


def level_hits(scene, cfg: RenderConfig, off=(0.0, 0.0)):
    """Per bounce level, the (H, W) pixels whose ray at the subsample offset
    ``off`` hit an object (`fused.level_hits` by the object-vectorized
    trace): level 0's primary rays, and at each bounce level the reflected
    rays where every level above hit too: where the forward kernel's planes
    of that level and subsample are the plain version's (elsewhere the
    kernel's are 0)."""
    o, d = primary_rays(scene, cfg, off)
    t, k = nearest_vec(scene, o, d)
    hits = [k >= 0]
    zero = torch.zeros(cfg.shape, device=scene.device, dtype=scene.ambient.dtype)
    for _ in range(cfg.reflections):
        w = fused.winner_surface(scene, fused.winner_geometry(scene, k, zero), o, d, t, zero)
        o, d = shadow_origin(o, d, t, w.n), reflect_dir(d, w.n)
        t, k = nearest_vec(scene, o, d)
        hits.append(hits[-1] & (k >= 0))
    return hits


class _VecRender(torch.autograd.Function):
    """The vec forward and render backward kernels at one subsample offset
    ``off`` as one differentiable function of the scene's leaves (the
    ``custom_vjp`` of fused_vec.py:1340-1364), given the scene's packed
    ``rows`` (`packed_inputs`, and with object texel grids `texel_inputs`
    after them; they carry no gradient): the forward saves them and the
    visibility planes, the backward launches the backward kernel once."""

    @staticmethod
    def forward(ctx, scene, cfg, off, rows, *leaves):
        glob, sph, rct, *tex = rows
        check_smem(VEC_RENDER, "rrt_vec_render_levels_smem", scene, *levels(scene, cfg))
        if any(ctx.needs_input_grad):
            if tex:
                check_smem(VEC_RENDER_BWD, "rrt_vec_render_bwd_tex_smem", scene,
                           *tex_levels(scene, cfg)[1:])
            else:
                check_smem(VEC_RENDER_BWD, "rrt_vec_render_bwd_levels_smem", scene,
                           levels(scene, cfg)[1])
        dev = glob.device
        img = torch.empty((cfg.height, cfg.width, 3), device=dev)
        vis = torch.empty((n_vis_planes(scene, cfg), cfg.height, cfg.width), device=dev)
        ptrs = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr())
        if tex:
            VEC_RENDER.call("rrt_vec_render_tex_band", *ptrs, *(t.data_ptr() for t in tex),
                            *_geometry(scene, cfg), *fused.band_args(cfg), *off,
                            *tex_levels(scene, cfg), img.data_ptr(), vis.data_ptr(),
                            fused._stream(dev))
        else:
            VEC_RENDER.call("rrt_vec_render_levels_band", *ptrs, *_geometry(scene, cfg),
                            *fused.band_args(cfg), *off, *levels(scene, cfg), img.data_ptr(),
                            vis.data_ptr(), fused._stream(dev))
        VEC_RENDER.launches += 1
        ctx.scene, ctx.cfg, ctx.off = scene, cfg, off
        ctx.save_for_backward(glob, sph, rct, vis, *tex)
        ctx.mark_non_differentiable(vis)
        ctx.set_materialize_grads(False)
        return img, vis

    @staticmethod
    @once_differentiable
    def backward(ctx, g_img, _g_vis):
        if g_img is None:
            return (None, None, None, None, *(None for _ in tree_leaves(ctx.scene)))
        glob, sph, rct, vis, *tex = ctx.saved_tensors
        grads = _render_bwd_launch(ctx.scene, ctx.cfg, ctx.off, glob, sph, rct, g_img, vis, tex)
        return (None, None, None, None, *tree_leaves(grads))


# ---------------------------------------------------------------------------
# Render backward kernel
# ---------------------------------------------------------------------------


def _render_bwd_launch(scene_like, cfg, off, glob, sph, rct, g_img, vis, tex=()):
    """The scene's gradient (a Scene) from one backward-kernel call at the
    subsample offset ``off`` (``tex``: `texel_inputs` of a scene with object
    texel grids, the ``_tex`` entries)."""
    dev = glob.device
    g_img = fused.cotangent_f32(g_img, cfg)
    geom = _geometry(scene_like, cfg)
    refl, ke = levels(scene_like, cfg)
    out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel() + texel_row(scene_like),),
                      device=dev)
    ptrs = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr())
    if tex:
        tl = tex_levels(scene_like, cfg)
        scratch = fused._scratch(VEC_RENDER_BWD, "rrt_vec_render_bwd_tex_scratch_floats",
                                 (geom[0], geom[1], *geom[4:7], *tl[1:]), dev)
        VEC_RENDER_BWD.call("rrt_vec_render_bwd_tex_band", *ptrs, *(t.data_ptr() for t in tex),
                            *geom, *fused.band_args(cfg), *off, *tl, g_img.data_ptr(),
                            vis.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                            fused._stream(dev))
    else:
        scratch = fused._scratch(VEC_RENDER_BWD, "rrt_vec_render_bwd_levels_scratch_floats",
                                 (*geom[2:7], ke), dev)
        VEC_RENDER_BWD.call("rrt_vec_render_bwd_levels_band", *ptrs, *geom, *fused.band_args(cfg),
                            *off, refl, ke, g_img.data_ptr(), vis.data_ptr(),
                            scratch.data_ptr(), out.data_ptr(), fused._stream(dev))
    VEC_RENDER_BWD.launches += 1
    return _unpack_out(scene_like, out, glob, sph, rct)


def _unpack_out(scene_like, out, glob, sph, rct):
    """A step or backward kernel's output [sq, dglob, dsph, drct] (and with
    object texel grids their gradient, `pack_texels`' layout) -> the scene's
    gradient (a Scene)."""
    a = 1 + glob.numel()
    b = a + sph.numel()
    c = b + rct.numel()
    return unpack_grads(scene_like, out[1:a], out[a:b].view(sph.shape), out[b:c].view(rct.shape),
                        out[c:] if object_textured(scene_like) else None)


def render_vec_bwd_plain(scene, cfg: RenderConfig, g_img):
    """torch.autograd of `render_eager_vec` for the image cotangent."""
    return fused.autograd_vjp(render_eager_vec, scene, cfg, g_img)


# ---------------------------------------------------------------------------
# Fused training-step kernel
# ---------------------------------------------------------------------------


def loss_grad_vec(scene, cfg: RenderConfig, target, loss: str = "mse", row0=0,
                  out_height: int | None = None, norm: float | None = None):
    """``(norm * sq_sum, grads as a Scene)`` of the squared error between
    the render of ``scene`` and ``target`` (norm 1/(H*W*3) for mse, 1 for
    sum, unless given), of the band of ``out_height`` rows from ``row0`` if
    given (``target`` the band's; `fused.loss_grad_fused`). One step-kernel
    call on CUDA; autograd over `render_eager_vec` on the CPU."""
    dev = scene.device
    cfg = band_config(cfg, row0, out_height)
    w = fused._loss_norm(cfg, loss, norm)
    fused._check_target(target, cfg, scene)
    if dev.type == "cpu":  # the plain version takes the mean where no band or norm is given
        return loss_grad_vec_plain(scene, cfg, target, loss, norm=norm)
    if dev.type != "cuda":
        raise NotImplementedError(f"no step kernel for device {dev}")
    glob, sph, rct = _cuda_inputs(scene, cfg)
    target = target.contiguous()
    geom = _geometry(scene, cfg)
    refl, ke = levels(scene, cfg)
    out = torch.empty((1 + glob.numel() + sph.numel() + rct.numel() + texel_row(scene),),
                      device=dev)
    ptrs = (glob.data_ptr(), sph.data_ptr(), rct.data_ptr())
    if object_textured(scene):
        tl = tex_levels(scene, cfg)
        check_smem(VEC_STEP, "rrt_vec_step_tex_smem", scene, *tl[1:])
        stex, rtex = texel_inputs(scene)
        scratch = fused._scratch(VEC_STEP, "rrt_vec_step_tex_scratch_floats",
                                 (geom[0], geom[1], *geom[4:7], *tl[1:]), dev)
        VEC_STEP.call("rrt_vec_step_tex_band", *ptrs, stex.data_ptr(), rtex.data_ptr(),
                      *geom, *fused.band_args(cfg), cfg.spp, *tl, target.data_ptr(), w,
                      scratch.data_ptr(), out.data_ptr(), fused._stream(dev))
    else:
        check_smem(VEC_STEP, "rrt_vec_step_levels_smem", scene, ke)
        scratch = fused._scratch(VEC_STEP, "rrt_vec_step_levels_scratch_floats",
                                 (*geom[2:7], ke), dev)
        VEC_STEP.call("rrt_vec_step_levels_band", *ptrs, *geom, *fused.band_args(cfg), cfg.spp,
                      refl, ke, target.data_ptr(), w, scratch.data_ptr(), out.data_ptr(),
                      fused._stream(dev))
    VEC_STEP.launches += 1
    return w * out[0], _unpack_out(scene, out, glob, sph, rct)


def loss_grad_vec_plain(scene, cfg: RenderConfig, target, loss: str = "mse", row0=0,
                        out_height: int | None = None, norm: float | None = None):
    """torch.autograd of ``loss(render_eager_vec(scene), target)`` (of a
    band's, `fused.autograd_loss_grad`)."""
    return fused.autograd_loss_grad(render_eager_vec, scene, band_config(cfg, row0, out_height),
                                    target, loss, norm)


def culled_nearest(scene, o, d):
    """`nearest_vec` over each warp's primary candidates
    (`cull.primary_candidates`), as the step and backward kernels walk."""
    keep = per_pixel(primary_candidates(scene.spheres, scene.camera.eye, d), d[0].shape[1])
    return nearest_vec(scene, o, d, keep)


def culled_visibility(scene, cfg: RenderConfig):
    """The step kernel's visibility of light ``li`` at either bounce level:
    the any-hit test over each warp's shadow candidates for the pixels whose
    ray hit at that level (`cull.warp_candidates` at tau = 0), then the
    rects (1 everywhere without shadows)."""
    def visibility(li, so, f, zero, hit, level=0):
        if not cfg.shadows:
            return zero + 1.0
        cand = warp_candidates(scene.spheres, so, hit, scene.lights.position[li], 0.0)
        occ = occluded_any(scene, so, f.ldir, f.dist, per_pixel(cand, cfg.width))
        return torch.where(occ, 0.0, 1.0)
    return visibility


def render_vec_culled(scene, cfg: RenderConfig):
    """The vec forward kernel's algorithm in eager torch, once per
    subsample: the nearest hit over each warp's primary candidates (with
    bounces, each bounce level's over every sphere) and, at each level, the
    any-hit shadow test over each light's shadow candidates of its hit
    pixels, then the shading of the step's forward. Returns the (H, W, 3)
    image (the subsamples' average) and the (spp (1 + R) L, H, W) visibility
    planes (0 where that level's ray or one above it hits nothing, as the
    kernel writes them; none without shadows)."""
    check_vec_kernel_config(scene, cfg)
    imgs, planes = [], []
    with torch.no_grad():
        for off in SPP_OFFSETS[cfg.spp]:
            fw = fused.forward_terms(scene, cfg, culled_nearest, culled_visibility(scene, cfg),
                                     off, nearest1=nearest_vec)
            imgs.append(torch.stack(fw.img, dim=-1))
            live = torch.ones_like(fw.w.hit)
            for lv in fw.levels if cfg.shadows else ():
                live = live & lv.w.hit
                planes += [torch.where(live, vis, 0.0) for _, vis in lv.per_light]
    img = fused.subsample_average(imgs)
    if not cfg.shadows:
        return img, img.new_zeros((0, cfg.height, cfg.width))
    return img, torch.stack(planes)


def loss_grad_vec_adjoint_eager(scene, cfg: RenderConfig, target, loss: str = "mse"):
    """The vec step kernel's algorithm in eager torch: the object-vectorized
    nearest hit over each warp's primary candidates and any-hit shadow test
    over its shadow candidates (with bounces, each bounce level over every
    sphere and its own shadow candidates), then the same per-pixel adjoint
    as the small-scene step (`fused.loss_grad_adjoint_eager`): shade, the
    winning object only, the camera; with bounces the deepest level first,
    up to level 0, and the mirror coefficients. Same contract as
    `loss_grad_vec`."""
    check_vec_kernel_config(scene, cfg)
    norm = fused._loss_norm(cfg, loss)
    fused._check_target(target, cfg, scene)
    with torch.no_grad():
        sq, grads = fused.subsample_adjoint(scene, cfg, culled_nearest,
                                            fused.residual_cotangent(target, norm),
                                            lambda q: culled_visibility(scene, cfg),
                                            nearest1=nearest_vec)
    return norm * sq, grads


def render_vec_bwd_adjoint_eager(scene, cfg: RenderConfig, g_img, vis):
    """The vec render backward kernel's algorithm in eager torch: the vec
    step's adjoint (over the same primary candidates) with the image
    cotangent ``g_img`` in place of the residual and the forward's planes
    ``vis`` in place of the shadow rays: the scene's gradient (a Scene)."""
    check_vec_kernel_config(scene, cfg)
    fused._check_target(g_img, cfg, scene, "cotangent")
    with torch.no_grad():
        return fused.subsample_adjoint(scene, cfg, culled_nearest, fused.image_cotangent(g_img),
                                       fused.subsample_planes(scene, cfg, vis),
                                       nearest1=nearest_vec)[1]
