"""Ray parallelism over ranks: the image cut into row bands, the scene and
its gradient replicated (the counterpart of the JAX package's
parallel/shard.py).

The scaling dimension of inverse rendering is the pixel grid. A rank
renders or steps only its bands of whole image rows (every kernel takes a
band: ``row0`` and ``out_height``, `ops.pipeline.band_config`), each band's
loss and gradient pre-scaled by the whole image's normalization, so that
their sum over the bands is the whole image's. That sum is the only
traffic between ranks: the loss and the flattened gradient of the bands a
rank holds go into one flat buffer and one ``all_reduce`` a step (the JAX
package's single ``psum``), after which every rank applies the same Adam
update to the same sum, so the ranks' scenes stay identical to the bit.

A mesh (`RayMesh`) is the process group's ranks on the rays axis and the
bands of the image: one band a rank by default, or several, rendered in
turn and summed locally before the all-reduce (so one process stands for
the JAX package's 8-device mesh, and one card runs 2 or 4 bands). A second
axis (`make_scene_ray_mesh`) runs a batch of independent inversions, each
scene's gradient all-reduced over its own rays group only.

Under NCCL the sharded step is a CUDA graph with the all-reduce inside it
(`optim`'s `GraphStep`), captured after one collective has made NCCL's
communicator; gloo cannot be captured, so under gloo (and without a process
group) the step runs eagerly (`optim.make_eager_step`'s route).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..models.scene import ParamSpec, Scene, tree_leaves, tree_map, tree_unflatten
from ..ops.render import loss_and_grad_fn, render, render_eager
from ..ops.kernels import fused, fused_vec, fused_vec_soft
from ..ops.pipeline import RenderConfig, band_config
from ..ops.pipeline_vec import render_eager_vec
from ..optim import OptConfig, _make_step, _scan_key, make_flat_update
from . import distributed

RAYS_AXIS = "rays"
BATCH_AXIS = "batch"

_SHARD_SCAN_CACHE: dict = {}


@dataclass(frozen=True)
class RayMesh:
    """The rays axis: ``ranks`` ranks of the process ``group`` (None: the
    default group) splitting the image into ``n_bands`` row bands, this
    rank at position ``rank`` holding bands ``rank * k .. rank * k + k - 1``
    (``k = n_bands // ranks``). ``collective``: whether a process group is
    up, so that the step all-reduces (without one, a lone process sums its
    bands and nothing more)."""

    ranks: int
    rank: int
    n_bands: int
    group: object = None
    collective: bool = False

    @property
    def bands_per_rank(self) -> int:
        return self.n_bands // self.ranks

    @property
    def local_bands(self) -> range:
        k = self.bands_per_rank
        return range(self.rank * k, (self.rank + 1) * k)

    @property
    def shape(self) -> dict:
        return {RAYS_AXIS: self.n_bands}

    def band_rows(self, cfg: RenderConfig) -> int:
        """The rows of one band of ``cfg``'s image (its height over the
        bands; refused unless they divide it, as the JAX package asserts)."""
        if cfg.height % self.n_bands:
            raise ValueError(f"height {cfg.height} is not divisible by the mesh's "
                             f"{self.n_bands} bands")
        return cfg.height // self.n_bands

    def all_reduce(self, buf: torch.Tensor) -> None:
        """Sum ``buf`` in place over the rays axis (nothing without a group)."""
        if self.collective:
            dist.all_reduce(buf, group=self.group)


@dataclass(frozen=True)
class SceneRayMesh:
    """The (batch x rays) grid: ``batch`` scenes over ``batch_ranks`` rows
    of ranks, this rank in row ``batch_rank`` holding scenes ``batch_rank *
    s .. batch_rank * s + s - 1`` (``s = batch // batch_ranks``), each row's
    ranks a `RayMesh` of its own group (``rays``)."""

    batch: int
    batch_ranks: int
    batch_rank: int
    rays: RayMesh

    @property
    def local_scenes(self) -> range:
        s = self.batch // self.batch_ranks
        return range(self.batch_rank * s, (self.batch_rank + 1) * s)

    @property
    def shape(self) -> dict:
        return {BATCH_AXIS: self.batch, RAYS_AXIS: self.rays.n_bands}


def make_ray_mesh(n_bands: int | None = None) -> RayMesh:
    """The rays axis over every rank of the process group (one rank without
    one), with ``n_bands`` bands in all (default: one a rank; a multiple of
    the ranks)."""
    world, r = distributed.world_size(), distributed.rank()
    n = n_bands or world
    if n % world:
        raise ValueError(f"{n} bands do not divide evenly over {world} ranks")
    return RayMesh(ranks=world, rank=r, n_bands=n, collective=dist.is_initialized())


def make_scene_ray_mesh(batch: int, rays: int) -> SceneRayMesh:
    """The (batch x rays) grid: ``batch`` scenes, each image in ``rays``
    bands, over every rank of the process group. With at least ``batch``
    ranks each scene has its own row of ``world // batch`` ranks (its rays
    group, a ``new_group`` that every rank makes in the same order); with
    fewer, each rank holds ``batch // world`` whole scenes."""
    world, r = distributed.world_size(), distributed.rank()
    if world >= batch:
        if world % batch or rays % (world // batch):
            raise ValueError(f"{world} ranks do not split into {batch} rows of a {rays}-band "
                             f"rays axis")
        batch_ranks, ray_ranks = batch, world // batch
    else:
        if batch % world:
            raise ValueError(f"{batch} scenes do not divide evenly over {world} ranks")
        batch_ranks, ray_ranks = world, 1
    group = None
    if dist.is_initialized() and ray_ranks < world:
        for b in range(batch_ranks):  # every rank makes every row's group, in order
            g = dist.new_group(list(range(b * ray_ranks, (b + 1) * ray_ranks)))
            if b == r // ray_ranks:
                group = g
    rays_mesh = RayMesh(ranks=ray_ranks, rank=r % ray_ranks, n_bands=rays, group=group,
                        collective=dist.is_initialized() and ray_ranks > 1)
    return SceneRayMesh(batch=batch, batch_ranks=batch_ranks, batch_rank=r // ray_ranks,
                        rays=rays_mesh)


# ---------------------------------------------------------------------------
# Band functions
# ---------------------------------------------------------------------------

_BAND_RENDER = {
    "cuda": lambda s, c, r0, h: fused.render_fused(s, c, r0, h)[0],
    "cuda_vec": lambda s, c, r0, h: fused_vec.render_vec(s, c, r0, h)[0],
    "cuda_vec_soft": fused_vec_soft.render_vec_soft,
    "eager": render_eager,
    "eager_vec": render_eager_vec,
    "render": render,
}


def _band_render_fn(cfg: RenderConfig, band: int, impl: str | None = None):
    """``f(scene, row0) -> (band, W, 3)``: the band of ``band`` rows from
    ``row0`` through the family ``impl`` (``"cuda"``, ``"cuda_vec"``,
    ``"cuda_vec_soft"``, ``"eager"``, ``"eager_vec"``; None or ``"render"``:
    `ops.render.render`'s dispatch by device and scene)."""
    fn = _BAND_RENDER[impl or "render"]
    return lambda scene, row0: fn(scene, cfg, row0, band)


def _band_vag_fn(rcfg: RenderConfig, band: int, loss: str = "mse"):
    """``f(scene, target_band, row0) -> (loss, grads)``: the fused step of
    one band (rows 1, 6 or 9 on CUDA, by `ops.render.loss_and_grad_fn`'s
    policy; autograd of the eager twin on the CPU), its loss and gradient
    scaled by the whole image's normalization so that the bands' sums are
    the whole image's."""
    return lambda scene, target_band, row0: loss_and_grad_fn(
        scene, rcfg, loss, row0=row0, out_height=band)(scene, target_band)


def _band_render_vag_fn(rcfg: RenderConfig, band: int, loss: str, impl: str | None):
    """The other branch: torch autograd of the band's loss (the whole
    image's normalization times its squared error) through the band render
    (rows 2 + 3, 4 + 5 or 7 + 8 on CUDA)."""
    render_band = _band_render_fn(rcfg, band, impl)

    def vag(scene, target_band, row0):
        bcfg = band_config(rcfg, row0, band)
        return fused.autograd_loss_grad(lambda s, _cfg: render_band(s, row0), scene, bcfg,
                                        target_band, loss)

    return vag


def _pack(loss, grads) -> torch.Tensor:
    return torch.cat([loss.reshape(1).to(torch.float32),
                      *(g.reshape(-1).to(torch.float32) for g in tree_leaves(grads))])


def _unpack(buf, like):
    out, off = [], 1
    for leaf in tree_leaves(like):
        out.append(buf[off:off + leaf.numel()].view(leaf.shape))
        off += leaf.numel()
    return buf[0], tree_unflatten(like, out)


def _local_sums(mesh: RayMesh, rcfg: RenderConfig, band: int, loss: str, impl: str | None):
    """``f(scene, target_rows) -> buf``: the loss and the flattened gradient
    (`_pack`) summed over this rank's bands (``target_rows`` their rows of
    the target, in order), by the fused band step (``impl`` None or
    ``"step"``) or by autograd through the band render (``impl`` a render
    family, `_band_render_fn`)."""
    if impl in (None, "step"):
        band_vag = _band_vag_fn(rcfg, band, loss)
    else:
        band_vag = _band_render_vag_fn(rcfg, band, loss, impl)

    def sums(scene, target_rows):
        buf = None
        for k, b in enumerate(mesh.local_bands):
            part = _pack(*band_vag(scene, target_rows[k * band:(k + 1) * band], b * band))
            buf = part if buf is None else buf + part
        return buf

    return sums


def _sharded_loss_and_grads(mesh: RayMesh, rcfg: RenderConfig, band: int, loss: str,
                            impl: str | None):
    """``f(scene, target_rows) -> (loss, grads)`` of one step: this rank's
    bands summed (`_local_sums`), then the sum in one buffer and ONE
    all-reduce over the rays axis."""
    sums = _local_sums(mesh, rcfg, band, loss, impl)

    def loss_and_grads(scene, target_rows):
        buf = sums(scene, target_rows)
        mesh.all_reduce(buf)
        return _unpack(buf, scene)

    return loss_and_grads


def _local_rows(mesh: RayMesh, target, band: int):
    """This rank's rows of the (H, W, 3) target, contiguous float32."""
    b = mesh.local_bands
    return target[b.start * band:b.stop * band].to(torch.float32).contiguous()


def render_sharded(scene: Scene, cfg: RenderConfig, mesh: RayMesh, impl: str | None = None):
    """This rank's rows of the image: its bands, rendered in turn and
    stacked in order (rank r holds rows ``r k band .. (r + 1) k band - 1``);
    `distributed.gather_image` puts the ranks' rows together."""
    band = mesh.band_rows(cfg)
    render_band = _band_render_fn(cfg, band, impl)
    return torch.cat([render_band(scene, b * band) for b in mesh.local_bands])


def _capture(mesh: RayMesh, device) -> bool:
    """Whether the sharded step is a CUDA graph: under NCCL (the all-reduce
    captured inside it), never under gloo, whose collectives a graph cannot
    hold, nor without a process group on the CPU."""
    if torch.device(device).type != "cuda":
        return False
    if not mesh.collective:
        return True
    return dist.get_backend(mesh.group) == "nccl"


def _warm_collective(mesh: RayMesh, device) -> None:
    """One all-reduce before a capture: NCCL makes its communicator at the
    first collective, which a CUDA graph cannot hold."""
    if mesh.collective:
        mesh.all_reduce(torch.zeros((1,), device=device))
        torch.cuda.synchronize(device)


def make_sharded_step(mesh: RayMesh, rcfg: RenderConfig, spec: ParamSpec, ocfg: OptConfig,
                      impl: str | None = None):
    """``(step, init)`` of the distributed optimization step: this rank's
    band losses and gradients, one all-reduce, the flat Adam update
    (`optim.make_flat_update`), the same on every rank. ``init(scene,
    target) -> (scene, state, target_rows)`` takes the (H, W, 3) target and
    keeps this rank's rows of it; ``step(scene, state, target_rows) ->
    (scene, state, loss, grad_norm)``. ``impl`` None takes the fused band
    step (`_sharded_loss_and_grads`). The update is built by ``init`` from
    the scene's structure (a scene of another structure rebuilds it), so a
    ``step`` before ``init`` raises. On CUDA under NCCL the step is one CUDA
    graph replay (the all-reduce inside it); under gloo it runs eagerly."""
    band = mesh.band_rows(rcfg)
    vag = _sharded_loss_and_grads(mesh, rcfg, band, ocfg.loss, impl)
    built = {}

    def init(scene, target):
        key = (tuple(l.shape for l in tree_leaves(scene)), str(scene.device))
        if built.get("key") != key:
            capture = _capture(mesh, scene.device)
            if capture:
                _warm_collective(mesh, scene.device)
            built["key"] = key
            built["step"], built["init"] = _make_step(rcfg, spec, ocfg, None, vag,
                                                      capture=capture)
        return scene, built["init"](scene), _local_rows(mesh, target, band)

    def step(scene, state, target_rows):
        if "step" not in built:
            raise RuntimeError("make_sharded_step: call init(scene, target) before step() "
                               "— the flat optimizer update is built from the scene's "
                               "structure at init time")
        return built["step"](scene, state, target_rows)

    def captured() -> bool:
        """Whether the step replays a captured CUDA graph."""
        inner = built["step"].parts.get("step") if "step" in built else None
        return getattr(inner, "graph", None) is not None

    step.captured = captured
    return step, init


def optimize_sharded_scan(scene: Scene, target, mesh: RayMesh, rcfg: RenderConfig,
                          spec: ParamSpec, ocfg: OptConfig, impl: str | None = None):
    """The whole sharded inversion, ``ocfg.iters`` steps of
    `make_sharded_step` back to back with no host wait (the JAX package's
    ``lax.scan``), each step's loss into one device tensor. The step (its
    captured graph) is kept by scene structure, configurations, mesh and
    ``impl`` and reused by later calls. Returns (final_scene, losses[iters]);
    the final scene is a copy."""
    sig = ("sharded", _scan_key(scene, spec, rcfg, ocfg, None), mesh, impl)
    if sig not in _SHARD_SCAN_CACHE:
        _SHARD_SCAN_CACHE[sig] = make_sharded_step(mesh, rcfg, spec, ocfg, impl)
    step, init = _SHARD_SCAN_CACHE[sig]
    scene, state, rows = init(scene, target)
    losses = torch.empty((ocfg.iters,), dtype=torch.float32, device=rows.device)
    for it in range(ocfg.iters):
        scene, state, loss, _ = step(scene, state, rows)
        losses[it] = loss
    return tree_map(lambda l: l.detach().clone(), scene), losses


# ---------------------------------------------------------------------------
# Batched scenes: independent inversions over a (batch x rays) grid
# ---------------------------------------------------------------------------


def stack_scenes(scenes: "list[Scene]") -> Scene:
    """Stack B scenes of one structure into one (a leading axis B on every
    leaf)."""
    return tree_map(lambda *xs: torch.stack(xs), *scenes)


def unstack_scenes(batched: Scene) -> "list[Scene]":
    """The B scenes of a stacked one."""
    b = tree_leaves(batched)[0].shape[0]
    return [tree_map(lambda x: x[i], batched) for i in range(b)]


def make_batched_step(mesh: SceneRayMesh, rcfg: RenderConfig, spec: ParamSpec,
                      ocfg: OptConfig, impl: str | None = None):
    """``(step, init)`` of a batch of independent inversions on the (batch x
    rays) grid. ``init(scenes, targets) -> (scenes, state, targets)`` takes
    the stacked batch and its (B, H, W, 3) targets and keeps this rank's
    scenes and their rows; ``step(scenes, state, targets) -> (scenes, state,
    per_scene_loss, grad_norm)``. Each scene's band losses and gradients go,
    with the other scenes', into one buffer and one all-reduce over this
    row's rays group (scenes never meet); each scene then takes the flat
    Adam update of its own gradient (adam, lr_scales, lr, as the JAX
    package's optax chain), and ``grad_norm`` is that of the whole batch's
    gradients together (the JAX package's ``optax.global_norm`` over the
    batch): the squared norms of this rank's scenes summed, then one scalar
    all-reduce over every rank, divided by the rays ranks (each rank of a row
    holds its row's sums), before the root. The step runs eagerly: the
    batch's loop over scenes is short and is not captured."""
    rays = mesh.rays
    band = rays.band_rows(rcfg)
    sums = _local_sums(rays, rcfg, band, ocfg.loss, impl)
    built = {}

    def init(scenes, targets):
        local = mesh.local_scenes
        scenes = tree_map(lambda x: x[local.start:local.stop], scenes)
        first = unstack_scenes(scenes)[0]
        built["init"], built["apply"] = make_flat_update(first, spec, ocfg)
        states = [built["init"](s) for s in unstack_scenes(scenes)]
        state = {k: torch.stack([st[k] for st in states]) for k in states[0]}
        rows = torch.stack([_local_rows(rays, targets[i], band) for i in local])
        return scenes, state, rows

    def step(scenes, state, targets):
        if "apply" not in built:
            raise RuntimeError("make_batched_step: call init(scenes, targets) before step()")
        singles = unstack_scenes(scenes)
        bufs = [sums(s, targets[i]) for i, s in enumerate(singles)]
        buf = torch.cat(bufs)
        rays.all_reduce(buf)
        n = bufs[0].numel()
        losses, outs, states, sq = [], [], [], 0.0
        for i, s in enumerate(singles):
            l, g = _unpack(buf[i * n:(i + 1) * n], s)
            st = {k: v[i] for k, v in state.items()}
            s2, st2, gnorm = built["apply"](s, st, g)
            losses.append(l)
            outs.append(s2)
            states.append(st2)
            sq = sq + gnorm * gnorm
        if dist.is_initialized() and mesh.batch_ranks > 1:  # the other rows' scenes
            sq = sq.reshape(1)
            dist.all_reduce(sq)
            sq = sq[0] / rays.ranks
        state = {k: torch.stack([st[k] for st in states]) for k in states[0]}
        return stack_scenes(outs), state, torch.stack(losses), torch.sqrt(sq)

    return step, init


def optimize_batched_scan(scenes: Scene, targets, mesh: SceneRayMesh, rcfg: RenderConfig,
                          spec: ParamSpec, ocfg: OptConfig, impl: str | None = None):
    """``ocfg.iters`` steps of `make_batched_step` with no host wait.
    Returns (this rank's scenes, losses[iters, scenes])."""
    step, init = make_batched_step(mesh, rcfg, spec, ocfg, impl)
    scenes, state, rows = init(scenes, targets)
    losses = []
    for _ in range(ocfg.iters):
        scenes, state, loss, _ = step(scenes, state, rows)
        losses.append(loss)
    return scenes, torch.stack(losses)
