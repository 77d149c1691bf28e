"""Scene model: dataclasses of stacked float32 tensors.

The counterpart of `reversible_raytracer_tpu.models.scene`. Every parameter
kind is one stacked tensor (`Spheres.center: (N, 3)`, `Spheres.radius:
(N,)`, ...), so the renderer is a function of a handful of tensors and the
whole scene flattens to one flat vector, which is how it enters the CUDA
kernels (`ops.kernels.fused.flatten_scene`).

Leaf order is part of the contract: `tree_leaves` walks the dataclass
fields in declaration order, recursing into nested dataclasses, which is
exactly the treedef order of the JAX package's pytree (size-0 texture and
env leaves included). `configs.perturb`, the flat kernel layout and the
numpy bridge all rely on it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``cuda`` is the default across
    the package; asking for it on a machine without a GPU raises instead of
    quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --device cpu) to run on the CPU"
        )
    return dev


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _is_node(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def tree_leaves(tree) -> list:
    """Leaves in JAX treedef order (dataclass field order, depth first)."""
    if _is_node(tree):
        out = []
        for f in dataclasses.fields(tree):
            out.extend(tree_leaves(getattr(tree, f.name)))
        return out
    return [tree]


def tree_unflatten(like, leaves):
    """Rebuild the structure of ``like`` from ``leaves`` (inverse of
    `tree_leaves`)."""
    it = iter(leaves)

    def build(node):
        if _is_node(node):
            return dataclasses.replace(
                node, **{f.name: build(getattr(node, f.name))
                         for f in dataclasses.fields(node)}
            )
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of one structure."""
    cols = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def leaf_paths(tree) -> list[str]:
    """Dotted paths of every leaf, in `tree_leaves` order."""
    if _is_node(tree):
        out = []
        for f in dataclasses.fields(tree):
            sub = getattr(tree, f.name)
            if _is_node(sub):
                out.extend(f"{f.name}.{p}" for p in leaf_paths(sub))
            else:
                out.append(f.name)
        return out
    return [""]


@dataclass(frozen=True)
class Materials:
    """Per-object material parameters, stacked over K objects."""

    color: torch.Tensor  # (K, 3) base albedo
    color2: torch.Tensor  # (K, 3) second checker color
    checker: torch.Tensor  # (K,) 0 solid / 1 checkered (step select)
    checker_scale: torch.Tensor  # (K,)
    ka: torch.Tensor  # (K,) ambient
    kd: torch.Tensor  # (K,) diffuse
    ks: torch.Tensor  # (K,) specular
    shininess: torch.Tensor  # (K,) Phong exponent
    mirror: torch.Tensor  # (K,) mirror reflectivity

    @staticmethod
    def make(color, color2=None, checker=0.0, checker_scale=1.0, ka=0.1,
             kd=0.9, ks=0.0, shininess=30.0, mirror=0.0,
             device="cuda") -> "Materials":
        dev = resolve_device(device)
        one = lambda v: _f32(v, dev).reshape(1)
        return Materials(
            color=_f32(color, dev).reshape(1, 3),
            color2=_f32(color2 if color2 is not None else color, dev).reshape(1, 3),
            checker=one(checker),
            checker_scale=one(checker_scale),
            ka=one(ka),
            kd=one(kd),
            ks=one(ks),
            shininess=one(shininess),
            mirror=one(mirror),
        )


def _empty_materials(dev) -> Materials:
    z = torch.zeros((0, 3), device=dev)
    z1 = torch.zeros((0,), device=dev)
    return Materials(color=z, color2=z, checker=z1, checker_scale=z1,
                     ka=z1, kd=z1, ks=z1, shininess=z1, mirror=z1)


@dataclass(frozen=True)
class Spheres:
    center: torch.Tensor  # (N, 3)
    radius: torch.Tensor  # (N,)
    material: Materials
    texture: torch.Tensor  # (N, K, K, 3); K == 0 -> untextured

    @property
    def count(self) -> int:
        return self.center.shape[0]

    @property
    def textured(self) -> bool:
        return self.texture.numel() > 0

    @staticmethod
    def empty(device="cuda") -> "Spheres":
        dev = resolve_device(device)
        return Spheres(center=torch.zeros((0, 3), device=dev),
                       radius=torch.zeros((0,), device=dev),
                       material=_empty_materials(dev),
                       texture=torch.zeros((0, 0, 0, 3), device=dev))


@dataclass(frozen=True)
class Rects:
    """Parallelograms ``origin + a * edge_u + b * edge_v``, (a, b) in
    [0, 1]^2; face normal ``normalize(edge_u x edge_v)``."""

    origin: torch.Tensor  # (M, 3)
    edge_u: torch.Tensor  # (M, 3)
    edge_v: torch.Tensor  # (M, 3)
    material: Materials
    texture: torch.Tensor  # (M, K, K, 3); K == 0 -> untextured

    @property
    def count(self) -> int:
        return self.origin.shape[0]

    @property
    def textured(self) -> bool:
        return self.texture.numel() > 0

    @staticmethod
    def empty(device="cuda") -> "Rects":
        dev = resolve_device(device)
        z = torch.zeros((0, 3), device=dev)
        return Rects(origin=z, edge_u=z, edge_v=z,
                     material=_empty_materials(dev),
                     texture=torch.zeros((0, 0, 0, 3), device=dev))


@dataclass(frozen=True)
class Lights:
    position: torch.Tensor  # (L, 3)
    color: torch.Tensor  # (L, 3) RGB intensity

    @property
    def count(self) -> int:
        return self.position.shape[0]


@dataclass(frozen=True)
class Camera:
    eye: torch.Tensor  # (3,)
    look_at: torch.Tensor  # (3,)
    up: torch.Tensor  # (3,)
    fov_deg: torch.Tensor  # () vertical field of view in degrees

    @staticmethod
    def make(eye, look_at, up=(0.0, 1.0, 0.0), fov_deg=60.0,
             device="cuda") -> "Camera":
        dev = resolve_device(device)
        return Camera(eye=_f32(eye, dev), look_at=_f32(look_at, dev),
                      up=_f32(up, dev), fov_deg=_f32(fov_deg, dev))


@dataclass(frozen=True)
class Scene:
    spheres: Spheres
    rects: Rects
    lights: Lights
    camera: Camera
    ambient: torch.Tensor  # (3,)
    background: torch.Tensor  # (3,) miss color
    env: torch.Tensor  # (K, K, 3) lat-long environment map; K == 0 -> flat

    @property
    def env_mapped(self) -> bool:
        return self.env.numel() > 0

    @property
    def device(self) -> torch.device:
        return self.ambient.device

    @staticmethod
    def make(spheres=None, rects=None, lights=None, camera=None,
             ambient=(1.0, 1.0, 1.0), background=(0.0, 0.0, 0.0), env=None,
             device="cuda") -> "Scene":
        """``env``: an optional (K, K, 3) lat-long environment map, sampled
        by a missed ray's direction in place of ``background``."""
        dev = resolve_device(device)
        if lights is None:
            lights = Lights(position=_f32([[0.0, 5.0, 0.0]], dev),
                            color=_f32([[1.0, 1.0, 1.0]], dev))
        return Scene(
            spheres=spheres if spheres is not None else Spheres.empty(dev),
            rects=rects if rects is not None else Rects.empty(dev),
            lights=lights,
            camera=camera if camera is not None
            else Camera.make((0, 0, 5), (0, 0, 0), device=dev),
            ambient=_f32(ambient, dev),
            background=_f32(background, dev),
            env=(torch.zeros((0, 0, 3), device=dev) if env is None
                 else _square_grid(env, dev, "env map")),
        )


def scene_textured(scene: Scene) -> bool:
    """True when the scene carries any texel grid (object textures or an
    environment map)."""
    return scene.rects.textured or scene.spheres.textured or scene.env_mapped


def _square_grid(grid, dev, what: str) -> torch.Tensor:
    """A (K, K, 3) texel grid as float32 on ``dev`` (square, as the JAX
    package requires)."""
    g = _f32(grid, dev)
    if g.dim() != 3 or g.shape[-1] != 3 or g.shape[0] != g.shape[1]:
        raise ValueError(f"{what} must be square (K, K, 3), got {tuple(g.shape)}")
    return g


def _texture_leaf(texture, dev) -> torch.Tensor:
    """(K, K, 3) grid (or None) -> the (1, K, K, 3) stacked-texture leaf."""
    if texture is None:
        return torch.zeros((1, 0, 0, 3), device=dev)
    return _square_grid(texture, dev, "texture")[None]


def sphere(center, radius, material: Materials, texture=None, device="cuda") -> Spheres:
    """``texture``: an optional (K, K, 3) lat-long texel grid (azimuth on
    its first axis, `pipeline.sphere_uv`)."""
    dev = resolve_device(device)
    return Spheres(center=_f32(center, dev).reshape(1, 3),
                   radius=_f32(radius, dev).reshape(1),
                   material=material,
                   texture=_texture_leaf(texture, dev))


def rect(origin, edge_u, edge_v, material: Materials, texture=None, device="cuda") -> Rects:
    """``texture``: an optional (K, K, 3) texel grid sampled at the in-face
    coordinates (a, b)."""
    dev = resolve_device(device)
    return Rects(origin=_f32(origin, dev).reshape(1, 3),
                 edge_u=_f32(edge_u, dev).reshape(1, 3),
                 edge_v=_f32(edge_v, dev).reshape(1, 3),
                 material=material,
                 texture=_texture_leaf(texture, dev))


def ground_plane(y, half_extent, material: Materials, center_xz=(0.0, 0.0), texture=None,
                 device="cuda") -> Rects:
    """Horizontal rect of side 2*half_extent at height y, facing +y."""
    cx, cz = center_xz
    s = float(half_extent)
    return rect(origin=(cx - s, y, cz - s), edge_u=(0.0, 0.0, 2 * s),
                edge_v=(2 * s, 0.0, 0.0), material=material, texture=texture, device=device)


def merge_spheres(parts: "list[Spheres]") -> Spheres:
    return tree_map(lambda *xs: torch.cat(xs), *parts)


# ---------------------------------------------------------------------------
# Trainability + bounds spec
# ---------------------------------------------------------------------------


def path_matches(name: str, needle: str) -> bool:
    """Segment-aware dotted-path matching: ``needle`` must align to '.'
    boundaries of ``name`` ("spheres.material.color" does not match
    "...color2")."""
    if name == needle:
        return True
    if name.startswith(needle + "."):
        return True
    if name.endswith("." + needle):
        return True
    return ("." + needle + ".") in name


@dataclass(frozen=True)
class ParamSpec:
    """Which leaves of the Scene are optimized, and their box bounds: three
    Scene-structured trees whose leaves are a bool and two float32
    scalars."""

    trainable: Scene
    lower: Scene
    upper: Scene

    @staticmethod
    def none(scene: Scene) -> "ParamSpec":
        return ParamSpec(
            trainable=tree_map(lambda _: False, scene),
            lower=tree_map(lambda _: np.float32(-np.inf), scene),
            upper=tree_map(lambda _: np.float32(np.inf), scene),
        )

    def train(self, path_pred, lower=-np.inf, upper=np.inf) -> "ParamSpec":
        """Mark leaves whose dotted path satisfies ``path_pred`` (a string,
        matched by `path_matches`, or a callable) trainable."""
        if isinstance(path_pred, str):
            needle = path_pred
            path_pred = lambda p: path_matches(p, needle)
        paths = leaf_paths(self.trainable)

        def visit(tree, value):
            leaves = tree_leaves(tree)
            return tree_unflatten(
                tree, [value if path_pred(p) else l for p, l in zip(paths, leaves)]
            )

        return ParamSpec(
            trainable=visit(self.trainable, True),
            lower=visit(self.lower, np.float32(lower)),
            upper=visit(self.upper, np.float32(upper)),
        )
