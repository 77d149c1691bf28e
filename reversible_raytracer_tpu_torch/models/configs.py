"""Benchmark scenes 1-5, config 6 (mirror reflections), configs 7-9
(texture, globe and sky recovery), config 10 (64 chrome spheres under a
sky), and the inverse-render start.

The counterpart of `reversible_raytracer_tpu.models.configs` for the
configs the CUDA kernels cover (hard shading). Each builder
returns ``(scene, spec, cfg)``: the ground-truth Scene on ``device``, the
ParamSpec of what the inverse render optimizes, and the RenderConfig.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pipeline import RenderConfig
from .scene import (
    Camera,
    Lights,
    Materials,
    ParamSpec,
    Scene,
    ground_plane,
    merge_spheres,
    resolve_device,
    sphere,
    tree_leaves,
    tree_unflatten,
)


def _lights(positions, colors, dev) -> Lights:
    return Lights(
        position=torch.tensor(positions, dtype=torch.float32, device=dev),
        color=torch.tensor(colors, dtype=torch.float32, device=dev),
    )


def config1_single_sphere(size: int = 64, device="cuda"):
    """Config 1: single sphere, Lambertian, no shadows; optimize
    center+radius."""
    dev = resolve_device(device)
    mat = Materials.make((0.9, 0.2, 0.2), ka=0.15, kd=0.9, ks=0.0, device=dev)
    scene = Scene.make(
        spheres=sphere((0.0, 0.0, 0.0), 1.0, mat, device=dev),
        lights=_lights([[3.0, 4.0, 5.0]], [[1.0, 1.0, 1.0]], dev),
        camera=Camera.make((0.0, 0.0, 4.0), (0.0, 0.0, 0.0), fov_deg=50.0,
                           device=dev),
        device=dev,
    )
    spec = (
        ParamSpec.none(scene)
        .train("spheres.center", lower=-3.0, upper=3.0)
        .train("spheres.radius", lower=0.2, upper=2.5)
    )
    return scene, spec, RenderConfig(height=size, width=size, shadows=False)


def config2_four_spheres(size: int = 128, device="cuda"):
    """Config 2: 4 spheres + ground plane, Phong specular, hard shadows;
    optimize centers/radii/albedos."""
    dev = resolve_device(device)
    m = lambda c, **kw: Materials.make(c, device=dev, **kw)
    parts = [
        sphere((-1.1, 0.0, 0.0), 0.55, m((0.9, 0.2, 0.2), ks=0.5, shininess=40.0), device=dev),
        sphere((1.1, 0.1, 0.3), 0.6, m((0.2, 0.8, 0.3), ks=0.5, shininess=40.0), device=dev),
        sphere((0.0, 0.9, -0.6), 0.5, m((0.25, 0.35, 0.9), ks=0.6, shininess=60.0), device=dev),
        sphere((0.1, -0.5, 1.0), 0.35, m((0.9, 0.8, 0.2), ks=0.4, shininess=25.0), device=dev),
    ]
    plane = ground_plane(-1.1, 12.0, m((0.6, 0.6, 0.6), ka=0.15, kd=0.85), device=dev)
    scene = Scene.make(
        spheres=merge_spheres(parts),
        rects=plane,
        lights=_lights([[4.0, 6.0, 4.0]], [[1.0, 1.0, 1.0]], dev),
        camera=Camera.make((0.0, 1.0, 5.0), (0.0, 0.0, 0.0), fov_deg=55.0,
                           device=dev),
        device=dev,
    )
    spec = (
        ParamSpec.none(scene)
        .train("spheres.center", lower=-3.0, upper=3.0)
        .train("spheres.radius", lower=0.15, upper=2.0)
        .train("spheres.material.color", lower=0.0, upper=1.0)
    )
    return scene, spec, RenderConfig(height=size, width=size, shadows=True)


def config3_multi_light(size: int = 256, device="cuda"):
    """Config 3: two lights with shadow rays; optimize light position +
    materials."""
    dev = resolve_device(device)
    m = lambda c, **kw: Materials.make(c, device=dev, **kw)
    parts = [
        sphere((-0.9, -0.1, 0.0), 0.6, m((0.85, 0.3, 0.25), ks=0.4, shininess=35.0), device=dev),
        sphere((0.9, 0.0, -0.4), 0.7, m((0.25, 0.45, 0.85), ks=0.4, shininess=35.0), device=dev),
        sphere((0.0, 0.8, 0.6), 0.4, m((0.3, 0.8, 0.35), ks=0.5, shininess=50.0), device=dev),
    ]
    plane = ground_plane(-0.8, 14.0, m((0.55, 0.55, 0.58), ka=0.15, kd=0.85), device=dev)
    scene = Scene.make(
        spheres=merge_spheres(parts),
        rects=plane,
        lights=_lights([[4.0, 5.0, 3.0], [-4.0, 4.0, 1.5]],
                       [[0.8, 0.75, 0.7], [0.35, 0.4, 0.5]], dev),
        camera=Camera.make((0.0, 1.2, 5.0), (0.0, 0.0, 0.0), fov_deg=55.0,
                           device=dev),
        device=dev,
    )
    spec = (
        ParamSpec.none(scene)
        .train("lights.position", lower=-8.0, upper=8.0)
        .train("spheres.material.color", lower=0.0, upper=1.0)
        .train("spheres.material.ks", lower=0.0, upper=1.0)
        .train("spheres.material.kd", lower=0.0, upper=1.0)
    )
    return scene, spec, RenderConfig(height=size, width=size, shadows=True)


def config4_checker_camera(size: int = 512, device="cuda"):
    """Config 4: checker materials (a checkered sphere and ground) +
    camera-pose optimization, 512^2. Its camera inversion needs the soft
    checker (`RenderConfig.checker_tau`, `optim.optimize_annealed`'s
    ``checker_ratio``): the hard checker gives hit positions no gradient."""
    dev = resolve_device(device)
    m = lambda c, **kw: Materials.make(c, device=dev, **kw)
    parts = [
        sphere((-0.9, 0.0, 0.0), 0.65,
               m((0.9, 0.25, 0.2), color2=(0.95, 0.9, 0.85), checker=1.0, checker_scale=4.0,
                 ks=0.4, shininess=40.0), device=dev),
        sphere((0.95, 0.1, -0.3), 0.6, m((0.2, 0.5, 0.9), ks=0.5, shininess=60.0), device=dev),
    ]
    plane = ground_plane(-0.75, 14.0,
                         m((0.85, 0.85, 0.85), color2=(0.15, 0.15, 0.18), checker=1.0,
                           checker_scale=18.0, ka=0.15, kd=0.85), device=dev)
    scene = Scene.make(
        spheres=merge_spheres(parts),
        rects=plane,
        lights=_lights([[4.0, 6.0, 4.0]], [[1.0, 1.0, 1.0]], dev),
        camera=Camera.make((0.3, 1.3, 4.6), (0.0, 0.0, 0.0), fov_deg=55.0, device=dev),
        device=dev,
    )
    spec = (
        ParamSpec.none(scene)
        .train("camera.eye", lower=-10.0, upper=10.0)
        .train("camera.look_at", lower=-5.0, upper=5.0)
        .train("spheres.material.color", lower=0.0, upper=1.0)
        .train("spheres.material.color2", lower=0.0, upper=1.0)
    )
    return scene, spec, RenderConfig(height=size, width=size, shadows=True)


def config5_many_spheres(size: int = 1024, n_spheres: int = 64, seed: int = 0,
                         device="cuda"):
    """Config 5: a jittered square grid of spheres (8x8 by default) over a
    ground plane, hard shadows; full joint inverse render (centers, radii,
    albedos and the light). The spheres come from numpy's
    ``default_rng(seed)`` in the JAX package's draw order (x, z, y, radius,
    colour per sphere), so both packages build the same scene."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    g = int(np.ceil(np.sqrt(n_spheres)))
    parts = []
    for k in range(n_spheres):
        gx, gz = k % g, k // g
        x = (gx - (g - 1) / 2) * 1.1 + rng.uniform(-0.2, 0.2)
        z = (gz - (g - 1) / 2) * 1.1 + rng.uniform(-0.2, 0.2)
        y = rng.uniform(-0.1, 0.45)
        radius = rng.uniform(0.28, 0.5)
        color = rng.uniform(0.15, 0.95, size=3)
        parts.append(sphere((x, y, z), radius,
                            Materials.make(color, ks=0.35, shininess=40.0, device=dev),
                            device=dev))
    plane = ground_plane(-0.6, 30.0, Materials.make((0.6, 0.6, 0.62), ka=0.15, kd=0.85,
                                                    device=dev), device=dev)
    scene = Scene.make(
        spheres=merge_spheres(parts),
        rects=plane,
        lights=_lights([[6.0, 12.0, 6.0]], [[1.0, 1.0, 1.0]], dev),
        camera=Camera.make((0.0, 7.0, 9.5), (0.0, 0.0, 0.0), fov_deg=60.0, device=dev),
        device=dev,
    )
    spec = (
        ParamSpec.none(scene)
        .train("spheres.center", lower=-8.0, upper=8.0)
        .train("spheres.radius", lower=0.15, upper=1.0)
        .train("spheres.material.color", lower=0.0, upper=1.0)
        .train("lights.position", lower=-16.0, upper=16.0)
    )
    return scene, spec, RenderConfig(height=size, width=size, shadows=True)


def config6_mirror(size: int = 512, device="cuda"):
    """Config 6: mirror reflections. A chrome-ish sphere (mirror 0.65) and a
    diffuse sphere (mirror 0) over a checkered, slightly reflective floor
    (mirror 0.18), rendered with one bounce (``reflections=1``); the inverse
    render recovers every object's mirror coefficient, whose gradient runs
    through the bounce."""
    dev = resolve_device(device)
    parts = [
        sphere((-0.55, 0.05, 0.0), 0.85,
               Materials.make((0.55, 0.56, 0.6), ka=0.08, kd=0.25, ks=0.5, shininess=80.0,
                              mirror=0.65, device=dev), device=dev),
        sphere((1.25, -0.15, -0.9), 0.65,
               Materials.make((0.2, 0.55, 0.9), ks=0.3, shininess=40.0, device=dev),
               device=dev),
    ]
    plane = ground_plane(-0.8, 14.0,
                         Materials.make((0.85, 0.85, 0.85), color2=(0.12, 0.12, 0.14),
                                        checker=1.0, checker_scale=16.0, ka=0.15, kd=0.8,
                                        mirror=0.18, device=dev), device=dev)
    scene = Scene.make(
        spheres=merge_spheres(parts),
        rects=plane,
        lights=_lights([[4.0, 6.0, 4.0]], [[1.0, 1.0, 1.0]], dev),
        camera=Camera.make((0.2, 1.1, 4.4), (0.0, 0.0, 0.0), fov_deg=55.0, device=dev),
        device=dev,
    )
    spec = (
        ParamSpec.none(scene)
        .train("spheres.material.mirror", lower=0.0, upper=0.95)
        .train("rects.material.mirror", lower=0.0, upper=0.95)
    )
    return scene, spec, RenderConfig(height=size, width=size, shadows=True, reflections=1)


def _grid(k: int):
    """The (k, k) meshgrids of ``linspace(0, 1, k)`` the texel patterns are
    drawn on (axis 0 first)."""
    return np.meshgrid(np.linspace(0, 1, k), np.linspace(0, 1, k), indexing="ij")


def config7_texture(size: int = 512, tex_k: int = 16, seed: int = 0, device="cuda"):
    """Config 7: texture recovery. A glossy sphere over a floor carrying a
    (tex_k, tex_k, 3) image texture, sampled bilinearly at the floor's (a, b);
    the inverse render recovers the texel grid (3 tex_k^2 parameters) from a
    perturbed start. The texels are the JAX package's (configs.py:242-290),
    drawn from numpy in its order, so both packages hold the same bits."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    ii, jj = _grid(tex_k)
    tex = np.stack([0.25 + 0.6 * ii, 0.25 + 0.6 * jj,
                    0.5 + 0.4 * np.sin(6.0 * ii) * np.cos(4.0 * jj)], axis=-1)
    for _ in range(4):
        ci, cj = rng.uniform(0.15, 0.85, size=2)
        r2 = (ii - ci) ** 2 + (jj - cj) ** 2
        tex += rng.uniform(-0.35, 0.35, size=3) * np.exp(-r2 / 0.02)[..., None]
    tex = np.clip(tex, 0.05, 0.95).astype(np.float32)
    scene = Scene.make(
        spheres=sphere((0.4, 0.1, 0.3), 0.75,
                       Materials.make((0.85, 0.3, 0.25), ks=0.45, shininess=50.0, device=dev),
                       device=dev),
        rects=ground_plane(-0.7, 4.5, Materials.make((1.0, 1.0, 1.0), ka=0.2, kd=0.85,
                                                     device=dev), texture=tex, device=dev),
        lights=_lights([[3.0, 7.0, 4.0]], [[1.0, 1.0, 1.0]], dev),
        camera=Camera.make((0.0, 4.2, 5.2), (0.0, -0.7, 0.0), fov_deg=55.0, device=dev),
        device=dev,
    )
    spec = ParamSpec.none(scene).train("rects.texture", lower=0.0, upper=1.0)
    return scene, spec, RenderConfig(height=size, width=size, shadows=True)


def config8_globe(size: int = 512, tex_k: int = 16, seed: int = 0, device="cuda"):
    """Config 8: sphere-texture recovery. A globe carrying a (tex_k, tex_k,
    3) lat-long texture (`pipeline.sphere_uv`: the azimuth wraps at the
    atan2 seam, the polar axis clamps) over a plain floor; the inverse render
    recovers the texel grid, whose far hemisphere gets no gradient (JAX
    configs.py:293-344, the same draws)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    ii, jj = _grid(tex_k)
    tex = np.stack([0.15 + 0.1 * jj, 0.25 + 0.25 * ii, 0.55 + 0.3 * jj], axis=-1)
    for _ in range(5):
        ci, cj = rng.uniform(0.1, 0.9, size=2)
        r2 = (ii - ci) ** 2 + (jj - cj) ** 2
        tex += np.array([0.35, 0.3, -0.25]) * np.exp(-r2 / 0.015)[..., None]
    tex = np.clip(tex, 0.05, 0.95).astype(np.float32)
    scene = Scene.make(
        spheres=sphere((0.0, 0.3, 0.0), 1.1,
                       Materials.make((1.0, 1.0, 1.0), ka=0.25, kd=0.9, ks=0.25, shininess=40.0,
                                      device=dev), texture=tex, device=dev),
        rects=ground_plane(-0.9, 5.0, Materials.make((0.75, 0.75, 0.78), ka=0.2, kd=0.8,
                                                     device=dev), device=dev),
        lights=_lights([[3.5, 5.0, 4.0]], [[1.0, 1.0, 1.0]], dev),
        camera=Camera.make((0.0, 0.9, 3.6), (0.0, 0.1, 0.0), fov_deg=50.0, device=dev),
        device=dev,
    )
    spec = ParamSpec.none(scene).train("spheres.texture", lower=0.0, upper=1.0)
    return scene, spec, RenderConfig(height=size, width=size, shadows=True)


def config9_sky(size: int = 512, env_k: int = 16, seed: int = 0, device="cuda"):
    """Config 9: environment-map recovery. A chrome-ish mirror sphere over a
    floor under a (env_k, env_k, 3) lat-long sky (`Scene.env`, sampled by a
    missed ray's direction), rendered with one bounce; miss pixels and the
    sphere's reflected misses give the sky texels their gradient (JAX
    configs.py:347-396, the same draws)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    ii, jj = _grid(env_k)
    env = np.stack([0.2 + 0.15 * ii, 0.3 + 0.2 * jj, 0.6 + 0.3 * (1.0 - jj)], axis=-1)
    for _ in range(3):
        ci, cj = rng.uniform(0.1, 0.9, size=2)
        r2 = (ii - ci) ** 2 + (jj - cj) ** 2
        env += np.array([0.5, 0.4, 0.1]) * np.exp(-r2 / 0.01)[..., None]
    env = np.clip(env, 0.05, 0.95).astype(np.float32)
    scene = Scene.make(
        spheres=sphere((0.0, 0.1, 0.0), 0.9,
                       Materials.make((0.9, 0.9, 0.9), ka=0.1, kd=0.3, ks=0.5, shininess=80.0,
                                      mirror=0.7, device=dev), device=dev),
        rects=ground_plane(-0.8, 4.5, Materials.make((0.55, 0.5, 0.45), ka=0.2, kd=0.8,
                                                     device=dev), device=dev),
        lights=_lights([[3.0, 6.0, 3.0]], [[1.0, 1.0, 1.0]], dev),
        camera=Camera.make((0.0, 0.6, 3.8), (0.0, 0.1, 0.0), fov_deg=55.0, device=dev),
        env=env,
        device=dev,
    )
    spec = ParamSpec.none(scene).train("env", lower=0.0, upper=1.0)
    return scene, spec, RenderConfig(height=size, width=size, shadows=True, reflections=1)


def config10_chrome_field(size: int = 512, n_spheres: int = 64, env_k: int = 16, seed: int = 0,
                          device="cuda"):
    """Config 10: a field of 64 chrome spheres (config 5's jittered grid, each
    with its own mirror coefficient) over a floor under config 9's sky,
    rendered with one bounce; the inverse render recovers the mirror
    coefficients and the sky's texels together. Past 24 objects it takes the
    object-chunked kernels with the environment map and the bounce. The
    draws are the JAX package's (configs.py:398-456): per sphere jitter x, z,
    y, radius, colour, mirror; then the sky's three sun blobs."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    g = int(np.ceil(np.sqrt(n_spheres)))
    parts = []
    for k in range(n_spheres):
        gx, gz = k % g, k // g
        x = (gx - (g - 1) / 2) * 1.1 + rng.uniform(-0.2, 0.2)
        z = (gz - (g - 1) / 2) * 1.1 + rng.uniform(-0.2, 0.2)
        y = rng.uniform(-0.1, 0.45)
        radius = rng.uniform(0.28, 0.5)
        color = rng.uniform(0.3, 0.9, size=3)
        mirror = float(rng.uniform(0.3, 0.8))
        parts.append(sphere((x, y, z), radius,
                            Materials.make(color, ka=0.1, kd=0.35, ks=0.4, shininess=60.0,
                                           mirror=mirror, device=dev), device=dev))
    ii, jj = _grid(env_k)
    env = np.stack([0.2 + 0.15 * ii, 0.3 + 0.2 * jj, 0.6 + 0.3 * (1.0 - jj)], axis=-1)
    for _ in range(3):
        ci, cj = rng.uniform(0.1, 0.9, size=2)
        r2 = (ii - ci) ** 2 + (jj - cj) ** 2
        env += np.array([0.5, 0.4, 0.1]) * np.exp(-r2 / 0.01)[..., None]
    env = np.clip(env, 0.05, 0.95).astype(np.float32)
    scene = Scene.make(
        spheres=merge_spheres(parts),
        rects=ground_plane(-0.6, 30.0, Materials.make((0.5, 0.5, 0.52), ka=0.15, kd=0.85,
                                                      device=dev), device=dev),
        lights=_lights([[6.0, 12.0, 6.0]], [[1.0, 1.0, 1.0]], dev),
        camera=Camera.make((0.0, 7.0, 9.5), (0.0, 0.0, 0.0), fov_deg=60.0, device=dev),
        env=env,
        device=dev,
    )
    spec = (
        ParamSpec.none(scene)
        .train("spheres.material.mirror", lower=0.0, upper=1.0)
        .train("env", lower=0.0, upper=1.0)
    )
    return scene, spec, RenderConfig(height=size, width=size, shadows=True, reflections=1)


CONFIGS = {
    1: config1_single_sphere,
    2: config2_four_spheres,
    3: config3_multi_light,
    4: config4_checker_camera,
    5: config5_many_spheres,
    6: config6_mirror,
    7: config7_texture,
    8: config8_globe,
    9: config9_sky,
    10: config10_chrome_field,
}


def perturb(scene: Scene, spec: ParamSpec, scale: float = 0.25, seed: int = 0) -> Scene:
    """Additive-noise perturbation of the trainable leaves: noise of
    ``max(std, 1) * scale`` from numpy's ``default_rng(seed)``, drawn leaf by
    leaf in treedef order (the JAX package's draw order, so both packages
    start from the same scene), clipped to the bounds."""
    leaves = tree_leaves(scene)
    tr = tree_leaves(spec.trainable)
    lo = tree_leaves(spec.lower)
    hi = tree_leaves(spec.upper)
    rng = np.random.default_rng(seed)
    out = []
    for leaf, t, l, h in zip(leaves, tr, lo, hi):
        if not t:
            out.append(leaf)
            continue
        host = leaf.detach().cpu().numpy()
        mag = max(float(np.std(host)), 1.0) * scale
        noise = rng.normal(0.0, mag, size=host.shape).astype(np.float32)
        moved = np.asarray(np.clip(host + noise, np.float32(l), np.float32(h)), np.float32)
        out.append(torch.from_numpy(moved).to(leaf.device))
    return tree_unflatten(scene, out)
