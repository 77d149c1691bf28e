"""Scene <-> JSON: one key per leaf, its ``.``-joined path
(``spheres.material.color``), holding nested lists of float32 values, the
JAX package's schema."""

from __future__ import annotations

import json

import numpy as np
import torch

from ..models.scene import leaf_paths, tree_leaves, tree_unflatten


def scene_to_dict(scene) -> dict:
    return {name: leaf.detach().cpu().numpy().tolist()
            for name, leaf in zip(leaf_paths(scene), tree_leaves(scene))}


def scene_from_dict(data: dict, scene_like):
    """A Scene from `scene_to_dict` output, with the structure, shapes and
    device of ``scene_like``; a leaf the dict lacks is ``scene_like``'s."""
    leaves = []
    for name, like in zip(leaf_paths(scene_like), tree_leaves(scene_like)):
        if name in data:
            arr = np.asarray(data[name], np.float32).reshape(tuple(like.shape))
            leaves.append(torch.from_numpy(arr).to(like.device))
        else:
            leaves.append(like)
    return tree_unflatten(scene_like, leaves)


def save_scene(path: str, scene) -> None:
    with open(path, "w") as fh:
        json.dump(scene_to_dict(scene), fh, indent=2)


def load_scene(path: str, scene_like):
    with open(path) as fh:
        return scene_from_dict(json.load(fh), scene_like)
