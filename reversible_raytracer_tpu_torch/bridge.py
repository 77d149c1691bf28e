"""Carry scene values across from the JAX package as plain numpy arrays.

Neither function imports JAX: the caller flattens the JAX Scene itself
(``jax.tree_util.tree_leaves``) and passes the arrays in treedef order,
which is the order of `models.scene.tree_leaves`.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.scene import resolve_device, tree_leaves, tree_unflatten


def scene_from_numpy(leaves, like, device="cuda"):
    """A port Scene with the structure of ``like`` whose leaves are the
    given arrays (float32, on ``device``). Shapes must match ``like``."""
    dev = resolve_device(device)
    template = tree_leaves(like)
    leaves = list(leaves)
    if len(leaves) != len(template):
        raise ValueError(f"{len(leaves)} leaves given, the structure holds {len(template)}")
    out = []
    for arr, ref in zip(leaves, template):
        arr = np.asarray(arr, np.float32)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"leaf shape {arr.shape} != {tuple(ref.shape)}")
        out.append(torch.from_numpy(arr.copy()).to(dev))
    return tree_unflatten(like, out)


def scene_to_numpy(scene) -> list:
    """The scene's leaves as float32 numpy arrays, in treedef order."""
    return [l.detach().cpu().numpy().astype(np.float32) for l in tree_leaves(scene)]
