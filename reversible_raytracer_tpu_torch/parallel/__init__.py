"""Ray parallelism across processes and cards: row bands of the image over
the ranks of a ``torch.distributed`` process group, the gradient's one
all-reduce a step, the multi-process runtime and batched scenes (the
counterpart of the JAX package's parallel/ package)."""

from .distributed import gather_image, initialize, is_primary  # noqa: F401
from .shard import (  # noqa: F401
    BATCH_AXIS,
    RAYS_AXIS,
    make_batched_step,
    make_ray_mesh,
    make_scene_ray_mesh,
    make_sharded_step,
    optimize_batched_scan,
    optimize_sharded_scan,
    render_sharded,
    stack_scenes,
    unstack_scenes,
)
