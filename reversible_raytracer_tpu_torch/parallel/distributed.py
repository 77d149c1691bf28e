"""The multi-process runtime: process bring-up, the primary rank, and the
gather of a row-sharded image (the counterpart of the JAX package's
parallel/distributed.py).

`initialize` brings up one ``torch.distributed`` process group: NCCL for a
CUDA device, gloo for the CPU. A rank's device is ``cuda:(rank %
device_count)``, so N ranks on one host take one card each (and ranks past
the card count share cards). With no arguments it brings up a group of one
rank, so that the sharded step runs alone on one card; the coordinator's
``host:port`` makes a group of ``num_processes`` ranks that meet there.
Nothing here falls back: asking for a backend this build of PyTorch lacks,
or for CUDA on a machine without it, raises by name.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda") -> torch.device:
    """Bring up the process group (once; a second call returns this rank's
    device) and return this rank's device: ``cuda:(rank % device_count)``
    for a CUDA ``device``, the CPU otherwise. With ``coordinator_address``
    (``host:port``) the group has ``num_processes`` ranks, this one
    ``process_id``, meeting at ``tcp://host:port``; without it, one rank.
    ``backend`` None takes `default_backend` of ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() is False; "
                           "pass --device cpu to run the sharded step over gloo on the CPU")
    if not dist.is_initialized():
        backend = backend or default_backend(dev)
        if not dist.is_backend_available(backend):
            raise RuntimeError(f"the {backend!r} backend of torch.distributed is not available "
                               f"in this build of PyTorch")
        world = int(num_processes or 1)
        if coordinator_address is None and world != 1:
            raise ValueError(f"{world} processes need a coordinator address (host:port)")
        if coordinator_address is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    rank=int(process_id or 0), world_size=world)
    if dev.type != "cuda":
        return torch.device("cpu")
    dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The ranks of the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Whether this process is rank 0, the one that writes the outputs."""
    return rank() == 0


def group_backend() -> str | None:
    """The process group's backend, None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def all_gather_rows(rows: torch.Tensor) -> np.ndarray:
    """Every rank's ``rows`` (the same shape on every rank) concatenated
    along the first axis in rank order, as numpy on every rank. Under NCCL
    the gather runs on the card; under gloo it goes through the host (gloo
    gathers CPU tensors only), a copy of each rank's rows to its host
    first."""
    rows = rows.detach().contiguous()
    if world_size() == 1:
        return rows.cpu().numpy()
    if group_backend() != "nccl":
        rows = rows.cpu()
    parts = [torch.empty_like(rows) for _ in range(world_size())]
    dist.all_gather(parts, rows)
    return torch.cat(parts).cpu().numpy()


def gather_image(image: torch.Tensor) -> np.ndarray:
    """The full (H, W, 3) image as numpy on every rank, from each rank's
    rows of it (`shard.render_sharded`: a rank holds consecutive bands, in
    rank order)."""
    return all_gather_rows(image)
