"""Multi-process initialization on torch.distributed (port of parallel/multihost.py).

The reference's multi-node story is torchrun scaffolding only (train_grpo.sh:34-36,
empty multinode_training_demo.sh). `initialize()` joins the process group from
explicit arguments, `COORDINATOR_ADDRESS` (as the JAX package reads it) or
torchrun's environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`,
`LOCAL_RANK`); `make_global_mesh` builds a (data, fsdp, tensor) mesh over every
process's rank with the data axis spanning hosts (fsdp and tensor collectives stay
inside one host). Each process drives one device: `rank_device` picks it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from .collectives import all_gather_dim, split_dims
from .mesh import Mesh, groups_of, is_sharded, join_pieces, local_slice, make_mesh, map_with_spec

INIT_TIMEOUT_S = 600  # a rank that waits longer in the rendezvous or a collective raises


def rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """This process's device: `cuda` (None) is the CUDA device of its local rank
    (torchrun's LOCAL_RANK, else `rank`, else its rank in the group), and raises where the host has fewer
    devices than that; an explicit index (`cuda:0`) is taken as it is, so ranks
    share one device only when the caller names it. Raises without a CUDA device
    unless the CPU is asked for."""
    from ..cli.common import resolve_device

    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    import torch.distributed as dist

    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    if local >= torch.cuda.device_count():
        raise ValueError(f"local rank {local} has no CUDA device of its own ({torch.cuda.device_count()} on this "
                         f"host); name one (--device cuda:0) to share it, over gloo")
    return torch.device("cuda", local)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = INIT_TIMEOUT_S,
) -> bool:
    """Join the multi-process group. No-ops on single-process runs (returns False).

    coordinator_address ("host:port"; else COORDINATOR_ADDRESS, else torchrun's
    MASTER_ADDR:MASTER_PORT), num_processes (else WORLD_SIZE) and process_id (else
    RANK) mirror torchrun's --master_addr/--nnodes/--node_rank (train_grpo.sh:34-36).
    The backend is nccl for a CUDA device and gloo for the CPU unless `backend` names
    one; `device` (None: cuda) is this process's device, set as the current CUDA
    device before an nccl group forms. `timeout_s` bounds the rendezvous and every
    collective after it, so a rank whose peer died raises instead of waiting."""
    import torch.distributed as dist

    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("COORDINATOR_ADDRESS")
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        raise ValueError(f"a launch of {num_processes} processes needs a coordinator address "
                         "(--coordinator_address, COORDINATOR_ADDRESS, or MASTER_ADDR and MASTER_PORT)")
    if num_processes is None or process_id is None:
        raise ValueError(f"joining {coordinator_address} needs the number of processes and this process's id "
                         f"(--num_processes and --process_id, or WORLD_SIZE and RANK); got {num_processes}, "
                         f"{process_id}")
    dev = rank_device(device, int(process_id))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                            rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_global_mesh(fsdp: int = 1, tensor: int = 1) -> Mesh:
    """(data, fsdp, tensor) mesh over every process's rank; data absorbs the rest.

    fsdp*tensor must fit in one host's ranks (torchrun's LOCAL_WORLD_SIZE, else the
    whole world: one host) so those axes' collectives stay inside it."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if fsdp * tensor > local:
        raise ValueError(
            f"fsdp*tensor ({fsdp * tensor}) exceeds local devices ({local}); "
            "those axes must not cross hosts (they would put layer collectives between hosts)"
        )
    return make_mesh(data=-1, fsdp=fsdp, tensor=tensor)


def global_put(tree, specs, mesh: Mesh):
    """Each process holds the FULL logical value of every leaf (the same seed and data
    everywhere) and keeps its own slice under the leaf's spec; numpy leaves stay numpy.
    Works unchanged in a single process."""
    return map_with_spec(lambda x, s: local_slice(x, s, mesh), tree, specs)


@torch.no_grad()
def gather_params(tree, specs, mesh: Mesh, *, root: Optional[int] = None, device=None):
    """The full tree from its shards (the "weight push" of a rollout actor): each leaf
    split on the mesh is gathered over its axes and joined into the JAX layout
    (mesh.join_pieces), the others stay the same tensors. A
    collective: every rank calls it. root=None gives every rank the tree; root=r
    gives it to rank r and None elsewhere. device moves each gathered leaf there as
    it arrives (a checkpoint gathers onto the host)."""
    keep = root is None or mesh.rank == root

    def one(t, spec):
        if not is_sharded(spec, mesh):
            return t if keep else None
        for dim, axis in split_dims(spec, mesh):
            t = join_pieces(all_gather_dim(t, dim, mesh.group(axis)), dim, mesh.shape[axis], groups_of(spec, dim))
        if not keep:
            return None  # freed leaf by leaf
        return t.to(device) if device is not None else t

    out = map_with_spec(one, tree, specs)
    return out if keep else None


def process_info() -> dict:
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": int(os.environ.get("LOCAL_WORLD_SIZE", world)),
        "global_devices": world,
    }
