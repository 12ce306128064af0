"""The collectives of the sharded training step, on a mesh's per-axis groups.

The port's model is a functional tree of tensors with no nn.Module to wrap, so there
is no DDP or FSDP wrapper: the step calls these explicitly.

- `gather_for_compute`: the forward's view of a sharded tree. Each leaf split on the
  fsdp axis is all-gathered by `GatherShard`, an autograd.Function whose backward
  keeps this rank's slice of the full gradient. Ranks of one fsdp group take the same
  rows (the batch is split on `data` only, as the JAX package's batch_shardings
  split it), so their full gradients are equal and the slice needs no reduction: a
  reduce-scatter would count them fsdp times. `torch.autograd.grad` against the shard
  leaves then gives shard gradients, and the optimizer steps shards (ZeRO-3).
- `reduce_gradients`: the sum over the data axis. A leaf split on fsdp sums its slice
  over the data group. A leaf every rank holds whole sums over the data group too,
  but where fsdp > 1 it goes over the world with the gradients of fsdp ranks other
  than the first set to zero: one all-reduce, the same bits on every rank, so
  replicas cannot drift.

Every collective here (all-reduce, all-gather into one tensor, all-gather of
objects) runs on nccl, and on gloo for CPU and for CUDA tensors alike (gloo copies a
CUDA tensor through the host), so two ranks may share one card over gloo. Nothing
here switches backend.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import TENSOR_AXIS_ITEM, Mesh, map_with_spec, split

BUCKET_BYTES = 256 << 20  # the largest flat buffer one all-reduce of gradients takes
# bytes of the tensors this process handed to each kind of collective (a gather's
# full output, an all-reduce's buffer), for the caller to read and reset per step
traffic = collections.Counter()


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The pieces of `t` from every rank of `group`, concatenated along `dim` in rank
    order (`t` itself where group is None)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    traffic["all_gather"] += out.numel() * out.element_size()
    return out.movedim(0, dim).contiguous()


def all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """`t` summed (or reduced by `op`) over `group`, in place; `t` where group is None."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
        traffic["all_reduce"] += t.numel() * t.element_size()
    return t


def _sharded_dim(spec, mesh: Mesh) -> Optional[int]:
    """The one dimension of a leaf split over more than one rank, None if none is;
    only the fsdp axis may split it (tensor > 1 is not trained yet)."""
    found = None
    for dim, entry in enumerate(spec):
        pieces, _ = split(entry, mesh)
        if pieces > 1:
            if found is not None or mesh.shape["tensor"] > 1:
                raise NotImplementedError(f"training over the tensor axis is {TENSOR_AXIS_ITEM}")
            found = dim
    return found


class GatherShard(torch.autograd.Function):
    """All-gather of an fsdp-split leaf for the forward; the backward keeps this
    rank's slice of the (fsdp-group-identical) full gradient."""

    @staticmethod
    def forward(ctx, shard, dim, group, index):
        ctx.dim, ctx.index, ctx.n = dim, index, shard.shape[dim]
        return all_gather_dim(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(), None, None, None


def gather_leaf(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The full value of one leaf (differentiable where `t` requires grad)."""
    dim = _sharded_dim(spec, mesh)
    if dim is None:
        return t
    _, index = split(spec[dim], mesh)
    return GatherShard.apply(t, dim, mesh.group("fsdp"), index)


def gather_for_compute(tree, specs, mesh: Mesh):
    """The full parameter tree the forward reads: sharded leaves gathered (through
    GatherShard, so their gradients come back as slices), the others as they are."""
    return map_with_spec(lambda t, s: gather_leaf(t, s, mesh), tree, specs)


def _flat_all_reduce(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor over `group` in place, packed into flat buffers of at most
    BUCKET_BYTES per dtype and device."""
    by_kind = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_kind.values():
        bucket, nbytes = [], 0
        for t in ts + [None]:
            if t is not None and (not bucket or nbytes + t.numel() * t.element_size() <= BUCKET_BYTES):
                bucket.append(t)
                nbytes += t.numel() * t.element_size()
                continue
            if bucket:
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat, group=group)
                traffic["all_reduce"] += flat.numel() * flat.element_size()
                offset = 0
                for b in bucket:
                    b.copy_(flat[offset:offset + b.numel()].view_as(b))
                    offset += b.numel()
            bucket, nbytes = ([t], t.numel() * t.element_size()) if t is not None else ([], 0)


def reduce_gradients(grads: Sequence[torch.Tensor], specs: Sequence, mesh: Mesh) -> List[torch.Tensor]:
    """The micro-step's gradients summed over the data axis (see the module
    docstring), one per leaf, in place where a reduction runs."""
    grads = list(grads)
    if mesh.size == 1:
        return grads
    if mesh.shape["tensor"] > 1:
        raise NotImplementedError(f"training over the tensor axis is {TENSOR_AXIS_ITEM}")
    split_leaves, whole = [], []
    for g, s in zip(grads, specs):
        (split_leaves if _sharded_dim(s, mesh) is not None else whole).append(g)
    if mesh.shape["data"] > 1 and split_leaves:
        _flat_all_reduce(split_leaves, mesh.group("data"))
    if whole:
        if mesh.shape["fsdp"] > 1:
            if mesh.coordinate["fsdp"] != 0:
                for g in whole:
                    g.zero_()
            _flat_all_reduce(whole, mesh.world_group())
        elif mesh.shape["data"] > 1:
            _flat_all_reduce(whole, mesh.group("data"))
    return grads


def sum_over(values: Sequence[float], group, device) -> List[float]:
    """Host numbers summed over `group` in float64 (as they are where group is None)."""
    if group is None:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)
    dist.all_reduce(t, group=group)
    return t.tolist()


def max_over(values: Sequence[float], group, device) -> List[float]:
    """Host numbers, the largest over `group` (as they are where group is None)."""
    if group is None:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


def gather_objects(obj, group) -> list:
    """One picklable object from every rank of `group`, in rank order ([obj] where
    group is None)."""
    if group is None:
        return [obj]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
