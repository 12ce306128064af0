"""The collectives of the sharded training step, on a mesh's per-axis groups.

The port's model is a functional tree of tensors with no nn.Module to wrap, so there
is no DDP or FSDP wrapper: the step calls these explicitly.

- `gather_for_compute`: the forward's view of a sharded tree. Each leaf split on the
  fsdp axis is all-gathered over fsdp by `GatherShard`, an autograd.Function whose
  backward keeps this rank's slice of the full gradient; a dimension split on tensor
  stays this rank's piece. Ranks of one fsdp group take the same rows (the batch is
  split on `data` only, as the JAX package's batch_shardings split it), so their full
  gradients are equal and the slice needs no reduction: a reduce-scatter would count
  them fsdp times. `torch.autograd.grad` against the shard leaves then gives shard
  gradients, and the optimizer steps shards (ZeRO-3).
- `TensorParallel`: the tensor axis inside the forward (Megatron's layout). Each rank
  of a tensor group takes the same rows and computes its own heads and its own slice
  of the MLP widths: `f` (identity forward, all-reduce over tensor backward) at the
  input of each column-split block, `g` (all-reduce forward, identity backward) after
  each row-split product, the row-split biases added once, after `g`. A replicated
  bias in front of a column-split matrix is sliced by `SliceLocal`, whose backward
  all-gathers its pieces, so its gradient is whole on every rank. A block whose
  column and row matrices are not all split (the decoder's under LoRA, whose wrapped
  matrices the rules leave whole) runs whole, its split leaves gathered over tensor by
  GatherShard. Where the tensor axis exceeds the decoder's KV head count, a rank's
  query heads read one KV head of which it holds a piece: `ShareKVHead` joins the
  pieces of wk, wv, bk and bv over the rank's KV-replica group (Mesh.kv_group) and
  sums the group's gradients of the whole head in the backward.
- `reduce_gradients`: the sum over the data axis. A leaf split on fsdp or tensor sums
  its piece over the data group. A leaf every rank holds whole sums over the data
  group too, but where fsdp or tensor is above 1 it goes over the world with the
  gradients of every rank whose fsdp or tensor coordinate is not 0 set to zero: one
  all-reduce, the same bits on every rank, so replicas cannot drift.

Every collective here (all-reduce, all-gather into one tensor, all-gather of
objects) runs on nccl, and on gloo for CPU and for CUDA tensors alike (gloo copies a
CUDA tensor through the host), so two ranks may share one card over gloo. Nothing
here switches backend.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh, _axes, groups_of, join_pieces, map_with_spec, split, take_piece

BUCKET_BYTES = 256 << 20  # the largest flat buffer one all-reduce of gradients takes
# bytes of the tensors this process handed to each kind of collective (a gather's
# full output, an all-reduce's buffer), for the caller to read and reset per step;
# ShareKVHead's own under "kv_all_gather" and "kv_all_reduce"
traffic = collections.Counter()


def all_gather_dim(t: torch.Tensor, dim: int, group, kind: str = "all_gather") -> torch.Tensor:
    """The pieces of `t` from every rank of `group`, concatenated along `dim` in rank
    order (`t` itself where group is None); its bytes counted under traffic[kind]."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    traffic[kind] += out.numel() * out.element_size()
    return out.movedim(0, dim).contiguous()


def all_reduce(t: torch.Tensor, group, op=None, kind: str = "all_reduce") -> torch.Tensor:
    """`t` summed (or reduced by `op`) over `group`, in place; `t` where group is None;
    its bytes counted under traffic[kind]."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
        traffic[kind] += t.numel() * t.element_size()
    return t


def split_dims(spec, mesh: Mesh) -> List[Tuple[int, str]]:
    """(dimension, axis) of each dimension of a leaf split over more than one rank; a
    dimension is split on one axis at most (as every rule splits it)."""
    out = []
    for dim, entry in enumerate(spec):
        axes = [a for a in _axes(entry) if mesh.shape[a] > 1]
        if len(axes) > 1:
            raise ValueError(f"dimension {dim} of spec {spec} is split on {axes}: one axis a dimension")
        if axes:
            out.append((dim, axes[0]))
    return out


def tensor_dim(spec, mesh: Mesh) -> Optional[int]:
    """The dimension of a leaf split on the tensor axis, None if none is (or `spec` is a
    LoRA leaf's spec dict)."""
    if not isinstance(spec, tuple):
        return None
    return next((d for d, a in split_dims(spec, mesh) if a == "tensor"), None)


class GatherShard(torch.autograd.Function):
    """All-gather of a leaf's pieces along one dimension for the forward (joined into
    the full layout); the backward keeps this rank's piece of the (group-identical)
    full gradient."""

    @staticmethod
    def forward(ctx, shard, dim, group, index, groups):
        n = dist.get_world_size(group)
        ctx.dim, ctx.index, ctx.n, ctx.groups = dim, index, n, groups
        return join_pieces(all_gather_dim(shard, dim, group), dim, n, groups)

    @staticmethod
    def backward(ctx, grad):
        return take_piece(grad, ctx.dim, ctx.n, ctx.index, ctx.groups).contiguous(), None, None, None, None


def gather_leaf(t: torch.Tensor, spec, mesh: Mesh, axis: str = "fsdp") -> torch.Tensor:
    """`t` with its dimension split on `axis` gathered (differentiable where `t`
    requires grad); the other dimensions stay this rank's piece."""
    for dim, a in split_dims(spec, mesh):
        if a == axis:
            _, index = split(spec[dim], mesh)
            t = GatherShard.apply(t, dim, mesh.group(axis), index, groups_of(spec, dim))
    return t


def gather_for_compute(tree, specs, mesh: Mesh):
    """The parameter tree the forward reads: the fsdp-split leaves gathered (through
    GatherShard, so their gradients come back as slices), a tensor-split dimension
    left this rank's piece, the others as they are."""
    return map_with_spec(lambda t, s: gather_leaf(t, s, mesh), tree, specs)


class _Copy(torch.autograd.Function):
    """Megatron's f: the identity forward, an all-reduce of the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _Reduce(torch.autograd.Function):
    """Megatron's g: an all-reduce over the group forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class SliceLocal(torch.autograd.Function):
    """This rank's piece of a replicated leaf along `dim` (a bias in front of a
    column-split matrix); the backward all-gathers every rank's gradient piece, so
    the leaf's gradient is whole and the same on every rank of the group."""

    @staticmethod
    def forward(ctx, x, dim, group, index, groups):
        n = dist.get_world_size(group)
        ctx.dim, ctx.group, ctx.n, ctx.groups = dim, group, n, groups
        return take_piece(x, dim, n, index, groups).contiguous()

    @staticmethod
    def backward(ctx, grad):
        full = join_pieces(all_gather_dim(grad.contiguous(), ctx.dim, ctx.group), ctx.dim, ctx.n, ctx.groups)
        return full, None, None, None, None


class ShareKVHead(torch.autograd.Function):
    """A KV head shared by the r tensor ranks of `group`, each of which stores the
    r-th piece of it along `dim` (its JAX-layout piece of wk, wv, bk or bv). Forward:
    the pieces all-gathered into the whole head, in rank order. Backward: each rank's
    gradient of the whole head comes from its own query heads only, so the head's
    gradient is their sum over the group; the rank keeps its piece of that sum (a
    reduce-scatter, run as an all-reduce of the whole head's gradient, which every
    backend here runs on CPU and CUDA tensors alike). Nothing is counted twice: no
    query head lies on two ranks."""

    @staticmethod
    def forward(ctx, piece, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.n, ctx.index = dist.get_world_size(group), dist.get_rank(group)
        return all_gather_dim(piece, dim, group, "kv_all_gather")

    @staticmethod
    def backward(ctx, grad):
        whole = all_reduce(grad.contiguous().clone(), ctx.group, kind="kv_all_reduce")
        return take_piece(whole, ctx.dim, ctx.n, ctx.index).contiguous(), None, None


def f(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f over `group` (the identity where group is None)."""
    return x if group is None else _Copy.apply(x, group)


def g(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g over `group` (the identity where group is None)."""
    return x if group is None else _Reduce.apply(x, group)


class TensorParallel:
    """The forward's view of the tensor axis (see the module docstring): the mesh's
    tensor group, and the specs of the subtree the forward is in. `at(*keys)` steps
    into a subtree; `block(p, cols, rows)` says whether a block runs on this rank's
    heads and columns and gives the leaves it computes with. `blocks` records each
    block's path and whether it ran split, shared by every view of one forward."""

    def __init__(self, mesh: Mesh, specs, path: str = "", blocks: Optional[list] = None):
        self.mesh, self.specs, self.path = mesh, specs, path
        self.group = mesh.group("tensor")
        self.size, self.index = mesh.shape["tensor"], mesh.coordinate["tensor"]
        self.blocks = [] if blocks is None else blocks

    def at(self, *keys) -> "TensorParallel":
        specs, path = self.specs, self.path
        for k in keys:
            specs, path = specs[k], f"{path}/{k}" if path else str(k)
        return TensorParallel(self.mesh, specs, path, self.blocks)

    def f(self, x: torch.Tensor) -> torch.Tensor:
        return f(x, self.group)

    def g(self, x: torch.Tensor) -> torch.Tensor:
        return g(x, self.group)

    def share_kv_head(self, p: dict, kv_heads: int) -> dict:
        """A split attention block's leaves with this rank's KV head whole: where the
        tensor axis exceeds `kv_heads`, the pieces of wk, wv, bk and bv joined over the rank's
        KV-replica group of r = size / kv_heads ranks (ShareKVHead); `p` itself where
        each rank holds whole KV heads (r = 1)."""
        r = self.size // kv_heads if self.size > kv_heads else 1
        if r == 1:
            return p
        group = self.mesh.kv_group(r)
        out = dict(p)
        for n in ("wk", "wv", "bk", "bv"):
            if n in p:
                out[n] = ShareKVHead.apply(p[n], tensor_dim(self.specs[n], self.mesh), group)
        return out

    def block(self, p: dict, cols: Sequence[str], rows: Sequence[str], col_biases: Sequence[str] = ()):
        """(leaves, split) of a block whose column-split matrices are among `cols` and
        row-split ones among `rows` (names the block lacks are skipped). split: every
        one of them is tensor-split here, and the block runs on this rank's pieces, the
        replicated `col_biases` sliced to its columns (SliceLocal). Else the block runs
        whole: its tensor-split leaves are gathered over tensor (GatherShard)."""
        names = [n for n in tuple(cols) + tuple(rows) if n in p]
        if not names:
            raise ValueError(f"{self.path}: none of {tuple(cols) + tuple(rows)} in the block")
        split_ = all(tensor_dim(self.specs[n], self.mesh) is not None for n in names)
        out = dict(p)
        if split_:
            for n in col_biases:
                if n in p and tensor_dim(self.specs[n], self.mesh) is None:
                    out[n] = SliceLocal.apply(p[n], p[n].dim() - 1, self.group, self.index, 1)
        else:
            out = map_with_spec(lambda t, s: gather_leaf(t, s, self.mesh, "tensor"), p, self.specs)
        self.blocks.append((self.path, split_))
        return out, split_


def tensor_parallel(mesh: Optional[Mesh], specs) -> Optional[TensorParallel]:
    """The TensorParallel view of `mesh` over a tree with spec tree `specs`; None
    without a mesh or where its tensor axis is 1 (the forward is then the one-device
    forward, bit for bit)."""
    if mesh is None or mesh.shape["tensor"] == 1:
        return None
    return TensorParallel(mesh, specs)


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
    split_leaves, whole = [], []
    for grad, s in zip(grads, specs):
        (split_leaves if split_dims(s, mesh) else whole).append(grad)
    if mesh.shape["data"] > 1 and split_leaves:
        _flat_all_reduce(split_leaves, mesh.group("data"))
    if whole:
        if mesh.shape["fsdp"] > 1 or mesh.shape["tensor"] > 1:
            if mesh.coordinate["fsdp"] != 0 or mesh.coordinate["tensor"] != 0:
                for grad in whole:
                    grad.zero_()
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
