"""Device mesh construction + sharding rules for the data/fsdp/tensor axes (port of
parallel/mesh.py).

The JAX package puts every device of a slice in one `jax.sharding.Mesh` and lets XLA
insert the collectives. Here a mesh is a layout of the world's ranks, one device each,
on the same three axes, with one torch.distributed process group per axis
(`torch.distributed.device_mesh.init_device_mesh`):

- ``data``   — batch (DP; reference torchrun --nproc_per_node, train_grpo.sh:33-38)
- ``fsdp``   — parameter/optimizer sharding (ZeRO-3): each rank keeps a slice of every
               leaf the rules shard; the training step gathers them for the forward
               (parallel/collectives.py)
- ``tensor`` — megatron-style intra-layer sharding: each rank holds its own heads and
               its own slice of the MLP widths (column-split q/k/v, gate, up; row-split
               o, down), and the forward all-reduces twice a layer
               (parallel/collectives.py::TensorParallel). Where the tensor axis is
               larger than the decoder's key/value head count, each KV head is read by
               a run of r = tensor / Hkv ranks, which hold a piece of it each and join
               it in the forward over their KV-replica group (`Mesh.kv_group`)

A spec is the port's counterpart of a `PartitionSpec`: a tuple with one entry per
leading dimension, each an axis name, a tuple of axis names, or None (not split);
`()` is replicated. Ranks lie on the mesh in row-major order, rank = (d * fsdp + f) *
tensor + t, the layout `init_device_mesh` gives.

A rank's piece of a leaf is the JAX package's shard of it, except for the ViT's fused
q|k|v (`vision/blocks/*/attn/wqkv` and `bqkv`, spec `QKVSpec`): its columns are
[3][H][D], and a contiguous piece of them is not a set of heads (at 3B with tensor 2
it is all of q and half of k). Its tensor piece is this rank's heads of q, k and v
together. `take_piece` / `join_pieces` are the one pair of functions that go between
the two layouts; every full tree (checkpoints, the HF export, a rollout's gathered
tree, the optimizer's state_dict) stays in the JAX layout.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("data", "fsdp", "tensor")


class Mesh:
    """A (data, fsdp, tensor) layout of `size` ranks. With a `device_mesh` (this
    process joined the world and the mesh spans it) `group(axis)` is that axis's
    process group; without one the mesh is a layout only (the sharding rules read it,
    and a collective over an axis larger than 1 raises)."""

    def __init__(self, data: int, fsdp: int, tensor: int, *, rank: int = 0, device_mesh=None):
        self.shape: Dict[str, int] = {"data": int(data), "fsdp": int(fsdp), "tensor": int(tensor)}
        self.size = int(data) * int(fsdp) * int(tensor)
        self.rank = int(rank)
        self.device_mesh = device_mesh
        t = self.rank % tensor
        f = (self.rank // tensor) % fsdp
        d = self.rank // (tensor * fsdp)
        self.coordinate: Dict[str, int] = {"data": d, "fsdp": f, "tensor": t}
        self._kv_groups: Dict[int, object] = {}
        if device_mesh is not None:
            coord = tuple(device_mesh.get_coordinate())
            if coord != (d, f, t):
                raise RuntimeError(f"rank {rank}: the device mesh puts it at {coord}, the layout at {(d, f, t)}")
            self._kv_groups = _kv_replica_groups(self.shape, self.rank)

    def group(self, axis: str):
        """The process group of this rank's `axis`, None where that axis has size 1
        (a collective over it is the identity)."""
        if self.shape[axis] == 1:
            return None
        if self.device_mesh is None:
            raise RuntimeError(f"a collective over the {axis} axis of a mesh this process did not join "
                               f"({self.shape})")
        return self.device_mesh.get_group(axis)

    def kv_group(self, r: int):
        """The KV-replica group of this rank: the run of `r` tensor ranks, starting at a
        multiple of r, that read one shared KV head (None where r is 1, the tensor
        group where r is the whole axis)."""
        if r == 1:
            return None
        if r == self.shape["tensor"]:
            return self.group("tensor")
        if r not in self._kv_groups:
            raise RuntimeError(f"no KV-replica group of {r} ranks on {self}: r must divide the tensor axis, "
                               f"and the mesh must be joined")
        return self._kv_groups[r]

    def world_group(self):
        """The group of every rank of the mesh (None for a mesh of one rank)."""
        if self.size == 1:
            return None
        if self.device_mesh is None:
            raise RuntimeError(f"a collective over a mesh this process did not join ({self.shape})")
        import torch.distributed as dist

        return dist.group.WORLD

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _kv_replica_groups(shape: Dict[str, int], rank: int) -> Dict[int, object]:
    """r -> this rank's group of r consecutive tensor ranks, for every r with
    1 < r < tensor that divides tensor. dist.new_group is collective over the world:
    every rank creates every group, in the same order, when the mesh is built (never
    lazily inside a forward, where ranks could reach it in different orders)."""
    import torch.distributed as dist

    t, out = shape["tensor"], {}
    for r in range(2, t):
        if t % r:
            continue
        for base in range(0, shape["data"] * shape["fsdp"] * t, r):  # runs never straddle a tensor group
            ranks = list(range(base, base + r))
            group = dist.new_group(ranks)
            if rank in ranks:
                out[r] = group
    return out


def make_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1, world_size: Optional[int] = None) -> Mesh:
    """Build a (data, fsdp, tensor) mesh over the world's ranks. data=-1 absorbs the
    remaining ranks. With torch.distributed initialized the mesh spans its world and
    gets its process groups; `world_size` instead gives a layout of that many ranks
    that this process does not join (the sharding rules of a mesh it will not run)."""
    import torch.distributed as dist

    joined = world_size is None and dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if joined else (1 if world_size is None else int(world_size))
    if data == -1:
        if n % (fsdp * tensor) != 0:
            raise ValueError(f"{n} ranks not divisible by fsdp*tensor={fsdp * tensor}")
        data = n // (fsdp * tensor)
    if data * fsdp * tensor != n:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor} != {n} ranks")
    if not joined:
        return Mesh(data, fsdp, tensor)
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh's groups only carry tensors; its device type picks nothing: NCCL's
    # tensors live on the card, gloo's may live on either side
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (data, fsdp, tensor), mesh_dim_names=AXES)
    return Mesh(data, fsdp, tensor, rank=dist.get_rank(), device_mesh=dm)


# ---------------------------------------------------------------------------
# Param sharding rules (path-regex -> spec)
# ---------------------------------------------------------------------------

Spec = Tuple


class QKVSpec(tuple):
    """The spec of a fused [3][H][D] q|k|v dimension: its tensor piece is this rank's
    heads of each of the `groups` parts (see the module docstring). Equal to the plain
    tuple, which is the JAX package's spec."""

    groups = 3


def groups_of(spec, dim: int) -> int:
    """How many parts a piece of `dim` takes its share of: a QKVSpec's tensor dimension
    has 3 (q, k and v), every other dimension 1."""
    if dim < len(spec) and "tensor" in _axes(spec[dim]):
        return getattr(spec, "groups", 1)
    return 1


def take_piece(x, dim: int, pieces: int, index: int, groups: int = 1):
    """Piece `index` of `pieces` along `dim` (a view): contiguous, or with groups > 1
    the same piece of each of the dimension's `groups` equal parts, side by side. A
    tensor or a numpy array."""
    n = x.shape[dim]
    if n % (pieces * groups):
        raise ValueError(f"dimension {dim} of a {tuple(x.shape)} value does not split {pieces} ways"
                         + (f" in each of its {groups} parts" if groups > 1 else ""))
    m = n // groups // pieces
    if groups == 1:
        return x[(slice(None),) * dim + (slice(index * m, (index + 1) * m),)]
    parts = x.reshape(tuple(x.shape[:dim]) + (groups, n // groups) + tuple(x.shape[dim + 1:]))
    piece = parts[(slice(None),) * (dim + 1) + (slice(index * m, (index + 1) * m),)]
    return piece.reshape(tuple(x.shape[:dim]) + (groups * m,) + tuple(x.shape[dim + 1:]))


def join_pieces(x, dim: int, pieces: int, groups: int = 1):
    """take_piece's inverse: `x` holds every piece along `dim` in index order (an
    all-gather's output); returns the full value."""
    if groups == 1:
        return x
    n = x.shape[dim]
    parts = x.reshape(tuple(x.shape[:dim]) + (pieces, groups, n // pieces // groups) + tuple(x.shape[dim + 1:]))
    return parts.swapaxes(dim, dim + 1).reshape(x.shape)

# Megatron-style layout: column-parallel (out dim on tensor) for qkv/gate/up,
# row-parallel (in dim on tensor) for o/down; the other matmul dim shards on fsdp
# (ZeRO-3 style). Norm scales and small biases stay replicated on fsdp but biases of
# column-parallel layers follow their matrix's tensor split. The JAX package's rules,
# regex for regex.
DEFAULT_RULES: Tuple[Tuple[str, Spec], ...] = (
    # text decoder
    (r"text/layers/\d+/attn/w[qkv]$", ("fsdp", "tensor")),
    (r"text/layers/\d+/attn/b[qkv]$", ("tensor",)),
    (r"text/layers/\d+/attn/wo$", ("tensor", "fsdp")),
    (r"text/layers/\d+/mlp/w[gu]$", ("fsdp", "tensor")),
    (r"text/layers/\d+/mlp/wd$", ("tensor", "fsdp")),
    (r"text/(embed|lm_head)/weight$", ("fsdp", None)),
    # vision tower
    (r"vision/blocks/\d+/attn/wqkv$", QKVSpec(("fsdp", "tensor"))),
    (r"vision/blocks/\d+/attn/bqkv$", QKVSpec(("tensor",))),
    (r"vision/blocks/\d+/attn/wo$", ("tensor", "fsdp")),
    (r"vision/blocks/\d+/mlp/w[gu]$", ("fsdp", "tensor")),
    (r"vision/blocks/\d+/mlp/wd$", ("tensor", "fsdp")),
    (r"vision/merger/w0$", ("fsdp", "tensor")),
    (r"vision/merger/w1$", ("tensor", "fsdp")),
    (r"vision/patch_embed/kernel$", (None, "fsdp")),
    # everything else (norm scales, small biases): replicated
    (r".*", ()),
)


def map_with_path(fn, tree, path: str = ""):
    """fn(path, leaf) over a parameter tree (dicts and lists; a LoRA leaf's dict is
    walked into), paths in the JAX tree's "a/b/0/c" form."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def map_with_spec(fn, tree, specs):
    """fn(leaf, spec) over a parameter tree and its spec tree (param_shardings'
    output): the walk follows the parameter tree, so a spec's own tuple is never
    taken for a branch."""
    if isinstance(tree, dict):
        return {k: map_with_spec(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_spec(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def spec_leaves(tree, specs) -> list:
    """The specs of a tree's leaves, in tree_leaves order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v, sp in zip(tree, specs) for s in spec_leaves(v, sp)]
    return [specs]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec_fits(spec: Spec, shape, mesh: Mesh) -> bool:
    """A spec only applies if every sharded dim divides evenly by its axis size."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        size = int(np.prod([mesh.shape[a] for a in axes]))
        if dim >= len(shape) or shape[dim] % size != 0:
            return False
    return True


def param_shardings(params, mesh: Mesh, rules: Sequence[Tuple[str, Spec]] = DEFAULT_RULES):
    """Param tree -> matching spec tree (first rule whose regex matches the path AND
    whose spec divides the shape; falls back to replicated). Leaves need only a
    `shape` (tensors, numpy arrays, jax.ShapeDtypeStruct)."""

    def assign(path, leaf):
        for pattern, spec in rules:
            if re.search(pattern, path) and _spec_fits(spec, tuple(leaf.shape), mesh):
                return spec
        return ()

    return map_with_path(assign, params)


def split(entry, mesh: Mesh) -> Tuple[int, int]:
    """(pieces, this rank's piece) of a dimension whose spec entry is `entry`: the
    axes' sizes multiplied, this rank's coordinates on them in row-major order."""
    pieces, index = 1, 0
    for a in _axes(entry):
        pieces *= mesh.shape[a]
        index = index * mesh.shape[a] + mesh.coordinate[a]
    return pieces, index


def is_sharded(spec: Spec, mesh: Mesh) -> bool:
    return any(split(entry, mesh)[0] > 1 for entry in spec)


def split_axes(spec: Spec, mesh: Mesh) -> Tuple[str, ...]:
    """The axes of the mesh (of size > 1) that split a leaf under `spec`."""
    return tuple(a for entry in spec for a in _axes(entry) if mesh.shape[a] > 1)


def local_slice(x, spec: Spec, mesh: Mesh):
    """This rank's piece of a full value under `spec` (a tensor or a numpy array; the
    value itself where nothing is split), through take_piece. A tensor's piece is a
    copy, so the full tensor can be freed."""
    if not is_sharded(spec, mesh):
        return x
    out = x
    for dim, entry in enumerate(spec):
        pieces, i = split(entry, mesh)
        if pieces > 1:
            out = take_piece(out, dim, pieces, i, groups_of(spec, dim))
    return out.clone() if isinstance(out, torch.Tensor) else np.ascontiguousarray(out)


def check_tensor_heads(cfg, tensor: int) -> None:
    """Refuse, on the host, a tensor axis the model's heads cannot split on, naming the
    counts. The axis must divide the decoder's query heads and the ViT's heads (each
    rank computes whole query heads of its own); the decoder's key/value heads must
    divide by it or divide it (where they are fewer, the tensor / Hkv ranks that read
    one KV head share it: parallel.collectives.ShareKVHead). A width that does not
    split is no refusal: param_shardings leaves that leaf whole, as the JAX rules do
    (at 3B and tensor 8 the ViT's MLP, width 3420), and its block runs whole on every
    rank (TensorParallel.block)."""
    t = int(tensor)
    if t <= 1:
        return
    H, Hkv, Hv = cfg.text.num_attention_heads, cfg.text.num_key_value_heads, cfg.vision.num_heads
    if H % t or Hv % t or (Hkv % t and t % Hkv):
        raise ValueError(f"a tensor axis of {t} does not divide the head counts (decoder num_attention_heads {H}, "
                         f"decoder num_key_value_heads {Hkv}, ViT num_heads {Hv}): each rank computes whole query "
                         f"heads, and key/value heads must divide by {t} or divide it")


def shard_params(params, mesh: Mesh, rules: Sequence[Tuple[str, Spec]] = DEFAULT_RULES):
    """Each rank's slices of a full parameter tree per the rules (a replicated leaf
    stays the same tensor)."""
    specs = param_shardings(params, mesh, rules)
    return map_with_spec(lambda t, s: local_slice(t, s, mesh), params, specs)


def data_sharding(mesh: Mesh, *leading_batch_axes: int) -> Spec:
    """Spec for batch arrays: dim 0 on 'data', rest replicated."""
    return ("data",)
