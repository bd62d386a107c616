"""Process meshes and their collectives (counterpart of
``windtpu/core/mesh.py``).

The PyTorch idiom is one process per device, so a device of a JAX mesh is
a rank here.  A :class:`Mesh` names its axes as the JAX one does:

* ``data``     — data parallelism over the batch axis (gradients are
  all-reduced by the train step, ``train/wgan_gp.py``), or tile
  parallelism at inference (patch groups split over ranks);
* ``ensemble`` — ensemble members split over ranks at inference.

Ranks fill the mesh in row-major order over the axes as given, as JAX
reshapes its device list, so that the ranks sharing every coordinate but
one form that axis's process group.  A rank beyond the mesh's size (JAX
leaves those devices out of the mesh) holds no coordinate.

Only ``all_reduce`` and ``broadcast`` (and ``barrier``) are used, so every
path runs under gloo on CPU tensors and under gloo on CUDA tensors as it
does under NCCL; an all-gather becomes an all-reduce into a zero-filled
tensor.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def mesh_axes(axis_shapes: Optional[Mapping[str, int]],
              n_ranks: int) -> Dict[str, int]:
    """The JAX package's ``make_mesh`` rules on ``n_ranks`` ranks: the
    default is one ``data`` axis over all of them, one size may be -1 (the
    ranks left over), and a mesh needing more ranks than exist raises."""
    if axis_shapes is None:
        axis_shapes = {"data": n_ranks}
    names = list(axis_shapes)
    sizes = list(axis_shapes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n_ranks // known
    need = math.prod(sizes)
    if need > n_ranks:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {need} devices, "
            f"only {n_ranks} available")
    return dict(zip(names, sizes))


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over the ranks of the process group.

    ``coords`` is this rank's coordinate on each axis (None off the mesh);
    ``groups`` maps each axis to the process group of the ranks that share
    this rank's other coordinates, or None where the axis has one rank and
    needs no collective.  An axis over every rank holds the world's group;
    so in a process group of one rank every axis does, and a one-rank run
    goes through the backend's collectives as a larger run does."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    coords: Optional[Tuple[int, ...]]
    groups: Mapping[str, Optional[object]]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def axis_size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``; 0 for an axis the mesh does
        not have."""
        if axis not in self.axis_names:
            return 0
        if self.coords is None:
            raise ValueError("this rank lies outside the mesh")
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups.get(axis)


# The meshes made over the current process group (_WORLD), by their axes;
# emptied when the group changes.
_MESHES: Dict[tuple, Mesh] = {}
_WORLD = None


def make_mesh(axis_shapes: Optional[Mapping[str, int]] = None) -> Mesh:
    """The mesh over the ranks of the process group (one rank without
    one).  Default: all ranks on a single ``data`` axis.  Every rank must
    call it with the same axes: it creates each axis's process groups, and
    ``torch.distributed.new_group`` needs every rank, in the same order.
    An axis over every rank takes the world's group; the others' groups
    are made once per process group, and a mesh of the same axes is the
    one made before."""
    global _WORLD
    rank, n_ranks = world()
    axes = mesh_axes(axis_shapes, n_ranks)
    names, sizes = tuple(axes), tuple(axes.values())
    initialized = dist.is_available() and dist.is_initialized()
    pg = dist.group.WORLD if initialized else None
    if _WORLD is not pg:
        _MESHES.clear()
        _WORLD = pg
    key = tuple(axes.items())
    if key in _MESHES:
        return _MESHES[key]
    need = math.prod(sizes)
    grid = [tuple(c) for c in itertools.product(*map(range, sizes))]
    coords = grid[rank] if rank < need else None
    groups: Dict[str, Optional[object]] = {name: None for name in names}
    if initialized:
        for a, name in enumerate(names):
            if sizes[a] == n_ranks:
                groups[name] = dist.group.WORLD
                continue
            if sizes[a] == 1:
                continue
            others = [range(s) for i, s in enumerate(sizes) if i != a]
            for rest in itertools.product(*others):
                members = [grid.index(rest[:a] + (i,) + rest[a:])
                           for i in range(sizes[a])]
                g = dist.new_group(members)
                if rank in members:
                    groups[name] = g
    mesh = _MESHES[key] = Mesh(names, sizes, coords, groups)
    return mesh


def collective_device() -> torch.device:
    """Where small collective buffers live: the current card under NCCL,
    which takes only CUDA tensors, the CPU otherwise."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` in place over ``group``; a no-op for ``group=None``.
    Counts the bytes it reduces in ``all_reduce.bytes``."""
    if group is not None:
        all_reduce.bytes += x.numel() * x.element_size()
        dist.all_reduce(x, group=group)
    return x


all_reduce.bytes = 0


class _PSum(torch.autograd.Function):
    """All-reduce sum whose gradient is the all-reduce sum of the output
    gradients: the local input feeds every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (``jax.lax.psum``); ``x``
    itself for ``group=None``."""
    return x if group is None else _PSum.apply(x, group)


def pmean(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean of each tensor over ``group`` (``jax.lax.pmean``), in one
    f32 all-reduce of the tensors laid end to end; new tensors, or the
    same ones for ``group=None``.  Not differentiable."""
    tensors = list(tensors)
    if group is None:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    all_reduce(flat, group).div_(dist.get_world_size(group))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def shard_batch(mesh: Mesh, tree, axis: str = "data"):
    """This rank's contiguous rows of a global batch (a tensor or array, or
    a tuple of them): rank ``i`` of the ``axis`` group takes rows ``[i *
    B/n, (i + 1) * B/n)``, as JAX lays a batch over a ``data`` axis."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    if isinstance(tree, tuple):
        return tuple(shard_batch(mesh, a, axis) for a in tree)
    if tree.shape[0] % n:
        raise ValueError(f"global batch {tree.shape[0]} not divisible by "
                         f"the {n} ranks of the {axis!r} axis")
    per = tree.shape[0] // n
    return tree[i * per:(i + 1) * per]
