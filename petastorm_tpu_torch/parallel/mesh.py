"""Device meshes, batch shardings and DTensor delivery over ``torch.distributed``.

Port of ``petastorm_tpu.parallel.mesh``. The JAX package lays every device of a pod
slice into one ``jax.sharding.Mesh`` and hands batches out as global ``jax.Array``
values laid out per a ``NamedSharding``. The port keeps those names and that arithmetic
on torch's own idioms:

- **A mesh is a** ``torch.distributed.device_mesh.DeviceMesh`` **over ranks, one card a
  rank.** This is torch's layout under ``torchrun``: a process that feeds several cards
  runs one rank a card (``torchrun --nproc-per-node=<cards>``). On the card rank r's
  device is the one ``init_device_mesh`` selects (``cuda:<local rank>``); a ``"cpu"``
  mesh over gloo runs the same code on host ranks (the tests' way).
- **A sharding is** :class:`NamedSharding` ``(mesh, PartitionSpec(...))``, one entry a
  tensor dimension: a mesh-axis name, a tuple of names, or ``None``, as in JAX. Its
  :meth:`~NamedSharding.placements` are the DTensor counterpart: ``Shard(d)`` on each
  mesh dimension that ``spec[d]`` names, ``Replicate()`` on the rest.
- **Delivery** (:func:`to_dtensor`) wraps the rank's local tensor as
  ``DTensor.from_local(local, mesh, placements, run_check=False, shape=..., stride=...)``,
  the counterpart of ``jax.make_array_from_process_local_data``: the global shape is the
  one that function infers, the local data being the rank's slice along every sharded
  dimension (a dimension sharded over mesh axes of total size k is k times the local
  one). No collective runs. The loader first cuts whole rows to the rank's part along
  each sharded non-batch dimension (:func:`rank_part`), where the JAX package would
  infer that dimension k times longer.
"""
from __future__ import annotations

import math
import os

import numpy as np

#: Canonical mesh-axis vocabulary (the JAX package's): dp = data (batch), pp = pipeline
#: stages, ep = expert, sp = sequence/context, tp = tensor (model).
AXIS_ORDER = ("dp", "pp", "ep", "sp", "tp")

_ONE_CARD_A_RANK = (
    "a torch DeviceMesh holds one device a rank, so a process that feeds several cards "
    "runs one rank a card (torchrun --nproc-per-node=<cards>)")


def mesh_layout(axis_sizes, n):
    """``(shape, axis names)`` that :func:`make_mesh` lays ``n`` positions out in: the
    JAX ``make_mesh``'s arithmetic and errors, with no process group. Unlisted
    positions fold into ``dp``; at most one size may be -1 (inferred)."""
    axis_sizes = dict(axis_sizes or {})
    for ax in axis_sizes:
        if ax not in AXIS_ORDER:
            raise ValueError("Unknown mesh axis %r (expected one of %s)" % (ax, AXIS_ORDER))
    known = [s for s in axis_sizes.values() if s != -1]
    n_unknown = sum(1 for s in axis_sizes.values() if s == -1)
    if n_unknown > 1:
        raise ValueError("At most one axis size may be -1")
    prod = math.prod(known) if known else 1
    if n_unknown:
        if n % prod:
            raise ValueError("Cannot infer -1 axis: %d devices not divisible by %d" % (n, prod))
        inferred = n // prod
        axis_sizes = {k: (inferred if v == -1 else v) for k, v in axis_sizes.items()}
        prod = n
    if "dp" not in axis_sizes:
        if n % prod:
            raise ValueError("Axis sizes %r do not divide device count %d" % (axis_sizes, n))
        axis_sizes["dp"] = n // prod
    sizes = [(ax, axis_sizes[ax]) for ax in AXIS_ORDER if ax in axis_sizes]
    total = math.prod(s for _, s in sizes)
    if total != n:
        raise ValueError("Mesh %r needs %d devices, have %d" % (dict(sizes), total, n))
    return tuple(s for _, s in sizes), tuple(ax for ax, _ in sizes)


def process_group():
    """``(rank, world size)`` of an initialised ``torch.distributed`` group, else
    ``(0, 1)``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(axis_sizes=None, devices=None, device_type="cuda"):
    """A ``DeviceMesh`` from ``{axis: size}`` over the job's ranks, axes in
    :data:`AXIS_ORDER` (``tp`` innermost); unlisted ranks fold into ``dp``.

    ``devices=None``: every rank of the default process group (``WORLD_SIZE`` when none
    is initialised yet; ``init_device_mesh`` then initialises it from the environment,
    as under ``torchrun``). ``devices`` may instead list the mesh's ranks, in mesh order,
    each once; an entry that is a ``torch.device`` (or a device string) is this process's
    own position. Two positions in one process raise ``ValueError``: one card a rank.
    ``device_type`` is ``"cuda"`` unless the caller asks for ``"cpu"`` (a mesh of host
    ranks over gloo); a ``torch.device`` entry gives its own type."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if devices is None:
        n = dist.get_world_size() if dist.is_initialized() \
            else int(os.environ.get("WORLD_SIZE", "1"))
        shape, names = mesh_layout(axis_sizes, n)
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    ranks = []
    own = 0
    for d in devices:
        if isinstance(d, (torch.device, str)):
            own += 1
            device_type = torch.device(d).type
            ranks.append(process_group()[0])
        else:
            ranks.append(int(d))
    if own > 1 or len(set(ranks)) != len(ranks):
        raise ValueError("make_mesh(devices=%r) puts two mesh positions in one process: %s"
                         % (list(devices), _ONE_CARD_A_RANK))
    shape, names = mesh_layout(axis_sizes, len(ranks))
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape), mesh_dim_names=names)


def mesh_device(mesh):
    """This rank's device in ``mesh``: the CPU for a ``"cpu"`` mesh, else the current
    device of the mesh's type (the one ``init_device_mesh`` selected)."""
    import torch

    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, getattr(torch, mesh.device_type).current_device())


def _axes(part):
    """The mesh-axis names of one ``PartitionSpec`` entry."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


class PartitionSpec(tuple):
    """One entry a tensor dimension: a mesh-axis name, a tuple of names (the dimension
    split over those axes, major first) or ``None`` (not split). Trailing dimensions
    past the spec are not split. JAX's ``PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


class NamedSharding:
    """A tensor laid out over ``mesh`` per ``spec`` (JAX's ``NamedSharding``)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec):
        if not isinstance(spec, PartitionSpec):
            spec = PartitionSpec(*spec)
        names = tuple(mesh.mesh_dim_names or ())
        seen = []
        for part in spec:
            for ax in _axes(part):
                if ax not in names:
                    raise ValueError("PartitionSpec %r names axis %r, not an axis of the "
                                     "mesh %r" % (spec, ax, names))
                if ax in seen:
                    raise ValueError("PartitionSpec %r uses mesh axis %r twice" % (spec, ax))
                seen.append(ax)
            order = [names.index(ax) for ax in _axes(part)]
            if order != sorted(order):
                # DTensor splits a dimension over its mesh dimensions in mesh order
                raise ValueError(
                    "PartitionSpec %r splits one dimension over %r out of the mesh's axis "
                    "order %r: a DTensor cannot lay that out" % (spec, part, names))
        self.mesh = mesh
        self.spec = spec

    def __repr__(self):
        return "NamedSharding(mesh=%r, spec=%r)" % (
            tuple(self.mesh.mesh_dim_names or ()), self.spec)

    @property
    def device(self):
        """This rank's device (:func:`mesh_device`)."""
        return mesh_device(self.mesh)

    def placements(self):
        """The DTensor placements: ``Shard(d)`` on each mesh dimension that
        ``spec[d]`` names, ``Replicate()`` on the rest."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, part in enumerate(self.spec) if name in _axes(part)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def global_shape(self, local_shape):
        """The global shape of a rank's ``local_shape`` slice: each dimension times the
        sizes of the mesh axes that split it (``make_array_from_process_local_data``'s
        inference with one position a rank)."""
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape))
        shape = list(local_shape)
        for d, part in enumerate(self.spec[:len(shape)]):
            for ax in _axes(part):
                shape[d] *= int(sizes[ax])
        return tuple(shape)


def axis_coordinate(mesh, axes):
    """``(index, count)`` of this rank along the mesh axes ``axes`` taken together,
    major first (the order a ``PartitionSpec`` entry splits its dimension in)."""
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for ax in axes:
        index = index * int(sizes[ax]) + int(coord[names.index(ax)])
        count *= int(sizes[ax])
    return index, count


def rank_part(local, sharding, declared=None):
    """The rank's part of ``local`` along each sharded non-batch dimension.

    A rank reads whole rows, so a dimension past the batch one that ``sharding`` splits
    over k positions is cut to the rank's k-th (a contiguous copy). The JAX package
    infers such a dimension k times longer instead (ROADMAP.md "By design"). A dimension
    that already is the rank's part of the field's ``declared`` size (its schema shape,
    without the batch dimension) is kept as it is: a feed that sliced its rows itself."""
    for d, part in enumerate(sharding.spec[1:len(local.shape)], start=1):
        axes = _axes(part)
        if not axes:
            continue
        index, k = axis_coordinate(sharding.mesh, axes)
        n = int(local.shape[d])
        full = declared[d - 1] if declared is not None and d - 1 < len(declared) else None
        if k == 1 or (full is not None and full % k == 0 and n == full // k != full):
            continue
        if n % k:
            raise ValueError("dimension %d of size %d does not split over %r (%d ranks)"
                             % (d, n, part, k))
        local = local.narrow(d, index * (n // k), n // k).contiguous()
    return local


def to_local(value):
    """A DTensor's local tensor (the rank's block); anything else as it is."""
    local = getattr(value, "to_local", None)
    return local() if local is not None else value


def to_dtensor(local, sharding):
    """The delivered form of a rank's ``local`` tensor under ``sharding`` (a spec no
    longer than the tensor's rank): a ``DTensor`` of the global shape
    :meth:`NamedSharding.global_shape` infers (contiguous strides), built without a
    collective."""
    import torch
    from torch.distributed.tensor import DTensor

    shape = sharding.global_shape(local.shape)
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(local, sharding.mesh, sharding.placements(), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def batch_sharding(mesh, batch_axes=("dp",), extra_dims=0):
    """:class:`NamedSharding` splitting the leading (batch) dim over ``batch_axes`` (the
    ones the mesh has); trailing dims replicated. What a loader's ``sharding=`` takes
    for data parallelism."""
    names = tuple(mesh.mesh_dim_names or ())
    axes = tuple(a for a in batch_axes if a in names)
    spec = PartitionSpec(axes if len(axes) > 1 else (axes[0] if axes else None),
                         *([None] * extra_dims))
    return NamedSharding(mesh, spec)


def sequence_sharding(mesh, batch_axis="dp", seq_axis="sp"):
    """Sharding for (batch, seq, ...) token batches: batch over ``dp``, sequence over
    ``sp`` (each only where the mesh has it)."""
    names = tuple(mesh.mesh_dim_names or ())
    b = batch_axis if batch_axis in names else None
    s = seq_axis if seq_axis in names else None
    return NamedSharding(mesh, PartitionSpec(b, s))


def batch_axis_shard_count(sharding):
    """How many distinct slices a sharding cuts its batch (leading) axis into; 1 for a
    replicated batch axis or anything but a :class:`NamedSharding`."""
    if isinstance(sharding, NamedSharding):
        spec0 = sharding.spec[0] if len(sharding.spec) else None
        if spec0 is None:
            return 1
        sizes = dict(zip(sharding.mesh.mesh_dim_names, sharding.mesh.mesh.shape))
        return int(np.prod([sizes[a] for a in _axes(spec0)]))
    return 1


def batch_share(global_batch_size, grid_shape, axis_names, owned, batch_axes=("dp",)):
    """Rows a process feeds of a global batch, from the mesh's shape and the positions
    it owns (pure arithmetic, :func:`local_batch_size`'s core): the batch dim splits
    into prod(batch-axis sizes) chunks laid out along those axes, and a process supplies
    the chunk of every batch coordinate one of its positions occupies (other axes
    replicate and do not add to it)."""
    axes = [a for a in batch_axes if a in axis_names]
    sizes = dict(zip(axis_names, grid_shape))
    shards = math.prod(sizes[a] for a in axes) if axes else 1
    if global_batch_size % shards:
        raise ValueError("global batch %d not divisible by %d-way batch sharding"
                         % (global_batch_size, shards))
    axis_idx = [list(axis_names).index(a) for a in axes]
    coords = {tuple(pos[i] for i in axis_idx) for pos in owned}
    return global_batch_size * len(coords) // shards


def batch_shard(sharding):
    """``(cur_shard, shard_count)`` of the reader shard this rank reads under
    ``sharding``: its coordinate along the batch axes, so ranks that share a batch
    coordinate (replicas along the other axes) read the same rows. None for a
    replicated batch axis or anything but a :class:`NamedSharding` (or a dict holding
    one)."""
    if isinstance(sharding, dict):
        sharding = next((s for s in sharding.values() if isinstance(s, NamedSharding)),
                        None)
    if not isinstance(sharding, NamedSharding) or not len(sharding.spec) \
            or sharding.spec[0] is None:
        return None
    return axis_coordinate(sharding.mesh, _axes(sharding.spec[0]))


def local_batch_size(global_batch_size, mesh, batch_axes=("dp",)):
    """Rows this rank must feed for a given global batch: :func:`batch_share` over the
    mesh positions whose rank is ``dist.get_rank()`` (one, on a real ``DeviceMesh``)."""
    grid = np.asarray(mesh.mesh.cpu().numpy() if hasattr(mesh.mesh, "cpu") else mesh.mesh)
    owned = [tuple(int(i) for i in pos) for pos in np.argwhere(grid == process_group()[0])]
    return batch_share(global_batch_size, grid.shape, tuple(mesh.mesh_dim_names), owned,
                       batch_axes)
