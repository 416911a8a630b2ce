"""The port's mesh arithmetic (``petastorm_tpu_torch.parallel.mesh``) against the JAX
package's (``petastorm_tpu.parallel.mesh``), with no process group: ``make_mesh``'s shapes,
axis names and errors over the suite's 8 virtual CPU devices, ``local_batch_size`` on the
fake meshes of ``tests/test_multiprocess_loader.py``, ``batch_axis_shard_count``, the
spec adaptation and the loader's ``_resolve_local_batch`` at one rank. All exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_helpers import _no_leaked_shm_segments  # noqa: E402,F401

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import NamedSharding as RefNamed  # noqa: E402
from jax.sharding import PartitionSpec as RefSpec  # noqa: E402

from petastorm_tpu import loader as ref_loader  # noqa: E402
from petastorm_tpu.parallel import mesh as ref_mesh  # noqa: E402
from petastorm_tpu_torch import loader as port_loader  # noqa: E402
from petastorm_tpu_torch.parallel import mesh as port_mesh  # noqa: E402


class FakeTorchMesh:
    """What the port reads of a ``DeviceMesh``: the rank grid and the axis names."""

    def __init__(self, ranks, names, device_type="cpu"):
        self.mesh = torch.as_tensor(np.asarray(ranks))
        self.mesh_dim_names = tuple(names)
        self.device_type = device_type


def _fake(shape, names):
    return FakeTorchMesh(np.arange(int(np.prod(shape))).reshape(shape), names)


@pytest.mark.parametrize("axis_sizes", [
    None, {"dp": -1}, {"tp": 2}, {"dp": 2, "tp": 4}, {"sp": 2, "dp": -1},
    {"tp": -1, "dp": 2}, {"pp": 2, "ep": 2}, {"dp": 2, "pp": 2, "tp": 2},
    {"xx": 2}, {"dp": -1, "tp": -1}, {"tp": 3}, {"dp": -1, "tp": 3}, {"dp": 2, "tp": 2},
])
def test_mesh_layout_matches_jax_make_mesh(axis_sizes):
    devices = jax.devices()[:8]
    try:
        ref = ref_mesh.make_mesh(axis_sizes, devices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_mesh.mesh_layout(axis_sizes, len(devices))
        assert str(got.value) == str(e)
        return
    shape, names = port_mesh.mesh_layout(axis_sizes, len(devices))
    assert names == tuple(ref.axis_names)
    assert shape == tuple(ref.devices.shape)


@pytest.mark.parametrize("local_ids,batch_axes,batch,want", [
    ({0, 2}, ("dp",), 32, 16),       # two dp rows of one tp column: 2 of 4 shards
    ({0, 1}, ("dp",), 32, 8),        # a whole dp row: still one shard
    ({0, 1}, ("dp", "tp"), 32, 8),   # batch over both axes: 2 of 8 coordinates
    ({0}, ("dp",), 30, None),        # indivisible: raises
])
def test_local_batch_size_matches_jax_on_fake_meshes(local_ids, batch_axes, batch, want):
    class FakeDev:
        def __init__(self, did):
            self.id = did

    class FakeMesh:
        def __init__(self, grid, axis_names, local):
            self.devices = grid
            self.axis_names = axis_names
            self.shape = dict(zip(axis_names, grid.shape))
            self.local_devices = [d for d in grid.flat if d.id in local]

    grid = np.array([FakeDev(i) for i in range(8)]).reshape(4, 2)
    ref = FakeMesh(grid, ("dp", "tp"), local_ids)
    # the port's mesh: one rank a position; this process (rank 0) at the local ones
    ranks = np.array([0 if i in local_ids else 100 + i for i in range(8)]).reshape(4, 2)
    port = FakeTorchMesh(ranks, ("dp", "tp"))
    owned = [tuple(int(x) for x in p) for p in np.argwhere(ranks == 0)]
    if want is None:
        with pytest.raises(ValueError, match="divisible") as e:
            ref_mesh.local_batch_size(batch, ref, batch_axes=batch_axes)
        with pytest.raises(ValueError, match="divisible") as got:
            port_mesh.local_batch_size(batch, port, batch_axes=batch_axes)
        assert str(got.value) == str(e.value)
        return
    assert ref_mesh.local_batch_size(batch, ref, batch_axes=batch_axes) == want
    assert port_mesh.local_batch_size(batch, port, batch_axes=batch_axes) == want
    assert port_mesh.batch_share(batch, (4, 2), ("dp", "tp"), owned, batch_axes) == want


@pytest.mark.parametrize("shape,names,spec", [
    ((8,), ("dp",), ("dp",)), ((4, 2), ("dp", "tp"), ("dp",)),
    ((4, 2), ("dp", "tp"), (("dp", "tp"),)), ((2, 4), ("dp", "sp"), (None, "sp")),
    ((2, 4), ("dp", "sp"), ()), ((2, 2, 2), ("dp", "sp", "tp"), ("dp", "sp")),
])
def test_batch_axis_shard_count_and_matching_sharding_match_jax(shape, names, spec):
    ref = RefNamed(Mesh(np.array(jax.devices()[:8]).reshape(shape), names), RefSpec(*spec))
    port = port_mesh.NamedSharding(_fake(shape, names), spec)
    assert port_mesh.batch_axis_shard_count(port) == ref_mesh.batch_axis_shard_count(ref)
    for ndim in (1, 2, 3):
        arr = np.zeros((8,) * ndim)
        want = ref_loader._matching_sharding(ref, arr).spec
        got = port_loader._matching_sharding(port, arr).spec
        assert tuple(got) == tuple(want)


def test_batch_and_sequence_sharding_match_jax_specs():
    names = ("dp", "sp", "tp")
    ref_m = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), names)
    port_m = _fake((2, 2, 2), names)
    for kw in ({}, {"batch_axes": ("dp", "tp")}, {"extra_dims": 2},
               {"batch_axes": ("ep",)}):
        assert tuple(port_mesh.batch_sharding(port_m, **kw).spec) == \
            tuple(ref_mesh.batch_sharding(ref_m, **kw).spec)
    for kw in ({}, {"seq_axis": "tp"}, {"batch_axis": "ep"}):
        assert tuple(port_mesh.sequence_sharding(port_m, **kw).spec) == \
            tuple(ref_mesh.sequence_sharding(ref_m, **kw).spec)


def test_placements_and_global_shape():
    from torch.distributed.tensor import Replicate, Shard

    m = _fake((2, 2, 2), ("dp", "sp", "tp"))
    s = port_mesh.NamedSharding(m, (("dp", "tp"), "sp"))
    assert s.placements() == (Shard(0), Shard(1), Shard(0))
    assert s.global_shape((4, 8, 3)) == (16, 16, 3)
    s = port_mesh.batch_sharding(m)
    assert s.placements() == (Shard(0), Replicate(), Replicate())
    assert s.global_shape((4, 8)) == (8, 8)


def test_spec_errors():
    m = _fake((2, 4), ("dp", "sp"))
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        port_mesh.NamedSharding(m, ("xx",))
    with pytest.raises(ValueError, match="twice"):
        port_mesh.NamedSharding(m, ("dp", "dp"))
    with pytest.raises(ValueError, match="cannot lay that out"):
        port_mesh.NamedSharding(m, (("sp", "dp"),))
    # the JAX package refuses the unknown axis too
    with pytest.raises(ValueError):
        RefNamed(Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "sp")),
                 RefSpec("xx"))


@pytest.mark.parametrize("devices", [
    [torch.device("cpu"), torch.device("cpu")], [0, 0], ["cuda:0", "cuda:1"],
])
def test_make_mesh_refuses_two_positions_in_one_process(devices):
    with pytest.raises(ValueError, match="two mesh positions in one process"):
        port_mesh.make_mesh(devices=devices)


def test_resolve_local_batch_at_one_rank_is_the_identity():
    m = _fake((8,), ("dp",))
    s = port_mesh.batch_sharding(m)
    ref = RefNamed(Mesh(np.array(jax.devices()[:8]), ("dp",)), RefSpec("dp"))
    for batch in (32, 8):
        for port_s, ref_s in ((s, ref), (None, None), ({"x": s, "y": None},
                                                       {"x": ref, "y": None})):
            assert port_loader._resolve_local_batch(batch, port_s) == batch
            assert ref_loader._resolve_local_batch(batch, ref_s) == batch


def test_a_sharding_that_is_not_one_raises_value_error_like_the_reference():
    """The JAX package takes any object at construction and its ``device_put`` refuses
    it with ``ValueError`` at the first transfer; the port refuses it at construction."""
    import jax.numpy as jnp

    with pytest.raises(ValueError, match="only accepts"):
        jax.device_put(jnp.arange(4), object())
    for bad in (object(), {"x": object()}):
        with pytest.raises(ValueError, match="NamedSharding"):
            port_loader.DataLoader(object(), 4, sharding=bad, device="cpu")


def test_parallel_exports_and_item_15_names():
    import petastorm_tpu.parallel as ref_parallel
    import petastorm_tpu_torch.parallel as parallel

    for name in ("AXIS_ORDER", "batch_sharding", "local_batch_size", "make_mesh",
                 "sequence_sharding"):
        assert hasattr(parallel, name) and hasattr(ref_parallel, name)
    assert parallel.AXIS_ORDER == ref_parallel.AXIS_ORDER
    # item 15 is ported: its names resolve lazily, as the reference's do
    for name in ("ring_attention", "ulysses_attention", "reference_attention",
                 "ring_self_attention", "ulysses_self_attention", "spmd_pipeline",
                 "pipelined_apply", "stage_sharding"):
        assert callable(getattr(parallel, name)) and callable(getattr(ref_parallel, name))
    with pytest.raises(AttributeError):
        getattr(parallel, "no_such_name")
