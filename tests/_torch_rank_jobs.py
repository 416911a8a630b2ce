"""Rank bodies of the port's multi-card placement tests (``tests/test_torch_sharding.py``):
each runs in a spawned process as one rank of a ``torch.distributed`` job over gloo on a
``"cpu"`` mesh, and writes what it saw (JSON, plus an ``.npz`` of arrays) for the test
process to hold against the JAX package.

This module imports numpy and the port only: a rank must not load jax or the JAX package.
"""
import datetime
import json
import os

import numpy as np

MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]


def _join(rank, world, port):
    """Join the job's gloo group with a deadline: a rank whose peer never comes fails
    within a minute instead of hanging its test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))


def _is_dtensor(v):
    from torch.distributed.tensor import DTensor

    return isinstance(v, DTensor)


def _placements(v):
    return [repr(p) for p in v.placements]


def _scalar_part(cfg, mesh, rank, world, arrays):
    """(a): the scalar store, global batch ``cfg['batch']`` over the ranks."""
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.parallel.mesh import batch_sharding

    out = {"batches": []}
    reader = make_batch_reader(cfg["scalar"], cur_shard=rank, shard_count=world,
                               reader_pool_type="dummy", shuffle_row_groups=False)
    with DataLoader(reader, cfg["batch"], sharding=batch_sharding(mesh),
                    device="cpu") as loader:
        out["local_batch_size"] = loader.local_batch_size
        for i, b in enumerate(loader):
            rec = {"dtensor": sorted(k for k, v in b.items() if _is_dtensor(v)),
                   "shape": list(b["id"].shape), "placements": _placements(b["id"]),
                   "local_ids": b["id"].to_local().tolist()}
            out["batches"].append(rec)
            for k, v in b.items():
                arrays["a_%d_%s" % (i, k)] = v.full_tensor().numpy()
    return out


def _jpeg_part(cfg, mesh, rank, world, arrays):
    """(b): the JPEG store decoded on the rank's device, with a normalising transform."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops.image import normalize_images
    from petastorm_tpu_torch.parallel.mesh import batch_sharding

    def transform(b):
        return {**b, "norm": normalize_images(b["image"], MEAN, STD,
                                              out_dtype=torch.float32)}

    out = {"placements": set()}
    ids, images, norms = [], [], []
    reader = make_batch_reader(cfg["jpeg"], cur_shard=rank, shard_count=world,
                               workers_count=1, shuffle_row_groups=False,
                               decode_on_device=True)
    with DataLoader(reader, cfg["jpeg_batch"], sharding=batch_sharding(mesh),
                    device="cpu", device_transform=transform) as loader:
        for b in loader:
            out["placements"].add(tuple(_placements(b["image"])))
            out["global_shape"] = list(b["image"].shape)
            ids.extend(b["id"].to_local().tolist())
            images.append(b["image"].to_local().numpy())
            norms.append(b["norm"].to_local().numpy())
        out["decode_unsharded_batches"] = loader.stats.decode_unsharded_batches
    out["placements"] = sorted(out["placements"])
    out["ids"] = ids
    arrays["b_images"] = np.concatenate(images)
    arrays["b_norm"] = np.concatenate(norms)
    return out


def _passthrough_part(cfg, mesh, rank, world, arrays):
    """(c): the tabular store with ``pagedec="on"``; the inflate runs the kernels' plain
    versions on the rank's device (``PTPU_PAGEDEC_DEVICE=1``)."""
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.io.pagedec import counter_values
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.parallel.mesh import batch_sharding

    os.environ["PTPU_PAGEDEC_DEVICE"] = "1"
    before = counter_values()
    cols = {}
    reader = make_batch_reader(cfg["tab"], cur_shard=rank, shard_count=world,
                               workers_count=1, shuffle_row_groups=False,
                               io_options={"pagedec": "on"})
    with DataLoader(reader, cfg["tab_batch"], sharding=batch_sharding(mesh), device="cpu",
                    last_batch="partial") as loader:
        for b in loader:
            assert all(_is_dtensor(v) for v in b.values()), sorted(b)
            for k, v in b.items():
                cols.setdefault(k, []).append(v.to_local().numpy())
    after = counter_values()
    for k, parts in cols.items():
        arrays["c_" + k] = np.concatenate(parts)
    return {"columns": sorted(cols),
            "bytes_compressed": after["bytes_compressed"] - before["bytes_compressed"],
            "host_inflate_columns": after["host_inflate_columns"]
            - before["host_inflate_columns"]}


def _ring_part(cfg, mesh, rank, world):
    """(d): the device shuffle ring under the sharding: the rank's ids, one epoch."""
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.parallel.mesh import batch_sharding

    reader = make_batch_reader(cfg["scalar"], cur_shard=rank, shard_count=world,
                               reader_pool_type="dummy", shuffle_row_groups=False)
    ids = []
    dtensor = True
    with DataLoader(reader, cfg["batch"], sharding=batch_sharding(mesh), device="cpu",
                    device_shuffle_capacity=cfg["ring"], seed=3,
                    last_batch="partial") as loader:
        for b in loader:
            dtensor = dtensor and all(_is_dtensor(v) for v in b.values())
            ids.extend(b["id"].to_local().tolist())
    return {"ids": ids, "dtensor": dtensor}


def _inmem_part(cfg, mesh, rank, world):
    """(e): ``InMemDataLoader`` across the ranks, two epochs, and a resume."""
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import InMemDataLoader
    from petastorm_tpu_torch.parallel.mesh import batch_sharding

    def build():
        reader = make_batch_reader(cfg["scalar"], cur_shard=rank, shard_count=world,
                                   reader_pool_type="dummy", shuffle_row_groups=False)
        return InMemDataLoader(reader, cfg["batch"], num_epochs=2, seed=5,
                               sharding=batch_sharding(mesh), device="cpu")

    out = {"shapes": set(), "global_ids": []}
    with build() as loader:
        out.update(local_batch_size=loader.local_batch_size, len=len(loader),
                   rows=loader.rows, cur_shard=loader.cur_shard)
        stream = []
        for b in loader:
            out["shapes"].add(tuple(b["id"].shape))
            stream.append(b["id"].to_local().tolist())
            out["global_ids"].append(b["id"].full_tensor().tolist())
        per = out["len"]
        out["epochs"] = [sum(stream[e * per:(e + 1) * per], []) for e in range(2)]
        out["stream"] = stream
    # resume: a state taken after 3 batches, restored into a fresh loader on every rank
    with build() as loader:
        it = iter(loader)
        pre = [next(it)["id"].to_local().tolist() for _ in range(3)]
        state = loader.state_dict()
    with build() as loader:
        loader.load_state_dict(state)
        post = [b["id"].to_local().tolist() for b in loader]
    out["shapes"] = sorted(out["shapes"])
    out["resume_pre"] = pre
    out["resume_post"] = post
    out["resume_state"] = [state["epoch"], state["batch"]]
    return out


def _error_part(mesh):
    """(f): the refusals, each as ``(type name, message)``."""
    from petastorm_tpu_torch.loader import DataLoader, InMemDataLoader
    from petastorm_tpu_torch.parallel.mesh import (NamedSharding, PartitionSpec,
                                                   batch_sharding)

    s = batch_sharding(mesh)
    cases = {
        "indivisible": lambda: DataLoader(object(), 15, sharding=s, device="cpu"),
        "undecomposable": lambda: DataLoader(object(), 16, sharding=object(), device="cpu"),
        "undecomposable_dict": lambda: DataLoader(object(), 16, sharding={"x": object()},
                                                  device="cpu"),
        "device": lambda: DataLoader(object(), 16, sharding=s, device="meta"),
        "inmem_no_sharding": lambda: InMemDataLoader(object(), 16, device="cpu"),
        "inmem_partial": lambda: InMemDataLoader(object(), 16, sharding=s,
                                                 last_batch="partial", device="cpu"),
        "inmem_replicated": lambda: InMemDataLoader(
            object(), 16, sharding=NamedSharding(mesh, PartitionSpec(None)), device="cpu"),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except Exception as e:  # noqa: BLE001 — the test reads the type and message
            out[name] = [type(e).__name__, str(e)]
    return out


def gloo_sharding_rank(rank, world, port, cfg, out):
    """One rank of the two-rank job: parts (a)-(f) on a ``"cpu"`` mesh of ``dp=world``.
    Writes ``out`` (JSON) and ``out + ".npz"``."""
    import torch.distributed as dist

    from petastorm_tpu_torch.parallel.mesh import make_mesh

    _join(rank, world, port)
    try:
        mesh = make_mesh(device_type="cpu")
        arrays = {}
        res = {"mesh": [list(mesh.mesh.shape), list(mesh.mesh_dim_names)]}
        res["a"] = _scalar_part(cfg, mesh, rank, world, arrays)
        res["b"] = _jpeg_part(cfg, mesh, rank, world, arrays)
        res["c"] = _passthrough_part(cfg, mesh, rank, world, arrays)
        res["d"] = _ring_part(cfg, mesh, rank, world)
        res["e"] = _inmem_part(cfg, mesh, rank, world)
        res["f"] = _error_part(mesh)
        np.savez(out + ".npz", **arrays)
        with open(out, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def gloo_sequence_rank(rank, world, port, cfg, out):
    """One rank of the four-rank (dp, sp) = (2, 2) job of part (g): ``sequence_sharding``
    on the tokens, ``batch_sharding`` on the ids. Ranks that share a dp coordinate read
    the same reader shard. Fed whole sequences, the delivery cuts each rank's rows to
    its sp part; fed the rank's sp slice of each sequence (a device transform), it keeps
    it. Both give the global batch. Writes JSON with both."""
    import torch.distributed as dist

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader, make_dataloader
    from petastorm_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                                   sequence_sharding)

    _join(rank, world, port)
    try:
        mesh = make_mesh({"dp": 2, "sp": 2}, device_type="cpu")
        dp, sp = mesh.get_coordinate()
        sharding = {"tokens": sequence_sharding(mesh), "id": batch_sharding(mesh)}
        seq = cfg["seq"]

        def sp_slice(b):
            part = seq // 2
            return {**b, "tokens": b["tokens"][:, sp * part:(sp + 1) * part].contiguous()}

        res = {"coordinate": [dp, sp]}
        for name, transform in (("whole", None), ("sliced", sp_slice)):
            reader = make_batch_reader(cfg["url"], cur_shard=dp, shard_count=2,
                                       reader_pool_type="dummy", shuffle_row_groups=False)
            with DataLoader(reader, cfg["batch"], sharding=sharding, device="cpu",
                            device_transform=transform) as loader:
                b = next(iter(loader))
                res[name] = {
                    "local_batch_size": loader.local_batch_size,
                    "shape": list(b["tokens"].shape),
                    "local_shape": list(b["tokens"].to_local().shape),
                    "placements": _placements(b["tokens"]),
                    "tokens": b["tokens"].full_tensor().tolist(),
                    "ids": b["id"].full_tensor().tolist()}
        # make_dataloader picks the reader shard itself: the rank's dp coordinate
        with make_dataloader(cfg["url"], cfg["batch"], sharding=sharding, device="cpu",
                             reader_pool_type="dummy", shuffle_row_groups=False) as loader:
            b = next(iter(loader))
            res["made"] = {"shard": [loader.reader.cur_shard, loader.reader.shard_count],
                           "shape": list(b["tokens"].shape),
                           "tokens": b["tokens"].full_tensor().tolist()}
        with open(out, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def gloo_imagenet_example_rank(rank, world, port, cfg, out):
    """One rank of the ImageNet example under a ``torchrun``-like environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): the
    script joins the gloo group itself, reads its shard and trains through
    ``DistributedDataParallel``, its model in float32 (the step comparison's precision;
    the example computes in bfloat16). Writes JSON: the script's result and a float64
    sum of every parameter and of every batch-norm buffer; and ``out + ".npz"``: each
    step's local batch (``step<i>.image``, ``step<i>.label``) and the model's state
    after it (``step<i>.<state_dict key>``)."""
    import importlib.util

    import numpy as np
    import torch

    os.environ.update({"WORLD_SIZE": str(world), "RANK": str(rank),
                       "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(port)})
    spec = importlib.util.spec_from_file_location("train_imagenet_torch", cfg["script"])
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    models = []
    build = example.build_model
    make_step = example.make_train_step
    record = {}

    def keep(*args, **kwargs):
        models.append(build(*args, **{**kwargs, "dtype": torch.float32}))
        return models[-1]

    def recording(net, learning_rate):
        step = make_step(net, learning_rate)

        def recorded(image, label):
            loss = step(image, label)
            i = len(record) // 3
            record["step%d.image" % i] = image.numpy().copy()
            record["step%d.label" % i] = label.numpy().copy()
            record["step%d.state" % i] = {k: v.detach().numpy().copy()
                                          for k, v in models[0].state_dict().items()}
            return loss

        return recorded

    example.build_model = keep
    example.make_train_step = recording
    res = example.main(cfg["argv"])
    flat = {}
    for key, value in record.items():
        if key.endswith(".state"):
            flat.update({key[:-len("state")] + k: v for k, v in value.items()})
        else:
            flat[key] = value
    np.savez(out + ".npz", **flat)
    model = models[0]
    res["param_sum"] = float(sum(p.detach().double().sum() for p in model.parameters()))
    res["buffer_sum"] = float(sum(b.double().sum() for b in model.buffers()))
    with open(out, "w") as f:
        json.dump(res, f)
