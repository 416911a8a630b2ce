"""ImageNet training on a CUDA card: the north-star pipeline end to end, in PyTorch.

Parquet (JPEG via CompressedImageCodec) → ``make_batch_reader(decode_on_device=True)``
(native C++ entropy decode in the reader pool) → ``DataLoader`` (the batched stage-2
CUDA kernels: dequantise, IDCT, upsample and colour on the card, an async transfer
thread) → a ResNet-50 (or ViT) train step: ``x = image / 255``, mean cross entropy,
SGD with Nesterov momentum.

The counterpart of ``examples/imagenet/train_imagenet_jax.py``, with the same flags and
``--device``. Under ``torchrun`` with ``WORLD_SIZE`` > 1 each rank reads its shard, the
loader delivers the global batch sharded over a ``dp`` mesh (``batch_sharding``), the
batch norms take the global batch's statistics (``sync_batch_norm``) and the model is
wrapped in ``DistributedDataParallel``, so each step is the one-card step on the global
batch, as the JAX example's jitted step over its mesh is. Run ``generate_petastorm_imagenet.py`` first (or point --dataset-url at
any dataset written with a fixed-shape jpeg image field and an integer label), e.g.::

    python generate_petastorm_imagenet.py --url file:///tmp/imagenet_pq --size 224
    python train_imagenet_torch.py --dataset-url file:///tmp/imagenet_pq --steps 100
    torchrun --nproc-per-node 4 train_imagenet_torch.py --dataset-url ... --steps 100
"""
import argparse
import contextlib
import math
import os
import time

import torch
import torch.nn.functional as F

from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.parallel.mesh import batch_sharding, make_mesh, to_local
from petastorm_tpu_torch.reader import make_batch_reader

#: the crop ``--augment`` takes from stored images larger than it
CROP = 224
#: steps before the steady rate's clock starts (the first ones load the libraries' kernels)
WARMUP_STEPS = 2


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-url", required=True)
    parser.add_argument("--batch-size", type=int, default=256,
                        help="global rows a step (split over the ranks under torchrun)")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--learning-rate", type=float, default=0.1)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--model", choices=["resnet50", "vit_b16", "vit_s16"],
                        default="resnet50",
                        help="consumer model: ResNet-50 (conv, batch-norm state) or "
                             "a ViT (patchify + attention; same data plane)")
    parser.add_argument("--host-decode", action="store_true",
                        help="disable the two-stage on-device JPEG decode (baseline)")
    parser.add_argument("--augment", action="store_true",
                        help="on-device random crop to 224 (where the images exceed "
                             "it) + horizontal flip, drawn from the loader's generator")
    parser.add_argument("--decode-resize", type=int, default=0,
                        help="on-device resize target (pixels, square) for stores "
                             "with MIXED image sizes; 0 = require a uniform store")
    parser.add_argument("--trace", metavar="PATH", default=None,
                        help="write a chrome://tracing span trace of the pipeline + "
                             "train steps to PATH at exit")
    parser.add_argument("--device", default="cuda",
                        help="where batches land and the model trains (cuda, or cpu)")
    args = parser.parse_args(argv)
    if args.decode_resize and args.host_decode:
        parser.error("--decode-resize requires the on-device decode path "
                     "(drop --host-decode, or resize the store on write)")
    return args


def build_model(name, num_classes, image_hw, device, dtype=torch.bfloat16):
    """The consumer model, initialised from seed 0 (bfloat16 compute, float32
    parameters). ``image_hw``: the batches' (h, w), which sizes a ViT's positions."""
    from petastorm_tpu_torch.models import ResNet50, ViT_B16, ViT_S16

    torch.manual_seed(0)
    if name == "resnet50":
        return ResNet50(num_classes=num_classes, dtype=dtype, device=device)
    make = ViT_B16 if name == "vit_b16" else ViT_S16
    return make(num_classes=num_classes, image_size=image_hw, dtype=dtype, device=device)


def make_train_step(model, learning_rate):
    """``step(image, label) -> loss``: one SGD step (momentum 0.9, Nesterov: optax's
    ``sgd(lr, momentum=0.9, nesterov=True)`` update) of the mean cross entropy of the
    logits of ``image / 255`` (uint8 NHWC in). The model (or its
    ``DistributedDataParallel`` wrapper) stays in training mode: batch statistics
    update, a ViT's dropout is live. The loss comes back as a device scalar, not read."""
    opt = torch.optim.SGD(model.parameters(), lr=learning_rate, momentum=0.9,
                          nesterov=True)
    model.train()

    def train_step(image, label):
        x = image.float() / 255.0
        loss = F.cross_entropy(model(x), label.long())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return train_step


def make_augment(crop=CROP):
    """The ``--augment`` device transform: ``fn(batch, generator)``, a random crop to
    ``crop`` where the images exceed it on both sides, then a per-image horizontal flip,
    both drawn from the loader's generator."""
    from petastorm_tpu_torch.ops.image import random_crop

    def device_transform(batch, generator):
        img = batch["image"]
        if img.shape[1] > crop and img.shape[2] > crop:
            img = random_crop(img, generator, crop, crop)
        flips = torch.rand(img.shape[0], generator=generator, device=img.device) < 0.5
        img = torch.where(flips[:, None, None, None], img.flip(2), img)
        return {**batch, "image": img}

    return device_transform


def _init_distributed(device):
    """(rank, world, device, joined): joins the ``torchrun`` job when ``WORLD_SIZE`` >
    1 (NCCL on cards, gloo on the CPU), each rank on its local card; ``joined``: this
    call made the process group (and the script destroys it at the end)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1, torch.device(device), False
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    joined = not dist.is_initialized()
    if joined:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dist.get_rank(), dist.get_world_size(), dev, joined


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Train ``--steps`` steps; prints progress and returns ``{"steps", "losses",
    "img_per_s", "steady_img_per_s", "warmup_s", "seconds", "stats"}``: the losses read
    at the end, this rank's images a second over the whole run (reader start-up
    included) and after step ``WARMUP_STEPS`` (None for a shorter run), the seconds to
    the end of that step, the run's seconds, the loader's stage counters."""
    args = parse_args(argv)
    rank, world, device, joined = _init_distributed(args.device)
    mesh = sharding = None
    shard = {}
    if world > 1:
        mesh = make_mesh(device_type=device.type)
        sharding = batch_sharding(mesh)
        shard = {"cur_shard": rank, "shard_count": world}

    reader = make_batch_reader(
        args.dataset_url, workers_count=args.workers, num_epochs=None,
        shuffle_row_groups=True, decode_on_device=not args.host_decode,
        schema_fields=["image", "label"], **shard)

    # the model is built for the shape batches will have (a ViT's positions depend on it)
    if args.decode_resize:
        image_hw = (args.decode_resize, args.decode_resize)
    else:
        field_shape = reader.schema.fields["image"].shape
        image_hw = tuple(field_shape[:2]) if field_shape and None not in field_shape \
            else (CROP, CROP)
    if args.augment and image_hw[0] > CROP and image_hw[1] > CROP:
        image_hw = (CROP, CROP)  # the device transform random-crops to 224
    model = build_model(args.model, args.num_classes, image_hw, device)
    net = model
    if world > 1:
        from torch.nn.parallel import DistributedDataParallel

        from petastorm_tpu_torch.models.layers import sync_batch_norm

        sync_batch_norm(model, mesh.get_group("dp"))
        net = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None)
    train_step = make_train_step(net, args.learning_rate)

    device_transform = make_augment() if args.augment else None
    # stores with mixed image sizes batch at one shape through the on-device resize
    resize = (args.decode_resize, args.decode_resize) if args.decode_resize else None
    tracer = None
    if args.trace:
        from petastorm_tpu_torch.trace import TraceRecorder

        tracer = TraceRecorder()
    losses = []
    step = 0
    rows = 0
    t0 = time.perf_counter()
    warm = None  # (time, rows) at step WARMUP_STEPS
    stats = None
    try:
        with DataLoader(reader, args.batch_size, sharding=sharding,
                        device_transform=device_transform, device_decode_resize=resize,
                        trace=tracer, device=device) as loader:
            for batch in loader:
                image, label = to_local(batch["image"]), to_local(batch["label"])
                with tracer.span("train.step") if tracer is not None \
                        else contextlib.nullcontext():
                    losses.append(train_step(image, label))
                step += 1
                rows += image.shape[0]
                if step == WARMUP_STEPS:
                    _synchronize(device)
                    warm = (time.perf_counter(), rows)
                if step % 20 == 0:
                    loss = float(losses[-1])
                    dt = time.perf_counter() - t0
                    print("step %d loss %.4f  %.1f img/s  stages=%s"
                          % (step, loss, rows / dt, loader.stats.snapshot()))
                if step >= args.steps:
                    break
            _synchronize(device)
            t_end = time.perf_counter()
            stats = loader.stats.snapshot()
    finally:
        # a crash or Ctrl-C mid-run is exactly when the trace matters
        if tracer is not None:
            print("trace written to", tracer.dump(args.trace))
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()
    seconds = t_end - t0
    steady = None
    if warm is not None and step > WARMUP_STEPS:
        steady = (rows - warm[1]) / (t_end - warm[0])
    values = [float(v) for v in losses]
    print("done: %d steps, %.1f img/s overall, %s img/s after step %d, final loss %.4f"
          % (step, rows / seconds, "-" if steady is None else "%.1f" % steady,
             WARMUP_STEPS, values[-1] if values else math.nan))
    return {"steps": step, "losses": values, "img_per_s": rows / seconds,
            "steady_img_per_s": steady, "warmup_s": None if warm is None else warm[0] - t0,
            "seconds": seconds, "stats": stats}


if __name__ == "__main__":
    main()
