#!/usr/bin/env python3
"""Where a JPEG path's time goes on one CUDA card.

    python3 chip_profile.py [--path main|mixed|train] [--tree DIR] [--batches N]
                            [--trace PATH]

``--tree`` names a checkout whose ``petastorm_tpu_torch`` the run imports (default: this
one), so that two trees are profiled in one call on one card. ``--path main`` builds the
same 4,096-row JPEG store as ``chip_smoke.py`` and measures, in one process:

1. the reader alone (``make_batch_reader(decode_on_device=True)``: Parquet IO + stage 1
   entropy decode in the thread pool), rows/s;
2. the whole main path (``DataLoader`` with ``normalize_images`` as device transform),
   rows/s over a steady window and the ``PipelineStats`` split;
3. a ``torch.profiler`` window of ``--batches`` main-path batches: device time by kernel
   and the device's busy share (device time over the window's wall time). ``--trace``
   writes the window's chrome trace to PATH.

``--path mixed`` does 2 and 3 on chip_smoke's mixed-size store (five sizes, resized to
256x256, then ``random_crop``, ``color_jitter`` and ``normalize_and_augment``), read
without end. Each window's device time is also summed by kind: the stage-2 kernels
(``stage2_planes``/``stage2_rgb``, or the unpack and K1 of trees that launch them), K2,
the resize's bilinear kernel, copies, and every other kernel (the torch ops: in trees
without ``stage2_rgb`` the stage-2 range limit, upsample and colour; on the mixed path
also the resize's conversions, the crop and the jitter).

``--path train`` feeds chip_smoke phase 21 (a)'s ResNet-50 training step (bfloat16,
SGD with Nesterov momentum) from the main path and splits a step's time: on a resident
batch, the host's dispatch of one step (no synchronise), one step's wall time with a
synchronise, and its device time from CUDA events around it; on the fed path, rows/s
over a steady window with the time a step spends waiting for its batch (``next``) and
dispatching, and the ``PipelineStats`` split; then the profiled window as above.

Every figure is printed beside the card's name and power limit.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import chip_smoke as smoke


def reader_alone(url, workers, rows_wanted):
    from petastorm_tpu_torch import make_batch_reader

    with make_batch_reader(url, workers_count=workers, shuffle_row_groups=True, seed=0,
                           num_epochs=None, decode_on_device=True) as reader:
        rows = 0
        t0 = None
        for batch in reader:
            if t0 is None:  # the first row group pays for the pool's start
                t0 = time.perf_counter()
                continue
            rows += len(batch.id)
            if rows >= rows_wanted:
                break
        return rows / (time.perf_counter() - t0)


#: kind of a device activity, by the first pattern its name holds
KINDS = (("stage-2 kernels", ("stage2_planes", "stage2_rgb", "coef_unpack", "idct_segments")),
         ("K2", ("normalize",)), ("resize (bilinear)", ("upsample_bilinear",)),
         ("copies", ("Memcpy", "memcpy", "Memset", "memset")))


def kind_of(name):
    for kind, patterns in KINDS:
        if any(p in name for p in patterns):
            return kind
    return "other kernels"


def main_path(url, workers, warmup, measured, profiled, trace_path, mixed=False):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image

    if mixed:
        def transform(batch, gen):
            x = image.random_crop(batch["image"], gen, smoke.MIX_CROP, smoke.MIX_CROP)
            x = image.color_jitter(x, gen, 0.4, 0.4, 0.4)
            return {**batch, "image": image.normalize_and_augment(x, smoke.MEAN, smoke.STD,
                                                                  gen, flip=True)}

        kwargs = {"device_decode_resize": smoke.MIX_RESIZE, "seed": 2}
    else:
        def transform(batch):
            return {**batch, "image": image.normalize_images(batch["image"], smoke.MEAN,
                                                             smoke.STD)}

        kwargs = {"host_queue_size": 8}
    reader = make_batch_reader(url, workers_count=workers, shuffle_row_groups=True, seed=0,
                               num_epochs=None, decode_on_device=True)
    with DataLoader(reader, smoke.BATCH, device="cuda", device_transform=transform,
                    prefetch=3, **kwargs) as loader:
        it = iter(loader)
        for _ in range(warmup):
            next(it)
        torch.cuda.synchronize()
        loader.stats.reset()
        t0 = time.perf_counter()
        for _ in range(measured):
            next(it)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats = loader.stats.snapshot()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(profiled):
                next(it)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        it.close()
    if trace_path:
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
        prof.export_chrome_trace(trace_path)
    device = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            device.append((us, e.count, e.key))
    device.sort(reverse=True)
    return measured * smoke.BATCH / dt, stats, device, wall


def train_path(url, workers, warmup, measured, profiled, trace_path):
    """``--path train`` (module docstring): returns the printed figures."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.models import ResNet50

    torch.backends.cudnn.benchmark = True
    torch.manual_seed(smoke.MODEL_SEED)
    model = ResNet50(num_classes=1000)
    step = smoke._sgd_step(model)
    gen = torch.Generator(device="cuda").manual_seed(smoke.MODEL_SEED)
    x = torch.randn((smoke.BATCH,) + smoke.IMG, generator=gen, device="cuda").to(
        torch.bfloat16)
    y = torch.randint(0, 1000, (smoke.BATCH,), generator=gen, device="cuda")
    for _ in range(smoke.MODEL_WARMUP):
        step(x, y)
    torch.cuda.synchronize()
    dispatch, wall, device = [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step(x, y)
        end.record()
        dispatch.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        device.append(start.elapsed_time(end) / 1e3)
    out = {"resident": {k: sorted(v)[2] * 1e3 for k, v in (
        ("dispatch_ms", dispatch), ("wall_ms", wall), ("event_ms", device))}}
    reader = smoke._model_reader(url, None)
    with DataLoader(reader, smoke.BATCH, device_transform=smoke._k2_only(),
                    prefetch=3) as loader:
        it = iter(loader)
        for _ in range(warmup):
            b = next(it)
            step(b["image"], b["label"])
        torch.cuda.synchronize()
        loader.stats.reset()
        waits, steps = 0.0, 0.0
        t0 = time.perf_counter()
        for _ in range(measured):
            t1 = time.perf_counter()
            b = next(it)
            t2 = time.perf_counter()
            step(b["image"], b["label"])
            waits += t2 - t1
            steps += time.perf_counter() - t2
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["fed"] = {"rows_per_s": measured * smoke.BATCH / dt, "wall_s": dt,
                      "next_ms": waits / measured * 1e3,
                      "dispatch_ms": steps / measured * 1e3,
                      "stats": loader.stats.snapshot()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(profiled):
                b = next(it)
                step(b["image"], b["label"])
            torch.cuda.synchronize()
            window = time.perf_counter() - t1
        it.close()
    if trace_path:
        os.makedirs(os.path.dirname(os.path.abspath(trace_path)), exist_ok=True)
        prof.export_chrome_trace(trace_path)
    dev = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            dev.append((us, e.count, e.key))
    dev.sort(reverse=True)
    return out, dev, window


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=("main", "mixed", "train"), default="main")
    parser.add_argument("--tree", default=smoke.ROOT, help="checkout whose package to run")
    parser.add_argument("--batches", type=int, default=20, help="profiled batches")
    parser.add_argument("--trace", default=None, help="write the chrome trace here")
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import petastorm_tpu_torch

    if not os.path.abspath(petastorm_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit("imported %s, not the tree %s" % (petastorm_tpu_torch.__file__, tree))
    env = smoke.phase_environment()
    smoke.phase_build()
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    work = tempfile.mkdtemp(prefix="ptpu_chip_profile_")
    try:
        url = "file://" + os.path.join(work, "store")
        if args.path == "train":
            smoke.write_store(url, env["cv2"])
            out, device, wall = train_path(url, workers, smoke.MODEL_WARMUP, 16,
                                           args.batches, args.trace)
            smoke.log("train path (tree %s): ResNet-50 bf16 step at batch %d; resident "
                      "batch (median of 5): %s; fed: %s" % (
                          tree, smoke.BATCH, json.dumps(out["resident"]),
                          json.dumps(out["fed"])))
        elif args.path == "main":
            smoke.write_store(url, env["cv2"])
            alone = reader_alone(url, workers, 3000)
            smoke.log("reader alone (IO + stage 1, %d workers): %.1f rows/s" % (workers, alone))
            warmup, measured = smoke.WARMUP_BATCHES, smoke.MEASURED_BATCHES
        else:
            smoke.write_mixed_store(url, env["cv2"])
            warmup, measured = 2, 8
        if args.path != "train":
            rows_s, stats, device, wall = main_path(
                url, workers, warmup, measured, args.batches, args.trace,
                mixed=args.path == "mixed")
            smoke.log("%s path (tree %s): %.1f rows/s over %d batches; stats %s"
                      % (args.path, tree, rows_s, measured, json.dumps(stats)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    total_us = sum(us for us, _n, _k in device)
    if total_us:
        smoke.log("profiled window: %d batches, wall %.4f s, device time %.4f s, device "
                  "busy share %.4f (sum of device activity / wall; streams may overlap)"
                  % (args.batches, wall, total_us / 1e6, total_us / 1e6 / wall))
        kinds = {}
        for us, _n, key in device:
            kinds[kind_of(key)] = kinds.get(kind_of(key), 0.0) + us
        # the loader runs ahead of the consumer (prefetch), so the window holds the device
        # work of fewer batches than it consumed: count them by K2, one launch a batch
        made = sum(n for _us, n, key in device if kind_of(key) == "K2")
        smoke.log("device time a batch by kind (ms; the %d batches whose K2 ran in the "
                  "window): %s" % (made, json.dumps(
                      {k: round(v / 1e3 / max(1, made), 4) for k, v in sorted(kinds.items())})))
        for us, n, key in device[:14]:
            smoke.log("  %10.1f us  %6d x  %s" % (us, n, key[:100]))
    else:
        smoke.log("profiled window: the profiler recorded no device time (not measured)")
    smoke.log(env["smi"])


if __name__ == "__main__":
    main()
