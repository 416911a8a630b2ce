#!/usr/bin/env python3
"""A/B runs of the port's paths on one CUDA card: two trees, or two pass-through modes.

    python3 chip_ab.py --path main --run parent=_chipwork/parent: --run change=.:auto \\
        --rounds 5
    python3 chip_ab.py --path tabular --run off=.:off --run auto=.:auto --rounds 3
    python3 chip_ab.py --path main --run defaults=.: --run read_off=.:+read_off \
        --rounds 10
    python3 chip_ab.py --path mixed --run parent=_chipwork/parent: --run change=.: \
        --rounds 5
    python3 chip_ab.py --path kernels --run parent=_chipwork/parent: --run change=.: \\
        --rounds 4

Each ``--run LABEL=TREE:MODE`` names a checkout whose ``petastorm_tpu_torch`` package the
run imports (TREE holds the package) and the ``io_options={"pagedec": MODE}`` it reads
with (an empty MODE passes no ``io_options``, for trees that predate them). A MODE
ending in ``+read_off`` also turns the read path's readahead, coalescing and work
stealing off (trees that have them; ``.:+read_off`` alone keeps the default
``pagedec``). The stores
are written once, as ``chip_smoke.py`` writes them: ``main`` is the 4,096-row JPEG store
read with ``decode_on_device=True`` and ``normalize_images`` as the device transform,
batches of 256; ``mixed`` is the 2,048-row mixed-size store of chip_smoke's phase 6,
read without end through ``device_decode_resize=(256, 256)`` and the crop, jitter and
``normalize_and_augment`` transform, batches of 256; ``tabular`` is the 2,097,152-row
Criteo-shaped store, batches of 16,384.
``kernels`` times, per tree, K1 over one batch's three components (256 corpus images;
beside three ``torch.addmm`` calls), ``stage2_planes`` and ``stage2_rgb`` on the same
batch in the transfer variant its content selects (trees that have them), K2 on a (256, 224, 224, 3) batch to bfloat16 and
float32 and through ``normalize_and_augment`` (flip on; beside the bfloat16 conversion
copy), and K3, the run scan and K4 over one 16,384-row Criteo-shaped batch's pages, each
as the tree's own path launches it (one launch a batch where the tree has the batched
entries; one launch a component, a column or a dictionary data page where it does not);
it reports device milliseconds (the calls queued behind a spin on the card,
``chip_smoke.timing``) and K2's host enqueue microseconds a call, not rows/s. Every run
is its own process, so each pays its own build and start; the runs of a round
go in turn, and each round starts one run later than the one before (A B, B A, ...), so
that no label always runs first. Each run prints rows/s over its steady window and its
``PipelineStats`` split; the summary gives each label's runs and, for each label after the
first, the rounds in which it beat the first.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _one(args):
    """One run in this process: the path through the tree's package; prints one JSON."""
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    import petastorm_tpu_torch
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader

    if not os.path.abspath(petastorm_tpu_torch.__file__).startswith(tree + os.sep):
        raise SystemExit("imported %s, not the tree %s" % (petastorm_tpu_torch.__file__, tree))
    sys.path.insert(1, ROOT)
    import chip_smoke as smoke

    if args.path == "kernels":
        return _one_kernels(args, smoke)
    pagedec, _, extra = args.mode.partition("+")
    io_options = {"pagedec": pagedec} if pagedec else {}
    if extra == "read_off":
        io_options.update(readahead=False, coalesce=False, work_stealing=False)
    elif extra:
        raise SystemExit("unknown MODE suffix %r (want +read_off)" % extra)
    kwargs = {"io_options": io_options} if io_options else {}
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    if args.path == "main":
        from petastorm_tpu_torch.ops.image import normalize_images

        def transform(batch):
            return {**batch, "image": normalize_images(batch["image"], smoke.MEAN,
                                                       smoke.STD)}

        reader = make_batch_reader(args.url, workers_count=workers, shuffle_row_groups=True,
                                   seed=0, num_epochs=None, decode_on_device=True, **kwargs)
        batch, loader_kwargs = smoke.BATCH, {"device_transform": transform}
    elif args.path == "mixed":
        from petastorm_tpu_torch.ops import image

        def transform(batch, gen):
            x = image.random_crop(batch["image"], gen, smoke.MIX_CROP, smoke.MIX_CROP)
            x = image.color_jitter(x, gen, 0.4, 0.4, 0.4)
            return {**batch, "image": image.normalize_and_augment(x, smoke.MEAN, smoke.STD,
                                                                  gen, flip=True)}

        reader = make_batch_reader(args.url, workers_count=workers, shuffle_row_groups=True,
                                   seed=1, num_epochs=None, decode_on_device=True, **kwargs)
        batch, loader_kwargs = smoke.BATCH, {"device_transform": transform, "seed": 2,
                                             "device_decode_resize": smoke.MIX_RESIZE}
    else:
        reader = make_batch_reader(args.url, workers_count=workers, shuffle_row_groups=True,
                                   seed=0, num_epochs=None, **kwargs)
        batch, loader_kwargs = smoke.TAB_BATCH, {}
    try:
        from petastorm_tpu_torch.io import pagedec
        counters0 = pagedec.counter_values()
    except ImportError:  # a tree without the pass-through
        pagedec, counters0 = None, None
    with DataLoader(reader, batch, device="cuda", prefetch=3, host_queue_size=8,
                    **loader_kwargs) as loader:
        it = iter(loader)
        for _ in range(args.warmup):
            next(it)
        torch.cuda.synchronize()
        stats0 = loader.stats.snapshot()
        t0 = time.perf_counter()
        for _ in range(args.measured):
            next(it)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats1 = loader.stats.snapshot()
        it.close()
    window = {k: round(v - stats0[k], 4) for k, v in stats1.items()
              if isinstance(v, (int, float)) and k in stats0}
    out = {"rows_per_s": args.measured * batch / dt, "window_s": dt, "stats": window}
    if pagedec is not None:
        out["pagedec"] = {k: v - counters0[k] for k, v in pagedec.counter_values().items()}
    print("RESULT " + json.dumps(out), flush=True)


def _one_kernels(args, smoke):
    """K1, the stage-2 kernels, K2, K3, the scan and K4 of the tree at the main paths'
    shapes, as the tree launches them; device times from ``chip_smoke.timing``."""
    import pickle

    import numpy as np
    import torch

    from petastorm_tpu_torch.ops import image, jpeg
    from petastorm_tpu_torch.ops import pagedec_kernels as pk

    dev = torch.device("cuda")
    with open(os.path.join(args.url, "blobs.pkl"), "rb") as f:
        blobs = pickle.load(f)
    decoded = jpeg.entropy_decode_jpeg_batch(blobs)
    coeffs, qtabs = jpeg.stack_jpeg_coefficients(decoded)
    scaled = [(torch.from_numpy(c).float() * torch.from_numpy(q).float()[:, None, :])
              .reshape(-1, 64).contiguous().to(dev) for c, q in zip(coeffs, qtabs)]
    if hasattr(jpeg, "idct_scaled_segments"):
        def k1():
            return jpeg.idct_scaled_segments(scaled)
    else:
        def k1():
            return [jpeg.idct_scaled(x) for x in scaled]
    basis = jpeg._basis_on(dev)
    bias = torch.full((64,), 128.0, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    chunks = smoke.tabular_chunks(os.path.join(args.url, "tabular", "part-0.parquet"), 0)
    groups = [(c, ([c.dict_page] if c.dict_page is not None else []) + list(c.pages))
              for c in chunks.values()]
    if hasattr(pk, "snappy_inflate_ragged"):
        layout, src, table = pk.pack_ragged(groups)
        src, table = torch.from_numpy(src).to(dev), torch.from_numpy(table).to(dev)

        def k3():
            return pk.snappy_inflate_ragged(src, table, layout.out_bytes)
    else:
        padded = []
        for chunk, pages in groups:
            comp, meta, out_cap = pk._pack_pages(chunk, pages)
            padded.append((torch.from_numpy(comp).to(dev), torch.from_numpy(meta).to(dev),
                           out_cap))

        def k3():
            return [pk.snappy_inflate_pages(c, m, cap) for c, m, cap in padded]
    scan, k4, launches = _scan_and_k4(pk, chunks, dev)
    imgs = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (smoke.BATCH,) + smoke.IMG, dtype=np.uint8)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    k2_ms, k2_enqueue_us = smoke.timing(
        lambda: image.normalize_images(imgs, smoke.MEAN, smoke.STD, torch.bfloat16))
    out = {
        "k1_ms": smoke.cuda_ms(k1),
        "k1_library_ms": smoke.cuda_ms(lambda: [torch.addmm(bias, x, basis) for x in scaled]),
        "k2_bf16_ms": k2_ms, "k2_enqueue_us": k2_enqueue_us,
        "k2_f32_ms": smoke.cuda_ms(
            lambda: image.normalize_images(imgs, smoke.MEAN, smoke.STD, torch.float32)),
        "k2_augment_ms": smoke.cuda_ms(
            lambda: image.normalize_and_augment(imgs, smoke.MEAN, smoke.STD, gen)),
        "copy_bf16_ms": smoke.cuda_ms(lambda: imgs.to(torch.bfloat16)),
        "k3_ms": smoke.cuda_ms(k3), "scan_ms": smoke.cuda_ms(scan), "k4_ms": smoke.cuda_ms(k4),
        "scan_k4_launches": launches}
    if hasattr(jpeg, "stage2_planes_segments"):
        layout, variants, _selected = smoke.stage2_variants(decoded, dev)
        segs = variants["selected"]
        planes = jpeg.stage2_planes_segments(segs)
        out["stage2_planes_ms"] = smoke.cuda_ms(lambda: jpeg.stage2_planes_segments(segs))
        out["stage2_rgb_ms"] = smoke.cuda_ms(lambda: jpeg.stage2_rgb(planes, layout))
    out["rows_per_s"] = 0.0
    print("RESULT " + json.dumps(out), flush=True)


def _scan_and_k4(pk, chunks, dev):
    """The run scan and K4 over one row group's data pages as the tree launches them:
    ``(scan(), k4(), launches of each a batch)``. Batched trees launch each once over
    every data page; earlier trees once a dictionary data page, on its stream in K3's
    output (the level-block length and bit width read here, before the timing)."""
    import torch

    from petastorm_tpu_torch.io import pagedec

    if hasattr(pk, "stage_batch"):
        batch = pk.stage_batch({name: pagedec.PassthroughColumn.from_chunk(c)
                                for name, c in chunks.items()}, dev)
        out, ok, runs, meta, flags, _values = batch.run()
        plan = batch.plan

        def scan():
            return pk.rle_scan_pages(out, batch.stored, batch.pages, ok, plan.runs_total)

        def k4():
            return pk.extract_pages(out, batch.stored, batch.pages, batch.blocks, runs, meta,
                                    flags, plan.out_bytes)
        return scan, k4, 1
    groups = [(c, ([c.dict_page] if c.dict_page is not None else []) + list(c.pages))
              for c in chunks.values()]
    layout, src, table = pk.pack_ragged(groups)
    out, _ok = pk.snappy_inflate_ragged(torch.from_numpy(src).to(dev),
                                        torch.from_numpy(table).to(dev), layout.out_bytes)
    streams = []
    for g, (chunk, _pages) in enumerate(groups):
        matrix = layout.matrix(out, g)
        row0 = 1 if chunk.dict_page is not None else 0
        for j, page in enumerate(chunk.pages):
            if page.encoding == 0:
                continue
            body = matrix[row0 + j, :page.uncomp_size]
            off = 4 + int(body[:4].cpu().numpy().view("<u4")[0]) if chunk.max_def else 0
            data = body[off + 1:]
            bw, total = int(body[off].item()), page.num_values
            tables = pk.rle_run_scan(data, data.shape[0], total, max(8, total), bw)
            streams.append((data, bw, total, tables))

    def scan():
        return [pk.rle_run_scan(d, d.shape[0], n, max(8, n), bw) for d, bw, n, _t in streams]

    def k4():
        return [pk.rle_extract(d, *t[:4], bw, n) for d, bw, n, t in streams]
    return scan, k4, len(streams)


def _write_store(path, root):
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    if path in ("main", "mixed"):
        env = smoke.phase_environment()
        url = "file://" + os.path.join(root, "store")
        (smoke.write_store if path == "main" else smoke.write_mixed_store)(url, env["cv2"])
        return url, env["smi"]
    if path == "kernels":  # 256 corpus JPEGs and one Criteo-shaped row group
        import pickle

        env = smoke.phase_environment()
        codec = smoke.BaselineJpegEncoder(smoke.QUALITY) if env["cv2"] is None else None
        blobs = []
        for img in smoke.make_images(smoke.BATCH):
            if codec is not None:
                blobs.append(codec.encode(img))
            else:
                ok, enc = env["cv2"].imencode(".jpg", img[..., ::-1],
                                              [env["cv2"].IMWRITE_JPEG_QUALITY, smoke.QUALITY])
                blobs.append(enc.tobytes())
        with open(os.path.join(root, "blobs.pkl"), "wb") as f:
            pickle.dump(blobs, f)
        smoke.write_tabular_store(os.path.join(root, "tabular"), files=1, rgs_per_file=1)
        return root, env["smi"]
    url, _arrays = smoke.write_tabular_store(os.path.join(root, "tabular"))
    return url, smoke.phase_environment()["smi"]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=("main", "mixed", "tabular", "kernels"),
                        required=True)
    parser.add_argument("--run", action="append", required=True,
                        help="LABEL=TREE:MODE (MODE auto/on/off or empty, "
                             "optionally +read_off)")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--warmup", type=int, default=None)
    parser.add_argument("--measured", type=int, default=None)
    parser.add_argument("--timeout", type=float, default=300.0, help="seconds per run")
    # one run in this process (the driver's child)
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--tree", help=argparse.SUPPRESS)
    parser.add_argument("--mode", default="", help=argparse.SUPPRESS)
    parser.add_argument("--url", help=argparse.SUPPRESS)
    args = parser.parse_args()
    defaults = {"main": (5, 60), "mixed": (2, 16), "tabular": (30, 60),
                "kernels": (0, 0)}[args.path]
    args.warmup = defaults[0] if args.warmup is None else args.warmup
    args.measured = defaults[1] if args.measured is None else args.measured
    if args.one:
        return _one(args)

    runs = []
    for spec in args.run:
        label, _, rest = spec.partition("=")
        tree, _, mode = rest.rpartition(":")
        if not label or not tree or not os.path.isdir(os.path.join(tree, "petastorm_tpu_torch")):
            raise SystemExit("--run %r: want LABEL=TREE:MODE with TREE/petastorm_tpu_torch" % spec)
        runs.append((label, tree, mode))
    work = tempfile.mkdtemp(prefix="ptpu_chip_ab_")
    results = {label: [] for label, _t, _m in runs}
    try:
        url, smi = _write_store(args.path, work)
        print(smi, flush=True)
        for r in range(args.rounds):
            for k in range(len(runs)):
                label, tree, mode = runs[(r + k) % len(runs)]
                cmd = [sys.executable, os.path.abspath(__file__), "--one", "--path", args.path,
                       "--run", "unused", "--tree", tree, "--mode", mode, "--url", url,
                       "--warmup", str(args.warmup), "--measured", str(args.measured)]
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=args.timeout)
                lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
                if proc.returncode != 0 or not lines:
                    print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
                    raise SystemExit("run %s failed (rc %d)" % (label, proc.returncode))
                res = json.loads(lines[-1][len("RESULT "):])
                results[label].append(res)
                print("round %d %s (%s, pagedec=%s): %s" % (
                    r, label, tree, mode or "-", json.dumps(res)), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # rows/s: higher is better; kernel milliseconds: lower is better
    metrics = (("k1_ms", -1), ("stage2_planes_ms", -1), ("stage2_rgb_ms", -1),
               ("k2_bf16_ms", -1), ("k2_f32_ms", -1), ("k2_augment_ms", -1),
               ("k2_enqueue_us", -1), ("k3_ms", -1), ("scan_ms", -1), ("k4_ms", -1),
               ("k1_library_ms", -1), ("copy_bf16_ms", -1)) \
        if args.path == "kernels" else (("rows_per_s", 1),)
    first = runs[0][0]
    for metric, sign in metrics:
        if any(metric not in x for res in results.values() for x in res):
            continue  # a tree without this kernel
        for label, res in results.items():
            vals = [x[metric] for x in res]
            print("%s %s: %s (median %.4f)" % (label, metric, ", ".join(
                "%.4f" % v for v in vals), sorted(vals)[len(vals) // 2]))
        for label, _t, _m in runs[1:]:
            wins = sum(1 for x, y in zip(results[label], results[first])
                       if sign * (x[metric] - y[metric]) > 0)
            print("%s better than %s in %s in %d of %d rounds"
                  % (label, first, metric, wins, args.rounds))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
