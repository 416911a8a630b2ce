#!/usr/bin/env python3
"""Smoke run of petastorm_tpu_torch on one CUDA card: build, kernels, main path.

    python3 chip_smoke.py

Phases (each passes or the script exits non-zero, printing no result line):

1. Environment: the card's name, count and power limit; pyarrow and cv2 present.
2. Build: the CUDA kernels (``csrc/*.cu``, nvcc for sm_90a) and the host JPEG decoder,
   from this checkout's sources, timed.
3. Kernels against their plain PyTorch versions, on the card, at the main path's shapes:
   K1 (IDCT) as its one launch over the three components of one batch of 256 corpus
   images, timed in turns against three ``torch.addmm`` calls; the stage-2 unpack
   (``csrc/coef_unpack.cu``) over the same batch's 301,056 blocks, for the transfer
   variant the corpus selects and for forced full int16 and 12-bit packs, each held to
   max abs error 0 and timed beside its bytes bound, its plain version and (int16) one
   ``torch.mul``; K2 (normalize) on (256, 224, 224, 3) uint8 to bfloat16, float32 and
   float16, each of its three routes with and without flips held to max abs error 0, a
   non-contiguous crop view, the bulk route's tile sizes, the bfloat16 conversion copy
   as a yardstick, and the fused ``normalize_and_augment`` against the
   normalise-then-flip composition. Device times from CUDA events with the calls queued
   behind a spin (:func:`timing`), beside the host's enqueue time a call; bounds from
   H100 SXM peaks (3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores).
4. Main path: a 4,096-row ImageNet-shaped JPEG store (224x224x3, q85, ~256-row row
   groups, 1,024 rows per file, content from a numpy seed) written by the port, read with
   ``make_batch_reader(decode_on_device=True)`` and the port's ``DataLoader`` with
   ``normalize_images`` to bfloat16 as its device transform; ~40 batches of 256, the
   coefficients narrowed as the JAX package ships them (shipped/raw printed). The
   kernels' launch counters are zeroed just before and read just after (one unpack, one
   K1 and one K2 launch a batch, every K2 launch on the bulk route); the first batch is
   checked against host cv2 decode and, bit for bit, against the port's CPU decode of
   the same rows.

5. Tabular pass-through: a 2,097,152-row Criteo-shaped store (13 dense float32, 26
   categorical int32, an int32 label; 8 files of 16 row groups of 16,384 rows; snappy)
   written from a numpy seed. K3 (snappy pages) as its one launch over one batch's 79
   real pages, then the run scan and K4 (RLE/bit-packed extract and dictionary gather) as
   the path launches them, one launch each over the batch's 40 data pages, each against
   its plain version and the host twin, timed; crafted corrupt pages (each must latch
   ok=0) and a 1 MiB page above K3's shared-memory window through K3, crafted run streams
   (each must latch its page's reason) through the scan and K4; then
   ``make_batch_reader(io_options={"pagedec": "auto"})`` → ``DataLoader`` on the card,
   batches of 16,384, 30 warm-up + 60 measured, with the launch counters zeroed around
   it, launches (1 K3, 1 scan, 1 K4) and reads back to the host (1) held to the
   per-batch prediction, and the first and last measured batches held byte for byte
   against a ``pagedec="off"`` read.

6. The mixed-size training feed: a 2,048-row JPEG store of ImageNet's common sizes and
   one ragged size (q85, content from a numpy seed) read with
   ``DataLoader(device_decode_resize=(256, 256))`` and a device transform of
   ``random_crop`` (224), ``color_jitter`` and ``normalize_and_augment`` to bfloat16;
   every batch (256, 224, 224, 3) bfloat16, the first batch's resized uint8 within 1 of
   the port's CPU path on the same rows, one unpack and one K1 launch a layout group.

7. The process pool (``reader_pool_type='process'``, ``workers_count=min(8, cpus-1)``),
   against the thread pool in the same process. The main path's store and configuration
   for three epochs (48 batches: 5 warm-up, 35 measured, 8 under ``torch.profiler`` for
   the device busy share) on the thread pool, then the process pool on ``'arrow'``,
   ``'shm'`` and ``'shm-view'`` at the default 32 MB slab (a 270-row group's ~40.6 MB of
   coefficients takes the socket), the shm wires again with ``PTPU_SHM_SLAB_BYTES`` at
   64 MB (the phase fails where ``df /dev/shm`` says the ring does not fit), and the
   thread pool again, so the pools' order is bracketed. Each run: every id delivered
   once an epoch, every image equal on the card to the first thread-pool run's image of
   the same id, ``stage2_planes``/``stage2_rgb``/K2 launched once a batch, the first
   batch equal to the plain stage 2 (the CPU decode) and to K2's plain version, no
   lease leaked, no child with ``libcuda`` mapped or listed by ``nvidia-smi``, no slab
   left after ``join()``; printed: rows/s, ``read_s``/``decode_s``/``put_wait_s``/
   ``device_queue_wait_s`` a batch, the busy share, ``wire_stats()`` (slab items against
   socket fallbacks), start-up (seconds to the children's handshakes and to the first
   result) and the children's resident memory. Then phase 5's tabular path at 10 + 30
   batches on the thread pool, the process pool on ``'arrow'`` and ``'shm-view'``, and
   the thread pool again, with phase 5's checks (launches, 0 host-inflated columns,
   byte identity) and no lease leaked; printed: rows/s and ``inflate_s`` a batch.

8. The click-through training feed (BASELINE.json config #3 as a DLRM-style trainer
   consumes it). A ``FeaturePipeline(device=True)`` modelled on the MLPerf DLRM
   preprocessing of Criteo (``Standardize`` then ``FillNull`` on the 13 dense columns,
   ``HashField`` of the 26 categoricals into the MLPerf vocabulary sizes, one quantile
   ``Bucketize(num_buckets=16)``, one ``VocabLookup(max_size=1000)``, one
   ``FeatureCross``; every output under a new name), its statistics resolved once over
   phase 5's store (``io.statscache.resolve_statistics``, sources printed). (a) the feed:
   ``make_batch_reader(io_options={"pagedec": "auto"})`` → ``DataLoader(batch_size=16384,
   device_shuffle_capacity=131072, device_transform=pipeline)``, 10 warm-up + 30 measured
   batches, beside a phase-5-style run (no ring, no pipeline) in the same process: no row
   delivered twice (a 64-bit key a row over its 40 raw columns, on the card), one K3, one
   scan and one K4 launch and one read back to the host a transferred batch, 0
   host-inflated columns; the ring's exchange and the pipeline's device time a batch
   (:func:`timing`); then one whole epoch through the ring and the pipeline: the store's
   rows exactly once (sorted keys equal), every derived column of every batch equal to
   the port's host target on the batch's raw rows (ids exact, floats within 1 ulp; the
   bucket ids equal float32 comparisons, as the JAX package's device function compares,
   and those that differ from the host target's float64 comparison are counted). (b) the
   same pipeline as ``make_batch_reader(transform_spec=...)``, which resolves its own
   statistics: 0 compressed pages shipped (a transform turns the pass-through off, as in
   the JAX package) and the derived columns equal (a)'s pipeline on the same rows. (c)
   phase 4's store with ``device_shuffle_capacity=1024`` (decoded uint8 images in the
   ring), one epoch: every id once, every image equal on the card to phase 7's ring-less
   image of the same id, ``stage2_planes``, ``stage2_rgb`` and K2 once a batch.

9. Row selection and exact resume. (a) phase 4's store laid out as hive ``split=train/``
   (three files) and ``split=val/`` (one), hard links with metadata written anew, read
   with ``make_batch_reader(decode_on_device=True, filters=[("split", "=", "train")],
   predicate=in_pseudorandom_split([0.9, 0.1], 0, "id"))`` into phase 4's loader: the
   delivered ids equal the split recomputed on the host (md5 of each id), each once;
   every image equal on the card to phase 7's image of the same id; only the kept rows
   reach stage 1; ``stage2_planes``, ``stage2_rgb`` and K2 once a batch; rows/s,
   ``read_s`` and ``decode_s`` a batch and the share of rows that skipped stage 1
   printed. (b) phase 5's files as ``day=0..7/`` with ``filters=[("day", "<", 6)]`` and
   ``shuffle_row_drop_partitions=4``, one epoch through a loader whose batches are one
   partition each: every row of days 0-5 once (64-bit row keys), none of days 6-7, each
   partition's rows equal to the partitions recomputed with numpy, 0 compressed pages
   shipped. (c) phase 5's flat store with ``pagedec="auto"`` through
   ``DataLoader(16384)``: 20 batches, ``checkpoint.save(path, loader)``, a fresh reader
   and loader, ``checkpoint.restore``, the rest: every row arrives, the rows delivered
   twice are at most those of the row groups in flight at the save (printed), one K3,
   scan and K4 launch a pass-through batch in both halves. (d) the same on the main path
   through ``torch.distributed.checkpoint`` (``state_item(loader)`` beside a tensor).
   (e) ``pad_shapes`` on a 65,536-row store with a ragged int32 column of 0-50 ids a
   row, padded to (64,): the padded tensor and its mask on the card equal numpy's.

10. Windowed and in-memory feeds. (a) ``InMemDataLoader`` over phase 4's store
   (``decode_on_device=True``, batch 256, K2 as its device transform), two shuffled
   epochs: every id once an epoch, the orders differ, every image equal on the card to
   phase 7's, K2 equal to its plain version, ``stage2_planes``/``stage2_rgb`` once a fill
   batch and K2 once a served batch, and a state taken after 5 batches, restored into a
   fresh loader over a fresh reader (multi-worker fills both), serves exactly the
   remaining batches' ids; fill
   seconds, served rows/s and the store's ``memory_allocated`` printed. (b)
   ``InMemDataLoader`` over phase 5's store with ``pagedec="auto"``, batch 16,384: one K3,
   scan and K4 launch a pass-through fill batch, every row once, the first batch's
   columns equal to phase 5's arrays by row key. (c) ``make_dataloader(url, 256,
   decode_on_device=True, shuffle_row_groups=False, workers_count=7)`` against
   ``make_batch_reader`` + ``DataLoader`` with the same arguments: the same ids, images
   equal to phase 7's. (d) per-row ``NGram({0: ["id", "image"], 1: ["id", "image"], 2:
   ["id"]}, delta_threshold=1, timestamp_field="id")`` (host decode) into
   ``DataLoader(64)`` with K2 on both frames: the windows equal a numpy computation
   from the row-group layout, each once, frames equal to the host decode, K2 twice a
   batch and equal to its plain version. (e) a 1,048,576-row sensor store (``ts`` at 10
   ms with a seeded gap about every 1,000 rows, 8 float32 sensors, row groups of 65,536)
   through a batched ``NGram`` of 8 steps (72 flat columns) into ``DataLoader(16384)``,
   with and without overlap: the window starts equal a numpy rolling-sum computation,
   each window once, every value equal to the store's. (f) ``WeightedSamplingReader``
   over phase 5's files 0-5 and 6-7, ``[0.7, 0.3]``, seed 0, into ``DataLoader(16384)``:
   the items' origins follow numpy's ``Generator(PCG64(0)).choice`` while both readers
   live, every row once. (g) the torch adapters' ``BatchedDataLoader`` over phase 5's
   store: every column, moved to the card, equals the ``DataLoader``'s.

11. The read path and the row-group caches. The JAX package's default read path
   (readahead of depth 3 over 2 IO threads, coalesced reads of up to 4 adjacent row
   groups, work stealing, the 64 MiB shared footer cache) is the default of every phase
   above; here it is held against ``IoOptions(readahead=False, coalesce=False,
   work_stealing=False)``. (a) phase 7's thread-pool run of the main path at the
   defaults and all off, 3 rounds each, alternating which goes first: rows/s, read_s
   and decode_s a batch, readahead hits, misses and exposed-wait seconds, coalesced
   reads and steals printed; every id once an epoch, images equal to phase 7's per id,
   K2 equal to its plain version, one stage2_planes, stage2_rgb and K2 launch a batch.
   (b) phase 5's pass-through the same way (phase 5's checks in every run), from an
   emptied footer cache: one footer parse a file over all six runs, and no pass-through
   column in any prefetch made while the pass-through was live. (c) the main path with
   ``memcache_bytes`` over two epochs (one reader each): 300 MB must evict and deliver
   exactly; 1 GiB serves epoch 2 from memory for every row group with 0 rows through
   stage 1, equal images, and counts at least the store's 616,562,688 coefficient bytes.
   (d) phase 5's store through ``cache_type="local-disk"`` (classic read), two epochs:
   epoch 2 from the disk tier, every row group equal to the source, the cache
   directory's bytes printed. (e) the process pool on ``'arrow'``: every child's
   readahead hits, every id once an epoch, images equal to phase 7's per id.

12. The object-store tier and the host-wide cache arena, every store behind the
   port's cloud simulator (``io.latencyfs.CloudLatencyFS(LocalFileSystem(), sleep=True,
   seed=13)``: a 5 ms floor, ~1 s/GB, 2 % of GETs at 10x), passed as ``filesystem=``,
   which engages the ranged-GET engine. (a) phase 7's thread-pool run of the main path
   from the simulator against the local read, 3 rounds, alternating: rows/s, read_s and
   decode_s a batch, GETs, hedges, sparse fallbacks, footer GETs a file and the
   simulator's p50/p99 delay printed; every id once, images equal to the local read's
   per id, K2 equal to its plain version, one stage2_planes, stage2_rgb and K2 launch a
   batch, at most one footer GET a file in the process. (b) phase 5's pass-through from
   the simulator beside the local read (phase 5's checks); then phase 5's columns in
   row groups of 65,536 rows and 16 KB pages (its own row groups' chunks are under the
   engine's 64 KB request floor), two epochs at ``target_request_bytes`` of 64 KB: the
   second epoch splits every chunk over the target only at walked page starts. (c)
   hedging: phase 5's pass-through over 3 epochs with 30 % of GETs at 10x, hedged and
   not: hedges fire, the batches are equal between the runs, no lease is left; the p99
   of a row group's GET plan printed (a quarter of the row groups: 40 GETs a row group
   through one engine's 8 in flight). (d) the main path from the simulator on a process
   pool of 7 children over ``'arrow'`` with a 1 GiB arena and memcache, two epochs (one
   reader each), then without the arena: with it, epoch 2 takes no store GET and no row
   through stage 1 in any child, each footer is fetched once across the pool, images
   equal, and no arena segment is left.

13. Failure handling and its record: the recovery policy, the chaos plane, the trace
   recorder and the metrics registry (every plan's faults are the plan's own). (a) the
   main path (phase 7's thread-pool configuration, one epoch, the partial last batch
   delivered) under ``FaultPlan([FaultRule("reader.read", "raise_transient",
   every=4)], seed=14)`` with ``recovery=dict(io_retries=8, io_retry_backoff_s=0.01)``
   (retry attempts are hits too: among 7 reader and 2 IO threads a failed read's retry
   lands on another fourth hit about one time in four, so 2 retries ran out on the card,
   and 8 leave it one time in 4**8)
   beside a clean epoch, 3 rounds alternating: every id once, images equal per id to
   phase 7's, the ``io_retry`` degradations equal to the plan's injections, nothing
   quarantined, one ``stage2_planes``, ``stage2_rgb`` and K2 launch a batch in both;
   rows/s of both printed. (b) phase 5's files 0 and 1 (32 row groups) with
   ``pagedec="on"``, one epoch, under ``FaultRule("io.pagedec", "raise_permanent",
   item_key="part-1.parquet:3")`` and ``recovery=dict(on_poison="quarantine",
   poison_attempts=2)``: exactly that row group quarantined (16,384 rows, 2 attempts,
   ``ptpu_quarantined_rows_total`` up by 16,384), every other row group once and byte
   for byte the source, 0 host-inflated columns, one K3, scan and K4 launch a batch,
   the loader's state after the epoch with all 32 row groups consumed; the same run with
   ``on_poison="raise"`` raises ``FileNotFoundError`` to the consumer within its
   ``results_timeout_s``. (c) the main path on 7 children over ``'arrow'`` under
   ``FaultRule("child.item", "kill", item_key="ordinal=5")`` (propagated) with
   ``RecoveryOptions(on_poison="quarantine", poison_attempts=2, worker_respawns=1)``:
   exactly ordinal 5's row group missing, the rest equal per id, one ``child_death``
   entry of 2 attempts, a budget of 0 left; then ``'shm'`` with 9 x 64 MB slabs under
   ``FaultRule("wire.decode", "corrupt", nth=2, times=1)``: every id once, no respawn,
   no lease leaked; no ``ptpu_torch_shm_*`` or ``ptpu_torch_arena_*`` segment of this
   process left after either. (d) (a)'s clean main path and phase 5's pass-through at
   10 + 30 batches, each with a ``TraceRecorder`` and a ``MetricsRegistry`` and without,
   3 rounds alternating (phase 5's checks in every pass-through run): the dumped Chrome
   JSON loads and holds every stage span (``reader.next``, ``batch.form``,
   ``decode.dispatch``, ``h2d.transfer``, ``wait.host_queue``, ``wait.device_queue``,
   ``train.step``) on 3 thread lanes or more, ``ptpu_pipeline_batches`` equals the
   batches delivered, the read stage's histogram counts, ``write_prometheus`` parses
   back, ``bottleneck_report()`` gives a verdict; a traced pool run of (c)'s
   configuration (two epochs) shows one ``child.work`` lane for each child pid. Rows/s
   on and off and the verdicts printed.

14. Liveness and time: the health monitor with its stall watchdog on the main path, a
   hung decode caught by the ``raise`` escalation, the process pool's healer, and the
   time series, SLOs and scrape endpoint on the pass-through (the comment block above
   ``phase_health_main_path``).

15. Attribution: the provenance plane on both kernel paths (the comment block above
   ``phase_prov_tabular``). (a) phase 5's pass-through with ``provenance=True`` on the
   thread pool and on the process pool over ``'arrow'``, with phase 5's checks: every
   batch's record holds its rows from one item delivered once, the report counts the
   batches delivered, each child's ``child.work`` lies inside its ``wire.roundtrip``.
   (b) one site at a time slowed by a chaos latency (``decode.device_inflate``,
   ``reader.read``, ``io.pagedec``) with one worker and readahead off, 3 rounds: the
   report's slow-decile culprit is the slowed site, the columns equal the store's, K3,
   the scan and K4 once a batch; an SLO on the inflate stage's p99 alerts once, naming
   it. (c) the main path with provenance on and off, 3 rounds alternating: images equal
   per id, K2 equal to its plain version, the kernels once a batch, rows/s of each arm,
   and the host self time of ``loader.decode`` beside the kernels' device time. (d) the
   trend gate twice, the run diff and the stats CLI's attribution panel.

16. Tenants and the controller (the comment block above ``phase_ctl_converge``): (a) the
   wrong readahead depth on a slow simulated store, with and without
   ``DataLoader(controller=...)``, and the depth set by hand: the controller grows the
   depth, each actuation carrying its window and signal, every id once, the images id
   for id those of the run without it; rows/s of the last third printed. (b) the live
   resize 4 -> 2 -> 4 on the thread pool and on the process pool over ``'arrow'``, two
   epochs, every id once an epoch, nothing quarantined, no lease leaked; the process
   pool's running children ack a readahead retune sent mid-run. (c) the controller armed
   on the healthy main path: 0 actuations; armed against unarmed, 3 pairs. (d) ``team-a``
   on the thread pool, ``team-b`` on the process pool, then an untagged run: the usage
   report's rows equal each loader's, worker and decode seconds charged, the untagged
   run adds no tenant series, the per-tenant fold, the stats CLI's tenant panel. Every
   run checks the kernels once a batch and K2 against its plain version.

17. Dataset watch and mutation (the comment block above ``_watch_copy``): (a) a watched
   main path on the thread pool over a copy of phase 1's store, two epochs; after the
   second batch one tick of a seeded FaultPlan's mutation rules appends a file of new
   ids, rewrites file 2 with new ids and images and removes file 3: the first epoch
   delivers files 0, 1 and the appended one, the second those and file 2's new
   generation, files 2 and 3 quarantine as ``piece_rewritten``/``piece_removed`` in both,
   no epoch holds two generations of a file, every image equals the plain stage 2 of its
   id, the kernels once a batch, the ``ptpu_dataset_*`` counters equal the mutations;
   the stamping's cost with and without the footer crc. (b) the pass-through over phase
   5's files 0 and 1, file 1 rewritten from a new seed after the first epoch: the new
   generation's batches equal pyarrow's read of the new bytes, no stale footer or
   refusal survives, one K3, scan and K4 launch a batch. (c) (a) on the process pool over
   ``'arrow'``: the same items, ids and quarantine, each conflict counted once in the
   parent.

18. Multi-card placement (the comment block above ``phase_place_world_of_one``): (a) a
   world of one over NCCL, phase 4's main path with ``sharding=batch_sharding(
   make_mesh())``: DTensors of the global batch, pixels per id phase 7's; (b) two ranks
   over gloo on the one card: each rank's main path, two-epoch ``InMemDataLoader`` and
   pass-through over its shard, ids once across the ranks, pixels per id phase 7's,
   the pass-through's rows the store's, every kernel once a batch on each rank.

19. The process pool on tcp (the comment block above ``phase_tcp_main_path``): (a) the
   main path on four children over the pipe and over framed tcp, one epoch each at
   batches of 128: every id once, pixels per id phase 7's, the JPEG kernels once a
   batch, the connects counted and no link death; (b) the pass-through over both wires
   with phase 5's checks; (c) a seeded ``net.reset`` and (d) a ``net.corrupt_frame`` in
   the middle of (a)'s epoch: every id once, nothing quarantined, the reconnect and the
   corrupt frame counted.

20. The data service (the comment block above ``phase_service``): a ``DataService``
   over two of phase 4's files with two ``DecodeWorker`` processes decoding the JPEG
   cells on the host; (a) two trainers, each a ``ServiceReader`` into
   ``DataLoader(device='cuda')`` with K2, every row once each, pixels per id phase 7's,
   one decode an item; (b) a detach with ``state_dict()`` and an exact resume; (c) a
   seeded ``net.reset`` on a worker's link; (d) a co-hosted trainer served from the
   host arena.
21. The model zoo and the model-parallel toolkit (the comment block above
   ``phase_model_resnet``): (a) ResNet-50 (bfloat16, ``channels_last``) trained with SGD
   fed by the main path with K2, the step alone timed with CUDA events, rows/s fed,
   ``device_queue_wait_s``, the busy share, peak memory and every loss printed, the loss
   falling on one fixed batch, ``stage2_planes``/``stage2_rgb``/K2 once a fed batch; (b)
   a float32 ResNet-50's logits on the card within 1e-3 of the CPU's (TF32 off); (c)
   ViT-B/16 steps on the same loader; (d) the SPMD MoE transformer step as a world of
   one over NCCL against ``reference_loss``, and ring and Ulysses attention at axis
   size 1 against ``reference_attention``.
22. The examples, the tools and reference compatibility (the comment block above
   ``_example``): (a) ``examples/torch/imagenet/train_imagenet_torch.py`` trains
   ResNet-50 at 1,000 classes, 224x224, batch 256 for 24 steps on phase 4's store with
   ``--augment`` and ``--trace``: finite losses, 24 ``train.step`` spans, the stage-2
   kernels once a decoded batch, K2 never, the script's img/s; (b) ViT-S/16 with
   ``--decode-resize 256 --augment`` on phase 6's mixed store, the stage-2 kernels once
   a layout group; (c) ``train_mnist_torch.py`` streamed and ``--in-memory``; (d)
   ``tools.copy_dataset`` and ``generate_metadata`` on phase 4's store, the copy read on
   the card, and phase 4's files under the reference petastorm's pickled keys read
   through ``make_reader``: pixels per id phase 7's.

The last lines are the kernels table (JSON; ``pool_launches`` gives each kernel's
launches in phase 7's runs, ``ring_feed_launches`` in phase 8's, ``selection_launches``
in phase 9's, ``slice11_launches`` in phase 10's, ``slice12_launches`` in phase 11's,
``slice13_launches`` in phase 12's, ``slice14_launches`` in phase 13's,
``slice15_launches`` in phase 14's, ``slice16_launches`` in phase 15's,
``slice17_launches`` in phase 16's, ``slice18_launches`` in phase 17's,
``slice19_launches`` in phase 18's, each rank apart, ``slice20_launches`` in phases 19
and 20's, ``slice21_launches`` in phase 21's fed trainers, ``slice22_launches`` in
phase 22's parts, every kernel's counter read), the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
"""
import collections
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
SMEM_ROUND_TRIP_CYCLES = 30    # least shared-memory load-to-use latency, one token of K3
L2_ROUND_TRIP_CYCLES = 200     # about the least L2 load-to-use latency, one run of the scan
SM_CLOCK_MHZ = [1980.0]        # nvidia-smi clocks.max.sm, read in phase 1
ROWS, ROWS_PER_FILE, BATCH = 4096, 1024, 256
IMG = (224, 224, 3)
QUALITY = 85
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
WARMUP_BATCHES, MEASURED_BATCHES = 5, 35
K1_PAIRS = 6
PER_IMAGE_ROWS = 4             # corpus images through the per-image stage 2 (K1's path)


class PhaseFailed(Exception):
    pass


def log(*parts):
    print(*parts, flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def timing(fn, iters=20, warmup=3):
    """``(device ms, host enqueue us)`` a call of ``fn()`` on the current stream.

    The device time comes from CUDA events around ``iters`` calls. A spin on the card
    (``torch.cuda._sleep``) is queued ahead of the start event, twice as long as one
    untimed round of ``iters`` calls took the host (at least 1 ms, at most 0.5 s: the
    plain versions that take longer are host-bound anyway), so the calls are all queued
    before the start event fires and the events time the device alone, not the enqueue.
    The enqueue time is the host's wall time a call in the timed round."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(0.5, max(1e-3, 2.0 * host_s)) * SM_CLOCK_MHZ[0] * 1e6))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_s / iters * 1e6


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds of ``fn()`` on the current stream (:func:`timing`)."""
    return timing(fn, iters, warmup)[0]


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and flops over f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 ---------------------------------------------------------------------------


def phase_environment():
    import torch

    check(torch.cuda.is_available(), "no CUDA device: torch.cuda.is_available() is False")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"], capture_output=True,
                           text=True, timeout=60).stdout.strip().splitlines()
    SM_CLOCK_MHZ[0] = float(clock[0]) if clock and clock[0].strip().isdigit() else 1980.0
    log("device: %s  count: %d  torch %s  cuda %s" % (name, count, torch.__version__,
                                                      torch.version.cuda))
    log("nvidia-smi: %s" % (smi[0] if smi else "unavailable"))
    try:
        import pyarrow
    except ImportError:
        raise PhaseFailed("pyarrow is not installed: the main path (Parquet reading) "
                          "cannot run on this machine")
    try:
        import cv2
    except ImportError:
        cv2 = None
    log("pyarrow %s, cv2 %s" % (pyarrow.__version__, cv2.__version__ if cv2 else "absent"))
    sys.path.insert(0, ROOT)
    import petastorm_tpu_torch  # noqa: F401 — fails outside a checkout of the repo
    return {"name": name, "count": count, "smi": smi[0] if smi else "", "cv2": cv2}


# -- phase 2 ---------------------------------------------------------------------------


def phase_build():
    from petastorm_tpu_torch.ops import kernels, native

    t0 = time.perf_counter()
    kernels.library()
    cuda_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(native.native_available(), "host JPEG decoder build failed: %s"
          % native.native_error())
    host_s = time.perf_counter() - t0
    log("build: CUDA kernels %.2fs (%s), host decoder %.2fs"
        % (cuda_s, os.path.basename(kernels.BUILD_INFO.get("path", "?")), host_s))
    for line in kernels.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  ptxas: " + line.strip())


# -- corpus ------------------------------------------------------------------------------


def make_images(n, seed=0, shape=IMG):
    """ImageNet-shaped content from a numpy seed: lightly blurred noise over a gradient,
    one uint8 image of ``shape`` per row, ~19 KB as a q85 JPEG at 224x224x3
    (photographic crops of that size run 20-35 KB)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    grad = np.add.outer(np.linspace(0, 255, shape[0], dtype=np.float32),
                        np.linspace(0, 255, shape[1], dtype=np.float32)) * 0.5
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for _ in range(n):
        img = rng.randint(0, 256, shape).astype(np.float32)
        for axis in (0, 1):
            pad = [(1, 1) if a == axis else (0, 0) for a in range(3)]
            p = np.pad(img, pad, mode="reflect")
            img = sum(k[i] * np.take(p, range(i, i + shape[axis]), axis=axis)
                      for i in range(3))
        yield (0.8 * img + 0.2 * grad[..., None]).clip(0, 255).astype(np.uint8)


def write_store(url, cv2):
    """The 4,096-row store through the port's writer; returns {id: jpeg bytes}."""
    import numpy as np

    from petastorm_tpu_torch import types
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.metadata import RowWriter
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("ChipSmokeSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("image", np.uint8, IMG, CompressedImageCodec("jpeg", QUALITY), False),
        UnischemaField("label", np.int32, (), ScalarCodec(types.IntegerType()), False),
    ])
    field = schema.fields["image"]
    if cv2 is None:
        # no cv2 on this machine: encode a pool of distinct images with the small
        # baseline encoder below and cycle the rows through it
        pool = [BaselineJpegEncoder(QUALITY).encode(img) for img in make_images(128)]
        encoded = (pool[i % len(pool)] for i in range(ROWS))
    else:
        encoded = (bytes(field.codec.encode(field, img)) for img in make_images(ROWS))
    blobs = {}
    # 5 MB of ~19 KB rows: row groups of ~270 rows, four per 1,024-row file
    with RowWriter(url, schema, row_group_size_mb=5, rows_per_file=ROWS_PER_FILE) as w:
        for i, blob in enumerate(encoded):
            blobs[i] = blob
            w.write_encoded({"id": i, "image": blob, "label": i % 1000})
    return blobs


# -- phase 3 ---------------------------------------------------------------------------


def phase_kernels(blobs):
    import numpy as np
    import torch

    from petastorm_tpu_torch.ops import image, jpeg

    dev = torch.device("cuda")
    results = {}

    # K1 on the coefficients of one batch of 256 corpus images: ONE launch over the
    # batch's three components, as _batched_stage2 makes it
    planes = jpeg.entropy_decode_jpeg_batch([blobs[i] for i in range(BATCH)])
    check(all(p is not None for p in planes), "stage 1 refused a corpus image")
    coeffs, qtabs = jpeg.stack_jpeg_coefficients(planes)
    scaled_all = [
        (torch.from_numpy(c).float() * torch.from_numpy(q).float()[:, None, :])
        .reshape(-1, 64).contiguous().to(dev) for c, q in zip(coeffs, qtabs)]
    basis = jpeg._basis_on(dev)
    bias = torch.full((64,), 128.0, device=dev)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    outs = jpeg.idct_scaled_segments(scaled_all)
    plains = [jpeg._idct_scaled_plain(scaled) for scaled in scaled_all]
    torch.cuda.synchronize()
    err = max((o - p).abs().max().item() for o, p in zip(outs, plains))
    diff_u8 = sum(int((torch.clamp(torch.round(o), 0, 255)
                       != torch.clamp(torch.round(p), 0, 255)).sum().item())
                  for o, p in zip(outs, plains))
    rows = [s.shape[0] for s in scaled_all]
    nbytes, flops = sum(2 * n * 64 * 4 for n in rows) + 64 * 64 * 4, sum(2 * n * 64 * 64
                                                                         for n in rows)
    b_ms, b_by = bound(nbytes, flops)
    # kernel and library call in turns (K1, addmm x 3, addmm x 3, K1, ...): each pair
    # is one comparison on one card
    pairs = []
    for r in range(K1_PAIRS):
        timed = [("kernel", lambda: jpeg.idct_scaled_segments(scaled_all)),
                 ("library", lambda: [torch.addmm(bias, x, basis) for x in scaled_all])]
        got = dict((name, cuda_ms(fn)) for name, fn in (timed if r % 2 == 0 else timed[::-1]))
        pairs.append((got["kernel"], got["library"]))
    plain_ms = cuda_ms(lambda: [jpeg._idct_scaled_plain(x) for x in scaled_all])
    torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    ms = sorted(k for k, _l in pairs)[len(pairs) // 2]
    lib_ms = sorted(lib for _k, lib in pairs)[len(pairs) // 2]
    log("K1 idct one launch over rows %s: kernel_ms %s, library_ms (3 x torch.addmm) %s "
        "(pairs in turn); kernel below the library call in %d of %d pairs"
        % (rows, [round(k, 4) for k, _l in pairs], [round(lib, 4) for _k, lib in pairs],
           sum(k < lib for k, lib in pairs), len(pairs)))
    log("K1 per batch (1 launch): kernel_ms=%.4f (median) plain_ms=%.4f library_ms=%.4f "
        "bound_ms=%.4f (%s) roofline_share=%.3f max_abs_err=%.3g differing_uint8=%d"
        % (ms, plain_ms, lib_ms, b_ms, b_by, b_ms / ms, err, diff_u8))
    check(err <= 1e-3, "K1 differs from its plain version by %.3g > 1e-3" % err)
    check(diff_u8 == 0, "K1 range-limited output differs from the plain version's in %d "
          "values" % diff_u8)
    k1 = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "max_abs_err": err,
          "rows": rows, "pairs": pairs}
    # the whole batched stage 2 on the card against the CPU path (plain versions
    # throughout)
    on_card = jpeg.decode_jpeg_batch(planes, device=dev).cpu().numpy()
    on_cpu = jpeg.decode_jpeg_batch(planes, device="cpu").numpy()
    n_diff = int((on_card != on_cpu).sum())
    log("batched decode on the card vs the CPU plain path: %d of %d uint8 values differ"
        % (n_diff, on_cpu.size))
    check(n_diff == 0, "decoded uint8 on the card differs from the plain decode in %d "
          "values" % n_diff)
    # the standalone kernels' own path since the batched stage 2 folds the unpack and
    # K1's product into stage2_planes: the per-image stage 2 (decode_jpeg_device_stage →
    # idct_blocks: one unpack and one K1 launch a component), counts zeroed around it
    jpeg.unpack_dequant_segments.launches = 0
    jpeg.idct_scaled_segments.launches = 0
    per_image = [jpeg.decode_jpeg_device_stage(p, device=dev) for p in planes[:PER_IMAGE_ROWS]]
    per_image_launches = {"unpack": jpeg.unpack_dequant_segments.launches,
                          "K1": jpeg.idct_scaled_segments.launches}
    for p, got in zip(planes[:PER_IMAGE_ROWS], per_image):
        check(torch.equal(got.cpu(), jpeg.decode_jpeg_device_stage(p, device="cpu")),
              "the per-image stage 2 on the card differs from the CPU path")
    log("the per-image path: %d images through decode_jpeg_device_stage, launches %s (one "
        "each a component), each image equal to the CPU path"
        % (PER_IMAGE_ROWS, json.dumps(per_image_launches)))
    check(per_image_launches == {"unpack": 3 * PER_IMAGE_ROWS, "K1": 3 * PER_IMAGE_ROWS},
          "the unpack and K1 should launch once a component on the per-image path: %s"
          % per_image_launches)
    results["K1"] = dict(k1, bound_ms=b_ms, bound_by=b_by, launches=per_image_launches["K1"])

    results["unpack"] = phase_unpack(planes, dev)
    results["unpack"]["launches"] = per_image_launches["unpack"]
    results["stage2"] = phase_stage2(planes, dev)
    results["K2"] = phase_k2(dev)
    return results


def parent_stage2(layout, segments, bgr=False):
    """The parent's stage 2 of one layout group, kept here as a yardstick of time: the
    standalone unpack kernel, K1, then the torch ops that range-limited, transposed,
    upsampled, cropped and coloured (each product rounded on its own, as the parent did).
    The same work as ``stage2_planes_segments`` then ``stage2_rgb``."""
    import torch

    from petastorm_tpu_torch.ops import jpeg

    height, width, comp_layout = layout
    n = segments[0].qtab.shape[0]
    full = []
    pixels = jpeg.idct_scaled_segments(jpeg.unpack_dequant_segments(segments))
    for seg, pix, (ry, rx) in zip(segments, pixels, jpeg._ratios(comp_layout)):
        pix = torch.clamp(torch.round(pix), 0.0, 255.0)
        plane = pix.reshape(n, seg.by, seg.bx, 8, 8).permute(0, 1, 3, 2, 4).reshape(
            n, seg.by * 8, seg.bx * 8)
        for axis, r in ((1, ry), (2, rx)):
            if r == 2:
                plane = jpeg._fancy_upsample2(plane, axis)
            elif r > 1:
                plane = torch.repeat_interleave(plane, r, dim=axis)
        full.append(plane[:, :height, :width])
    if len(full) == 1:
        y = torch.clamp(full[0], 0, 255).to(torch.uint8)
        return torch.stack([y, y, y], dim=-1)
    return jpeg._to_uint8(jpeg.ycbcr_to_rgb(full[0], full[1], full[2], bgr=bgr))


def stage2_variants(planes, dev):
    """A layout group's transfer variants as the stage-2 kernels take them: ``{name:
    segments}`` with the variant the content selects (``_stage_groups``, as the paths
    stage it), forced full int16 and 12-bit packs, and, cut to zigzag prefixes of (32,
    16, 16) positions, int16, 12-bit and a split from the cut's own profile (a cut
    changes the image, not what a kernel must equal)."""
    import numpy as np
    import torch

    from petastorm_tpu_torch.ops import jpeg, native

    layout = jpeg._layout_key(planes[0])
    comps = layout[2]
    coeffs, qtabs = jpeg.stack_jpeg_coefficients(planes)
    qdev = [torch.from_numpy(q).to(dev) for q in qtabs]
    reset_transfer_state(jpeg)
    (staged, staged_q, ks, packed, split), = jpeg._stage_groups([(layout, planes)], dev, None)
    reset_transfer_state(jpeg)

    def segments(slabs, ks=None, packed=None, split=None, qs=qdev):
        return [jpeg.CoefSegment(c, q, 64 if ks is None else ks[ci],
                                 bool(packed is not None and packed[ci]),
                                 None if split is None else split[ci], by, bx)
                for ci, ((_h, _v, by, bx), c, q) in enumerate(zip(comps, slabs, qs))]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cut = tuple((32, 16, 16)[:len(comps)])
    trunc = [native.jpeg_zigzag_truncate_native(c, k) for c, k in zip(coeffs, cut)]
    profile = np.stack([np.pad(native.jpeg_specmax_native(t, is_zigzag=True), (0, 64 - k))
                        for t, k in zip(trunc, cut)])
    points = jpeg._split_points(profile, cut, ("chip_smoke", len(comps)))
    reset_transfer_state(jpeg)
    split_slabs, split_spec, split_packed = [], [], []
    for t, sp in zip(trunc, points):
        pk12 = None if sp is not None else native.jpeg_pack12_native(t)
        if sp is not None:
            split_slabs.append(tuple(up(a) for a in native.jpeg_pack_split_native(
                t, sp[0], sp[1], is_zigzag=True)))
        else:  # pack12 is as good for this component; int16 beyond 12 bits
            split_slabs.append(up(t if pk12 is None else pk12))
        split_spec.append(sp)
        split_packed.append(pk12 is not None)
    variants = {
        "selected": segments(staged, ks, packed, split, staged_q),
        "int16": segments([up(c) for c in coeffs]),
        "int16_cut": segments([up(t) for t in trunc], cut),
        "split_cut": segments(split_slabs, cut, tuple(split_packed), tuple(split_spec)),
    }
    full12 = [native.jpeg_pack12_native(c) for c in coeffs]
    if all(p is not None for p in full12):  # None: a coefficient beyond 12 bits
        variants["pack12"] = segments([up(p) for p in full12], packed=(True,) * len(comps))
        variants["pack12_cut"] = segments([up(native.jpeg_pack12_native(t)) for t in trunc],
                                          cut, (True,) * len(comps))
    return layout, variants, (ks, packed, split)


def check_stage2(layout, variants, what):
    """Each variant through ``stage2_planes_segments`` and ``stage2_rgb`` (RGB and BGR)
    equal to the plain versions (``torch.equal``)."""
    import torch

    from petastorm_tpu_torch.ops import jpeg

    for name, segs in variants.items():
        outs = jpeg.stage2_planes_segments(segs)
        plains = [jpeg._stage2_planes_plain(seg) for seg in segs]
        torch.cuda.synchronize()
        check(all(torch.equal(o, p) for o, p in zip(outs, plains)),
              "stage2_planes differs from its plain version (%s, %s)" % (what, name))
        for bgr in (False, True):
            rgb = jpeg.stage2_rgb(outs, layout, bgr)
            torch.cuda.synchronize()
            check(torch.equal(rgb, jpeg._stage2_rgb_plain(outs, layout, bgr)),
                  "stage2_rgb differs from its plain version (%s, %s, bgr=%s)"
                  % (what, name, bgr))


def phase_stage2(planes, dev):
    """The batched stage 2's two kernels on one batch of 256 corpus images (301,056
    blocks): every transfer variant through ``stage2_planes`` and ``stage2_rgb`` equal to
    the plain versions; device times of each kernel (the corpus's variant, and
    ``stage2_planes`` in every variant) beside its bound and its plain version, and the
    parent's composition of the same work (the unpack, K1 and the torch ops) as a
    yardstick."""
    import torch

    from petastorm_tpu_torch.ops import jpeg

    layout, variants, selected = stage2_variants(planes, dev)
    check_stage2(layout, variants, "corpus batch")
    log("stage 2: %d variants of the corpus batch (the selected ks=%s packed=%s split=%s) "
        "equal to the plain versions through both kernels, RGB and BGR"
        % (len(variants), *selected))
    segs = variants["selected"]
    blocks = sum(seg.qtab.shape[0] * seg.by * seg.bx for seg in segs)
    plane_bytes = blocks * 64
    res = {"planes": {}, "max_abs_err": 0.0}  # every variant held with torch.equal
    for name, vsegs in variants.items():
        shipped = sum(sum(t.numel() * t.element_size() for t in
                          (seg.slabs if seg.split is not None else (seg.slabs,)))
                      for seg in vsegs)
        nbytes = shipped + sum(seg.qtab.numel() * 4 for seg in vsegs) + plane_bytes
        b_ms, b_by = bound(nbytes, 2 * blocks * 64 * 64)
        ms, enq = timing(lambda: jpeg.stage2_planes_segments(vsegs))
        res["planes"][name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                               "shipped": shipped, "enqueue_us": enq}
        log("stage2_planes %s (one launch, 3 components): kernel_ms=%.4f bound_ms=%.4f (%s; "
            "%d bytes, %d shipped) roofline_share=%.3f enqueue_us=%.1f"
            % (name, ms, b_ms, b_by, nbytes, shipped, b_ms / ms, enq))
    planes_out = jpeg.stage2_planes_segments(segs)
    sel = res["planes"]["selected"]
    sel["plain_ms"] = cuda_ms(lambda: [jpeg._stage2_planes_plain(seg) for seg in segs])
    n = segs[0].qtab.shape[0]
    rgb_bytes = plane_bytes + n * layout[0] * layout[1] * 3
    r_bound, r_by = bound(rgb_bytes, 0)
    r_ms, r_enq = timing(lambda: jpeg.stage2_rgb(planes_out, layout))
    r_plain = cuda_ms(lambda: jpeg._stage2_rgb_plain(planes_out, layout))
    res["rgb"] = {"ms": r_ms, "bound_ms": r_bound, "bound_by": r_by, "plain_ms": r_plain,
                  "enqueue_us": r_enq}
    log("stage2_rgb (one launch): kernel_ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s; %d bytes) "
        "roofline_share=%.3f enqueue_us=%.1f" % (r_ms, r_plain, r_bound, r_by, rgb_bytes,
                                                 r_bound / r_ms, r_enq))
    # the two launches as _batched_stage2 makes them, in turns with the parent's
    # composition of the same work (each pair one comparison on one card)
    pairs = []
    for r in range(4):
        timed = [("change", lambda: jpeg.stage2_rgb(jpeg.stage2_planes_segments(segs), layout)),
                 ("parent", lambda: parent_stage2(layout, segs))]
        got = dict((name, cuda_ms(fn)) for name, fn in (timed if r % 2 == 0 else timed[::-1]))
        pairs.append((got["change"], got["parent"]))
    both = sorted(c for c, _p in pairs)[len(pairs) // 2]
    parent_ms = sorted(p for _c, p in pairs)[len(pairs) // 2]
    composed = parent_stage2(layout, segs)
    ours = jpeg.stage2_rgb(jpeg.stage2_planes_segments(segs), layout)
    torch.cuda.synchronize()
    differ = int((composed != ours).sum().item())
    log("stage 2 of the batch (stage2_planes + stage2_rgb, 2 launches): %s ms; the parent's "
        "composition (unpack + K1 + torch ops) %s ms (pairs in turn); medians %.4f against "
        "%.4f; the parent's rounding of the colour differs in %d of %d uint8 values"
        % ([round(c, 4) for c, _p in pairs], [round(p, 4) for _c, p in pairs], both,
           parent_ms, differ, ours.numel()))
    res.update(both_ms=both, composition_ms=parent_ms, pairs=pairs)
    return res


def reset_transfer_state(jpeg):
    """Clear the stage-2 transfer's sticky choices and byte counters (process-global, as
    in the JAX package), so a phase starts from what its own data selects."""
    with jpeg._STICKY_KS_LOCK:
        jpeg._STICKY_KS.clear()
        jpeg._STICKY_SPLIT.clear()
        jpeg._PACK12_DISABLED.clear()
        jpeg._SPLIT_DISABLED.clear()
        jpeg._TRANSFER_BYTES.update(shipped=0, raw=0)


def phase_unpack(planes, dev):
    """The stage-2 unpack on one batch of 256 corpus images (301,056 blocks): the variant
    the corpus selects (as the main path stages it), then forced full int16 and 12-bit
    packs of the same coefficients; each launch over the three components equals the
    plain version (max abs error 0), timed, beside its bytes bound, the plain version's
    time and, for int16, one library call computing the same function."""
    import numpy as np
    import torch

    from petastorm_tpu_torch.ops import jpeg, native

    layout = jpeg._layout_key(planes[0])
    coeffs, qtabs = jpeg.stack_jpeg_coefficients(planes)
    qtabs_dev = [torch.from_numpy(q).to(dev) for q in qtabs]
    reset_transfer_state(jpeg)
    (corpus_coeffs, corpus_q, ks, packed, split), = jpeg._stage_groups(
        [(layout, planes)], dev, None)
    counters = jpeg.transfer_byte_counters(reset=True)
    packs = [native.jpeg_pack12_native(c) for c in coeffs]
    check(all(p is not None for p in packs), "a corpus coefficient exceeds 12 bits")
    variants = {
        "corpus": [jpeg.CoefSegment(c, q, 64 if ks is None else ks[ci],
                                    bool(packed and packed[ci]),
                                    None if split is None else split[ci])
                   for ci, (c, q) in enumerate(zip(corpus_coeffs, corpus_q))],
        "int16": [jpeg.CoefSegment(torch.from_numpy(c).to(dev), q, 64, False, None)
                  for c, q in zip(coeffs, qtabs_dev)],
        "pack12": [jpeg.CoefSegment(torch.from_numpy(pk).to(dev), q, 64, True, None)
                   for pk, q in zip(packs, qtabs_dev)],
    }
    blocks = sum(c.shape[0] * c.shape[1] for c in coeffs)
    out_bytes = blocks * 64 * 4
    log("unpack: the corpus selects ks=%s packed=%s split=%s; shipped/raw %d/%d = %.4f "
        "(%d blocks, %d bytes out)" % (ks, packed, split, counters["shipped"],
                                       counters["raw"], counters["shipped"] / counters["raw"],
                                       blocks, out_bytes))
    res = {}
    for name, segs in variants.items():
        outs = jpeg.unpack_dequant_segments(segs)
        plains = [jpeg._unpack_dequant_plain(seg) for seg in segs]
        torch.cuda.synchronize()
        err = max((o - p).abs().max().item() for o, p in zip(outs, plains))
        check(err == 0 and all(torch.equal(o, p) for o, p in zip(outs, plains)),
              "unpack %s differs from its plain version by %.3g" % (name, err))
        shipped = sum(sum(t.numel() * t.element_size() for t in
                          (seg.slabs if seg.split is not None else (seg.slabs,)))
                      for seg in segs)
        nbytes = shipped + sum(q.numel() * 4 for q in qtabs_dev) + out_bytes
        b_ms, b_by = bound(nbytes, blocks * 64)
        ms, enq = timing(lambda: jpeg.unpack_dequant_segments(segs))
        plain_ms = cuda_ms(lambda: [jpeg._unpack_dequant_plain(seg) for seg in segs])
        lib_ms = None
        if name == "int16":
            qf = [q.to(torch.float32)[:, None, :] for q in qtabs_dev]
            views = [seg.slabs for seg in segs]
            lib_ms = cuda_ms(lambda: [torch.mul(c, q) for c, q in zip(views, qf)])
        log("unpack %s (one launch, 3 components): kernel_ms=%.4f plain_ms=%.4f "
            "library_ms=%s bound_ms=%.4f (%s, %d bytes: %d shipped) roofline_share=%.3f "
            "enqueue_us=%.1f max_abs_err=%.3g"
            % (name, ms, plain_ms, "null" if lib_ms is None else "%.4f" % lib_ms, b_ms,
               b_by, nbytes, shipped, b_ms / ms, enq, err))
        res[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                     "shipped": shipped}
    res["ratio"] = counters["shipped"] / counters["raw"]
    reset_transfer_state(jpeg)
    return res


def phase_k2(dev):
    """K2 on a (256, 224, 224, 3) uint8 batch: every route, to bfloat16 and float32, with
    and without flips, equal to the plain version (max abs error 0); times of each route,
    of the bulk route's tile sizes, of the plain version, of the bfloat16 conversion copy
    and a device-to-device copy (the same bytes: yardsticks of the rate the card reaches,
    not of K2's function) and of the fused
    ``normalize_and_augment`` against the normalise-then-flip-and-select composition."""
    import numpy as np
    import torch

    from petastorm_tpu_torch.ops import image

    rng = np.random.RandomState(1)
    imgs = torch.from_numpy(rng.randint(0, 256, (BATCH,) + IMG, dtype=np.uint8)).to(dev)
    flips = torch.from_numpy(rng.randint(0, 2, BATCH).astype(bool)).to(dev)
    res = {}
    for out_dtype in (torch.bfloat16, torch.float32, torch.float16):
        name = {torch.bfloat16: "bf16", torch.float32: "f32", torch.float16: "f16"}[out_dtype]
        nbytes = imgs.numel() * (1 + torch.empty((), dtype=out_dtype).element_size())
        b_ms, b_by = bound(nbytes, 3 * imgs.numel())
        plain_ms = cuda_ms(lambda: image._normalize_plain(imgs, MEAN, STD, out_dtype))
        err = 0.0
        for route in image.ROUTES:
            for fl in (None, flips):
                out = image.normalize_images(imgs, MEAN, STD, out_dtype, flips=fl,
                                             route=route)
                plain = image._normalize_plain(imgs, MEAN, STD, out_dtype, fl)
                torch.cuda.synchronize()
                e = (out.float() - plain.float()).abs().max().item()
                check(e == 0 and torch.equal(out, plain), "K2 %s route %s (flips %s) "
                      "differs from its plain version by %.3g" % (name, route,
                                                                   fl is not None, e))
                err = max(err, e)
            ms, enq = timing(lambda: image.normalize_images(imgs, MEAN, STD, out_dtype,
                                                            route=route))
            log("K2 normalize %s route %s: kernel_ms=%.4f bound_ms=%.4f (%s) "
                "roofline_share=%.3f enqueue_us=%.1f (flips on and off equal to the plain "
                "version)" % (name, route, ms, b_ms, b_by, b_ms / ms, enq))
            if route == "bulk":
                res[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                 enqueue_us=enq)
        # the bulk route's tile: whole rows of 224 x 3 values
        sweep = []
        saved = image.BULK_TILE_IN_BYTES, image.BULK_TILE_OUT_BYTES
        try:
            for rows in (6, 12, 18, 24):
                image.BULK_TILE_IN_BYTES = rows * IMG[1] * IMG[2]
                image.BULK_TILE_OUT_BYTES = image.BULK_TILE_IN_BYTES * out.element_size()
                out = image.normalize_images(imgs, MEAN, STD, out_dtype, flips=flips)
                check(torch.equal(out, image._normalize_plain(imgs, MEAN, STD, out_dtype,
                                                              flips)),
                      "K2 %s at %d rows a tile differs from its plain version" % (name, rows))
                sweep.append((rows, cuda_ms(lambda: image.normalize_images(
                    imgs, MEAN, STD, out_dtype))))
        finally:
            image.BULK_TILE_IN_BYTES, image.BULK_TILE_OUT_BYTES = saved
        log("K2 normalize %s bulk route by rows a tile: %s (default %d rows)" % (
            name, ", ".join("%d: %.4f ms" % rt for rt in sweep),
            image.choose_route(imgs.shape, 0, 0, out.element_size())[1]))
        res[name]["max_abs_err"] = err
        log("K2 normalize %s kernel_ms=%.4f plain_ms=%.4f bound_ms=%.4f (%s) "
            "roofline_share=%.3f max_abs_err=%.3g (every route, flips on and off)"
            % (name, res[name]["ms"], plain_ms, b_ms, b_by, b_ms / res[name]["ms"], err))
    # a crop's view (not contiguous): one contiguous copy, then K2
    view = imgs[:, 3:227 - 6, 2:226 - 8, :]
    for out_dtype in (torch.bfloat16, torch.float32, torch.float16):
        for fl in (None, flips):
            out = image.normalize_images(view, MEAN, STD, out_dtype, flips=fl)
            check(torch.equal(out, image._normalize_plain(view, MEAN, STD, out_dtype, fl)),
                  "K2 on a non-contiguous view differs from its plain version (%s)"
                  % out_dtype)
    log("K2 on a non-contiguous (256, 218, 216, 3) view: equal to the plain version in "
        "bf16, f32 and f16, flips on and off")
    copy_ms = cuda_ms(lambda: imgs.to(torch.bfloat16))
    log("K2 yardstick: imgs.to(torch.bfloat16) (1 byte in, 2 out, no arithmetic) "
        "copy_ms=%.4f, %.3f of the bf16 bound %.4f ms; K2 bf16 takes %.3f of the copy's "
        "time" % (copy_ms, res["bf16"]["bound_ms"] / copy_ms, res["bf16"]["bound_ms"],
                  res["bf16"]["ms"] / copy_ms))
    # a device-to-device copy of as many bytes as K2 bf16 moves (half read, half written)
    src = torch.empty(imgs.numel() * 3 // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    d2d_ms = cuda_ms(lambda: dst.copy_(src))
    del src, dst
    log("K2 yardstick: device-to-device copy of the same %d bytes (%d read, %d written) "
        "d2d_ms=%.4f, %.3f of the bf16 bound; K2 bf16 takes %.3f of the copy's time"
        % (3 * imgs.numel(), 3 * imgs.numel() // 2, 3 * imgs.numel() // 2, d2d_ms,
           res["bf16"]["bound_ms"] / d2d_ms, res["bf16"]["ms"] / d2d_ms))

    def composed(gen):  # the normalise-then-flip-and-select composition
        out = image.normalize_images(imgs, MEAN, STD)
        fl = torch.rand(imgs.shape[0], generator=gen, device=dev) < 0.5
        return torch.where(fl[:, None, None, None], out.flip(2), out)

    fused = image.normalize_and_augment(imgs, MEAN, STD,
                                        torch.Generator(device=dev).manual_seed(3))
    check(torch.equal(fused, composed(torch.Generator(device=dev).manual_seed(3))),
          "normalize_and_augment differs from the normalise-then-flip composition")
    gen = torch.Generator(device=dev).manual_seed(0)
    before = image.normalize_images.launches
    image.normalize_and_augment(imgs, MEAN, STD, gen)
    check(image.normalize_images.launches == before + 1,
          "normalize_and_augment took more than one K2 launch")
    aug_ms, aug_enq = timing(lambda: image.normalize_and_augment(imgs, MEAN, STD, gen))
    comp_ms, comp_enq = timing(lambda: composed(gen))
    log("K2 normalize_and_augment(flip=True) bf16: fused_ms=%.4f (enqueue_us=%.1f, one "
        "launch + torch.rand) composition_ms=%.4f (enqueue_us=%.1f; normalize_images, "
        "torch.rand, flip, where); fused within %.1f %% of K2 alone; bit-identical"
        % (aug_ms, aug_enq, comp_ms, comp_enq,
           100.0 * (aug_ms / res["bf16"]["ms"] - 1.0)))
    res["bf16"].update(copy_ms=copy_ms, d2d_ms=d2d_ms, augment_ms=aug_ms,
                       composition_ms=comp_ms)
    return res


# -- phase 4 ---------------------------------------------------------------------------


def phase_main_path(url, blobs, cv2):
    import numpy as np
    import torch

    from petastorm_tpu_torch import codecs, make_batch_reader
    from petastorm_tpu_torch.io import pagedec
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image, jpeg

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))

    def transform(batch):
        return {**batch, "image": image.normalize_images(batch["image"], MEAN, STD),
                "image_u8": batch["image"]}

    reader = make_batch_reader(url, workers_count=workers, shuffle_row_groups=True,
                               seed=0, num_epochs=None, decode_on_device=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    codecs.host_decoded_rows(reset=True)
    reset_transfer_state(jpeg)
    jpeg.unpack_dequant_segments.launches = 0
    jpeg.idct_scaled_segments.launches = 0
    jpeg.stage2_planes_segments.launches = 0
    jpeg.stage2_rgb.launches = 0
    image.normalize_images.launches = 0
    image.normalize_images.routes = dict.fromkeys(image.ROUTES, 0)
    pagedec0 = pagedec.counter_values()
    first = None
    consumed = 0
    t_start = time.perf_counter()
    with DataLoader(reader, BATCH, device="cuda", device_transform=transform, prefetch=3,
                    host_queue_size=8) as loader:
        for batch in loader:
            consumed += 1
            if first is None:
                first = {"id": batch["id"].cpu().numpy(),
                         "label": batch["label"].cpu().numpy(),
                         "u8": batch["image_u8"].cpu().numpy(),
                         "norm": batch["image"][:8].float().cpu()}
            if consumed == WARMUP_BATCHES:
                torch.cuda.synchronize()
                t0, rows0 = time.perf_counter(), consumed * BATCH
            if consumed == WARMUP_BATCHES + MEASURED_BATCHES:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                break
        snapshot = loader.stats.snapshot()
    transfer = jpeg.transfer_byte_counters()
    launches = {"stage2_planes": jpeg.stage2_planes_segments.launches,
                "stage2_rgb": jpeg.stage2_rgb.launches,
                "unpack": jpeg.unpack_dequant_segments.launches,
                "K1": jpeg.idct_scaled_segments.launches,
                "K2": image.normalize_images.launches,
                "K2_routes": dict(image.normalize_images.routes)}
    wall = time.perf_counter() - t_start
    rows_per_s = (consumed * BATCH - rows0) / dt
    peak = torch.cuda.max_memory_allocated()
    log("main path: %d batches of %d, steady window %d batches: %.1f rows/s "
        "(%.3f s); total %.1f s; workers=%d" % (consumed, BATCH, MEASURED_BATCHES,
                                                 rows_per_s, dt, wall, workers))
    log("main path stats: " + json.dumps(snapshot))
    log("main path peak device memory: %d bytes" % peak)
    log("main path launches: %s (host-decoded rows: %d)"
        % (json.dumps(launches), codecs.host_decoded_rows()))
    decoded = launches["stage2_planes"]  # one launch a batch on the uniform path
    qtab_bytes = BATCH * 3 * 64 * 4
    full_bytes = transfer["raw"] / max(1, decoded)
    log("main path transfer: shipped/raw %d/%d = %.4f; coefficient H2D a batch %.0f bytes "
        "(+%d of tables) against %.0f of full int16; decode_s %.5f, h2d_s %.5f a batch "
        "(%d batches decoded)" % (
            transfer["shipped"], transfer["raw"], transfer["shipped"] / transfer["raw"],
            transfer["shipped"] / max(1, decoded), qtab_bytes, full_bytes,
            snapshot["decode_s"] / max(1, snapshot["batches"]),
            snapshot["h2d_s"] / max(1, snapshot["batches"]), decoded))
    # the reader's default pagedec is "off": the main path's id and label columns take
    # the classic read, as before the pass-through existed
    log("main path pass-through: %s" % json.dumps(
        {k: v - pagedec0[k] for k, v in pagedec.counter_values().items()}))
    check(launches["stage2_planes"] > 0 and launches["stage2_rgb"] > 0
          and launches["K2"] > 0, "a kernel of the path was never launched: %s" % launches)
    check(launches["stage2_planes"] == launches["stage2_rgb"] == launches["K2"],
          "stage2_planes and stage2_rgb should launch once per batch (one launch each for "
          "the three colour components): %s" % launches)
    check(launches["unpack"] == 0 and launches["K1"] == 0, "the batched path launched the "
          "standalone unpack or K1: %s" % launches)
    check(transfer["shipped"] < transfer["raw"], "the narrowed transfer shipped no less than "
          "full int16: %s" % transfer)
    check(launches["K2"] >= consumed, "fewer K2 launches than delivered batches")
    check(launches["K2_routes"]["bulk"] == launches["K2"],
          "a K2 launch of the main path missed the bulk route: %s" % launches)
    check(codecs.host_decoded_rows() == 0, "%d rows fell back to host decode on a "
          "baseline q85 corpus" % codecs.host_decoded_rows())

    # the first batch: labels, shape, pixels against host decode, normalised values
    ids = first["id"]
    check(first["u8"].shape == (BATCH,) + IMG and first["u8"].dtype == np.uint8,
          "first batch has shape %s" % (first["u8"].shape,))
    check(len(set(ids.tolist())) == BATCH, "duplicate ids in the first batch")
    check(np.array_equal(first["label"], (ids % 1000).astype(np.int32)), "labels differ")
    if cv2 is not None:
        ref = np.stack([cv2.imdecode(np.frombuffer(blobs[int(i)], np.uint8),
                                     cv2.IMREAD_UNCHANGED) for i in ids])
        what = "host cv2 decode"
    else:
        planes = [jpeg.entropy_decode_jpeg(blobs[int(i)]) for i in ids[:16]]
        ref = jpeg.decode_jpeg_batch(planes, device="cpu", bgr=True).numpy()
        first["u8"] = first["u8"][:16]
        what = "the pure-Python stage 1 + CPU stage 2"
    diff = np.abs(ref.astype(np.int32) - first["u8"].astype(np.int32))
    log("first batch vs %s: max %d, mean %.4f" % (what, diff.max(), diff.mean()))
    if cv2 is not None:
        check(diff.max() <= 4 and diff.mean() < 1.0, "decoded pixels too far from cv2")
    else:
        check(diff.max() == 0, "decoded pixels differ from the CPU path")
    # the port's CPU path on the same rows (stage 1 over the batch's own rows, so its
    # transfer variant may differ; every variant is exact)
    cpu = jpeg.decode_jpeg_batch(jpeg.entropy_decode_jpeg_batch([blobs[int(i)] for i in ids]),
                                 device="cpu", bgr=True).numpy()
    check(np.array_equal(cpu[:len(first["u8"])], first["u8"]), "the first batch differs from "
          "the port's CPU decode of the same rows")
    log("first batch equal to the port's CPU decode of the same rows (bit for bit)")
    norm_ref = image._normalize_plain(torch.from_numpy(first["u8"][:8]), MEAN, STD,
                                      torch.bfloat16).float()
    check((first["norm"] - norm_ref).abs().max().item() <= 2e-2,
          "normalised batch differs from normalising its uint8 images")
    check(torch.isfinite(first["norm"]).all().item(), "non-finite normalised values")
    return launches, {"rows_per_s": rows_per_s, "peak_bytes": peak,
                      "shipped_ratio": transfer["shipped"] / transfer["raw"]}


# -- phase 7: the process pool ---------------------------------------------------------
#
# The main path and the tabular pass-through with reader_pool_type='process': children
# run Parquet IO and stage 1 (or the page walk) in clean interpreters and answer over a
# socket ('arrow', make_batch_reader's default) or shared-memory slabs ('shm',
# 'shm-view'), against the thread pool in the same process. The JPEG runs read three
# epochs of the main-path store (48 batches: 5 warm-up, 35 measured, 8 under the
# profiler); every delivered image is held on the card against the first thread-pool
# run's image of the same id, and the thread pool runs again last, bracketing the
# order. A row group of 256 rows ships ~38.5 MB of int16 coefficients, over the 32 MB
# default slab, so the shm wires run once at the default slab and once with
# PTPU_SHM_SLAB_BYTES at POOL_SLAB_BYTES. The ring keeps its default of workers + 2
# slabs.

POOL_EPOCHS = 3
POOL_PROFILED = 8
POOL_SLAB_BYTES = 64 << 20
POOL_TAB_WARMUP, POOL_TAB_MEASURED = 10, 30


def shm_state():
    """(free bytes of /dev/shm or None, `df -B1 /dev/shm` as printed)."""
    from petastorm_tpu_torch.parallel.shm_ring import shm_free_bytes

    out = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True, text=True,
                         timeout=60)
    return shm_free_bytes(), " | ".join(out.stdout.strip().splitlines())


def port_slabs():
    import glob

    from petastorm_tpu_torch.parallel.shm_ring import SEGMENT_PREFIX

    return sorted(glob.glob("/dev/shm/%s%d_*" % (SEGMENT_PREFIX, os.getpid())))


def child_report(pids):
    """{pid: (resident MiB, libcuda mapped)} of the pool's children, from /proc."""
    out = {}
    for pid in pids:
        try:
            with open("/proc/%d/status" % pid) as f:
                rss = [int(line.split()[1]) for line in f if line.startswith("VmRSS:")]
            with open("/proc/%d/maps" % pid) as f:
                cuda = any("libcuda" in line for line in f)
        except OSError:
            continue
        out[pid] = (rss[0] / 1024.0 if rss else -1.0, cuda)
    return out


def compute_app_pids():
    """The pids nvidia-smi lists with a context on a card (as it prints them)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def profiled_busy_share(next_batch, batches):
    """Device busy share over ``batches`` calls of ``next_batch`` under torch.profiler
    (sum of device activity / wall; streams may overlap), or None when the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(batches):
            next_batch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    us = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            v = getattr(e, "self_device_time_total", None)
            us += v if v is not None else getattr(e, "self_cuda_time_total", 0)
    return (us / 1e6 / wall) if us else None


def pool_jpeg_run(url, blobs, pool, wire, slab_bytes, images, smi, fill=False, tag="",
                  io_options=None, filesystem=None):
    """One JPEG run (module comment above). ``images`` ((ROWS, 224, 224, 3) uint8 on the
    card): the first thread-pool run fills it by id (``fill``), every later run is held
    to it bit for bit. ``io_options``: the reader's read path (None: the defaults);
    the result's ``io`` is ``reader.io_stats()`` at the end of the run. ``filesystem``:
    the store's filesystem (phase 12's simulator)."""
    import numpy as np
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.io.lease import lease_stats
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image, jpeg

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    label = "%s/%s%s%s" % (pool, wire or "-", "" if slab_bytes is None
                           else " %d-byte slabs" % slab_bytes, tag)

    def transform(batch):
        return {**batch, "image": image.normalize_images(batch["image"], MEAN, STD),
                "image_u8": batch["image"]}

    with pool_env(slab_bytes):
        reader = make_batch_reader(url, reader_pool_type=pool, workers_count=workers,
                                   wire_serializer=wire, shuffle_row_groups=True, seed=0,
                                   num_epochs=POOL_EPOCHS, decode_on_device=True,
                                   io_options=io_options, filesystem=filesystem)
    executor = reader._executor
    dev = torch.device("cuda")
    counts = torch.zeros(ROWS, dtype=torch.int32, device=dev)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    leases0 = lease_stats()
    reset_transfer_state(jpeg)
    jpeg.stage2_planes_segments.launches = 0
    jpeg.stage2_rgb.launches = 0
    image.normalize_images.launches = 0
    first = None
    children = {}
    apps = None
    consumed = 0
    total = POOL_EPOCHS * ROWS // BATCH
    with DataLoader(reader, BATCH, device="cuda", device_transform=transform, prefetch=3,
                    host_queue_size=8) as loader:
        it = iter(loader)

        def take():
            nonlocal consumed, first
            batch = next(it)
            consumed += 1
            ids, u8 = batch["id"], batch["image_u8"]
            counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
            if fill:
                images.index_copy_(0, ids, u8)
            else:
                bad.add_((images.index_select(0, ids) != u8).sum())
            if first is None:
                first = {"id": ids.cpu().numpy(), "u8": u8[:32].cpu().numpy(),
                         "u8_dev": u8[:8].clone(), "norm": batch["image"][:8].clone()}

        for _ in range(WARMUP_BATCHES):
            take()
        if pool == "process":
            pids = executor.child_pids()
            children = child_report(pids)
            apps = compute_app_pids()
        torch.cuda.synchronize()
        stats0 = loader.stats.snapshot()
        t0 = time.perf_counter()
        for _ in range(MEASURED_BATCHES):
            take()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats1 = loader.stats.snapshot()
        busy = profiled_busy_share(take, POOL_PROFILED)
        for _ in range(total - consumed):
            take()
        check(next(it, None) is None, "%s: more batches than %d epochs hold" % (label,
                                                                              POOL_EPOCHS))
        wire_stats = reader.wire_stats()
        io = reader.io_stats()
        pool_stats = executor.pool_stats() if pool == "process" else {}
    torch.cuda.synchronize()
    launches = {"stage2_planes": jpeg.stage2_planes_segments.launches,
                "stage2_rgb": jpeg.stage2_rgb.launches, "K2": image.normalize_images.launches}
    leases = {k: lease_stats()[k] - leases0[k] for k in ("acquired", "released", "leaked")}
    window = {k: (stats1[k] - stats0[k]) / MEASURED_BATCHES * 1e3
              for k in ("read_s", "decode_s", "put_wait_s", "device_queue_wait_s",
                        "queue_wait_s", "batch_s", "h2d_s")}
    rows_per_s = MEASURED_BATCHES * BATCH / dt
    log("pool %s: %.1f rows/s over %d batches (%.3f s); ms a batch: %s; device busy share "
        "%s (%d profiled batches); %s" % (
            label, rows_per_s, MEASURED_BATCHES, dt,
            json.dumps({k: round(v, 3) for k, v in window.items()}),
            "%.4f" % busy if busy is not None else "not measured", POOL_PROFILED, smi))
    log("pool %s: launches %s; wire %s; leases %s" % (label, json.dumps(launches),
                                                     json.dumps(wire_stats), leases))
    if pool == "process":
        log("pool %s: start-up %s; children (pid: resident MiB, libcuda mapped) %s; "
            "nvidia-smi compute apps %s (this process %d)" % (
                label, json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                                   for k, v in pool_stats.items()}),
                {p: (round(m, 1), c) for p, (m, c) in children.items()}, apps, os.getpid()))
    # -- checks ------------------------------------------------------------------------
    c = counts.cpu()
    check(bool((c == POOL_EPOCHS).all()), "%s: ids delivered %s times, not %d each"
          % (label, sorted(set(c.tolist())), POOL_EPOCHS))
    if not fill:
        check(bad.item() == 0, "%s: %d uint8 values differ from the thread pool's images "
              "of the same ids" % (label, bad.item()))
    check(all(v > 0 for v in launches.values()), "%s: a kernel of the path was never "
          "launched: %s" % (label, launches))
    check(launches["stage2_planes"] == launches["stage2_rgb"] == launches["K2"] == total,
          "%s: stage2_planes, stage2_rgb and K2 should launch once a batch (%d): %s"
          % (label, total, launches))
    ids = first["id"]
    cpu = jpeg.decode_jpeg_batch(jpeg.entropy_decode_jpeg_batch([blobs[int(i)]
                                                                 for i in ids[:32]]),
                                 device="cpu", bgr=True).numpy()
    check(np.array_equal(cpu, first["u8"]), "%s: the first batch differs from the plain "
          "stage 2 (the port's CPU decode) of the same rows" % label)
    plain = image._normalize_plain(first["u8_dev"], MEAN, STD, torch.bfloat16)
    check(torch.equal(plain, first["norm"]), "%s: K2 differs from its plain version on "
          "the first batch" % label)
    norm_ref = image._normalize_plain(torch.from_numpy(first["u8"][:8]), MEAN, STD,
                                      torch.bfloat16).float()
    check((first["norm"].float().cpu() - norm_ref).abs().max().item() <= 2e-2,
          "%s: normalised batch further than 2e-2 from a CPU normalisation" % label)
    check(leases["leaked"] == 0 and leases["acquired"] == leases["released"],
          "%s: leases %s" % (label, leases))
    if pool == "process":
        check(children and all(not cuda for _m, cuda in children.values()),
              "%s: a child mapped libcuda (or none was found): %s" % (label, children))
        check(not set(apps) & set(children),
              "%s: nvidia-smi lists a child with a CUDA context: %s" % (label, apps))
        if wire.startswith("shm") and slab_bytes is not None:
            check(wire_stats.get("shm_items", 0) > 0, "%s: no item went through a slab "
                  "(wire %s): not an shm run" % (label, wire_stats))
    check(not port_slabs(), "%s: slabs left in /dev/shm after join: %s"
          % (label, port_slabs()))
    log("pool %s: every id %d times, images equal to the thread pool's per id, first "
        "batch equal to the plain stage 2 and K2, no slab left" % (label, POOL_EPOCHS))
    return {"rows_per_s": rows_per_s, "window_ms": window, "busy": busy,
            "wire": wire_stats, "pool": pool_stats, "launches": launches,
            "child_rss_mib": [m for m, _c in children.values()], "io": io}


@contextlib.contextmanager
def pool_env(slab_bytes):
    """``PTPU_SHM_SLAB_BYTES`` set while a reader starts its pool (None: the default)."""
    saved = os.environ.pop("PTPU_SHM_SLAB_BYTES", None)
    if slab_bytes is not None:
        os.environ["PTPU_SHM_SLAB_BYTES"] = str(slab_bytes)
    try:
        yield
    finally:
        os.environ.pop("PTPU_SHM_SLAB_BYTES", None)
        if saved is not None:
            os.environ["PTPU_SHM_SLAB_BYTES"] = saved


def check_ring_fits(slab_bytes, slabs):
    """Fail unless /dev/shm holds ``slabs`` slabs of ``slab_bytes``: a ring that does not
    fit sends every item over the socket, which is no shm run."""
    free, _df = shm_state()
    check(free is None or free >= slab_bytes * slabs, "/dev/shm has %s bytes free, less "
          "than a ring of %d slabs of %d bytes" % (free, slabs, slab_bytes))


def phase_process_pool_jpeg(url, blobs, env):
    """The JPEG runs: the thread pool, then the process pool on 'arrow', 'shm' and
    'shm-view' at the default slab, the shm wires at POOL_SLAB_BYTES (the default ring of
    workers + 2 slabs), then the thread pool again (the pools' order bracketed)."""
    import torch

    _free, df = shm_state()
    log("process pool: /dev/shm %s; %s" % (df, env["smi"]))
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    check(not port_slabs(), "slabs in /dev/shm before the phase: %s" % port_slabs())
    images = torch.zeros((ROWS,) + IMG, dtype=torch.uint8, device="cuda")
    out = {}
    check_ring_fits(POOL_SLAB_BYTES, workers + 2)
    runs = [("thread", None, None), ("process", "arrow", None), ("process", "shm", None),
            ("process", "shm-view", None), ("process", "shm", POOL_SLAB_BYTES),
            ("process", "shm-view", POOL_SLAB_BYTES), ("thread", None, None)]
    for i, (pool, wire, slab_bytes) in enumerate(runs):
        tag = " (again)" if pool == "thread" and i else ""
        res = pool_jpeg_run(url, blobs, pool, wire, slab_bytes, images, env["smi"],
                            fill=i == 0, tag=tag)
        out["%s/%s/%s%s" % (pool, wire, "default" if slab_bytes is None
                            else "%dMB" % (slab_bytes >> 20), tag)] = res
    return out, images


def phase_process_pool_tabular(root, arrays, predicted, env):
    """The tabular pass-through at a reduced depth: the thread pool, then the process
    pool on 'arrow' and 'shm-view', then the thread pool again (the pools' order bracketed,
    so a drift of the host across the phase shows)."""
    out = {}
    for pool, wire, tag in (("thread", None, ""), ("process", "arrow", ""),
                            ("process", "shm-view", ""), ("thread", None, " (again)")):
        launches, res = phase_tabular_path(
            root, arrays, predicted, warmup=POOL_TAB_WARMUP, measured=POOL_TAB_MEASURED,
            pool=pool, wire=wire)
        w = res["window"]
        name = "%s/%s%s" % (pool, wire, tag)
        log("pool tabular %s: %.1f rows/s; inflate_s %.3f, read_s %.3f ms a batch; "
            "launches %s; wire %s; %s" % (
                name, res["rows_per_s"], w["inflate_s"] / POOL_TAB_MEASURED * 1e3,
                w["read_s"] / POOL_TAB_MEASURED * 1e3, json.dumps(launches),
                json.dumps(res["wire"]), env["smi"]))
        out[name] = res
    return out


# -- phase 6: the mixed-size training feed ---------------------------------------------
#
# Raw ImageNet-style stores hold images of many sizes. 2,048 JPEG rows at q85, content
# from the corpus generator, each row's size drawn from a seed among ImageNet's common
# (h, w) = (375, 500), (500, 375), (333, 500), (500, 333) and one ragged size (359, 481)
# that is not a multiple of 16; row groups of ~256 rows, 1,024 rows a file. Read with
# make_batch_reader(decode_on_device=True) into DataLoader(batch_size=256,
# device_decode_resize=(256, 256), prefetch=3) with a two-argument device transform:
# random_crop(224, 224), color_jitter(0.4, 0.4, 0.4), normalize_and_augment(flip=True)
# to bfloat16.

MIX_ROWS, MIX_SIZES, MIX_RESIZE, MIX_CROP = 2048, ((375, 500), (500, 375), (333, 500),
                                                   (500, 333), (359, 481)), (256, 256), 224
MIX_GROUP_ROWS = 51  # a batch of 256 over five layouts


def write_mixed_store(url, cv2, rows=MIX_ROWS, seed=5):
    """The mixed-size store through the port's writer; returns {id: jpeg bytes}. The
    images are made by 8 threads (numpy releases the GIL), 256 a thread, each from its
    own seed."""
    import concurrent.futures

    import numpy as np

    from petastorm_tpu_torch import types
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.metadata import RowWriter
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema("ChipSmokeMixedSchema", [
        UnischemaField("id", np.int64, (), ScalarCodec(types.LongType()), False),
        UnischemaField("image", np.uint8, (None, None, 3),
                       CompressedImageCodec("jpeg", QUALITY), False),
        UnischemaField("label", np.int32, (), ScalarCodec(types.IntegerType()), False),
    ])
    field = schema.fields["image"]
    sizes = np.random.RandomState(seed).randint(len(MIX_SIZES), size=rows)
    chunk = 256

    def encode_chunk(c):
        out = []
        for j, size in enumerate(sizes[c * chunk:(c + 1) * chunk]):
            shape = MIX_SIZES[size] + (3,)
            img = next(make_images(1, seed=seed * 100003 + c * chunk + j, shape=shape))
            if cv2 is None:
                out.append(BaselineJpegEncoder(QUALITY).encode(img))
            else:
                out.append(bytes(field.codec.encode(field, img)))
        return out

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        blobs = [b for part in pool.map(encode_chunk, range(-(-rows // chunk))) for b in part]
    mean = sum(map(len, blobs)) / len(blobs)
    with RowWriter(url, schema, row_group_size_mb=max(1, round(256 * mean / 2 ** 20)),
                   rows_per_file=ROWS_PER_FILE) as w:
        for i, blob in enumerate(blobs):
            w.write_encoded({"id": i, "image": blob, "label": i % 1000})
    return dict(enumerate(blobs)), [MIX_SIZES[k] for k in sizes]


def phase_stage2_layouts(blobs, sizes, dev):
    """The stage-2 kernels on every layout of the mixed store: ``MIX_GROUP_ROWS`` rows of
    each size (one batch's share of a group), every transfer variant equal to the plain
    versions through both kernels; then, per layout, the device times of the two kernels,
    of the parent's composition of the same work and of the resize to 256x256, and the
    host time of the per-image stage 1 those rows take in the feed. The five layouts'
    sums are a mixed batch's split."""
    import torch

    from petastorm_tpu_torch.ops import jpeg

    split = {"stage2_ms": 0.0, "composition_ms": 0.0, "resize_ms": 0.0, "stage1_host_s": 0.0}
    for size in MIX_SIZES:
        rows = [blobs[i] for i, s in enumerate(sizes) if s == size][:MIX_GROUP_ROWS]
        t0 = time.perf_counter()
        for b in rows:
            jpeg.entropy_decode_jpeg_fast(b)
        stage1_s = time.perf_counter() - t0
        planes = jpeg.entropy_decode_jpeg_batch(rows)
        check(all(p is not None for p in planes), "stage 1 refused a mixed-store image")
        layout, variants, selected = stage2_variants(planes, dev)
        check_stage2(layout, variants, "%dx%d" % size)
        segs = variants["selected"]
        planes_out = jpeg.stage2_planes_segments(segs)
        img = jpeg.stage2_rgb(planes_out, layout)
        ms = cuda_ms(lambda: jpeg.stage2_rgb(jpeg.stage2_planes_segments(segs), layout))
        p_ms = cuda_ms(lambda: jpeg.stage2_planes_segments(segs))
        r_ms = cuda_ms(lambda: jpeg.stage2_rgb(planes_out, layout))
        c_ms = cuda_ms(lambda: parent_stage2(layout, segs))
        z_ms = cuda_ms(lambda: jpeg.resize_image_batch(img, MIX_RESIZE))
        log("stage 2 %dx%d (%s, %d rows; selected ks=%s packed=%s split=%s): %d variants "
            "equal to the plain versions; stage2_planes %.4f + stage2_rgb %.4f ms (both "
            "%.4f), the parent's composition %.4f ms, resize %.4f ms; per-image stage 1 "
            "%.4f s on one host thread" % (
                size[0], size[1], [c[:2] for c in layout[2]], len(rows), *selected,
                len(variants), p_ms, r_ms, ms, c_ms, z_ms, stage1_s))
        split["stage2_ms"] += ms
        split["composition_ms"] += c_ms
        split["resize_ms"] += z_ms
        split["stage1_host_s"] += stage1_s
    torch.cuda.synchronize()
    log("mixed batch split (%d rows of each of %d layouts): stage 2 %.4f ms of device time "
        "(the parent's composition %.4f), resize %.4f ms; per-image stage 1 %.4f s of host "
        "time on one thread" % (MIX_GROUP_ROWS, len(MIX_SIZES), split["stage2_ms"],
                                split["composition_ms"], split["resize_ms"],
                                split["stage1_host_s"]))
    return split


def phase_mixed_feed(url, blobs, sizes, device="cuda"):
    """The mixed-size store through the resize and the augmentations on the card: every
    batch (256, 224, 224, 3) bfloat16; the first batch's resized uint8 (before the
    transform) within 1 of the port's CPU path on the same rows; one stage2_planes and
    one stage2_rgb launch a layout group (no standalone unpack or K1), one K2 launch a
    batch."""
    import numpy as np
    import torch

    from petastorm_tpu_torch import codecs, make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image, jpeg

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))

    def transform(batch, gen):
        u8 = batch["image"]
        x = image.random_crop(u8, gen, MIX_CROP, MIX_CROP)
        x = image.color_jitter(x, gen, 0.4, 0.4, 0.4)
        x = image.normalize_and_augment(x, MEAN, STD, gen, flip=True)
        return {**batch, "image": x, "image_u8": u8}

    groups = [0]
    real_stage2 = jpeg._batched_stage2

    def counting_stage2(*args, **kwargs):  # one call a layout group
        groups[0] += 1
        return real_stage2(*args, **kwargs)

    reader = make_batch_reader(url, workers_count=workers, shuffle_row_groups=True, seed=1,
                               num_epochs=1, decode_on_device=True)
    reset_transfer_state(jpeg)
    codecs.per_image_stage1_rows(reset=True)
    codecs.host_decoded_rows(reset=True)
    jpeg.unpack_dequant_segments.launches = 0
    jpeg.idct_scaled_segments.launches = 0
    jpeg.stage2_planes_segments.launches = 0
    jpeg.stage2_rgb.launches = 0
    image.normalize_images.launches = 0
    jpeg._batched_stage2 = counting_stage2
    first, shapes, consumed = None, set(), 0
    t_start = time.perf_counter()
    try:
        with DataLoader(reader, BATCH, device_transform=transform, prefetch=3,
                        device_decode_resize=MIX_RESIZE, seed=2, device=device) as loader:
            for batch in loader:
                consumed += 1
                shapes.add((tuple(batch["image"].shape), batch["image"].dtype))
                if first is None:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    first = {"id": batch["id"].cpu().numpy(),
                             "u8": batch["image_u8"].cpu().numpy(),
                             "x": batch["image"][:4].float().cpu()}
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            snapshot = loader.stats.snapshot()
    finally:
        jpeg._batched_stage2 = real_stage2
    wall = time.perf_counter() - t_start
    launches = {"stage2_planes": jpeg.stage2_planes_segments.launches,
                "stage2_rgb": jpeg.stage2_rgb.launches,
                "unpack": jpeg.unpack_dequant_segments.launches,
                "K1": jpeg.idct_scaled_segments.launches,
                "K2": image.normalize_images.launches, "groups": groups[0]}
    transfer = jpeg.transfer_byte_counters()
    per_image = codecs.per_image_stage1_rows()
    rows_per_s = (consumed - 1) * BATCH / dt if consumed > 1 else float("nan")
    log("mixed feed: %d batches of %d from %d rows of sizes %s; %.1f rows/s after the "
        "first batch (%.3f s), %.1f s in all; workers=%d" % (
            consumed, BATCH, len(blobs), json.dumps(
                {"%dx%d" % s: sizes.count(s) for s in MIX_SIZES}), rows_per_s, dt, wall,
            workers))
    log("mixed feed stats: " + json.dumps(snapshot))
    log("mixed feed: shipped/raw %d/%d = %.4f; rows through the per-image stage 1: %d of "
        "%d; host-decoded rows: %d; layout groups %d (%.2f a batch); launches %s (a "
        "batch: stage2_planes %.2f, stage2_rgb %.2f, K2 %.2f)" % (
            transfer["shipped"], transfer["raw"], transfer["shipped"] / transfer["raw"],
            per_image, consumed * BATCH, codecs.host_decoded_rows(), groups[0],
            groups[0] / consumed, json.dumps(launches), launches["stage2_planes"] / consumed,
            launches["stage2_rgb"] / consumed, launches["K2"] / consumed))
    # the first batch's resized uint8 against the port's CPU path on the same rows
    from petastorm_tpu_torch.unischema import UnischemaField

    field = UnischemaField("image", np.uint8, (None, None, 3),
                           codecs.CompressedImageCodec("jpeg", QUALITY), False)
    rows = [blobs[int(i)] for i in first["id"]]
    staged = field.codec.host_stage_decode_batch(field, rows)
    cpu = field.codec.device_decode_batch(field, staged, torch.device("cpu"),
                                          resize_to=MIX_RESIZE).numpy()
    diff = np.abs(cpu.astype(np.int32) - first["u8"].astype(np.int32))
    share = float((diff > 0).mean())
    log("mixed feed first batch (resized uint8, before the transform) vs the port's CPU "
        "path on the same rows: max %d, %.6f of the values differ" % (diff.max(), share))
    check(first["u8"].shape == (BATCH,) + MIX_RESIZE + (3,), "resized batch has shape %s"
          % (first["u8"].shape,))
    check(diff.max() <= 1 and share < 0.01, "resized uint8 on the card too far from the "
          "CPU path")
    check(consumed == len(blobs) // BATCH, "mixed feed delivered %d batches" % consumed)
    check(shapes == {((BATCH, MIX_CROP, MIX_CROP, 3), torch.bfloat16)},
          "mixed feed batches have shapes %s" % shapes)
    check(launches["stage2_planes"] == launches["stage2_rgb"] == groups[0] > consumed,
          "stage2_planes and stage2_rgb should launch once a layout group: %s" % launches)
    check(launches["unpack"] == 0 and launches["K1"] == 0, "the batched path launched the "
          "standalone unpack or K1: %s" % launches)
    check(launches["K2"] == consumed, "K2 should launch once a batch: %s" % launches)
    check(torch.isfinite(first["x"]).all().item(), "non-finite values in the fed batch")
    return {"rows_per_s": rows_per_s, "launches": launches, "batches": consumed,
            "shipped_ratio": transfer["shipped"] / transfer["raw"],
            "per_image_rows": per_image}


# -- phase 5: tabular pass-through ----------------------------------------------------
#
# BASELINE.json config #3 (bench.py bench_tabular): the Criteo-1TB tabular shape, 13
# float32 dense columns, 26 int32 categorical columns and an int32 label, at 2,097,152
# rows (~1 % of one Criteo-1TB day) in 8 files of 16 row groups of 16,384 rows, snappy,
# data page v1. Dense: log1p of Zipf(1.6) counts; categorical: Zipf(1.2) modulo the
# MLPerf DLRM Criteo-1TB vocabulary sizes; label: 3.4 % positive, PLAIN (no dictionary).

TAB_FILES, TAB_RGS_PER_FILE, TAB_RG_ROWS = 8, 16, 16384
TAB_BATCH = TAB_RG_ROWS
TAB_WARMUP_BATCHES, TAB_MEASURED_BATCHES = 30, 60
CRITEO_VOCAB = (39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951, 2953546,
                403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295, 39664984,
                585935, 12972, 108, 36)
TAB_COLUMNS = ["label"] + ["i%d" % i for i in range(13)] + ["c%d" % i for i in range(26)]


def write_tabular_store(root, seed=0, files=TAB_FILES, rgs_per_file=TAB_RGS_PER_FILE,
                        rg_rows=TAB_RG_ROWS, data_page_size=None):
    """The Criteo-shaped store, from ``seed``; returns (url, [per-file {column: array}]).
    ``data_page_size``: pyarrow's page size target (None: its 1 MB default)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(root)
    rng = np.random.default_rng(seed)
    n = rgs_per_file * rg_rows
    arrays = []
    for f in range(files):
        cols = {"label": (rng.random(n) < 0.034).astype(np.int32)}
        for i in range(13):
            cols["i%d" % i] = np.log1p(rng.zipf(1.6, n).astype(np.float64)).astype(np.float32)
        for i, vocab in enumerate(CRITEO_VOCAB):
            cols["c%d" % i] = (rng.zipf(1.2, n) % vocab).astype(np.int32)
        pq.write_table(pa.table(cols), os.path.join(root, "part-%d.parquet" % f),
                       row_group_size=rg_rows, compression="snappy",
                       use_dictionary=TAB_COLUMNS[1:], data_page_version="1.0",
                       data_page_size=data_page_size)
        arrays.append(cols)
    return "file://" + root, arrays


def tabular_chunks(path, rg):
    """{column: PassthroughChunk} of one row group, through the port's walker."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.io import pagedec

    md = pq.read_metadata(path)
    rgmd = md.row_group(rg)
    out = {}
    with open(path, "rb") as f:
        for i in range(rgmd.num_columns):
            el = pagedec.classify_chunk(md, rg, i)
            check(el.eligible, "column %s is not pass-through eligible: %s"
                  % (rgmd.column(i).path_in_schema, el.reason))
            start, length = pagedec.chunk_byte_range(rgmd.column(i))
            f.seek(start)
            chunk, reason = pagedec.build_chunk(f.read(length), el, rgmd.num_rows)
            check(chunk is not None, "column %s declined the pass-through: %s"
                  % (rgmd.column(i).path_in_schema, reason))
            out[rgmd.column(i).path_in_schema] = chunk
    return out


def tabular_structure(root, files=None, rgs_per_file=None):
    """Per-batch launches and reads back to the host the path predicts (one batch = one
    row group): K3 once (one launch over every snappy page of the batch), the scan and K4
    once (one launch each over every data page); one read back to the host (K3's ok flags
    and the data pages' verdicts). Checked uniform over every row group of the store
    (``files`` x ``rgs_per_file``, by default phase 5's)."""
    shapes = set()
    for f in range(TAB_FILES if files is None else files):
        path = os.path.join(root, "part-%d.parquet" % f)
        for rg in range(TAB_RGS_PER_FILE if rgs_per_file is None else rgs_per_file):
            chunks = tabular_chunks(path, rg).values()
            shapes.add((int(any(c.codec == "SNAPPY" for c in chunks)),
                        sum(len(c.pages) + (c.dict_page is not None) for c in chunks),
                        len(chunks)))
    check(len(shapes) == 1, "row groups differ in page structure: %s" % sorted(shapes))
    k3, pages, columns = shapes.pop()
    return {"K3": k3, "scan": 1, "K4": 1, "pages": pages, "columns": columns,
            "host_reads": 1}


def _crafted_pages():
    """Corrupt snappy pages, each of which must latch ok = 0: the reference's crafted
    literal (4 length bytes, top bit set), a literal whose 31-bit length wraps a 32-bit
    bound check, a copy reaching before the output's start, and a stream whose claimed
    length it does not fill."""
    return [
        ("literal length 0xFFFFFFFF", bytes([64, 252, 0xFF, 0xFF, 0xFF, 0xFF]) + bytes(10),
         64),
        ("literal length 2^31 - 1 after a literal",
         bytes([64, 0, 7, 252, 0xFE, 0xFF, 0xFF, 0x7F]) + bytes(8), 64),
        ("copy offset past the output", bytes([16, 0, 7, 0x3D, 9]) + bytes(4), 16),
        ("stream shorter than its length", bytes([32, 8, 1, 2, 3]), 32),
    ]


def snappy_token_census(comp, comp_len):
    """Tokens of one snappy stream (host walk): literal and copy counts, the copies that
    overlap their output, the tokens shorter than 32 bytes (those K3 executes 32 output
    bytes a step; longer ones run alone), and the bytes those short tokens carry."""
    data = bytes(comp[:comp_len])
    pos = 0
    while data[pos] & 0x80:  # varint preamble
        pos += 1
    pos += 1
    census = {"literals": 0, "copies": 0, "overlapping": 0, "short": 0, "short_bytes": 0}
    while pos < len(data):
        tag = data[pos]
        t = tag & 3
        if t == 0:
            n0 = tag >> 2
            extra = n0 - 59 if n0 >= 60 else 0
            ln = (int.from_bytes(data[pos + 1:pos + 1 + extra], "little") if extra else n0) + 1
            pos += 1 + extra + ln
            census["literals"] += 1
        else:
            if t == 1:
                ln, off, size = ((tag >> 2) & 7) + 4, ((tag >> 5) << 8) | data[pos + 1], 2
            else:
                size = 3 if t == 2 else 5
                ln, off = (tag >> 2) + 1, int.from_bytes(data[pos + 1:pos + size], "little")
            pos += size
            census["copies"] += 1
            census["overlapping"] += int(off < ln)
        if ln < 32:
            census["short"] += 1
            census["short_bytes"] += ln
    return census


def _above_window_page(seed=31):
    """A 1 MiB snappy dictionary-like page (Zipf int32 values, a mix of literals and
    copies), far above K3's 66 KiB shared-memory output window: (compressed, raw)."""
    import numpy as np
    import pyarrow as pa

    raw = (np.random.default_rng(seed).zipf(1.3, 1 << 18) % 1000).astype(np.int32).tobytes()
    return pa.compress(raw, codec="snappy", asbytes=True), raw


def _varint(v):
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _crafted_streams():
    """Dictionary data pages of 10 values over a 3-value dictionary, each of which must
    latch its own reason: (what, page body, max_def, max_runs, reason code)."""
    levels = _varint(10 << 1) + b"\x01"
    level_block = len(levels).to_bytes(4, "little") + levels
    return [
        ("a good page", bytes([2, 20, 1]), 0, 10, 0),
        ("a run of no values", bytes([2, 0, 1]), 0, 10, 7),
        ("an overrun stream", level_block + bytes([2, 0x09, 0xAB, 0xCD]), 1, 10, 7),
        ("more runs than max_runs", bytes([3]) + b"".join(bytes([2, v]) for v in range(10)),
         0, 4, 7),
        ("a short stream", bytes([2, 6, 1]), 0, 10, 7),
        ("the 2^27-group header", level_block + bytes([16]) + _varint(((1 << 27) << 1) | 1)
         + bytes(range(1, 17)), 1, 10, 7),
        ("width 33", bytes([33, 20, 1, 0, 0, 0, 0]), 0, 10, 7),
        ("an out-of-range index", level_block + bytes([3, 20, 5]), 1, 10, 8),
        ("a level block past page end", (1000).to_bytes(4, "little") + bytes(8), 1, 10, 3),
        ("an empty index body", level_block, 1, 10, 6),
    ]


def _scan_sectors(r, m, runs):
    """The 32-byte sectors, as (buffer, index), of the bytes the scan must read on one
    page whose verdict is 0: the level block's length, the bit width, and each run's
    header and, for an RLE run, its value. A run starts where the one before it ends:
    after its RLE value, or after its 8 x groups packed values."""
    from petastorm_tpu_torch.ops import pagedec_kernels as pk

    spans = [(0, 4)] if r["max_def"] else []  # (first byte in the page, bytes)
    width = m[1]
    if r["enc"] != pk.ENC_VALUES_PLAIN:
        spans.append((m[0] - 1, 1))
        byte_width, start, prev_end = (width + 7) // 8, 0, 0
        for end, packed, _value, pos in (runs[r["run_off"]:r["run_off"] + m[2]].tolist()
                                          if width else []):
            spans.append((m[0] + start, pos - start + (0 if packed else byte_width)))
            start = pos + ((end - prev_end) // 8 * width if packed else byte_width)
            prev_end = end
    first = r["off"]
    return {(r["buf"], sector) for at, n in spans
            for sector in range((first + at) // 32, (first + at + n - 1) // 32 + 1)}


def phase_batched_scan_and_k4(chunks, res, dev):
    """The run scan and K4 as the path launches them, one launch each over the batch's
    data pages (every chunk of the row group read whole), against their plain versions
    (max abs error 0) and the host twin, timed; then the crafted streams through them."""
    import numpy as np
    import torch

    from petastorm_tpu_torch.io import pagedec
    from petastorm_tpu_torch.ops import pagedec_kernels as pk

    cols = {name: pagedec.PassthroughColumn.from_chunk(c) for name, c in chunks.items()}
    batch = pk.stage_batch(cols, dev)
    out, ok, runs, meta, flags, values = batch.run()
    check(bool(ok.all().item()) and not bool(flags.any().item()),
          "the batched scan or K4 rejected a valid page of the batch")
    plan = batch.plan
    cpu = [t.cpu() for t in (out, batch.stored, batch.pages, ok, batch.blocks)]
    t0 = time.perf_counter()
    p_runs, p_meta, p_flags = pk.rle_scan_pages(cpu[0], cpu[1], cpu[2], cpu[3],
                                                plan.runs_total)
    res["scan"]["plain_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    p_values = pk.extract_pages(cpu[0], cpu[1], cpu[2], cpu[4], p_runs, p_meta, p_flags,
                                plan.out_bytes)
    res["K4"]["plain_ms"] = (time.perf_counter() - t0) * 1e3
    runs_h, meta_h, values_h = runs.cpu(), meta.cpu(), values.cpu()
    scan_err = float((meta_h.long() - p_meta.long()).abs().max().item())
    n_runs = longest = 0
    stream_bytes = plain_bytes = 0
    sectors = set()  # the 32-byte sectors of the page bytes the scan must read
    for row, m in zip(plan.pages.tolist(), p_meta.tolist()):
        r = dict(zip(pk.PAGE_COLS, row))
        sectors |= _scan_sectors(r, m, p_runs)
        if r["enc"] == pk.ENC_VALUES_PLAIN:
            plain_bytes += r["num_values"] * r["item"]
            continue
        span = slice(r["run_off"], r["run_off"] + m[2])
        if m[2]:
            scan_err = max(scan_err, float((runs_h[span].long() - p_runs[span].long())
                                           .abs().max().item()))
        n_runs += m[2]
        longest = max(longest, m[2])
        stream_bytes += r["size"] - m[0]
    res["scan"]["max_abs_err"] = scan_err
    check(scan_err == 0, "the batched scan differs from its plain version")
    dict_bytes = delivered = 0
    for name, (off, n, dtype) in plan.columns.items():
        span = slice(off, off + n * dtype.itemsize)
        as_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        err = float((values_h[span].view(as_dtype).double()
                     - p_values[span].view(as_dtype).double()).abs().max().item()) if n else 0.0
        res["K4"]["max_abs_err"] = max(res["K4"]["max_abs_err"], err)
        check(values_h[span].numpy().tobytes() == p_values[span].numpy().tobytes(),
              "K4 differs from its plain version on column %s" % name)
        check(values_h[span].numpy().tobytes() == chunks[name].decode().tobytes(),
              "K4 differs from the host twin on column %s" % name)
        chunk = chunks[name]
        if chunk.dict_page is not None:
            dict_bytes += chunk.dict_page.num_values * dtype.itemsize
        delivered += n * dtype.itemsize
    res["scan"]["pages"] = len(plan.pages)
    res["scan"]["ms"] = cuda_ms(lambda: pk.rle_scan_pages(out, batch.stored, batch.pages, ok,
                                                          plan.runs_total))
    res["K4"]["ms"] = cuda_ms(lambda: pk.extract_pages(out, batch.stored, batch.pages,
                                                       batch.blocks, runs, meta, flags,
                                                       plan.out_bytes))
    n_pages = len(plan.pages)
    # the scan: the sectors of its level-block lengths, bit widths, run headers and RLE
    # values (not the bit-packed bodies it jumps over), the page table and K3's flags in;
    # the real run entries, meta and flags out. Its serial floor: the longest stream's
    # runs, one dependent L2 load each
    res["scan"]["bytes"] = 32 * len(sectors) + n_pages * (8 * len(pk.PAGE_COLS) + 16 + 4) \
        + ok.shape[0] + 16 * n_runs
    res["scan"]["serial_floor_ms"] = longest * L2_ROUND_TRIP_CYCLES / (SM_CLOCK_MHZ[0] * 1e3)
    # K4: the streams, the real run entries, the dictionaries and the PLAIN values in,
    # every delivered value out
    res["K4"]["bytes"] = stream_bytes + 16 * n_runs + dict_bytes + plain_bytes + delivered
    log("batched scan over %d data pages (%d runs, longest stream %d runs, %d stream bytes "
        "of which it reads %d sectors): %.4f ms, serial floor %.6f ms (%d runs x %d cycles "
        "at %.0f MHz); K4 over %d values in %d blocks: %.4f ms"
        % (n_pages, n_runs, longest, stream_bytes, len(sectors), res["scan"]["ms"],
                     res["scan"]["serial_floor_ms"], longest, L2_ROUND_TRIP_CYCLES,
                     SM_CLOCK_MHZ[0], delivered // 4, len(plan.blocks), res["K4"]["ms"]))

    # the whole inflate stage alone (no reader threads beside it), as the loader calls it:
    # host prep (page packing and tables into a pinned slab), one upload, the three
    # launches and the one read back
    from petastorm_tpu_torch.io.staging import PinnedStagingPool

    stager = PinnedStagingPool(num_slabs=4)
    prep = total = 0.0
    for i in range(23):
        torch.cuda.synchronize() if dev.type == "cuda" else None
        t0 = time.perf_counter()
        staged = pk.stage_batch(cols, dev, stager)
        t1 = time.perf_counter()
        del staged
        pk.inflate_columns(cols, dev, stager)
        t2 = time.perf_counter()
        if i >= 3:
            prep, total = prep + (t1 - t0) / 20, total + (t2 - t1) / 20
    stager.close()
    res["stage"] = {"prep_ms": prep * 1e3, "inflate_columns_ms": total * 1e3}
    log("inflate stage alone, one row group's 40 columns: inflate_columns %.4f ms a batch "
        "(host clock, ends in its one read back), of which host prep and upload enqueue "
        "(stage_batch) %.4f ms" % (total * 1e3, prep * 1e3))

    # the crafted streams, one page each, in one launch of each kernel: each latches its
    # own reason, equal to the plain version's
    dictionary = np.array([11, 22, 33], "<i4").tobytes()
    buf, rows = bytearray(dictionary), []
    for i, (_what, body, max_def, max_runs, _reason) in enumerate(_crafted_streams()):
        buf += bytes(-len(buf) % 16)
        rows.append(pk.page_row(buf=1, off=len(buf), size=len(body), max_def=max_def,
                                enc=pk.ENC_VALUES_DICT, num_values=10, item=4, dict_buf=1,
                                dict_n=3, run_off=16 * i, run_cap=16, max_runs=max_runs,
                                hi=10, dst=40 * i))
        buf += body
    stored = torch.from_numpy(np.frombuffer(bytes(buf), np.uint8).copy())
    table = torch.tensor(rows, dtype=torch.int64)
    blocks = torch.from_numpy(pk.block_table(rows))
    empty, no_ok = torch.empty(0, dtype=torch.uint8), torch.empty(0, dtype=torch.bool)
    got = []
    for d in (dev, torch.device("cpu")):
        c_runs, c_meta, c_flags = pk.rle_scan_pages(empty.to(d), stored.to(d), table.to(d),
                                                    no_ok.to(d), 16 * len(rows))
        c_out = pk.extract_pages(empty.to(d), stored.to(d), table.to(d), blocks.to(d),
                                 c_runs, c_meta, c_flags, 40 * len(rows))
        got.append((c_flags.cpu().tolist(), c_out.cpu()))
    want = [reason for *_x, reason in _crafted_streams()]
    check(got[0][0] == got[1][0] == want, "crafted streams latched %s, plain %s, expected %s"
          % (got[0][0], got[1][0], want))
    check(torch.equal(got[0][1], got[1][1]), "K4 differs from its plain version on the "
          "crafted streams")
    log("crafted streams through the batched scan and K4: %s"
        % "; ".join("%s -> %s" % (w, pk.REASONS.get(r, "ok"))
                    for (w, _b, _m, _x, _r), r in zip(_crafted_streams(), got[0][0])))


def phase_tabular_kernels(root, dev=None):
    """K3 as ONE launch over one batch's real pages (file 0, row group 0) against the
    host twin and its plain version, timed; the crafted corrupt pages and a page above
    K3's shared-memory window; then the scan and K4 on the batch's streams."""
    import numpy as np
    import torch

    from petastorm_tpu_torch.io import pagedec
    from petastorm_tpu_torch.ops import pagedec_kernels as pk

    dev = dev or torch.device("cuda")
    chunks = tabular_chunks(os.path.join(root, "part-0.parquet"), 0)
    res = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "max_abs_err": 0.0}
           for k in ("K3", "scan", "K4")}
    groups = [(chunk, ([chunk.dict_page] if chunk.dict_page is not None else [])
               + list(chunk.pages)) for chunk in chunks.values()]
    layout, src_np, table_np = pk.pack_ragged(groups)
    src_cpu, table_cpu = torch.from_numpy(src_np), torch.from_numpy(table_np)
    src, table = src_cpu.to(dev), table_cpu.to(dev)
    out, ok = pk.snappy_inflate_ragged(src, table, layout.out_bytes)
    check(bool(ok.all().item()), "K3 latched ok=0 on a valid page of the batch")
    t0 = time.perf_counter()
    plain_out, plain_ok = pk.snappy_inflate_ragged(src_cpu, table_cpu, layout.out_bytes)
    res["K3"]["plain_ms"] = (time.perf_counter() - t0) * 1e3
    host_out = out.cpu().numpy()
    n_pages = len(table_np)
    k3_outputs = {}
    census = []
    for g, (name, (chunk, pages)) in enumerate(zip(chunks, groups)):
        matrix = layout.matrix(out, g)
        for i, p in enumerate(pages):  # every page against the host twin (pyarrow snappy)
            payload = chunk.buf[p.payload_offset:p.payload_offset + p.comp_size]
            want = np.zeros(layout.matrices[g][3], np.int16)
            want[:p.uncomp_size] = np.frombuffer(pagedec._decompress_page(
                chunk.codec, payload, p.uncomp_size), np.uint8)
            err = int(np.abs(matrix[i].cpu().numpy().astype(np.int16) - want).max())
            res["K3"]["max_abs_err"] = max(res["K3"]["max_abs_err"], float(err))
            check(err == 0, "K3 differs from the host twin on column %s page %d" % (name, i))
            census.append((snappy_token_census(np.frombuffer(payload, np.uint8),
                                               p.comp_size), name, i, p.uncomp_size))
        k3_outputs[name] = (chunk, pages, matrix)
    for src_off, _sl, _cl, dst_off, cap in table_np.tolist():
        span = slice(dst_off, dst_off + cap)
        err = int(np.abs(host_out[span].astype(np.int16)
                         - plain_out[span].numpy().astype(np.int16)).max())
        res["K3"]["max_abs_err"] = max(res["K3"]["max_abs_err"], float(err))
    check(res["K3"]["max_abs_err"] == 0 and torch.equal(ok.cpu(), plain_ok),
          "K3 differs from its plain version on the batch's pages")
    res["K3"]["ms"] = cuda_ms(lambda: pk.snappy_inflate_ragged(src, table, layout.out_bytes))
    # the bytes K3 must move: each page's compressed bytes and its page-table row in,
    # its decoded bytes and its ok flag out
    res["K3"]["bytes"] = sum(p.comp_size + 8 * pk.PAGE_TABLE_COLS + p.uncomp_size + 4
                             for _c, pages in groups for p in pages)
    longest = max(census, key=lambda c: c[0]["literals"] + c[0]["copies"])
    res["K3"]["longest_tokens"] = longest[0]["literals"] + longest[0]["copies"]
    # K3's serial floor: the longest page's tokens, one shared-memory round trip each
    res["K3"]["serial_floor_ms"] = (res["K3"]["longest_tokens"] * SMEM_ROUND_TRIP_CYCLES
                                    / (SM_CLOCK_MHZ[0] * 1e3))
    log("K3 one launch over %d pages (%d columns): %.4f ms; longest page column %s page %d "
        "(%d bytes), tokens %s; serial floor %.4f ms (%d tokens x %d cycles at %.0f MHz)"
        % (n_pages, len(groups), res["K3"]["ms"], longest[1], longest[2], longest[3],
           json.dumps(longest[0]), res["K3"]["serial_floor_ms"],
           res["K3"]["longest_tokens"], SMEM_ROUND_TRIP_CYCLES, SM_CLOCK_MHZ[0]))

    # crafted corruption and the page above the shared-memory window, in one launch:
    # K3 == plain, ok flags included; the large page == the host twin
    big_comp, big_raw = _above_window_page()
    spans = [(np.frombuffer(c, np.uint8), n) for _w, c, n in _crafted_pages()]
    spans.append((np.frombuffer(big_comp, np.uint8), len(big_raw)))
    rows, parts, src_off, dst_off = [], [], 0, 0
    for a, cap in spans:
        rows.append((src_off, len(a), len(a), dst_off, cap))
        parts.append(np.pad(a, (0, -len(a) % 16)))
        src_off += len(parts[-1])
        dst_off += -(-cap // 16) * 16
    c_src = torch.from_numpy(np.concatenate(parts))
    c_table = torch.tensor(rows, dtype=torch.int64)
    c_out, c_ok = pk.snappy_inflate_ragged(c_src.to(dev), c_table.to(dev), dst_off)
    c_plain, c_plain_ok = pk.snappy_inflate_ragged(c_src, c_table, dst_off)
    c_host = c_out.cpu()
    for (what, _c, _n), row, flag in zip(_crafted_pages(), rows, c_ok.tolist()):
        check(not flag, "K3 did not latch ok=0 on a crafted page: %s" % what)
    check(torch.equal(c_ok.cpu(), c_plain_ok) and all(
        torch.equal(c_host[r[3]:r[3] + r[4]], c_plain[r[3]:r[3] + r[4]]) for r in rows),
          "K3 differs from its plain version on the crafted and above-window pages")
    big = rows[-1]
    twin = pagedec._decompress_page("SNAPPY", big_comp, len(big_raw))
    check(bool(c_ok[-1].item()) and c_host[big[3]:big[3] + big[4]].numpy().tobytes()
          == bytes(twin) == big_raw, "K3 differs from the host twin on the page above the "
          "shared-memory window")
    big_table = c_table[-1:].clone()
    big_table[0, 0], big_table[0, 3] = 0, 0
    big_src = torch.from_numpy(np.frombuffer(big_comp, np.uint8).copy()).to(dev)
    big_ms = cuda_ms(lambda: pk.snappy_inflate_ragged(big_src, big_table.to(dev),
                                                      len(big_raw)), iters=5)
    log("K3 crafted pages latched ok=0: %s; the %d-byte page above the shared-memory "
        "window (%d compressed) equals the host twin, %.4f ms alone"
        % ("; ".join(w for w, _c, _n in _crafted_pages()), len(big_raw), len(big_comp),
           big_ms))
    # bit flips of a real page through the padded entry: K3 == plain, ok flags included
    chunk, pages, _out = k3_outputs["c0"]
    comp_np, meta_np, out_cap = pk._pack_pages(chunk, pages)
    rng = np.random.default_rng(5)
    flips = 0
    for _ in range(16):
        bad = comp_np.copy()
        row = int(rng.integers(0, len(pages)))
        pos = int(rng.integers(0, meta_np[row, 0]))
        bad[row, pos] ^= np.uint8(1 << int(rng.integers(0, 8)))
        b_out, b_ok = pk.snappy_inflate_pages(torch.from_numpy(bad).to(dev),
                                              torch.from_numpy(meta_np).to(dev), out_cap)
        p_out, p_ok = pk.snappy_inflate_pages(torch.from_numpy(bad),
                                              torch.from_numpy(meta_np), out_cap)
        check(torch.equal(b_out.cpu(), p_out) and torch.equal(b_ok.cpu(), p_ok),
              "K3 differs from its plain version on a bit-flipped page")
        flips += int(not bool(b_ok.all().item()))
    log("K3 bit flips: %d of 16 bit-flipped pages latched ok=0, all equal to the plain "
        "version" % flips)

    phase_batched_scan_and_k4(chunks, res, dev)
    for k in ("K3", "scan", "K4"):
        res[k]["bound_ms"], res[k]["bound_by"] = bound(res[k]["bytes"], 0)
    log("tabular kernels on file 0 row group 0 (%d columns, %d pages): K3 equal to the host "
        "twin and to its plain version on every page; scan and K4 (one launch each over "
        "the %d data pages) equal to their plain versions and the host twin"
        % (len(chunks), n_pages, res["scan"]["pages"]))
    for k in ("K3", "scan", "K4"):
        r = res[k]
        log("%s per batch: kernel_ms=%.4f plain_ms=%.4f bound_ms=%.6f (%s) "
            "roofline_share=%.4f bytes=%d" % (k, r["ms"], r["plain_ms"], r["bound_ms"],
                                              r["bound_by"], r["bound_ms"] / r["ms"],
                                              r["bytes"]))
    return res


def _rowgroup_of(first_row, arrays, rg_rows):
    """(file, row group) whose first row equals ``first_row`` ({column: value})."""
    for f, cols in enumerate(arrays):
        for start in range(0, len(cols["label"]), rg_rows):
            if all(cols[c][start] == v for c, v in first_row.items()):
                return f, start // rg_rows
    raise PhaseFailed("a delivered batch matches no row group of the store")


def _off_read(root, f, rg):
    """Row group ``rg`` of file ``f`` through the classic read (``pagedec="off"``)."""
    from petastorm_tpu_torch import make_batch_reader

    url = "file://" + os.path.join(root, "part-%d.parquet" % f)
    with make_batch_reader(url, reader_pool_type="dummy", shuffle_row_groups=False,
                           io_options={"pagedec": "off"}) as r:
        for i, batch in enumerate(r):
            if i == rg:
                return batch._asdict()
    raise PhaseFailed("row group %d of file %d not found" % (rg, f))


def phase_tabular_path(root, arrays, predicted, device="cuda", warmup=TAB_WARMUP_BATCHES,
                       measured=TAB_MEASURED_BATCHES, batch_size=TAB_BATCH, pool="thread",
                       wire=None, io_options=None, filesystem=None, trace=None,
                       metrics=None, slos=None, probe=None, on_batch=None,
                       provenance=None, transport=None):
    """``make_batch_reader(io_options={"pagedec": "auto"})`` → ``DataLoader`` on the
    card: counts zeroed just before, read just after; the first and last measured
    batches against a ``pagedec="off"`` read of their row groups and the source arrays.
    ``pool``/``wire``: the reader's pool and the process pool's wire (then also no lease
    leaked and no slab left). ``io_options``: more read-path fields beside ``pagedec``
    (the result's ``io`` is ``reader.io_stats()`` at the end of the window).
    ``filesystem``: the store's filesystem (phase 12's simulator). ``trace`` and
    ``metrics``: the loader's recorder and registry (phase 13 (d)); each batch's
    consumer step is then a ``train.step`` span, and the result carries the registry's
    snapshot and the loader's bottleneck report, both taken before the loader exits.
    ``slos``: the loader's SLO specs (phase 14 (d)); ``probe(loader, reader)`` runs inside
    the loader's block after the window, its result under ``probe``; ``on_batch(n)`` is
    called with the consumer's count after each batch it takes. ``provenance``: the
    reader factory's (phase 15 (a)). ``transport``: the process pool's wire (phase 19
    (b))."""
    import numpy as np
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.io import pagedec
    from petastorm_tpu_torch.io.lease import lease_stats
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import pagedec_kernels as pk

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    leases0 = lease_stats()  # before the reader: a thread pool reads from its start
    reader = make_batch_reader("file://" + root, workers_count=workers,
                               shuffle_row_groups=True, seed=0, num_epochs=None,
                               io_options={"pagedec": "auto", **(io_options or {})},
                               reader_pool_type=pool, wire_serializer=wire,
                               filesystem=filesystem, provenance=provenance,
                               transport=transport)
    counters0 = pagedec.counter_values()
    reads0 = pk.HOST_READS.value
    pk.snappy_inflate_ragged.launches = 0
    pk.rle_scan_pages.launches = 0
    pk.extract_pages.launches = 0
    kept = []
    consumed = 0
    t_start = time.perf_counter()
    probed = None
    with DataLoader(reader, batch_size, device=device, prefetch=3, host_queue_size=8,
                    trace=trace, metrics=metrics, slos=slos) as loader:
        for batch in loader:
            with trace.span("train.step") if trace is not None else contextlib.nullcontext():
                consumed += 1
                if on_batch is not None:
                    on_batch(consumed)
                if consumed == warmup:
                    torch.cuda.synchronize() if device == "cuda" else None
                    t0 = time.perf_counter()
                    stats0 = loader.stats.snapshot()
                if consumed in (warmup + 1, warmup + measured):
                    kept.append({k: v.cpu().numpy() for k, v in batch.items()})
                if consumed == warmup + measured:
                    torch.cuda.synchronize() if device == "cuda" else None
                    dt = time.perf_counter() - t0
                    stats1 = loader.stats.snapshot()
                    break
        wire_stats = reader.wire_stats()
        io = reader.io_stats()
        snap = metrics.snapshot() if metrics is not None else None
        report = loader.bottleneck_report()
        if probe is not None:
            probed = probe(loader, reader)
    launches = {"K3": pk.snappy_inflate_ragged.launches, "scan": pk.rle_scan_pages.launches,
                "K4": pk.extract_pages.launches}
    leases = {k: lease_stats()[k] - leases0[k] for k in ("acquired", "released", "leaked")}
    counters = {k: v - counters0[k] for k, v in pagedec.counter_values().items()}
    host_reads = pk.HOST_READS.value - reads0
    wall = time.perf_counter() - t_start
    window = {k: stats1[k] - stats0[k] for k in ("rows", "batches", "read_s", "batch_s",
                                                 "put_wait_s", "decode_s", "h2d_s",
                                                 "inflate_s", "queue_wait_s",
                                                 "device_queue_wait_s")}
    rows_per_s = measured * batch_size / dt
    passthrough_batches = counters["pages"] // predicted["pages"]
    log("tabular path (%s pool%s): %d batches of %d, steady window %d batches: %.1f rows/s "
        "(%.3f s); total %.1f s; workers=%d" % (
            pool, ", wire %s" % wire if wire else "", consumed, batch_size, measured,
            rows_per_s, dt, wall, workers))
    log("tabular window stats: " + json.dumps(window))
    log("tabular launches: %s for %d pass-through batches (predicted per batch: %s); "
        "pagedec counters: %s; reads back to the host: %d (%.1f per pass-through batch)"
        % (json.dumps(launches), passthrough_batches, json.dumps(predicted),
           json.dumps(counters), host_reads, host_reads / max(1, passthrough_batches)))
    raw = passthrough_batches * batch_size * 4 * predicted["columns"]
    log("tabular bytes: %d compressed shipped for %d raw (%.4f of raw), %d columns "
        "through the pass-through, %d fell back" % (
            counters["bytes_compressed"], raw, counters["bytes_compressed"] / max(1, raw),
            predicted["columns"], counters["fallback_columns"]))
    check(all(v > 0 for v in launches.values()), "a kernel of the tabular path was never "
          "launched: %s" % launches)
    check(counters["pages"] % predicted["pages"] == 0, "pages shipped (%d) are not whole "
          "batches of %d" % (counters["pages"], predicted["pages"]))
    for k in ("K3", "scan", "K4"):
        check(launches[k] == predicted[k] * passthrough_batches,
              "%s launched %d times, the path predicts %d per batch x %d batches"
              % (k, launches[k], predicted[k], passthrough_batches))
    check(passthrough_batches >= measured, "only %d batches went through the pass-through"
          % passthrough_batches)
    check(host_reads == predicted["host_reads"] * passthrough_batches,
          "%d reads back to the host, the path predicts %d per batch x %d batches"
          % (host_reads, predicted["host_reads"], passthrough_batches))
    check(counters["host_inflate_columns"] == 0, "%d columns were inflated on the host"
          % counters["host_inflate_columns"])
    check(counters["fallback_columns"] == 0, "%d columns fell back to the classic read"
          % counters["fallback_columns"])
    check(leases["leaked"] == 0 and leases["acquired"] == leases["released"],
          "leases of the tabular run: %s" % leases)
    if pool == "process":
        check(not port_slabs(), "slabs left in /dev/shm after join: %s" % port_slabs())
    for which, got in zip(("first", "last"), kept):
        check(sorted(got) == sorted(TAB_COLUMNS), "batch columns %s" % sorted(got))
        f, rg = _rowgroup_of({c: got[c][0] for c in TAB_COLUMNS}, arrays, batch_size)
        off = _off_read(root, f, rg)
        for c in TAB_COLUMNS:
            src = arrays[f][c][rg * batch_size:(rg + 1) * batch_size]
            check(got[c].dtype == off[c].dtype == src.dtype and got[c].shape == src.shape,
                  "column %s: %s %s, off read %s, source %s"
                  % (c, got[c].dtype, got[c].shape, off[c].dtype, src.dtype))
            check(got[c].tobytes() == off[c].tobytes() == src.tobytes(),
                  "column %s of the %s measured batch differs from the pagedec=off read"
                  % (c, which))
        log("tabular %s measured batch (file %d, row group %d): byte-identical to the "
            "pagedec=off read and the source arrays in all %d columns"
            % (which, f, rg, len(TAB_COLUMNS)))
    return launches, {"rows_per_s": rows_per_s, "window": window, "counters": counters,
                      "wire": wire_stats, "leases": leases, "launches": launches,
                      "io": io, "passthrough_batches": passthrough_batches,
                      "consumed": consumed, "metrics": snap, "bottleneck": report,
                      "probe": probed}


# -- phase 8: the click-through training feed ------------------------------------------
#
# BASELINE.json config #3 as a DLRM-style trainer consumes it: phase 5's Criteo-shaped
# store through the compressed-page pass-through, the device shuffle ring and a
# declarative FeaturePipeline(device=True) modelled on the MLPerf DLRM preprocessing of
# Criteo (standardised dense features with gaps filled, categoricals hashed into the
# MLPerf vocabulary sizes, one quantile-bucketised dense feature, one vocabulary-mapped
# categorical, one crossed pair). Every output takes a new name, so the raw columns
# travel along and identify each row (a 64-bit key a row over its 40 raw words, computed
# on the card). (a) the feed at batches of 16,384 through a ring of 131,072 rows
# (~21 MB), beside a phase-5-style run in the same process, then one whole epoch held
# row by row to the store and to the port's host target; (b) the same pipeline as the
# reader's transform_spec (the pass-through off, as the JAX package rules); (c) the JPEG
# main path through a ring of 1,024 decoded images (~154 MB).

FEED_BATCH, FEED_CAPACITY = TAB_BATCH, 131072
FEED_WARMUP, FEED_MEASURED = 10, 30
FEED_B_BATCHES = 4
FEED_JPEG_CAPACITY = 1024
FEED_BUCKETIZED, FEED_VOCAB, FEED_CROSS = "i1", "c2", ("c3", "c4")


def feed_pipeline(tab, device=True):
    """The DLRM-style pipeline over TAB_COLUMNS (module ``tab``: the port's
    ``ops.tabular``); statistics-dependent ops resolve through ``resolve_statistics``."""
    ops = []
    for i in range(13):
        ops += [tab.Standardize("i%d" % i, out="dense%d" % i),
                tab.FillNull("dense%d" % i, 0.0)]
    ops += [tab.HashField("c%d" % i, v, out="cat%d" % i) for i, v in enumerate(CRITEO_VOCAB)]
    ops += [tab.Bucketize(FEED_BUCKETIZED, num_buckets=16, out="%s_bucket" % FEED_BUCKETIZED),
            tab.VocabLookup(FEED_VOCAB, max_size=1000, out="%s_vocab" % FEED_VOCAB),
            tab.FeatureCross(FEED_CROSS, 1 << 20, out="%s_x_%s" % FEED_CROSS)]
    return tab.FeaturePipeline(ops, device=device)


def row_keys(cols):
    """A 64-bit key a row over the 40 raw columns (float32 by its bits), on the columns'
    device: the multiset identity of the rows."""
    import torch

    key = None
    for name in TAB_COLUMNS:
        c = cols[name]
        w = (c.view(torch.int32) if c.dtype == torch.float32 else c).to(torch.int64)
        key = w if key is None else key * 1000003 + w  # wraps in int64 alike everywhere
    return key


def _ulps(a, b):
    """Largest distance in float32 units in the last place between two arrays."""
    import numpy as np

    def ordered(x):
        i = np.ascontiguousarray(x, dtype=np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(ordered(a) - ordered(b)).max()) if len(a) else 0


def check_against_host_target(batch, host_pipe):
    """Every derived column of a delivered batch against the port's host target on the
    batch's own raw rows: ids exact, floats within 1 ulp; the bucket ids exact against
    float32 comparisons (the device target's, as the JAX package's) and counted where
    they differ from the host target's float64 ones. Returns (max ulps, bucket ids that
    differ from the float64 comparison)."""
    import numpy as np

    got = {k: v.cpu().numpy() for k, v in batch.items()}
    host = host_pipe.apply_columns({c: got[c] for c in TAB_COLUMNS})
    worst = differ = 0
    bucket = "%s_bucket" % FEED_BUCKETIZED
    for stage in host_pipe._plan:
        name = stage.out
        a, b = got[name], host[name]
        check(a.shape == b.shape, "derived %s has shape %s, host %s" % (name, a.shape,
                                                                        b.shape))
        if name == bucket:
            bounds = stage.op.boundaries.astype(np.float32)
            f32 = np.searchsorted(bounds, got[FEED_BUCKETIZED].astype(np.float32),
                                  side="right")
            check(np.array_equal(a, f32), "%s differs from float32 searchsorted" % name)
            differ = int((a != b).sum())
        elif a.dtype.kind == "f":
            check(a.dtype == np.float32, "derived %s is %s, not float32" % (name, a.dtype))
            worst = max(worst, _ulps(a, b))
        else:
            check(a.dtype == np.int32, "derived %s is %s, not int32" % (name, a.dtype))
            check(np.array_equal(a, b.astype(np.int64)), "derived %s differs from the "
                  "host target" % name)
    check(worst <= 1, "a derived float is %d ulps from the host target" % worst)
    return worst, differ


def _feed_reader(root, pool_kw):
    from petastorm_tpu_torch import make_batch_reader

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    return make_batch_reader("file://" + root, workers_count=workers,
                             shuffle_row_groups=True, seed=0,
                             io_options={"pagedec": "auto"}, **pool_kw)


def phase_feed_tabular(root, arrays, predicted, smi, device="cuda"):
    """(a) and (b) (module comment above). Returns the printed numbers."""
    import numpy as np
    import torch

    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.io import pagedec
    from petastorm_tpu_torch.io.statscache import resolve_statistics
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.metadata import infer_or_load_unischema, load_row_groups
    from petastorm_tpu_torch.ops import pagedec_kernels as pk
    from petastorm_tpu_torch.ops import tabular as tab
    from petastorm_tpu_torch.ops.device_shuffle import DeviceShuffleBuffer

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    # the statistics, once, over the store (phase 5's pieces)
    fs, path = get_filesystem_and_path_or_paths("file://" + root)
    pieces = load_row_groups(fs, path)
    schema = infer_or_load_unischema(fs, path)
    pipe = feed_pipeline(tab)
    t0 = time.perf_counter()
    stats, sources = resolve_statistics(pipe.required_statistics(schema), fs, pieces)
    stats_s = time.perf_counter() - t0
    pipe.compile(schema, statistics=stats)
    host_pipe = feed_pipeline(tab, device=False).compile(schema, statistics=stats)
    by_source = {}
    for key, src in sources.items():
        by_source.setdefault(src, []).append(key)
    log("feed statistics: %d keys in %.3f s, by source %s" % (
        len(sources), stats_s, json.dumps({k: len(v) for k, v in by_source.items()})))
    log("feed statistics sources: %s" % json.dumps(sources, sort_keys=True))

    # the phase-5-style run beside it, in the same process: no ring, no pipeline
    _launches, plain = phase_tabular_path(root, arrays, predicted, device=device,
                                          warmup=FEED_WARMUP, measured=FEED_MEASURED)
    store = {c: torch.from_numpy(np.concatenate([a[c] for a in arrays])).to(dev)
             for c in TAB_COLUMNS}
    store_keys = torch.sort(row_keys(store)).values
    del store
    n_store = len(store_keys)
    check(bool((store_keys[1:] != store_keys[:-1]).all().item()),
          "two rows of the store share a key")

    def zero_counts():
        pk.snappy_inflate_ragged.launches = 0
        pk.rle_scan_pages.launches = 0
        pk.extract_pages.launches = 0
        return pagedec.counter_values(), pk.HOST_READS.value

    def read_counts(counters0, reads0):
        launches = {"K3": pk.snappy_inflate_ragged.launches,
                    "scan": pk.rle_scan_pages.launches, "K4": pk.extract_pages.launches}
        counters = {k: v - counters0[k] for k, v in pagedec.counter_values().items()}
        return launches, counters, pk.HOST_READS.value - reads0

    def check_launches(what, launches, counters, host_reads, least):
        batches = counters["pages"] // predicted["pages"]
        check(counters["pages"] % predicted["pages"] == 0, "%s: pages shipped (%d) are "
              "not whole batches of %d" % (what, counters["pages"], predicted["pages"]))
        check(batches >= least, "%s: only %d batches went through the pass-through"
              % (what, batches))
        for k in ("K3", "scan", "K4"):
            check(launches[k] == predicted[k] * batches, "%s: %s launched %d times for "
                  "%d pass-through batches" % (what, k, launches[k], batches))
        check(host_reads == predicted["host_reads"] * batches, "%s: %d reads back to the "
              "host for %d batches" % (what, host_reads, batches))
        check(counters["host_inflate_columns"] == 0 and counters["fallback_columns"] == 0,
              "%s: host-inflated or fallen-back columns: %s" % (what, counters))
        return batches

    # (a) the feed, measured
    derived = [s.out for s in pipe._plan]
    counts0 = zero_counts()
    raws = []  # the delivered raw columns, keyed after the window: the consumer stays idle
    first = None
    consumed = 0
    with DataLoader(_feed_reader(root, {"num_epochs": None}), FEED_BATCH, device=device,
                    prefetch=3, host_queue_size=8, device_transform=pipe,
                    device_shuffle_capacity=FEED_CAPACITY, seed=0) as loader:
        for batch in loader:
            consumed += 1
            raws.append({c: batch[c] for c in TAB_COLUMNS})
            if first is None:
                first = {k: v.clone() for k, v in batch.items()}
            if consumed == FEED_WARMUP:
                sync()
                t0 = time.perf_counter()
                stats0 = loader.stats.snapshot()
            if consumed == FEED_WARMUP + FEED_MEASURED:
                sync()
                dt = time.perf_counter() - t0
                stats1 = loader.stats.snapshot()
                break
    feed_launches, counters, host_reads = read_counts(*counts0)
    rows_per_s = FEED_MEASURED * FEED_BATCH / dt
    window = {k: (stats1[k] - stats0[k]) / FEED_MEASURED * 1e3
              for k in ("read_s", "inflate_s", "h2d_s", "queue_wait_s",
                        "device_queue_wait_s", "put_wait_s")}
    keys = torch.cat([row_keys(r) for r in raws])
    del raws
    distinct = len(torch.unique(keys))
    known = bool(torch.isin(keys, store_keys).all().item())
    # batches read before the loader adopted the reader ("auto" engages at adoption)
    # take the classic read, as in phase 5
    transferred = check_launches("feed", feed_launches, counters, host_reads,
                                 FEED_MEASURED)
    log("feed (a): %.1f rows/s over %d batches of %d (%.3f s) through a ring of %d rows, "
        "beside %.1f rows/s without ring and pipeline; ms a batch %s; %s" % (
            rows_per_s, FEED_MEASURED, FEED_BATCH, dt, FEED_CAPACITY, plain["rows_per_s"],
            json.dumps({k: round(v, 3) for k, v in window.items()}), smi))
    log("feed (a): launches %s for %d transferred batches; reads back to the host %d; "
        "pagedec counters %s; %d rows delivered, %d distinct, all in the store: %s" % (
            json.dumps(feed_launches), transferred, host_reads, json.dumps(counters),
            len(keys), distinct, known))
    check(distinct == len(keys) == consumed * FEED_BATCH, "a row was delivered twice "
          "(%d distinct of %d)" % (distinct, len(keys)))
    check(known, "a delivered row is not a row of the store")
    check(sorted(first) == sorted(TAB_COLUMNS + derived), "feed batch columns %s"
          % sorted(first))

    # the ring's exchange and the pipeline's device time a batch, at this phase's shapes
    raw = {c: first[c] for c in TAB_COLUMNS}
    ring = DeviceShuffleBuffer(FEED_CAPACITY, seed=1)
    while ring.push(raw) is None:
        pass
    exchange_ms, exchange_us = timing(lambda: ring.push(raw))
    pipe_ms, pipe_us = timing(lambda: pipe._device_call(raw))
    ring_bytes = ring.nbytes
    del ring
    log("feed (a): the ring's exchange %.4f ms of device time a batch (%.1f us host "
        "enqueue), %d bytes resident; the pipeline %.4f ms of device time a batch "
        "(%.1f us host enqueue), %d stages; %s" % (
            exchange_ms, exchange_us, ring_bytes, pipe_ms, pipe_us, len(pipe._plan), smi))
    again = pipe._device_call(raw)
    for name in derived:
        check(torch.equal(again[name], first[name]), "the pipeline on the first batch's "
              "raw rows differs from the delivered %s" % name)

    # (a) one whole epoch: every row once, every derived column against the host target
    counts0 = zero_counts()
    keys = []
    worst = differ = rows = 0
    t0 = time.perf_counter()
    with DataLoader(_feed_reader(root, {"num_epochs": 1}), FEED_BATCH, device=device,
                    prefetch=3, host_queue_size=8, device_transform=pipe,
                    device_shuffle_capacity=FEED_CAPACITY, seed=1) as loader:
        for batch in loader:
            keys.append(row_keys(batch))
            w, d = check_against_host_target(batch, host_pipe)
            worst, differ, rows = max(worst, w), differ + d, rows + FEED_BATCH
    epoch_s = time.perf_counter() - t0
    epoch_launches, counters, host_reads = read_counts(*counts0)
    epoch_batches = check_launches("epoch", epoch_launches, counters, host_reads,
                                   FEED_MEASURED)
    keys = torch.sort(torch.cat(keys)).values
    check(torch.equal(keys, store_keys), "one epoch through the ring is not the store's "
          "rows exactly once (%d rows delivered of %d)" % (len(keys), n_store))
    log("feed (a) epoch: %d rows, each row of the store exactly once (%d of %d batches "
        "through the pass-through, %.1f s with the host checks); every derived column equal to the host target (ids "
        "exact, floats within %d ulp); %s bucket ids of %d differ from the host's float64 "
        "comparison and all equal the float32 one; launches %s" % (
            len(keys), epoch_batches, n_store // FEED_BATCH, epoch_s, worst, differ, rows,
            json.dumps(epoch_launches)))

    # (b) the same pipeline as the reader's transform_spec: the pass-through is off
    spec = feed_pipeline(tab)
    counts0 = zero_counts()
    got = []
    with DataLoader(_feed_reader(root, {"num_epochs": None, "transform_spec": spec}),
                    FEED_BATCH, device=device, prefetch=3, host_queue_size=8) as loader:
        for batch in loader:
            got.append(batch)
            if len(got) == FEED_B_BATCHES:
                break
    launches, counters, host_reads = read_counts(*counts0)
    log("feed (b): transform_spec statistics %s; launches %s; pagedec counters %s" % (
        json.dumps(spec.stats_info, sort_keys=True), json.dumps(launches),
        json.dumps(counters)))
    check(counters["pages"] == 0 and counters["bytes_compressed"] == 0 and
          not any(launches.values()), "a transform_spec read shipped compressed pages: "
          "%s %s" % (counters, launches))
    for batch in got:
        check(sorted(batch) == sorted(TAB_COLUMNS + derived), "feed (b) batch columns %s"
              % sorted(batch))
        ref = pipe._device_call({c: batch[c] for c in TAB_COLUMNS})
        for name in derived:
            check(torch.equal(batch[name], ref[name]), "feed (b): %s differs from (a)'s "
                  "pipeline on the same rows" % name)
    log("feed (b): %d batches, 0 compressed pages shipped, every derived column equal to "
        "(a)'s pipeline on the same rows" % len(got))
    return {"rows_per_s": rows_per_s, "plain_rows_per_s": plain["rows_per_s"],
            "exchange_ms": exchange_ms, "pipeline_ms": pipe_ms, "window_ms": window,
            "launches": feed_launches, "transferred": transferred,
            "epoch_launches": epoch_launches, "b_launches": launches,
            "sources": by_source, "bucket_differ": differ}


def phase_feed_jpeg(url, images):
    """(c): the main path with a ring of FEED_JPEG_CAPACITY decoded images, one epoch;
    ``images`` ((ROWS, 224, 224, 3) uint8 on the card, by id) from phase 7's first
    thread-pool run, which had no ring."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image, jpeg

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))

    def transform(batch):
        return {**batch, "image": image.normalize_images(batch["image"], MEAN, STD),
                "image_u8": batch["image"]}

    reader = make_batch_reader(url, workers_count=workers, shuffle_row_groups=True, seed=0,
                               num_epochs=1, decode_on_device=True)
    counts = torch.zeros(ROWS, dtype=torch.int32, device="cuda")
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    reset_transfer_state(jpeg)
    jpeg.stage2_planes_segments.launches = 0
    jpeg.stage2_rgb.launches = 0
    image.normalize_images.launches = 0
    t0 = time.perf_counter()
    with DataLoader(reader, BATCH, device="cuda", device_transform=transform, prefetch=3,
                    host_queue_size=8, device_shuffle_capacity=FEED_JPEG_CAPACITY,
                    seed=0) as loader:
        for batch in loader:
            ids, u8 = batch["id"], batch["image_u8"]
            counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
            bad.add_((images.index_select(0, ids) != u8).sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    batches = ROWS // BATCH
    launches = {"stage2_planes": jpeg.stage2_planes_segments.launches,
                "stage2_rgb": jpeg.stage2_rgb.launches, "K2": image.normalize_images.launches}
    c = counts.cpu()
    log("feed (c): one epoch of %d rows through a ring of %d images in %.2f s; launches "
        "%s for %d batches; %d uint8 values differ from the ring-less run" % (
            ROWS, FEED_JPEG_CAPACITY, wall, json.dumps(launches), batches, bad.item()))
    check(bool((c == 1).all()), "feed (c): ids delivered %s times, not once each"
          % sorted(set(c.tolist())))
    check(bad.item() == 0, "feed (c): images differ from the ring-less run's of the same "
          "ids")
    check(all(v == batches for v in launches.values()), "feed (c): stage2_planes, "
          "stage2_rgb and K2 should launch once a batch (%d): %s" % (batches, launches))
    return {"launches": launches, "seconds": wall}


# -- phase 9: row selection and exact resume -------------------------------------------
#
# (a) the main path over phase 4's store laid out as hive split=train/ (3 files) and
# split=val/ (1 file), hard links plus fresh metadata, read with a train filter and a
# 90/10 pseudorandom split on id; (b) phase 5's store as day=0..7/ directories with
# filters=[("day", "<", 6)] and shuffle_row_drop_partitions=4, one epoch; (c) phase 5's
# flat store on the pass-through, checkpointed after 20 batches with checkpoint.save and
# resumed from a fresh reader and loader; (d) the main path checkpointed through
# torch.distributed.checkpoint (state_item) and resumed the same way; (e) pad_shapes on a
# 65,536-row store with a ragged int32 column of 0-50 ids a row, padded to (64,).

SEL_SPLIT = (0.9, 0.1)
SEL_DAYS_KEPT = 6
SEL_DROP_PARTITIONS = 4
SEL_RESUME_AFTER = 20
SEL_JPEG_RESUME_AFTER = 6
PAD_ROWS, PAD_RG_ROWS, PAD_MAX, PAD_TO = 65536, 8192, 50, 64


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _md5_band(ids, lo, hi):
    """The rows ``in_pseudorandom_split`` keeps, recomputed here from its definition:
    md5 of the decimal id, the first 8 hex digits over 0xFFFFFFFF, in [lo, hi)."""
    import hashlib

    import numpy as np

    units = np.array([int(hashlib.md5(str(int(i)).encode()).hexdigest()[:8], 16)
                      for i in ids], np.float64) / float(0xFFFFFFFF)
    return np.asarray(ids)[(lo <= units) & (units < hi)]


@contextlib.contextmanager
def count_stage1_rows():
    """Counts the rows that reach stage 1 (``host_stage_decode_batch``) in the block."""
    from petastorm_tpu_torch.codecs import CompressedImageCodec

    rows = []
    orig = CompressedImageCodec.host_stage_decode_batch

    def counting(self, field, values):
        rows.append(len(values))
        return orig(self, field, values)

    CompressedImageCodec.host_stage_decode_batch = counting
    try:
        yield rows
    finally:
        CompressedImageCodec.host_stage_decode_batch = orig


def _items_done(state):
    """Work items a reader state counts as delivered (whole epochs included)."""
    return int(state["resume_epoch"]) * int(state["plan"]["num_items"]) \
        + sum(len(v) for v in state["consumed"].values())


def _jpeg_launch_counters(zero=False):
    from petastorm_tpu_torch.ops import image, jpeg

    if zero:
        reset_transfer_state(jpeg)
        jpeg.stage2_planes_segments.launches = 0
        jpeg.stage2_rgb.launches = 0
        image.normalize_images.launches = 0
    return {"stage2_planes": jpeg.stage2_planes_segments.launches,
            "stage2_rgb": jpeg.stage2_rgb.launches, "K2": image.normalize_images.launches}


def _tab_launch_counters(zero=False):
    from petastorm_tpu_torch.ops import pagedec_kernels as pk

    if zero:
        pk.snappy_inflate_ragged.launches = 0
        pk.rle_scan_pages.launches = 0
        pk.extract_pages.launches = 0
    return {"K3": pk.snappy_inflate_ragged.launches, "scan": pk.rle_scan_pages.launches,
            "K4": pk.extract_pages.launches}


def write_split_store(url, split_url):
    """Phase 4's files as split=train/ (the first three) and split=val/ (the last), hard
    links, with metadata written anew (the unischema and the row-group counts)."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.metadata import get_schema, write_petastorm_tpu_metadata

    fs, src = get_filesystem_and_path_or_paths(url)
    _fs, dst = get_filesystem_and_path_or_paths(split_url)
    files = sorted(f for f in os.listdir(src) if f.endswith(".parquet"))
    check(len(files) == 4, "phase 4's store has %d files, not 4" % len(files))
    counts = {}
    for i, f in enumerate(files):
        rel = "split=%s/%s" % ("train" if i < 3 else "val", f)
        os.makedirs(os.path.dirname(os.path.join(dst, rel)), exist_ok=True)
        os.link(os.path.join(src, f), os.path.join(dst, rel))
        counts[rel] = pq.read_metadata(os.path.join(src, f)).num_row_groups
    write_petastorm_tpu_metadata(fs, dst, get_schema(fs, src), counts)
    return files


def _jpeg_transform():
    from petastorm_tpu_torch.ops import image

    def transform(batch):
        return {**batch, "image": image.normalize_images(batch["image"], MEAN, STD),
                "image_u8": batch["image"]}

    return transform


def phase_selection_jpeg(url, work, images, smi, device="cuda"):
    """(a) and (d) (module comment above); ``images`` ((ROWS, 224, 224, 3) uint8 on the
    card, by id) from phase 7's first thread-pool run."""
    import numpy as np
    import torch
    import torch.distributed.checkpoint as dcp

    from petastorm_tpu_torch import checkpoint as ptck
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.predicates import in_pseudorandom_split

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    out = {}
    # -- (a) ------------------------------------------------------------------------------
    split_url = "file://" + os.path.join(work, "split_store")
    write_split_store(url, split_url)
    train_ids = np.arange(3 * ROWS_PER_FILE)
    want = _md5_band(train_ids, 0.0, SEL_SPLIT[0])
    counts = torch.zeros(ROWS, dtype=torch.int32, device=device)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    _jpeg_launch_counters(zero=True)
    batches = 0
    t0 = time.perf_counter()
    # counting from before the reader starts: its pool begins reading at construction
    with count_stage1_rows() as staged:
        reader = make_batch_reader(
            split_url, workers_count=workers, shuffle_row_groups=True, seed=0,
            num_epochs=1, decode_on_device=True, filters=[("split", "=", "train")],
            predicate=in_pseudorandom_split(list(SEL_SPLIT), 0, "id"))
        with DataLoader(reader, BATCH, device=device, device_transform=_jpeg_transform(),
                        prefetch=3, host_queue_size=8, last_batch="partial") as loader:
            for batch in loader:
                batches += 1
                ids, u8 = batch["id"], batch["image_u8"]
                counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
                bad.add_((images.index_select(0, ids) != u8).sum())
                check(set(batch["split"]) == {"train"}, "(a): a batch holds rows of %s"
                      % sorted(set(batch["split"])))
            _sync(device)
            wall = time.perf_counter() - t0
            stats = loader.stats.snapshot()
    launches = _jpeg_launch_counters()
    c = counts.cpu().numpy()
    got = np.nonzero(c)[0]
    skipped = 1.0 - sum(staged) / float(len(train_ids))
    log("selection (a): %d of %d train rows in %d batches, %.1f rows/s (%.3f s); read_s "
        "%.5f and decode_s %.5f a batch; %d rows through stage 1, %d skipped it (%.4f of "
        "the scheduled rows); launches %s; %s" % (
            len(got), len(train_ids), batches, len(got) / wall, wall,
            stats["read_s"] / batches, stats["decode_s"] / batches, sum(staged),
            len(train_ids) - sum(staged), skipped, json.dumps(launches), smi))
    check(np.array_equal(got, want) and (c[got] == 1).all(), "(a): the delivered ids are "
          "not the host's split of the train files (%d delivered, %d wanted, %d delivered "
          "twice)" % (len(got), len(want), int((c > 1).sum())))
    check(sum(staged) == len(want), "(a): %d rows reached stage 1, the split keeps %d: "
          "the mask did not run before stage 1" % (sum(staged), len(want)))
    check(bad.item() == 0, "(a): %d uint8 values differ from phase 7's images of the same "
          "ids" % bad.item())
    check(all(v == batches for v in launches.values()), "(a): stage2_planes, stage2_rgb and "
          "K2 should launch once a batch (%d): %s" % (batches, launches))
    out["a"] = {"launches": launches, "rows_per_s": len(got) / wall, "seconds": wall,
                "stage1_skipped_share": skipped}
    # -- (d) ------------------------------------------------------------------------------

    def build():
        reader = make_batch_reader(url, workers_count=workers, shuffle_row_groups=True,
                                   seed=3, num_epochs=1, decode_on_device=True)
        return DataLoader(reader, BATCH, device=device, device_transform=_jpeg_transform(),
                          prefetch=3, host_queue_size=8, last_batch="partial")

    counts.zero_()
    bad.zero_()
    model = {"w": torch.arange(12, dtype=torch.float32, device=device).view(3, 4)}
    ckpt = os.path.join(work, "dcp_jpeg")
    halves = []
    t0 = time.perf_counter()
    loader = build()
    _jpeg_launch_counters(zero=True)
    n = 0
    with loader:
        for batch in loader:
            n += 1
            ids, u8 = batch["id"], batch["image_u8"]
            counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
            bad.add_((images.index_select(0, ids) != u8).sum())
            if n == SEL_JPEG_RESUME_AFTER:
                break
        reader_done = _items_done(loader.reader.state_dict())
        dcp.save({"model": {k: v.cpu() for k, v in model.items()},
                  "data": ptck.state_item(loader)}, checkpoint_id=ckpt)
        saved = loader.state_dict()
    # the transfer thread decodes ahead of the consumer: it took stats["batches"]
    halves.append((n, _jpeg_launch_counters(), loader.stats.snapshot()["batches"]))
    loader = build()
    target = {"model": {"w": torch.zeros(3, 4)}, "data": ptck.state_item(loader)}
    dcp.load(target, checkpoint_id=ckpt)
    check(torch.equal(target["model"]["w"].to(device), model["w"]), "(d): the model tensor "
          "did not come back from the checkpoint")
    _jpeg_launch_counters(zero=True)
    n = 0
    with loader:
        for batch in loader:
            n += 1
            ids, u8 = batch["id"], batch["image_u8"]
            counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
            bad.add_((images.index_select(0, ids) != u8).sum())
    halves.append((n, _jpeg_launch_counters(), loader.stats.snapshot()["batches"]))
    _sync(device)
    wall = time.perf_counter() - t0
    c = counts.cpu().numpy()
    in_flight = reader_done - _items_done(saved)
    dup = int((c - 1).clip(0).sum())
    log("selection (d): %d + %d batches around a torch.distributed.checkpoint save "
        "(%.2f s); %d row groups in flight at the save, %d rows delivered twice; launches "
        "%s for %s batches the transfer thread took; %s" % (
            halves[0][0], halves[1][0], wall, in_flight, dup,
            json.dumps([h[1] for h in halves]), [h[2] for h in halves], smi))
    check(bool((c >= 1).all()), "(d): %d ids never arrived" % int((c == 0).sum()))
    check(dup <= in_flight * 270, "(d): %d rows twice, more than the %d row groups in "
          "flight hold" % (dup, in_flight))
    check(bad.item() == 0, "(d): images differ from phase 7's of the same ids")
    for nb, lc, transferred in halves:
        check(lc["stage2_planes"] == lc["stage2_rgb"] == lc["K2"]
              and nb <= lc["K2"] <= transferred, "(d): stage2_planes, stage2_rgb and K2 "
              "should launch once for each batch the transfer thread decoded (%d taken by "
              "the consumer, %d by the transfer thread): %s" % (nb, transferred, lc))
    out["d"] = {"launches": [h[1] for h in halves], "seconds": wall,
                "in_flight_row_groups": in_flight, "duplicate_rows": dup}
    return out


def _global_row_index(arrays):
    """Sorted 64-bit row keys (``row_keys``' formula in numpy) of every row of phase 5's
    store and each one's (file, row) position."""
    import numpy as np

    keys, where = [], []
    for f, cols in enumerate(arrays):
        key = None
        for name in TAB_COLUMNS:
            c = cols[name]
            w = (c.view(np.int32) if c.dtype == np.float32 else c).astype(np.int64)
            key = w if key is None else key * 1000003 + w
        keys.append(key)
        where.append(np.stack([np.full(len(key), f), np.arange(len(key))], 1))
    keys, where = np.concatenate(keys), np.concatenate(where)
    order = np.argsort(keys, kind="stable")
    keys, where = keys[order], where[order]
    check(len(np.unique(keys)) == len(keys), "phase 5's rows do not have distinct keys")
    return keys, where


def _drop_partition_rows(path, rg, rows, k, p, seed=0):
    """Partition ``p`` of ``k`` of a row group, recomputed here from the JAX package's
    definition: PCG64 over SeedSequence([seed, crc32(path), row group])."""
    import zlib

    import numpy as np

    seq = np.random.SeedSequence([seed, zlib.crc32(path.encode()) & 0x7FFFFFFF, rg])
    perm = np.random.Generator(np.random.PCG64(seq)).permutation(rows)
    return np.sort(np.array_split(perm, k)[p])


def phase_selection_tabular(root, arrays, predicted, work, smi, device="cuda"):
    """(b) and (c) (module comment above)."""
    import numpy as np
    import torch

    from petastorm_tpu_torch import checkpoint as ptck
    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.io import pagedec
    from petastorm_tpu_torch.loader import DataLoader

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    out = {}
    keys, where = _global_row_index(arrays)
    # -- (b) ------------------------------------------------------------------------------
    days = os.path.join(work, "days")
    for f in range(TAB_FILES):
        os.makedirs(os.path.join(days, "day=%d" % f))
        os.link(os.path.join(root, "part-%d.parquet" % f),
                os.path.join(days, "day=%d" % f, "part-0.parquet"))
    part_rows = TAB_RG_ROWS // SEL_DROP_PARTITIONS
    reader = make_batch_reader("file://" + days, workers_count=workers,
                               shuffle_row_groups=True, seed=0, num_epochs=1,
                               io_options={"pagedec": "auto"},
                               filters=[("day", "<", SEL_DAYS_KEPT)],
                               shuffle_row_drop_partitions=SEL_DROP_PARTITIONS)
    counters0 = pagedec.counter_values()
    _tab_launch_counters(zero=True)
    seen = np.zeros(len(keys), np.int32)
    partitions = {}
    t0 = time.perf_counter()
    with DataLoader(reader, part_rows, device=device, prefetch=3,
                    host_queue_size=8) as loader:
        for batch in loader:
            check(torch.equal(batch["day"], torch.full_like(batch["day"], batch["day"][0]))
                  and int(batch["day"][0]) < SEL_DAYS_KEPT, "(b): a batch mixes days or "
                  "holds a pruned day")
            k = row_keys(batch).cpu().numpy()
            pos = np.searchsorted(keys, k)
            check(bool((keys[np.minimum(pos, len(keys) - 1)] == k).all()),
                  "(b): a delivered row is no row of the store")
            seen[pos] += 1
            f, rows = where[pos, 0], where[pos, 1]
            check(len(set(f.tolist())) == 1 and len(set((rows // TAB_RG_ROWS).tolist())) == 1,
                  "(b): a batch spans row groups: the items are not whole partitions")
            rg = int(rows[0] // TAB_RG_ROWS)
            partitions.setdefault((int(f[0]), rg), []).append(np.sort(rows % TAB_RG_ROWS))
        _sync(device)
        wall = time.perf_counter() - t0
    counters = {k: v - counters0[k] for k, v in pagedec.counter_values().items()}
    launches = _tab_launch_counters()
    kept = np.isin(where[:, 0], np.arange(SEL_DAYS_KEPT))
    matched = 0
    for (f, rg), parts in partitions.items():
        path = os.path.join(days, "day=%d" % f, "part-0.parquet")
        want = [_drop_partition_rows(path, rg, TAB_RG_ROWS, SEL_DROP_PARTITIONS, p)
                for p in range(SEL_DROP_PARTITIONS)]
        for got in parts:
            check(any(np.array_equal(got, w) for w in want), "(b): day %d row group %d: a "
                  "partition's rows differ from the recomputed partitions" % (f, rg))
            matched += 1
    delivered = int(seen.sum())
    log("selection (b): %d rows of days 0-%d in %d partitions of %d rows, %.1f rows/s "
        "(%.3f s); pass-through pages shipped %d, launches %s; %s" % (
            delivered, SEL_DAYS_KEPT - 1, matched, part_rows, delivered / wall, wall,
            counters["pages"], json.dumps(launches), smi))
    check(bool((seen[kept] == 1).all()) and not seen[~kept].any(), "(b): rows of days "
          "0-%d not delivered once each (%d missing, %d twice) or rows of later days "
          "delivered (%d)" % (SEL_DAYS_KEPT - 1, int((seen[kept] == 0).sum()),
                              int((seen[kept] > 1).sum()), int(seen[~kept].sum())))
    check(matched == SEL_DAYS_KEPT * TAB_RGS_PER_FILE * SEL_DROP_PARTITIONS,
          "(b): %d partitions delivered" % matched)
    check(counters["pages"] == 0 and counters["bytes_compressed"] == 0,
          "(b): the pass-through shipped %d pages under filters and row-drop partitions"
          % counters["pages"])
    out["b"] = {"launches": launches, "rows_per_s": delivered / wall, "seconds": wall,
                "pages_shipped": counters["pages"]}
    # -- (c) ------------------------------------------------------------------------------

    def build():
        reader = make_batch_reader("file://" + root, workers_count=workers,
                                   shuffle_row_groups=True, seed=5, num_epochs=1,
                                   io_options={"pagedec": "auto"})
        return DataLoader(reader, TAB_BATCH, device=device, prefetch=3, host_queue_size=8)

    ckpt = os.path.join(work, "tab_ckpt", "data.pt")
    all_keys = []
    halves = []
    t0 = time.perf_counter()
    loader = build()
    counters0 = pagedec.counter_values()
    _tab_launch_counters(zero=True)
    n = 0
    with loader:
        for batch in loader:
            n += 1
            all_keys.append(row_keys(batch))
            if n == SEL_RESUME_AFTER:
                break
        reader_done = _items_done(loader.reader.state_dict())
        ptck.save(ckpt, loader)
        saved = loader.state_dict()
    halves.append((n, _tab_launch_counters(), {k: v - counters0[k] for k, v in
                                               pagedec.counter_values().items()}))
    loader = build()
    ptck.restore(ckpt, loader)
    counters0 = pagedec.counter_values()
    _tab_launch_counters(zero=True)
    n = 0
    with loader:
        for batch in loader:
            n += 1
            all_keys.append(row_keys(batch))
    halves.append((n, _tab_launch_counters(), {k: v - counters0[k] for k, v in
                                               pagedec.counter_values().items()}))
    got = torch.cat(all_keys).sort().values
    want = torch.from_numpy(keys).to(device)
    present = torch.isin(want, got)
    dup = int(len(got) - torch.unique(got).numel())
    _sync(device)
    wall = time.perf_counter() - t0
    in_flight = reader_done - _items_done(saved)
    log("selection (c): %d + %d batches around checkpoint.save (%.2f s); %d row groups in "
        "flight at the save, %d rows delivered twice; launches %s; pages %s; %s" % (
            halves[0][0], halves[1][0], wall, in_flight, dup,
            json.dumps([h[1] for h in halves]),
            json.dumps([h[2]["pages"] for h in halves]), smi))
    check(bool(present.all()), "(c): %d rows never arrived" % int((~present).sum()))
    check(dup <= in_flight * TAB_RG_ROWS, "(c): %d rows twice, more than the %d row groups "
          "in flight hold" % (dup, in_flight))
    for nb, lc, cnt in halves:
        passthrough_batches = cnt["pages"] // predicted["pages"]
        check(passthrough_batches >= 1 and cnt["host_inflate_columns"] == 0,
              "(c): %d pass-through batches, %d host-inflated columns"
              % (passthrough_batches, cnt["host_inflate_columns"]))
        for k in ("K3", "scan", "K4"):
            check(lc[k] == predicted[k] * passthrough_batches, "(c): %s launched %d times "
                  "for %d pass-through batches" % (k, lc[k], passthrough_batches))
    out["c"] = {"launches": [h[1] for h in halves], "seconds": wall,
                "in_flight_row_groups": in_flight, "duplicate_rows": dup}
    return out


def phase_pad_shapes(work, smi, device="cuda"):
    """(e) (module comment above)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader

    rng = np.random.default_rng(9)
    lengths = rng.integers(0, PAD_MAX + 1, PAD_ROWS)
    flat = rng.integers(0, 2**31 - 1, int(lengths.sum()), dtype=np.int64).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    root = os.path.join(work, "ragged")
    os.makedirs(root)
    pq.write_table(pa.table({"id": np.arange(PAD_ROWS, dtype=np.int64),
                             "hist": pa.ListArray.from_arrays(pa.array(offsets),
                                                              pa.array(flat))}),
                   os.path.join(root, "p.parquet"), row_group_size=PAD_RG_ROWS)
    padded = np.zeros((PAD_ROWS, PAD_TO), np.int64)
    mask = np.zeros((PAD_ROWS, PAD_TO), bool)
    col = np.arange(PAD_TO)
    mask[:] = col[None, :] < lengths[:, None]
    padded[mask] = flat
    padded_dev = torch.from_numpy(padded).to(device)
    mask_dev = torch.from_numpy(mask).to(device)
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    reader = make_batch_reader("file://" + root, workers_count=workers, num_epochs=1)
    seen = torch.zeros(PAD_ROWS, dtype=torch.int32, device=device)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    batches = 0
    t0 = time.perf_counter()
    with DataLoader(reader, PAD_RG_ROWS, device=device, prefetch=3,
                    pad_shapes={"hist": (PAD_TO,)}) as loader:
        for batch in loader:
            batches += 1
            ids, h, m = batch["id"], batch["hist"], batch["hist__mask"]
            on_card = h.device.type == m.device.type == torch.device(device).type
            check(on_card and h.shape == (len(ids), PAD_TO)
                  and m.dtype == torch.bool, "(e): padded %s %s %s, mask %s" % (
                      h.device, tuple(h.shape), h.dtype, m.dtype))
            seen.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
            bad.add_((padded_dev.index_select(0, ids) != h).sum()
                     + (mask_dev.index_select(0, ids) != m).sum())
        _sync(device)
        wall = time.perf_counter() - t0
        stats = loader.stats.snapshot()
    log("selection (e): %d rows with 0-%d ids each padded to (%d,) in %d batches, %.1f "
        "rows/s (%.3f s; batch_s %.5f a batch: the padding runs in the producer); dtype "
        "%s; %d values apart from numpy; %s" % (
            PAD_ROWS, PAD_MAX, PAD_TO, batches, PAD_ROWS / wall, wall,
            stats["batch_s"] / max(1, batches), str(h.dtype), bad.item(), smi))
    check(bool((seen == 1).all()), "(e): rows not delivered once each")
    check(bad.item() == 0, "(e): %d padded values or mask bits differ from numpy"
          % bad.item())
    return {"rows_per_s": PAD_ROWS / wall, "seconds": wall}


# -- phase 10: windowed and in-memory feeds --------------------------------------------
#
# (a) InMemDataLoader over phase 4's JPEG store (decode_on_device, batch 256, K2 as the
# device transform), two shuffled epochs and an exact resume; (b) InMemDataLoader over
# phase 5's tabular store through the pass-through (pagedec="auto", batch 16,384), one
# epoch; (c) make_dataloader against make_batch_reader + DataLoader with the same
# arguments; (d) per-row NGram windows of three consecutive ids over phase 4's store,
# host decode, K2 on two frames a window; (e) batched NGram windows of eight 10 ms steps
# over a 1,048,576-row sensor store written here (72 flat columns), with and without
# overlap; (f) WeightedSamplingReader over phase 5's store split by files, [0.7, 0.3];
# (g) the torch adapters' BatchedDataLoader against the DataLoader on phase 5's store.

INMEM_EPOCHS, INMEM_RESUME_AFTER = 2, 5
NGRAM_BATCH = 64
SENSOR_ROWS, SENSOR_RG_ROWS, SENSOR_COLUMNS, SENSOR_LENGTH = 1 << 20, 1 << 16, 8, 8
SENSOR_GAP_EVERY, SENSOR_STEP_MS = 1000, 10
MIX_P = (0.7, 0.3)
MIX_FILES = 6  # files 0-5 in the first reader, the rest in the second


def _k2_transform(names):
    """Normalise ``names`` (uint8 frames) to bfloat16 with K2, keeping each frame's
    uint8 as ``name + "_u8"``."""
    from petastorm_tpu_torch.ops import image

    def transform(batch):
        out = dict(batch)
        for name in names:
            out[name] = image.normalize_images(batch[name], MEAN, STD)
            out[name + "_u8"] = batch[name]
        return out

    return transform


def _k2_plain_equal(batch, name):
    """K2's output of ``name`` equal to its plain version on the same uint8 frames."""
    import torch

    from petastorm_tpu_torch.ops import image

    plain = image._normalize_plain(batch[name + "_u8"], MEAN, STD, torch.bfloat16)
    return torch.equal(batch[name], plain)


def phase_inmem_jpeg(url, images, smi, device="cuda"):
    """(a) (comment above); ``images`` ((ROWS, 224, 224, 3) uint8 by id) from phase 7."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import InMemDataLoader

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))

    def build(workers_count):
        reader = make_batch_reader(url, workers_count=workers_count, shuffle_row_groups=True,
                                   seed=0, num_epochs=1, decode_on_device=True)
        return InMemDataLoader(reader, BATCH, num_epochs=INMEM_EPOCHS, shuffle=True, seed=0,
                               device_transform=_k2_transform(["image"]), device=device)

    _sync(device)
    base_mem = torch.cuda.memory_allocated() if device == "cuda" else 0
    _jpeg_launch_counters(zero=True)
    t0 = time.perf_counter()
    loader = build(workers)
    _sync(device)
    fill_s = time.perf_counter() - t0
    fill = _jpeg_launch_counters()
    store_mem = (torch.cuda.memory_allocated() - base_mem) if device == "cuda" else 0
    fill_batches = -(-ROWS // BATCH)  # one layout group a batch: the store is uniform
    _jpeg_launch_counters(zero=True)
    counts = torch.zeros((INMEM_EPOCHS, ROWS), dtype=torch.int32, device=device)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    order, plain_ok = [], True
    t0 = time.perf_counter()
    with loader:
        for n, batch in enumerate(loader):
            ids = batch["id"]
            epoch = n // len(loader)
            counts[epoch].index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
            bad.add_((images.index_select(0, ids) != batch["image_u8"]).sum())
            order.append(ids)
            if n == 0:
                plain_ok = _k2_plain_equal(batch, "image")
        _sync(device)
        serve_s = time.perf_counter() - t0
        served = len(order)
    launches = _jpeg_launch_counters()
    c = counts.cpu()
    epochs = [torch.cat(order[e * len(loader):(e + 1) * len(loader)]).cpu()
              for e in range(INMEM_EPOCHS)]
    del loader
    # the resume: the epochs' orders are permutations of the store, so a resumed loader
    # must fill its store in the same row order; the fill puts the rows in the reader's
    # item order whatever order the workers finish in. A state after INMEM_RESUME_AFTER
    # batches of an uninterrupted run, restored into a fresh loader over a fresh reader
    # (both on all the workers), serves exactly that run's remaining batches.
    with build(workers) as uninterrupted:
        run, state = [], None
        for n, batch in enumerate(uninterrupted):
            run.append(batch["id"].cpu())
            if n + 1 == INMEM_RESUME_AFTER:
                state = uninterrupted.state_dict()
    with build(workers) as resumed:
        resumed.load_state_dict(state)
        rest = [b["id"].cpu() for b in resumed]
    want = run[INMEM_RESUME_AFTER:]
    resume_ok = len(rest) == len(want) and all(torch.equal(a, b) for a, b in zip(rest, want))
    rows_per_s = served * BATCH / serve_s
    log("inmem (a): fill of %d rows in %.3f s (%.1f rows/s), store %.1f MB on the card "
        "(memory_allocated +%d bytes); %d batches served over %d epochs in %.3f s, %.1f "
        "rows/s; fill launches %s for %d fill batches; serving launches %s; resume after "
        "%d batches served %d of %d remaining batches identically; %s" % (
            ROWS, fill_s, ROWS / fill_s, ROWS * IMG[0] * IMG[1] * IMG[2] / 1e6, store_mem,
            served, INMEM_EPOCHS, serve_s, rows_per_s, json.dumps(fill), fill_batches,
            json.dumps(launches), INMEM_RESUME_AFTER, len(rest), len(want), smi))
    check(bool((c == 1).all()), "inmem (a): ids not served once each epoch")
    check(not torch.equal(epochs[0], epochs[1]), "inmem (a): the two epochs' orders are "
          "equal")
    check(bad.item() == 0, "inmem (a): %d uint8 values differ from phase 7's images of the "
          "same ids" % bad.item())
    check(plain_ok, "inmem (a): K2 differs from its plain version")
    check(fill["stage2_planes"] == fill["stage2_rgb"] == fill_batches and fill["K2"] == 0,
          "inmem (a): the fill should launch stage2_planes and stage2_rgb once a fill batch "
          "(%d) and K2 never: %s" % (fill_batches, fill))
    check(launches["K2"] == served and launches["stage2_planes"] == 0,
          "inmem (a): K2 should launch once a served batch (%d) and stage 2 never: %s"
          % (served, launches))
    check(resume_ok, "inmem (a): the restored loader served other ids than the "
          "uninterrupted run's remaining batches")
    return {"fill_launches": fill, "launches": launches, "fill_s": fill_s,
            "rows_per_s": rows_per_s, "store_bytes": store_mem}


def phase_make_dataloader(url, images, smi, device="cuda"):
    """(c) (comment above)."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader, make_dataloader

    workers = 7
    kw = dict(decode_on_device=True, shuffle_row_groups=False, workers_count=workers)
    out = {}
    for form in ("make_dataloader", "two_calls"):
        if form == "make_dataloader":
            loader = make_dataloader(url, BATCH, device=device, **kw)
        else:
            loader = DataLoader(make_batch_reader(url, num_epochs=1, **kw), BATCH,
                                device=device)
        counts = torch.zeros(ROWS, dtype=torch.int32, device=device)
        bad = torch.zeros((), dtype=torch.int64, device=device)
        _jpeg_launch_counters(zero=True)
        batches = 0
        t0 = time.perf_counter()
        with loader:
            for batch in loader:
                batches += 1
                ids = batch["id"]
                counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
                bad.add_((images.index_select(0, ids) != batch["image"]).sum())
            _sync(device)
        wall = time.perf_counter() - t0
        out[form] = {"ids": counts.cpu(), "bad": bad.item(), "batches": batches,
                     "launches": _jpeg_launch_counters(), "rows_per_s": batches * BATCH / wall}
    a, b = out["make_dataloader"], out["two_calls"]
    log("make_dataloader (c): %d and %d batches (%.1f and %.1f rows/s); launches %s and %s; "
        "%d and %d uint8 values apart from phase 7's images; %s" % (
            a["batches"], b["batches"], a["rows_per_s"], b["rows_per_s"],
            json.dumps(a["launches"]), json.dumps(b["launches"]), a["bad"], b["bad"], smi))
    check(torch.equal(a["ids"], b["ids"]) and bool((a["ids"] == 1).all()),
          "make_dataloader (c): the two forms deliver other ids (or not every id once)")
    check(a["bad"] == 0 and b["bad"] == 0, "make_dataloader (c): images differ from "
          "phase 7's")
    check(a["batches"] == b["batches"] == ROWS // BATCH
          and a["launches"]["stage2_planes"] == a["launches"]["stage2_rgb"] == a["batches"],
          "make_dataloader (c): batches %d / %d, launches %s" % (
              a["batches"], b["batches"], a["launches"]))
    return {"launches": a["launches"], "rows_per_s": a["rows_per_s"]}


def _store_window_starts(url, length, key="id"):
    """Sorted ``key`` values that start a window of ``length`` consecutive values (delta
    1) inside one row group, from the store's row-group layout (numpy)."""
    import numpy as np
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths

    _fs, root = get_filesystem_and_path_or_paths(url)
    starts = []
    for f in sorted(x for x in os.listdir(root) if x.endswith(".parquet")):
        pf = pq.ParquetFile(os.path.join(root, f))
        for rg in range(pf.num_row_groups):
            v = np.sort(pf.read_row_group(rg, columns=[key]).column(key).to_numpy())
            ok = np.concatenate([[0], np.cumsum(np.diff(v) <= 1)])
            win = ok[length - 1:] - ok[:len(v) - length + 1]
            starts.append(v[:len(v) - length + 1][win == length - 1])
    return np.sort(np.concatenate(starts))


def phase_ngram_rows(url, blobs, smi, device="cuda"):
    """(d) (comment above); ``blobs`` {id: jpeg bytes} of phase 4's store."""
    import numpy as np
    import torch

    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ngram import NGram

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    ngram = NGram({0: ["id", "image"], 1: ["id", "image"], 2: ["id"]}, delta_threshold=1,
                  timestamp_field="id")
    reader = make_reader(url, schema_fields=ngram, workers_count=workers, num_epochs=1,
                         shuffle_row_groups=True, seed=0)
    field = reader.schema.fields["image"]
    want = _store_window_starts(url, 3)
    counts = torch.zeros(ROWS, dtype=torch.int32, device=device)
    bad_ids = torch.zeros((), dtype=torch.int64, device=device)
    _jpeg_launch_counters(zero=True)
    checked, plain_ok, batches = 0, True, 0
    t0 = time.perf_counter()
    with DataLoader(reader, NGRAM_BATCH, device=device, last_batch="partial",
                    device_transform=_k2_transform(["0/image", "1/image"])) as loader:
        for batch in loader:
            batches += 1
            ids = batch["0/id"]
            counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
            bad_ids.add_((batch["1/id"] != ids + 1).sum() + (batch["2/id"] != ids + 2).sum())
            if batches in (1, 2):
                plain_ok &= _k2_plain_equal(batch, "0/image") and \
                    _k2_plain_equal(batch, "1/image")
                # the frames equal the host decode of the same ids
                for off in (0, 1):
                    host = np.stack([field.codec.decode(field, blobs[int(i) + off])
                                     for i in ids.tolist()])
                    check(torch.equal(batch["%d/image_u8" % off],
                                      torch.from_numpy(host).to(device)),
                          "ngram (d): frames of offset %d differ from the host decode" % off)
                    checked += len(host)
        _sync(device)
        wall = time.perf_counter() - t0
    launches = _jpeg_launch_counters()
    c = counts.cpu().numpy()
    got = np.nonzero(c)[0]
    log("ngram (d): %d windows of 3 ids (2 frames each) in %d batches of %d, %.1f windows/s "
        "(%.3f s); %d frames held to the host decode; launches %s; %s" % (
            int(c.sum()), batches, NGRAM_BATCH, c.sum() / wall, wall, checked,
            json.dumps(launches), smi))
    check(np.array_equal(got, want) and bool((c[got] == 1).all()), "ngram (d): %d windows "
          "delivered, %d computed from the row-group layout (or some twice)"
          % (len(got), len(want)))
    check(bad_ids.item() == 0, "ngram (d): a window's ids are not consecutive")
    check(plain_ok, "ngram (d): K2 differs from its plain version")
    check(launches["K2"] == 2 * batches and launches["stage2_planes"] == 0,
          "ngram (d): K2 should launch twice a batch (%d batches) and stage 2 never: %s"
          % (batches, launches))
    return {"launches": launches, "windows_per_s": float(c.sum() / wall)}


def write_sensor_store(root, seed=12):
    """The sensor store: SENSOR_ROWS rows in row groups of SENSOR_RG_ROWS, ``ts`` int64 at
    10 ms steps with a seeded gap (11-500 ms) about every 1,000 rows, ``s0``..``s7``
    float32. Returns (url, ts, [sensor arrays])."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    steps = np.full(SENSOR_ROWS, SENSOR_STEP_MS, np.int64)
    gaps = rng.random(SENSOR_ROWS) < 1.0 / SENSOR_GAP_EVERY
    steps[gaps] += rng.integers(1, 491, int(gaps.sum()))
    ts = np.cumsum(steps)
    sensors = [rng.standard_normal(SENSOR_ROWS).astype(np.float32)
               for _ in range(SENSOR_COLUMNS)]
    os.makedirs(root)
    cols = {"ts": ts}
    cols.update({"s%d" % j: s for j, s in enumerate(sensors)})
    pq.write_table(pa.table(cols), os.path.join(root, "sensors.parquet"),
                   row_group_size=SENSOR_RG_ROWS)
    return "file://" + root, ts, sensors


def _sensor_window_starts(ts, overlap):
    """Row indices that start a valid window, recomputed here per row group: a rolling
    sum of the steps within SENSOR_STEP_MS, then (no overlap) a greedy pass."""
    import numpy as np

    out = []
    for start in range(0, len(ts), SENSOR_RG_ROWS):
        t = ts[start:start + SENSOR_RG_ROWS]
        ok = np.concatenate([[0], np.cumsum(np.diff(t) <= SENSOR_STEP_MS)])
        win = ok[SENSOR_LENGTH - 1:] - ok[:len(t) - SENSOR_LENGTH + 1]
        s = np.nonzero(win == SENSOR_LENGTH - 1)[0]
        if not overlap:
            kept, free = [], -1
            for x in s:
                if x > free:
                    kept.append(x)
                    free = x + SENSOR_LENGTH - 1
            s = np.asarray(kept, np.int64)
        out.append(s + start)
    return np.concatenate(out)


def phase_ngram_sensors(work, smi, device="cuda"):
    """(e) (comment above)."""
    import numpy as np
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ngram import NGram

    t0 = time.perf_counter()
    url, ts, sensors = write_sensor_store(os.path.join(work, "sensors"))
    log("sensor store: %d rows in row groups of %d, %d gaps, written in %.2f s" % (
        SENSOR_ROWS, SENSOR_RG_ROWS, int((np.diff(ts) > SENSOR_STEP_MS).sum()),
        time.perf_counter() - t0))
    names = ["ts"] + ["s%d" % j for j in range(SENSOR_COLUMNS)]
    ts_dev = torch.from_numpy(ts).to(device)
    sens_dev = torch.stack([torch.from_numpy(s) for s in sensors]).to(device)
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    out = {}
    for overlap in (True, False):
        ngram = NGram({k: list(names) for k in range(SENSOR_LENGTH)},
                      delta_threshold=SENSOR_STEP_MS, timestamp_field="ts",
                      timestamp_overlap=overlap)
        want = _sensor_window_starts(ts, overlap)
        reader = make_batch_reader(url, schema_fields=ngram, workers_count=workers,
                                   num_epochs=1)
        starts, bad, batches, columns = [], torch.zeros((), dtype=torch.int64,
                                                        device=device), 0, 0
        t0 = time.perf_counter()
        with DataLoader(reader, TAB_BATCH, device=device, last_batch="partial") as loader:
            for batch in loader:
                batches += 1
                columns = len(batch)
                idx = torch.searchsorted(ts_dev, batch["0/ts"])
                starts.append(idx)
                for k in range(SENSOR_LENGTH):
                    bad.add_((batch["%d/ts" % k] != ts_dev[idx + k]).sum())
                    for j in range(SENSOR_COLUMNS):
                        bad.add_((batch["%d/s%d" % (k, j)] != sens_dev[j][idx + k]).sum())
            _sync(device)
            wall = time.perf_counter() - t0
        got = torch.cat(starts).sort().values.cpu().numpy()
        tag = "overlap" if overlap else "no_overlap"
        out[tag] = {"windows": len(got), "windows_per_s": len(got) / wall, "seconds": wall}
        log("ngram (e, %s): %d windows of %d steps in %d batches of %d flat columns, %.1f "
            "windows/s (%.3f s); %d values apart from the store; %s" % (
                tag, len(got), SENSOR_LENGTH, batches, columns, len(got) / wall, wall,
                bad.item(), smi))
        check(columns == SENSOR_LENGTH * len(names), "ngram (e): %d columns a batch, not %d"
              % (columns, SENSOR_LENGTH * len(names)))
        check(np.array_equal(got, want), "ngram (e, %s): %d windows delivered, %d computed "
              "from the store (or some twice)" % (tag, len(got), len(want)))
        check(bad.item() == 0, "ngram (e, %s): %d window values differ from the store"
              % (tag, bad.item()))
    return out


def phase_inmem_tabular(root, arrays, predicted, smi, device="cuda"):
    """(b) (comment above)."""
    import numpy as np
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.io import pagedec
    from petastorm_tpu_torch.loader import InMemDataLoader

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    keys, where = _global_row_index(arrays)
    rows = len(keys)
    _sync(device)
    base_mem = torch.cuda.memory_allocated() if device == "cuda" else 0
    counters0 = pagedec.counter_values()
    _tab_launch_counters(zero=True)
    t0 = time.perf_counter()
    reader = make_batch_reader("file://" + root, workers_count=workers, num_epochs=1,
                               io_options={"pagedec": "auto"})
    loader = InMemDataLoader(reader, TAB_BATCH, num_epochs=1, shuffle=True, seed=0,
                             device=device)
    _sync(device)
    fill_s = time.perf_counter() - t0
    store_mem = (torch.cuda.memory_allocated() - base_mem) if device == "cuda" else 0
    launches = _tab_launch_counters()
    cnt = {k: v - counters0[k] for k, v in pagedec.counter_values().items()}
    passthrough = cnt["pages"] // predicted["pages"]
    got, first_ok, served = [], None, 0
    t0 = time.perf_counter()
    with loader:
        for batch in loader:
            served += 1
            k = row_keys(batch)
            got.append(k)
            if first_ok is None:
                # the first batch's columns against the arrays phase 5 wrote, by row key
                pos = np.searchsorted(keys, k.cpu().numpy())
                f, r = where[pos, 0], where[pos, 1]
                first_ok = True
                for name in TAB_COLUMNS:
                    want = np.empty(len(pos), arrays[0][name].dtype)
                    for fi in np.unique(f):
                        want[f == fi] = arrays[int(fi)][name][r[f == fi]]
                    first_ok &= torch.equal(batch[name].cpu(), torch.from_numpy(want))
        _sync(device)
        serve_s = time.perf_counter() - t0
    got = torch.cat(got).sort().values
    every_row = torch.equal(got, torch.from_numpy(keys).to(device))
    log("inmem (b): fill of %d rows in %.3f s (%.1f rows/s), memory_allocated +%d bytes; "
        "%d pass-through fill batches of %d, launches %s, %d host-inflated columns; %d "
        "batches served in %.3f s, %.1f rows/s; %s" % (
            rows, fill_s, rows / fill_s, store_mem, passthrough, -(-rows // TAB_BATCH),
            json.dumps(launches), cnt["host_inflate_columns"], served, serve_s,
            rows / serve_s, smi))
    check(every_row, "inmem (b): the served rows are not the store's rows, each once")
    check(bool(first_ok), "inmem (b): the first batch's columns differ from phase 5's "
          "arrays of the same rows")
    check(passthrough >= 1 and cnt["host_inflate_columns"] == 0,
          "inmem (b): %d pass-through fill batches, %d host-inflated columns"
          % (passthrough, cnt["host_inflate_columns"]))
    for k in ("K3", "scan", "K4"):
        check(launches[k] == predicted[k] * passthrough, "inmem (b): %s launched %d times "
              "for %d pass-through fill batches" % (k, launches[k], passthrough))
    return {"launches": launches, "passthrough_batches": passthrough, "fill_s": fill_s,
            "rows_per_s": rows / serve_s, "store_bytes": store_mem}


def phase_weighted(root, arrays, smi, device="cuda"):
    """(f) (comment above)."""
    import numpy as np
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.weighted_sampling import WeightedSamplingReader

    keys, where = _global_row_index(arrays)
    files = ["file://" + os.path.join(root, "part-%d.parquet" % f) for f in range(TAB_FILES)]
    readers = [make_batch_reader(files[:MIX_FILES], num_epochs=1),
               make_batch_reader(files[MIX_FILES:], num_epochs=1)]
    items = [MIX_FILES * TAB_RGS_PER_FILE, (TAB_FILES - MIX_FILES) * TAB_RGS_PER_FILE]
    mixer = WeightedSamplingReader(readers, list(MIX_P), seed=0)
    seen = np.zeros(len(keys), np.int32)
    origins = []
    t0 = time.perf_counter()
    with DataLoader(mixer, TAB_BATCH, device=device) as loader:
        for batch in loader:
            k = row_keys(batch).cpu().numpy()
            pos = np.searchsorted(keys, k)
            check(bool((keys[np.minimum(pos, len(keys) - 1)] == k).all()),
                  "mixer (f): a delivered row is no row of the store")
            seen[pos] += 1
            f = set((where[pos, 0] >= MIX_FILES).astype(int).tolist())
            check(len(f) == 1, "mixer (f): a batch mixes both readers' rows")
            origins.append(f.pop())
        _sync(device)
        wall = time.perf_counter() - t0
    rng = np.random.Generator(np.random.PCG64(0))
    left, drawn = list(items), []
    for got in origins:
        if min(left) == 0:
            break
        drawn.append(int(rng.choice([0, 1], p=list(MIX_P))))
        left[got] -= 1
    share = origins[:len(drawn)].count(0) / float(len(drawn))
    log("mixer (f): %d batches, %d while both readers lived (share of the first %.4f), "
        "%.1f rows/s (%.3f s); %s" % (len(origins), len(drawn), share,
                                       len(keys) / wall, wall, smi))
    check(origins[:len(drawn)] == drawn, "mixer (f): the items' origins do not follow "
          "numpy's Generator(PCG64(0)).choice while both readers are alive")
    check(bool((seen == 1).all()), "mixer (f): rows not delivered once each")
    return {"rows_per_s": len(keys) / wall, "alive_draws": len(drawn)}


def phase_adapters(root, smi, device="cuda"):
    """(g) (comment above)."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.adapters.pytorch import BatchedDataLoader
    from petastorm_tpu_torch.loader import DataLoader

    kw = dict(workers_count=1, shuffle_row_groups=False, num_epochs=1)
    t0 = time.perf_counter()
    with DataLoader(make_batch_reader("file://" + root, **kw), TAB_BATCH,
                    device=device) as loader:
        card = [{k: v.clone() for k, v in b.items()} for b in loader]
    batches, bad = 0, 0
    with BatchedDataLoader(make_batch_reader("file://" + root, **kw), TAB_BATCH) as adapter:
        for i, b in enumerate(adapter):
            batches += 1
            check(all(not v.is_cuda for v in b.values()), "adapters (g): the adapter "
                  "yielded tensors on the card")
            bad += sum(int(not torch.equal(v.to(device), card[i][k])) for k, v in b.items())
    _sync(device)
    wall = time.perf_counter() - t0
    log("adapters (g): %d BatchedDataLoader batches against %d DataLoader batches, %d "
        "columns apart (%.3f s); %s" % (batches, len(card), bad, wall, smi))
    check(batches == len(card) and bad == 0, "adapters (g): the adapter's columns differ "
          "from the DataLoader's for the same rows")
    return {"batches": batches}


# -- phase 11: the read path and the row-group caches -----------------------------------
#
# The JAX package's default read path (readahead of depth 3 over 2 IO threads a worker
# process, coalesced reads of up to 4 adjacent row groups, the work-stealing dispatcher,
# the 64 MiB shared footer cache) is the port's default since this phase's slice, so
# phases 4-10 already ran on it. Phase 11 holds it against the read path with all three
# off, and drives the caches: (a) the main path (phase 7's thread-pool run) at the
# defaults and all off, IO_ROUNDS rounds each, alternating which goes first; (b) phase
# 5's pass-through the same way, with the footer cache's own counts and a spy on every
# prefetch; (c) the main path with a memcache over two epochs, at MEMCACHE_SMALL (which
# must evict) and then MEMCACHE_BIG (which holds the store: epoch 2 runs no stage 1);
# (d) phase 5's store through cache_type="local-disk" (classic read), two epochs; (e)
# the process pool on 'arrow' with the readahead hints riding to the children.

IO_ALL_OFF = {"readahead": False, "coalesce": False, "work_stealing": False}
IO_ROUNDS = 3
MEMCACHE_SMALL, MEMCACHE_BIG = 300 << 20, 1 << 30
#: the main-path store's int16 coefficient bytes: 4,096 rows of 224x224 4:2:0 JPEG hold
#: 784 + 196 + 196 blocks of 64 coefficients (616,562,688 bytes)
COEF_BYTES = ROWS * (784 + 196 + 196) * 64 * 2
IO_KEYS = ("readahead_hits", "readahead_misses", "readahead_wait_s", "readahead_exposed_s",
           "coalesced_reads", "coalesced_items", "steals")


def _io_brief(io):
    return {k: io[k] for k in IO_KEYS if k in io}


def phase_read_path_jpeg(url, blobs, images, smi):
    """(a): phase 7's thread-pool run at the read path's defaults and with it all off.
    Each run holds every id once an epoch, every image to phase 7's of the same id, the
    first batch to the plain stage 2 and K2 to its plain version, and stage2_planes,
    stage2_rgb and K2 to one launch a batch (``pool_jpeg_run``)."""
    out = {"defaults": [], "all_off": []}
    for r in range(IO_ROUNDS):
        order = [("defaults", None), ("all_off", IO_ALL_OFF)]
        if r % 2:
            order.reverse()
        for name, opts in order:
            res = pool_jpeg_run(url, blobs, "thread", None, None, images, smi,
                                tag=" read path %s round %d" % (name, r), io_options=opts)
            w = res["window_ms"]
            log("read path (a) %s round %d: %.1f rows/s; read_s %.3f, decode_s %.3f ms a "
                "batch; io %s; %s" % (name, r, res["rows_per_s"], w["read_s"],
                                      w["decode_s"], json.dumps(_io_brief(res["io"])), smi))
            io = res["io"]
            if name == "defaults":
                check(io.get("readahead_hits", 0) > 0, "read path (a): no readahead hit at "
                      "the defaults: %s" % _io_brief(io))
            else:
                check("readahead_hits" not in io and io.get("steals", 0) == 0,
                      "read path (a): the all-off run prefetched or stole: %s"
                      % _io_brief(io))
            out[name].append(res)
    for name, runs in out.items():
        rates = [r["rows_per_s"] for r in runs]
        log("read path (a) %s: rows/s %s (median %.1f)" % (
            name, [round(x, 1) for x in rates], sorted(rates)[len(rates) // 2]))
    return out


def phase_read_path_tabular(root, arrays, predicted, smi):
    """(b): phase 5's pass-through (``pagedec="auto"``) at the defaults and all off.
    Each run holds phase 5's checks (one K3, scan and K4 launch a pass-through batch, 0
    host-inflated columns, the first and last measured batches byte-identical to the
    classic read). Across the runs: one footer parse a file (the footer cache's misses
    grow by the store's file count, from an emptied cache) and no pass-through column in
    any prefetch made while the pass-through was live."""
    import threading

    from petastorm_tpu_torch.io import readahead as ra
    from petastorm_tpu_torch.io.footercache import shared_footer_cache
    from petastorm_tpu_torch.reader import ArrowWorker

    local = threading.local()
    scheduled = []  # (pass-through live at the hint, requested columns)
    orig_prefetch, orig_schedule = ArrowWorker.prefetch, ra.ReadaheadPool.schedule

    def prefetch(self, items):
        local.live = self._pagedec_active()
        try:
            return orig_prefetch(self, items)
        finally:
            local.live = None

    def schedule(self, requests):
        requests = list(requests)
        scheduled.extend((getattr(local, "live", None), tuple(cols))
                         for _piece, cols in requests)
        return orig_schedule(self, requests)

    footers = shared_footer_cache()
    footers.clear()
    misses0 = footers.stats()["footer_cache_misses"]
    out = {"defaults": [], "all_off": []}
    ArrowWorker.prefetch, ra.ReadaheadPool.schedule = prefetch, schedule
    try:
        for r in range(IO_ROUNDS):
            order = [("defaults", None), ("all_off", IO_ALL_OFF)]
            if r % 2:
                order.reverse()
            for name, opts in order:
                launches, res = phase_tabular_path(
                    root, arrays, predicted, warmup=POOL_TAB_WARMUP,
                    measured=POOL_TAB_MEASURED, io_options=opts)
                w = res["window"]
                log("read path (b) %s round %d: %.1f rows/s; read_s %.3f, inflate_s %.3f "
                    "ms a batch; launches %s for %d pass-through batches; io %s; %s" % (
                        name, r, res["rows_per_s"], w["read_s"] / POOL_TAB_MEASURED * 1e3,
                        w["inflate_s"] / POOL_TAB_MEASURED * 1e3, json.dumps(launches),
                        res["passthrough_batches"], json.dumps(_io_brief(res["io"])), smi))
                out[name].append(res)
    finally:
        ArrowWorker.prefetch, ra.ReadaheadPool.schedule = orig_prefetch, orig_schedule
    fstats = footers.stats()
    parses = fstats["footer_cache_misses"] - misses0
    live = [cols for flag, cols in scheduled if flag]
    leaked = [cols for cols in live if set(cols) & set(TAB_COLUMNS)]
    log("read path (b): footer cache %s (%d parses for %d files over %d runs); %d "
        "prefetch requests, %d while the pass-through was live, %d of them naming a "
        "pass-through column" % (json.dumps(fstats), parses, TAB_FILES, 2 * IO_ROUNDS,
                                 len(scheduled), len(live), len(leaked)))
    check(parses == TAB_FILES, "read path (b): %d footer parses for %d files (one a file "
          "a process expected)" % (parses, TAB_FILES))
    check(fstats["footer_cache_hits"] > 0, "read path (b): the footer cache served nothing")
    check(not leaked, "read path (b): a prefetch named pass-through columns: %s"
          % leaked[:3])
    for name, runs in out.items():
        rates = [r["rows_per_s"] for r in runs]
        log("read path (b) %s: rows/s %s (median %.1f)" % (
            name, [round(x, 1) for x in rates], sorted(rates)[len(rates) // 2]))
    return out


def _memcache_run(url, images, budget, smi):
    """Two epochs of the main path with ``memcache_bytes=budget``, one reader each (the
    process-wide store carries the row groups from the first to the second; emptied
    before and after): every id once an epoch, every image equal to phase 7's,
    stage2_planes, stage2_rgb and K2 once a batch. Returns each epoch's rows through
    stage 1, tier counts and rows/s, and the store's counts after epoch 2. One reader an
    epoch, because a reader running two epochs overlaps them (its workers' claims cross
    the boundary), and an epoch-2 item may then run before its epoch-1 twin is cached."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.io.memcache import shared_store
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    per_epoch = ROWS // BATCH
    store = shared_store()
    store.clear()
    store0 = store.stats()

    def transform(batch):
        return {**batch, "image": image.normalize_images(batch["image"], MEAN, STD),
                "image_u8": batch["image"]}

    dev = torch.device("cuda")
    label = "read path (c) memcache %d bytes" % budget
    epochs = []
    for epoch in range(2):
        counts = torch.zeros(ROWS, dtype=torch.int32, device=dev)
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        first = None
        with count_stage1_rows() as staged:
            reader = make_batch_reader(url, workers_count=workers, shuffle_row_groups=True,
                                       seed=epoch, num_epochs=1, decode_on_device=True,
                                       io_options={"memcache_bytes": budget})
            counters = _jpeg_launch_counters(zero=True)
            with DataLoader(reader, BATCH, device="cuda", device_transform=transform,
                            prefetch=3, host_queue_size=8) as loader:
                for i, batch in enumerate(loader):
                    ids, u8 = batch["id"], batch["image_u8"]
                    counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
                    bad.add_((images.index_select(0, ids) != u8).sum())
                    if first is None:
                        first = (u8[:8].clone(), batch["image"][:8].clone())
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                torch.cuda.synchronize()
                rate = (per_epoch - 1) * BATCH / (time.perf_counter() - t0)
                io = reader.io_stats()
            counters = _jpeg_launch_counters()
        c = counts.cpu()
        tiers = {k: v for k, v in io.items() if k.startswith("tier_")}
        log("%s epoch %d: %.1f rows/s (batches 2-%d); stage 1 %d rows; tiers %s; "
            "launches %s; %s" % (label, epoch + 1, rate, per_epoch, sum(staged),
                                 json.dumps(tiers), json.dumps(counters), smi))
        check(bool((c == 1).all()), "%s epoch %d: ids delivered %s times, not once each"
              % (label, epoch + 1, sorted(set(c.tolist()))))
        check(bad.item() == 0, "%s epoch %d: %d uint8 values differ from phase 7's images "
              "of the same ids" % (label, epoch + 1, bad.item()))
        check(counters["stage2_planes"] == counters["stage2_rgb"] == counters["K2"]
              == per_epoch, "%s epoch %d: stage2_planes, stage2_rgb and K2 should launch "
              "once a batch (%d): %s" % (label, epoch + 1, per_epoch, counters))
        check(torch.equal(image._normalize_plain(first[0], MEAN, STD, torch.bfloat16),
                          first[1]), "%s: K2 differs from its plain version" % label)
        epochs.append({"staged_rows": sum(staged), "tiers": tiers, "rows_per_s": rate,
                       "launches": counters})
    torch.cuda.synchronize()
    mem = store.stats()
    store.clear()
    log("%s: store after epoch 2 %s" % (label, json.dumps(mem)))
    return {"label": label, "epochs": epochs, "mem": mem,
            "evictions": mem["memcache_evictions"] - store0["memcache_evictions"]}


def phase_read_path_memcache(url, images, smi):
    """(c): the main path over two epochs with a memcache. MEMCACHE_SMALL first (the
    store's budget only grows: the big budget afterwards raises it), which cannot hold
    the store's ~616 MB of coefficients and must evict; then MEMCACHE_BIG, which holds
    it: epoch 2 is served from memory for all 16 row groups and runs no stage 1, and the
    store counts at least the coefficient bytes (ROADMAP.md Queue 3 M)."""
    small = _memcache_run(url, images, MEMCACHE_SMALL, smi)
    check(small["evictions"] > 0, "%s: no eviction" % small["label"])
    big = _memcache_run(url, images, MEMCACHE_BIG, smi)
    one, two = big["epochs"]
    row_groups = one["tiers"]["tier_remote_hits"]
    check(one["staged_rows"] == ROWS and two["staged_rows"] == 0, "%s: %d and %d rows "
          "through stage 1 in epochs 1 and 2 (%d and 0 expected)" % (
              big["label"], one["staged_rows"], two["staged_rows"], ROWS))
    check(row_groups >= ROWS // 270 and two["tiers"]["tier_mem_hits"] == row_groups
          and two["tiers"]["tier_remote_hits"] == 0, "%s: epoch 2 not served from memory "
          "for every row group: %s" % (big["label"], two["tiers"]))
    check(big["evictions"] == 0, "%s: %d evictions" % (big["label"], big["evictions"]))
    check(big["mem"]["memcache_held_bytes"] >= COEF_BYTES, "%s: the store counts %d bytes, "
          "less than the %d bytes of coefficients it holds" % (
              big["label"], big["mem"]["memcache_held_bytes"], COEF_BYTES))
    log("read path (c): %d row groups served from memory in epoch 2, 0 rows through stage "
        "1 there (%.1f rows/s against %.1f in epoch 1); the store counted %d bytes for %d "
        "bytes of coefficients; the small budget evicted %d entries, delivery exact" % (
            row_groups, two["rows_per_s"], one["rows_per_s"],
            big["mem"]["memcache_held_bytes"], COEF_BYTES, small["evictions"]))
    return {"small": small, "big": big}


def phase_read_path_disk(root, arrays, work, smi):
    """(d): phase 5's store through ``cache_type="local-disk"`` (the classic read,
    ``pagedec="off"``) into the DataLoader on the card, two epochs of one reader each
    (the cache directory carries the row groups over): epoch 2 from the disk tier,
    every row group once an epoch and equal to the source arrays."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    cache_dir = os.path.join(work, "disk_cache")
    per_epoch = TAB_FILES * TAB_RGS_PER_FILE
    epochs = []
    for epoch in range(2):
        reader = make_batch_reader("file://" + root, workers_count=workers,
                                   shuffle_row_groups=True, seed=epoch, num_epochs=1,
                                   cache_type="local-disk", cache_location=cache_dir,
                                   io_options={"pagedec": "off"})
        seen = {}
        t0 = time.perf_counter()
        with DataLoader(reader, TAB_BATCH, device="cuda", prefetch=3) as loader:
            for batch in loader:
                check(all(batch[c].is_cuda for c in TAB_COLUMNS), "read path (d): a "
                      "column is not on the card")
                host = {c: batch[c].cpu().numpy() for c in TAB_COLUMNS}
                f, rg = _rowgroup_of({c: host[c][0] for c in TAB_COLUMNS}, arrays,
                                     TAB_BATCH)
                seen[(f, rg)] = seen.get((f, rg), 0) + 1
                for c in TAB_COLUMNS:
                    src = arrays[f][c][rg * TAB_BATCH:(rg + 1) * TAB_BATCH]
                    check(host[c].dtype == src.dtype and host[c].tobytes() == src.tobytes(),
                          "read path (d): column %s of file %d row group %d differs from "
                          "the source" % (c, f, rg))
            torch.cuda.synchronize()
            rate = per_epoch * TAB_BATCH / (time.perf_counter() - t0)
            io = reader.io_stats()
        tiers = {k: v for k, v in io.items() if k.startswith("tier_")}
        check(len(seen) == per_epoch and set(seen.values()) == {1}, "read path (d) epoch "
              "%d: row groups delivered %s times" % (epoch + 1, sorted(set(seen.values()))))
        epochs.append({"rows_per_s": rate, "tiers": tiers})
    disk_bytes = sum(os.path.getsize(os.path.join(cache_dir, f))
                     for f in os.listdir(cache_dir))
    log("read path (d) local-disk: epoch 1 %.1f rows/s (tiers %s), epoch 2 %.1f rows/s "
        "(tiers %s), each batch checked on the host, the reader's start included; cache "
        "directory %d bytes in %d files; %s" % (
            epochs[0]["rows_per_s"], json.dumps(epochs[0]["tiers"]),
            epochs[1]["rows_per_s"], json.dumps(epochs[1]["tiers"]), disk_bytes,
            len(os.listdir(cache_dir)), smi))
    check(epochs[0]["tiers"]["tier_remote_hits"] == per_epoch
          and epochs[1]["tiers"]["tier_disk_hits"] == per_epoch
          and epochs[1]["tiers"]["tier_remote_hits"] == 0,
          "read path (d): epoch 2 not served from the disk tier: %s" % epochs)
    shutil.rmtree(cache_dir, ignore_errors=True)
    return {"epochs": epochs, "disk_bytes": disk_bytes}


def phase_read_path_pool(url, blobs, images, smi):
    """(e): the process pool on 'arrow' at the defaults: the readahead hints ride to the
    children with each item, and every child's own readahead pool hits; the rest is
    phase 7's run (every id once an epoch, images equal to phase 7's per id)."""
    res = pool_jpeg_run(url, blobs, "process", "arrow", None, images, smi,
                        tag=" read path hints")
    children = res["io"]["children"]
    brief = {i: _io_brief(c) for i, c in sorted(children.items())}
    log("read path (e) process/arrow: %.1f rows/s; children's io %s; steals %s; %s" % (
        res["rows_per_s"], json.dumps(brief), res["io"].get("steals"), smi))
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    check(len(children) == workers and all(c.get("readahead_hits", 0) > 0
                                           for c in children.values()),
          "read path (e): a child's readahead never hit: %s" % brief)
    return res


# -- phase 12: the object-store tier and the host-wide cache arena ---------------------
#
# Every store behind the port's cloud simulator (CloudLatencyFS at the JAX package's
# defaults: a 5 ms floor with a lognormal spread, ~1 s/GB, 2 % of GETs at 10x; seeded,
# sleeping), passed as ``filesystem=``: its ``type_name`` engages the ranged-GET engine.
# The simulator's delays are the simulator's, not a real store's.

REMOTE_SEED = 13
REMOTE_ROUNDS = 3
#: (b)'s split epochs: phase 5's columns in row groups of 65,536 rows and 16 KB pages
#: (phase 5's own chunks, 44.5 KB at most, are under the engine's 64 KB request floor)
SPLIT_FILES, SPLIT_RGS_PER_FILE, SPLIT_RG_ROWS, SPLIT_PAGE = 2, 2, 65536, 16 << 10
SPLIT_TARGET = 64 << 10
HEDGE_EPOCHS = 3
#: (c) reads 1/HEDGE_SHARDS of phase 5's row groups: every row group's 40 column GETs
#: share one engine's 8 in flight, and 30 % of them at 10x make a full epoch ~13 s
HEDGE_SHARDS = 4
#: (d): the main path's 616,562,688 coefficient bytes, their tables and pickled meta
ARENA_BYTES = 1 << 30
ARENA_WORKERS = 7


def cloud_fs(**kw):
    """The store simulator over the local disk (``kw`` overrides its defaults)."""
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.io.latencyfs import CloudLatencyFS

    return CloudLatencyFS(pafs.LocalFileSystem(), sleep=True, seed=REMOTE_SEED, **kw)


def _store_files(root):
    return sorted(os.path.join(root, f) for f in os.listdir(root)
                  if f.endswith(".parquet") and not f.startswith("_"))


def _footer_windows(files):
    """({path: size}, {path: footer length + 8}) of each file, from its last 8 bytes."""
    sizes, windows = {}, {}
    for path in files:
        sizes[path] = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(-8, 2)
            windows[path] = int.from_bytes(f.read(4), "little") + 8
    return sizes, windows


def _delay_quantiles(fs):
    """(p50, p99) of the simulator's delays over its logged GETs, in ms."""
    delays = sorted(r["delay_s"] for r in fs.requests)
    if not delays:
        return None, None
    return (delays[len(delays) // 2] * 1e3,
            delays[min(len(delays) - 1, int(len(delays) * 0.99))] * 1e3)


def phase_remote_jpeg(url, blobs, images, smi):
    """(a): phase 7's thread-pool run of the main path read from the simulator against
    the same store read locally, REMOTE_ROUNDS rounds alternating which goes first, from
    an emptied footer cache. ``pool_jpeg_run`` holds every id once an epoch, every image
    to phase 7's (the local read's) of the same id, the first batch to the plain stage 2
    and K2 to its plain version, and stage2_planes, stage2_rgb and K2 to one launch a
    batch. Here: GETs > 0, no sparse fallback, at most one footer GET a file in this
    process over all rounds."""
    from petastorm_tpu_torch.io.footercache import shared_footer_cache

    root = url[len("file://"):]
    files = _store_files(root)
    sizes, windows = _footer_windows(files)
    shared_footer_cache().clear()
    out = {"remote": [], "local": []}
    footer_gets = dict.fromkeys(files, 0)
    for r in range(REMOTE_ROUNDS):
        order = ["remote", "local"]
        if r % 2:
            order.reverse()
        for name in order:
            fs = cloud_fs() if name == "remote" else None
            res = pool_jpeg_run(url, blobs, "thread", None, None, images, smi,
                                tag=" store %s round %d" % (name, r), filesystem=fs)
            w, io = res["window_ms"], res["io"]
            if fs is not None:
                per_file = dict.fromkeys(files, 0)
                for q in fs.footer_requests(sizes, windows):
                    per_file[q["path"]] += 1
                for path, n in per_file.items():
                    footer_gets[path] += n
                p50, p99 = _delay_quantiles(fs)
                res.update(gets=io.get("remote_gets", 0), p50_ms=p50, p99_ms=p99,
                           footer_gets=[per_file[p] for p in files],
                           requests=fs.request_count())
                log("object store (a) remote round %d: %.1f rows/s; read_s %.3f, decode_s "
                    "%.3f ms a batch; remote_gets %d, remote_hedges %d, "
                    "remote_sparse_fallbacks %d, footer GETs a file %s, simulator delay "
                    "p50 %.3f ms p99 %.3f ms over %d requests; %s" % (
                        r, res["rows_per_s"], w["read_s"], w["decode_s"], res["gets"],
                        io.get("remote_hedges", 0), io.get("remote_sparse_fallbacks", -1),
                        res["footer_gets"], p50, p99, res["requests"], smi))
                check(res["gets"] > 0, "object store (a): no ranged GET (the engine did "
                      "not engage): %s" % sorted(io))
                check(io.get("remote_sparse_fallbacks", -1) == 0, "object store (a): "
                      "%s sparse fallbacks" % io.get("remote_sparse_fallbacks"))
            else:
                log("object store (a) local round %d: %.1f rows/s; read_s %.3f, decode_s "
                    "%.3f ms a batch; %s" % (r, res["rows_per_s"], w["read_s"],
                                            w["decode_s"], smi))
            out[name].append(res)
    check(all(n <= 1 for n in footer_gets.values()), "object store (a): footer GETs a "
          "file over %d rounds in one process %s (at most 1 each)" % (
              REMOTE_ROUNDS, sorted(footer_gets.values())))
    for name, runs in out.items():
        rates = [x["rows_per_s"] for x in runs]
        log("object store (a) %s: rows/s %s (median %.1f)" % (
            name, [round(x, 1) for x in rates], sorted(rates)[len(rates) // 2]))
    out["footer_gets"] = sorted(footer_gets.values())
    return out


def _chunk_ranges(path):
    """{(row group, column): (start, length)} of one file's column chunks."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.io.pagedec import chunk_byte_range

    md = pq.read_metadata(path)
    out = {}
    for rg in range(md.num_row_groups):
        rgmd = md.row_group(rg)
        for i in range(rgmd.num_columns):
            out[(rg, rgmd.column(i).path_in_schema)] = chunk_byte_range(rgmd.column(i))
    return out


def _split_epoch(root, arrays, predicted, fs, epoch, dev="cuda"):
    """One epoch of (b)'s split store through the pass-through (``pagedec="on"``) into
    the DataLoader on the card, from the simulator at
    ``target_request_bytes=SPLIT_TARGET``: every batch byte-identical to the source
    arrays, one K3, scan and K4 launch a batch."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader

    fs.reset_accounting()
    counters = _tab_launch_counters(zero=True)
    seen = {}
    # pagedec "on": every row group's raw chunks go through the engine's planner from the
    # first read ("auto" would read the row groups fetched before the loader adopted
    # the reader classically, with splits at the target)
    reader = make_batch_reader("file://" + root, filesystem=fs, workers_count=2,
                               shuffle_row_groups=True, seed=epoch,
                               io_options={"pagedec": "on", "remote": {
                                   "target_request_bytes": SPLIT_TARGET}})
    t0 = time.perf_counter()
    with DataLoader(reader, SPLIT_RG_ROWS, device=dev, prefetch=2) as loader:
        for batch in loader:
            host = {c: batch[c].cpu().numpy() for c in TAB_COLUMNS}
            f, rg = _rowgroup_of({c: host[c][0] for c in TAB_COLUMNS}, arrays,
                                 SPLIT_RG_ROWS)
            seen[(f, rg)] = seen.get((f, rg), 0) + 1
            for c in TAB_COLUMNS:
                src = arrays[f][c][rg * SPLIT_RG_ROWS:(rg + 1) * SPLIT_RG_ROWS]
                check(host[c].dtype == src.dtype and host[c].tobytes() == src.tobytes(),
                      "object store (b) split epoch %d: column %s of file %d row group "
                      "%d differs from the source" % (epoch, c, f, rg))
        torch.cuda.synchronize() if dev == "cuda" else None
        dt = time.perf_counter() - t0
        io = reader.io_stats()
    counters = _tab_launch_counters()
    batches = SPLIT_FILES * SPLIT_RGS_PER_FILE
    check(len(seen) == batches and set(seen.values()) == {1}, "object store (b) split "
          "epoch %d: row groups delivered %s" % (epoch, seen))
    check(all(counters[k] == predicted[k] * batches for k in ("K3", "scan", "K4")),
          "object store (b) split epoch %d: launches %s for %d batches" % (
              epoch, counters, batches))
    return {"requests": list(fs.requests), "rows_per_s": batches * SPLIT_RG_ROWS / dt,
            "launches": counters, "gets": io.get("remote_gets", 0)}


def phase_remote_tabular(root, arrays, predicted, work, smi):
    """(b): phase 5's pass-through from the simulator beside the local read
    (``phase_tabular_path``'s checks: byte identity against the classic read, 0
    host-inflated columns, one K3, scan and K4 launch a pass-through batch), then the
    split store's two epochs: the first splits chunks over the target at the target
    (no page index yet), the second only at page starts of ``shared_page_index()``."""
    from petastorm_tpu_torch.io.pagedec import shared_page_index
    from petastorm_tpu_torch.reader import ArrowWorker

    out = {}
    fetched = []  # one entry a row group whose raw chunks were fetched
    orig = ArrowWorker._pagedec_fetch_raw

    def counting(self, piece, eligible, rgmd):
        fetched.append(1)
        return orig(self, piece, eligible, rgmd)

    for name in ("remote", "local"):
        fs = cloud_fs() if name == "remote" else None
        del fetched[:]
        ArrowWorker._pagedec_fetch_raw = counting
        try:
            launches, res = phase_tabular_path(root, arrays, predicted,
                                               warmup=POOL_TAB_WARMUP,
                                               measured=POOL_TAB_MEASURED, filesystem=fs)
        finally:
            ArrowWorker._pagedec_fetch_raw = orig
        io = res["io"]
        # a batch is a row group; the readers run ahead of the consumer, so GETs are
        # counted against the row groups they fetched, footer GETs aside
        res["gets_a_batch"] = (io.get("remote_gets", 0) - io.get("remote_footer_fetches", 0)
                               ) / max(1, len(fetched))
        if fs is not None:
            check(res["io"].get("remote_gets", 0) > 0 and
                  res["io"].get("remote_sparse_fallbacks", -1) == 0,
                  "object store (b): GETs %s, sparse fallbacks %s" % (
                      res["io"].get("remote_gets"), res["io"].get("remote_sparse_fallbacks")))
        log("object store (b) pass-through %s: %.1f rows/s; launches %s for %d "
            "pass-through batches; %.2f GETs a batch; %s" % (
                name, res["rows_per_s"], json.dumps(launches), res["passthrough_batches"],
                res["gets_a_batch"], smi))
        out[name] = res
    split_root = os.path.join(work, "tabular_split")
    _url, split_arrays = write_tabular_store(split_root, seed=7, files=SPLIT_FILES,
                                             rgs_per_file=SPLIT_RGS_PER_FILE,
                                             rg_rows=SPLIT_RG_ROWS,
                                             data_page_size=SPLIT_PAGE)
    split_predicted = tabular_structure(split_root, SPLIT_FILES, SPLIT_RGS_PER_FILE)
    files = _store_files(split_root)
    chunks = {(path,) + key: rng for path in files
              for key, rng in _chunk_ranges(path).items()}
    big = {k: v for k, v in chunks.items() if v[1] > SPLIT_TARGET}
    check(big, "object store (b): no chunk of the split store is over %d bytes"
          % SPLIT_TARGET)
    shared_page_index().clear()
    fs = cloud_fs()
    epochs = []
    for epoch in range(2):
        res = _split_epoch(split_root, split_arrays, split_predicted, fs, epoch)
        cuts = {}  # chunk -> request starts strictly inside it (planning tail reads aside)
        for q in res["requests"]:
            if q["offset"] + q["nbytes"] >= os.path.getsize(q["path"]):
                continue
            for (path, rg, col), (start, length) in big.items():
                if path == q["path"] and start < q["offset"] < start + length:
                    cuts.setdefault((path, rg, col), []).append(q["offset"])
        res["cuts"] = cuts
        epochs.append(res)
    off_page = []
    for (path, rg, col), offs in epochs[1]["cuts"].items():
        index = shared_page_index().get(path, rg, col)
        pages = set(index[1]) if index is not None else set()
        off_page.extend(o for o in offs if o not in pages)
    first_cuts = sum(len(v) for v in epochs[0]["cuts"].values())
    second_cuts = sum(len(v) for v in epochs[1]["cuts"].values())
    first_on_pages = sum(
        o in set((shared_page_index().get(*k) or (0, ()))[1])
        for k, v in epochs[0]["cuts"].items() for o in v)
    log("object store (b) split store: %d chunks, %d over the %d-byte target; epoch 1 "
        "split them %d times (%d at a page start), epoch 2 %d times, %d of them off a "
        "walked page start; epochs %.1f and %.1f rows/s, %d and %d GETs; %s" % (
            len(chunks), len(big), SPLIT_TARGET, first_cuts, first_on_pages, second_cuts,
            len(off_page), epochs[0]["rows_per_s"], epochs[1]["rows_per_s"],
            epochs[0]["gets"], epochs[1]["gets"], smi))
    check(first_cuts > 0 and second_cuts > 0, "object store (b): the chunks over the "
          "target were not split (%d, %d)" % (first_cuts, second_cuts))
    check(not off_page, "object store (b): epoch 2 split chunks off their walked page "
          "starts at %s" % off_page[:5])
    out["split"] = {"chunks": len(chunks), "big": len(big), "cuts": [first_cuts, second_cuts],
                    "first_on_pages": first_on_pages,
                    "launches": [e["launches"] for e in epochs],
                    "rows_per_s": [e["rows_per_s"] for e in epochs]}
    shutil.rmtree(split_root, ignore_errors=True)
    return out


def _batch_digest(batch):
    """One int64 a column over a batch: the sum of its 32-bit words weighted by their
    row index, on the card (equal digests: equal batches, with overwhelming odds)."""
    import torch

    n = batch[TAB_COLUMNS[0]].shape[0]
    w = torch.arange(1, n + 1, device=batch[TAB_COLUMNS[0]].device, dtype=torch.int64)
    return torch.stack([(batch[c].view(torch.int32).to(torch.int64) * w).sum()
                        for c in TAB_COLUMNS]).cpu().numpy()


def _hedge_run(root, arrays, hedge, smi, dev="cuda"):
    """HEDGE_EPOCHS epochs of a shard (1/HEDGE_SHARDS) of phase 5's row groups through
    the pass-through (``pagedec="on"``: every row group's raw chunks through the engine,
    none read classically before the loader adopts the reader) from a simulator with
    30 % of GETs at 10x, readahead off: {(file,
    row group): digests}, the row-group GET plans' seconds, hedges and the lease
    deltas."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.io.lease import lease_stats
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.reader import ArrowWorker

    fs = cloud_fs(tail_fraction=0.3, tail_multiplier=10)
    plan_s = []
    orig = ArrowWorker._pagedec_fetch_raw

    def timed(self, piece, eligible, rgmd):
        t0 = time.perf_counter()
        try:
            return orig(self, piece, eligible, rgmd)
        finally:
            plan_s.append(time.perf_counter() - t0)

    leases0 = lease_stats()
    digests = {}
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    counters = _tab_launch_counters(zero=True)
    ArrowWorker._pagedec_fetch_raw = timed
    try:
        reader = make_batch_reader("file://" + root, filesystem=fs, workers_count=workers,
                                   shuffle_row_groups=True, seed=0,
                                   num_epochs=HEDGE_EPOCHS, cur_shard=0,
                                   shard_count=HEDGE_SHARDS,
                                   io_options={"pagedec": "on", "readahead": False,
                                               "remote": {"hedge": hedge,
                                                          "hedge_min_samples": 6,
                                                          "hedge_min_s": 0.002}})
        items = len(reader._plan._items)
        t0 = time.perf_counter()
        batches = 0
        with DataLoader(reader, TAB_BATCH, device=dev, prefetch=3) as loader:
            for batch in loader:
                batches += 1
                first = {c: batch[c][0].item() for c in TAB_COLUMNS}
                key = _rowgroup_of(first, arrays, TAB_BATCH)
                digests.setdefault(key, []).append(_batch_digest(batch))
            torch.cuda.synchronize() if dev == "cuda" else None
            dt = time.perf_counter() - t0
            io = reader.io_stats()
    finally:
        ArrowWorker._pagedec_fetch_raw = orig
    counters = _tab_launch_counters()
    leases = {k: lease_stats()[k] - leases0[k] for k in ("acquired", "released", "leaked")}
    plan_s.sort()
    p99 = plan_s[min(len(plan_s) - 1, int(len(plan_s) * 0.99))] if plan_s else None
    p50 = plan_s[len(plan_s) // 2] if plan_s else None
    label = "object store (c) hedge=%s" % hedge
    log("%s: %d batches over %d epochs, %.1f rows/s; remote_hedges %d, remote_hedge_wins "
        "%d, remote_gets %d; a row group's GET plan p50 %.4f s p99 %.4f s over %d; "
        "launches %s; leases %s; %s" % (
            label, batches, HEDGE_EPOCHS, batches * TAB_BATCH / dt, io.get("remote_hedges", 0),
            io.get("remote_hedge_wins", 0), io.get("remote_gets", 0), p50, p99, len(plan_s),
            json.dumps(counters), leases, smi))
    check(batches == HEDGE_EPOCHS * items and len(digests) == items and all(
        len(v) == HEDGE_EPOCHS for v in digests.values()), "%s: row groups delivered "
        "%s times" % (label, sorted({len(v) for v in digests.values()})))
    check(all(all((d == v[0]).all() for d in v) for v in digests.values()),
          "%s: one row group's batches differ between epochs" % label)
    check(all(counters[k] == batches for k in ("K3", "scan", "K4")), "%s: launches %s "
          "for %d batches" % (label, counters, batches))
    check(leases["leaked"] == 0 and leases["acquired"] == leases["released"],
          "%s: leases %s (a GET's lease left held)" % (label, leases))
    return {"digests": digests, "hedges": io.get("remote_hedges", 0),
            "hedge_wins": io.get("remote_hedge_wins", 0), "p50_s": p50, "p99_s": p99,
            "rows_per_s": batches * TAB_BATCH / dt, "launches": counters}


def phase_remote_hedging(root, arrays, smi):
    """(c): the pass-through from a heavy-tailed simulator with hedging on, then off:
    hedges fire with it on (none off), the batches of every row group equal between the
    runs and across epochs, no lease left held."""
    on = _hedge_run(root, arrays, True, smi)
    off = _hedge_run(root, arrays, False, smi)
    check(on["hedges"] >= 1, "object store (c): no hedge fired with hedging on")
    check(off["hedges"] == 0, "object store (c): %d hedges with hedging off" % off["hedges"])
    check(sorted(on["digests"]) == sorted(off["digests"]) and all(
        (on["digests"][k][0] == off["digests"][k][0]).all() for k in on["digests"]),
        "object store (c): the batches differ between the hedged and unhedged runs")
    log("object store (c): %d hedges (%d won); a row group's GET plan p99 %.4f s hedged "
        "against %.4f s unhedged; batches equal" % (
            on["hedges"], on["hedge_wins"], on["p99_s"], off["p99_s"]))
    return {"on": on, "off": off}


def _arena_epoch(url, images, io_options, shard_count, epoch, label, smi):
    """One epoch of the main path from the simulator on a process pool of ARENA_WORKERS
    children over 'arrow': every id (of the shard) once, images equal to phase 7's,
    K2 equal to its plain version, stage2_planes, stage2_rgb and K2 once a batch.
    Returns rows/s, the children's summed io counts, their resident memory and the
    launches."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image

    def transform(batch):
        return {**batch, "image": image.normalize_images(batch["image"], MEAN, STD),
                "image_u8": batch["image"]}

    dev = torch.device("cuda")
    counts = torch.zeros(ROWS, dtype=torch.int32, device=dev)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    reader = make_batch_reader(url, filesystem=cloud_fs(), reader_pool_type="process",
                               workers_count=ARENA_WORKERS, wire_serializer="arrow",
                               shuffle_row_groups=True, seed=epoch, num_epochs=1,
                               decode_on_device=True, results_timeout_s=300,
                               cur_shard=0 if shard_count > 1 else None,
                               shard_count=shard_count if shard_count > 1 else None,
                               io_options=io_options)
    reader_files = len({item[0].path for item in reader._plan._items})
    first = None
    rss = {}
    batches = 0
    counters = _jpeg_launch_counters(zero=True)
    t0 = time.perf_counter()
    with DataLoader(reader, BATCH, device="cuda", device_transform=transform, prefetch=3,
                    host_queue_size=8, last_batch="partial") as loader:
        for batch in loader:
            batches += 1
            ids, u8 = batch["id"], batch["image_u8"]
            counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
            bad.add_((images.index_select(0, ids) != u8).sum())
            if first is None:
                first = (u8[:8].clone(), batch["image"][:8].clone())
                rss = child_report(reader._executor.child_pids())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        io = reader.io_stats()
        children = io.get("children", {})
    counters = _jpeg_launch_counters()
    c = counts.cpu()
    delivered = int((c > 0).sum())
    summed = {}
    for child in children.values():
        for k, v in child.items():
            if isinstance(v, (int, float)) and k.startswith(("remote_", "tier_", "arena_",
                                                             "memcache_")):
                summed[k] = summed.get(k, 0) + v
    log("%s epoch %d: %.1f rows/s (%d batches, the pool's start included); children's "
        "io %s; children's resident MiB %s; launches %s; %s" % (
            label, epoch, delivered / dt, batches,
            json.dumps({k: summed[k] for k in sorted(summed) if k in (
                "remote_gets", "remote_footer_fetches", "remote_footer_arena_maps",
                "remote_sparse_fallbacks", "tier_mem_hits", "tier_arena_hits",
                "tier_remote_hits", "arena_hits", "arena_admits")}),
            [round(m, 1) for m, _c in rss.values()], json.dumps(counters), smi))
    if shard_count == 1:
        check(bool((c == 1).all()), "%s epoch %d: ids delivered %s times, not once each"
              % (label, epoch, sorted(set(c.tolist()))))
    else:  # a shard of the row groups: each of its ids once
        check(bool((c <= 1).all()) and delivered > 0, "%s epoch %d: ids delivered %s "
              "times" % (label, epoch, sorted(set(c.tolist()))))
    check(bad.item() == 0, "%s epoch %d: %d uint8 values differ from phase 7's images of "
          "the same ids" % (label, epoch, bad.item()))
    check(counters["stage2_planes"] == counters["stage2_rgb"] == counters["K2"] == batches,
          "%s epoch %d: stage2_planes, stage2_rgb and K2 should launch once a batch (%d): "
          "%s" % (label, epoch, batches, counters))
    check(torch.equal(image._normalize_plain(first[0], MEAN, STD, torch.bfloat16),
                      first[1]), "%s: K2 differs from its plain version" % label)
    check(all(not cuda for _m, cuda in rss.values()), "%s: a child mapped libcuda" % label)
    return {"rows_per_s": delivered / dt, "io": summed, "rss_mib": [m for m, _c in
                                                                    rss.values()],
            "launches": counters, "delivered": delivered, "files": reader_files}


def phase_remote_arena(url, images, smi):
    """(d): the main path from the simulator on a process pool, two epochs (one reader
    each: fresh children attach the arena the first epoch's children filled), with a
    1 GiB arena and memcache and then without the arena. With it: epoch 2 takes no
    store GET in any child (data or footer) and no row through stage 1 (no store-tier
    serve), the arena serves, each file's footer is fetched once across the pool's
    children; after close no ``ptpu_torch_arena_*`` segment is left in /dev/shm."""
    import glob

    from petastorm_tpu_torch.io import arena as arena_mod
    from petastorm_tpu_torch.io.footercache import shared_footer_cache
    from petastorm_tpu_torch.io.memcache import shared_store

    free, df = shm_state()
    log("object store (d): /dev/shm: %s" % df)
    shard_count = 1
    if free is not None and free < ARENA_BYTES + (64 << 20):
        shard_count = -(-(ARENA_BYTES + (64 << 20)) // max(1, free))
        log("object store (d): /dev/shm holds %d bytes, less than the %d-byte arena: "
            "reading 1/%d of the row groups" % (free, ARENA_BYTES, shard_count))
    out = {"shard_count": shard_count}
    for mode, arena_bytes in (("arena", ARENA_BYTES), ("no_arena", 0)):
        shared_footer_cache().clear()
        shared_store().clear()
        label = "object store (d) %s" % mode
        io_options = {"arena_bytes": arena_bytes, "memcache_bytes": ARENA_BYTES}
        epochs = [_arena_epoch(url, images, io_options, shard_count, e, label, smi)
                  for e in (1, 2)]
        stats = {}
        arena_obj = arena_mod.process_arena()
        if arena_obj is not None:
            stats = {k: v for k, v in arena_obj.stats().items()
                     if k in ("arena_payload_bytes", "arena_entries", "arena_budget_bytes",
                              "arena_attached", "arena_held_entries")}
        arena_mod.close_process_arena()
        left = glob.glob("/dev/shm/%s*" % arena_mod.ARENA_PREFIX)
        one, two = epochs
        files = one["files"]
        log("%s: epochs %.1f and %.1f rows/s; arena %s; footer fetches in the children "
            "%d and %d for %d files; after close %d arena segments in /dev/shm; %s" % (
                label, one["rows_per_s"], two["rows_per_s"], json.dumps(stats),
                one["io"].get("remote_footer_fetches", 0),
                two["io"].get("remote_footer_fetches", 0), files, len(left), smi))
        check(not left, "%s: arena segments left after close: %s" % (label, left[:5]))
        if mode == "arena":
            check(stats.get("arena_payload_bytes", 0) > 0 and stats.get("arena_entries", 0)
                  > 0, "%s: the arena holds nothing: %s" % (label, stats))
            # a child that read nothing never built its engine: no remote_* counts at all
            check(two["io"].get("remote_gets", 0) == 0, "%s: epoch 2 took %s store GETs "
                  "in the children" % (label, two["io"].get("remote_gets")))
            check(two["io"].get("tier_remote_hits", -1) == 0 and two["io"].get(
                "tier_arena_hits", 0) > 0, "%s: epoch 2 not served from the arena: %s" % (
                    label, two["io"]))
            check(one["io"].get("remote_footer_fetches", -1) == files, "%s: %s footer "
                  "fetches across the pool in epoch 1 for %d files (one each expected)" % (
                      label, one["io"].get("remote_footer_fetches"), files))
        else:
            check(two["io"].get("tier_remote_hits", 0) > 0, "%s: epoch 2 read nothing from "
                  "the store without the arena: %s" % (label, two["io"]))
        out[mode] = {"epochs": epochs, "arena": stats}
    shared_store().clear()
    return out


# -- phase 13: failure handling and its record -------------------------------------------
#
# The recovery policy, the chaos plane, the trace recorder and the metrics registry on
# the card. (a) the main path (phase 7's thread-pool configuration, one epoch) under a
# transient fault every fourth row-group read, retried, beside a clean epoch, CHAOS_ROUNDS
# rounds alternating which goes first; (b) a poison row group on the pass-through (two of
# phase 5's files, one epoch), quarantined, then the same run raising; (c) the main path
# on the process pool over 'arrow' under a child kill (quarantined after two deaths),
# then on 'shm' with phase 7's 9 x 64 MB slabs under one corrupt wire payload; (d) the
# main path and phase 5's pass-through at 10 + 30 batches with a TraceRecorder and a
# MetricsRegistry and without, CHAOS_ROUNDS rounds alternating, and one traced pool run
# of (c)'s configuration. Every run of the main path here delivers its partial last
# batch (a quarantined row group leaves a short one), so ids compare exactly.

CHAOS_ROUNDS = 3
CHAOS_SEED = 14
CHAOS_TAB_FILES = 2        # phase 5's files 0 and 1: 32 row groups, 524,288 rows
CHAOS_POISON = (1, 3)      # (file, row group) of phase 5's store that (b) poisons
CHAOS_STAGE_SPANS = ("reader.next", "batch.form", "decode.dispatch", "h2d.transfer",
                     "wait.host_queue", "wait.device_queue", "train.step")


def _own_segments():
    """This process's slab and arena segments left in /dev/shm."""
    import glob

    pid = os.getpid()
    return sorted(glob.glob("/dev/shm/ptpu_torch_shm_%d_*" % pid)
                  + glob.glob("/dev/shm/ptpu_torch_arena_%d_*" % pid))


def _rowgroup_ids(piece):
    """The ``id`` column of one row group of the JPEG store (pyarrow, no decode)."""
    import pyarrow.parquet as pq

    with pq.ParquetFile(piece.path) as pf:
        return pf.read_row_group(piece.row_group, columns=["id"]).column(0).to_pylist()


def chaos_jpeg_run(url, images, label, smi, plan=None, propagate=False, recovery=None,
                   pool="thread", wire=None, slab_bytes=None, trace=None, metrics=None,
                   epochs=1, health=None, expect_stall=False, provenance=None):
    """One run of the main path (phase 7's configuration, ``last_batch="partial"``):
    every delivered image held on the card to phase 7's image of the same id; the
    launch counters zeroed just before and read just after. ``plan`` is armed around
    the reader's whole life (``propagate``: into the pool's children). ``health``: the
    loader's (phase 14), whose busy heartbeats' ages are sampled between batches (the
    largest an actor showed is kept); with ``expect_stall`` the run must end in a
    StallError, caught in the loop, where the plan is disarmed (a hung thread then
    wakes at once). ``provenance``: the reader factory's (phase 15 (c)); the result then
    carries the loader's attribution report. The first batch's K2 output is held to
    K2's plain version. Returns the per-id counts, the quarantine entries and the counts
    the caller checks."""
    import threading

    import torch

    from petastorm_tpu_torch import chaos, make_batch_reader
    from petastorm_tpu_torch.errors import StallError
    from petastorm_tpu_torch.io.lease import lease_stats
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.log import degradation_counts
    from petastorm_tpu_torch.ops import image

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))

    def transform(batch):
        return {**batch, "image": image.normalize_images(batch["image"], MEAN, STD),
                "image_u8": batch["image"]}

    dev = torch.device("cuda")
    counts = torch.zeros(ROWS, dtype=torch.int32, device=dev)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    leases0 = lease_stats()
    deg0 = degradation_counts()
    armed = chaos.armed(plan, propagate=propagate) if plan is not None \
        else contextlib.nullcontext()
    batches = rows = 0
    t0 = None
    stall = t_caught = None
    busy_age = {}
    first = None
    with armed, pool_env(slab_bytes):
        reader = make_batch_reader(url, reader_pool_type=pool, workers_count=workers,
                                   wire_serializer=wire, shuffle_row_groups=True, seed=0,
                                   num_epochs=epochs, decode_on_device=True,
                                   recovery=recovery, results_timeout_s=120,
                                   provenance=provenance)
        executor = reader._executor
        items = list(reader._plan.items)
        _jpeg_launch_counters(zero=True)
        with DataLoader(reader, BATCH, device="cuda", device_transform=transform,
                        prefetch=3, host_queue_size=8, last_batch="partial",
                        trace=trace, metrics=metrics, health=health) as loader:
            monitor = loader._health
            pids = executor.child_pids() if pool == "process" else []
            try:
                for batch in loader:
                    with trace.span("train.step") if trace is not None \
                            else contextlib.nullcontext():
                        ids, u8 = batch["id"], batch["image_u8"]
                        counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
                        bad.add_((images.index_select(0, ids) != u8).sum())
                        if first is None:
                            first = (u8[:8].clone(), batch["image"][:8].clone())
                        batches += 1
                        for h in monitor.heartbeats() if monitor is not None else ():
                            if h["state"] != "done" and not h["state"].startswith("wait:"):
                                busy_age[h["actor"]] = max(busy_age.get(h["actor"], 0.0),
                                                           h["age_s"])
                        if t0 is None:
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                        else:
                            rows += len(ids)
                torch.cuda.synchronize()
            except StallError as e:
                if not expect_stall:
                    raise
                stall, t_caught = e, time.time()
                chaos.disarm()  # a hung thread-pool worker wakes now
            dt = time.perf_counter() - t0 if t0 is not None else 0.0
            entries = [(e.path, e.row_group, e.num_rows, e.kind, e.attempts, e.ordinal)
                       for e in loader.quarantine_report.entries]
            state = loader.state_dict() if stall is None else None
            snap = metrics.snapshot() if metrics is not None else None
            report = loader.bottleneck_report()
            wire_stats = reader.wire_stats()
            pool_stats = executor.pool_stats() if pool == "process" else {}
            budget = getattr(executor, "_respawn_budget", None)
            hbs = monitor.heartbeats() if monitor is not None else []
            io_threads = sorted(t.name for t in threading.enumerate()
                                if t.name.startswith(HEALTH_IO_PREFIX))
            stalls = monitor.stall_count if monitor is not None else 0
            heals = monitor.heal_count if monitor is not None else 0
            attribution = loader.attribution_report() if provenance else None
    launches = _jpeg_launch_counters()
    deg = {k: v - deg0.get(k, 0) for k, v in degradation_counts().items()
           if v != deg0.get(k, 0)}
    leases = {k: lease_stats()[k] - leases0[k] for k in ("acquired", "released", "leaked")}
    res = {"label": label, "rows_per_s": rows / dt if rows else 0.0, "batches": batches,
           "counts": counts.cpu(), "bad": int(bad.item()), "launches": launches,
           "entries": entries, "state": state, "metrics": snap, "bottleneck": report,
           "wire": wire_stats, "pool": pool_stats, "budget": budget, "leases": leases,
           "degradations": deg, "fires": plan.stats()["fires"] if plan else None,
           "items": items, "pids": pids, "segments": _own_segments(), "workers": workers,
           "heartbeats": hbs, "busy_age": busy_age, "io_threads": io_threads,
           "stalls": stalls, "heals": heals, "stall": stall, "t_caught": t_caught,
           "injections": plan.injections() if plan is not None else [],
           "attribution": attribution}
    log("chaos %s: %.1f rows/s over %d batches (the first excluded); launches %s; "
        "quarantined %s; degradations %s; plan fires %s; leases %s; respawns %s; pool "
        "spawn %s s, child first-item seconds %s; stalls %d, heals %d, StallError %s; %s"
        % (label, res["rows_per_s"], batches, json.dumps(launches),
           [(os.path.basename(p), rg, n, k, a) for p, rg, n, k, a, _o in entries],
           json.dumps(deg), res["fires"], leases, pool_stats.get("respawns"),
           pool_stats.get("spawn_s"), pool_stats.get("child_first_work_s"), stalls,
           heals, "yes" if stall is not None else "no", smi))
    check(expect_stall == (stall is not None), "%s: StallError %r (expected: %s)"
          % (label, stall, expect_stall))
    if not expect_stall:
        check(launches["stage2_planes"] == launches["stage2_rgb"] == launches["K2"]
              == batches, "%s: stage2_planes, stage2_rgb and K2 should launch once a "
              "batch (%d): %s" % (label, batches, launches))
    check(res["bad"] == 0, "%s: %d uint8 values differ from phase 7's images of the same "
          "ids" % (label, res["bad"]))
    if first is not None:
        check(torch.equal(image._normalize_plain(first[0], MEAN, STD, torch.bfloat16),
                          first[1]), "%s: K2 differs from its plain version on the first "
              "batch" % label)
    check(leases["leaked"] == 0 and leases["acquired"] == leases["released"],
          "%s: leases %s" % (label, leases))
    check(not res["segments"], "%s: segments left in /dev/shm: %s" % (label,
                                                                      res["segments"]))
    return res


def phase_chaos_main_path(url, images, smi):
    """(a): one epoch under ``FaultRule("reader.read", "raise_transient", every=4)`` with
    ``io_retries=8`` beside a clean epoch, CHAOS_ROUNDS rounds alternating: every id
    once, images equal per id to phase 7's (so to each other), the io_retry
    degradations equal the plan's injections, nothing quarantined, the kernels once a
    batch in both."""
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule

    out = {"faults": [], "clean": []}
    for r in range(CHAOS_ROUNDS):
        order = ["faults", "clean"] if r % 2 == 0 else ["clean", "faults"]
        for name in order:
            plan = FaultPlan([FaultRule("reader.read", "raise_transient", every=4)],
                             seed=CHAOS_SEED) if name == "faults" else None
            res = chaos_jpeg_run(
                url, images, "(a) %s round %d" % (name, r), smi, plan=plan,
                # a retry is a hit of the rule too, and other threads' hits land
                # between a read's attempts: its retry fails again about one time in
                # four, so a budget of 2 runs out (it did on the card); 8 leaves it
                # one time in 4 ** 8
                recovery=dict(io_retries=8, io_retry_backoff_s=0.01))
            check(bool((res["counts"] == 1).all()), "(a) %s: ids delivered %s times, not "
                  "once each" % (name, sorted(set(res["counts"].tolist()))))
            check(not res["entries"], "(a) %s: quarantined %s" % (name, res["entries"]))
            retries = res["degradations"].get("io_retry", 0)
            if plan is not None:
                fired = plan.stats()["injected_total"]
                check(fired > 0 and retries == fired, "(a): %d io_retry degradations for "
                      "%d injected faults" % (retries, fired))
            else:
                check(retries == 0, "(a) clean: %d io_retry degradations" % retries)
            out[name].append(res)
    per_batch = {name: sorted({tuple(v // max(1, r["batches"])
                                     for v in r["launches"].values()) for r in runs})
                 for name, runs in out.items()}
    check(per_batch["faults"] == per_batch["clean"] == [(1, 1, 1)],
          "(a): launches a batch %s" % per_batch)
    log("chaos (a): rows/s under faults %s, clean %s; retries %s (= injections); %s" % (
        [round(r["rows_per_s"], 1) for r in out["faults"]],
        [round(r["rows_per_s"], 1) for r in out["clean"]],
        [r["degradations"].get("io_retry", 0) for r in out["faults"]], smi))
    return out


def phase_chaos_pool(url, images, smi):
    """(c): the main path on 7 children over 'arrow' with ``FaultRule("child.item",
    "kill", item_key="ordinal=5")`` armed with propagation under
    ``RecoveryOptions(on_poison="quarantine", poison_attempts=2, worker_respawns=1)``:
    exactly ordinal 5's row group missing, one ``child_death`` entry of 2 attempts, a
    respawn budget of 0 left; then 'shm' at 9 x 64 MB under one corrupt wire payload:
    every id once, no respawn, no lease leaked; no slab or arena segment left after
    either."""
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule
    from petastorm_tpu_torch.recovery import RecoveryOptions

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    rec = RecoveryOptions(on_poison="quarantine", poison_attempts=2, worker_respawns=1)
    check(not _own_segments(), "segments in /dev/shm before (c): %s" % _own_segments())
    kill = chaos_jpeg_run(url, images, "(c) kill, process/arrow", smi,
                          plan=FaultPlan([FaultRule("child.item", "kill",
                                                    item_key="ordinal=5")]),
                          propagate=True, recovery=rec, pool="process", wire="arrow")
    piece = kill["items"][5][0]  # plan ordinal 5: (piece, partition)
    lost = set(_rowgroup_ids(piece))
    c = kill["counts"]
    missing = {i for i in range(ROWS) if c[i] == 0}
    check(missing == lost and bool((c[sorted(set(range(ROWS)) - lost)] == 1).all()),
          "(c) kill: missing %d ids (%d in ordinal 5's row group %s:%d); counts %s" % (
              len(missing), len(lost), piece.path, piece.row_group,
              sorted(set(c.tolist()))))
    check([(e[0], e[1], e[3], e[4]) for e in kill["entries"]]
          == [(piece.path, piece.row_group, "child_death", 2)],
          "(c) kill: quarantine entries %s" % kill["entries"])
    check(kill["budget"] == 0 and kill["pool"].get("respawns") == 2,
          "(c) kill: respawn budget left %s, respawns %s" % (kill["budget"],
                                                            kill["pool"].get("respawns")))
    check_ring_fits(POOL_SLAB_BYTES, workers + 2)
    corrupt = chaos_jpeg_run(url, images, "(c) corrupt wire, process/shm 64MB", smi,
                             plan=FaultPlan([FaultRule("wire.decode", "corrupt", nth=2,
                                                       times=1)], seed=CHAOS_SEED),
                             recovery=rec, pool="process", wire="shm",
                             slab_bytes=POOL_SLAB_BYTES)
    check(corrupt["fires"] == [1], "(c) corrupt: the plan fired %s times"
          % corrupt["fires"])
    check(bool((corrupt["counts"] == 1).all()) and not corrupt["entries"],
          "(c) corrupt: counts %s, quarantined %s" % (
              sorted(set(corrupt["counts"].tolist())), corrupt["entries"]))
    check(corrupt["pool"].get("respawns") == 0, "(c) corrupt: %s respawns"
          % corrupt["pool"].get("respawns"))
    check(corrupt["wire"].get("shm_items", 0) > 0, "(c) corrupt: no item through a slab: "
          "%s" % corrupt["wire"])
    log("chaos (c): the kill quarantined %s:%d (%d ids) after 2 deaths, budget 0 left; "
        "the corrupt payload was decoded again on its live child; no segment left; %s"
        % (os.path.basename(piece.path), piece.row_group, len(lost), smi))
    return {"kill": kill, "corrupt": corrupt}


def _trace_checks(tracer, label, work, pids=None):
    """The dumped Chrome JSON loads and holds every stage span from 3 threads or more;
    with ``pids``, one child.work lane for each child pid. Returns the span names."""
    path = tracer.dump(os.path.join(work, "trace_%d.json" % len(os.listdir(work))))
    with open(path) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    lanes = {e["tid"] for e in spans if e["pid"] == os.getpid()}
    missing = set(CHAOS_STAGE_SPANS) - names
    check(not missing and len(lanes) >= 3, "%s: the trace lacks %s or has %d thread "
          "lanes" % (label, sorted(missing), len(lanes)))
    if pids is not None:
        child_lanes = {e["pid"] for e in spans if e["name"] == "child.work"}
        check(child_lanes == set(pids), "%s: child.work lanes %s, children %s"
              % (label, sorted(child_lanes), sorted(pids)))
    return sorted(names)


def _metrics_checks(snap, batches, label, ahead=0):
    """The registry's snapshot: the batches delivered and the read stage's histogram.
    ``ahead``: how many batches the transfer thread may have taken beyond the consumer's
    (a run that stops early leaves its prefetch in flight)."""
    check(batches <= snap["ptpu_pipeline_batches"] <= batches + ahead,
          "%s: ptpu_pipeline_batches %s for %d delivered (%d may be in flight)"
          % (label, snap["ptpu_pipeline_batches"], batches, ahead))
    check(snap['ptpu_pipeline_stage_seconds{stage="read"}']["count"] > 0,
          "%s: no read-stage observation" % label)


def phase_trace_main_path(url, images, work, smi):
    """(d), the main path: (a)'s clean epoch with a TraceRecorder and a MetricsRegistry
    and without, CHAOS_ROUNDS rounds alternating; then one traced run of (c)'s pool
    configuration without faults (two epochs, so every child takes items)."""
    from petastorm_tpu_torch.obs.export import parse_prometheus_text, write_prometheus
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry
    from petastorm_tpu_torch.trace import TraceRecorder

    out = {"on": [], "off": []}
    for r in range(CHAOS_ROUNDS):
        for name in (["on", "off"] if r % 2 == 0 else ["off", "on"]):
            tracer = TraceRecorder() if name == "on" else None
            registry = MetricsRegistry() if name == "on" else None
            res = chaos_jpeg_run(url, images, "(d) main path trace %s round %d"
                                 % (name, r), smi, trace=tracer, metrics=registry)
            check(bool((res["counts"] == 1).all()), "(d) %s: ids not once each" % name)
            if tracer is not None:
                res["spans"] = _trace_checks(tracer, "(d) main path", work)
                _metrics_checks(res["metrics"], res["batches"], "(d) main path")
                prom = write_prometheus(os.path.join(work, "m%d.prom" % r), registry)
                with open(prom) as f:
                    samples = parse_prometheus_text(f.read())
                # written after the loader's exit: its pull collectors are gone, its
                # stage histograms stay
                read = res["metrics"]['ptpu_pipeline_stage_seconds{stage="read"}']
                check(samples['ptpu_pipeline_stage_seconds_count{stage="read"}']
                      == read["count"], "(d): the Prometheus file's read count differs "
                      "from the snapshot's %d" % read["count"])
            check(res["bottleneck"].verdict in ("producer-bound", "consumer-bound",
                                                "wire-bound", "balanced", "straggler",
                                                "idle"),
                  "(d): no verdict: %s" % res["bottleneck"])
            out[name].append(res)
    tracer = TraceRecorder()
    pool = chaos_jpeg_run(url, images, "(d) traced process/arrow", smi, pool="process",
                          wire="arrow", trace=tracer, metrics=MetricsRegistry(), epochs=2)
    check(bool((pool["counts"] == 2).all()), "(d) pool: ids not twice each")
    pool["spans"] = _trace_checks(tracer, "(d) pool", work, pids=pool["pids"])
    out["pool"] = pool
    log("chaos (d) main path: rows/s traced %s, untraced %s; verdicts %s; the pool's "
        "trace has %d child lanes; %s" % (
            [round(r["rows_per_s"], 1) for r in out["on"]],
            [round(r["rows_per_s"], 1) for r in out["off"]],
            [r["bottleneck"].verdict for r in out["on"] + out["off"]],
            len(pool["pids"]), smi))
    log("chaos (d) main path report: %s" % out["on"][0]["bottleneck"].render()
        .replace("\n", " | "))
    return out


def phase_chaos_tabular(root, arrays, predicted, smi):
    """(b): phase 5's files 0 and 1 (32 row groups) with ``pagedec="on"`` (``"auto"``
    engages when the loader adopts the reader, and the thread pool reads its first
    items before that: the poisoned row group could pass classically), one epoch,
    under ``FaultRule("io.pagedec", "raise_permanent", item_key=<file 1>:<row group 3>)``
    and ``recovery=dict(on_poison="quarantine", poison_attempts=2)``: that row group
    quarantined (16,384 rows, 2 attempts, counted on the registry), every other row
    group delivered once and byte-identical to the source (phase 5's classic read
    equals it), 0 host-inflated columns, one K3, scan and K4 launch a batch, and the
    loader's state after the epoch counts all 32 row groups consumed. Then the same run
    with ``on_poison="raise"``: FileNotFoundError reaches the consumer within its
    ``results_timeout_s``."""
    import numpy as np

    from petastorm_tpu_torch import chaos, make_batch_reader
    from petastorm_tpu_torch.io import pagedec
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.metrics import default_registry

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    urls = ["file://" + os.path.join(root, "part-%d.parquet" % f)
            for f in range(CHAOS_TAB_FILES)]
    f_bad, rg_bad = CHAOS_POISON
    bad_name = "part-%d.parquet" % f_bad
    # the site's key is "<path>:<row group>": the file's name and the row group match
    # this one row group of the two files
    rule = chaos.FaultRule("io.pagedec", "raise_permanent",
                           item_key="%s:%d" % (bad_name, rg_bad))
    q_rows = default_registry().counter("ptpu_quarantined_rows_total")
    q_items = default_registry().counter("ptpu_quarantined_items_total")
    rows0, items0 = q_rows.value, q_items.value
    counters0 = pagedec.counter_values()
    seen = {}
    with chaos.armed(chaos.FaultPlan([rule]), propagate=False):
        reader = make_batch_reader(urls, workers_count=workers, shuffle_row_groups=True,
                                   seed=0, num_epochs=1, io_options={"pagedec": "on"},
                                   recovery=dict(on_poison="quarantine", poison_attempts=2),
                                   results_timeout_s=60)
        _tab_launch_counters(zero=True)
        t0 = time.perf_counter()
        with DataLoader(reader, TAB_BATCH, device="cuda", prefetch=3,
                        host_queue_size=8) as loader:
            for batch in loader:
                got = {k: v.cpu().numpy() for k, v in batch.items()}
                f, rg = _rowgroup_of({c: got[c][0] for c in TAB_COLUMNS}, arrays,
                                     TAB_BATCH)
                check((f, rg) not in seen, "(b): row group %d:%d delivered twice"
                      % (f, rg))
                for c in TAB_COLUMNS:
                    src = arrays[f][c][rg * TAB_BATCH:(rg + 1) * TAB_BATCH]
                    check(got[c].dtype == src.dtype and got[c].tobytes() == src.tobytes(),
                          "(b): column %s of row group %d:%d differs from the source"
                          % (c, f, rg))
                seen[(f, rg)] = True
            dt = time.perf_counter() - t0
            state = loader.state_dict()
            entries = loader.quarantine_report.entries
    launches = _tab_launch_counters()
    counters = {k: v - counters0[k] for k, v in pagedec.counter_values().items()}
    want = {(f, rg) for f in range(CHAOS_TAB_FILES) for rg in range(TAB_RGS_PER_FILE)}
    batches = len(seen)
    log("chaos (b): %d batches in %.2f s (%.1f rows/s); launches %s; quarantined %s; "
        "quarantined rows +%d; counters %s; state resume_epoch %s; %s" % (
            batches, dt, batches * TAB_BATCH / dt, json.dumps(launches),
            [(os.path.basename(e.path), e.row_group, e.num_rows, e.kind, e.attempts)
             for e in entries], q_rows.value - rows0, json.dumps(counters),
            state["resume_epoch"], smi))
    check(set(seen) == want - {CHAOS_POISON}, "(b): delivered %d row groups, missing %s"
          % (batches, sorted(want - set(seen))))
    check([(os.path.basename(e.path), e.row_group, e.num_rows, e.attempts)
           for e in entries] == [(bad_name, rg_bad, TAB_RG_ROWS, 2)],
          "(b): quarantine report %s" % entries)
    check((q_rows.value - rows0, q_items.value - items0) == (TAB_RG_ROWS, 1),
          "(b): ptpu_quarantined rows/items rose by %d/%d"
          % (q_rows.value - rows0, q_items.value - items0))
    check(counters["host_inflate_columns"] == 0 and counters["fallback_columns"] == 0,
          "(b): counters %s" % counters)
    for k in ("K3", "scan", "K4"):
        check(launches[k] == predicted[k] * batches, "(b): %s launched %d times for %d "
              "batches" % (k, launches[k], batches))
    check(state["resume_epoch"] == 1 and state["consumed"] == {}
          and state["plan"]["num_items"] == len(want),
          "(b): the loader's state after the epoch: %s" % json.dumps(state)[:300])
    # on_poison="raise": the permanent error reaches the consumer
    t0 = time.perf_counter()
    raised = None
    with chaos.armed(chaos.FaultPlan([rule]), propagate=False):
        reader = make_batch_reader(urls, workers_count=workers, shuffle_row_groups=True,
                                   seed=0, num_epochs=1, io_options={"pagedec": "on"},
                                   recovery=dict(on_poison="raise"), results_timeout_s=60)
        try:
            with DataLoader(reader, TAB_BATCH, device="cuda", prefetch=3) as loader:
                for _ in loader:
                    pass
        except FileNotFoundError as e:
            raised = e
    waited = time.perf_counter() - t0
    log("chaos (b) on_poison='raise': %r after %.2f s" % (raised, waited))
    check(raised is not None and waited < 60, "(b): on_poison='raise' did not raise "
          "FileNotFoundError within 60 s (%r after %.1f s)" % (raised, waited))
    return {"launches": launches, "batches": batches, "entries": entries,
            "rows_per_s": batches * TAB_BATCH / dt, "raise_s": waited}


def phase_trace_tabular(root, arrays, predicted, work, smi):
    """(d), the pass-through: phase 5's path at 10 + 30 batches with a TraceRecorder and
    a MetricsRegistry and without, CHAOS_ROUNDS rounds alternating (phase 5's checks
    in every run)."""
    from petastorm_tpu_torch.obs.export import parse_prometheus_text, write_prometheus
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry
    from petastorm_tpu_torch.trace import TraceRecorder

    out = {"on": [], "off": []}
    for r in range(CHAOS_ROUNDS):
        for name in (["on", "off"] if r % 2 == 0 else ["off", "on"]):
            tracer = TraceRecorder() if name == "on" else None
            registry = MetricsRegistry() if name == "on" else None
            _launches, res = phase_tabular_path(
                root, arrays, predicted, warmup=POOL_TAB_WARMUP, measured=POOL_TAB_MEASURED,
                trace=tracer, metrics=registry)
            if tracer is not None:
                res["spans"] = _trace_checks(tracer, "(d) pass-through", work)
                check("decode.device_inflate" in res["spans"], "(d): no inflate span")
                # phase 5's loader: prefetch 3, a host queue of 8
                _metrics_checks(res["metrics"], res["consumed"], "(d) pass-through",
                                ahead=3 + 8 + 2)
                prom = write_prometheus(os.path.join(work, "t%d.prom" % r), registry)
                with open(prom) as f:
                    samples = parse_prometheus_text(f.read())
                check(samples['ptpu_pipeline_stage_seconds_count{stage="device_inflate"}']
                      > 0, "(d): no inflate-stage observation in the Prometheus file")
            out[name].append(res)
    log("chaos (d) pass-through: rows/s traced %s, untraced %s; verdicts %s; %s" % (
        [round(r["rows_per_s"], 1) for r in out["on"]],
        [round(r["rows_per_s"], 1) for r in out["off"]],
        [r["bottleneck"].verdict for r in out["on"] + out["off"]], smi))
    log("chaos (d) pass-through report: %s" % out["on"][0]["bottleneck"].render()
        .replace("\n", " | "))
    return out


# -- phase 14: liveness and time -----------------------------------------------------------
#
# The health monitor, the stall healer and the time-series plane on the card. (a) the
# main path (phase 13's configuration) with health=HealthOptions(stall_threshold_s=5.0,
# poll_interval_s=0.25, escalation="raise") and a MetricsRegistry beside an epoch without
# health, HEALTH_ROUNDS rounds alternating which goes first: 0 stalls, every actor's
# heartbeat registered, the ptpu_health_* and ptpu_io_* families in the snapshot, the
# kernels once a batch in both; the busy heartbeat ages each actor showed between batches
# are printed. (b) one worker.item hang on the thread pool (hang_s 20 s) at a 2 s
# threshold: escalation "raise" delivers the StallError within threshold + poll + 2 s
# of the hang, with a flight record naming the hung worker thread and holding its frame;
# escalation "flight" with a 4 s hang keeps the stream alive, every id once. (c) the main
# path on 7 children over 'arrow' with a child hung on ordinal 5 every time it is tried
# (the plan propagates to respawned children), heal escalation at a 3 s child threshold:
# two heals, the row group quarantined after 2 attempts, every other id once; then with
# no respawn budget and on_poison="raise": no kill, the StallError with the children's
# SIGUSR1 stacks in the flight record. (d) phase 5's pass-through at 10 + 30 batches with
# a MetricsRegistry, a Reporter sampling the windows every 0.25 s, two SLO specs (read
# p99 <= 60 s cannot breach; the batch count's delta <= 0 over 2 windows must) and a
# MetricsServer on 127.0.0.1:0, HEALTH_ROUNDS rounds beside runs without any of it.

HEALTH_ROUNDS = 3
HEALTH_IO_PREFIX = "ptpu-torch-io"  # the readahead pool's thread names


def phase_health_main_path(url, images, work, smi):
    """(a): the watchdog on the clean main path beside an epoch without health."""
    from petastorm_tpu_torch.obs.health import HealthOptions
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    out = {"on": [], "off": []}
    for r in range(HEALTH_ROUNDS):
        for name in (["on", "off"] if r % 2 == 0 else ["off", "on"]):
            flight = os.path.join(work, "a_flight_%d.json" % r)
            health = HealthOptions(stall_threshold_s=5.0, poll_interval_s=0.25,
                                   escalation="raise", flight_path=flight) \
                if name == "on" else None
            res = chaos_jpeg_run(url, images, "(a) health %s round %d" % (name, r), smi,
                                  health=health,
                                  metrics=MetricsRegistry() if name == "on" else None)
            check(bool((res["counts"] == 1).all()), "(a) %s: ids not once each" % name)
            if name == "on":
                check(res["stalls"] == 0 and not os.path.exists(flight),
                      "(a): %d stalls, flight record %s" % (res["stalls"],
                                                            os.path.exists(flight)))
                actors = {h["actor"]: h["role"] for h in res["heartbeats"]}
                want = {"loader.producer": "producer", "loader.transfer": "transfer"}
                want.update({"worker.thread-%d" % i: "worker"
                             for i in range(res["workers"])})
                want.update({"io." + t: "io" for t in res["io_threads"]})
                missing = {a for a, role in want.items() if actors.get(a) != role}
                check(not missing and res["io_threads"], "(a): heartbeats missing for %s "
                      "(IO threads %s)" % (sorted(missing), res["io_threads"]))
                snap = res["metrics"]
                fams = {p: [k for k in snap if k.startswith(p)]
                        for p in ("ptpu_health_", "ptpu_io_")}
                check(all(fams.values()) and "ptpu_health_stalls_total" in snap,
                      "(a): families missing from the snapshot: %s"
                      % {p: len(v) for p, v in fams.items()})
                res["families"] = {p: len(v) for p, v in fams.items()}
            out[name].append(res)
    per_batch = {name: sorted({tuple(v // max(1, r["batches"]) for v in r["launches"].values())
                               for r in runs}) for name, runs in out.items()}
    check(per_batch["on"] == per_batch["off"] == [(1, 1, 1)],
          "(a): launches a batch %s" % per_batch)
    ages = {}
    for r in out["on"]:
        for actor, age in r["busy_age"].items():
            ages[actor] = max(ages.get(actor, 0.0), age)
    out["busy_age"] = ages
    log("health (a): rows/s with health %s, without %s; families %s; largest busy "
        "heartbeat age seen between batches: %s; %s" % (
            [round(r["rows_per_s"], 1) for r in out["on"]],
            [round(r["rows_per_s"], 1) for r in out["off"]], out["on"][0]["families"],
            json.dumps({k: round(v, 3) for k, v in sorted(ages.items())}), smi))
    return out


def phase_health_hang(url, images, work, smi):
    """(b): a hung decode on the thread pool, escalation "raise" then "flight"."""
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule
    from petastorm_tpu_torch.obs.health import HealthOptions

    flight = os.path.join(work, "b_flight.json")
    threshold, poll = 2.0, 0.25
    plan = FaultPlan([FaultRule("worker.item", "hang", nth=3, times=1, hang_s=20.0)])
    raised = chaos_jpeg_run(
        url, images, "(b) hung decode, raise", smi, plan=plan, expect_stall=True,
        health=HealthOptions(stall_threshold_s=threshold, poll_interval_s=poll,
                             escalation="raise", flight_path=flight))
    hung_at = raised["injections"][0]["t"]
    latency = raised["t_caught"] - hung_at
    check(latency <= threshold + poll + 2.0, "(b): the StallError came %.3f s after the "
          "hang (bound %.2f s)" % (latency, threshold + poll + 2.0))
    with open(flight) as f:
        rec = json.load(f)
    stalled = [st["actor"] for st in rec["stalled"]]
    check(any(a.startswith("worker.thread-") for a in stalled),
          "(b): the flight record's stalled actors %s name no worker thread" % stalled)
    hung = [k for k, v in rec["driver_stacks"].items()
            if "chaos/plan.py" in v and "_execute" in v]
    check(hung, "(b): no driver stack holds the hung frame")
    flight2 = os.path.join(work, "b_flight2.json")
    alive = chaos_jpeg_run(
        url, images, "(b) hung decode, flight", smi,
        plan=FaultPlan([FaultRule("worker.item", "hang", nth=3, times=1, hang_s=4.0)]),
        health=HealthOptions(stall_threshold_s=threshold, poll_interval_s=poll,
                             escalation="flight", flight_path=flight2))
    check(bool((alive["counts"] == 1).all()) and alive["stalls"] >= 1
          and os.path.exists(flight2), "(b) flight: ids %s, stalls %d"
          % (sorted(set(alive["counts"].tolist())), alive["stalls"]))
    log("health (b): StallError %.3f s after the hang began (threshold %.2f s, poll %.2f "
        "s); stalled %s; hung frame in %s; the flight-only run delivered every id once "
        "(%d stalls); %s" % (latency, threshold, poll, stalled, hung, alive["stalls"], smi))
    return {"latency_s": latency, "stalled": stalled, "raised": raised, "alive": alive}


def phase_health_heal(url, images, work, smi):
    """(c): the healer on the process pool, then a heal nothing can absorb."""
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule
    from petastorm_tpu_torch.obs.health import HealthOptions
    from petastorm_tpu_torch.recovery import RecoveryOptions

    def plan():
        return FaultPlan([FaultRule("child.item", "hang", item_key="ordinal=5",
                                    hang_s=120.0)])

    check(not _own_segments(), "segments in /dev/shm before (c): %s" % _own_segments())
    healed = chaos_jpeg_run(
        url, images, "(c) heal, process/arrow", smi, plan=plan(), propagate=True,
        pool="process", wire="arrow",
        recovery=RecoveryOptions(on_poison="quarantine", poison_attempts=2,
                                 worker_respawns=2),
        health=HealthOptions(thresholds={"child": 3.0}, poll_interval_s=0.25,
                             escalation="heal",
                             flight_path=os.path.join(work, "c_flight.json")))
    piece = healed["items"][5][0]
    lost = set(_rowgroup_ids(piece))
    c = healed["counts"]
    missing = {i for i in range(ROWS) if c[i] == 0}
    check(missing == lost and bool((c[sorted(set(range(ROWS)) - lost)] == 1).all()),
          "(c) heal: missing %d ids (%d in ordinal 5's row group); counts %s"
          % (len(missing), len(lost), sorted(set(c.tolist()))))
    check([(e[0], e[1], e[3], e[4]) for e in healed["entries"]]
          == [(piece.path, piece.row_group, "child_death", 2)],
          "(c) heal: quarantine entries %s" % healed["entries"])
    kills = healed["degradations"].get("stall_heal_kill", 0)
    check(healed["heals"] == 2 and kills == 2, "(c) heal: %d heals, %d stall_heal_kill"
          % (healed["heals"], kills))
    flight = os.path.join(work, "c_flight_raise.json")
    refused = chaos_jpeg_run(
        url, images, "(c) heal refused, process/arrow", smi, plan=plan(), propagate=True,
        pool="process", wire="arrow", expect_stall=True,
        recovery=RecoveryOptions(on_poison="raise", worker_respawns=0),
        health=HealthOptions(thresholds={"child": 3.0}, poll_interval_s=0.25,
                             escalation="heal", flight_path=flight))
    check(refused["heals"] == 0 and not refused["degradations"].get("stall_heal_kill"),
          "(c) refused: %d heals" % refused["heals"])
    with open(flight) as f:
        rec = json.load(f)
    stacks = rec["child_stacks"]
    check(stacks and any("chaos/plan.py" in t for t in stacks.values()),
          "(c) refused: the flight record's child stacks %s hold no hung frame"
          % sorted(stacks))
    log("health (c): 2 heals quarantined %s:%d (%d ids) after 2 attempts, every other id "
        "once; the unabsorbable heal killed nothing and delivered the StallError with %d "
        "children's stacks; no segment left; %s" % (
            os.path.basename(piece.path), piece.row_group, len(lost), len(stacks), smi))
    return {"healed": healed, "refused": refused, "child_stacks": len(stacks)}


def phase_health_tabular(root, arrays, predicted, work, smi):
    """(d): time series, SLOs and the endpoint on the pass-through, beside runs with the
    registry alone (``metrics=``, no Reporter, no SLOs) and runs with neither, so the
    sampling's cost is told apart from the collectors'."""
    import urllib.request

    from petastorm_tpu_torch.obs.export import Reporter, parse_prometheus_text
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry
    from petastorm_tpu_torch.obs.serve import MetricsServer
    from petastorm_tpu_torch.obs.slo import SloSpec
    from petastorm_tpu_torch.obs.timeseries import load_export

    batches_key = "ptpu_pipeline_batches"
    out = {"on": [], "metrics": [], "off": []}
    for r in range(HEALTH_ROUNDS):
        for name in (["on", "metrics", "off"] if r % 2 == 0 else ["off", "metrics", "on"]):
            if name != "on":
                _launches, res = phase_tabular_path(
                    root, arrays, predicted, warmup=POOL_TAB_WARMUP,
                    measured=POOL_TAB_MEASURED,
                    metrics=MetricsRegistry() if name == "metrics" else None)
                out[name].append(res)
                continue
            registry = MetricsRegistry()
            jsonl = os.path.join(work, "d_%d.jsonl" % r)
            specs = [SloSpec(name="read-p99", stat="p99", op="<=", threshold=60.0,
                             metric='ptpu_pipeline_stage_seconds{stage="read"}',
                             breach_windows=1),
                     SloSpec(name="batches-stall", metric=batches_key, stat="delta",
                             op="<=", threshold=0, breach_windows=2)]

            # the consumer's own count at each of the Reporter's samples, read by a
            # listener on its thread: a count the pipeline collector does not read
            taken = {"n": 0}
            marks = []
            registry.timeline_store().add_listener(
                lambda window, t, taken=taken, marks=marks:
                marks.append((t, taken["n"])) if batches_key in window else None)

            def probe(loader, reader, registry=registry, r=r):
                time.sleep(0.75)  # the Reporter samples the windows after the last batch
                with MetricsServer(registry, slo_engine=loader.slo_engine) as srv:
                    prom = urllib.request.urlopen(srv.url + "/metrics", timeout=30).read()
                    doc = urllib.request.urlopen(srv.url + "/timelines", timeout=30).read()
                    alerts = json.loads(urllib.request.urlopen(
                        srv.url + "/alerts", timeout=30).read())["alerts"]
                    port = srv.port
                path = os.path.join(work, "d_timelines_%d.json" % r)
                with open(path, "wb") as f:
                    f.write(doc)
                return {"prom": parse_prometheus_text(prom.decode()),
                        "export": load_export(path), "alerts": alerts, "port": port,
                        "report": loader.bottleneck_report(),
                        "slo_alerts": loader.slo_alerts()}

            with Reporter(registry=registry, interval_s=0.25, jsonl_path=jsonl):
                _launches, res = phase_tabular_path(
                    root, arrays, predicted, warmup=POOL_TAB_WARMUP,
                    measured=POOL_TAB_MEASURED, metrics=registry, slos=specs, probe=probe,
                    on_batch=lambda n, taken=taken: taken.__setitem__("n", n))
            p = res["probe"]
            names = [(a.name, a.cause) for a in p["slo_alerts"]]
            check(names == [("batches-stall", "slo_breach")], "(d): alerts %s (the loose "
                  "spec must raise none, the tight one exactly one)" % names)
            check([a["name"] for a in p["alerts"]] == ["batches-stall"],
                  "(d): GET /alerts lists %s" % [a["name"] for a in p["alerts"]])
            check(p["report"].slo_alerts and p["report"].slo_alerts[0]["name"]
                  == "batches-stall", "(d): bottleneck_report() carries no alert")
            # the batch counter runs ahead of the consumer by at most the device queue
            # (prefetch 3) and the batch the transfer thread holds; the listener reads
            # the consumer's count just after the sampler read the counter, so one more
            lead = 3 + 1 + 1
            points = registry.timeline(batches_key)
            check(len(points) == len(marks) >= 3 and all(
                q["t"] == m[0] for q, m in zip(points, marks)),
                "(d): %d windows of the batch counter, %d samples seen by the listener"
                % (len(points), len(marks)))
            bad = []
            for i in range(1, len(points)):
                prev, q = points[i - 1], points[i]
                took = marks[i][1] - marks[i - 1][1]
                # the rate is its own window's: rate x window = delta
                if abs(q["rate"] * (q["t"] - prev["t"]) - q["delta"]) > 1e-3 * max(
                        1, q["delta"]) or abs(q["delta"] - took) > lead:
                    bad.append((i, q["delta"], q["rate"], took))
            summed = points[0]["value"] + sum(
                q["rate"] * (q["t"] - prev["t"]) for prev, q in zip(points, points[1:]))
            check(not bad, "(d): windows (index, delta, rate, batches the consumer took) "
                  "off by more than %d batches or whose rate is not their delta: %s"
                  % (lead, bad))
            check(0 <= round(summed) - res["consumed"] <= lead,
                  "(d): the batch counter's windowed rates sum to %.3f, the consumer took "
                  "%d batches (lead at most %d)" % (summed, res["consumed"], lead))
            deltas = [q["delta"] for q in points if q.get("delta") is not None]
            check(batches_key in p["export"]["series"], "(d): GET /timelines lacks %s"
                  % batches_key)
            rates = [q["rate"] for q in points if q.get("rate") is not None]
            fams = {pre: [k for k in p["prom"] if k.startswith(pre)]
                    for pre in ("ptpu_io_", "ptpu_pipeline_")}
            check(all(fams.values()) and p["port"], "(d): GET /metrics families %s"
                  % {k: len(v) for k, v in fams.items()})
            res["slo"] = {"alerts": names, "windows": len(points),
                          "moving_windows": sum(1 for d in deltas if d > 0),
                          "rates": rates, "families": {k: len(v) for k, v in fams.items()}}
            out[name].append(res)
    log("health (d): pass-through rows/s with time series, SLOs and the endpoint %s, "
        "with metrics= alone %s, with neither %s; windows %s (moving %s); one "
        "batches-stall alert a run; %s" % (
            [x["rows_per_s"] for x in out["on"]],
            [x["rows_per_s"] for x in out["metrics"]],
            [x["rows_per_s"] for x in out["off"]],
            [x["slo"]["windows"] for x in out["on"]],
            [x["slo"]["moving_windows"] for x in out["on"]], smi))
    return out


# -- phase 15: attribution on the card ---------------------------------------------------
#
# The provenance plane on the two paths that launch the port's kernels. (a) phase 5's
# pass-through (pagedec="auto", batches of 16,384, 10 + 30 batches) with provenance=True
# on the thread pool (with a MetricsRegistry, whose Reporter JSONL (d) renders) and on
# the process pool over 'arrow', with phase 5's checks (one K3, scan and K4 launch and
# one read back a batch, the first and last measured batches byte for byte the
# pagedec="off" read); every delivered batch's record holds the batch's rows, every
# item once, the report counts the batches delivered, and on the process pool each
# item's child.work span lies inside its wire.roundtrip. (b) blame and exoneration with
# the real kernels: a store of BLAME_RGS row groups whose float32 and int64 columns take
# the pass-through and whose int32 id column reads classically, one worker, readahead
# off, pagedec="on", and a chaos latency of BLAME_LATENCY_S on every hit of one site;
# BLAME_ROUNDS rounds of the three sites decode.device_inflate, reader.read and
# io.pagedec: the report's slow_top is the slowed site with more than half of the slow
# batches' critical path, the columns are the store's byte for byte, and K3, the scan
# and K4 launch once a batch; then the inflate stage slowed under
# DataLoader(metrics=, slos=[p99 of the inflate stage <= BLAME_LATENCY_S / 2]): one
# alert, whose culprit is the slowed stage. (c) the main path (phase 13's
# configuration), PROV_ROUNDS rounds of provenance on and off, alternating which goes
# first: every id once, the images equal per id to phase 7's in both arms, K2 equal to
# its plain version, stage2_planes, stage2_rgb and K2 once a batch; rows/s of each arm,
# their ratio, and the report's host self seconds of loader.decode a batch beside the
# kernels' device milliseconds a batch from phase 3. (d) the tools: the port's trend
# gate twice (its history under the run's work directory: the first run seeds it, the
# second's entry carries the per-site self times), the run diff of the two entries (its
# last line a ptpu-bench-diff-v1 verdict) and the stats CLI over (a)'s Reporter JSONL
# (the attribution panel).

BLAME_RGS, BLAME_RG_ROWS = 8, 16384
BLAME_LATENCY_S = 0.1
BLAME_ROUNDS = 3
BLAME_SITES = ("decode.device_inflate", "reader.read", "io.pagedec")
PROV_ROUNDS = 3


def write_blame_store(root, seed=15):
    """(b)'s store in one file of BLAME_RGS row groups: the repeated float32 ``feat`` and
    the small-range int64 ``cat`` take the pass-through; the int32 ``id`` saves nothing
    compressed, so it reads classically (the ``reader.read`` site)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = BLAME_RGS * BLAME_RG_ROWS
    rng = np.random.default_rng(seed)
    cols = {"feat": np.repeat(rng.normal(size=n // 40 + 1).astype(np.float32), 40)[:n],
            "cat": rng.integers(0, 13, size=n).astype(np.int64),
            "id": np.arange(n, dtype=np.int32)}
    os.makedirs(root, exist_ok=True)
    pq.write_table(pa.table(cols), os.path.join(root, "part-0.parquet"),
                   compression="snappy", row_group_size=BLAME_RG_ROWS)
    return cols


def _report_brief(report):
    """The report's verdict and per-site self seconds (largest first) for a log line."""
    return "%s; self s %s" % (report.verdict, json.dumps(dict(sorted(
        report.stage_self_s.items(), key=lambda kv: -kv[1]))))


def phase_prov_tabular(root, arrays, predicted, work, smi, device="cuda"):
    """(a): the pass-through with provenance on the thread pool and on the process pool
    over 'arrow'."""
    from petastorm_tpu_torch.obs.export import Reporter
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    out = {}
    local = os.getpid()
    for pool, wire in (("thread", None), ("process", "arrow")):
        registry = MetricsRegistry() if pool == "thread" else None
        jsonl = os.path.join(work, "prov_%s.jsonl" % pool) if registry is not None else None

        def probe(loader, reader, registry=registry, jsonl=jsonl):
            if registry is not None:
                with Reporter(registry=registry, interval_s=600.0, jsonl_path=jsonl):
                    pass  # the final flush, while the loader's collectors are live
            rec = loader.provenance
            return {"report": loader.attribution_report(), "views": rec.batches(),
                    "jsonl": jsonl}

        _launches, res = phase_tabular_path(
            root, arrays, predicted, device=device, warmup=POOL_TAB_WARMUP,
            measured=POOL_TAB_MEASURED, pool=pool, wire=wire, metrics=registry,
            probe=probe, provenance=True)
        p = res["probe"]
        label = "provenance (a) %s%s" % (pool, "/" + wire if wire else "")
        report, views = p["report"], p["views"]
        check(report.batches == len(views) == res["consumed"],
              "%s: the report folds %d batches, %d recorded, %d delivered"
              % (label, report.batches, len(views), res["consumed"]))
        seen = {}
        for v in views:
            check(v["rows"] == TAB_BATCH and v["items"] is not None
                  and sum(r for _e, _o, r in v["items"]) == v["rows"],
                  "%s: batch %s records %s rows from items %s" % (label, v["seq"],
                                                                   v["rows"], v["items"]))
            for rec in v["item_records"]:
                key = rec["key"]
                check(key not in seen and rec["rows"] == TAB_BATCH,
                      "%s: item %s delivered twice, or %d rows of %d" % (
                          label, key, rec["rows"], TAB_BATCH))
                seen[key] = rec
        check(len(seen) == len(views), "%s: %d items for %d batches (a row group a batch)"
              % (label, len(seen), len(views)))
        check(report.stage_self_s.get("decode.device_inflate", 0.0) > 0.0,
              "%s: no decode.device_inflate self time: %s" % (label, report.stage_self_s))
        nested = 0
        if pool == "process":
            for key, rec in seen.items():
                trip = [s for s in rec["spans"] if s["site"] == "wire.roundtrip"]
                child = [s for s in rec["spans"] if s["site"] == "child.work"]
                check(len(trip) == 1 and len(child) == 1 and child[0]["pid"] != local,
                      "%s: item %s: %d wire.roundtrip spans, child.work %s" % (
                          label, key, len(trip), child))
                tol = 0.005  # the clock alignment's error is the wall clock's jitter
                check(trip[0]["t0"] - tol <= child[0]["t0"] <= child[0]["t1"]
                      <= trip[0]["t1"] + tol, "%s: item %s's child.work [%.6f, %.6f] lies "
                      "outside its wire.roundtrip [%.6f, %.6f]" % (
                          label, key, child[0]["t0"], child[0]["t1"], trip[0]["t0"],
                          trip[0]["t1"]))
                nested += 1
        res["report"] = report
        log("%s: %.1f rows/s; %d batches, each its rows from one item delivered once%s; "
            "report: %s; %s" % (label, res["rows_per_s"], len(views),
                                "; child.work inside wire.roundtrip for all %d items"
                                % nested if nested else "", _report_brief(report), smi))
        log("%s report:\n%s" % (label, report.render()))
        out[pool] = res
    return out


def blame_run(root, cols, site, label, smi, device="cuda", slo=False):
    """One pass of (b)'s store with ``site`` slowed by BLAME_LATENCY_S on every hit."""
    import numpy as np

    from petastorm_tpu_torch import chaos, make_batch_reader
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry
    from petastorm_tpu_torch.obs.slo import SloSpec
    from petastorm_tpu_torch.ops import pagedec_kernels as pk

    registry = MetricsRegistry() if slo else None
    specs = [SloSpec(name="inflate-p99",
                     metric='ptpu_pipeline_stage_seconds{stage="device_inflate"}',
                     stat="p99", op="<=", threshold=BLAME_LATENCY_S / 2,
                     breach_windows=1)] if slo else None
    plan = FaultPlan([FaultRule(site, "latency", every=1, latency_s=BLAME_LATENCY_S)],
                     seed=15)
    delivered = {}
    with chaos.armed(plan, propagate=False):
        reader = make_batch_reader("file://" + root, reader_pool_type="thread",
                                   workers_count=1, shuffle_row_groups=False,
                                   io_options={"pagedec": "on", "readahead": False},
                                   provenance=True)
        _tab_launch_counters(zero=True)
        reads0 = pk.HOST_READS.value
        t0 = time.perf_counter()
        with DataLoader(reader, BLAME_RG_ROWS, device=device, metrics=registry,
                        slos=specs) as loader:
            for i, batch in enumerate(loader):
                got = {k: v.cpu().numpy() for k, v in batch.items()}
                delivered[int(got["id"][0]) // BLAME_RG_ROWS] = got
                if slo and i in (3, BLAME_RGS - 1):
                    registry.sample_timelines()  # a window after 4 batches, and the last
            dt = time.perf_counter() - t0
            report = loader.attribution_report()
            alerts = loader.slo_alerts()
    launches = _tab_launch_counters()
    host_reads = pk.HOST_READS.value - reads0
    fires = plan.stats()["injected_total"]
    check(sorted(delivered) == list(range(BLAME_RGS)), "%s: row groups delivered %s"
          % (label, sorted(delivered)))
    for rg, got in delivered.items():
        for name, src in cols.items():
            part = src[rg * BLAME_RG_ROWS:(rg + 1) * BLAME_RG_ROWS]
            check(got[name].dtype == part.dtype and got[name].tobytes() == part.tobytes(),
                  "%s: column %s of row group %d differs from the store"
                  % (label, name, rg))
    check(all(n == BLAME_RGS for n in launches.values()) and host_reads == BLAME_RGS,
          "%s: launches %s and %d reads back to the host for %d batches"
          % (label, launches, host_reads, BLAME_RGS))
    check(fires >= BLAME_RGS, "%s: the plan fired %d times" % (label, fires))
    share = report.slow_share.get(site, 0.0)
    log("%s: %.3f s for %d batches; slow_top %s (%.4f of the slow batches' critical path); "
        "launches %s; plan fires %d; %s; %s" % (
            label, dt, len(delivered), report.slow_top, share, json.dumps(launches), fires,
            _report_brief(report), smi))
    check(report.batches == BLAME_RGS and report.slow_top == site and share > 0.5,
          "%s: the report names %s (slow shares %s), not the slowed %s"
          % (label, report.slow_top, report.slow_share, site))
    if slo:
        check(len(alerts) == 1 and alerts[0].culprit == site
              and alerts[0].attribution["slow_top"] == site,
              "%s: alerts %s" % (label, [(a.name, a.culprit) for a in alerts]))
        log("%s: alert %r" % (label, alerts[0].message))
    return {"dt": dt, "report": report, "launches": launches, "share": share,
            "alerts": [(a.name, a.culprit) for a in alerts]}


def phase_prov_blame(work, smi, device="cuda"):
    """(b): each site slowed in turn, BLAME_ROUNDS rounds; then the SLO alert."""
    root = os.path.join(work, "blame")
    cols = write_blame_store(root)
    out = {site: [] for site in BLAME_SITES}
    for r in range(BLAME_ROUNDS):
        for site in BLAME_SITES:
            out[site].append(blame_run(root, cols, site, "provenance (b) %s slowed, round "
                                       "%d" % (site, r), smi, device=device))
    out["slo"] = blame_run(root, cols, BLAME_SITES[0], "provenance (b) %s slowed, "
                           "slos=" % BLAME_SITES[0], smi, device=device, slo=True)
    log("provenance (b): the slowed site named in %d of %d rounds for each of %s; shares "
        "%s; the SLO alert's culprit %s; %s" % (
            BLAME_ROUNDS, BLAME_ROUNDS, list(BLAME_SITES),
            json.dumps({s: [round(x["share"], 4) for x in out[s]] for s in BLAME_SITES}),
            out["slo"]["alerts"], smi))
    shutil.rmtree(root, ignore_errors=True)
    return out


def phase_prov_main_path(url, images, kernels, smi):
    """(c): the main path with provenance on and off, PROV_ROUNDS rounds."""
    out = {"on": [], "off": []}
    for r in range(PROV_ROUNDS):
        for name in (["on", "off"] if r % 2 == 0 else ["off", "on"]):
            res = chaos_jpeg_run(url, images, "(c) provenance %s round %d" % (name, r), smi,
                                 provenance=True if name == "on" else None)
            check(bool((res["counts"] == 1).all()), "(c) %s: ids not once each" % name)
            if name == "on":
                rep = res["attribution"]
                check(rep.batches == res["batches"] and "loader.decode" in rep.stage_self_s,
                      "(c): the report folds %d batches of %d, sites %s"
                      % (rep.batches, res["batches"], sorted(rep.stage_self_s)))
            out[name].append(res)
    per_batch = {name: sorted({tuple(v // max(1, r["batches"])
                                     for v in r["launches"].values()) for r in runs})
                 for name, runs in out.items()}
    check(per_batch["on"] == per_batch["off"] == [(1, 1, 1)],
          "(c): launches a batch %s" % per_batch)
    s2 = kernels["stage2"]
    device_ms = {"stage2_planes": s2["planes"]["selected"]["ms"],
                 "stage2_rgb": s2["rgb"]["ms"], "K2": kernels["K2"]["bf16"]["ms"]}
    decode_ms = sorted(r["attribution"].stage_self_s["loader.decode"] / r["batches"] * 1e3
                       for r in out["on"])
    on = sorted(r["rows_per_s"] for r in out["on"])
    off = sorted(r["rows_per_s"] for r in out["off"])
    out["ratio"] = on[len(on) // 2] / off[len(off) // 2]
    out["device_ms"] = device_ms
    out["decode_self_ms"] = decode_ms
    log("provenance (c): main path rows/s with provenance %s, without %s (median ratio "
        "%.4f); loader.decode host self time %s ms a batch against the kernels' device "
        "time %s ms a batch (%.4f in all, phase 3); reports: %s; %s" % (
            [round(r["rows_per_s"], 1) for r in out["on"]],
            [round(r["rows_per_s"], 1) for r in out["off"]], out["ratio"],
            [round(x, 4) for x in decode_ms], json.dumps({k: round(v, 4) for k, v in
                                                          device_ms.items()}),
            sum(device_ms.values()), [_report_brief(r["attribution"]) for r in out["on"]],
            smi))
    log("provenance (c) report:\n%s" % out["on"][0]["attribution"].render())
    return out


def phase_prov_tools(prov_tab, work, smi):
    """(d): the trend gate twice, the run diff and the stats CLI."""
    import io as io_mod

    from petastorm_tpu_torch.benchmark import trend
    from petastorm_tpu_torch.obs import diff, stats_cli

    def run(fn, argv):
        buf = io_mod.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        return rc, buf.getvalue().strip().splitlines()

    history = os.path.join(work, "trend_history.jsonl")
    runs = []
    for i in range(2):
        rc, lines = run(trend.main, ["--history", history])
        entries = trend.load_history(history)
        check(len(entries) == i + 1 and entries[-1].get("sites"),
              "(d) trend run %d: %d entries, sites %s" % (
                  i, len(entries), entries[-1].get("sites") if entries else None))
        if i == 0:
            check(rc == 0 and "seeded" in lines[0]
                  and entries[0]["baseline_rows_per_s"] is None,
                  "(d) the first trend run did not seed the history: rc %d, %s"
                  % (rc, lines))
        runs.append({"rc": rc, "verdict": lines[0], "entry": entries[-1]})
        log("provenance (d) trend run %d: exit %d; %s; rows/s %s (epochs %s); sites %s; %s"
            % (i, rc, lines[0], entries[-1]["rows_per_s"], entries[-1]["epoch_rates"],
               json.dumps(entries[-1]["sites"]), smi))
    rc, lines = run(diff.main, ["-2", "-1", "--history", history])
    verdict = json.loads(lines[-1])
    check(rc == 0 and verdict["schema"] == "ptpu-bench-diff-v1",
          "(d) diff: exit %d, last line %s" % (rc, lines[-1]))
    log("provenance (d) diff of the two trend entries: %s" % " | ".join(lines))
    jsonl = prov_tab["thread"]["probe"]["jsonl"]
    rc, lines = run(stats_cli.main, [jsonl])
    panel = [x for x in lines if x.startswith("attribution (critical-path self time")]
    check(rc == 0 and panel, "(d) stats CLI over (a)'s Reporter JSONL: exit %d, no "
          "attribution panel in %d lines" % (rc, len(lines)))
    start = lines.index(panel[0])
    end = start + 1
    while end < len(lines) and lines[end].startswith("  "):
        end += 1
    log("provenance (d) stats CLI attribution panel: %s" % " | ".join(lines[start:end]))
    return {"trend": runs, "diff": verdict}


# -- phase 16: tenants and the closed-loop controller ----------------------------------
#
# The main path's store and configuration under the controller and the tenant plane.
# (a) converge: the store read through CloudLatencyFS (CTL_LATENCY_S a request, no tail,
# CTL_PER_BYTE_S a byte, the remote tier off) with readahead_depth=1 and one worker,
# `metrics=`, `provenance=True` and `controller=ControlOptions(warmup_windows=3,
# settle_windows=2)`, one window a batch; the same run without the controller, and a
# hand-tuned run at depth 8. (b) fleet: two epochs with 4 workers on the thread pool and
# on the process pool over 'arrow', resized to 2 after a third of the run's row groups
# were read and to 4 after two thirds; the process pool's readahead depth retuned to 6
# in between (two epochs: the reader runs up to six row groups ahead of the consumer
# through the loader's queues, and a grown pool's children must find work left).
# (c) clean: the controller armed at the default knobs on the local main path, 0
# actuations, CTL_ROUNDS pairs against unarmed runs. (d) tenants: `team-a` on the thread
# pool, `team-b` on the process pool, then an untagged run; the usage report, the
# per-tenant attribution fold and the stats CLI's tenant panel.
#
# A row group's stage 1 on one worker outlasts a 20 ms request, so with the request
# floor alone a depth-1 prefetch already hides the read and there is nothing for the
# controller to converge on: the per-byte cost (6.7 MB/s a request) makes the read the
# bottleneck at depth 1, as a slow store is for a one-worker reader.

CTL_LATENCY_S = 0.02
CTL_PER_BYTE_S = 1.5e-7
CTL_ROUNDS = 3
CTL_TUNED_DEPTH = 8


def _items_read(reader):
    """Plan items the reader has delivered so far: its consumed-work map, read from the
    consumer's thread while the loader's producer adds to it (a snapshot, retried if the
    map changes size under it)."""
    while True:
        try:
            return sum(len(v) for v in list(reader._consumed.values())) \
                + reader._resume_epoch * reader._num_items
        except RuntimeError:
            continue


def ctl_jpeg_run(url, against, label, smi, pool="thread", workers=None, wire=None,
                 filesystem=None, io_options=None, metrics=None, controller=None,
                 provenance=None, tenant=None, fill=None, on_batch=None,
                 results_queue_size=16, host_queue_size=8, prefetch=3, epochs=1):
    """``epochs`` of the main path (each id once an epoch): every delivered image held
    on the card to
    ``against`` (by id) and, with ``fill``, written into it by id; the launch counters
    zeroed just before and read just after; with ``metrics`` one
    ``registry.sample_timelines()`` a batch (one controller window); ``on_batch(n,
    reader, loader)`` runs after each batch. Returns the per-id counts and what the
    caller checks."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.io.lease import lease_stats
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image

    workers = workers or max(1, min(8, (os.cpu_count() or 2) - 1))

    def transform(batch):
        return {**batch, "image": image.normalize_images(batch["image"], MEAN, STD),
                "image_u8": batch["image"]}

    dev = torch.device("cuda")
    counts = torch.zeros(ROWS, dtype=torch.int32, device=dev)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    leaked0 = lease_stats()["leaked"]
    stamps, extra = [], {}
    batches = rows = 0
    first = None
    reader = make_batch_reader(url, reader_pool_type=pool, workers_count=workers,
                               wire_serializer=wire, shuffle_row_groups=True, seed=0,
                               num_epochs=epochs, decode_on_device=True,
                               filesystem=filesystem,
                               io_options=io_options, results_timeout_s=120,
                               results_queue_size=results_queue_size,
                               provenance=provenance, tenant=tenant)
    executor = reader._executor
    _jpeg_launch_counters(zero=True)
    with DataLoader(reader, BATCH, device="cuda", device_transform=transform,
                    prefetch=prefetch, host_queue_size=host_queue_size,
                    last_batch="partial", metrics=metrics, controller=controller) as loader:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        for batch in loader:
            ids, u8 = batch["id"], batch["image_u8"]
            counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
            bad.add_((against.index_select(0, ids) != u8).sum())
            if fill is not None:
                fill.index_copy_(0, ids, u8)
            if first is None:
                first = (u8[:8].clone(), batch["image"][:8].clone())
            batches += 1
            rows += len(ids)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            if metrics is not None:
                metrics.sample_timelines()
            if on_batch is not None:
                on_batch(batches, reader, loader, extra)
        ctl = loader.controller
        decisions = [d.to_dict() for d in loader.ctl_decisions()]
        knobs = ctl.knobs.describe() if ctl is not None else {}
        frozen = ctl.frozen if ctl is not None else None
        entries = list(loader.quarantine_report.entries)
        attribution = {t: loader.attribution_report(tenant=t)
                       for t in (tenant, "nobody")} if provenance else None
        acks = executor.ctl_acks() if pool == "process" else {}
        # the feeders that sent their child the pending knob frame (before an item)
        sent = sorted(i for i, v in getattr(executor, "_ctl_seen", {}).items()
                      if v and v == executor._ctl_version)
        pool_stats = executor.pool_stats() if pool == "process" else {}
    launches = _jpeg_launch_counters()
    res = {"label": label, "batches": batches, "rows": rows, "stamps": stamps,
           "rows_per_s": rows / (stamps[-1] - stamps[0]), "counts": counts.cpu(),
           "bad": int(bad.item()), "launches": launches, "decisions": decisions,
           "knobs": knobs, "frozen": frozen, "entries": entries,
           "attribution": attribution, "acks": acks, "sent": sent, "pool": pool_stats,
           "leaked": lease_stats()["leaked"] - leaked0, "extra": extra,
           "segments": _own_segments()}
    log("controller %s: %.1f rows/s over %d batches; launches %s; actuations %s; "
        "quarantined %d; leases leaked %d; %s" % (
            label, res["rows_per_s"], batches, json.dumps(launches),
            [(d["knob"], d["before"], d["after"], d["window"]) for d in decisions
             if d["cause"] == "ctl_actuate"], len(entries), res["leaked"], smi))
    check(bool((res["counts"] == epochs).all()), "%s: ids not delivered once an epoch "
          "(counts %s)" % (label, sorted(set(res["counts"].tolist()))))
    check(launches["stage2_planes"] == launches["stage2_rgb"] == launches["K2"]
          == batches, "%s: stage2_planes, stage2_rgb and K2 should launch once a batch "
          "(%d): %s" % (label, batches, launches))
    check(res["bad"] == 0, "%s: %d uint8 values differ, id for id, from the run they "
          "are held to" % (label, res["bad"]))
    check(torch.equal(image._normalize_plain(first[0], MEAN, STD, torch.bfloat16),
                      first[1]), "%s: K2 differs from its plain version on the first "
          "batch" % label)
    check(not entries and res["leaked"] == 0 and not res["segments"],
          "%s: quarantined %s, leases leaked %d, segments left %s"
          % (label, entries, res["leaked"], res["segments"]))
    return res


def _tail_rows_per_s(res, share=1 / 3):
    """Rows/s over the last ``share`` of a run's batches (the converged window)."""
    stamps = res["stamps"]
    tail = max(1, int(round((len(stamps) - 1) * share)))
    return tail * BATCH / (stamps[-1] - stamps[-1 - tail])


def phase_ctl_converge(url, images, smi):
    """(a): the wrong depth on a slow store, with and without the controller, and the
    hand-tuned depth."""
    import torch

    from petastorm_tpu_torch.control import ControlOptions
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    fs = cloud_fs(base_latency_s=CTL_LATENCY_S, per_byte_s=CTL_PER_BYTE_S,
                  tail_fraction=0.0)

    def io(depth):
        return dict(readahead_depth=depth, io_threads=depth, coalesce=False,
                    remote=dict(enabled=False))

    # the off run fills `ref`, which the controller's run is then held to id for id
    ref = torch.zeros_like(images)
    common = dict(workers=1, filesystem=fs, results_queue_size=2, host_queue_size=2,
                  prefetch=1)
    off = ctl_jpeg_run(url, images, "(a) depth 1, no controller", smi, io_options=io(1),
                       fill=ref, metrics=MetricsRegistry(), **common)
    ctl = ctl_jpeg_run(url, ref, "(a) depth 1 with the controller", smi,
                       io_options=io(1), metrics=MetricsRegistry(), provenance=True,
                       controller=ControlOptions(warmup_windows=3, settle_windows=2),
                       **common)
    tuned = ctl_jpeg_run(url, images, "(a) depth %d by hand" % CTL_TUNED_DEPTH, smi,
                         io_options=io(CTL_TUNED_DEPTH), **common)
    moves = [d for d in ctl["decisions"]
             if d["cause"] == "ctl_actuate" and d["knob"] == "readahead_depth"]
    check(moves, "(a): the controller never actuated readahead_depth (decisions %s)"
          % ctl["decisions"])
    check(all(d["window"] and "io.readahead_wait" in d["trigger"] for d in moves),
          "(a): an actuation without its window or signal: %s" % moves)
    out = {"off": off, "controller": ctl, "tuned": tuned, "moves": moves,
           "tail": {k: _tail_rows_per_s(r) for k, r in
                    (("off", off), ("controller", ctl), ("tuned", tuned))}}
    log("controller (a): readahead_depth actuations %s (triggers %s); final knobs %s, "
        "frozen %s; rows/s over the last third: %.1f with the controller, %.1f at depth "
        "%d by hand, %.1f at depth 1 without (%.3f of the hand-tuned arm); %s" % (
            [(d["before"], d["after"], d["window"]) for d in moves],
            [d["trigger"] for d in moves], json.dumps(
                {k: v["value"] for k, v in ctl["knobs"].items()}), ctl["frozen"],
            out["tail"]["controller"], out["tail"]["tuned"], CTL_TUNED_DEPTH,
            out["tail"]["off"], out["tail"]["controller"] / out["tail"]["tuned"], smi))
    return out


def phase_ctl_fleet(url, images, smi):
    """(b): the live resize on both pools, and the knob frame on the process pool."""
    out = {}
    for pool, wire in (("thread", None), ("process", "arrow")):
        def on_batch(n, reader, loader, extra, pool=pool):
            done = _items_read(reader)
            third = 2 * reader._num_items / 3.0
            live = reader.live_workers()
            extra.setdefault("live", []).append(live)
            if "shrunk" not in extra and done >= third:
                check(reader.resize_workers(2) == 2, "(b) %s: resize to 2 refused" % pool)
                extra["shrunk"] = n
            elif "shrunk" in extra and "reached" not in extra and live == 2:
                extra["reached"] = n
            if pool == "process" and "shrunk" in extra and "knob" not in extra \
                    and done >= 1.5 * third:
                extra["knob"] = reader.apply_readahead_depth(6)
                with reader._executor._respawn_lock:
                    extra["survivors"] = sorted(reader._executor._child_by_idx)
            if "reached" in extra and "grown" not in extra and done >= 2 * third:
                check(reader.resize_workers(4) == 4, "(b) %s: resize to 4 refused" % pool)
                extra["grown"] = n
                extra["live_after_grow"] = reader.live_workers()

        res = ctl_jpeg_run(url, images, "(b) %s pool resized" % pool, smi, pool=pool,
                           wire=wire, workers=4, results_queue_size=1, host_queue_size=2,
                           prefetch=1, on_batch=on_batch, epochs=2)
        extra = res["extra"]
        check("reached" in extra and extra.get("live_after_grow") == 4,
              "(b) %s: live_workers() did not reach 2 then 4 (shrunk at batch %s, 2 at "
              "%s, grown at %s to %s; live %s)" % (
                  pool, extra.get("shrunk"), extra.get("reached"), extra.get("grown"),
                  extra.get("live_after_grow"), extra.get("live")))
        if pool == "process":
            # every child that took an item after the retune was sent the frame ahead of
            # it, and each of them must have acked the applied value
            acks = res["acks"]
            check(extra.get("knob") == 6 and res["sent"]
                  and sorted(acks) == res["sent"]
                  and all(a == {"readahead_depth": 6} for a in acks.values())
                  and res["pool"].get("respawns") == 0,
                  "(b) process: the knob frame (applied %s) sent to %s, acked by %s "
                  "(children alive at the retune %s), respawns %s" % (
                      extra.get("knob"), res["sent"], acks, extra.get("survivors"),
                      res["pool"].get("respawns")))
        log("controller (b) %s: shrunk at batch %s, 2 alive at %s, grown at %s (alive "
            "%s); live per batch %s; knob frame sent to %s (alive at the retune %s), "
            "acks %s; %s" % (
                pool, extra.get("shrunk"), extra.get("reached"), extra.get("grown"),
                extra.get("live_after_grow"), extra.get("live"), res["sent"],
                extra.get("survivors"), res["acks"], smi))
        out[pool] = res
    return out


def phase_ctl_clean(url, images, smi):
    """(c): the controller armed on the healthy main path: no actuation; armed against
    unarmed, CTL_ROUNDS pairs alternating which runs first."""
    from petastorm_tpu_torch.obs.metrics import MetricsRegistry

    out = {"armed": [], "off": []}
    for r in range(CTL_ROUNDS):
        for name in (["armed", "off"] if r % 2 == 0 else ["off", "armed"]):
            res = ctl_jpeg_run(url, images, "(c) %s round %d" % (name, r), smi,
                               metrics=MetricsRegistry(),
                               controller=True if name == "armed" else None)
            if name == "armed":
                acts = [d for d in res["decisions"] if d["cause"] == "ctl_actuate"]
                check(not acts, "(c): the controller actuated on a healthy run: %s" % acts)
            out[name].append(res)
    armed = sorted(r["rows_per_s"] for r in out["armed"])
    off = sorted(r["rows_per_s"] for r in out["off"])
    out["ratio"] = armed[len(armed) // 2] / off[len(off) // 2]
    log("controller (c): 0 actuations in %d armed epochs; rows/s armed %s, unarmed %s "
        "(median ratio %.4f); %s" % (
            CTL_ROUNDS, [round(r["rows_per_s"], 1) for r in out["armed"]],
            [round(r["rows_per_s"], 1) for r in out["off"]], out["ratio"], smi))
    return out


def phase_ctl_tenants(url, images, work, smi):
    """(d): two tagged loaders in turn, then an untagged one: the usage report, the
    per-tenant fold and the stats CLI's panel."""
    import io as io_mod

    from petastorm_tpu_torch.obs import stats_cli
    from petastorm_tpu_torch.obs.export import Reporter
    from petastorm_tpu_torch.obs.metrics import default_registry
    from petastorm_tpu_torch.obs.tenant import TenantUsageReport

    def tenant_series():
        return {k: v for k, v in default_registry().snapshot().items()
                if k.startswith("ptpu_tenant_")}

    before = TenantUsageReport.from_registry()
    a = ctl_jpeg_run(url, images, "(d) team-a, thread pool", smi, tenant="team-a",
                     provenance=True)
    b = ctl_jpeg_run(url, images, "(d) team-b, process pool", smi, pool="process",
                     wire="arrow", tenant="team-b")
    tagged = tenant_series()
    untagged = ctl_jpeg_run(url, images, "(d) untagged", smi)
    check(tenant_series() == tagged, "(d): the untagged run changed the tenant series")
    report = TenantUsageReport.from_registry()
    usage = {}
    for name, run in (("team-a", a), ("team-b", b)):
        got = {k: report.get(name, k) - before.get(name, k)
               for k in ("rows", "worker_s", "decode_s", "read_bytes")}
        usage[name] = got
        check(got["rows"] == run["rows"] and got["worker_s"] > 0 and got["decode_s"] > 0,
              "(d) %s: charged %s against %d rows delivered" % (name, got, run["rows"]))
    folds = a["attribution"]
    check(folds["team-a"].batches == a["batches"] and folds["nobody"].batches == 0,
          "(d): attribution_report(tenant='team-a') folds %d of %d batches, another "
          "tenant %d" % (folds["team-a"].batches, a["batches"], folds["nobody"].batches))
    jsonl = os.path.join(work, "tenant_stats.jsonl")
    with Reporter(registry=default_registry(), interval_s=600.0, jsonl_path=jsonl):
        pass
    buf = io_mod.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = stats_cli.main([jsonl])
    lines = buf.getvalue().splitlines()
    check(rc == 0 and "tenants (ptpu_tenant_*):" in lines,
          "(d) stats CLI: exit %d, no tenant panel" % rc)
    start = lines.index("tenants (ptpu_tenant_*):")
    panel = lines[start:start + 3]
    check(sorted(x.split()[0] for x in panel[1:]) == ["team-a", "team-b"],
          "(d) stats CLI tenant panel: %s" % panel)
    log("tenants (d): charged %s; team-a's fold %d batches of %d; the untagged run "
        "added no tenant series; stats CLI panel: %s; %s" % (
            json.dumps({t: {k: round(v, 4) for k, v in u.items()}
                        for t, u in usage.items()}),
            folds["team-a"].batches, a["batches"], " | ".join(panel), smi))
    return {"a": a, "b": b, "untagged": untagged, "usage": usage}


# -- phase 17: dataset watch and mutation ---------------------------------------------
#
# A watched reader over a store that changes under it; the watch thread never ticks on
# its own (a one-hour interval), each tick is a poll_once() call. (a) the main path on
# the thread pool over a fresh copy of phase 1's store, two epochs: after the second
# batch one tick applies a seeded FaultPlan's three mutation rules through a
# LocalDatasetMutator writing the store's own schema (append a fifth file of 1,024 new
# ids, rewrite file 2 with a new id range and new images, remove file 3). The plan also
# holds every first-epoch item of files 2 and 3 at the pool's dispatch (a hang at
# ``worker.item``, or at ``pool.dispatch`` in the process pool's parent, released by the
# disarm right after the tick), so no read of those files runs before the tick: the
# first epoch delivers nothing of them on any pool, and the run is the same on the
# thread and process pools. The readahead is off in all three parts: a prefetch reads
# items before their dispatch (the hold would not hold them), and a read checked before
# the tick delivers the old generation by design (the readahead invariant, pinned by
# the CPU tests), so the split of the first epoch would follow the timing; without it
# a pool claims at most a few items ahead of the consumer. (b) the pass-through over copies of phase 5's files 0 and 1:
# file 1 rewritten from a new seed when the first epoch's last batch arrives, one tick,
# three epochs (the plan has rolled into the second epoch by then, so the new
# generation is planned into the third). (c) (a) on the process pool over 'arrow' with
# 4 children.

WATCH_NEW_SEED = 17
WATCH_TAB_SEED = 18
WATCH_TAB_EPOCHS = 3
WATCH_STAMP_ROUNDS = 3
WATCH_HANG_S = 120.0  # the hold's cap; the disarm after the tick ends it at once


def _watch_copy(src, dst, names=None):
    """A fresh directory of hard links to ``src``'s files (``names``: those only). The
    mutations replace or unlink directory entries, never the linked inodes, so ``src``
    stays as it was."""
    os.makedirs(dst)
    for name in sorted(os.listdir(src)) if names is None else names:
        os.link(os.path.join(src, name), os.path.join(dst, name))
    return dst


def watch_new_blobs(cv2, n):
    """``n`` new JPEG images from WATCH_NEW_SEED, encoded as phase 1 encodes its own."""
    import numpy as np

    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.unischema import UnischemaField

    field = UnischemaField("image", np.uint8, IMG, CompressedImageCodec("jpeg", QUALITY),
                           False)
    imgs = make_images(n, seed=WATCH_NEW_SEED)
    if cv2 is None:
        return [BaselineJpegEncoder(QUALITY).encode(img) for img in imgs]
    return [bytes(field.codec.encode(field, img)) for img in imgs]


def plain_stage2_images(blob_list, dev, chunk=BATCH):
    """The plain stage 2 on the card (``_stage2_planes_plain``, then ``_stage2_rgb_plain``
    in BGR, as the loader delivers) of the host stage 1 of ``blob_list``, full int16
    coefficients: (n, 224, 224, 3) uint8."""
    import torch

    from petastorm_tpu_torch.ops import jpeg

    out = []
    for i in range(0, len(blob_list), chunk):
        planes = jpeg.entropy_decode_jpeg_batch(blob_list[i:i + chunk])
        layout = jpeg._layout_key(planes[0])
        check(all(jpeg._layout_key(p) == layout for p in planes),
              "phase 17: the images are not of one layout")
        coeffs, qtabs = jpeg.stack_jpeg_coefficients(planes)
        segs = [jpeg.CoefSegment(torch.from_numpy(c).to(dev), torch.from_numpy(q).to(dev),
                                 64, False, None, by, bx)
                for (_h, _v, by, bx), c, q in zip(layout[2], coeffs, qtabs)]
        out.append(jpeg._stage2_rgb_plain([jpeg._stage2_planes_plain(s) for s in segs],
                                          layout, bgr=True))
    return torch.cat(out)


def _watch_plan(root, names, new_blobs, held, pool):
    """(a)'s and (c)'s seeded FaultPlan and its mutator (the phase comment above)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule
    from petastorm_tpu_torch.dataset.mutate import LocalDatasetMutator

    schema = pq.read_schema(os.path.join(root, names[0]))

    def table_fn(start, rows):
        ids = range(start, start + rows)
        return pa.table({"id": pa.array(ids, pa.int64()),
                         "image": pa.array([new_blobs[i - ROWS] for i in ids], pa.binary()),
                         "label": pa.array([i % 1000 for i in ids], pa.int32())},
                        schema=schema)

    site = "pool.dispatch" if pool == "process" else "worker.item"
    rules = [FaultRule("dataset.mutate", "append_piece", nth=1,
                       target={"name": "part-zz000.parquet", "start": ROWS,
                               "rows": ROWS_PER_FILE}),
             FaultRule("dataset.mutate", "rewrite_file", nth=1,
                       target={"name": names[2], "start": ROWS + ROWS_PER_FILE,
                               "rows": ROWS_PER_FILE}),
             FaultRule("dataset.mutate", "remove_file", nth=1, target={"name": names[3]})]
    # "ordinal=O " with its space, so that ordinal 1 never matches ordinals 10 to 15
    rules += [FaultRule(site, "hang", hang_s=WATCH_HANG_S,
                        item_key="epoch=0 ordinal=%d " % o) for o in held]
    return FaultPlan(rules, seed=CHAOS_SEED), LocalDatasetMutator(root, table_fn=table_fn)


def watch_jpeg_run(root, ref, new_blobs, label, smi, pool="thread", workers=2, wire=None):
    """One watched main-path run over the store copy ``root`` (the phase comment above).
    ``ref`` holds the plain stage 2's image of every id, old and new. Returns the
    delivered plan items of each epoch, the quarantine entries, the id counts, the
    ``ptpu_dataset_*`` deltas and the launches."""
    import torch

    from petastorm_tpu_torch import chaos, make_batch_reader
    from petastorm_tpu_torch.dataset.watch import watch_metrics
    from petastorm_tpu_torch.io.lease import lease_stats
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image

    names = sorted(n for n in os.listdir(root) if n.endswith(".parquet"))
    check(len(names) == 4, "%s: the store copy holds %d files" % (label, len(names)))
    with make_batch_reader("file://" + root, reader_pool_type="dummy",
                           shuffle_row_groups=False) as probe:
        items0 = [(os.path.basename(p.path), p.row_group) for p, _ in probe._plan.items]
    held = [o for o, (name, _rg) in enumerate(items0) if name in names[2:]]
    plan, mutator = _watch_plan(root, names, new_blobs, held, pool)

    def transform(batch):
        return {**batch, "image": image.normalize_images(batch["image"], MEAN, STD),
                "image_u8": batch["image"]}

    dev = torch.device("cuda")
    n_ids = ROWS + 2 * ROWS_PER_FILE
    counts = torch.zeros(n_ids, dtype=torch.int32, device=dev)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    metrics = watch_metrics()
    counters0 = {k: c.value for k, c in metrics.items()}
    leases0 = lease_stats()
    marks = []
    batches = 0
    first = delta = None
    tick_s = 0.0
    with chaos.armed(plan, propagate=False):
        reader = make_batch_reader("file://" + root, reader_pool_type=pool,
                                   workers_count=workers, wire_serializer=wire,
                                   shuffle_row_groups=False, num_epochs=2,
                                   decode_on_device=True, results_queue_size=2,
                                   io_options={"readahead": False},
                                   recovery=dict(on_poison="quarantine", poison_attempts=1,
                                                 io_retries=0),
                                   results_timeout_s=120, watch={"interval_s": 3600})
        mark = reader._mark_consumed

        def recording(tag):  # every charge to the watermark: deliveries and quarantines
            marks.append(tag)
            mark(tag)

        reader._mark_consumed = recording
        watcher = reader.dataset_watcher
        watcher.set_mutator(mutator)
        _jpeg_launch_counters(zero=True)
        t0 = time.perf_counter()
        with DataLoader(reader, BATCH, device="cuda", device_transform=transform,
                        prefetch=1, host_queue_size=2, last_batch="partial") as loader:
            for batch in loader:
                ids, u8 = batch["id"], batch["image_u8"]
                counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
                bad.add_((ref.index_select(0, ids) != u8).sum())
                if first is None:
                    first = (u8[:8].clone(), batch["image"][:8].clone())
                batches += 1
                if batches == 2:
                    t_tick = time.perf_counter()
                    delta = watcher.poll_once()
                    tick_s = time.perf_counter() - t_tick
                    chaos.disarm()  # the held items go now, to fail their check
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            entries = [(os.path.basename(e.path), e.row_group, e.kind, e.epoch, e.ordinal,
                        type(e.error).__name__) for e in loader.quarantine_report.entries]
            items = [(os.path.basename(p.path), p.row_group) for p, _ in reader._plan.items]
            io = reader.io_stats()
    launches = _jpeg_launch_counters()
    counters = {k: c.value - counters0[k] for k, c in metrics.items()}
    leases = {k: lease_stats()[k] - leases0[k] for k in ("acquired", "released", "leaked")}
    quarantined = {(e, o) for _n, _rg, _k, e, o, _t in entries}
    delivered = collections.defaultdict(set)
    for epoch, ordinal in marks:
        if (epoch, ordinal) not in quarantined:
            gen = "new" if ordinal >= len(items0) else "old"
            delivered[epoch].add(items[ordinal] + (gen,))
    kinds = collections.Counter((n, k, e) for n, _rg, k, e, _o, _t in entries)
    c = counts.cpu()
    watch = {k: io.get(k) for k in ("watch_ticks", "watch_deltas", "watch_errors")}
    res = {"label": label, "batches": batches, "launches": launches, "entries": entries,
           "kinds": dict(kinds), "counters": counters, "leases": leases,
           "delivered": dict(delivered), "counts": c, "bad": int(bad.item()),
           "rows_per_s": int(c.sum()) / dt, "tick_s": tick_s, "watch": watch}
    log("watch %s: %d batches in %.2f s (%.1f rows/s); tick %r in %.4f s applied %s; "
        "launches %s; quarantined %s; ptpu_dataset_* %s; watcher %s; leases %s; %s" % (
            label, batches, dt, res["rows_per_s"], delta, tick_s, mutator.applied,
            json.dumps(launches), sorted(kinds.items()), json.dumps(counters),
            json.dumps(watch), leases, smi))
    # -- checks ------------------------------------------------------------------------
    check(launches["stage2_planes"] == launches["stage2_rgb"] == launches["K2"] == batches,
          "%s: stage2_planes, stage2_rgb and K2 should launch once a batch (%d): %s"
          % (label, batches, launches))
    check(res["bad"] == 0, "%s: %d uint8 values differ from the plain stage 2's image of "
          "the same id" % (label, res["bad"]))
    check(torch.equal(image._normalize_plain(first[0], MEAN, STD, torch.bfloat16), first[1]),
          "%s: K2 differs from its plain version on the first batch" % label)
    check(leases["leaked"] == 0 and leases["acquired"] == leases["released"],
          "%s: leases %s" % (label, leases))
    check(mutator.applied == [("append_piece", "part-zz000.parquet"),
                              ("rewrite_file", names[2]), ("remove_file", names[3])],
          "%s: the plan applied %s" % (label, mutator.applied))
    old = {(n, rg, "old") for n, rg in items0 if n in names[:2]}
    appended, rewritten = ("part-zz000.parquet", 0, "new"), (names[2], 0, "new")
    want = {0: old | {appended}, 1: old | {appended, rewritten}}
    check(res["delivered"] == want, "%s: delivered plan items by epoch %s, expected %s"
          % (label, res["delivered"], want))
    per_file = collections.Counter(n for n, _rg in items0)
    want_q = {(names[2], "piece_rewritten", e): per_file[names[2]] for e in (0, 1)}
    want_q.update({(names[3], "piece_removed", e): per_file[names[3]] for e in (0, 1)})
    check(res["kinds"] == want_q, "%s: quarantined %s, expected %s"
          % (label, res["kinds"], want_q))
    check(all(t == {"piece_rewritten": "PieceRewrittenError",
                    "piece_removed": "PieceRemovedError"}[k]
              for _n, _rg, k, _e, _o, t in entries),
          "%s: quarantine errors %s" % (label, sorted({(k, t) for _n, _r, k, _e, _o, t
                                                       in entries})))
    spans = {"files 0-1": (0, 2 * ROWS_PER_FILE, 2),
             "file 2, old": (2 * ROWS_PER_FILE, 3 * ROWS_PER_FILE, 0),
             "file 3": (3 * ROWS_PER_FILE, ROWS, 0),
             "appended": (ROWS, ROWS + ROWS_PER_FILE, 2),
             "file 2, new": (ROWS + ROWS_PER_FILE, n_ids, 1)}
    for what, (lo, hi, times) in spans.items():
        check(bool((c[lo:hi] == times).all()), "%s: ids of %s delivered %s times, not %d"
              % (label, what, sorted(set(c[lo:hi].tolist())), times))
    conflicts = sum(n for (_n, k, _e), n in kinds.items() if k == "piece_rewritten")
    check(counters == {"pieces_added": 1, "pieces_removed": per_file[names[3]],
                       "pieces_rewritten": per_file[names[2]], "plan_extensions": 1,
                       "generation_conflicts": conflicts},
          "%s: ptpu_dataset_* counters moved %s" % (label, counters))
    check(watch == {"watch_ticks": 1, "watch_deltas": 1, "watch_errors": 0},
          "%s: watcher %s" % (label, watch))
    return res


def phase_watch_main_path(store_root, blobs, images, work, env):
    """(a) on the thread pool and (c) on the process pool, each over its own copy of
    phase 1's store, against the plain stage 2 of every id; the stamping's cost on
    the copy, with and without the footer crc."""
    import pyarrow.fs as pafs
    import torch

    from petastorm_tpu_torch.dataset.watch import stamp_generation_tokens
    from petastorm_tpu_torch.io.footercache import shared_footer_cache
    from petastorm_tpu_torch.metadata import load_row_groups

    smi = env["smi"]
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    new_blobs = watch_new_blobs(env["cv2"], 2 * ROWS_PER_FILE)
    t1 = time.perf_counter()
    ref = torch.empty((ROWS + len(new_blobs),) + IMG, dtype=torch.uint8, device=dev)
    ref[:ROWS] = images
    ref[ROWS:] = plain_stage2_images(new_blobs, dev)
    # phase 7's images of the old ids are the kernels' (equal run after run); hold the
    # first batch of them to the plain stage 2 here too
    sample = plain_stage2_images([blobs[i] for i in range(BATCH)], dev)
    torch.cuda.synchronize()
    check(torch.equal(sample, images[:BATCH]), "phase 17: phase 7's images of ids 0-255 "
          "differ from the plain stage 2 of the same rows")
    log("watch: %d new images encoded in %.2f s; plain stage 2 references in %.2f s"
        % (len(new_blobs), t1 - t0, time.perf_counter() - t1))
    # the stamping cost: one stat and one fresh footer parse a file (the crc), or a stat
    stamp_root = _watch_copy(store_root, os.path.join(work, "watch_stamp"))
    fs = pafs.LocalFileSystem()
    pieces = load_row_groups(fs, stamp_root)
    stamp = {}
    for crc in (True, False):
        times = []
        for _ in range(WATCH_STAMP_ROUNDS):
            shared_footer_cache().clear()
            t = time.perf_counter()
            stamped = stamp_generation_tokens(fs, pieces, footer_crc=crc)
            times.append(time.perf_counter() - t)
        check(all(p.generation and (p.generation.endswith(".-") != crc) for p in stamped),
              "phase 17: stamping (footer_crc=%s) left a piece unstamped" % crc)
        stamp["crc" if crc else "stat_only"] = sorted(times)[len(times) // 2]
    log("watch: stamping %d pieces of %d files adds %.6f s to the reader's construction "
        "with the footer crc, %.6f s without (median of %d); %s" % (
            len(pieces), len({p.path for p in pieces}), stamp["crc"], stamp["stat_only"],
            WATCH_STAMP_ROUNDS, smi))
    a = watch_jpeg_run(_watch_copy(store_root, os.path.join(work, "watch_a")), ref,
                       new_blobs, "(a) thread", smi)
    c = watch_jpeg_run(_watch_copy(store_root, os.path.join(work, "watch_c")), ref,
                       new_blobs, "(c) process/arrow", smi, pool="process", workers=4,
                       wire="arrow")
    check(c["delivered"] == a["delivered"] and c["kinds"] == a["kinds"]
          and torch.equal(c["counts"], a["counts"]),
          "(c): the process pool's items, ids or quarantine differ from the thread pool's")
    log("watch (a)/(c): the same items and ids in each epoch and the same quarantine on "
        "both pools; rows/s %.1f thread, %.1f process; %s" % (
            a["rows_per_s"], c["rows_per_s"], smi))
    return {"a": a, "c": c, "stamp_s": stamp}


def phase_watch_tabular(root, arrays, predicted, work, smi):
    """(b): the pass-through over copies of phase 5's files 0 and 1 (the phase comment
    above): every batch byte-identical to its source, the old generation's or pyarrow's
    read of the new bytes; the file's refusals dropped at the tick; the new generation
    only in the third epoch, after every batch of the old one; one K3, scan and K4
    launch a batch."""
    import pyarrow.fs as pafs
    import pyarrow.parquet as pq

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.dataset.watch import current_stat_token
    from petastorm_tpu_torch.io import pagedec
    from petastorm_tpu_torch.io.footercache import metadata_crc, shared_footer_cache
    from petastorm_tpu_torch.loader import DataLoader

    names = ["part-%d.parquet" % f for f in range(CHAOS_TAB_FILES)]
    wdir = _watch_copy(root, os.path.join(work, "watch_tab"), names)
    path1 = os.path.join(wdir, names[1])
    per_epoch = CHAOS_TAB_FILES * TAB_RGS_PER_FILE
    new = None
    seen = []  # (batch index, source): (f, rg) of the old files, or ("new", rg)
    refused, delta, write_s = set(), None, 0.0
    counters0 = pagedec.counter_values()
    reader = make_batch_reader("file://" + wdir, workers_count=2, results_queue_size=2,
                               shuffle_row_groups=False, num_epochs=WATCH_TAB_EPOCHS,
                               io_options={"pagedec": "on", "readahead": False},
                               recovery=dict(on_poison="quarantine", poison_attempts=1,
                                             io_retries=0),
                               results_timeout_s=120, watch={"interval_s": 3600})
    _tab_launch_counters(zero=True)
    t0 = time.perf_counter()
    with DataLoader(reader, TAB_BATCH, device="cuda", prefetch=1,
                    host_queue_size=1) as loader:
        for i, batch in enumerate(loader):
            got = {k: v.cpu().numpy() for k, v in batch.items()}
            sources = arrays[:CHAOS_TAB_FILES] + ([new] if new is not None else [])
            f, rg = _rowgroup_of({k: got[k][0] for k in TAB_COLUMNS}, sources, TAB_BATCH)
            for k in TAB_COLUMNS:
                src = sources[f][k][rg * TAB_BATCH:(rg + 1) * TAB_BATCH]
                check(got[k].dtype == src.dtype and got[k].tobytes() == src.tobytes(),
                      "(b): column %s of batch %d differs from its source" % (k, i))
            seen.append((i, ("new", rg) if f == CHAOS_TAB_FILES else (f, rg)))
            if i + 1 == per_epoch:
                # a refusal of the old generation's column must not outlive it
                reader._worker._pagedec_refused.add((path1, "label"))
                t_w = time.perf_counter()
                tmp = os.path.join(work, "watch_tab_new")
                _url, (new_arrays,) = write_tabular_store(
                    tmp, seed=WATCH_TAB_SEED, files=1, rgs_per_file=TAB_RGS_PER_FILE,
                    rg_rows=TAB_RG_ROWS)
                os.replace(os.path.join(tmp, "part-0.parquet"), path1)
                write_s = time.perf_counter() - t_w
                delta = reader.dataset_watcher.poll_once()
                table = pq.read_table(path1)  # pyarrow's read of the new bytes
                new = {k: table.column(k).to_numpy() for k in TAB_COLUMNS}
                check(all(new[k].tobytes() == new_arrays[k].tobytes() for k in TAB_COLUMNS),
                      "(b): pyarrow's read of the new file differs from what was written")
                refused = set(reader._worker._pagedec_refused)
        dt = time.perf_counter() - t0
        entries = [(os.path.basename(e.path), e.row_group, e.kind, e.epoch)
                   for e in loader.quarantine_report.entries]
        io = reader.io_stats()
    launches = _tab_launch_counters()
    counters = {k: v - counters0[k] for k, v in pagedec.counter_values().items()}
    entry = shared_footer_cache().peek(path1)
    stat = current_stat_token(pafs.LocalFileSystem(), path1)
    batches = len(seen)
    tally = collections.Counter(src for _i, src in seen)
    log("watch (b): %d batches in %.2f s (%.1f rows/s); new file written in %.2f s, tick "
        "%r; launches %s; quarantined %s; counters %s; watcher %s; %s" % (
            batches, dt, batches * TAB_BATCH / dt, write_s, delta, json.dumps(launches),
            sorted(collections.Counter((n, k, e) for n, _rg, k, e in entries).items()),
            json.dumps(counters), json.dumps({k: io.get(k) for k in (
                "watch_ticks", "watch_deltas", "watch_errors")}), smi))
    want = {(0, rg): WATCH_TAB_EPOCHS for rg in range(TAB_RGS_PER_FILE)}
    want.update({(1, rg): 1 for rg in range(TAB_RGS_PER_FILE)})
    want.update({("new", rg): 1 for rg in range(TAB_RGS_PER_FILE)})
    check(dict(tally) == want, "(b): row groups delivered %s" % dict(tally))
    last_old = max(i for i, src in seen if src[0] == 1)
    check(all(i > last_old for i, src in seen if src[0] == "new"),
          "(b): a batch of the new generation came before the old one's last")
    check(sorted((n, rg, k, e) for n, rg, k, e in entries) == sorted(
        (names[1], rg, "piece_rewritten", e) for e in (1, 2)
        for rg in range(TAB_RGS_PER_FILE)), "(b): quarantine report %s" % entries)
    check(not [t for t in refused if t[0] == path1], "(b): the old generation's refusal "
          "survived the tick: %s" % sorted(refused))
    check(entry is None or (entry.stat_token in (None, stat)
                            and entry.crc == metadata_crc(pq.read_metadata(path1))),
          "(b): the footer cache holds a stale footer of the rewritten file")
    check(counters["host_inflate_columns"] == 0 and counters["fallback_columns"] == 0,
          "(b): counters %s" % counters)
    for k in ("K3", "scan", "K4"):
        check(launches[k] == predicted[k] * batches, "(b): %s launched %d times for %d "
              "pass-through batches" % (k, launches[k], batches))
    return {"launches": launches, "batches": batches, "entries": entries,
            "rows_per_s": batches * TAB_BATCH / dt}


# -- phase 18: multi-card placement -------------------------------------------------
#
# BASELINE.json config #5: the main path and the pass-through feeding a data-parallel
# job through ``sharding=batch_sharding(make_mesh())`` (each rank reads its shard, cuts
# its share of the global batch, decodes it on its own card and gets DTensors of its
# rows). The machine has one card, so: (a) a world of one over NCCL on cuda:0, phase 4's
# store and configuration (K2 as the device transform), every field a DTensor
# (``Shard(0)``, the global batch of 256), the pixels per id equal to phase 7's
# unsharded run; (b) two ranks over gloo, both on the one card (each rank sets cuda:0
# before ``init_device_mesh``; NCCL refuses two ranks on one device, and gloo runs only
# some collectives on CUDA tensors, so the ranks compare through host copies with
# ``all_gather_object``): each rank's main path over its shard (global batch 256, 128 a
# rank), its two-epoch ``InMemDataLoader`` over the same shard, and its pass-through of
# phase 5's store (``pagedec="on"``, global batch 32,768, one row group a rank a batch).
# Phase 1's row groups are not all one size, so the ranks' shards differ (1,896 and 2,200
# rows): each rank's main path delivers its shard's full batches (the rows of its last
# partial batch, whichever its three reader threads finish last, are dropped),
# the in-memory loader serves the smaller shard's full batches an epoch (the batch count
# agreed across the ranks). Checked: the ids once across the ranks, pixels per id equal
# to phase 7's (a 64-bit weighted digest a row, weights from PLACE_SEED), the
# pass-through's rows equal to the source's (sorted 64-bit row keys over the 40
# columns), each kernel launched once a batch on each rank. The first DTensor built in a
# process imports torch's distributed-tensor machinery (hundreds of modules): it is
# timed apart, before each timed window. Placement across more than one physical card
# stays unmeasured here.

PLACE_SEED = 19
PLACE_WORKERS = 3  # a rank's reader threads: the two ranks share the host's cores
PLACE_DEADLINE_S = 300


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pixel_weights(device):
    """PLACE_SEED's int64 weights, one an image value: a row's digest is its weighted
    sum (below 2**63 for uint8 rows of IMG)."""
    import torch

    gen = torch.Generator(device="cpu")
    gen.manual_seed(PLACE_SEED)
    return torch.randint(1, 1 << 31, (IMG[0] * IMG[1] * IMG[2],), generator=gen,
                         dtype=torch.int64).to(device)


def pixel_digest(rows, weights, chunk=BATCH):
    """A 64-bit digest of each uint8 image row, on the rows' device: (n,) int64."""
    import torch

    out = [(rows[i:i + chunk].reshape(len(rows[i:i + chunk]), -1).to(torch.int64)
            * weights).sum(1) for i in range(0, len(rows), chunk)]
    return torch.cat(out)


def warm_dtensor(sharding):
    """Seconds of the process's first DTensor (``to_dtensor`` of one element on the
    card), which imports torch's distributed-tensor machinery."""
    import torch

    from petastorm_tpu_torch.parallel.mesh import to_dtensor

    t0 = time.perf_counter()
    to_dtensor(torch.zeros(1, device=sharding.device), sharding)
    return time.perf_counter() - t0


def _all_dtensors(batch):
    from torch.distributed.tensor import DTensor, Shard

    return all(isinstance(v, DTensor) and tuple(v.placements) == (Shard(0),)
               for v in batch.values())


def phase_place_world_of_one(url, images, smi):
    """(a) (comment above); ``images`` ((ROWS, 224, 224, 3) uint8 on the card, by id)
    from phase 7's first thread-pool run."""
    import datetime

    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image
    from petastorm_tpu_torch.parallel.mesh import batch_sharding, make_mesh

    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d" % _free_port(),
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh()
        first_s = warm_dtensor(batch_sharding(mesh))
        workers = max(1, min(8, (os.cpu_count() or 2) - 1))
        reader = make_batch_reader(url, decode_on_device=True, workers_count=workers,
                                   shuffle_row_groups=False)
        counts = torch.zeros(ROWS, dtype=torch.int32, device="cuda")
        bad = torch.zeros((), dtype=torch.int64, device="cuda")
        placed, shapes, plain_ok, batches = True, set(), False, 0
        _jpeg_launch_counters(zero=True)
        t0 = time.perf_counter()
        with DataLoader(reader, BATCH, sharding=batch_sharding(mesh),
                        device_transform=_jpeg_transform()) as loader:
            device = loader.device
            for batch in loader:
                placed = placed and _all_dtensors(batch)
                shapes.add(tuple(batch["image_u8"].shape))
                ids = batch["id"].to_local()
                u8 = batch["image_u8"].to_local()
                counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
                bad.add_((images.index_select(0, ids) != u8).sum())
                if batches == 0:
                    plain_ok = torch.equal(batch["image"].to_local(), image._normalize_plain(
                        u8, MEAN, STD, torch.bfloat16))
                batches += 1
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _jpeg_launch_counters()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    rows_per_s = batches * BATCH / wall
    log("placement (a): a world of one over %s on %s (the first DTensor %.3f s), %d "
        "batches of %d (%.1f rows/s); shapes %s; launches %s; %d uint8 values apart from "
        "phase 7's images; %s" % (
            backend, device, first_s, batches, BATCH, rows_per_s, sorted(shapes),
            json.dumps(launches), bad.item(), smi))
    check(device == torch.device("cuda", 0), "(a): the loader's device is %s" % device)
    check(placed, "(a): a delivered field is not a DTensor placed Shard(0)")
    check(shapes == {(BATCH,) + IMG}, "(a): global shapes %s" % sorted(shapes))
    check(bool((counts == 1).all()), "(a): ids not delivered once each")
    check(bad.item() == 0, "(a): images differ from phase 7's unsharded run")
    check(plain_ok, "(a): K2 differs from its plain version")
    check(launches["stage2_planes"] == launches["stage2_rgb"] == launches["K2"] == batches
          == ROWS // BATCH, "(a): launches %s for %d batches" % (launches, batches))
    return {"launches": launches, "batches": batches, "rows_per_s": rows_per_s,
            "first_dtensor_s": first_s}


def _shard_ids(url, rank, world):
    """The ids of the rank's shard in the order its reader delivers them (host read of
    the id column)."""
    import numpy as np

    from petastorm_tpu_torch import make_batch_reader

    with make_batch_reader(url, schema_fields=["id"], cur_shard=rank, shard_count=world,
                           reader_pool_type="dummy", shuffle_row_groups=False) as r:
        return [int(i) for b in r for i in np.asarray(b.id)]


def _rank_main_path(url, rank, world, sharding, weights):
    """(b)'s main path on one rank: its shard, its share of the global batch."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image

    reader = make_batch_reader(url, decode_on_device=True, cur_shard=rank, shard_count=world,
                               workers_count=PLACE_WORKERS, shuffle_row_groups=False)
    ids, digests, placed, plain_ok, batches = [], [], True, False, 0
    _jpeg_launch_counters(zero=True)
    t0 = time.perf_counter()
    with DataLoader(reader, BATCH, sharding=sharding,
                    device_transform=_jpeg_transform()) as loader:
        local_batch = loader.local_batch_size
        for batch in loader:
            placed = placed and _all_dtensors(batch) \
                and tuple(batch["image_u8"].shape) == (BATCH,) + IMG
            u8 = batch["image_u8"].to_local()
            ids.append(batch["id"].to_local())
            digests.append(pixel_digest(u8, weights))
            if batches == 0:
                plain_ok = torch.equal(batch["image"].to_local(), image._normalize_plain(
                    u8, MEAN, STD, torch.bfloat16))
            batches += 1
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"ids": torch.cat(ids).tolist(), "digests": torch.cat(digests).tolist(),
            "placed": placed, "plain_ok": plain_ok, "batches": batches,
            "local_batch": local_batch, "launches": _jpeg_launch_counters(),
            "rows_per_s": batches * local_batch / wall}


def _rank_inmem(url, rank, world, sharding, weights):
    """(b)'s in-memory loader on one rank: its shard resident on the card, two epochs
    of global batches."""
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.loader import InMemDataLoader

    reader = make_batch_reader(url, decode_on_device=True, cur_shard=rank, shard_count=world,
                               workers_count=PLACE_WORKERS, shuffle_row_groups=True, seed=0)
    _jpeg_launch_counters(zero=True)
    t0 = time.perf_counter()
    loader = InMemDataLoader(reader, BATCH, num_epochs=INMEM_EPOCHS, seed=0,
                             sharding=sharding, device_transform=_k2_transform(["image"]))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    fill = _jpeg_launch_counters()
    _jpeg_launch_counters(zero=True)
    epochs = [[] for _ in range(INMEM_EPOCHS)]
    digests, placed = {}, True
    with loader:
        per_epoch = len(loader)
        for n, batch in enumerate(loader):
            placed = placed and _all_dtensors(batch) and batch["id"].shape == (BATCH,)
            ids = batch["id"].to_local()
            epochs[n // per_epoch].append(ids)
            for i, d in zip(ids.tolist(), pixel_digest(batch["image_u8"].to_local(),
                                                       weights).tolist()):
                digests.setdefault(i, set()).add(d)
        torch.cuda.synchronize()
    return {"epochs": [torch.cat(e).tolist() for e in epochs], "per_epoch": per_epoch,
            "local_batch": loader.local_batch_size, "rows": loader.rows,
            "digests": {str(i): sorted(d) for i, d in digests.items()}, "placed": placed,
            "fill_launches": fill, "launches": _jpeg_launch_counters(), "fill_s": fill_s}


def _rank_passthrough(tab_root, rank, world, sharding, out):
    """(b)'s pass-through on one rank: its shard of phase 5's store, one row group a
    rank a batch; the sorted row keys go to ``out`` (.npy)."""
    import numpy as np
    import torch

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.io import pagedec
    from petastorm_tpu_torch.loader import DataLoader

    reader = make_batch_reader("file://" + tab_root, cur_shard=rank, shard_count=world,
                               workers_count=PLACE_WORKERS, shuffle_row_groups=False,
                               io_options={"pagedec": "on"})
    counters0 = pagedec.counter_values()
    _tab_launch_counters(zero=True)
    keys, placed, batches = [], True, 0
    t0 = time.perf_counter()
    with DataLoader(reader, world * TAB_RG_ROWS, sharding=sharding) as loader:
        for batch in loader:
            placed = placed and _all_dtensors(batch) \
                and batch["label"].shape == (world * TAB_RG_ROWS,)
            keys.append(row_keys({k: v.to_local() for k, v in batch.items()}))
            batches += 1
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    np.save(out, torch.cat(keys).sort().values.cpu().numpy())
    counters = {k: v - counters0[k] for k, v in pagedec.counter_values().items()}
    return {"batches": batches, "placed": placed, "launches": _tab_launch_counters(),
            "host_inflate_columns": counters["host_inflate_columns"],
            "rows_per_s": batches * TAB_RG_ROWS / wall}


def phase18_rank(rank, world, port, cfg, out):
    """One rank of (b), in a spawned process: joins the gloo group with a deadline,
    builds the mesh on the card, runs the three parts, checks its ids against the other
    ranks' through ``all_gather_object`` and writes JSON to ``out``."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)  # one card: every rank on it (the mesh keeps a set device)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from petastorm_tpu_torch.parallel.mesh import batch_sharding, make_mesh

        mesh = make_mesh()
        sharding = batch_sharding(mesh)
        weights = pixel_weights("cuda")
        res = {"device": str(sharding.device), "mesh": list(mesh.mesh.shape),
               "first_dtensor_s": warm_dtensor(sharding),
               "shard": _shard_ids(cfg["url"], rank, world)}
        res["main"] = _rank_main_path(cfg["url"], rank, world, sharding, weights)
        res["inmem"] = _rank_inmem(cfg["url"], rank, world, sharding, weights)
        res["tab"] = _rank_passthrough(cfg["tab_root"], rank, world, sharding,
                                       out + ".keys.npy")
        # the other ranks' ids, through host copies
        everyone = [None] * world
        dist.all_gather_object(everyone, {"main": res["main"]["ids"],
                                          "inmem": res["inmem"]["epochs"],
                                          "shard": len(res["shard"])})
        res["others"] = [e for r, e in enumerate(everyone) if r != rank]
        res["shard_rows"] = [e["shard"] for e in everyone]
        with open(out, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_place_two_ranks(url, tab_root, arrays, digests, predicted, work, smi):
    """(b) (comment above); ``digests`` ((ROWS,) int64 by id) of phase 7's images."""
    import multiprocessing

    import numpy as np
    import torch

    world = 2
    cfg = {"url": url, "tab_root": tab_root}
    outs = [os.path.join(work, "place_rank%d.json" % r) for r in range(world)]
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=phase18_rank, args=(r, world, port, cfg, outs[r]))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=PLACE_DEADLINE_S)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.terminate()
            p.join(10)
    wall = time.perf_counter() - t0
    check(not alive and [p.exitcode for p in procs] == [0] * world,
          "(b): the ranks exited %s (alive after %d s: %d)" % (
              [p.exitcode for p in procs], PLACE_DEADLINE_S, len(alive)))
    res = [json.load(open(o)) for o in outs]
    want = digests.tolist()
    keys = np.sort(np.concatenate([np.load(o + ".keys.npy") for o in outs]))
    src = []
    for cols in arrays:
        t = {k: torch.from_numpy(v).cuda() for k, v in cols.items()}
        src.append(row_keys(t))
    src = torch.cat(src).sort().values.cpu().numpy()
    for rank, r in enumerate(res):
        m, im, tb = r["main"], r["inmem"], r["tab"]
        log("placement (b) rank %d on %s (the first DTensor %.3f s, a shard of %d rows): "
            "main path %d batches of %d (%.1f rows/s) launches %s; in-memory fill %.2f s, "
            "launches %s, %d batches served, launches %s; pass-through %d batches (%.1f "
            "rows/s) launches %s; %s" % (
                rank, r["device"], r["first_dtensor_s"], len(r["shard"]), m["batches"],
                m["local_batch"], m["rows_per_s"], json.dumps(m["launches"]), im["fill_s"],
                json.dumps(im["fill_launches"]), INMEM_EPOCHS * im["per_epoch"],
                json.dumps(im["launches"]), tb["batches"], tb["rows_per_s"],
                json.dumps(tb["launches"]), smi))
        local = BATCH // world
        shard = r["shard"]
        check(r["device"] == "cuda:0" and r["mesh"] == [world], "(b) rank %d: device %s, "
              "mesh %s" % (rank, r["device"], r["mesh"]))
        check(sum(r["shard_rows"]) == ROWS, "(b) rank %d: shards of %s rows" % (
            rank, r["shard_rows"]))
        check(m["local_batch"] == local and m["batches"] == len(shard) // local
              and len(m["ids"]) == len(set(m["ids"])) == m["batches"] * local
              and set(m["ids"]) <= set(shard), "(b) rank %d: %d batches of %d, not its "
              "shard's full batches, each row once" % (rank, m["batches"],
                                                       m["local_batch"]))
        check(m["placed"] and m["plain_ok"], "(b) rank %d main path: placed %s, K2 equal "
              "to plain %s" % (rank, m["placed"], m["plain_ok"]))
        check(all(not set(m["ids"]) & set(o["main"]) for o in r["others"]),
              "(b) rank %d: main-path ids delivered by another rank too" % rank)
        check(all(want[i] == d for i, d in zip(m["ids"], m["digests"])),
              "(b) rank %d: main-path pixels differ from phase 7's unsharded run" % rank)
        check(m["launches"]["stage2_planes"] == m["launches"]["stage2_rgb"]
              == m["launches"]["K2"] == m["batches"], "(b) rank %d main path: launches %s"
              % (rank, m["launches"]))
        per_epoch = min(r["shard_rows"]) // local  # the agreed batch count
        check(im["placed"] and im["local_batch"] == local and im["rows"] == ROWS
              and im["per_epoch"] == per_epoch, "(b) rank %d in-memory: placed %s, %d "
              "batches an epoch of %d" % (rank, im["placed"], im["per_epoch"],
                                          im["local_batch"]))
        for e, ids in enumerate(im["epochs"]):
            check(len(ids) == len(set(ids)) == per_epoch * local and set(ids) <= set(shard)
                  and all(not set(ids) & set(o["inmem"][e]) for o in r["others"]),
                  "(b) rank %d in-memory epoch %d: ids not once, or not its shard's" % (
                      rank, e))
        check(im["epochs"][0] != im["epochs"][1], "(b) rank %d in-memory: the epochs' "
              "orders are equal" % rank)
        check(all(d == [want[int(i)]] for i, d in im["digests"].items()),
              "(b) rank %d in-memory: pixels differ from phase 7's" % rank)
        fill_batches = -(-len(shard) // BATCH)
        check(im["fill_launches"]["stage2_planes"] == im["fill_launches"]["stage2_rgb"]
              == fill_batches and im["launches"]["K2"] == INMEM_EPOCHS * im["per_epoch"]
              and im["launches"]["stage2_planes"] == 0, "(b) rank %d in-memory: fill "
              "launches %s, served %s" % (rank, im["fill_launches"], im["launches"]))
        check(tb["placed"] and tb["host_inflate_columns"] == 0, "(b) rank %d pass-through: "
              "placed %s, host-inflated columns %d" % (rank, tb["placed"],
                                                       tb["host_inflate_columns"]))
        for k in ("K3", "scan", "K4"):
            check(tb["launches"][k] == predicted[k] * tb["batches"], "(b) rank %d: %s "
                  "launched %d times for %d pass-through batches" % (
                      rank, k, tb["launches"][k], tb["batches"]))
    check(sum(r["tab"]["batches"] for r in res) == TAB_FILES * TAB_RGS_PER_FILE
          and np.array_equal(keys, src), "(b): the ranks' pass-through rows are not the "
          "store's rows, each once")
    log("placement (b): two ranks on one card in %.1f s; %s" % (wall, smi))
    return {"ranks": res, "wall_s": wall}


# -- phase 19: the process pool on tcp ---------------------------------------------------
#
# The process pool's wire as framed tcp (``transport='tcp'``): each of TCP_WORKERS
# children dials back to the pool's hub, and results ride length-prefixed crc32-checked
# frames with heartbeats, a redial after a link death and the in-flight ledger. (a) the
# main path, phase 4's store read with make_batch_reader(decode_on_device=True,
# reader_pool_type='process', transport=...) into DataLoader(128) with K2 as the device
# transform, one epoch (32 batches of 128) on the pipe and then on tcp: every id once,
# the pixels per id phase 7's in both (so the two wires deliver the same), the kernels
# once a batch; rows/s of each and the p50 of the heartbeat round trip printed. (b) phase
# 5's pass-through over the pipe and over tcp at TCP_TAB_WARMUP + TCP_TAB_MEASURED
# batches, with phase 5's checks (byte identity to the source, one K3, scan and K4 a
# batch). (c) (a) on tcp with a seeded net.reset at the parent's transport.send: the link
# is torn down, the child redials, the item goes out again on the healed link: every id
# once, nothing quarantined, a reconnect counted. (d) one net.corrupt_frame at the
# parent's transport.recv (its crc trailer catches it, the link is torn down): a corrupt
# frame counted, every id once. Each tcp run checks the pool really ran on tcp (its
# transport, the connects counted, no transport_link_down degradation in (a)).

TCP_WORKERS = 4
TCP_BATCH = 128
# the warm-up covers the children's first items: pagedec="auto" reaches a running
# child with its next item, so each child's first one may still be classic
TCP_TAB_WARMUP, TCP_TAB_MEASURED = 10, 20
TCP_RESET_NTH = 8     # about the middle of the epoch's 16 item dispatches
TCP_CORRUPT_NTH = 12  # an inbound frame early in the epoch
TCP_HEARTBEAT_S = 0.5  # round trips observed within an epoch; 1.5 s of silence is half-open


def net_values():
    """This process's ``ptpu_net_*`` counts and its transport_link_down degradations."""
    from petastorm_tpu_torch.obs.log import degradation_counts
    from petastorm_tpu_torch.transport import net_metrics

    m = net_metrics()
    return {"connects": m.connects.value, "reconnects": m.reconnects.value,
            "frames_corrupt": m.frames_corrupt.value, "rtt_count": m.rtt.count,
            "link_down": degradation_counts().get("transport_link_down", 0)}


def tcp_jpeg_run(url, images, transport, label, smi, plan=None, device="cuda"):
    """One epoch of the main path on TCP_WORKERS children over ``transport``, ``plan``
    armed in this process (not in the children) while it reads; every id once and its
    pixels ``images``' (phase 7's, by id)."""
    import torch

    from petastorm_tpu_torch import chaos, make_batch_reader
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image
    from petastorm_tpu_torch.transport import net_metrics

    net0 = net_values()
    reader = make_batch_reader(url, decode_on_device=True, reader_pool_type="process",
                               workers_count=TCP_WORKERS, transport=transport,
                               shuffle_row_groups=False, results_timeout_s=120,
                               recovery={"link_heartbeat_s": TCP_HEARTBEAT_S})
    wire = reader._executor._transport_name
    counts = torch.zeros(ROWS, dtype=torch.int32, device=device)
    bad = torch.zeros((), dtype=torch.int64, device=device)
    plain_ok, batches = False, 0
    _jpeg_launch_counters(zero=True)
    t0 = time.perf_counter()
    with chaos.armed(plan, propagate=False) if plan is not None \
            else contextlib.nullcontext():
        with DataLoader(reader, TCP_BATCH, device=device, last_batch="partial",
                        device_transform=_jpeg_transform()) as loader:
            for batch in loader:
                ids, u8 = batch["id"], batch["image_u8"]
                counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
                bad.add_((images.index_select(0, ids) != u8).sum())
                if batches == 0:
                    plain_ok = torch.equal(batch["image"], image._normalize_plain(
                        u8, MEAN, STD, torch.bfloat16))
                batches += 1
            _sync(device)
            quarantined = list(loader.quarantine_report or ())
        injections = plan.injections() if plan is not None else []
    wall = time.perf_counter() - t0
    launches = _jpeg_launch_counters()
    net1 = net_values()
    net = {k: net1[k] - net0[k] for k in net0}
    rtt_p50 = net_metrics().rtt.percentile(0.5)
    rows_per_s = ROWS / wall
    log("tcp pool (%s): %s wire, %d batches of %d, %.1f rows/s (%.3f s); launches %s; "
        "net counts %s; heartbeat round trip p50 %.6f s (this process, all links so far); "
        "injections %s; quarantined %d; %d uint8 values apart from phase 7's images; %s"
        % (label, wire, batches, TCP_BATCH, rows_per_s, wall, json.dumps(launches),
           json.dumps(net), rtt_p50, [(i["site"], i["action"], i["key"])
                                      for i in injections], len(quarantined), bad.item(),
           smi))
    check(wire == (transport or "pipe"), "%s: the pool ran on %r" % (label, wire))
    check(bool((counts == 1).all()), "%s: ids delivered %s times, not once each"
          % (label, sorted(set(counts.tolist()))))
    check(bad.item() == 0, "%s: images differ from phase 7's of the same ids" % label)
    check(plain_ok, "%s: K2 differs from its plain version" % label)
    check(launches["stage2_planes"] == launches["stage2_rgb"] == launches["K2"]
          == batches == -(-ROWS // TCP_BATCH),
          "%s: launches %s for %d batches" % (label, launches, batches))
    check(not quarantined, "%s: quarantined %s" % (label, quarantined))
    if transport == "tcp":
        check(net["connects"] >= TCP_WORKERS, "%s: %d links connected, fewer than %d "
              "children" % (label, net["connects"], TCP_WORKERS))
    return {"rows_per_s": rows_per_s, "launches": launches, "batches": batches,
            "net": net, "rtt_p50_s": rtt_p50, "injections": len(injections)}


def phase_tcp_main_path(url, images, smi, device="cuda"):
    """(a), (c) and (d) (comment above)."""
    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule

    out = {"pipe": tcp_jpeg_run(url, images, "pipe", "(a) pipe", smi, device=device)}
    out["tcp"] = tcp_jpeg_run(url, images, "tcp", "(a) tcp", smi, device=device)
    check(out["tcp"]["net"]["link_down"] == 0 and out["tcp"]["net"]["reconnects"] == 0,
          "(a): the clean tcp run saw a link death: %s" % out["tcp"]["net"])
    log("tcp pool (a): tcp %.1f rows/s against the pipe's %.1f (%.4fx; a record, no claim)"
        % (out["tcp"]["rows_per_s"], out["pipe"]["rows_per_s"],
           out["tcp"]["rows_per_s"] / out["pipe"]["rows_per_s"]))
    plan = FaultPlan([FaultRule("transport.send", "net.reset", nth=TCP_RESET_NTH,
                                times=1)], seed=CHAOS_SEED)
    out["reset"] = tcp_jpeg_run(url, images, "tcp", "(c) net.reset", smi, plan=plan,
                                device=device)
    check(out["reset"]["injections"] == 1 and out["reset"]["net"]["reconnects"] >= 1,
          "(c): %d injections, %d reconnects" % (out["reset"]["injections"],
                                                  out["reset"]["net"]["reconnects"]))
    plan = FaultPlan([FaultRule("transport.recv", "net.corrupt_frame",
                                nth=TCP_CORRUPT_NTH, times=1)], seed=CHAOS_SEED)
    out["corrupt"] = tcp_jpeg_run(url, images, "tcp", "(d) net.corrupt_frame", smi,
                                  plan=plan, device=device)
    check(out["corrupt"]["net"]["frames_corrupt"] >= 1,
          "(d): no corrupt frame counted: %s" % out["corrupt"]["net"])
    check(sum(out[k]["net"]["rtt_count"] for k in ("tcp", "reset", "corrupt")) > 0,
          "no heartbeat round trip observed on the tcp runs")
    return out


def phase_tcp_tabular(root, arrays, predicted, smi, device="cuda"):
    """(b) (comment above)."""
    out = {}
    for transport in ("pipe", "tcp"):
        net0 = net_values()
        launches, res = phase_tabular_path(
            root, arrays, predicted, device=device, warmup=TCP_TAB_WARMUP,
            measured=TCP_TAB_MEASURED, pool="process", wire="arrow", transport=transport,
            probe=lambda _loader, reader: reader._executor._transport_name)
        net = {k: v - net0[k] for k, v in net_values().items()}
        log("tcp pool (b) %s: pass-through %.1f rows/s; launches %s; net counts %s; %s"
            % (transport, res["rows_per_s"], json.dumps(launches), json.dumps(net), smi))
        check(res["probe"] == transport, "(b): the pool ran on %r" % res["probe"])
        if transport == "tcp":
            check(net["connects"] >= min(8, max(1, (os.cpu_count() or 2) - 1))
                  and net["link_down"] == 0, "(b): net counts %s" % net)
        out[transport] = res
    return out


# -- phase 20: the data service ----------------------------------------------------------
#
# One DataService (ServiceOptions(arena=True), the host arena made first) over phase 4's
# files 0 and 1 (2,048 rows, 8 row groups: the plan items of parquet_job), with a decode
# callable that reads a row group and decodes its JPEG cells on the host into uint8
# (n, 224, 224, 3) BGR (cv2 where the machine has it, else the port's CPU path). The
# callable run in this process gives the pixels every trainer must receive, by id (held
# within phase 4's cv2 tolerance of phase 7's images). Two DecodeWorkers run in
# processes of their own (this script started with ``--svc-worker``, which resolves the
# pickled callable from its own ``__main__``). (a) decode once, serve many: two trainers
# attach before the workers start, each a ServiceReader into DataLoader(128,
# device='cuda', prefetch=0) with K2 as its device transform (prefetch=0: the transform
# runs on the consumer thread, which takes the two loaders' batches in turns, so K2's
# launch counter sees one caller at a time): each trainer gets every row once with the
# callable's pixels, one decode an item, no lease leaked; decode seconds a delivered row
# and rows/s a trainer printed. (b) a trainer detaches
# after SVC_DETACH_AFTER items with state_dict(); a fresh ServiceReader restored from it
# receives exactly the rest. (c) a seeded net.reset on one worker's link (the service's
# transport.send on that session): every row once, nothing quarantined, a reconnect.
# (d) a co-hosted trainer with arena=True after the items were decoded: every item
# arrives as an arena key and is mapped from the arena, with the same pixels.

SVC_FILES = 2
SVC_WORKERS = 2
SVC_BATCH = 128
SVC_DETACH_AFTER = 3
SVC_ARENA_BYTES = 1 << 30
SVC_JOB = "jpeg"
SVC_DEADLINE_S = 120
SVC_WARM_SEED = 20


def host_jpeg_decode(blobs):
    """JPEG blobs to uint8 (n, h, w, 3) BGR on the host: cv2 (libjpeg) where the machine
    has it, else the port's CPU path (stage 1, then the plain stage 2)."""
    import numpy as np

    try:
        import cv2
    except ImportError:
        from petastorm_tpu_torch.ops import jpeg

        return jpeg.decode_jpeg_batch(jpeg.entropy_decode_jpeg_batch(blobs), device="cpu",
                                      bgr=True).numpy()
    return np.stack([cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
                     for b in blobs])


class JpegRowGroupDecode:
    """Phase 20's decode callable: the ``(path, row_group)`` item's rows, the JPEG cells
    decoded on the host (:func:`host_jpeg_decode`), BGR as the loader delivers them."""

    def __call__(self, item):
        import pyarrow.parquet as pq

        path, rg = item
        table = pq.ParquetFile(path).read_row_group(rg, columns=["id", "image", "label"])
        blobs = table.column("image").to_pylist()
        return {"id": table.column("id").to_numpy(), "image": host_jpeg_decode(blobs),
                "label": table.column("label").to_numpy()}, len(blobs)


def svc_schema():
    import numpy as np

    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    return Unischema("ServiceImages", [
        UnischemaField("id", np.int64, (), None, False),
        UnischemaField("image", np.uint8, IMG, None, False),
        UnischemaField("label", np.int32, (), None, False)])


def svc_worker_main(address, token, name):
    """A decode worker process (``chip_smoke.py --svc-worker <address> <token> <name>``):
    imports the callable's reader and warms the host decode on one image of its own
    before it dials (without cv2, torch's first host ops take seconds), so no lease
    times the warm-up, then serves leases until the service stops it."""
    import pyarrow as pa
    import pyarrow.parquet  # noqa: F401  (the callable's reader, imported here)

    from petastorm_tpu_torch.service import DecodeWorker

    pa.table({"id": [0]}).column("id").to_numpy()  # pyarrow's lazy pandas import
    host_jpeg_decode([BaselineJpegEncoder(QUALITY).encode(
        next(make_images(1, seed=SVC_WARM_SEED)))])
    DecodeWorker(address, token, name=name).run()


def _svc_spawn_worker(svc, name):
    from petastorm_tpu_torch.transport.tcp import parse_address

    address = svc.worker_address()
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ROOT + (
        os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else "")}
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--svc-worker",
                             address, svc.token, name], env=env, cwd=ROOT)
    return proc, parse_address(address)[2]


def _svc_reader(svc, trainer, arena=False):
    from petastorm_tpu_torch.reader import make_service_reader

    return make_service_reader(svc.trainer_address(), svc.token, SVC_JOB, trainer=trainer,
                               arena=arena)


def _svc_host_rows(reader, images, limit=None, device="cuda"):
    """Items of a ServiceReader taken on the host (``limit`` of them, or all): their ids,
    and the count of uint8 values apart from ``images`` (by id) of the same ids."""
    import numpy as np
    import torch

    ids, bad = [], 0
    deadline = time.monotonic() + SVC_DEADLINE_S
    for n, row in enumerate(reader):
        got = torch.from_numpy(np.array(row.image)).to(device)
        idx = torch.from_numpy(np.array(row.id)).to(device)
        bad += int((images.index_select(0, idx) != got).sum())
        ids.extend(int(i) for i in row.id)
        check(time.monotonic() < deadline, "phase 20: a trainer's read ran past %d s"
              % SVC_DEADLINE_S)
        if limit is not None and n + 1 == limit:
            break
    return ids, bad


def phase_service(url, images, smi, device="cuda"):
    """(a)-(d) (comment above)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import pyarrow.parquet as pq
    import torch

    from petastorm_tpu_torch.chaos import FaultPlan, FaultRule, armed
    from petastorm_tpu_torch.io import arena as arena_mod
    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.ops import image
    from petastorm_tpu_torch.service import DataService, JobSpec, ServiceOptions, parquet_job
    from petastorm_tpu_torch.service.protocol import svc_metrics

    root = url[len("file://"):]
    files = sorted(os.path.join(root, f) for f in os.listdir(root)
                   if f.endswith(".parquet") and not f.startswith("_"))[:SVC_FILES]
    base = parquet_job(SVC_JOB, files)
    job = JobSpec(SVC_JOB, base.items, JpegRowGroupDecode(), svc_schema())
    want = sorted(int(i) for f in files
                  for i in pq.read_table(f, columns=["id"]).column("id").to_numpy())
    # the callable run here, item by item on threads (cv2 releases the GIL): the pixels
    # the trainers must receive, by id; against phase 7's images as phase 4 holds cv2
    ref = torch.zeros_like(images)
    with ThreadPoolExecutor(len(job.items)) as pool:
        for cols, _rows in pool.map(JpegRowGroupDecode(), job.items):
            ref.index_copy_(0, torch.from_numpy(np.array(cols["id"])).to(device),
                            torch.from_numpy(cols["image"]).to(device))
    rows_t = torch.tensor(want, device=device)
    diff = (ref.index_select(0, rows_t).to(torch.int32)
            - images.index_select(0, rows_t).to(torch.int32)).abs()
    log("service: the decode callable run here against phase 7's images: max %d, mean "
        "%.4f" % (diff.max().item(), diff.float().mean().item()))
    check(diff.max().item() <= 4 and diff.float().mean().item() < 1.0,
          "phase 20: the decode callable's pixels too far from phase 7's images")
    del diff
    arena = arena_mod.host_arena(SVC_ARENA_BYTES)
    check(arena is not None, "phase 20: the host arena could not be made")
    m = svc_metrics()
    m0 = {k: v.value for k, v in m.items()}
    procs = []
    out = {}
    t_phase = time.perf_counter()
    svc = DataService(options=ServiceOptions(arena=True))
    try:
        svc.add_job(job)
        # (a): both trainers attach before the fleet starts, so every decode fans out
        readers = [_svc_reader(svc, "trainer-%d" % i) for i in range(2)]
        sessions = []
        for i in range(SVC_WORKERS):
            proc, session = _svc_spawn_worker(svc, "decode-%d" % i)
            procs.append(proc)
            sessions.append(session)
        _jpeg_launch_counters(zero=True)
        dec0 = m["decode_seconds"].value
        t0 = time.perf_counter()
        state = [{"ids": [], "bad": torch.zeros((), dtype=torch.int64, device=device),
                  "batches": 0, "plain_ok": None, "done_s": None, "first_s": None,
                  "first_rows": 0} for _ in readers]
        with DataLoader(readers[0], SVC_BATCH, device=device, prefetch=0,
                        last_batch="partial", device_transform=_jpeg_transform()) as l0, \
                DataLoader(readers[1], SVC_BATCH, device=device, prefetch=0,
                           last_batch="partial", device_transform=_jpeg_transform()) as l1:
            its = [iter(l0), iter(l1)]
            live = [True, True]
            while any(live):
                for t, it in enumerate(its):
                    if not live[t]:
                        continue
                    batch = next(it, None)
                    st = state[t]
                    if batch is None:
                        live[t] = False
                        st["done_s"] = time.perf_counter() - t0
                        continue
                    ids, u8 = batch["id"], batch["image_u8"]
                    if st["first_s"] is None:
                        # the clock of the trainer's rate starts at its first batch: the
                        # workers' start-up is not the service's rate
                        st["first_s"], st["first_rows"] = time.perf_counter() - t0, len(ids)
                    st["ids"].append(ids)
                    st["bad"].add_((ref.index_select(0, ids) != u8).sum())
                    if st["plain_ok"] is None:
                        st["plain_ok"] = torch.equal(batch["image"], image._normalize_plain(
                            u8, MEAN, STD, torch.bfloat16))
                    st["batches"] += 1
                check(time.perf_counter() - t0 < SVC_DEADLINE_S,
                      "phase 20 (a): the trainers ran past %d s" % SVC_DEADLINE_S)
            _sync(device)
        launches = _jpeg_launch_counters()
        decode_s = m["decode_seconds"].value - dec0
        outstanding = svc.outstanding_leases()
        for st in state:
            st["ids"] = torch.cat(st["ids"]).tolist()
        batches = sum(st["batches"] for st in state)
        rows_per_s = [(len(st["ids"]) - st["first_rows"]) / (st["done_s"] - st["first_s"])
                      for st in state]
        delta = {k: m[k].value - m0[k] for k in ("decodes", "served_items",
                                                 "fanout_serves", "lease_redispatch")}
        log("service (a): two trainers, %d items of %d rows: %s batches, rows/s a trainer "
            "after its first batch %s (first batch at %s s, the workers' start-up "
            "inside); decode worker-seconds %.4f (%.6f a delivered row, %.6f a row a "
            "trainer); counts %s; K2 launches %s; outstanding leases %d; %s" % (
                len(job.items), len(want), [st["batches"] for st in state],
                [round(r, 1) for r in rows_per_s],
                [round(st["first_s"], 3) for st in state], decode_s,
                decode_s / (2 * len(want)), decode_s / len(want), json.dumps(delta),
                json.dumps(launches), outstanding, smi))
        for t, st in enumerate(state):
            check(sorted(st["ids"]) == want, "(a): trainer %d's ids are not the job's "
                  "rows once each" % t)
            check(st["bad"].item() == 0, "(a): trainer %d's images differ from the "
                  "callable's run here" % t)
            check(st["plain_ok"], "(a): K2 differs from its plain version (trainer %d)" % t)
        check(launches["K2"] == batches > 0 and launches["stage2_planes"] == 0,
              "(a): launches %s for %d batches" % (launches, batches))
        check(delta["decodes"] == len(job.items) and delta["fanout_serves"] == len(
            job.items), "(a): not one decode an item, fanned out: %s" % delta)
        check(outstanding == 0, "(a): %d leases outstanding" % outstanding)
        out["a"] = {"launches": launches, "batches": batches, "rows_per_s": rows_per_s,
                    "decode_s_per_row": decode_s / len(want), "counts": delta}
        # (b): detach mid-epoch with the watermark, resume in a fresh reader
        r = _svc_reader(svc, "trainer-b")
        first_ids, bad1 = _svc_host_rows(r, ref, limit=SVC_DETACH_AFTER,
                                         device=device)
        saved = r.state_dict()
        r.stop()
        r = _svc_reader(svc, "trainer-b")
        r.load_state_dict(saved)
        rest_ids, bad2 = _svc_host_rows(r, ref, device=device)
        r.stop()
        log("service (b): %d rows before the detach, %d after the resume" % (
            len(first_ids), len(rest_ids)))
        check(sorted(first_ids + rest_ids) == want and not set(first_ids) & set(rest_ids),
              "(b): the resumed trainer's rows are not exactly the rest")
        check(bad1 == bad2 == 0, "(b): images differ from the callable's")
        out["b"] = {"before": len(first_ids), "after": len(rest_ids)}
        # (c): a seeded net.reset on each worker's link, at its first frame (the phase
        # opens 8 sessions, numbered from 1, so a key names one link); a worker that
        # gets no lease in (c) may escape it, so one injection at least
        net0 = net_values()
        q0 = m["quarantined"].value
        plan = FaultPlan([FaultRule("transport.send", "net.reset", nth=1, times=1,
                                    item_key="session=%d" % s) for s in sessions],
                         seed=CHAOS_SEED)
        with armed(plan, propagate=False):
            r = _svc_reader(svc, "trainer-c")
            ids_c, bad_c = _svc_host_rows(r, ref, device=device)
            quarantined = dict(r.quarantined)
            r.stop()
            injections = plan.injections()
        net = {k: v - net0[k] for k, v in net_values().items()}
        log("service (c): injections %s; net counts %s; quarantined %s" % (
            [(i["site"], i["action"], i["key"]) for i in injections], json.dumps(net),
            quarantined))
        check(sorted(ids_c) == want and bad_c == 0, "(c): rows not once each with the "
              "callable's images")
        check(len(injections) >= 1 and net["reconnects"] >= len(injections),
              "(c): %d injections, %d reconnects" % (len(injections), net["reconnects"]))
        check(not quarantined and m["quarantined"].value == q0, "(c): quarantined %s"
              % quarantined)
        out["c"] = {"net": net}
        # (d): a co-hosted trainer through the arena
        hits0 = arena_mod.arena_counters()["hits"]
        r = _svc_reader(svc, "trainer-d", arena=True)
        ids_d, bad_d = _svc_host_rows(r, ref, device=device)
        mapped = len(r._arena_leases)
        r.stop()
        hits = arena_mod.arena_counters()["hits"] - hits0
        log("service (d): %d items mapped from the arena (%d arena hits)" % (mapped, hits))
        check(sorted(ids_d) == want and bad_d == 0, "(d): rows not once each with the "
              "callable's images")
        check(mapped == len(job.items) and hits >= mapped, "(d): %d items mapped, %d hits"
              % (mapped, hits))
        out["d"] = {"mapped": mapped}
    finally:
        svc.stop()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        arena_mod.close_process_arena()
    del ref
    leaked = m["lease_leaked"].value - m0["lease_leaked"]
    codes = [p.returncode for p in procs]
    log("service: phase 20's parts in %.1f s; leases leaked %d; worker exit codes %s"
        % (time.perf_counter() - t_phase, leaked, codes))
    check(leaked == 0, "phase 20: %d leases leaked" % leaked)
    check(codes == [0] * SVC_WORKERS, "phase 20: worker exit codes %s" % codes)
    return out


# -- phase 21: the model zoo and the model-parallel toolkit ------------------------------
#
# The consumer of the main path. (a) ResNet-50 (1,000 classes, bfloat16 compute with
# float32 parameters, channels_last; MODEL_SEED) trained with SGD, Nesterov momentum 0.9
# at lr 0.1 (examples/imagenet/train_imagenet_jax.py's optimizer), fed by the main path:
# phase 4's store through make_batch_reader(decode_on_device=True) and DataLoader(256)
# with K2 (normalize_images to bfloat16) as the device transform. After MODEL_WARMUP
# steps on a resident batch (cuDNN picks its algorithms), the step alone is timed on that
# batch with CUDA events; then three fed epochs of 16 steps each: the first a warm-up
# (the reader's pool starts), the second timed (rows/s fed, device_queue_wait_s, peak
# memory, the loss at each step), the third under torch.profiler (the device's busy
# share in the fed window); stage2_planes, stage2_rgb and K2 once a fed batch. Then MODEL_FIXED_STEPS steps on one fixed fed batch: the loss
# falls. (b) (a)'s trained weights in a float32 ResNet-50 on the card and on the CPU (one
# state dict), eval mode, 8 of phase 7's images normalised in float32, with TF32 off
# (cuDNN convolutions use it by default): the card's logits within 1e-3 of the largest.
# (c) ViT-B/16 (bfloat16) trained VIT_STEPS steps on the same loader; ms a step. (d) the
# SPMD MoE transformer step as a world of one over NCCL (all five mesh axes of size 1;
# the default TransformerConfig with its two layers in one stage, as pp = 1 asks, and
# one microbatch): the first loss within 2e-4 of reference_loss on the card, the loss
# falling over 5 steps at lr 0.5,
# and ring and Ulysses attention at axis size 1 equal to reference_attention.

MODEL_SEED = 21
MODEL_WARMUP = 3
MODEL_TIMED = 5
MODEL_FIXED_STEPS = 10
VIT_STEPS = 8
MODEL_CARD_CPU_ROWS = 8


def _sgd_step(model, lr=0.1):
    """One SGD step (Nesterov momentum 0.9) of cross-entropy on ``model``: ``step(x,
    labels) -> loss`` (a device scalar, not read back)."""
    import torch
    import torch.nn.functional as F

    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9, nesterov=True)

    def step(images, labels):
        loss = F.cross_entropy(model(images), labels.long())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def _model_reader(url, epochs):
    from petastorm_tpu_torch import make_batch_reader

    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    return make_batch_reader(url, decode_on_device=True, workers_count=workers,
                             shuffle_row_groups=True, seed=MODEL_SEED, num_epochs=epochs,
                             schema_fields=["id", "image", "label"])


def _k2_only():
    from petastorm_tpu_torch.ops import image

    def transform(batch):
        return {**batch, "image": image.normalize_images(batch["image"], MEAN, STD)}

    return transform


def phase_model_resnet(url, smi):
    """(a) (comment above)."""
    import math

    import torch

    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.models import ResNet50

    torch.manual_seed(MODEL_SEED)
    model = ResNet50(num_classes=1000)
    check(next(model.parameters()).device.type == "cuda"
          and model.compute_dtype == torch.bfloat16, "(a): ResNet50() is not on the card "
          "in bfloat16")
    step = _sgd_step(model)
    gen = torch.Generator(device="cuda").manual_seed(MODEL_SEED)
    x = torch.randn((BATCH,) + IMG, generator=gen, device="cuda").to(torch.bfloat16)
    y = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    t0 = time.perf_counter()
    for _ in range(MODEL_WARMUP):
        step(x, y)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # timing()'s enqueue figure counts the host blocked on a launch queue filled behind
    # its spin (a step is ~3,000 launches): the dispatch is timed apart, one step after
    # a synchronise, to its return
    step_ms = timing(lambda: step(x, y), iters=MODEL_TIMED, warmup=1)[0]
    dispatch = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(x, y)
        dispatch.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    dispatch_ms = sorted(dispatch)[1] * 1e3
    out = {"step_ms": step_ms, "dispatch_ms": dispatch_ms, "warmup_s": warm_s}

    _jpeg_launch_counters(zero=True)
    losses, batches, fixed = [], 0, None
    per_epoch = ROWS // BATCH
    with DataLoader(_model_reader(url, 3), BATCH, device_transform=_k2_only(),
                    prefetch=3) as loader:
        it = iter(loader)

        def fed_step():
            nonlocal batches, fixed
            b = next(it)
            losses.append(step(b["image"], b["label"]))
            batches += 1
            if fixed is None:
                fixed = (b["image"].clone(), b["label"].clone())

        for _ in range(per_epoch):
            fed_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loader.stats.reset()
        t0 = time.perf_counter()
        for _ in range(per_epoch):
            fed_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        queue_wait_s = loader.stats.device_queue_wait_s
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["busy_share"] = profiled_busy_share(fed_step, per_epoch)
    launches = _jpeg_launch_counters()
    out["warmup_losses"] = [float(v) for v in losses[:per_epoch]]
    out["losses"] = [float(v) for v in losses[per_epoch:]]
    out.update(rows_per_s=per_epoch * BATCH / wall, wall_s=wall, batches=batches,
               launches=launches, device_queue_wait_s=queue_wait_s)
    fixed_losses = [float(step(*fixed)) for _ in range(MODEL_FIXED_STEPS)]
    out["fixed_losses"] = fixed_losses
    out["consumer_rows_per_s"] = BATCH / (step_ms / 1e3)
    log("model (a): ResNet-50 bf16 channels_last, batch %d: %.4f ms a step alone on a "
        "resident batch (CUDA events; the host's dispatch of a step %.4f ms, median of 3; "
        "warm-up %.1f s) = "
        "%.1f rows/s the consumer takes; fed by the main path %.1f rows/s over the %d "
        "steps of the second epoch (%.3f s), device_queue_wait_s %.4f, device busy share "
        "%s in the third, peak memory %.2f GB; losses (all %d fed steps) %s; launches "
        "%s for %d batches; %s" % (
            BATCH, step_ms, dispatch_ms, warm_s, out["consumer_rows_per_s"],
            out["rows_per_s"], per_epoch, wall, out["device_queue_wait_s"],
            "not measured" if out["busy_share"] is None else "%.4f" % out["busy_share"],
            out["peak_gb"], batches,
            [round(v, 4) for v in out["warmup_losses"] + out["losses"]],
            json.dumps(launches), batches, smi))
    log("model (a): %d steps on one fixed fed batch: losses %s; %s"
        % (MODEL_FIXED_STEPS, [round(v, 4) for v in fixed_losses], smi))
    check(all(math.isfinite(v) for v in out["warmup_losses"] + out["losses"]
              + fixed_losses), "(a): a loss is not finite")
    check(fixed_losses[-1] < fixed_losses[0], "(a): the loss on one fixed batch did not "
          "fall over %d steps: %s" % (MODEL_FIXED_STEPS, fixed_losses))
    check(batches == 3 * per_epoch, "(a): %d batches fed, %d expected"
          % (batches, 3 * per_epoch))
    check(launches["stage2_planes"] == launches["stage2_rgb"] == launches["K2"] == batches,
          "(a): launches %s for %d batches" % (launches, batches))
    return model, out


def phase_model_card_vs_cpu(model, images, smi):
    """(b) (comment above); ``model``: (a)'s trained ResNet-50; ``images``: phase 7's
    uint8 images on the card."""
    import torch

    from petastorm_tpu_torch.models import ResNet50
    from petastorm_tpu_torch.ops import image

    state = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    x = image.normalize_images(images[:MODEL_CARD_CPU_ROWS], MEAN, STD,
                               out_dtype=torch.float32)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = ResNet50(num_classes=1000, dtype=torch.float32)
        card.load_state_dict(state)
        with torch.no_grad():
            on_card = card.eval()(x).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = ResNet50(num_classes=1000, dtype=torch.float32, device="cpu")
    cpu.load_state_dict(state)
    with torch.no_grad():
        on_cpu = cpu.eval()(x.cpu())
    err = float((on_card - on_cpu).abs().max())
    scale = float(on_cpu.abs().max())
    log("model (b): ResNet-50 float32 eval on %d images, card against CPU (TF32 off): "
        "max abs error %.3e against max |logit| %.4f (%.3e of it); %s"
        % (MODEL_CARD_CPU_ROWS, err, scale, err / scale, smi))
    check(bool(torch.isfinite(on_card).all()) and on_card.shape == (MODEL_CARD_CPU_ROWS,
                                                                   1000),
          "(b): card logits %s not finite or mis-shaped" % (tuple(on_card.shape),))
    check(err <= 1e-3 * scale, "(b): card logits %.3e apart from the CPU's (bar %.3e)"
          % (err, 1e-3 * scale))
    return {"max_abs_err": err, "max_logit": scale}


def phase_model_vit(url, smi):
    """(c) (comment above)."""
    import math

    import torch

    from petastorm_tpu_torch.loader import DataLoader
    from petastorm_tpu_torch.models import ViT_B16

    torch.manual_seed(MODEL_SEED)
    model = ViT_B16(num_classes=1000)
    step = _sgd_step(model, lr=0.01)
    _jpeg_launch_counters(zero=True)
    losses, times = [], []
    with DataLoader(_model_reader(url, 1), BATCH, device_transform=_k2_only(),
                    prefetch=3) as loader:
        for batch in loader:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(batch["image"], batch["label"])))
            times.append(time.perf_counter() - t0)  # float() waits for the step
            if len(losses) == VIT_STEPS:
                break
    launches = _jpeg_launch_counters()
    ms = sorted(times[1:])[len(times[1:]) // 2] * 1e3  # the first step builds the plan
    log("model (c): ViT-B/16 bf16, batch %d, %d steps on the main path: %.4f ms a step "
        "(median wall of steps 2-%d, synchronised; the first %.4f ms), %.1f rows/s the "
        "consumer takes; losses %s; launches %s; %s" % (
            BATCH, len(losses), ms, VIT_STEPS, times[0] * 1e3, BATCH / (ms / 1e3),
            [round(v, 4) for v in losses], json.dumps(launches), smi))
    check(len(losses) == VIT_STEPS and all(math.isfinite(v) for v in losses),
          "(c): losses %s" % losses)
    check(launches["stage2_planes"] == launches["stage2_rgb"] == launches["K2"]
          >= VIT_STEPS, "(c): launches %s for %d steps" % (launches, VIT_STEPS))
    return {"step_ms": ms, "losses": losses, "launches": launches, "batches": VIT_STEPS}


def phase_model_transformer(smi):
    """(d) (comment above)."""
    import dataclasses
    import datetime
    import math

    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch.models import transformer as tx
    from petastorm_tpu_torch.parallel import attention

    cfg = dataclasses.replace(tx.TransformerConfig(), n_stages=1, layers_per_stage=2)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d" % _free_port(),
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = tx.model_mesh()
        params = tx.init_params(cfg, MODEL_SEED)
        gen = torch.Generator(device="cuda").manual_seed(MODEL_SEED)
        tokens = torch.randint(0, cfg.vocab, (8, cfg.max_seq), generator=gen, device="cuda")
        targets = torch.randint(0, cfg.vocab, (8, cfg.max_seq), generator=gen, device="cuda")
        ref = float(tx.reference_loss(cfg, params, tokens, targets))
        placed = tx.distribute_params(params, tx.param_shardings(cfg, mesh))
        ds = tx.data_sharding(mesh)
        tok, tgt = tx.distribute_params(tokens, ds), tx.distribute_params(targets, ds)
        # one microbatch: the capacity of each expert is then reference_loss's (the
        # default capacity_factor drops tokens, per microbatch in the step)
        step = tx.make_train_step(cfg, mesh, n_micro=1, learning_rate=0.5)
        losses = []
        for _ in range(5):
            placed, loss = step(placed, tok, tgt)
            losses.append(float(loss))
        q, k, v = (torch.randn(2, cfg.max_seq, cfg.n_heads, cfg.head_dim, generator=gen,
                               device="cuda") for _ in range(3))
        errs = {}
        for causal in (False, True):
            dense = attention.reference_attention(q, k, v, causal=causal)
            for name, fn in (("ring", attention.ring_attention),
                             ("ulysses", attention.ulysses_attention)):
                errs["%s_causal_%d" % (name, causal)] = float(
                    (fn(q, k, v, mesh, "sp", causal) - dense).abs().max())
        backend = dist.get_backend()
        device = placed["embed"].to_local().device
    finally:
        dist.destroy_process_group()
    log("model (d): the MoE transformer step as a world of one over %s on %s: losses %s, "
        "reference_loss %.6f (first loss %.3e apart); attention at axis size 1 against "
        "reference_attention: %s; %s" % (
            backend, device, [round(v, 6) for v in losses], ref, abs(losses[0] - ref),
            json.dumps({k: "%.3e" % v for k, v in errs.items()}), smi))
    check(device.type == "cuda", "(d): params on %s" % device)
    check(all(math.isfinite(v) for v in losses), "(d): losses %s" % losses)
    check(abs(losses[0] - ref) < 2e-4, "(d): first loss %.6f, reference %.6f"
          % (losses[0], ref))
    check(losses[-1] < losses[0], "(d): the loss did not fall: %s" % losses)
    check(max(errs.values()) <= 2e-5, "(d): attention errors %s" % errs)
    return {"losses": losses, "reference_loss": ref, "attention_errs": errs}


def phase_models(url, images, smi):
    """Phase 21 (a)-(d), with cuDNN's algorithm search on (restored after)."""
    import torch

    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        model, resnet = phase_model_resnet(url, smi)
        card_cpu = phase_model_card_vs_cpu(model, images, smi)
        del model
        vit = phase_model_vit(url, smi)
    finally:
        torch.backends.cudnn.benchmark = bench
    torch.cuda.empty_cache()
    return {"a": resnet, "b": card_cpu, "c": vit, "d": phase_model_transformer(smi)}


# -- phase 22: the examples, the tools and reference compatibility --------------------
#
# (a) examples/torch/imagenet/train_imagenet_torch.py's main() on phase 4's store:
# ResNet-50 (bfloat16) at 1,000 classes and 224x224, batch 256, EXAMPLE_STEPS steps,
# --augment (the flip only: the store is 224x224, and the JAX example skips the crop
# there too) and --trace to a temporary file. Every loss finite and EXAMPLE_STEPS
# train.step spans in the trace; stage2_planes and stage2_rgb launched once a batch the
# codec decoded on the card (counted around CompressedImageCodec.device_decode_batch:
# the loader decodes ahead of the steps), K2 never (the step divides by 255, as the JAX
# example's does). Printed: the script's img/s over its whole run and from its third
# step on.
# (b) The same script with --model vit_s16 --decode-resize 256 --augment on phase 6's
# mixed store, EXAMPLE_VIT_STEPS steps of 256: the crop to 224 applies; one
# stage2_planes and one stage2_rgb launch a layout group (counted around
# jpeg._batched_stage2), K2 never.
# (c) examples/torch/mnist/train_mnist_torch.py for one epoch, streamed and --in-memory:
# every loss finite, one step a batch of 128.
# (d) tools.copy_dataset copies phase 4's store, tools.generate_metadata rewrites the
# copy's metadata, and the main path reads the copy on the card: every id once, pixels
# per id phase 7's (bit for bit), labels the originals, the stage-2 kernels once a
# decoded batch. Then a store of phase 4's files (hard links) whose _common_metadata
# carries only the reference petastorm's pickled schema and row-group counts, built as
# tests/test_metadata.py builds one, read through make_reader on the card with the same
# checks.
# HDFS, Spark and TF are held on the CPU only (tests/test_torch_hdfs.py,
# test_torch_spark.py, test_torch_tf.py): the card's machine has no cluster, pyspark or
# tensorflow.

EXAMPLE_STEPS = 24
EXAMPLE_VIT_STEPS = 8


def _example(rel):
    """Import ``examples/torch/<rel>`` by path (its directory on ``sys.path`` for its
    sibling imports, as when it runs as a script)."""
    import importlib.util

    path = os.path.join(ROOT, "examples", "torch", rel)
    if os.path.dirname(path) not in sys.path:
        sys.path.insert(0, os.path.dirname(path))
    spec = importlib.util.spec_from_file_location(
        "example_" + os.path.basename(path)[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _all_launch_counters(zero=False):
    """Every kernel's launch counter (the JPEG path's, the standalone unpack and K1, the
    pass-through's), zeroed first with ``zero``."""
    from petastorm_tpu_torch.ops import jpeg

    if zero:
        jpeg.unpack_dequant_segments.launches = 0
        jpeg.idct_scaled_segments.launches = 0
    out = _jpeg_launch_counters(zero)
    out.update(_tab_launch_counters(zero))
    out.update(unpack=jpeg.unpack_dequant_segments.launches,
               K1=jpeg.idct_scaled_segments.launches)
    return out


@contextlib.contextmanager
def _counting_decodes():
    """``{"batches": ..., "groups": ...}``: the batches the image codec decoded on the
    device and the layout groups their stage 2 ran, counted while the block runs."""
    from petastorm_tpu_torch.codecs import CompressedImageCodec
    from petastorm_tpu_torch.ops import jpeg

    counts = {"batches": 0, "groups": 0}
    decode, stage2 = CompressedImageCodec.device_decode_batch, jpeg._batched_stage2

    def counted_decode(self, *args, **kwargs):
        counts["batches"] += 1
        return decode(self, *args, **kwargs)

    def counted_stage2(*args, **kwargs):
        counts["groups"] += 1
        return stage2(*args, **kwargs)

    CompressedImageCodec.device_decode_batch = counted_decode
    jpeg._batched_stage2 = counted_stage2
    try:
        yield counts
    finally:
        CompressedImageCodec.device_decode_batch = decode
        jpeg._batched_stage2 = stage2


def _example_workers():
    return max(1, min(8, (os.cpu_count() or 2) - 1))


def phase_example_imagenet(url, work, smi):
    """(a) (comment above)."""
    import math

    example = _example("imagenet/train_imagenet_torch.py")
    trace = os.path.join(work, "example_trace.json")
    argv = ["--dataset-url", url, "--batch-size", str(BATCH), "--steps", str(EXAMPLE_STEPS),
            "--num-classes", "1000", "--workers", str(_example_workers()), "--augment",
            "--trace", trace]
    _all_launch_counters(zero=True)
    t0 = time.perf_counter()
    with _counting_decodes() as decoded:
        res = example.main(argv)
    wall = time.perf_counter() - t0
    launches = _all_launch_counters()
    with open(trace) as f:
        spans = sum(e.get("name") == "train.step" for e in json.load(f)["traceEvents"])
    log("example (a): train_imagenet_torch.py %s: %d steps of %d, %.1f img/s over the "
        "script's run (%.3f s, reader start included; %.3f s to the end of step %d), %s "
        "img/s after it; %.1f s of wall time with the import and the trace; losses %s; "
        "%d train.step spans; launches %s for %d batches decoded; loader stats %s; %s" % (
            " ".join(argv[4:]), res["steps"], BATCH, res["img_per_s"], res["seconds"],
            res["warmup_s"], example.WARMUP_STEPS,
            "-" if res["steady_img_per_s"] is None else "%.1f" % res["steady_img_per_s"],
            wall, [round(v, 4) for v in res["losses"]], spans,
            json.dumps(launches), decoded["batches"], json.dumps(res["stats"]), smi))
    check(res["steps"] == EXAMPLE_STEPS and len(res["losses"]) == EXAMPLE_STEPS,
          "(a): %d steps, %d losses" % (res["steps"], len(res["losses"])))
    check(all(math.isfinite(v) for v in res["losses"]), "(a): losses %s" % res["losses"])
    check(spans == EXAMPLE_STEPS, "(a): %d train.step spans in the trace" % spans)
    check(launches["stage2_planes"] == launches["stage2_rgb"] == decoded["batches"]
          == decoded["groups"] >= EXAMPLE_STEPS,
          "(a): launches %s for %s" % (launches, decoded))
    check(launches["K2"] == launches["unpack"] == launches["K1"] == 0,
          "(a): launches %s" % launches)
    return {"launches": launches, "batches": decoded["batches"], "wall_s": wall,
            "img_per_s": res["img_per_s"], "steady_img_per_s": res["steady_img_per_s"],
            "warmup_s": res["warmup_s"], "losses": res["losses"]}


def phase_example_vit(mix_url, smi):
    """(b) (comment above)."""
    import math

    example = _example("imagenet/train_imagenet_torch.py")
    argv = ["--dataset-url", mix_url, "--batch-size", str(BATCH), "--steps",
            str(EXAMPLE_VIT_STEPS), "--num-classes", "1000", "--workers",
            str(_example_workers()), "--model", "vit_s16", "--decode-resize",
            str(MIX_RESIZE[0]), "--augment"]
    _all_launch_counters(zero=True)
    t0 = time.perf_counter()
    with _counting_decodes() as decoded:
        res = example.main(argv)
    wall = time.perf_counter() - t0
    launches = _all_launch_counters()
    log("example (b): train_imagenet_torch.py %s: %d steps, %.1f img/s over the run "
        "(%.3f s to the end of step %d), %s after it; %.1f s of wall time; losses %s; "
        "launches %s for %d batches of %d layout groups; %s" % (
            " ".join(argv[4:]), res["steps"], res["img_per_s"], res["warmup_s"],
            example.WARMUP_STEPS,
            "-" if res["steady_img_per_s"] is None else "%.1f" % res["steady_img_per_s"],
            wall, [round(v, 4) for v in res["losses"]],
            json.dumps(launches), decoded["batches"], decoded["groups"], smi))
    check(res["steps"] == EXAMPLE_VIT_STEPS and all(math.isfinite(v) for v in res["losses"]),
          "(b): %d steps, losses %s" % (res["steps"], res["losses"]))
    check(launches["stage2_planes"] == launches["stage2_rgb"] == decoded["groups"]
          > decoded["batches"] >= EXAMPLE_VIT_STEPS,
          "(b): launches %s for %s" % (launches, decoded))
    check(launches["K2"] == launches["unpack"] == launches["K1"] == 0,
          "(b): launches %s" % launches)
    return {"launches": launches, "batches": decoded["batches"], "groups": decoded["groups"],
            "wall_s": wall, "img_per_s": res["img_per_s"],
            "steady_img_per_s": res["steady_img_per_s"]}


def phase_example_mnist(work, smi):
    """(c) (comment above)."""
    import math

    example = _example("mnist/train_mnist_torch.py")
    out = {}
    for name, extra in (("streamed", []), ("in_memory", ["--in-memory"])):
        path = os.path.join(work, "mnist_" + name)
        os.makedirs(path)
        _all_launch_counters(zero=True)
        t0 = time.perf_counter()
        res = example.main(["--path", path, "--epochs", "1"] + extra)
        wall = time.perf_counter() - t0
        launches = _all_launch_counters()
        log("example (c) %s: train_mnist_torch.py %d steps in %.3f s (%.1f s of wall "
            "time), losses %s; launches %s; %s" % (
                name, res["steps"], res["seconds"], wall,
                [round(v, 4) for v in res["losses"]], json.dumps(launches), smi))
        check(res["steps"] == 2048 // 128 and all(math.isfinite(v) for v in res["losses"]),
              "(c) %s: %d steps, losses %s" % (name, res["steps"], res["losses"]))
        out[name] = {"launches": launches, "steps": res["steps"], "seconds": res["seconds"]}
    return out


def _example_pixels_run(reader, images, label, smi):
    """Every row of ``reader`` (phase 4's rows) through the port's DataLoader on the
    card: each id once, pixels per id ``images``' (phase 7's), labels ``id % 1000``,
    the stage-2 kernels once a decoded batch, K2 never."""
    import torch

    from petastorm_tpu_torch.loader import DataLoader

    counts = torch.zeros(ROWS, dtype=torch.int32, device="cuda")
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    bad_labels = torch.zeros((), dtype=torch.int64, device="cuda")
    batches = 0
    _all_launch_counters(zero=True)
    t0 = time.perf_counter()
    with _counting_decodes() as decoded:
        with DataLoader(reader, BATCH, device="cuda", last_batch="partial") as loader:
            for batch in loader:
                ids = batch["id"]
                counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
                bad.add_((images.index_select(0, ids) != batch["image"]).sum())
                bad_labels.add_((batch["label"].long() != ids % 1000).sum())
                batches += 1
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _all_launch_counters()
    log("example (d) %s: %d batches, %.1f rows/s (%.3f s); %d uint8 values and %d labels "
        "apart from phase 7's and the originals; launches %s for %d batches decoded; %s"
        % (label, batches, ROWS / wall, wall, bad.item(), bad_labels.item(),
           json.dumps(launches), decoded["batches"], smi))
    check(bool((counts == 1).all()), "(d) %s: ids delivered %s times, not once each"
          % (label, sorted(set(counts.tolist()))))
    check(bad.item() == 0 and bad_labels.item() == 0, "(d) %s: %d pixel values, %d "
          "labels differ" % (label, bad.item(), bad_labels.item()))
    check(launches["stage2_planes"] == launches["stage2_rgb"] == decoded["batches"]
          == batches and launches["K2"] == 0,
          "(d) %s: launches %s for %d batches" % (label, launches, batches))
    return {"launches": launches, "batches": batches, "rows_per_s": ROWS / wall}


def phase_tools_compat(url, images, work, smi):
    """(d) (comment above)."""
    import pickle

    import pyarrow.parquet as pq

    from petastorm_tpu_torch import make_batch_reader, make_reader, metadata
    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset
    from petastorm_tpu_torch.tools.generate_metadata import generate_metadata

    src = get_filesystem_and_path_or_paths(url)[1]
    copy_url = "file://" + os.path.join(work, "copy")
    t0 = time.perf_counter()
    copied = copy_dataset(url, copy_url)
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    generate_metadata(copy_url)
    gen_s = time.perf_counter() - t0
    pieces = metadata.load_row_groups(*get_filesystem_and_path_or_paths(copy_url))
    log("example (d): copy_dataset %d rows in %.3f s into %d row groups; generate_metadata "
        "%.3f s" % (copied, copy_s, len(pieces), gen_s))
    check(copied == ROWS, "(d): copy_dataset copied %d rows" % copied)
    out = {"copy_s": copy_s, "generate_s": gen_s}
    out["copy"] = _example_pixels_run(
        make_batch_reader(copy_url, decode_on_device=True, workers_count=_example_workers(),
                          shuffle_row_groups=False), images, "copy", smi)
    # phase 4's files under metadata keyed the reference petastorm's way only
    ref_root = os.path.join(work, "reference")
    os.makedirs(ref_root)
    for name in sorted(os.listdir(src)):
        if name.endswith(".parquet"):
            os.link(os.path.join(src, name), os.path.join(ref_root, name))
    fs, path = get_filesystem_and_path_or_paths("file://" + ref_root)
    schema = metadata.get_schema(*get_filesystem_and_path_or_paths(url))
    payload = pickle.dumps(schema, protocol=2)
    for ours, theirs in ((b"petastorm_tpu_torch.unischema", b"petastorm.unischema"),
                         (b"petastorm_tpu_torch.codecs", b"petastorm.codecs"),
                         (b"petastorm_tpu_torch.types", b"pyspark.sql.types")):
        payload = payload.replace(ours, theirs)
    pq.write_metadata(schema.as_arrow_schema().with_metadata({
        metadata.REFERENCE_SCHEMA_KEY: payload,
        metadata.REFERENCE_ROW_GROUPS_KEY: pickle.dumps(
            metadata._count_row_groups_per_file(fs, path), protocol=2)}),
        os.path.join(ref_root, "_common_metadata"))
    kv = pq.read_schema(os.path.join(ref_root, "_common_metadata")).metadata
    check(set(kv) == {metadata.REFERENCE_SCHEMA_KEY, metadata.REFERENCE_ROW_GROUPS_KEY},
          "(d): the reference store's keys are %s" % sorted(kv))
    out["reference"] = _example_pixels_run(
        make_reader("file://" + ref_root, decode_on_device=True,
                    workers_count=_example_workers(), shuffle_row_groups=False),
        images, "reference keys, make_reader", smi)
    return out


# -- no-cv2 fallback: a small baseline JPEG encoder (JPEG Annex K tables, 4:2:0) -------


_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
           41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
           15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
           62, 63]
_Q_LUMA = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24,
           40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77,
           24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95,
           98, 112, 100, 103, 99]
_Q_CHROMA = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99,
             99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718"
    "191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a7374"
    "75767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9ba"
    "c2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434"
    "e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768"
    "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4"
    "b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


class BaselineJpegEncoder:
    """Baseline sequential JPEG (JFIF YCbCr, 4:2:0, the Annex K quantisation and Huffman
    tables scaled to ``quality`` as libjpeg scales them). Used only where cv2 is absent."""

    def __init__(self, quality):
        import numpy as np

        scale = 5000 // quality if quality < 50 else 200 - 2 * quality
        self.q = [np.clip((np.array(t) * scale + 50) // 100, 1, 255).astype(np.int32)
                  for t in (_Q_LUMA, _Q_CHROMA)]
        self.huff = [(self._codes(*_DC_LUMA), self._codes(*_AC_LUMA)),
                     (self._codes(*_DC_CHROMA), self._codes(*_AC_CHROMA))]
        a = np.zeros((8, 8))
        for u in range(8):
            for p in range(8):
                a[u, p] = (0.5 ** 0.5 if u == 0 else 1.0) * 0.5 * np.cos(
                    (2 * p + 1) * u * np.pi / 16)
        self.fdct = np.kron(a, a).T  # pixels_flat @ fdct = coefficients_flat

    @staticmethod
    def _codes(bits, values):
        codes, code, k = {}, 0, 0
        for length in range(1, 17):
            for _ in range(bits[length - 1]):
                codes[values[k]] = (code, length)
                code += 1
                k += 1
            code <<= 1
        return codes

    def _blocks(self, plane, q):
        import numpy as np

        h, w = plane.shape
        b = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
        coef = (b - 128.0) @ self.fdct
        zz = np.rint(coef / q).astype(np.int32)[:, _ZIGZAG]
        return zz.reshape(h // 8, w // 8, 64)

    def encode(self, rgb):
        import numpy as np

        h, w, _ = rgb.shape
        ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
        img = np.pad(rgb.astype(np.float64), ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128

        def sub(c):
            return c.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))

        planes = [self._blocks(y, self.q[0]), self._blocks(sub(cb), self.q[1]),
                  self._blocks(sub(cr), self.q[1])]
        out = bytearray()
        acc, nbits = 0, 0

        def put(code, length):
            nonlocal acc, nbits
            acc = (acc << length) | code
            nbits += length
            while nbits >= 8:
                byte = (acc >> (nbits - 8)) & 0xFF
                out.append(byte)
                if byte == 0xFF:
                    out.append(0)
                nbits -= 8
            acc &= (1 << nbits) - 1

        def put_value(v):
            size = int(abs(v)).bit_length()
            return size, (v if v >= 0 else v + (1 << size) - 1)

        pred = [0, 0, 0]
        for my in range(ph // 16):
            for mx in range(pw // 16):
                units = [(0, 2 * my + dy, 2 * mx + dx) for dy in (0, 1) for dx in (0, 1)]
                units += [(1, my, mx), (2, my, mx)]
                for c, by, bx in units:
                    dc_codes, ac_codes = self.huff[0 if c == 0 else 1]
                    blk = planes[c][by, bx]
                    size, bits = put_value(int(blk[0]) - pred[c])
                    pred[c] = int(blk[0])
                    put(*dc_codes[size])
                    if size:
                        put(bits, size)
                    run = 0
                    last = max((i for i in range(1, 64) if blk[i]), default=0)
                    for i in range(1, last + 1):
                        v = int(blk[i])
                        if v == 0:
                            run += 1
                            continue
                        while run > 15:
                            put(*ac_codes[0xF0])
                            run -= 16
                        size, bits = put_value(v)
                        put(*ac_codes[(run << 4) | size])
                        put(bits, size)
                        run = 0
                    if last < 63:
                        put(*ac_codes[0x00])
        if nbits:
            put((1 << (8 - nbits)) - 1, 8 - nbits)
        return self._headers(h, w) + bytes(out) + b"\xff\xd9"

    def _headers(self, h, w):
        import struct

        def seg(marker, body):
            return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

        dqt = b"".join(bytes([i]) + bytes(int(q[z]) for z in _ZIGZAG)
                       for i, q in enumerate(self.q))
        sof = struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
        dht = b""
        for cls, tid, (bits, vals) in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA),
                                       (0, 1, _DC_CHROMA), (1, 1, _AC_CHROMA)):
            dht += bytes([(cls << 4) | tid]) + bytes(bits) + bytes(vals)
        sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
        app0 = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
        return (b"\xff\xd8" + seg(0xE0, app0) + seg(0xDB, dqt) + seg(0xC0, sof)
                + seg(0xC4, dht) + seg(0xDA, sos))


# -- main ------------------------------------------------------------------------------


def main():
    t_all = time.perf_counter()
    env = phase_environment()
    import torch

    phase_build()
    work = tempfile.mkdtemp(prefix="ptpu_chip_smoke_")
    try:
        t0 = time.perf_counter()
        url = "file://" + os.path.join(work, "store")
        blobs = write_store(url, env["cv2"])
        from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths
        from petastorm_tpu_torch.metadata import load_row_groups

        pieces = load_row_groups(*get_filesystem_and_path_or_paths(url))
        log("store: %d rows, %d row groups, %.1f MB of JPEG, written in %.1f s"
            % (len(blobs), len(pieces), sum(map(len, blobs.values())) / 1e6,
               time.perf_counter() - t0))
        kernels = phase_kernels(blobs)
        launches, main = phase_main_path(url, blobs, env["cv2"])
        pool_jpeg, images = phase_process_pool_jpeg(url, blobs, env)
        feed_jpeg = phase_feed_jpeg(url, images)
        t9 = time.perf_counter()
        sel_jpeg = phase_selection_jpeg(url, work, images, env["smi"])
        phase9_s = time.perf_counter() - t9
        t10 = time.perf_counter()
        inmem_jpeg = phase_inmem_jpeg(url, images, env["smi"])
        mkdl = phase_make_dataloader(url, images, env["smi"])
        ngram_rows = phase_ngram_rows(url, blobs, env["smi"])
        phase10_s = time.perf_counter() - t10
        t11 = time.perf_counter()
        io_jpeg = phase_read_path_jpeg(url, blobs, images, env["smi"])
        io_mem = phase_read_path_memcache(url, images, env["smi"])
        io_pool = phase_read_path_pool(url, blobs, images, env["smi"])
        phase11_s = time.perf_counter() - t11
        t12 = time.perf_counter()
        store_jpeg = phase_remote_jpeg(url, blobs, images, env["smi"])
        store_arena = phase_remote_arena(url, images, env["smi"])
        phase12_s = time.perf_counter() - t12
        t13 = time.perf_counter()
        traces = os.path.join(work, "traces")
        os.makedirs(traces)
        chaos_a = phase_chaos_main_path(url, images, env["smi"])
        chaos_c = phase_chaos_pool(url, images, env["smi"])
        trace_jpeg = phase_trace_main_path(url, images, traces, env["smi"])
        phase13_s = time.perf_counter() - t13
        t14 = time.perf_counter()
        health_dir = os.path.join(work, "health")
        os.makedirs(health_dir)
        health_a = phase_health_main_path(url, images, health_dir, env["smi"])
        health_b = phase_health_hang(url, images, health_dir, env["smi"])
        health_c = phase_health_heal(url, images, health_dir, env["smi"])
        phase14_s = time.perf_counter() - t14
        t15 = time.perf_counter()
        prov_c = phase_prov_main_path(url, images, kernels, env["smi"])
        phase15_s = time.perf_counter() - t15
        t16 = time.perf_counter()
        ctl_a = phase_ctl_converge(url, images, env["smi"])
        ctl_b = phase_ctl_fleet(url, images, env["smi"])
        ctl_c = phase_ctl_clean(url, images, env["smi"])
        ctl_d = phase_ctl_tenants(url, images, work, env["smi"])
        phase16_s = time.perf_counter() - t16
        log("tenants and the controller: phase 16 took %.1f s of wall time; %s"
            % (phase16_s, env["smi"]))
        t17 = time.perf_counter()
        watch_jpeg = phase_watch_main_path(os.path.join(work, "store"), blobs, images, work,
                                           env)
        phase17_s = time.perf_counter() - t17
        t18 = time.perf_counter()
        place_a = phase_place_world_of_one(url, images, env["smi"])
        # (b) runs after phase 5's store exists: it keeps phase 7's pixels as digests
        digests = pixel_digest(images, pixel_weights("cuda")).cpu()
        phase18_s = time.perf_counter() - t18
        t19 = time.perf_counter()
        tcp_jpeg = phase_tcp_main_path(url, images, env["smi"])
        phase19_s = time.perf_counter() - t19
        t20 = time.perf_counter()
        service = phase_service(url, images, env["smi"])
        phase20_s = time.perf_counter() - t20
        log("the data service: phase 20 took %.1f s of wall time; %s"
            % (phase20_s, env["smi"]))
        t21 = time.perf_counter()
        models = phase_models(url, images, env["smi"])
        phase21_s = time.perf_counter() - t21
        log("the model zoo: phase 21 took %.1f s of wall time; %s" % (phase21_s, env["smi"]))
        check(phase21_s < 120.0, "phase 21 took %.1f s, over its 120 s" % phase21_s)
        t22 = time.perf_counter()
        log("phase 22: HDFS, Spark and TensorFlow are held on the CPU only "
            "(tests/test_torch_hdfs.py, test_torch_spark.py, test_torch_tf.py): this "
            "machine has no HDFS cluster, pyspark or tensorflow")
        example_a = phase_example_imagenet(url, work, env["smi"])
        example_c = phase_example_mnist(work, env["smi"])
        example_d = phase_tools_compat(url, images, work, env["smi"])
        phase22_s = time.perf_counter() - t22
        del images

        t0 = time.perf_counter()
        mix_url = "file://" + os.path.join(work, "mixed")
        mix_blobs, mix_sizes = write_mixed_store(mix_url, env["cv2"])
        log("mixed store: %d rows, %.1f MB of JPEG, written in %.1f s" % (
            len(mix_blobs), sum(map(len, mix_blobs.values())) / 1e6,
            time.perf_counter() - t0))
        mixed_split = phase_stage2_layouts(mix_blobs, mix_sizes, torch.device("cuda"))
        mixed = phase_mixed_feed(mix_url, mix_blobs, mix_sizes)
        t22 = time.perf_counter()
        example_b = phase_example_vit(mix_url, env["smi"])
        phase22_s += time.perf_counter() - t22
        log("the examples, the tools and reference compatibility: phase 22 took %.1f s of "
            "wall time; %s" % (phase22_s, env["smi"]))
        check(phase22_s < 240.0, "phase 22 took %.1f s, over its 240 s" % phase22_s)
        shutil.rmtree(os.path.join(work, "mixed"), ignore_errors=True)

        t0 = time.perf_counter()
        tab_root = os.path.join(work, "tabular")
        _url, arrays = write_tabular_store(tab_root)
        size = sum(os.path.getsize(os.path.join(tab_root, f)) for f in os.listdir(tab_root))
        log("tabular store: %d rows in %d files of %d row groups, %d bytes on disk, %d "
            "decoded, written in %.1f s" % (
                TAB_FILES * TAB_RGS_PER_FILE * TAB_RG_ROWS, TAB_FILES, TAB_RGS_PER_FILE,
                size, TAB_FILES * TAB_RGS_PER_FILE * TAB_RG_ROWS * 4 * len(TAB_COLUMNS),
                time.perf_counter() - t0))
        predicted = tabular_structure(tab_root)
        tab_kernels = phase_tabular_kernels(tab_root)
        tab_launches, tab = phase_tabular_path(tab_root, arrays, predicted)
        pool_tab = phase_process_pool_tabular(tab_root, arrays, predicted, env)
        feed = phase_feed_tabular(tab_root, arrays, predicted, env["smi"])
        t9 = time.perf_counter()
        sel_tab = phase_selection_tabular(tab_root, arrays, predicted, work, env["smi"])
        pad = phase_pad_shapes(work, env["smi"])
        phase9_s += time.perf_counter() - t9
        log("selection: phase 9 took %.1f s of wall time; %s" % (phase9_s, env["smi"]))
        t10 = time.perf_counter()
        inmem_tab = phase_inmem_tabular(tab_root, arrays, predicted, env["smi"])
        mixer = phase_weighted(tab_root, arrays, env["smi"])
        phase_adapters(tab_root, env["smi"])
        sensors = phase_ngram_sensors(work, env["smi"])
        phase10_s += time.perf_counter() - t10
        log("windowed and in-memory feeds: phase 10 took %.1f s of wall time; %s"
            % (phase10_s, env["smi"]))
        t11 = time.perf_counter()
        io_tab = phase_read_path_tabular(tab_root, arrays, predicted, env["smi"])
        io_disk = phase_read_path_disk(tab_root, arrays, work, env["smi"])
        phase11_s += time.perf_counter() - t11
        log("read path and caches: phase 11 took %.1f s of wall time; %s"
            % (phase11_s, env["smi"]))
        t12 = time.perf_counter()
        store_tab = phase_remote_tabular(tab_root, arrays, predicted, work, env["smi"])
        store_hedge = phase_remote_hedging(tab_root, arrays, env["smi"])
        phase12_s += time.perf_counter() - t12
        log("object-store tier and arena: phase 12 took %.1f s of wall time; %s"
            % (phase12_s, env["smi"]))
        t13 = time.perf_counter()
        chaos_b = phase_chaos_tabular(tab_root, arrays, predicted, env["smi"])
        trace_tab = phase_trace_tabular(tab_root, arrays, predicted, traces, env["smi"])
        phase13_s += time.perf_counter() - t13
        log("failure handling and its record: phase 13 took %.1f s of wall time; %s"
            % (phase13_s, env["smi"]))
        t14 = time.perf_counter()
        health_d = phase_health_tabular(tab_root, arrays, predicted, health_dir,
                                        env["smi"])
        phase14_s += time.perf_counter() - t14
        log("liveness and time: phase 14 took %.1f s of wall time; %s"
            % (phase14_s, env["smi"]))
        t15 = time.perf_counter()
        prov_a = phase_prov_tabular(tab_root, arrays, predicted, work, env["smi"])
        prov_b = phase_prov_blame(work, env["smi"])
        prov_d = phase_prov_tools(prov_a, work, env["smi"])
        phase15_s += time.perf_counter() - t15
        log("attribution: phase 15 took %.1f s of wall time; %s" % (phase15_s, env["smi"]))
        t17 = time.perf_counter()
        watch_tab = phase_watch_tabular(tab_root, arrays, predicted, work, env["smi"])
        phase17_s += time.perf_counter() - t17
        log("dataset watch and mutation: phase 17 took %.1f s of wall time; %s"
            % (phase17_s, env["smi"]))
        check(phase17_s < 60.0, "phase 17 took %.1f s, over its 60 s" % phase17_s)
        t18 = time.perf_counter()
        place_b = phase_place_two_ranks(url, tab_root, arrays, digests, predicted, work,
                                        env["smi"])
        phase18_s += time.perf_counter() - t18
        shutil.rmtree(os.path.join(work, "store"), ignore_errors=True)
        log("multi-card placement: phase 18 took %.1f s of wall time; %s"
            % (phase18_s, env["smi"]))
        check(phase18_s < 120.0, "phase 18 took %.1f s, over its 120 s" % phase18_s)
        t19 = time.perf_counter()
        tcp_tab = phase_tcp_tabular(tab_root, arrays, predicted, env["smi"])
        phase19_s += time.perf_counter() - t19
        log("the process pool on tcp: phase 19 took %.1f s of wall time; %s"
            % (phase19_s, env["smi"]))
        check(phase19_s + phase20_s < 180.0, "phases 19 and 20 took %.1f s, over their "
              "180 s" % (phase19_s + phase20_s))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    k1, k2, up, s2 = kernels["K1"], kernels["K2"]["bf16"], kernels["unpack"], kernels["stage2"]
    sel = s2["planes"]["selected"]

    def pool_launches(runs, key):
        """{run: launches of ``key``} over the process-pool runs (phase 7)."""
        return {name: r["launches"][key] for name, r in runs.items()}

    tab_pool = {name: r["launches"] for name, r in pool_tab.items()}

    def selection_launches(key):
        """{part: launches of ``key``} in phase 9 ((d): [before, after] the restore)."""
        return {"a_split_store": sel_jpeg["a"]["launches"][key],
                "d_resume": [h[key] for h in sel_jpeg["d"]["launches"]]}

    def slice11_launches(key):
        """{part: launches of ``key``} in phase 10's JPEG parts."""
        return {"a_inmem_fill": inmem_jpeg["fill_launches"][key],
                "a_inmem_served": inmem_jpeg["launches"][key],
                "c_make_dataloader": mkdl["launches"][key],
                "d_ngram_rows": ngram_rows["launches"][key]}

    def slice12_launches(key):
        """{part: launches of ``key``} in phase 11's JPEG parts (a list a run)."""
        return {"a_defaults": [r["launches"][key] for r in io_jpeg["defaults"]],
                "a_all_off": [r["launches"][key] for r in io_jpeg["all_off"]],
                "c_memcache_small": [e["launches"][key] for e in io_mem["small"]["epochs"]],
                "c_memcache_big": [e["launches"][key] for e in io_mem["big"]["epochs"]],
                "e_process_arrow": io_pool["launches"][key]}

    def slice13_launches(key):
        """{part: launches of ``key``} in phase 12's JPEG parts (a list a run or epoch)."""
        return {"a_remote": [r["launches"][key] for r in store_jpeg["remote"]],
                "a_local": [r["launches"][key] for r in store_jpeg["local"]],
                "d_arena": [e["launches"][key] for e in store_arena["arena"]["epochs"]],
                "d_no_arena": [e["launches"][key] for e in store_arena["no_arena"]["epochs"]]}

    def slice14_launches(key):
        """{part: launches of ``key``} in phase 13's JPEG parts (a list a run)."""
        return {"a_faults": [r["launches"][key] for r in chaos_a["faults"]],
                "a_clean": [r["launches"][key] for r in chaos_a["clean"]],
                "a_batches": [r["batches"] for r in chaos_a["faults"]],
                "c_kill": chaos_c["kill"]["launches"][key],
                "c_kill_batches": chaos_c["kill"]["batches"],
                "c_corrupt": chaos_c["corrupt"]["launches"][key],
                "d_traced": [r["launches"][key] for r in trace_jpeg["on"]],
                "d_untraced": [r["launches"][key] for r in trace_jpeg["off"]],
                "d_pool_traced": trace_jpeg["pool"]["launches"][key]}

    def slice15_launches(key):
        """{part: launches of ``key``} in phase 14's JPEG parts (a list a run)."""
        return {"a_health": [r["launches"][key] for r in health_a["on"]],
                "a_no_health": [r["launches"][key] for r in health_a["off"]],
                "a_batches": [r["batches"] for r in health_a["on"]],
                "b_raise": health_b["raised"]["launches"][key],
                "b_raise_batches": health_b["raised"]["batches"],
                "b_flight": health_b["alive"]["launches"][key],
                "c_heal": health_c["healed"]["launches"][key],
                "c_heal_batches": health_c["healed"]["batches"],
                "c_refused": health_c["refused"]["launches"][key],
                "c_refused_batches": health_c["refused"]["batches"]}

    def slice16_launches(key):
        """{part: launches of ``key``} in phase 15's JPEG part (a list a run)."""
        return {"c_provenance": [r["launches"][key] for r in prov_c["on"]],
                "c_no_provenance": [r["launches"][key] for r in prov_c["off"]],
                "c_batches": [r["batches"] for r in prov_c["on"] + prov_c["off"]]}

    def slice17_launches(key):
        """{part: launches of ``key``} in phase 16 (a list a run where it has several)."""
        runs = {"a_off": ctl_a["off"], "a_controller": ctl_a["controller"],
                "a_tuned": ctl_a["tuned"], "b_thread": ctl_b["thread"],
                "b_process": ctl_b["process"], "d_team_a": ctl_d["a"],
                "d_team_b": ctl_d["b"], "d_untagged": ctl_d["untagged"]}
        out = {name: r["launches"][key] for name, r in runs.items()}
        out.update({"c_" + arm: [r["launches"][key] for r in ctl_c[arm]]
                    for arm in ("armed", "off")})
        out["batches"] = {name: r["batches"] for name, r in runs.items()}
        return out

    def slice18_launches(key):
        """{part: launches of ``key``} in phase 17's main-path parts."""
        return {"a_thread": watch_jpeg["a"]["launches"][key],
                "c_process": watch_jpeg["c"]["launches"][key],
                "batches": {"a_thread": watch_jpeg["a"]["batches"],
                            "c_process": watch_jpeg["c"]["batches"]}}

    def slice19_launches(key):
        """{part: launches of ``key``} in phase 18, each rank's parts apart."""
        ranks = enumerate(place_b["ranks"])
        if key in ("K3", "scan", "K4"):
            parts = {"b_rank%d_passthrough" % n: (r["tab"]["launches"][key],
                                                  r["tab"]["batches"]) for n, r in ranks}
        else:
            parts = {"a_world_of_one": (place_a["launches"][key], place_a["batches"])}
            for n, r in ranks:
                served = INMEM_EPOCHS * r["inmem"]["per_epoch"]
                parts["b_rank%d_main" % n] = (r["main"]["launches"][key],
                                              r["main"]["batches"])
                parts["b_rank%d_inmem_fill" % n] = (r["inmem"]["fill_launches"][key],
                                                    -(-len(r["shard"]) // BATCH))
                parts["b_rank%d_inmem_served" % n] = (r["inmem"]["launches"][key], served)
        out = {part: n for part, (n, _b) in parts.items()}
        out["batches"] = {part: b for part, (_n, b) in parts.items()}
        return out

    def slice20_launches(key):
        """{part: launches of ``key``} in phases 19 and 20 (phase 20's path runs K2
        alone; the pass-through kernels run in phase 19 (b))."""
        if key in ("K3", "scan", "K4"):
            parts = {"19b_" + t: (r["launches"][key], r["passthrough_batches"])
                     for t, r in tcp_tab.items()}
        else:
            parts = {"19" + part: (tcp_jpeg[run]["launches"][key],
                                   tcp_jpeg[run]["batches"])
                     for part, run in (("a_pipe", "pipe"), ("a_tcp", "tcp"),
                                       ("c_net_reset", "reset"),
                                       ("d_net_corrupt_frame", "corrupt"))}
            parts["20a_two_trainers"] = (service["a"]["launches"][key],
                                         service["a"]["batches"])
        out = {part: n for part, (n, _b) in parts.items()}
        out["batches"] = {part: b for part, (_n, b) in parts.items()}
        return out

    def slice21_launches(key):
        """{part: launches of ``key``} in phase 21's fed trainers."""
        parts = {"a_resnet50_fed": models["a"], "c_vit_b16_fed": models["c"]}
        out = {part: r["launches"][key] for part, r in parts.items()}
        out["batches"] = {part: r["batches"] for part, r in parts.items()}
        return out

    def slice22_launches(key):
        """{part: launches of ``key``} in phase 22 (every kernel's counter is read)."""
        parts = {"a_imagenet_resnet50": example_a, "b_imagenet_vit_s16_mixed": example_b,
                 "d_copy": example_d["copy"], "d_reference_keys": example_d["reference"]}
        parts.update({"c_mnist_" + k: v for k, v in example_c.items()})
        out = {part: r["launches"][key] for part, r in parts.items()}
        out["batches"] = {part: r.get("batches", r.get("steps"))
                          for part, r in parts.items()}
        return out

    table = {"kernels": [
        {"name": "stage2_planes (the batched stage 2: the unpack, dequantisation, K1's "
         "product and the range limit into uint8 planes, one launch a layout group)",
         "route": "cuda", "source": "petastorm_tpu_torch/csrc/stage2.cu",
         "replaces": "petastorm_tpu/ops/jpeg.py:311", "launches": launches["stage2_planes"],
         "max_abs_err": s2["max_abs_err"], "ms": sel["ms"], "plain_ms": sel["plain_ms"],
         "bound_ms": sel["bound_ms"], "bound_by": sel["bound_by"], "library_ms": None,
         "composition_ms": s2["composition_ms"], "both_kernels_ms": s2["both_ms"],
         "variants": {k: {kk: v[kk] for kk in ("ms", "bound_ms")}
                      for k, v in s2["planes"].items()},
         "mixed_feed_launches": mixed["launches"]["stage2_planes"],
         "pool_launches": pool_launches(pool_jpeg, "stage2_planes"),
         "ring_feed_launches": feed_jpeg["launches"]["stage2_planes"],
         "selection_launches": selection_launches("stage2_planes"),
         "slice11_launches": slice11_launches("stage2_planes"),
         "slice12_launches": slice12_launches("stage2_planes"),
         "slice13_launches": slice13_launches("stage2_planes"),
         "slice14_launches": slice14_launches("stage2_planes"),
         "slice15_launches": slice15_launches("stage2_planes"),
         "slice16_launches": slice16_launches("stage2_planes"),
         "slice17_launches": slice17_launches("stage2_planes"),
         "slice18_launches": slice18_launches("stage2_planes"),
         "slice19_launches": slice19_launches("stage2_planes"),
         "slice20_launches": slice20_launches("stage2_planes"),
         "slice21_launches": slice21_launches("stage2_planes"),
         "slice22_launches": slice22_launches("stage2_planes")},
        {"name": "stage2_rgb (the batched stage 2: chroma upsample, crop and YCbCr to RGB, "
         "one launch a layout group)", "route": "cuda",
         "source": "petastorm_tpu_torch/csrc/stage2.cu",
         "replaces": "petastorm_tpu/ops/jpeg.py:337", "launches": launches["stage2_rgb"],
         "max_abs_err": s2["max_abs_err"], "ms": s2["rgb"]["ms"],
         "plain_ms": s2["rgb"]["plain_ms"], "bound_ms": s2["rgb"]["bound_ms"],
         "bound_by": s2["rgb"]["bound_by"], "library_ms": None,
         "mixed_feed_launches": mixed["launches"]["stage2_rgb"],
         "pool_launches": pool_launches(pool_jpeg, "stage2_rgb"),
         "ring_feed_launches": feed_jpeg["launches"]["stage2_rgb"],
         "selection_launches": selection_launches("stage2_rgb"),
         "slice11_launches": slice11_launches("stage2_rgb"),
         "slice12_launches": slice12_launches("stage2_rgb"),
         "slice13_launches": slice13_launches("stage2_rgb"),
         "slice14_launches": slice14_launches("stage2_rgb"),
         "slice15_launches": slice15_launches("stage2_rgb"),
         "slice16_launches": slice16_launches("stage2_rgb"),
         "slice17_launches": slice17_launches("stage2_rgb"),
         "slice18_launches": slice18_launches("stage2_rgb"),
         "slice19_launches": slice19_launches("stage2_rgb"),
         "slice20_launches": slice20_launches("stage2_rgb"),
         "slice21_launches": slice21_launches("stage2_rgb"),
         "slice22_launches": slice22_launches("stage2_rgb")},
        {"name": "coef_unpack_segments (the stage-2 unpack and dequantisation on its own; "
         "launches counted on its path, the per-image stage 2 decode_jpeg_device_stage; "
         "the batched path runs its code inside stage2_planes and launches it 0 times; "
         "replaces fused jnp, not Pallas)", "route": "cuda",
         "source": "petastorm_tpu_torch/csrc/coef_unpack.cu",
         "replaces": "petastorm_tpu/ops/jpeg.py:552", "launches": up["launches"],
         "max_abs_err": max(v["max_abs_err"] for k, v in up.items()
                            if k not in ("ratio", "launches")),
         "ms": up["corpus"]["ms"], "plain_ms": up["corpus"]["plain_ms"],
         "bound_ms": up["corpus"]["bound_ms"], "bound_by": up["corpus"]["bound_by"],
         "library_ms": up["corpus"]["library_ms"],
         "variants": {k: {kk: v[kk] for kk in ("ms", "plain_ms", "bound_ms", "library_ms")}
                      for k, v in up.items() if k not in ("ratio", "launches")},
         "main_path_launches": launches["unpack"],
         "mixed_feed_launches": mixed["launches"]["unpack"],
         "slice22_launches": slice22_launches("unpack")},
        {"name": "idct_segments_f32 (K1; launches counted on its path, the per-image "
         "stage 2 decode_jpeg_device_stage; the batched path runs its product inside "
         "stage2_planes and launches it 0 times)", "route": "cuda",
         "source": "petastorm_tpu_torch/csrc/idct.cu",
         "replaces": "petastorm_tpu/ops/jpeg.py:311", "launches": k1["launches"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"], "main_path_launches": launches["K1"],
         "mixed_feed_launches": mixed["launches"]["K1"],
         "slice22_launches": slice22_launches("K1")},
        {"name": "normalize_u8 (K2)", "route": "cuda",
         "source": "petastorm_tpu_torch/csrc/normalize.cu",
         "replaces": "petastorm_tpu/ops/image.py:24", "launches": launches["K2"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None,
         "pool_launches": pool_launches(pool_jpeg, "K2"),
         "ring_feed_launches": feed_jpeg["launches"]["K2"],
         "selection_launches": selection_launches("K2"),
         "slice11_launches": slice11_launches("K2"),
         "slice12_launches": slice12_launches("K2"),
         "slice13_launches": slice13_launches("K2"),
         "slice14_launches": slice14_launches("K2"),
         "slice15_launches": slice15_launches("K2"),
         "slice16_launches": slice16_launches("K2"),
         "slice17_launches": slice17_launches("K2"),
         "slice18_launches": slice18_launches("K2"),
         "slice19_launches": slice19_launches("K2"),
         "slice20_launches": slice20_launches("K2"),
         "slice21_launches": slice21_launches("K2"),
         "slice22_launches": slice22_launches("K2")},
    ]}
    for key, name, replaces in (
            ("K3", "snappy_ragged (K3)", "petastorm_tpu/ops/pagedec_kernels.py:149"),
            ("scan", "rle_scan_pages (the run scan, one launch over a batch's data pages; "
             "feeds K4; replaces a lax.while_loop)", "petastorm_tpu/ops/pagedec_kernels.py:224"),
            ("K4", "extract_pages (K4, one launch over a batch's data pages, with the "
             "dictionary gather)", "petastorm_tpu/ops/pagedec_kernels.py:290")):
        r = tab_kernels[key]
        row = {
            "name": name, "route": "cuda", "source": "petastorm_tpu_torch/csrc/pagedec.cu",
            "replaces": replaces, "launches": tab_launches[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
        if "serial_floor_ms" in r:
            row["serial_floor_ms"] = r["serial_floor_ms"]
        row["pool_launches"] = {name: n[key] for name, n in tab_pool.items()}
        row["ring_feed_launches"] = {"feed": feed["launches"][key],
                                     "feed_transferred_batches": feed["transferred"],
                                     "epoch": feed["epoch_launches"][key],
                                     "transform_spec_read": feed["b_launches"][key]}
        row["selection_launches"] = {"b_days_row_drop": sel_tab["b"]["launches"][key],
                                     "c_resume": [h[key] for h in sel_tab["c"]["launches"]]}
        row["slice11_launches"] = {
            "b_inmem_fill": inmem_tab["launches"][key],
            "b_inmem_passthrough_fill_batches": inmem_tab["passthrough_batches"]}
        row["slice12_launches"] = {
            "b_" + mode: [r["launches"][key] for r in runs] for mode, runs in io_tab.items()}
        row["slice12_launches"]["b_passthrough_batches"] = {
            mode: [r["passthrough_batches"] for r in runs] for mode, runs in io_tab.items()}
        row["slice13_launches"] = {
            "b_remote": store_tab["remote"]["launches"][key],
            "b_local": store_tab["local"]["launches"][key],
            "b_passthrough_batches": {m: store_tab[m]["passthrough_batches"]
                                      for m in ("remote", "local")},
            "b_split_epochs": [e[key] for e in store_tab["split"]["launches"]],
            "c_hedged": store_hedge["on"]["launches"][key],
            "c_unhedged": store_hedge["off"]["launches"][key]}
        row["slice14_launches"] = {
            "b_quarantine": chaos_b["launches"][key], "b_batches": chaos_b["batches"],
            "d_traced": [r["launches"][key] for r in trace_tab["on"]],
            "d_untraced": [r["launches"][key] for r in trace_tab["off"]],
            "d_passthrough_batches": [r["passthrough_batches"]
                                      for r in trace_tab["on"] + trace_tab["off"]]}
        row["slice15_launches"] = {
            "d_timeseries": [r["launches"][key] for r in health_d["on"]],
            "d_metrics": [r["launches"][key] for r in health_d["metrics"]],
            "d_plain": [r["launches"][key] for r in health_d["off"]],
            "d_passthrough_batches": [
                r["passthrough_batches"]
                for r in health_d["on"] + health_d["metrics"] + health_d["off"]]}
        row["slice16_launches"] = {
            "a_" + pool: prov_a[pool]["launches"][key] for pool in prov_a}
        row["slice16_launches"]["a_passthrough_batches"] = {
            pool: prov_a[pool]["passthrough_batches"] for pool in prov_a}
        row["slice16_launches"].update({
            "b_" + site: [x["launches"][key] for x in prov_b[site]] for site in BLAME_SITES})
        row["slice16_launches"]["b_slo"] = prov_b["slo"]["launches"][key]
        row["slice16_launches"]["b_batches"] = BLAME_RGS
        row["slice18_launches"] = {"b_passthrough": watch_tab["launches"][key],
                                   "b_passthrough_batches": watch_tab["batches"]}
        row["slice19_launches"] = slice19_launches(key)
        row["slice20_launches"] = slice20_launches(key)
        row["slice22_launches"] = slice22_launches(key)
        table["kernels"].append(row)
    log("process pool: JPEG rows/s %s; tabular rows/s %s" % (
        json.dumps({k: round(v["rows_per_s"], 1) for k, v in pool_jpeg.items()}),
        json.dumps({k: round(v["rows_per_s"], 1) for k, v in pool_tab.items()})))
    log("total %.1f s; main path %.1f rows/s (shipped/raw %.4f); mixed feed %.1f rows/s "
        "(shipped/raw %.4f, %.2f groups a batch; a batch's stage 2 %.4f ms and resize %.4f "
        "ms of device time); tabular path %.1f rows/s; click-through feed %.1f rows/s "
        "beside %.1f without ring and pipeline (ring exchange %.4f ms, pipeline %.4f ms of "
        "device time a batch); phase 9 %.1f s (split store %.1f rows/s, %.4f of its rows "
        "skipped stage 1; day partitions %.1f rows/s; pad_shapes %.1f rows/s); phase 10 "
        "%.1f s (in-memory JPEG: fill %.3f s, %.1f rows/s served; in-memory tabular: fill "
        "%.3f s, %.1f rows/s served; make_dataloader %.1f rows/s; per-row NGram %.1f "
        "windows/s; sensor NGram %.1f windows/s; mixer %.1f rows/s)"
        % (time.perf_counter() - t_all, main["rows_per_s"], main["shipped_ratio"],
           mixed["rows_per_s"], mixed["shipped_ratio"],
           mixed["launches"]["groups"] / mixed["batches"], mixed_split["stage2_ms"],
           mixed_split["resize_ms"], tab["rows_per_s"], feed["rows_per_s"],
           feed["plain_rows_per_s"], feed["exchange_ms"], feed["pipeline_ms"], phase9_s,
           sel_jpeg["a"]["rows_per_s"], sel_jpeg["a"]["stage1_skipped_share"],
           sel_tab["b"]["rows_per_s"], pad["rows_per_s"], phase10_s, inmem_jpeg["fill_s"],
           inmem_jpeg["rows_per_s"], inmem_tab["fill_s"], inmem_tab["rows_per_s"],
           mkdl["rows_per_s"], ngram_rows["windows_per_s"],
           sensors["overlap"]["windows_per_s"], mixer["rows_per_s"]))
    def median(runs):
        rates = sorted(r["rows_per_s"] for r in runs)
        return rates[len(rates) // 2]

    log("read path (phase 11, %.1f s): main path rows/s median %.1f at the defaults, "
        "%.1f all off; pass-through %.1f and %.1f; memcache epoch 2 %.1f rows/s against "
        "%.1f in epoch 1; local-disk epoch 2 %.1f against %.1f; process pool with hints "
        "%.1f" % (phase11_s, median(io_jpeg["defaults"]), median(io_jpeg["all_off"]),
                  median(io_tab["defaults"]), median(io_tab["all_off"]),
                  io_mem["big"]["epochs"][1]["rows_per_s"],
                  io_mem["big"]["epochs"][0]["rows_per_s"],
                  io_disk["epochs"][1]["rows_per_s"], io_disk["epochs"][0]["rows_per_s"],
                  io_pool["rows_per_s"]))
    log("object store (phase 12, %.1f s): main path rows/s median %.1f from the simulator, "
        "%.1f local; pass-through %.1f from the simulator, %.1f local; hedged p99 of a row "
        "group's GET plan %.4f s against %.4f s; arena epoch 2 %.1f rows/s against %.1f "
        "without it" % (
            phase12_s, median(store_jpeg["remote"]), median(store_jpeg["local"]),
            store_tab["remote"]["rows_per_s"], store_tab["local"]["rows_per_s"],
            store_hedge["on"]["p99_s"], store_hedge["off"]["p99_s"],
            store_arena["arena"]["epochs"][1]["rows_per_s"],
            store_arena["no_arena"]["epochs"][1]["rows_per_s"]))
    log("failure handling (phase 13, %.1f s): main path rows/s median %.1f under a transient "
        "fault every 4th read, %.1f clean; the pass-through with a quarantined row group "
        "%.1f rows/s; traced/untraced main path %.1f/%.1f, pass-through %.1f/%.1f; "
        "verdicts: main path %s, pass-through %s" % (
            phase13_s, median(chaos_a["faults"]), median(chaos_a["clean"]),
            chaos_b["rows_per_s"], median(trace_jpeg["on"]), median(trace_jpeg["off"]),
            median(trace_tab["on"]), median(trace_tab["off"]),
            sorted({r["bottleneck"].verdict for r in trace_jpeg["on"] + trace_jpeg["off"]}),
            sorted({r["bottleneck"].verdict for r in trace_tab["on"] + trace_tab["off"]})))
    log("liveness and time (phase 14, %.1f s): main path rows/s median %.1f with the "
        "watchdog, %.1f without; the hung decode's StallError %.3f s after the hang; %d "
        "heals, then a refused heal with %d children's stacks; pass-through rows/s median "
        "%.1f with time series, SLOs and the endpoint, %.1f with metrics= alone, %.1f "
        "with neither" % (
            phase14_s, median(health_a["on"]), median(health_a["off"]),
            health_b["latency_s"], health_c["healed"]["heals"], health_c["child_stacks"],
            median(health_d["on"]), median(health_d["metrics"]), median(health_d["off"])))
    log("attribution (phase 15, %.1f s): pass-through rows/s with provenance %.1f on the "
        "thread pool, %.1f on the process pool over 'arrow'; the slowed site named in "
        "%d of %d rounds for each of %s, the SLO alert's culprit %s; main path rows/s "
        "median ratio provenance on/off %.4f (on %s, off %s); loader.decode host self "
        "time %s ms a batch beside %.4f ms of kernel device time a batch; trend gate "
        "verdicts %s; diff %r" % (
            phase15_s, prov_a["thread"]["rows_per_s"], prov_a["process"]["rows_per_s"],
            BLAME_ROUNDS, BLAME_ROUNDS, list(BLAME_SITES), prov_b["slo"]["alerts"],
            prov_c["ratio"], [round(r["rows_per_s"], 1) for r in prov_c["on"]],
            [round(r["rows_per_s"], 1) for r in prov_c["off"]],
            [round(x, 4) for x in prov_c["decode_self_ms"]],
            sum(prov_c["device_ms"].values()), [r["verdict"] for r in prov_d["trend"]],
            prov_d["diff"]["verdict"]))
    log("tenants and the controller (phase 16, %.1f s): (a) readahead_depth %s; rows/s "
        "over the last third %.1f with the controller, %.1f at depth %d by hand, %.1f at "
        "depth 1 without; (b) resized 4 -> 2 -> 4 on both pools, knob frame acks %s; (c) "
        "0 actuations, armed/unarmed median ratio %.4f; (d) charged %s" % (
            phase16_s, [(d["before"], d["after"]) for d in ctl_a["moves"]],
            ctl_a["tail"]["controller"], ctl_a["tail"]["tuned"], CTL_TUNED_DEPTH,
            ctl_a["tail"]["off"], ctl_b["process"]["acks"], ctl_c["ratio"],
            json.dumps({t: {k: round(v, 4) for k, v in u.items()}
                        for t, u in ctl_d["usage"].items()})))
    log("dataset watch (phase 17, %.1f s): stamping adds %.6f s with the footer crc, "
        "%.6f s without; main path rows/s %.1f on the thread pool, %.1f on the process "
        "pool; pass-through %.1f rows/s across the rewrite" % (
            phase17_s, watch_jpeg["stamp_s"]["crc"], watch_jpeg["stamp_s"]["stat_only"],
            watch_jpeg["a"]["rows_per_s"], watch_jpeg["c"]["rows_per_s"],
            watch_tab["rows_per_s"]))
    log("multi-card placement (phase 18, %.1f s): a world of one %.1f rows/s; two ranks "
        "on one card: main path %s rows/s, pass-through %s rows/s a rank" % (
            phase18_s, place_a["rows_per_s"],
            [round(r["main"]["rows_per_s"], 1) for r in place_b["ranks"]],
            [round(r["tab"]["rows_per_s"], 1) for r in place_b["ranks"]]))
    log("the process pool on tcp (phase 19, %.1f s): main path rows/s %.1f on tcp against "
        "%.1f on the pipe, %.1f across a net.reset, %.1f across a corrupt frame; heartbeat "
        "round trip p50 %.6f s; pass-through rows/s %.1f on tcp against %.1f on the pipe"
        % (phase19_s, tcp_jpeg["tcp"]["rows_per_s"], tcp_jpeg["pipe"]["rows_per_s"],
           tcp_jpeg["reset"]["rows_per_s"], tcp_jpeg["corrupt"]["rows_per_s"],
           tcp_jpeg["corrupt"]["rtt_p50_s"], tcp_tab["tcp"]["rows_per_s"],
           tcp_tab["pipe"]["rows_per_s"]))
    log("the data service (phase 20, %.1f s): two trainers at %s rows/s, %.6f decode "
        "worker-seconds a row (decoded once for both); (b) %d + %d rows across the detach; "
        "(c) %d reconnects; (d) %d items mapped from the arena" % (
            phase20_s, [round(r, 1) for r in service["a"]["rows_per_s"]],
            service["a"]["decode_s_per_row"], service["b"]["before"],
            service["b"]["after"], service["c"]["net"]["reconnects"],
            service["d"]["mapped"]))
    ma, mc, md = models["a"], models["c"], models["d"]
    log("the model zoo (phase 21, %.1f s): ResNet-50 bf16 at batch %d %.4f ms a step "
        "alone (%.1f rows/s the consumer takes), fed by the main path at %.1f rows/s "
        "(device_queue_wait_s %.4f, busy share %s, peak %.2f GB); card against CPU %.3e "
        "of the largest logit; ViT-B/16 %.4f ms a step; the transformer's world of one "
        "losses %s; %s" % (
            phase21_s, BATCH, ma["step_ms"], ma["consumer_rows_per_s"], ma["rows_per_s"],
            ma["device_queue_wait_s"],
            "not measured" if ma["busy_share"] is None else "%.4f" % ma["busy_share"],
            ma["peak_gb"], models["b"]["max_abs_err"] / models["b"]["max_logit"],
            mc["step_ms"], [round(v, 4) for v in md["losses"]], env["smi"]))
    ea, eb = example_a, example_b
    log("the examples (phase 22, %.1f s): train_imagenet_torch.py ResNet-50 at batch %d "
        "%.1f img/s over its run, %s after step 2 (%d steps, %d batches decoded, %.1f s "
        "of wall time); ViT-S/16 on the mixed store %.1f img/s, %s after step 2 (%d "
        "layout groups in %d batches); train_mnist_torch.py streamed %.3f s, in memory "
        "%.3f s; the tools' copy read at %.1f rows/s, the reference-keyed store at %.1f "
        "rows/s; %s" % (
            phase22_s, BATCH, ea["img_per_s"],
            "-" if ea["steady_img_per_s"] is None else "%.1f" % ea["steady_img_per_s"],
            EXAMPLE_STEPS, ea["batches"], ea["wall_s"], eb["img_per_s"],
            "-" if eb["steady_img_per_s"] is None else "%.1f" % eb["steady_img_per_s"],
            eb["groups"], eb["batches"], example_c["streamed"]["seconds"],
            example_c["in_memory"]["seconds"], example_d["copy"]["rows_per_s"],
            example_d["reference"]["rows_per_s"], env["smi"]))
    log(json.dumps(table))
    log(env["smi"])
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": env["name"],
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--svc-worker"]:
        svc_worker_main(*sys.argv[2:5])  # phase 20's decode worker processes
        sys.exit(0)
    try:
        main()
    except PhaseFailed as e:
        print("FAILED: %s" % e, file=sys.stderr, flush=True)
        sys.exit(1)
