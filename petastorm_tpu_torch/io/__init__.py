"""Host IO under the reader workers and the loader.

- :class:`IoOptions`: one picklable struct of read-path knobs, handed from the reader
  factories (``io_options=``) to the workers (readahead, coalescing, the caches, the
  pass-through) and the executors (dispatch lookahead, work stealing).
- :mod:`.readahead`: a bounded per-process prefetcher; the next row-group reads run on
  a small IO thread pool while the current one decodes.
- :mod:`.coalesce`: adjacent row groups of one file queued together merge into one
  ranged read, sliced back apart.
- :mod:`.footercache`: each file's parsed footer, read once per process.
- :mod:`.memcache` and :mod:`.tiers`: the in-memory decoded-row-group LRU in front of
  the local-disk cache (:mod:`petastorm_tpu_torch.cache`), as one funnel with per-tier
  accounting.
- :mod:`.arena`: the host-wide shared-memory cache arena (``arena_bytes``) that every
  process of a host maps: decoded row groups, footers and page indexes, warmed once.
- :mod:`.remote` and :mod:`.latencyfs`: the object-store tier (parallel hedged ranged
  GETs, footer GETs, page-granular raw-chunk plans) and the cloud-latency simulator.
- :mod:`.staging` (the pinned H2D ring), :mod:`.pagedec` (the compressed-page
  pass-through's host half), :mod:`.statscache` (the feature pipelines' statistics),
  :mod:`.lease` (buffer leases).

The work-stealing dispatcher lives in :mod:`petastorm_tpu_torch.workers` and reads its
lookahead from the same ``IoOptions``. Every feature can be turned off on its own, and a
fallback counts a degradation (``parallel.shm_ring.degradation_counts()``).
"""
from __future__ import annotations

import os

from petastorm_tpu_torch.io.remote import RemoteIoOptions, _env_bool, _env_int


class IoOptions:
    """Knobs of the read path, with the JAX package's fields, defaults and env
    overrides:

    ==================  =========================  ==============================
    field               env var                    meaning
    ==================  =========================  ==============================
    readahead           PTPU_READAHEAD             prefetch the next row groups on
                                                   an IO thread pool (default on)
    readahead_depth     PTPU_READAHEAD_DEPTH       row-group reads in flight a
                                                   worker process (default 3)
    readahead_bytes     PTPU_READAHEAD_BYTES       byte budget of prefetched tables
                                                   awaiting use (256 MB; 0 = no cap)
    io_threads          PTPU_IO_THREADS            IO pool size (default 2)
    coalesce            PTPU_IO_COALESCE           merge adjacent queued row groups
                                                   into ranged reads (default on)
    coalesce_max_run    PTPU_IO_COALESCE_MAX_RUN   row groups a ranged read (4)
    work_stealing       PTPU_WORK_STEALING         idle workers steal claimed items
                                                   from busy peers (default on)
    memcache_bytes      PTPU_MEMCACHE_BYTES        in-memory decoded-row-group LRU
                                                   budget (0 = off, the default)
    memcache_writable_  PTPU_MEMCACHE_WRITABLE_    every memcache serve a writable
    hits                HITS                       deep copy (default off: zero-copy
                                                   read-only views)
    arena_bytes         PTPU_ARENA_BYTES           host-wide shared cache arena
                                                   budget (0 = off, the default;
                                                   ``PTPU_ARENA=off`` kills it)
    pagedec             PTPU_PAGEDEC               compressed-page pass-through:
                                                   "auto", "on" or "off" (default
                                                   ``off``, where the JAX package
                                                   defaults to ``auto``)
    remote              (see RemoteIoOptions)      the object-store tier's knobs: a
                                                   RemoteIoOptions or a dict
    ==================  =========================  ==============================

    ``pagedec``: ``auto`` engages for a batch reader that a :class:`DataLoader` on a
    CUDA device adopted (eligible fixed-width columns ship their raw snappy or
    uncompressed pages, which the loader inflates on the card); a reader with no
    loader, or whose loader runs on the CPU, reads classically. ``on`` forces it. ``off``
    is the default: on an H100 the pass-through does not beat the classic read on the
    stores measured (PERF.md).
    """

    __slots__ = ("readahead", "readahead_depth", "readahead_bytes", "io_threads",
                 "coalesce", "coalesce_max_run", "work_stealing", "memcache_bytes",
                 "memcache_writable_hits", "arena_bytes", "pagedec", "remote")

    def __init__(self, readahead=None, readahead_depth=None, readahead_bytes=None,
                 io_threads=None, coalesce=None, coalesce_max_run=None,
                 work_stealing=None, memcache_bytes=None,
                 memcache_writable_hits=None, arena_bytes=None, pagedec=None,
                 remote=None):
        self.readahead = _env_bool("PTPU_READAHEAD", True) \
            if readahead is None else bool(readahead)
        self.readahead_depth = max(1, _env_int("PTPU_READAHEAD_DEPTH", 3)
                                   if readahead_depth is None else int(readahead_depth))
        self.readahead_bytes = max(0, _env_int("PTPU_READAHEAD_BYTES", 256 << 20)
                                   if readahead_bytes is None else int(readahead_bytes))
        self.io_threads = max(1, _env_int("PTPU_IO_THREADS", 2)
                              if io_threads is None else int(io_threads))
        self.coalesce = _env_bool("PTPU_IO_COALESCE", True) \
            if coalesce is None else bool(coalesce)
        self.coalesce_max_run = max(1, _env_int("PTPU_IO_COALESCE_MAX_RUN", 4)
                                    if coalesce_max_run is None
                                    else int(coalesce_max_run))
        self.work_stealing = _env_bool("PTPU_WORK_STEALING", True) \
            if work_stealing is None else bool(work_stealing)
        self.memcache_bytes = max(0, _env_int("PTPU_MEMCACHE_BYTES", 0)
                                  if memcache_bytes is None else int(memcache_bytes))
        self.memcache_writable_hits = \
            _env_bool("PTPU_MEMCACHE_WRITABLE_HITS", False) \
            if memcache_writable_hits is None else bool(memcache_writable_hits)
        self.arena_bytes = max(0, _env_int("PTPU_ARENA_BYTES", 0)
                               if arena_bytes is None else int(arena_bytes))
        pagedec = (os.environ.get("PTPU_PAGEDEC") or "off").strip().lower() \
            if pagedec is None else str(pagedec).strip().lower()
        if pagedec not in ("auto", "on", "off"):
            raise ValueError("pagedec must be 'auto', 'on' or 'off'; got %r" % pagedec)
        self.pagedec = pagedec
        self.remote = RemoteIoOptions.normalize(remote)

    @classmethod
    def normalize(cls, value):
        """``None`` → defaults (env-aware), dict → kwargs, IoOptions → itself."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError("io_options must be an IoOptions, a dict of its fields, "
                        "or None; got %r" % type(value).__name__)

    @property
    def lookahead(self):
        """A worker's dispatch claim beyond its current item: how many upcoming plan
        items each worker holds (and prefetches). 0 when readahead is off: the
        dispatcher is then the plain shared pull queue."""
        return self.readahead_depth if self.readahead else 0

    def __getstate__(self):
        return {name: getattr(self, name) for name in self.__slots__}

    def __setstate__(self, state):
        for name in self.__slots__:
            # a pickle from an older IoOptions lacking a newer field keeps its default
            if name in state:
                setattr(self, name, state[name])
            else:
                setattr(self, name, getattr(type(self)(), name))

    def __repr__(self):
        return "IoOptions(%s)" % ", ".join(
            "%s=%r" % (name, getattr(self, name)) for name in self.__slots__)


# the read path's building blocks, re-exported at the package as in the JAX package
from petastorm_tpu_torch.io.coalesce import plan_runs, split_run_table  # noqa: E402,F401
from petastorm_tpu_torch.io.footercache import FooterCache  # noqa: E402,F401
from petastorm_tpu_torch.io.memcache import MemCache  # noqa: E402,F401
from petastorm_tpu_torch.io.readahead import ReadaheadPool  # noqa: E402,F401
from petastorm_tpu_torch.io.tiers import TieredCache  # noqa: E402,F401
