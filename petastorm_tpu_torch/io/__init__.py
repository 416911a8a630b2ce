"""Host IO for the device path: the pinned H2D staging ring (:mod:`.staging`), the
compressed-page pass-through's host half (:mod:`.pagedec`), the feature pipelines'
statistics resolution (:mod:`.statscache`) and :class:`IoOptions`.

``IoOptions`` holds the read-path options of the JAX package's ``IoOptions``. Of them
the port has ``pagedec`` only; any other field raises ``NotImplementedError`` naming
its ROADMAP.md item.
"""
from __future__ import annotations

import os

from petastorm_tpu_torch._unported import not_ported

#: the JAX package's IoOptions fields the port does not have yet
_UNPORTED_FIELDS = ("readahead", "readahead_depth", "readahead_bytes", "io_threads",
                    "coalesce", "coalesce_max_run", "work_stealing", "memcache_bytes",
                    "memcache_writable_hits", "arena_bytes", "remote")


class IoOptions:
    """Read-path options. ``pagedec``: the compressed-page pass-through, ``"auto"``,
    ``"on"`` or ``"off"`` (default; env ``PTPU_PAGEDEC``).

    - ``auto`` engages for a batch reader that a :class:`DataLoader` on a CUDA device
      adopted: eligible fixed-width columns ship their raw snappy/uncompressed pages to
      the loader, which inflates them on the card. A reader with no loader, or one
      whose loader runs on the CPU, reads classically.
    - ``on`` forces the pass-through (the loader then inflates on the card, or with the
      host twin on the CPU).
    - ``off`` is the classic read, and the default, where the JAX package defaults to
      ``auto``: on an H100 the pass-through does not beat the classic read on the stores
      measured (PERF.md: on the Criteo-shaped store the two tie, and on the JPEG store
      ``auto`` is slower).
    """

    __slots__ = ("pagedec",)

    def __init__(self, pagedec=None, **others):
        for name, value in others.items():
            if name not in _UNPORTED_FIELDS:
                raise TypeError("IoOptions got an unknown field %r" % name)
            if value is not None:
                raise not_ported("IoOptions(%s=%r)" % (name, value), "io")
        pagedec = (os.environ.get("PTPU_PAGEDEC") or "off").strip().lower() \
            if pagedec is None else str(pagedec).strip().lower()
        if pagedec not in ("auto", "on", "off"):
            raise ValueError("pagedec must be 'auto', 'on' or 'off'; got %r" % pagedec)
        self.pagedec = pagedec

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

    def __repr__(self):
        return "IoOptions(pagedec=%r)" % self.pagedec
