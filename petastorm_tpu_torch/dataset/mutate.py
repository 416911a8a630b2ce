"""Deterministic local-dataset mutations for chaos scenarios.

Port of ``petastorm_tpu.dataset.mutate``. :class:`LocalDatasetMutator` is the payload
the ``dataset.mutate`` chaos site hands to the ``remove_file``, ``rewrite_file`` and
``append_piece`` :class:`~petastorm_tpu_torch.chaos.FaultRule` actions: each action
calls the method of the same name with the rule's JSON ``target``, so a seeded
:class:`~petastorm_tpu_torch.chaos.FaultPlan` replays the same mutations at the same
watch ticks every run.

Targets are plain dicts (they survive the FaultRule JSON round trip):

- ``remove_file``: ``{"name": "part_003.parquet"}``
- ``rewrite_file``: ``{"name": "part_003.parquet", "start": 10**6, "rows": 64}``
  replaces the file atomically (write a temporary file, then ``os.replace``) with a new
  generation whose ``id`` column covers ``[start, start + rows)``
- ``append_piece``: the same spec, for a name that must be new; name appended files to
  sort after the existing ones (``part_zz0.parquet``), so ordinals keep their identity
  when a plan is rebuilt on resume

The default table is ``{id: int64, x: float64}`` from a seeded rng; ``table_fn(start,
rows)`` writes another schema. Local filesystems only: a test and benchmark utility.
"""
from __future__ import annotations

import os


class LocalDatasetMutator:
    """Applies deterministic file mutations under a local dataset root."""

    def __init__(self, root, seed=0, table_fn=None):
        self._root = str(root)
        self._seed = int(seed)
        self._table_fn = table_fn
        self._applied = []  # (action, name) in application order

    def _build_table(self, start, rows):
        if self._table_fn is not None:
            return self._table_fn(start, rows)
        import numpy as np
        import pyarrow as pa

        rng = np.random.default_rng(self._seed + int(start))
        return pa.table({
            "id": np.arange(start, start + rows, dtype=np.int64),
            "x": rng.random(int(rows)),
        })

    def _write(self, name, start, rows):
        import pyarrow.parquet as pq

        table = self._build_table(int(start), int(rows))
        full = os.path.join(self._root, name)
        tmp = full + ".tmp-mutate"
        pq.write_table(table, tmp, row_group_size=table.num_rows)
        os.replace(tmp, full)  # atomic: a reader sees the old bytes or the new ones

    # -- the chaos action surface -------------------------------------------------------

    def remove_file(self, target):
        name = target["name"] if isinstance(target, dict) else str(target)
        os.remove(os.path.join(self._root, name))
        self._applied.append(("remove_file", name))

    def rewrite_file(self, target):
        self._write(target["name"], target["start"], target["rows"])
        self._applied.append(("rewrite_file", target["name"]))

    def append_piece(self, target):
        full = os.path.join(self._root, target["name"])
        if os.path.exists(full):
            raise FileExistsError("append_piece target already exists: %s" % full)
        self._write(target["name"], target["start"], target["rows"])
        self._applied.append(("append_piece", target["name"]))

    @property
    def applied(self):
        """``[(action, name), ...]`` in application order."""
        return list(self._applied)
