"""NGram windowing: sliding windows over timestamp-sorted rows within a row group.

Port of ``petastorm_tpu.ngram`` (numpy only, the same public names): ``NGram`` (``fields``
dict offset→field-list, ``delta_threshold``, ``timestamp_field``, ``timestamp_overlap``;
``form_ngram``, ``get_field_names_at_timestep``, ``resolve_regex_field_names``) gives
windowed consecutive-row samples for sequence and video models, with a timestamp-delta
validity constraint. Window validity is computed vectorized over the whole row group
(:func:`valid_window_starts`, one numpy pass), and the same helper serves the batch path,
which windows whole row groups by index gathers (:func:`form_ngram_columns`). Timestamps
stay numpy on the host; only the windows' columns reach the card.
"""
from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.unischema import UnischemaField


class NGram:
    def __init__(self, fields, delta_threshold, timestamp_field, timestamp_overlap=True):
        """``fields``: {offset: [UnischemaField | name | regex]}; offsets must be consecutive
        integers. ``delta_threshold``: max timestamp delta between consecutive window rows.
        ``timestamp_field``: field (or name) rows are ordered by. ``timestamp_overlap=False``
        yields only windows whose timestamp spans do not overlap.
        """
        if not fields:
            raise ValueError("NGram fields must be a non-empty dict of offset -> field list")
        offsets = sorted(fields.keys())
        if offsets != list(range(offsets[0], offsets[-1] + 1)):
            raise ValueError("NGram offsets must be consecutive integers, got %r" % offsets)
        self._fields = {k: list(v) for k, v in fields.items()}
        self._delta_threshold = delta_threshold
        self._timestamp_field = timestamp_field
        self._timestamp_overlap = timestamp_overlap

    @property
    def fields(self):
        return self._fields

    @property
    def length(self):
        return max(self._fields) - min(self._fields) + 1

    @property
    def delta_threshold(self):
        return self._delta_threshold

    @property
    def timestamp_field_name(self):
        ts = self._timestamp_field
        return ts.name if isinstance(ts, UnischemaField) else ts

    @property
    def timestamp_overlap(self):
        return self._timestamp_overlap

    def resolve_regex_field_names(self, schema):
        """Expand name/regex entries in ``fields`` against a schema (reference API)."""
        from petastorm_tpu_torch.unischema import match_unischema_fields

        resolved = {}
        for offset, entries in self._fields.items():
            out = []
            for entry in entries:
                if isinstance(entry, UnischemaField):
                    out.append(entry)
                else:
                    matched = match_unischema_fields(schema, [entry])
                    if not matched:
                        raise ValueError("NGram field selector %r matched nothing" % entry)
                    out.extend(matched)
            resolved[offset] = out
        self._fields = resolved
        return self

    def get_field_names_at_timestep(self, timestep):
        return [
            f.name if isinstance(f, UnischemaField) else f
            for f in self._fields.get(timestep, [])
        ]

    def get_all_field_names(self):
        names = []
        for offset in sorted(self._fields):
            for name in self.get_field_names_at_timestep(offset):
                if name not in names:
                    names.append(name)
        ts = self.timestamp_field_name
        if ts not in names:
            names.append(ts)
        return names

    def make_schema_view(self, schema):
        """Schema view covering every field any timestep needs + the timestamp field."""
        return schema.create_schema_view(self.get_all_field_names())

    # -- window math --------------------------------------------------------------------

    def form_ngram(self, data, schema):
        """``data``: list of decoded row dicts (one row group). Returns a list of
        {offset: row namedtuple} windows (reference ``form_ngram`` contract).
        """
        if len(data) < self.length:
            return []
        ts_name = self.timestamp_field_name
        timestamps = np.asarray([row[ts_name] for row in data])
        order = np.argsort(timestamps, kind="stable")
        sorted_rows = [data[i] for i in order]
        starts = valid_window_starts(
            timestamps[order], self.length, self._delta_threshold, self._timestamp_overlap
        )
        offsets = sorted(self._fields)
        # views depend only on the offset: build once, not per window (hot path)
        views = {
            offset: schema.create_schema_view(self.get_field_names_at_timestep(offset))
            for offset in offsets
        }
        ngrams = []
        for s in starts:
            window = {}
            for pos, offset in enumerate(offsets):
                row = sorted_rows[s + pos]
                view = views[offset]
                window[offset] = view.make_namedtuple(
                    **{name: row[name] for name in view.fields}
                )
            ngrams.append(window)
        return ngrams


def form_ngram_columns(columns, ngram):
    """Columnar windowing for the BATCH reader path: one row group's ``{name:
    column}`` → flat ``{'offset/name': column[order[starts + pos]]}`` window
    columns.

    Window assembly is one argsort of the timestamps plus one fancy-index gather per
    (offset, field), with no per-window Python, and the flat ``offset/field`` naming is
    the column convention the DataLoader delivers, so batches go straight to device
    tensors. The row count of every output column is the window count (one row == one
    window).

    Windows never span row groups (reference semantics: ``form_ngram`` runs per
    row group). Returns ``{}`` when the group is shorter than the window or no
    window satisfies ``delta_threshold``.
    """
    ts_name = ngram.timestamp_field_name
    ts = columns.get(ts_name)
    if ts is None:
        raise ValueError(
            "NGram timestamp field %r is not among the read columns" % ts_name)
    ts = np.asarray(ts)
    if len(ts) < ngram.length:
        return {}
    order = np.argsort(ts, kind="stable")
    starts = valid_window_starts(ts[order], ngram.length, ngram.delta_threshold,
                                 ngram.timestamp_overlap)
    if len(starts) == 0:
        return {}
    offsets = sorted(ngram.fields)
    out = {}
    for pos, offset in enumerate(offsets):
        idx = order[starts + pos]
        for name in ngram.get_field_names_at_timestep(offset):
            col = columns.get(name)
            if col is None:
                # as the per-row path, which raises when a requested field is absent:
                # dropping 'offset/name' silently would lose a feature column
                raise ValueError(
                    "NGram field %r (offset %d) is not among the batch columns "
                    "%s — was it removed by a transform_spec?"
                    % (name, offset, sorted(columns)))
            out["%d/%s" % (offset, name)] = col[idx]
    return out


def valid_window_starts(sorted_timestamps, length, delta_threshold, overlap=True):
    """Start indices of valid windows over sorted timestamps — vectorized.

    A window of ``length`` rows starting at i is valid iff every consecutive delta within it is
    <= ``delta_threshold``. With ``overlap=False``, greedily keep only windows whose row spans
    do not overlap previously kept windows.
    """
    n = len(sorted_timestamps)
    if n < length:
        return np.empty(0, dtype=np.int64)
    if length == 1:
        starts = np.arange(n)
    else:
        deltas = np.diff(np.asarray(sorted_timestamps))
        ok = (deltas <= delta_threshold).astype(np.int64)
        # window i valid iff ok[i:i+length-1] all 1 -> rolling sum == length-1
        csum = np.concatenate([[0], np.cumsum(ok)])
        win = csum[length - 1:] - csum[: n - length + 1]
        starts = np.nonzero(win == length - 1)[0]
    if overlap or len(starts) == 0:
        return starts
    kept = []
    next_free = -1
    for s in starts:
        if s > next_free:
            kept.append(s)
            next_free = s + length - 1
    return np.asarray(kept, dtype=np.int64)
