"""Row-group selectors: prune row groups via prebuilt value→row-group indexes.

Port of ``petastorm_tpu.selectors`` (``RowGroupSelectorBase``, ``SingleIndexSelector``,
``IntersectIndexSelector``, ``UnionIndexSelector``). Selectors resolve against the indexes
:mod:`petastorm_tpu_torch.etl.rowgroup_indexing` builds, before any scheduling happens.
"""
from __future__ import annotations


class RowGroupSelectorBase:
    def get_index_names(self):
        """Names of the indexes this selector needs."""
        raise NotImplementedError

    def select_row_groups(self, index_dict):
        """index_dict: {index_name: RowGroupIndexBase} -> set of row-group piece ordinals."""
        raise NotImplementedError


class SingleIndexSelector(RowGroupSelectorBase):
    """Row groups containing any of ``values`` per one index (reference ~L30)."""

    def __init__(self, index_name, values):
        self._index_name = index_name
        self._values = list(values)

    def get_index_names(self):
        return [self._index_name]

    def select_row_groups(self, index_dict):
        indexer = index_dict.get(self._index_name)
        if indexer is None:
            raise ValueError("Dataset has no index named %r" % self._index_name)
        selected = set()
        for value in self._values:
            selected |= set(indexer.get_row_group_indexes(value))
        return selected


class IntersectIndexSelector(RowGroupSelectorBase):
    """Row groups selected by ALL child selectors."""

    def __init__(self, single_index_selectors):
        self._selectors = list(single_index_selectors)

    def get_index_names(self):
        names = []
        for s in self._selectors:
            names.extend(s.get_index_names())
        return names

    def select_row_groups(self, index_dict):
        sets = [s.select_row_groups(index_dict) for s in self._selectors]
        return set.intersection(*sets) if sets else set()


class UnionIndexSelector(RowGroupSelectorBase):
    """Row groups selected by ANY child selector."""

    def __init__(self, single_index_selectors):
        self._selectors = list(single_index_selectors)

    def get_index_names(self):
        names = []
        for s in self._selectors:
            names.extend(s.get_index_names())
        return names

    def select_row_groups(self, index_dict):
        selected = set()
        for s in self._selectors:
            selected |= s.select_row_groups(index_dict)
        return selected
