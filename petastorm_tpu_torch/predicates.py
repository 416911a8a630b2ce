"""Row-level predicates evaluated in workers before full decode.

Port of ``petastorm_tpu.predicates`` (numpy only, copied): ``PredicateBase``,
``in_set``, ``in_intersection``, ``in_negate``, ``in_reduce``, ``in_lambda``,
``in_pseudorandom_split`` and ``implied_dnf_filters``. ``get_fields()`` declares the
columns a predicate needs so workers read only those columns first and fetch the others
only for matching rows; ``do_include_vectorized`` masks a whole column batch at once.
``in_pseudorandom_split._unit_hash`` is the JAX package's byte for byte, so a split
selects the same ids in both packages.
"""
from __future__ import annotations

import hashlib

import numpy as np


class PredicateBase:
    def get_fields(self):
        """Names of the fields this predicate reads."""
        raise NotImplementedError

    def do_include(self, values):
        """values: {field_name: value} for one row -> bool."""
        raise NotImplementedError

    def do_include_vectorized(self, columns):
        """columns: {field_name: np.ndarray} -> boolean mask. Default: per-row loop."""
        names = list(columns.keys())
        n = len(columns[names[0]]) if names else 0
        mask = np.empty(n, dtype=bool)
        for i in range(n):
            mask[i] = bool(self.do_include({name: columns[name][i] for name in names}))
        return mask


class in_set(PredicateBase):  # noqa: N801 - reference naming kept
    """True when the field value is in ``values``."""

    def __init__(self, values, predicate_field):
        self._values = set(values)
        self._field = predicate_field

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        return values[self._field] in self._values

    def do_include_vectorized(self, columns):
        return np.isin(columns[self._field], list(self._values))


class in_intersection(PredicateBase):  # noqa: N801
    """True when the field (a collection) intersects ``values``."""

    def __init__(self, values, predicate_field):
        self._values = set(values)
        self._field = predicate_field

    def get_fields(self):
        return {self._field}

    def do_include(self, values):
        return bool(self._values.intersection(values[self._field]))

    def do_include_vectorized(self, columns):
        # rows are ragged collections (object column); the per-row set intersection is
        # inherent, but skip the base class's per-row dict construction
        vals = self._values
        col = columns[self._field]
        return np.fromiter((bool(vals.intersection(v)) for v in col),
                           dtype=bool, count=len(col))


class in_negate(PredicateBase):  # noqa: N801
    def __init__(self, predicate):
        self._predicate = predicate

    def get_fields(self):
        return self._predicate.get_fields()

    def do_include(self, values):
        return not self._predicate.do_include(values)

    def do_include_vectorized(self, columns):
        return ~np.asarray(self._predicate.do_include_vectorized(columns), dtype=bool)


class in_reduce(PredicateBase):  # noqa: N801
    """Combine predicates with a reduction (e.g. ``all``/``any`` or numpy logical ops)."""

    def __init__(self, predicate_list, reduce_func):
        self._predicates = list(predicate_list)
        self._reduce_func = reduce_func

    def get_fields(self):
        fields = set()
        for p in self._predicates:
            fields |= set(p.get_fields())
        return fields

    def do_include(self, values):
        return self._reduce_func([p.do_include(values) for p in self._predicates])

    def do_include_vectorized(self, columns):
        masks = [np.asarray(p.do_include_vectorized(columns), dtype=bool)
                 for p in self._predicates]
        # The builtin all/any users pass for the per-row path are ambiguous over
        # arrays — translate them to their elementwise equivalents
        if self._reduce_func in (all, np.all):
            return np.logical_and.reduce(masks)
        if self._reduce_func in (any, np.any):
            return np.logical_or.reduce(masks)
        return np.asarray(self._reduce_func(masks), dtype=bool)


def implied_dnf_filters(predicate):
    """DNF filter clauses IMPLIED by ``predicate`` (predicate ⇒ clauses), or None.

    Used for plan-time pruning only: the reader conjoins these with any user
    ``filters`` so hive-partition and row-group-statistics pruning fire for the
    translatable predicate families too — ``in_set`` (→ ``in``), ``in_negate(in_set)``
    (→ ``not in``), and ``in_reduce`` over ``all``/``any``. The predicate itself still
    runs as the row-level mask, so an over-broad translation can never change
    results — untranslatable predicates (``in_lambda``, ``in_pseudorandom_split``,
    ``in_intersection``) just return None (no extra pruning). The reference prunes
    row groups for predicates only through prebuilt indexes (``rowgroup_selector``,
    petastorm/selectors.py ~L30); this derives the pruning automatically.

    Returns the OR-of-ANDs form ``[[(field, op, value-list), ...], ...]``.
    """
    if isinstance(predicate, in_set):
        return [[(predicate._field, "in", sorted(predicate._values, key=repr))]]
    if isinstance(predicate, in_negate):
        inner = predicate._predicate
        if isinstance(inner, in_set):
            return [[(inner._field, "not in", sorted(inner._values, key=repr))]]
        return None
    if isinstance(predicate, in_reduce):
        # Pruning is optional (the row mask carries correctness), so bail out rather
        # than let nested reduces cross-product into an exponential clause set.
        max_clauses = 64
        children = [implied_dnf_filters(p) for p in predicate._predicates]
        if predicate._reduce_func in (all, np.all, np.logical_and.reduce):
            # AND: untranslatable children drop out (a conjunct subset is still
            # implied); cross-product the survivors' or-clauses
            out = [[]]
            for c in children:
                if c is None:
                    continue
                out = [acc + clause for acc in out for clause in c]
                if len(out) > max_clauses:
                    return None
            return out if out != [[]] else None
        if predicate._reduce_func in (any, np.any, np.logical_or.reduce):
            # OR: every child must translate, else rows outside the union can match
            if any(c is None for c in children):
                return None
            out = [clause for c in children for clause in c]
            return out if len(out) <= max_clauses else None
        return None
    return None


class in_lambda(PredicateBase):  # noqa: N801
    """Arbitrary user function over declared fields (reference ~L90).

    ``func({field: value}) -> bool``; optional ``vectorized_func({field: array}) -> mask``.
    """

    def __init__(self, predicate_fields, func, vectorized_func=None):
        self._fields = list(predicate_fields)
        self._func = func
        self._vectorized_func = vectorized_func

    def get_fields(self):
        return set(self._fields)

    def do_include(self, values):
        return self._func(values)

    def do_include_vectorized(self, columns):
        if self._vectorized_func is not None:
            return np.asarray(self._vectorized_func(columns), dtype=bool)
        return super().do_include_vectorized(columns)


class in_pseudorandom_split(PredicateBase):  # noqa: N801
    """Deterministic hash-based train/val/test split (reference ~L140).

    ``fraction_list`` sums to <= 1; ``subset_index`` selects which band a row must hash into.
    The split is a pure function of the field value, so it is stable across runs and hosts.
    """

    def __init__(self, fraction_list, subset_index, predicate_field):
        if not 0 <= subset_index < len(fraction_list):
            raise ValueError("subset_index out of range")
        if sum(fraction_list) > 1.0 + 1e-9:
            raise ValueError("fractions must sum to <= 1")
        self._fractions = list(fraction_list)
        self._subset_index = subset_index
        self._field = predicate_field
        self._lo = sum(fraction_list[:subset_index])
        self._hi = self._lo + fraction_list[subset_index]

    def get_fields(self):
        return {self._field}

    @staticmethod
    def _unit_hash(value):
        digest = hashlib.md5(str(value).encode("utf-8")).hexdigest()[:8]
        return int(digest, 16) / float(0xFFFFFFFF)

    def do_include(self, values):
        u = self._unit_hash(values[self._field])
        return self._lo <= u < self._hi

    def do_include_vectorized(self, columns):
        """Hash each UNIQUE value once and map back through the inverse index — on
        categorical split keys (user ids etc.) this collapses the md5 loop to the
        distinct values; the md5 itself must stay per-value to keep split semantics
        identical to ``do_include``."""
        col = np.asarray(columns[self._field])
        try:
            uniq, inverse = np.unique(col, return_inverse=True)
        except TypeError:  # unorderable mixed objects
            uniq, inverse = col, np.arange(len(col))
        md5 = hashlib.md5
        # int.from_bytes(digest[:4]) == int(hexdigest[:8], 16): same unit interval value
        units = np.fromiter(
            (int.from_bytes(md5(str(v).encode("utf-8")).digest()[:4], "big")
             for v in uniq),
            dtype=np.uint32, count=len(uniq),
        ).astype(np.float64) / float(0xFFFFFFFF)
        mask = (self._lo <= units) & (units < self._hi)
        return mask[inverse]
