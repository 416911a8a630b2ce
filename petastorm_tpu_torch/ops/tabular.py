"""Declarative tabular preprocessing: feature pipelines for both targets.

Port of ``petastorm_tpu.ops.tabular``. An opaque ``TransformSpec`` callable cannot be
planned, fused, given statistics or moved to the device; this module replaces it with a
small **declarative op set** composed into a :class:`FeaturePipeline` that slots in
wherever a ``TransformSpec`` goes:

========================  ============================================================
op                        semantics
========================  ============================================================
:class:`Normalize`        ``(x - min) / (max - min)`` → float; min/max from
                          row-group statistics when omitted
:class:`Standardize`      ``(x - mean) / std`` → float; mean/std from one cached
                          streaming statistics pass when omitted
:class:`Clip`             ``clip(x, lo, hi)``, dtype preserved
:class:`Cast`             ``astype(dtype)``
:class:`FillNull`         NaN → ``value`` (numeric float columns)
:class:`Bucketize`        quantile/explicit boundaries → int bucket ids
:class:`HashField`        deterministic 32-bit FNV-1a hash → ``[0, num_buckets)``
:class:`VocabLookup`      categorical value → vocabulary index (OOV → ``default``)
:class:`FeatureCross`     hash-combine of N int columns → ``[0, num_buckets)``
========================  ============================================================

The planner (:meth:`FeaturePipeline.compile`) validates the op graph against the
Unischema, derives the post-transform schema by populating ``edit_fields`` so the stock
:func:`petastorm_tpu_torch.transform.transform_schema` applies unchanged, fuses adjacent
element-wise ops on the same column into one single-materialization pass, and compiles
to both execution targets:

- **host**: vectorized numpy kernels run inside the workers, columnar in and out, no
  pandas round trip. Untouched columns pass through as the original arrays; a mutated
  column is materialized once per fused stage (through ``LeasedBatch.writable()`` when
  the container is one).
- **device**: ``fn(batch) -> batch`` over torch tensors, applied by the
  :class:`~petastorm_tpu_torch.loader.DataLoader` on its device after transfer (the
  ``TransformSpec(device=True)`` seam). Every stage is a short chain of torch
  operations, as the JAX package's are ``jnp`` expressions (no custom kernel).

The device target follows the JAX package's device function, which runs with 64-bit
types off: 64-bit inputs are read as 32-bit (float64 → float32, int64 → its low word),
every result is at most 32 bits wide (a float64 result becomes float32, an int64 result
int32), ids are int32, ``Bucketize`` compares in float32 (the host target compares in
float64), and a float-to-integer conversion saturates with NaN → 0. Hash and cross
arithmetic is uint32 on both targets, computed on the device in int64 masked to 32 bits
after every multiply, so host and device produce identical ids.

Ops that need dataset statistics resolve them through
:mod:`petastorm_tpu_torch.io.statscache`. Per-fused-stage host timing is kept in plain
in-module counters (:func:`transform_op_stats`, :func:`transform_rows_total`).
"""
from __future__ import annotations

import threading
import time

import numpy as np

from petastorm_tpu_torch.obs import provenance as _prov
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.unischema import UnischemaField


class PipelineValidationError(ValueError):
    """An op graph that cannot run against the given Unischema (unknown field, dtype
    contract violation, unresolvable statistic). Raised at plan time, never from inside
    a worker."""


# --------------------------------------------------------------------------------------
# Statistics requirements
# --------------------------------------------------------------------------------------


class StatRequirement:
    """One statistic an op needs before it can compile: ``kind`` is one of
    ``min|max|mean|std|quantiles|vocab``, ``param`` carries the kind's knob (bucket
    count / vocab size). ``key`` is the stable identity used both for the
    resolved-statistics dict and the statscache fingerprint."""

    __slots__ = ("field", "kind", "param")

    def __init__(self, field, kind, param=None):
        self.field = field
        self.kind = kind
        self.param = param

    @property
    def key(self):
        if self.param is None:
            return "%s:%s" % (self.kind, self.field)
        return "%s:%s:%s" % (self.kind, self.field, self.param)

    def __repr__(self):
        return "<StatRequirement %s>" % self.key


# --------------------------------------------------------------------------------------
# Hashing primitive (host/device identical)
# --------------------------------------------------------------------------------------

_FNV_OFFSET = np.uint32(2166136261)
_FNV_PRIME = np.uint32(16777619)
_U32_MASK = 0xFFFFFFFF


def _hash_u32_host(arr, seed=0):
    """Vectorized FNV-1a-style 32-bit hash of an integer column. All arithmetic wraps in
    uint32: numerically identical to :func:`_hash_u32_device`, so a pipeline compiled to
    either target yields the same ids."""
    x = np.asarray(arr).astype(np.int64, copy=False).view(np.uint64)
    h = np.full(x.shape, _FNV_OFFSET ^ np.uint32(seed), dtype=np.uint32)
    for shift in (0, 8, 16, 24):
        byte = ((x >> np.uint64(shift)) & np.uint64(0xFF)).astype(np.uint32)
        h = (h ^ byte) * _FNV_PRIME  # uint32 multiply wraps mod 2**32
    return h


def _fnv_offset(seed):
    return int(_FNV_OFFSET) ^ (seed & _U32_MASK)


def _hash_u32_device(x, seed=0):
    """:func:`_hash_u32_host` on a tensor: the low 32 bits of each value (the reference's
    ``astype(int32).view(uint32)``), hashed in int64 with every product masked to 32
    bits (torch's uint32 lacks most operators). Returns int64 values in ``[0, 2**32)``.
    ``seed`` is an int, or a tensor of per-row offset bases (:func:`_fnv_offset` of each
    row's seed) that broadcasts against ``x``: a stacked group of columns hashes in one
    pass."""
    import torch

    if x.dtype != torch.int64:
        x = _cast_device(x, torch.int32)
    x = x.to(torch.int64) & _U32_MASK
    h = _fnv_offset(seed) if isinstance(seed, int) else seed
    prime = int(_FNV_PRIME)
    for shift in (0, 8, 16, 24):
        byte = (x >> shift) & 0xFF if shift else x & 0xFF
        h = ((h ^ byte) * prime) & _U32_MASK
    return h


def _crc32_table():
    """The standard reflected CRC-32 (IEEE 802.3) lookup table as uint32: byte for byte
    what ``zlib.crc32`` uses, so the vectorized sweep below is value-identical to the
    per-element loop."""
    poly = np.uint32(0xEDB88320)
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & np.uint32(1),
                         (table >> np.uint32(1)) ^ poly,
                         table >> np.uint32(1)).astype(np.uint32)
    return table


_CRC32_TABLE = _crc32_table()


def _encode_string_cell(v):
    """One cell's hash bytes. Object columns may carry non-string scalars (decimals, big
    ints); those hash by their repr: deterministic, never by-magnitude allocation."""
    if isinstance(v, str):
        return v.encode("utf-8")
    if isinstance(v, (bytes, bytearray, memoryview)):
        return bytes(v)
    if v is None:
        return b""
    return repr(v).encode("utf-8")


def _hash_strings_scalar(values, seed=0):
    """The per-element ``zlib.crc32`` loop: the identity oracle for the vectorized
    sweep, and the lane for every column the sweep declines."""
    import zlib

    out = np.empty(len(values), dtype=np.uint32)
    for i, v in enumerate(values):
        out[i] = zlib.crc32(_encode_string_cell(v), seed) & 0xFFFFFFFF
    return out


#: slicing-by-4 tables, built on first use (two merged 64K-entry uint32 tables =
#: 512 KB): T0..T3 are the standard slice tables (T0 = the classic byte table; T_{k+1}[b]
#: advances T_k[b] one zero byte), merged pairwise so one 16-bit gather covers two bytes:
#: a 4-byte word costs two gathers and a handful of elementwise passes instead of four
#: full byte rounds
_crc32_slice4 = None


def _crc32_slice4_tables():
    global _crc32_slice4
    if _crc32_slice4 is None:
        t0 = _CRC32_TABLE
        mask = np.uint32(0xFF)
        eight = np.uint32(8)
        t1 = t0[t0 & mask] ^ (t0 >> eight)
        t2 = t0[t1 & mask] ^ (t1 >> eight)
        t3 = t0[t2 & mask] ^ (t2 >> eight)
        i = np.arange(65536, dtype=np.uint32)
        lo = t3[i & mask] ^ t2[(i >> eight) & mask]      # bytes 0-1 of a word
        hi = t1[i & mask] ^ t0[(i >> eight) & mask]      # bytes 2-3
        _crc32_slice4 = (lo, hi)
    return _crc32_slice4


#: widest byte matrix the vectorized path accepts: beyond this the padding tax (every
#: row materialized at maxlen) outweighs the vectorization win and the C loop is faster
_MATRIX_HASH_MAX_WIDTH = 32


def _hash_strings_matrix(values, seed):
    """The byte-matrix fast lane, or ``None`` when ``values`` is ineligible
    (non-strings, non-ASCII, NUL-bearing, or wider than the padding budget).

    One ``np.asarray`` bulk-encodes the column into a UCS4 codepoint matrix; for
    all-ASCII content the uint8 view IS the utf-8 byte matrix. Rows are length-sorted so
    the still-active rows form a contiguous prefix at every position, then the CRC
    register advances column-wise: one slicing-by-4 step per 4-byte word column (two
    16-bit table gathers), plus up to three masked byte steps for the ragged tails.
    Values are bit-identical to ``zlib.crc32``."""
    n = len(values)
    try:
        arr = np.asarray(values)
    except Exception:  # noqa: BLE001 — exotic mixed input: scalar lane
        return None
    if arr.dtype.kind != "U" or arr.ndim != 1 or arr.dtype.itemsize == 0:
        return None
    maxlen = arr.dtype.itemsize // 4
    if maxlen > _MATRIX_HASH_MAX_WIDTH:
        return None
    cp = arr.view(np.uint32).reshape(n, maxlen)
    if (cp >= 128).any():
        return None  # non-ASCII: utf-8 bytes != codepoints
    lengths = np.count_nonzero(cp, axis=1)
    pylen = np.fromiter(map(len, values), dtype=np.intp, count=n)
    if not (lengths == pylen).all():
        return None  # embedded/trailing NULs: numpy 'U' storage is lossy
    init = np.uint32(seed & 0xFFFFFFFF) ^ np.uint32(0xFFFFFFFF)
    order = np.argsort(-lengths, kind="stable")
    bm = cp.astype(np.uint8)[order]
    pad = (-maxlen) % 4
    if pad:
        bm = np.concatenate([bm, np.zeros((n, pad), np.uint8)], axis=1)
    # column-contiguous word view: the sweep reads one word column per step
    wcol = np.ascontiguousarray(bm.view("<u4").T)
    sorted_lengths = lengths[order]
    full_words = sorted_lengths // 4
    word_steps = int(full_words[0]) if n else 0  # sorted: row 0 is longest
    # rows with full_words > w form a prefix (length-descending sort)
    alive = np.searchsorted(-full_words, -np.arange(word_steps), side="left")
    crc = np.full(n, init, dtype=np.uint32)
    tlo, thi = _crc32_slice4_tables()
    m16 = np.uint32(0xFFFF)
    s16 = np.uint32(16)
    for w in range(word_steps):
        k = alive[w]
        c = crc[:k]
        x = c ^ wcol[w][:k]
        crc[:k] = tlo[x & m16] ^ thi[(x >> s16) & m16]
    # ragged tails: per row, the len%4 bytes after its last full word, at most three
    # masked byte rounds (zero padding is never processed: the word sweep covers full
    # words only, so pad bytes stay untouched)
    tails = sorted_lengths % 4
    base = full_words * 4
    t0 = _CRC32_TABLE
    m8 = np.uint32(0xFF)
    s8 = np.uint32(8)
    for m in range(3):
        sel = np.nonzero(tails > m)[0]
        if not len(sel):
            break
        b = bm[sel, base[sel] + m].astype(np.uint32)
        c = crc[sel]
        crc[sel] = (c >> s8) ^ t0[(c ^ b) & m8]
    out = np.empty(n, dtype=np.uint32)
    out[order] = crc
    return out ^ np.uint32(0xFFFFFFFF)


def _hash_strings_host(values, seed=0):
    """crc32 of a string/bytes column: the all-ASCII short-string shape (id, category
    and email columns, the hot tabular case) takes the vectorized byte-matrix lane
    (:func:`_hash_strings_matrix`); everything else (non-ASCII, bytes, None/decimal
    cells, long-tail widths) takes the per-element C loop. Both lanes produce
    bit-identical ``zlib.crc32`` values, so the dispatch is invisible to pipelines."""
    n = len(values)
    if n == 0:
        return np.empty(0, dtype=np.uint32)
    out = _hash_strings_matrix(values, seed)
    if out is not None:
        return out
    return _hash_strings_scalar(values, seed)


# --------------------------------------------------------------------------------------
# Device dtypes (the JAX package's device function runs with 64-bit types off)
# --------------------------------------------------------------------------------------

#: the 32-bit type a 64-bit device value takes
_NARROW = {np.dtype(np.float64): np.dtype(np.float32),
           np.dtype(np.int64): np.dtype(np.int32)}


def _device_dtype(np_dtype):
    """The torch dtype of a device result declared as numpy ``np_dtype``, narrowed to
    32 bits."""
    import torch

    dt = np.dtype(np_dtype)
    return getattr(torch, _NARROW.get(dt, dt).name)


def _device_input(x):
    """A stage's input as the reference's device function sees it: float64 as float32,
    int64 as its low word."""
    import torch

    if x.dtype == torch.float64:
        return x.to(torch.float32)
    if x.dtype == torch.int64:
        return x.to(torch.int32)
    return x


def _cast_device(x, dtype):
    """``x.to(dtype)`` with XLA's float-to-integer conversion: it saturates at the
    integer type's bounds and maps NaN to 0 (torch's conversion is undefined out of
    range)."""
    import torch

    if x.is_floating_point() and not dtype.is_floating_point and dtype != torch.bool \
            and x.dtype != dtype:
        info = torch.iinfo(dtype)
        x = torch.nan_to_num(x.to(torch.float64), nan=0.0).clamp(info.min, info.max)
    return x.to(dtype)


# --------------------------------------------------------------------------------------
# The op set
# --------------------------------------------------------------------------------------


class Op:
    """Base declarative op. Subclasses declare:

    - ``elementwise``: fusable into a single-pass chain with its neighbors on the same
      column (the fused chain materializes ONE working array and every subsequent op
      runs in place on it).
    - :meth:`validate`: plan-time checks against the evolving field map.
    - :meth:`result_field`: the post-op :class:`UnischemaField` (None = field
      unchanged, e.g. ``Clip`` fused mid-chain).
    - :meth:`requirements`: the :class:`StatRequirement` list still unresolved (empty
      once parameters are explicit or bound).
    - :meth:`apply_inplace` / :meth:`apply`: host kernels; ``apply_device``: the torch
      expression for the device target.
    """

    elementwise = False
    name = "op"

    def __init__(self, field, out=None):
        self.field = field
        self.out = out or field

    def __getstate__(self):
        # device-resident tables are rebuilt where the op runs
        state = dict(self.__dict__)
        state.pop("_device_tables", None)
        return state

    def input_fields(self):
        return (self.field,)

    def validate(self, fields):
        f = fields.get(self.field)
        if f is None:
            raise PipelineValidationError(
                "%s: input field %r is not in the schema (known: %s)"
                % (type(self).__name__, self.field, sorted(fields)))
        return f

    def _require_numeric(self, f):
        if np.dtype(f.numpy_dtype).kind not in "biuf":
            raise PipelineValidationError(
                "%s: field %r has non-numeric dtype %s"
                % (type(self).__name__, f.name, np.dtype(f.numpy_dtype)))

    def result_field(self, fields):
        return None

    def requirements(self):
        return ()

    def bind(self, stats):
        """Fill statistics-derived parameters from the resolved ``stats`` dict (keyed
        by :attr:`StatRequirement.key`)."""

    def _device_table(self, name, values, device, dtype):
        """``values`` as a tensor of ``dtype`` on ``device``, uploaded once per
        (device, dtype) and kept on the op (a batch's ops then launch no copy)."""
        import torch

        tables = self.__dict__.setdefault("_device_tables", {})
        key = (name, str(device), dtype)
        t = tables.get(key)
        if t is None:
            t = tables[key] = torch.as_tensor(np.asarray(values)).to(dtype).to(device)
        return t

    def __repr__(self):
        return "%s(%r -> %r)" % (type(self).__name__, self.field, self.out)


class _ElementwiseOp(Op):
    """Numeric element-wise op: validated numeric, fused with neighbors."""

    elementwise = True
    #: dtype the fused chain must be working in for this op (None = keep)
    work_dtype = None

    def validate(self, fields):
        f = super().validate(fields)
        self._require_numeric(f)
        return f

    def apply_inplace(self, work):
        raise NotImplementedError

    def device_params(self):
        """The op's device parameters as Python numbers (empty for none): a stacked
        group (:class:`_DeviceGroup`) passes them to :meth:`_device_op` as per-row
        tensors instead."""
        return ()

    def _device_op(self, x, *params):
        raise NotImplementedError

    def apply_device(self, x):
        return self._device_op(x, *self.device_params())


class Normalize(_ElementwiseOp):
    """Min-max scale to ``[0, 1]``: ``(x - min) / (max - min)``. ``min``/``max``
    resolve from parquet row-group statistics when omitted (no data pre-pass needed
    when the footers cover the column)."""

    name = "normalize"

    def __init__(self, field, out=None, min=None, max=None, dtype=np.float32):
        super().__init__(field, out)
        self.min = min
        self.max = max
        self.dtype = np.dtype(dtype)
        if self.dtype.kind != "f":
            raise PipelineValidationError(
                "normalize(%r): output dtype must be floating, got %s"
                % (field, self.dtype))
        self.work_dtype = self.dtype

    def requirements(self):
        reqs = []
        if self.min is None:
            reqs.append(StatRequirement(self.field, "min"))
        if self.max is None:
            reqs.append(StatRequirement(self.field, "max"))
        return reqs

    def bind(self, stats):
        if self.min is None:
            self.min = stats["min:%s" % self.field]
        if self.max is None:
            self.max = stats["max:%s" % self.field]

    def result_field(self, fields):
        f = fields[self.field]
        return UnischemaField(self.out, self.dtype, f.shape, None, f.nullable)

    def _scale(self):
        span = float(self.max) - float(self.min)
        return 1.0 / span if span else 1.0

    def apply_inplace(self, work):
        work -= np.asarray(self.min, dtype=work.dtype)
        work *= np.asarray(self._scale(), dtype=work.dtype)

    def device_params(self):
        return (float(self.min), self._scale())

    def _device_op(self, x, lo, scale):
        return (x - lo) * scale


class Standardize(_ElementwiseOp):
    """Z-score: ``(x - mean) / std``. ``mean``/``std`` come from one cached streaming
    statistics pass when omitted."""

    name = "standardize"

    def __init__(self, field, out=None, mean=None, std=None, dtype=np.float32):
        super().__init__(field, out)
        self.mean = mean
        self.std = std
        self.dtype = np.dtype(dtype)
        if self.dtype.kind != "f":
            raise PipelineValidationError(
                "standardize(%r): output dtype must be floating, got %s"
                % (field, self.dtype))
        self.work_dtype = self.dtype

    def requirements(self):
        reqs = []
        if self.mean is None:
            reqs.append(StatRequirement(self.field, "mean"))
        if self.std is None:
            reqs.append(StatRequirement(self.field, "std"))
        return reqs

    def bind(self, stats):
        if self.mean is None:
            self.mean = stats["mean:%s" % self.field]
        if self.std is None:
            self.std = stats["std:%s" % self.field]

    def result_field(self, fields):
        f = fields[self.field]
        return UnischemaField(self.out, self.dtype, f.shape, None, f.nullable)

    def _inv_std(self):
        return 1.0 / float(self.std) if float(self.std) else 1.0

    def apply_inplace(self, work):
        work -= np.asarray(float(self.mean), dtype=work.dtype)
        work *= np.asarray(self._inv_std(), dtype=work.dtype)

    def device_params(self):
        return (float(self.mean), self._inv_std())

    def _device_op(self, x, mean, inv_std):
        return (x - mean) * inv_std


class Clip(_ElementwiseOp):
    """``clip(x, lo, hi)``: dtype preserved (fuses into whatever chain it sits in)."""

    name = "clip"

    def __init__(self, field, lo, hi, out=None):
        super().__init__(field, out)
        self.lo = lo
        self.hi = hi

    def result_field(self, fields):
        if self.out == self.field:
            return None  # in-place: dtype/shape unchanged
        f = fields[self.field]
        return UnischemaField(self.out, f.numpy_dtype, f.shape, None, f.nullable)

    def apply_inplace(self, work):
        np.clip(work, self.lo, self.hi, out=work)

    def device_params(self):
        return (self.lo, self.hi)

    def _device_op(self, x, lo, hi):
        import torch

        return torch.clamp(x, lo, hi)


class Cast(_ElementwiseOp):
    """``astype(dtype)``, folded into the fused chain's single materialization when
    adjacent to other element-wise ops."""

    name = "cast"

    def __init__(self, field, dtype, out=None):
        super().__init__(field, out)
        self.dtype = np.dtype(dtype)
        if self.dtype.kind not in "biuf":
            raise PipelineValidationError(
                "cast(%r): target dtype must be numeric/bool, got %s"
                % (field, self.dtype))
        self.work_dtype = self.dtype

    def result_field(self, fields):
        f = fields[self.field]
        return UnischemaField(self.out, self.dtype, f.shape, None, f.nullable)

    def apply_inplace(self, work):
        pass  # the chain already materialized into self.dtype

    def _device_op(self, x):
        return _cast_device(x, _device_dtype(self.dtype))


class FillNull(_ElementwiseOp):
    """NaN → ``value`` on float columns; the result field drops nullability."""

    name = "fill_null"

    def __init__(self, field, value, out=None):
        super().__init__(field, out)
        self.value = value

    def validate(self, fields):
        f = super().validate(fields)
        if np.dtype(f.numpy_dtype).kind != "f":
            raise PipelineValidationError(
                "fill_null(%r): only float columns carry NaN nulls on the columnar "
                "path; field dtype is %s (use Cast first, or encode nulls upstream)"
                % (self.field, np.dtype(f.numpy_dtype)))
        return f

    def result_field(self, fields):
        f = fields[self.field]
        return UnischemaField(self.out, f.numpy_dtype, f.shape, None, False)

    def apply_inplace(self, work):
        np.copyto(work, np.asarray(self.value, dtype=work.dtype), where=np.isnan(work))

    def device_params(self):
        return (self.value,)

    def _device_op(self, x, value):
        import torch

        # value: a Python scalar (no host-to-device copy a batch) or a per-row tensor
        return torch.where(torch.isnan(x), value, x)


class Bucketize(Op):
    """Value → bucket id via ``searchsorted`` over ``boundaries`` (or dataset quantiles
    when ``num_buckets`` is given instead). Output ids lie in ``[0, len(boundaries)]``,
    an **integer** field by contract."""

    name = "bucketize"

    def __init__(self, field, boundaries=None, num_buckets=None, out=None,
                 dtype=np.int32):
        super().__init__(field, out)
        if (boundaries is None) == (num_buckets is None):
            raise PipelineValidationError(
                "bucketize(%r): pass exactly one of boundaries= or num_buckets=" % field)
        self.boundaries = None if boundaries is None \
            else np.asarray(boundaries, dtype=np.float64)
        self.num_buckets = num_buckets
        self.dtype = np.dtype(dtype)
        if self.dtype.kind not in "iu":
            raise PipelineValidationError(
                "bucketize(%r): bucket ids need an integer output dtype, got %s"
                % (field, self.dtype))

    def validate(self, fields):
        f = super().validate(fields)
        self._require_numeric(f)
        return f

    def requirements(self):
        if self.boundaries is None:
            return [StatRequirement(self.field, "quantiles", self.num_buckets)]
        return ()

    def bind(self, stats):
        if self.boundaries is None:
            self.boundaries = np.asarray(
                stats["quantiles:%s:%s" % (self.field, self.num_buckets)],
                dtype=np.float64)

    def result_field(self, fields):
        f = fields[self.field]
        return UnischemaField(self.out, self.dtype, f.shape, None, False)

    def apply(self, col):
        return np.searchsorted(
            self.boundaries, np.asarray(col, dtype=np.float64),
            side="right").astype(self.dtype, copy=False)

    def apply_device(self, x):
        import torch

        # float32 on both sides, as the reference's device function compares
        bounds = self._device_table("boundaries", self.boundaries, x.device, torch.float32)
        return torch.searchsorted(bounds, x.to(torch.float32).contiguous(), right=True,
                                  out_int32=True)


class HashField(Op):
    """Deterministic 32-bit hash of a column into ``[0, num_buckets)``. Integer columns
    hash vectorized (identical ids on host and device); string/bytes columns take a
    crc32 (host only)."""

    name = "hash"

    def __init__(self, field, num_buckets, out=None, seed=0, dtype=np.int64):
        super().__init__(field, out)
        self.num_buckets = int(num_buckets)
        if self.num_buckets <= 0:
            raise PipelineValidationError("hash(%r): num_buckets must be positive" % field)
        self.seed = int(seed)
        self.dtype = np.dtype(dtype)
        if self.dtype.kind not in "iu":
            raise PipelineValidationError(
                "hash(%r): hashed ids need an integer output dtype, got %s"
                % (field, self.dtype))

    def validate(self, fields):
        f = super().validate(fields)
        kind = np.dtype(f.numpy_dtype).kind
        if kind not in "biuUSO":
            raise PipelineValidationError(
                "hash(%r): cannot hash dtype %s (integer or string columns only)"
                % (self.field, np.dtype(f.numpy_dtype)))
        return f

    def result_field(self, fields):
        f = fields[self.field]
        return UnischemaField(self.out, self.dtype, f.shape, None, False)

    def apply(self, col):
        arr = np.asarray(col)
        if arr.dtype.kind in "biu":
            h = _hash_u32_host(arr, self.seed)
        else:
            h = _hash_strings_host(arr.ravel().tolist(), self.seed).reshape(arr.shape)
        return (h % np.uint32(self.num_buckets)).astype(self.dtype, copy=False)

    def apply_device(self, x):
        import torch

        return (_hash_u32_device(x, self.seed) % self.num_buckets).to(torch.int32)


class VocabLookup(Op):
    """Categorical value → vocabulary index. An explicit ``vocab`` (sequence, index =
    position) or a computed one (``max_size`` most frequent values, frequency-descending,
    from the cached statistics pass). Out-of-vocabulary values map to ``default``."""

    name = "vocab"

    def __init__(self, field, vocab=None, max_size=None, out=None, default=-1,
                 dtype=np.int64):
        super().__init__(field, out)
        if (vocab is None) == (max_size is None):
            raise PipelineValidationError(
                "vocab(%r): pass exactly one of vocab= or max_size=" % field)
        self.vocab = None if vocab is None else list(vocab)
        self.max_size = max_size
        self.default = int(default)
        self.dtype = np.dtype(dtype)
        if self.dtype.kind not in "iu":
            raise PipelineValidationError(
                "vocab(%r): vocabulary indices need an integer output dtype, got %s"
                % (field, self.dtype))
        self._sorted = None
        self._order = None

    def requirements(self):
        if self.vocab is None:
            return [StatRequirement(self.field, "vocab", self.max_size)]
        return ()

    def bind(self, stats):
        if self.vocab is None:
            self.vocab = list(stats["vocab:%s:%s" % (self.field, self.max_size)])

    def result_field(self, fields):
        f = fields[self.field]
        return UnischemaField(self.out, self.dtype, f.shape, None, False)

    def _tables(self):
        if self._sorted is None:
            vocab = np.asarray(self.vocab)
            order = np.argsort(vocab, kind="stable")
            self._sorted = vocab[order]
            self._order = order.astype(np.int64)
        return self._sorted, self._order

    def apply(self, col):
        arr = np.asarray(col)
        svocab, order = self._tables()
        if svocab.dtype.kind in "US" and arr.dtype.kind not in "US":
            arr = arr.astype(svocab.dtype.kind)  # object str column → unicode
        idx = np.searchsorted(svocab, arr)
        idx = np.clip(idx, 0, len(svocab) - 1)
        hit = svocab[idx] == arr
        out = np.where(hit, order[idx], self.default)
        return out.astype(self.dtype, copy=False)

    def apply_device(self, x):
        import torch

        svocab, order = self._tables()
        if svocab.dtype.kind not in "biuf":
            raise PipelineValidationError(
                "vocab(%r): string vocabularies cannot run on the device target — hash "
                "the column instead, or keep the pipeline on the host" % self.field)
        # the table as the reference's device function holds it (narrowed to 32 bits),
        # then the table and the column meet in their promoted type, as
        # jnp.searchsorted promotes both sides
        narrowed = svocab.astype(_NARROW.get(svocab.dtype, svocab.dtype))
        common = torch.promote_types(_device_dtype(narrowed.dtype), x.dtype)
        sv = self._device_table("vocab", narrowed, x.device, common)
        x = x.to(common).contiguous()
        idx = torch.searchsorted(sv, x).clamp(0, len(svocab) - 1)
        positions = self._device_table("order", order, x.device, torch.int32)
        return positions[idx].masked_fill(sv[idx] != x, self.default)


class FeatureCross(Op):
    """Hash-combine N integer (or previously hashed) columns into one crossed id in
    ``[0, num_buckets)``: uint32 arithmetic, host/device identical."""

    name = "cross"

    def __init__(self, fields, num_buckets, out, seed=0, dtype=np.int64):
        if not fields or len(fields) < 2:
            raise PipelineValidationError(
                "cross: needs at least two input fields, got %r" % (fields,))
        super().__init__(fields[0], out)
        self.fields = tuple(fields)
        self.num_buckets = int(num_buckets)
        self.seed = int(seed)
        self.dtype = np.dtype(dtype)
        if self.dtype.kind not in "iu":
            raise PipelineValidationError(
                "cross%r: crossed ids need an integer output dtype, got %s"
                % (tuple(fields), self.dtype))

    def input_fields(self):
        return self.fields

    def validate(self, fields):
        for name in self.fields:
            f = fields.get(name)
            if f is None:
                raise PipelineValidationError(
                    "cross: input field %r is not in the schema (known: %s)"
                    % (name, sorted(fields)))
            if np.dtype(f.numpy_dtype).kind not in "biu":
                raise PipelineValidationError(
                    "cross: field %r has dtype %s — cross integer columns (HashField "
                    "string columns first)" % (name, np.dtype(f.numpy_dtype)))
        return fields[self.fields[0]]

    def result_field(self, fields):
        f = fields[self.fields[0]]
        return UnischemaField(self.out, self.dtype, f.shape, None, False)

    def apply_multi(self, cols):
        h = _hash_u32_host(cols[0], self.seed)
        for col in cols[1:]:
            h = (h * _FNV_PRIME) ^ _hash_u32_host(col, self.seed)
        return (h % np.uint32(self.num_buckets)).astype(self.dtype, copy=False)

    def apply_device_multi(self, cols):
        import torch

        cols = [_cast_device(c, torch.int32) for c in cols]  # the hash reads the low word
        if all(c.shape == cols[0].shape for c in cols):
            hashed = _hash_u32_device(torch.stack(cols), self.seed).unbind(0)  # one pass
        else:
            hashed = [_hash_u32_device(c, self.seed) for c in cols]
        h = hashed[0]
        prime = int(_FNV_PRIME)
        for part in hashed[1:]:
            h = ((h * prime) & _U32_MASK) ^ part
        return (h % self.num_buckets).to(torch.int32)


# --------------------------------------------------------------------------------------
# Per-stage host timing
# --------------------------------------------------------------------------------------

_stats_lock = threading.Lock()
_op_seconds = {}  # fused-stage label -> [observations, seconds]
_rows = [0]


def _record_stage(label, t0):
    """One run of a fused stage that started at ``t0`` (``perf_counter``): its seconds
    into the per-label totals, and a ``transform.<label>`` span onto the calling item's
    provenance record (nested in the worker's ``transform`` span)."""
    seconds = time.perf_counter() - t0
    with _stats_lock:
        entry = _op_seconds.setdefault(label, [0, 0.0])
        entry[0] += 1
        entry[1] += seconds
    if _prov.ACTIVE is not None:
        _prov.add_span("transform.%s" % label, t0, seconds)


def _count_rows(n):
    with _stats_lock:
        _rows[0] += n


def transform_op_stats():
    """``{fused-stage label: {"count": stage runs, "sum": seconds}}`` of the host target
    in THIS process (thread and dummy pools; process-pool children keep their own)."""
    with _stats_lock:
        return {label: {"count": n, "sum": s} for label, (n, s) in _op_seconds.items()
                if n}


def transform_rows_total():
    """Rows through the host target in this process."""
    with _stats_lock:
        return _rows[0]


# --------------------------------------------------------------------------------------
# Compiled plan stages
# --------------------------------------------------------------------------------------


class _FusedStage:
    """A maximal run of adjacent element-wise ops on ONE column, compiled to a
    single-materialization pass: the working array is created once (``astype``, or the
    lease copy-on-write when the container offers ``writable`` and the dtype already
    matches) and every op mutates it in place."""

    def __init__(self, ops, source, out, out_dtype):
        self.ops = list(ops)
        self.source = source
        self.out = out
        self.out_dtype = out_dtype
        self.label = "+".join(op.name for op in self.ops)

    def inputs(self):
        return (self.source,)

    def apply(self, container):
        col = container[self.source]
        col = np.asarray(col)
        if self.out == self.source and col.dtype == self.out_dtype \
                and hasattr(container, "writable"):
            # in-place rewrite of a leased column: ONE copy (counted as lease_cow),
            # untouched columns stay zero-copy views
            work = container.writable(self.source)
        else:
            work = col.astype(self.out_dtype)  # the single materialization
            if not work.flags.writeable or work.base is not None:
                work = np.array(work)  # same-dtype astype may return a view
        for op in self.ops:
            op.apply_inplace(work)
        return work

    def apply_device(self, batch):
        x = _device_input(batch[self.source])
        for op in self.ops:
            x = op.apply_device(x)
        if self.out_dtype is not None:
            x = _cast_device(x, _device_dtype(self.out_dtype))
        return x


class _OpStage:
    """A non-fusable op (bucketize/hash/vocab/cross) as its own stage."""

    def __init__(self, op):
        self.op = op
        self.out = op.out
        self.label = op.name

    def inputs(self):
        return tuple(op_inputs(self.op))

    def apply(self, container):
        if isinstance(self.op, FeatureCross):
            return self.op.apply_multi([np.asarray(container[n]) for n in self.op.fields])
        return self.op.apply(container[self.op.field])

    def apply_device(self, batch):
        if isinstance(self.op, FeatureCross):
            return self.op.apply_device_multi([_device_input(batch[n])
                                               for n in self.op.fields])
        return self.op.apply_device(_device_input(batch[self.op.field]))


def op_inputs(op):
    return op.input_fields()


_STACKABLE = (Normalize, Standardize, Clip, FillNull, Cast)


def _stack_key(stage):
    """What a stage must share with its neighbours to run in one :class:`_DeviceGroup`,
    or None when it runs alone."""
    if isinstance(stage, _OpStage):
        return ("hash",) if type(stage.op) is HashField else None
    if not all(type(op) in _STACKABLE for op in stage.ops) \
            or any(p is None for op in stage.ops for p in op.device_params()):
        return None
    return ("chain", tuple((type(op), getattr(op, "dtype", None)) for op in stage.ops),
            np.dtype(stage.out_dtype))


def _device_groups(plan):
    """The plan cut into :class:`_DeviceGroup` runs: consecutive stages of one stack key,
    none reading or writing what another stage of the run writes."""
    groups, run, written = [], [], set()
    for stage in plan:
        key = _stack_key(stage)
        if run and key is not None and key == _stack_key(run[-1]) \
                and not (set(stage.inputs()) | {stage.out}) & written:
            run.append(stage)
            written.add(stage.out)
            continue
        if run:
            groups.append(_DeviceGroup(run))
        run, written = [stage], {stage.out}
    if run:
        groups.append(_DeviceGroup(run))
    return groups


class _DeviceGroup:
    """Consecutive plan stages that the device function runs as one stacked computation:
    ``HashField`` stages, or fused chains of the same element-wise ops, none reading
    what another writes. Their inputs stack into one tensor (a row a stage) and each
    op's parameters become per-row tensors, so the group launches each operation once
    instead of once a stage. The values are those of the stages run one by one: the
    same uint32 hash, and the same float32 operations with each parameter rounded to
    float32 as a Python scalar is (chains stack only float32 inputs)."""

    def __init__(self, stages):
        self.stages = list(stages)
        self._tables = {}

    def __getstate__(self):
        # device-resident parameters are rebuilt where the pipeline runs
        state = dict(self.__dict__)
        state["_tables"] = {}
        return state

    def _rows(self, key, values, like, dtype):
        """``values`` (one a stage) as a tensor broadcasting against ``like``'s rows,
        uploaded once per device."""
        import torch

        cache = (key, str(like.device), dtype, like.dim())
        t = self._tables.get(cache)
        if t is None:
            t = torch.tensor(values, dtype=dtype).view((-1,) + (1,) * (like.dim() - 1))
            t = self._tables[cache] = t.to(like.device)
        return t

    def apply_device(self, batch):
        """``{output: tensor}`` of every stage of the group."""
        import torch

        stages = self.stages
        if len(stages) == 1:
            return {stages[0].out: stages[0].apply_device(batch)}
        hashing = isinstance(stages[0], _OpStage)
        if hashing:
            xs = [_cast_device(_device_input(batch[s.op.field]), torch.int32)
                  for s in stages]
        else:
            xs = [_device_input(batch[s.source]) for s in stages]
        if any(x.shape != xs[0].shape or x.dtype != xs[0].dtype for x in xs) \
                or not (hashing or xs[0].dtype == torch.float32):
            return {s.out: s.apply_device(batch) for s in stages}
        x = torch.stack(xs)
        if hashing:
            offsets = self._rows("offsets", [_fnv_offset(s.op.seed) for s in stages], x,
                                 torch.int64)
            buckets = self._rows("buckets", [s.op.num_buckets for s in stages], x,
                                 torch.int64)
            x = (_hash_u32_device(x, offsets) % buckets).to(torch.int32)
        else:
            for i, op in enumerate(stages[0].ops):
                params = [self._rows((i, j), [s.ops[i].device_params()[j] for s in stages],
                                     x, x.dtype)
                          for j in range(len(op.device_params()))]
                x = op._device_op(x, *params)
            x = _cast_device(x, _device_dtype(stages[0].out_dtype))
        return {s.out: x[j] for j, s in enumerate(stages)}


# --------------------------------------------------------------------------------------
# FeaturePipeline
# --------------------------------------------------------------------------------------


class FeaturePipeline(TransformSpec):
    """A declarative transform: an ordered list of ops, planned and compiled against the
    read schema. Slots in anywhere a :class:`TransformSpec` does
    (``make_reader``/``make_batch_reader`` ``transform_spec=``); the reader factories
    call :meth:`compile` after resolving the read schema and any dataset statistics, and
    :func:`petastorm_tpu_torch.transform.transform_schema` then consumes the derived
    ``edit_fields``/``removed_fields`` unchanged.

    ``device=True`` compiles the SAME op list to ``fn(batch) -> batch`` over torch
    tensors, which the DataLoader applies on its device after transfer.
    """

    declarative = True  # the marker the read path branches on (transform.py)

    def __init__(self, ops, selected_fields=None, removed_fields=None, device=False):
        super().__init__(func=None, edit_fields=None, removed_fields=removed_fields,
                         selected_fields=selected_fields, device=device)
        self.ops = list(ops)
        for op in self.ops:
            if not isinstance(op, Op):
                raise PipelineValidationError(
                    "FeaturePipeline ops must be tabular Op instances; got %r" % (op,))
        self.compiled = False
        self._plan = []
        self._device_plan = []  # the plan in stacked device groups (_device_groups)
        #: requirement key -> "rowgroup-stats" | "data-pass" | "cached": how each
        #: statistic was resolved
        self.stats_info = {}

    # -- planning -----------------------------------------------------------------------

    def required_statistics(self, schema):
        """Unresolved :class:`StatRequirement` list, validated against ``schema``.
        Statistics are computed over STORED columns, so an op whose stat input was
        already written by an EARLIER op (renamed or transformed in place: stored-column
        statistics no longer describe the runtime values) must carry explicit
        parameters."""
        written = set()
        reqs = []
        for op in self.ops:
            for req in op.requirements():
                if req.field in written:
                    raise PipelineValidationError(
                        "%s(%r): statistics-dependent parameters on a field an earlier "
                        "op already transformed cannot be computed from the stored "
                        "dataset — pass them explicitly" % (type(op).__name__, req.field))
                if req.field not in schema.fields:
                    raise PipelineValidationError(
                        "%s: input field %r is not in the schema (known: %s)"
                        % (type(op).__name__, req.field, sorted(schema.fields)))
                reqs.append(req)
            written.add(op.out)
        return reqs

    def compile(self, schema, statistics=None):
        """Validate the op graph against ``schema``, bind resolved ``statistics``,
        derive the post-transform schema edits, and fuse the plan. Idempotent; raises
        :class:`PipelineValidationError` on any contract violation."""
        statistics = statistics or {}
        fields = dict(schema.fields)
        edits = []
        for op in self.ops:
            missing = [r.key for r in op.requirements() if r.key not in statistics]
            if missing:
                raise PipelineValidationError(
                    "%s(%r): unresolved statistics %s — compile through the reader "
                    "factories (which run the statistics pass), or pass the parameters "
                    "explicitly" % (type(op).__name__, op.field, missing))
            op.bind(statistics)
            op.validate(fields)
            new_field = op.result_field(fields)
            if new_field is not None:
                fields[new_field.name] = new_field
                edits.append(new_field)
        for removed in self.removed_fields:
            if removed not in fields:
                raise PipelineValidationError(
                    "removed_fields names %r, which is not a schema or derived field"
                    % removed)
        if self.selected_fields is not None:
            missing = set(self.selected_fields) - set(fields)
            if missing:
                raise PipelineValidationError(
                    "selected_fields %r not present after the pipeline" % sorted(missing))
        # last edit per name wins (same contract as transform_schema's dict)
        by_name = {f.name: f for f in edits}
        self.edit_fields = list(by_name.values())
        self._plan = self._fuse(schema)
        self._device_plan = _device_groups(self._plan)
        self.func = self._device_call if self.device else self._host_call
        self.compiled = True
        return self

    def _fuse(self, schema):
        """Adjacent element-wise ops chained on the same column collapse into one
        :class:`_FusedStage` (op N+1 reads op N's output): one materialization, the rest
        in place.

        A chain runs entirely in ONE working dtype (set by its first dtype-declaring op,
        or the column's dtype); an op that needs a DIFFERENT working dtype ends the chain
        and starts a new one, so the fused semantics always equal the unfused sequence:
        in particular ``Standardize → Cast(int)`` must not run the float math in integer
        arithmetic."""
        plan = []
        run = []           # accumulating elementwise ops
        run_source = None
        run_dtype = None   # the chain's working (= materialization) dtype
        dtypes = {name: np.dtype(f.numpy_dtype) for name, f in schema.fields.items()}

        def flush():
            nonlocal run_dtype
            if not run:
                return
            out_dtype = run_dtype if run_dtype is not None else np.dtype(np.float64)
            plan.append(_FusedStage(run[:], run_source, run[-1].out, out_dtype))
            dtypes[run[-1].out] = out_dtype
            run.clear()
            run_dtype = None

        for op in self.ops:
            if op.elementwise:
                want = None if op.work_dtype is None else np.dtype(op.work_dtype)
                # only an IN-PLACE op (out == field) may extend a chain: a mid-chain
                # rename would fuse away an intermediate output the derived schema
                # declares
                if run and op.field == run[-1].out and op.out == op.field \
                        and (want is None or want == run_dtype):
                    run.append(op)        # extends the chain in place
                    continue
                flush()
                run.append(op)
                run_source = op.field
                run_dtype = want if want is not None else dtypes.get(op.field)
            else:
                flush()
                plan.append(_OpStage(op))
                dtypes[op.out] = op.dtype
        flush()
        return plan

    # -- execution ----------------------------------------------------------------------

    def _finalize(self, result):
        if self.selected_fields is not None:
            if hasattr(result, "writable"):
                # lease container: subset in place so the leases stay attached
                for name in list(result.keys()):
                    if name not in self.selected_fields:
                        result.pop(name)
                return result
            return {name: result[name] for name in self.selected_fields}
        for removed in self.removed_fields:
            result.pop(removed, None)
        return result

    def apply_columns(self, columns):
        """Host target: columnar batch in, columnar batch out. Untouched columns pass
        through as the original (possibly read-only) arrays; each fused stage
        materializes exactly one working array. A
        :class:`~petastorm_tpu_torch.io.lease.LeasedBatch` input is transformed in its
        own container (outputs set alongside the leased views, mutated columns escalated
        per column via ``writable()``) so its leases keep protecting the untouched
        columns."""
        if not self.compiled:
            raise PipelineValidationError(
                "FeaturePipeline was not compiled — open it through "
                "make_reader/make_batch_reader, or call compile(schema)")
        result = columns if hasattr(columns, "writable") else dict(columns.items())
        if not self._plan:
            return self._finalize(result)
        rows = None
        for stage in self._plan:
            t0 = time.perf_counter()
            out = stage.apply(result)
            result[stage.out] = out
            _record_stage(stage.label, t0)
            if rows is None:
                rows = len(out) if hasattr(out, "__len__") else 0
        if rows:
            _count_rows(rows)
        return self._finalize(result)

    def apply_rows(self, rows):
        """Per-row-path host target: the row dicts are columnarized ONCE, the compiled
        columnar kernels run over the whole row group, and fresh row dicts are rebuilt
        (in place of a ``func(dict(r))`` loop per row)."""
        if not rows or not self._plan:
            return [self._finalize(dict(r)) for r in rows]
        available = set(rows[0].keys())
        needed = set()
        for stage in self._plan:
            needed.update(n for n in stage.inputs() if n in available)
        merged = {}
        for name in needed:
            values = [r.get(name) for r in rows]
            try:
                merged[name] = np.asarray(values)
            except (ValueError, TypeError):
                arr = np.empty(len(values), dtype=object)
                arr[:] = values
                merged[name] = arr
        out_cols = {}
        for stage in self._plan:
            t0 = time.perf_counter()
            out = stage.apply(merged)
            merged[stage.out] = out
            out_cols[stage.out] = out
            _record_stage(stage.label, t0)
        _count_rows(len(rows))
        new_rows = []
        for i, r in enumerate(rows):
            nr = dict(r)
            for name, col in out_cols.items():
                nr[name] = col[i]
            if self.selected_fields is not None:
                nr = {name: nr[name] for name in self.selected_fields}
            else:
                for removed in self.removed_fields:
                    nr.pop(removed, None)
            new_rows.append(nr)
        return new_rows

    def _host_call(self, columns):
        """``TransformSpec.func`` shape for the host target (a bound method: it pickles
        with the pipeline, so process-pool workers carry it)."""
        return self.apply_columns(columns)

    def _device_call(self, batch):
        """The device function (``TransformSpec(device=True)`` seam): every stage is
        torch operations over the batch dict's tensors, on their device and the caller's
        stream."""
        result = dict(batch)
        for group in self._device_plan:
            result.update(group.apply_device(result))
        return self._finalize(result)

    def device_fn(self, schema):
        """Compile (if needed) and return the device function: the hook
        :class:`petastorm_tpu_torch.loader.DataLoader` uses when a pipeline is passed
        directly as ``device_transform=``."""
        if not self.compiled:
            reqs = self.required_statistics(schema)
            if reqs:
                raise PipelineValidationError(
                    "device pipeline needs dataset statistics %s — open the reader with "
                    "transform_spec=FeaturePipeline(..., device=True) so the factory "
                    "resolves them, or compile it with resolve_statistics' result"
                    % [r.key for r in reqs])
            self.compile(schema)
        return self._device_call

    def __repr__(self):
        return "FeaturePipeline(%s%s)" % (
            ", ".join(repr(op) for op in self.ops), ", device=True" if self.device else "")
