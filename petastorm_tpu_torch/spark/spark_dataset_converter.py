"""Spark DataFrame → torch / TF loaders over a materialized Parquet cache.

Port of ``petastorm_tpu.spark.spark_dataset_converter`` (reference
petastorm/spark/spark_dataset_converter.py: ``SparkDatasetConverter`` ~L120 with
``make_tf_dataset`` ~L200, ``make_torch_dataloader`` ~L300 and ``delete``;
``make_spark_converter`` ~L400 with its plan-hash cache, atexit cleanup and precision
normalization). In place of the JAX package's ``make_jax_dataloader`` the converter has
:meth:`SparkDatasetConverter.make_device_dataloader`, which returns the port's
:func:`petastorm_tpu_torch.loader.make_dataloader`: batches as tensors on the card.

pyspark is imported lazily; every entry point raises a clear error when it is absent and
the DataFrame does not speak the protocol the converter consumes (the pyarrow-native
path for the same workflow is :func:`petastorm_tpu_torch.metadata.write_dataset` and
``make_batch_reader``).
"""
from __future__ import annotations

import atexit
import hashlib
import logging
import posixpath
import threading
import uuid

logger = logging.getLogger(__name__)

_CACHE_DIR_CONF = "petastorm.spark.converter.parentCacheDirUrl"

_materialized: dict = {}  # cache key -> SparkDatasetConverter
_materialized_lock = threading.Lock()
_delete_handler = None


def _require_pyspark():
    try:
        import pyspark  # noqa: F401

        return pyspark
    except ImportError as e:
        raise ImportError(
            "petastorm_tpu_torch.spark requires pyspark, which is not installed. For a "
            "Spark-free equivalent workflow, write Parquet with "
            "petastorm_tpu_torch.metadata.write_dataset (or any Parquet writer) and read "
            "with make_batch_reader / petastorm_tpu_torch.loader.make_dataloader."
        ) from e


#: DataFrame protocol the converter consumes. Anything satisfying it works: a pyspark
#: DataFrame, a pyspark-connect proxy, or a duck-typed frame over real Parquet (the
#: fake-session contract tests).
_DATAFRAME_PROTOCOL = ("sparkSession", "schema", "write", "count")


def _require_pyspark_or_compatible(df):
    try:
        import pyspark  # noqa: F401

        return
    except ImportError:
        if all(hasattr(df, attr) for attr in _DATAFRAME_PROTOCOL):
            return  # duck-typed DataFrame: the converter only uses the protocol above
    _require_pyspark()


def register_delete_dir_handler(handler):
    """Override how cache dirs are deleted (reference ``register_delete_dir_handler``)."""
    global _delete_handler
    _delete_handler = handler


def _delete_dir(url):
    if _delete_handler is not None:
        _delete_handler(url)
        return
    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths

    fs, path = get_filesystem_and_path_or_paths(url)
    fs.delete_dir_contents(path, accept_root_dir=True, missing_dir_ok=True)
    try:
        fs.delete_dir(path)
    except Exception as e:  # noqa: BLE001 - already gone / root kept
        logger.debug("delete_dir(%s) after contents cleanup: %s", path, e)


class SparkDatasetConverter:
    """Handle to a materialized dataset: build torch and TF loaders over it.

    Reference contract kept: ``PARENT_CACHE_DIR_URL_CONF``, ``dataset_size``, context-manager
    loaders, ``delete()``.
    """

    PARENT_CACHE_DIR_URL_CONF = _CACHE_DIR_CONF

    def __init__(self, cache_dir_url, file_urls, dataset_size):
        self.cache_dir_url = cache_dir_url
        self.file_urls = file_urls
        self._dataset_size = dataset_size

    def __len__(self):
        return self._dataset_size

    # -- loader factories --------------------------------------------------------------

    def make_device_dataloader(self, batch_size=32, sharding=None, num_epochs=1,
                               shuffling_queue_capacity=0, *, device=None,
                               **reader_kwargs):
        """The port's loader over the materialized files: batches as tensors on the card
        (``device``, default CUDA; ``sharding`` as :class:`~petastorm_tpu_torch.loader.
        DataLoader`'s). The counterpart of the JAX package's ``make_jax_dataloader``; the
        reference has none."""
        from petastorm_tpu_torch.loader import make_dataloader

        return make_dataloader(self.file_urls, batch_size=batch_size, sharding=sharding,
                               num_epochs=num_epochs,
                               shuffling_queue_capacity=shuffling_queue_capacity,
                               device=device, **reader_kwargs)

    def make_torch_dataloader(self, batch_size=32, num_epochs=1,
                              shuffling_queue_capacity=0, cur_shard=None, shard_count=None,
                              **reader_kwargs):
        """Context manager yielding a torch ``BatchedDataLoader`` (reference ~L300)."""
        return _TorchDatasetContextManager(self.file_urls, batch_size, num_epochs,
                                           shuffling_queue_capacity, cur_shard,
                                           shard_count, reader_kwargs)

    def make_tf_dataset(self, batch_size=None, num_epochs=1, cur_shard=None,
                        shard_count=None, **reader_kwargs):
        """Context manager yielding a ``tf.data.Dataset`` (reference ~L200)."""
        return _TfDatasetContextManager(self.file_urls, batch_size, num_epochs,
                                        cur_shard, shard_count, reader_kwargs)

    def delete(self):
        """Delete the materialized cache dir and forget the cache entry."""
        with _materialized_lock:
            for key, conv in list(_materialized.items()):
                if conv is self:
                    del _materialized[key]
        _delete_dir(self.cache_dir_url)


class _TorchDatasetContextManager:
    def __init__(self, file_urls, batch_size, num_epochs, shuffling_queue_capacity,
                 cur_shard, shard_count, reader_kwargs):
        self._args = (file_urls, batch_size, num_epochs, shuffling_queue_capacity,
                      cur_shard, shard_count, reader_kwargs)
        self._loader = None

    def __enter__(self):
        from petastorm_tpu_torch.adapters.pytorch import BatchedDataLoader
        from petastorm_tpu_torch.reader import make_batch_reader

        (urls, batch_size, num_epochs, cap, cur_shard, shard_count, kw) = self._args
        reader = make_batch_reader(urls, num_epochs=num_epochs, cur_shard=cur_shard,
                                   shard_count=shard_count, **kw)
        self._loader = BatchedDataLoader(reader, batch_size=batch_size,
                                         shuffling_queue_capacity=cap)
        return self._loader

    def __exit__(self, exc_type, exc, tb):
        self._loader.stop()
        self._loader.join()


class _TfDatasetContextManager:
    def __init__(self, file_urls, batch_size, num_epochs, cur_shard, shard_count,
                 reader_kwargs):
        self._args = (file_urls, batch_size, num_epochs, cur_shard, shard_count,
                      reader_kwargs)
        self._reader = None

    def __enter__(self):
        from petastorm_tpu_torch.adapters.tf import make_petastorm_dataset
        from petastorm_tpu_torch.reader import make_batch_reader

        urls, batch_size, num_epochs, cur_shard, shard_count, kw = self._args
        self._reader = make_batch_reader(urls, num_epochs=num_epochs,
                                         cur_shard=cur_shard, shard_count=shard_count, **kw)
        ds = make_petastorm_dataset(self._reader)
        if batch_size:
            ds = ds.unbatch().batch(batch_size)
        return ds

    def __exit__(self, exc_type, exc, tb):
        self._reader.stop()
        self._reader.join()


def _normalize_precision(df, dtype):
    """float64→float32 (or as asked) normalization before materialization (reference).

    With pyspark absent, falls back to the protocol form: columns whose
    ``dataType.typeName()`` is the source type are re-cast via
    ``df.withColumn(name, df[name].cast(target_typename))`` — the exact calls a real
    DataFrame would see, so the fake-session contract tests assert them.
    """
    if dtype is None:
        return df
    target_name = {"float32": "float", "float64": "double"}[dtype]
    source_name = "double" if dtype == "float32" else "float"
    try:
        from pyspark.sql.functions import col
        from pyspark.sql.types import DoubleType, FloatType

        target = FloatType() if dtype == "float32" else DoubleType()
        source = DoubleType() if dtype == "float32" else FloatType()
        for field in df.schema.fields:
            if field.dataType == source:
                df = df.withColumn(field.name, col(field.name).cast(target))
        return df
    except ImportError:
        for field in df.schema.fields:
            type_name = getattr(field.dataType, "typeName", lambda: None)()
            if type_name == source_name:
                df = df.withColumn(field.name, df[field.name].cast(target_name))
        return df


def _df_plan_string(df):
    """Stable textual identity of the DataFrame's analyzed plan (cache key basis)."""
    jdf = getattr(df, "_jdf", None)
    if jdf is not None:
        try:
            return jdf.queryExecution().analyzed().toString()
        except Exception as e:  # noqa: BLE001 - connect/duck-typed frames:
            # fall through to the weaker identities, counted, since
            # a degraded cache key can silently re-materialize datasets
            from petastorm_tpu_torch.obs.log import degradation

            degradation("spark_plan_identity",
                        "DataFrame plan identity unavailable (%s); falling "
                        "back to semanticHash/schema cache keying", e)
    semantic_hash = getattr(df, "semanticHash", None)
    if callable(semantic_hash):
        return "semanticHash:%s" % semantic_hash()
    # No plan identity at all: schema alone is NOT content identity — two frames over
    # different data with equal schemas would share a cache entry and silently serve
    # the wrong materialized rows. Refuse instead.
    raise ValueError(
        "Cannot derive a cache identity for %r: it exposes neither _jdf (pyspark) nor "
        "semanticHash(). Implement semanticHash() on the DataFrame, or bypass the "
        "converter cache by materializing manually "
        "(petastorm_tpu_torch.metadata.write_dataset + make_batch_reader)." % type(df).__name__
    )


def _df_cache_key(df, parent_dir, compression_codec, dtype):
    plan = _df_plan_string(df)
    payload = "|".join([plan, parent_dir or "", compression_codec or "", dtype or ""])
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


def make_spark_converter(df, parquet_row_group_size_bytes=32 * 1024 * 1024,
                         compression_codec=None, dtype="float32"):
    """Materialize ``df`` under the configured parent cache dir and return a converter.

    Cache keyed by (analyzed plan, options): re-converting the same DataFrame reuses the
    materialized files (reference ``make_spark_converter`` ~L400).
    """
    _require_pyspark_or_compatible(df)
    spark = df.sparkSession
    parent = spark.conf.get(_CACHE_DIR_CONF, None)
    if not parent:
        raise ValueError(
            "Configure the parent cache dir first: spark.conf.set(%r, <dir url>)"
            % _CACHE_DIR_CONF
        )
    df = _normalize_precision(df, dtype)
    key = _df_cache_key(df, parent, compression_codec, dtype)
    with _materialized_lock:
        cached = _materialized.get(key)
    if cached is not None:
        return cached

    cache_dir_url = posixpath.join(parent, "%s" % uuid.uuid4().hex)
    writer = df.write.mode("overwrite") \
        .option("parquet.block.size", parquet_row_group_size_bytes)
    if compression_codec:
        writer = writer.option("compression", compression_codec)
    writer.parquet(cache_dir_url)

    from petastorm_tpu_torch.fs import get_filesystem_and_path_or_paths

    fs, path = get_filesystem_and_path_or_paths(cache_dir_url)
    from petastorm_tpu_torch.metadata import _list_parquet_files

    files = _list_parquet_files(fs, path)
    size = df.count()
    converter = SparkDatasetConverter(cache_dir_url, cache_dir_url, size)
    with _materialized_lock:
        _materialized[key] = converter
    atexit.register(_atexit_delete, converter)
    logger.info("Materialized %d rows to %s (%d files)", size, cache_dir_url, len(files))
    return converter


def _atexit_delete(converter):
    try:
        converter.delete()
    except Exception:  # noqa: BLE001 - best-effort GC at interpreter exit
        logger.warning("Failed to delete converter cache %s", converter.cache_dir_url)
