"""Spark converter API (port of ``petastorm_tpu.spark``; the reference's
petastorm/spark/__init__.py re-exports)."""

from petastorm_tpu_torch.spark.spark_dataset_converter import (  # noqa: F401
    SparkDatasetConverter,
    make_spark_converter,
    register_delete_dir_handler,
)
