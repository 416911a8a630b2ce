"""Spark DataFrame → torch loaders via SparkDatasetConverter (reference
examples/spark_dataset_converter). Requires pyspark; without it the Spark-free
equivalent workflow (pyarrow write + make_dataloader) runs instead. The counterpart of
``examples/spark_dataset_converter/converter_example.py``."""
import argparse
import tempfile


def spark_path(device):
    from pyspark.sql import SparkSession

    from petastorm_tpu_torch.spark import SparkDatasetConverter, make_spark_converter

    spark = SparkSession.builder.master("local[2]").getOrCreate()
    spark.conf.set(SparkDatasetConverter.PARENT_CACHE_DIR_URL_CONF,
                   "file://" + tempfile.mkdtemp(prefix="converter_cache"))
    df = spark.range(1000).selectExpr("id", "rand() as feature")
    converter = make_spark_converter(df)
    print("materialized %d rows" % len(converter))
    with converter.make_torch_dataloader(batch_size=64) as loader:
        for batch in loader:
            print("torch batch:", {k: tuple(v.shape) for k, v in batch.items()})
            break
    loader = converter.make_device_dataloader(batch_size=64, device=device)
    with loader:
        for batch in loader:
            shapes = {k: tuple(v.shape) for k, v in batch.items()}
            print("device batch:", shapes)
            break
    converter.delete()
    return shapes


def arrow_fallback(device):
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.loader import make_dataloader

    path = tempfile.mkdtemp(prefix="converter_fallback")
    rng = np.random.RandomState(0)
    pq.write_table(pa.table({"id": np.arange(1000), "feature": rng.rand(1000)}),
                   path + "/data.parquet")
    loader = make_dataloader("file://" + path, batch_size=64, device=device)
    with loader:
        for batch in loader:
            shapes = {k: tuple(v.shape) for k, v in batch.items()}
            print("device batch (no spark):", shapes)
            break
    return shapes


def main(argv=None):
    """Returns the first device batch's ``{field: shape}``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="where the device loader's batches land (cuda, or cpu)")
    args = parser.parse_args(argv)
    try:
        import pyspark  # noqa: F401
    except ImportError:
        print("pyspark not installed; running the pyarrow-native equivalent")
        return arrow_fallback(args.device)
    return spark_path(args.device)


if __name__ == "__main__":
    main()
